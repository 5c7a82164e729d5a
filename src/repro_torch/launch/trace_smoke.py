"""Trace smoke: a short traced run must give a valid Perfetto trace.

Port of ``scripts/trace_smoke.py``, three checks against the real engine
(no stage mocked), and a fourth:

1. **Traced run and export.**  Two rounds of ``chan_slow_cabac`` (slow
   uplink, nnc-cabac) with the client-state store swapped to the sharded
   backend with one hot shard of 2 clients, so spills and reloads happen.
   The exported Chrome trace must be valid JSON whose "X" events carry
   pid/tid/ts/dur, sort to a timeline starting at 0, and hold every
   round-lifecycle stage (``STAGES``), the codec's encode and decode
   spans, the CABAC two-pass spans and a store spill and load
   (``REQUIRED``).  Each stage span lies inside a round span.
2. **Bytes.**  Each round's ``uplink.bytes`` and ``downlink.bytes``
   counters equal ``RoundRecord.up_bytes`` and ``down_bytes`` exactly.
3. **Telemetry-off overhead under 2%.**  The cost of a dormant span site
   (measured over 200,000 calls) times the sites one traced round hit,
   against the steady round wall of the same scenario with telemetry
   off, in this process.
4. **On/off determinism.**  The off run's bytes and accuracy are the
   traced run's.

    PYTHONPATH=src python -m repro_torch.launch.trace_smoke [--device cpu]

It exits non-zero when a check fails (CUDA unless ``--device cpu``).  The
trace goes to ``trace_smoke.trace.json`` in the temporary directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROUNDS = 2
STAGES = ("cohort_plan", "local_train", "uplink", "aggregate",
          "server_step", "downlink", "evaluate")
REQUIRED = ("codec.encode", "codec.decode", "nnc.encode", "nnc.decode",
            "cabac.pass1.state_scan", "cabac.pass2.range_encode",
            "store.spill", "store.load", "round")
NESTED = ("local_train.cohort", "uplink.intake", "aggregate", "server_step",
          "evaluate")
OVERHEAD_LIMIT = 0.02
NOOP_REPS = 200_000


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def _contains(parent, child) -> bool:
    return (parent["ts"] <= child["ts"] + 1e-9
            and parent["ts"] + parent["dur"]
            >= child["ts"] + child["dur"] - 1e-9)


def trace_path() -> str:
    return os.path.join(tempfile.gettempdir(), "trace_smoke.trace.json")


def run_checks(device) -> dict:
    """The four checks on ``device``; raises :class:`CheckFailed` at the
    first that fails.  -> what they read."""
    from repro_torch.fl import scenarios as sc
    from repro_torch.obs import trace as obs_trace

    base = sc.get_scenario("chan_slow_cabac")
    # a one-hot-shard sharded store forces spills and reloads even in a
    # 2-round smoke (the memory backend never spills)
    traced = dataclasses.replace(base, telemetry="trace", store="sharded",
                                 store_shard_size=2, store_hot_shards=1)

    print(f"== traced run: {traced.name} ({ROUNDS} rounds, sharded store)")
    res = sc.run_scenario(traced, rounds=ROUNDS, device=device)

    # -- check 2: metrics counters == RoundRecord bytes, exactly ----------
    for rec in res.records:
        snap = rec.telemetry
        check(snap is not None, "traced run produced no telemetry snapshot")
        up = snap["counters"].get("uplink.bytes")
        down = snap["counters"].get("downlink.bytes")
        check(up == rec.up_bytes,
              f"round {rec.round}: counter uplink.bytes={up} != "
              f"RoundRecord.up_bytes={rec.up_bytes}")
        check(down == rec.down_bytes,
              f"round {rec.round}: counter downlink.bytes={down} != "
              f"RoundRecord.down_bytes={rec.down_bytes}")
    print(f"byte equality OK: {[r.up_bytes for r in res.records]}")

    # -- check 1: export validity + stage/codec/store coverage ------------
    out = trace_path()
    n_spans = len(res.telemetry.recorder)
    n_events = res.telemetry.export_chrome_trace(out)
    with open(out) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    check(n_events == len(events) >= n_spans,
          f"{n_events} events exported, {len(events)} in the file, "
          f"{n_spans} spans recorded")
    xs = [e for e in events if e["ph"] == "X"]
    for e in xs:
        for k in ("pid", "tid", "ts", "dur", "name"):
            check(k in e, f"trace event missing {k!r}: {e}")
        check(e["ts"] >= 0 and e["dur"] >= 0, f"negative time in {e}")
    ts = [e["ts"] for e in sorted(xs, key=lambda e: e["ts"])]
    check(bool(ts) and ts == sorted(ts) and ts[0] == 0.0,
          "timeline must start at 0")

    names = {e["name"] for e in xs}
    roots = {n.split(".")[0] for n in names}
    missing = [s for s in STAGES if s not in roots]
    check(not missing, f"stage spans missing from trace: {missing}")
    for required in REQUIRED:
        check(required in names, f"span {required!r} missing from trace")

    # nesting: every stage-root span lies inside one round span
    rounds = [e for e in xs if e["name"] == "round"]
    check(len(rounds) == ROUNDS, f"{len(rounds)} round spans")
    for stage in NESTED:
        spans = [e for e in xs if e["name"] == stage]
        check(bool(spans), f"no {stage!r} spans")
        for s in spans:
            check(any(_contains(r, s) for r in rounds),
                  f"{stage!r} span not nested inside any round span")
    counter_tracks = {e["name"] for e in events if e["ph"] == "C"}
    check("uplink.bytes" in counter_tracks, "no uplink.bytes counter track")
    print(f"trace OK: {out} ({n_events} events, "
          f"{len(names)} span names, {len(rounds)} rounds)")

    # -- check 3: telemetry-off overhead ----------------------------------
    off = dataclasses.replace(traced, telemetry="off")
    res_off = sc.run_scenario(off, rounds=ROUNDS, device=device)
    walls = [r.wall_s for r in res_off.records]
    steady = min(walls[1:]) if len(walls) > 1 else walls[0]

    # per-call cost of a dormant span site (the off mode's own code path)
    t0 = time.perf_counter_ns()
    for _ in range(NOOP_REPS):
        with obs_trace.span("noop"):
            pass
    per_site_s = (time.perf_counter_ns() - t0) / NOOP_REPS / 1e9
    sites_per_round = n_spans / ROUNDS
    overhead = per_site_s * sites_per_round / steady
    print(f"overhead: {per_site_s * 1e9:.0f} ns/site x "
          f"{sites_per_round:.0f} sites/round = "
          f"{100 * overhead:.4f}% of the {steady:.3f}s steady round")
    check(overhead < OVERHEAD_LIMIT,
          f"telemetry-off overhead {100 * overhead:.2f}% exceeds "
          f"{100 * OVERHEAD_LIMIT:.0f}%")

    # -- check 4: the off run's records are the traced run's ---------------
    for a, b in zip(res.records, res_off.records):
        check((a.up_bytes, a.down_bytes, a.test_acc)
              == (b.up_bytes, b.down_bytes, b.test_acc),
              f"telemetry changed round {a.round}: "
              f"{(a.up_bytes, a.down_bytes, a.test_acc)} vs "
              f"{(b.up_bytes, b.down_bytes, b.test_acc)}")
    print("telemetry on/off determinism OK")
    return {"names": sorted(names), "events": n_events,
            "up_bytes": [r.up_bytes for r in res.records],
            "overhead": overhead, "per_site_ns": per_site_s * 1e9,
            "sites_per_round": sites_per_round, "steady_round_s": steady}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.runtime import resolve_device
    try:
        run_checks(resolve_device(args.device))
    except CheckFailed as e:
        print(f"trace smoke FAILED: {e}")
        return 1
    print("trace smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
