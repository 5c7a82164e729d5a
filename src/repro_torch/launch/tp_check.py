"""Checks of transformer tensor parallelism, shared by the tests and
``chip_smoke.py``'s tp phase: the worker entry of a tp job, the run each
worker makes, and the card phase.

A tp job is ``tp`` processes of one ``torch.distributed`` job (gloo),
started with ``repro_torch.dist``'s environment contract
(``REPRO_DIST_COORD``, ``REPRO_DIST_NPROCS``, ``REPRO_DIST_PID``) by
:func:`spawn_job`, each one shard of the mesh axis ``"model"``
(``launch.mesh.make_mesh((tp,), ("model",))``).  A worker runs every case
of the job file it is given and saves its results; a worker that fails,
or does not end in time, fails the job.  Every worker runs torch on one
thread, so every rank draws and rounds the same host bits.

    python -m repro_torch.launch.tp_check --worker JOB OUT   # a worker

A case (:func:`run_case`) is one model at one tp: ``forward_full`` and
``loss_fn`` on a prompt, then the prompt fed one token at a time through
``decode_step`` from ``init_cache`` (the reference serves tp > 1 so: its
``prefill`` is single-shard), then greedy steps, each fed the previous
step's token, or a forced one (the run it is held against, so that a tie
there does not send the two runs down different paths).  Each worker
draws its shards of the tp = 1 tree that ``init_params`` would draw from
the case's seed, one leaf at a time (``convert.init_shard_params``); the
prefill layout feeds ``forward_full``, the decode layout
(``ShardPlan(tp, decode_layout=True)``) the decode steps.

The comparison rules are ``arch_check``'s: floating outputs within a
bound of the reference tensor's largest magnitude (:func:`arch_check.
rel_gap`), greedy tokens equal but where the reference's top two logits
lie within that bound (:func:`arch_check.token_misses`).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import sys
import tempfile
import time

import torch

from repro_torch.launch.arch_check import rel_gap, token_misses

JOB_TIMEOUT_S = 600
CARD_TOL = 1e-4     # card against tp = 1 or against the CPU job, of the
                    # largest |x|


def cfg_of(case: dict):
    """The case's ``ArchConfig``: the registered one, reduced or not, with
    the case's overrides."""
    from repro_torch.configs import get
    cfg = get(case["arch"])
    if case.get("reduced"):
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, **case.get("over", {}))


def make_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """The inputs of a case, drawn on the CPU from ``seed`` (the same on
    every rank and device)."""
    from repro_torch.configs import make_inputs
    return make_inputs(torch.Generator().manual_seed(seed), cfg, batch, seq)


EXTRA_KEYS = ("enc_embeds", "patch_embeds", "patch_positions",
              "mrope_positions")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if hasattr(tree, "to") else tree


def _cpu(tree):
    return _to(tree, "cpu")


class _Clock:
    """ms between two points: CUDA events on the card, the host clock on
    the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t0 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            self.b.record()
            torch.cuda.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t0) * 1e3


def run_case(cfg, params, dparams, batch: dict, tp: int, device, *,
             feed: int, greedy: int, force=None, keep_cache: bool = False,
             keep_logits: bool = False) -> dict:
    """One model at ``tp`` on ``device`` (this process's shard; tp = 1
    alone).  ``params`` in the prefill layout, ``dparams`` in the decode
    layout.  ``forward_full`` and ``loss_fn`` on ``batch``; then
    ``feed`` prompt tokens through ``decode_step`` from ``init_cache``
    and ``greedy`` greedy steps (fed ``force[i]`` where given).  Returns
    the final hidden states, aux and loss, each step's token and hidden
    state (and the whole vocabulary's logits, gathered, with
    ``keep_logits``; the cache with ``keep_cache``), and the readings: ms
    of the forward, ms a decode token, collectives a token and their host
    ms.  The logits are gathered from the kept hidden states after the
    decode loop, outside its clock and its collective counts."""
    from repro_torch.models import common, decode, transformer
    from repro_torch.models.transformer import ShardPlan
    plan, dplan = ShardPlan(tp), ShardPlan(tp, decode_layout=True)
    ctx = plan.ctx("model" if tp > 1 else None)
    b = _to(batch, device)
    B = b["tokens"].shape[0]
    extras = {k: b.get(k) for k in EXTRA_KEYS}
    out = {}
    with torch.inference_mode():
        clock = _Clock(device)
        x, aux, _ = transformer.forward_full(params, b["tokens"], cfg, plan,
                                             ctx, **extras)
        loss = transformer.loss_fn(params, b, cfg, plan, ctx)
        out["forward_ms"] = clock.ms()
        out.update(x=x.cpu(), aux=torch.as_tensor(float(aux)),
                   loss=loss.cpu())
        del x
        steps = feed + greedy
        # a ring of r parts holds cache_len // r slots a part: round the
        # length up so that no tp up to 8 wraps it
        cache = decode.init_cache(
            cfg, dplan, B, -(-steps // 8) * 8,
            enc_ctx=cfg.encoder_ctx if cfg.family == "encdec" else None,
            device=device)
        top = transformer.as_source(dparams).top()
        tokens, hidden = [], []
        tok = b["tokens"][:, 0]
        common.reset_collectives()
        clock = _Clock(device)
        for i in range(steps):
            if i < feed:
                tok = b["tokens"][:, i]
            elif force is not None:
                tok = force[i - feed].to(device)
            h, cache = decode.decode_hidden(dparams, cache, tok, cfg, dplan,
                                            ctx)
            nxt, _ = transformer.greedy_token(h, top, cfg, ctx)
            tokens.append(nxt)
            hidden.append(h)
            tok = nxt
        decode_ms = clock.ms()
        calls, host_ms, nbytes = common.collective_totals()
        out.update(
            tokens=torch.stack(tokens).cpu(), hidden=torch.stack(hidden).cpu(),
            decode_ms_per_token=decode_ms / steps,
            collectives_per_token=calls / steps,
            collective_ms_per_token=host_ms / steps,
            collective_bytes_per_token=nbytes / steps,
            collectives={k: list(v) for k, v in common.COLLECTIVES.items()})
        if keep_logits:
            out["logits"] = torch.stack([common.all_gather_tp(
                transformer.head_logits(h, top, cfg), ctx, -1).cpu()
                for h in hidden])
        if keep_cache:
            out["cache"] = _cpu(tuple(cache.layers) if isinstance(
                cache.layers, tuple) else cache.layers)
    return out


def greedy_inputs(result: dict, feed: int):
    """The tokens a run fed its greedy steps: each step's input is the
    token the step before it chose."""
    return result["tokens"][feed - 1:-1]


def case_params(case: dict, cfg, tp: int, rank: int, device):
    """(prefill-layout, decode-layout) shards of this rank for a case,
    drawn on ``device`` from the case's seed one leaf at a time."""
    from repro_torch import convert
    from repro_torch.models.transformer import ShardPlan
    gen = torch.Generator(device=device).manual_seed(case.get("seed", 0))
    return convert.init_shard_params(
        gen, cfg, [ShardPlan(tp), ShardPlan(tp, decode_layout=True)], rank)


def worker_case(case: dict, tp: int, rank: int) -> list[dict]:
    """Every run of one case in this worker: the case's ``runs`` devices
    in order, each on the same shards (drawn once, moved); a run after
    the first is forced with the first's greedy tokens where the case
    says ``force_first``."""
    cfg = cfg_of(case)
    runs = case.get("runs", ["cpu"])
    params, dparams = case_params(case, cfg, tp, rank,
                                  case.get("draw", runs[0]))
    batch = make_batch(cfg, case.get("batch_size", 1), case["seq"],
                       case.get("seed", 0) + 1)
    results = []
    for dev in runs:
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        p, dp = _to(params, dev), _to(dparams, dev)
        force = case.get("force")
        if force is None and case.get("force_first") and results:
            force = greedy_inputs(results[0], case["feed"])
        res = run_case(cfg, p, dp, batch, tp, dev, feed=case["feed"],
                       greedy=case.get("greedy", 0), force=force,
                       keep_cache=case.get("keep_cache", False),
                       keep_logits=case.get("keep_logits", False))
        res["device"] = dev
        if torch.device(dev).type == "cuda":
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
        results.append(res)
        del p, dp
    del params, dparams
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return results


def worker_main(job_path: str, out_dir: str) -> int:
    from repro_torch.dist import init_from_env
    from repro_torch.launch.mesh import make_mesh
    job = torch.load(job_path, weights_only=False)
    torch.set_num_threads(1)
    ctx = init_from_env()
    tp, rank = ctx.process_count, ctx.process_index
    if any(torch.device(d).type == "cuda"
           for c in job["cases"] for d in c.get("runs", ["cpu"])):
        from repro_torch.runtime import resolve_device
        resolve_device("cuda")
    make_mesh((tp,), ("model",))
    out = {}
    for case in job["cases"]:
        t0 = time.time()
        out[case["name"]] = worker_case(case, tp, rank)
        out[case["name"]][0]["case_s"] = time.time() - t0
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    ctx.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


class TPJob:
    """``cases`` in a job of ``tp`` workers, started at construction;
    :meth:`results` waits for it."""

    def __init__(self, cases: list[dict], tp: int):
        from repro_torch.launch.dist_smoke import Job
        self.tp = tp
        self._tmp = tempfile.TemporaryDirectory(prefix="repro_torch_tp_")
        job_path = os.path.join(self._tmp.name, "job.pt")
        torch.save({"cases": cases}, job_path)
        self._job = Job(["-m", "repro_torch.launch.tp_check", "--worker",
                         job_path, self._tmp.name], procs=tp)

    def results(self) -> list[dict]:
        """Each rank's results (case name -> one result a run).  Raises
        where a worker fails or the job does not end within
        ``JOB_TIMEOUT_S`` seconds, with its stderr."""
        try:
            outs = self._job.wait(JOB_TIMEOUT_S)
            bad = [(pid, rc, err) for pid, (rc, _, err) in enumerate(outs)
                   if rc != 0]
            if bad:
                pid, rc, err = bad[0]
                raise RuntimeError(f"tp job (tp = {self.tp}): worker {pid} "
                                   f"failed (exit {rc}):\n{err[-4000:]}")
            return [torch.load(os.path.join(self._tmp.name, f"rank{r}.pt"),
                               weights_only=False) for r in range(self.tp)]
        finally:
            self._tmp.cleanup()


def spawn_job(cases: list[dict], tp: int) -> list[dict]:
    """Run ``cases`` in a job of ``tp`` workers and wait for it."""
    return TPJob(cases, tp).results()


# ------------------------------------------------------------ comparisons

def hold(want: dict, got: dict, tol: float, label: str) -> dict:
    """``got``'s outputs against ``want``'s: hidden states, aux, loss and
    each decode step's hidden state within ``tol`` of ``want``'s largest
    magnitude; greedy tokens equal but at ties of ``want``'s logits.
    Returns the gaps; raises where one is out of bounds."""
    rec = {"hidden_gap": rel_gap(want["x"], got["x"]),
           "loss_gap": rel_gap(want["loss"], got["loss"]),
           "aux_gap": rel_gap(want["aux"], got["aux"]),
           "decode_hidden_gap": rel_gap(want["hidden"], got["hidden"])}
    ties, misses = token_misses(want["logits"], want["tokens"],
                                got["tokens"], tol)
    rec.update(tokens=int(want["tokens"].numel()), ties=len(ties),
               misses=len(misses))
    bad = {k: v for k, v in rec.items() if k.endswith("gap") and v > tol}
    if bad or misses:
        raise AssertionError(f"{label}: {rec}")
    return rec


def same_bits(a: dict, b: dict, label: str) -> None:
    """Two runs of one case equal bit for bit (outputs and tokens)."""
    for k in ("x", "loss", "aux", "hidden", "tokens"):
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"{label}: {k} differs between two runs")


def ranks_agree(results: list[dict], name: str) -> None:
    """Every rank's replicated outputs (hidden states, loss, tokens) the
    same bits."""
    first = results[0][name]
    for r, res in enumerate(results[1:], 1):
        for run0, run in zip(first, res[name]):
            for k in ("x", "loss", "tokens", "hidden"):
                if not torch.equal(run0[k], run[k]):
                    raise AssertionError(f"{name}: rank {r}'s {k} parts "
                                         f"from rank 0's")


# ------------------------------------------------------------ on the card

PROMPT = 128        # tokens a full-width prompt, fed one at a time
GREEDY = 16         # greedy steps after it
# recurrentgemma-9b's layers in (a): its 38 layers at full width ran
# 423.9 s in the phase against a 150 s budget; 3 layers keep its widths,
# one of each block kind and its vocabulary head
RG_DEPTH = 3
CPU_DEPTH = {"recurrentgemma-9b": 3, "mamba2-370m": 2}   # CPU job's layers
# a run held to the CPU: a CPU_PROMPT-token forward and CPU_FEED +
# CPU_GREEDY decode steps.  A full-width vocabulary head is read whole
# each decode step (2 GB a shard for recurrentgemma-9b) and multiplied
# with the whole prompt in the forward and the loss: seconds on the
# CPU's one thread
CPU_PROMPT, CPU_FEED, CPU_GREEDY = 32, 8, 8


def tp1_reference(case: dict, device: str = "cuda") -> dict:
    """The tp = 1 run a tp case is held against, in this process on
    ``device`` (params drawn from the case's seed on the card, as the
    workers draw theirs), its model freed before it returns."""
    from repro_torch.models import transformer
    cfg = cfg_of(case)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=case.get("draw", device)).manual_seed(
        case.get("seed", 0))
    params = _to(transformer.init_params(gen, cfg), device)
    batch = make_batch(cfg, case.get("batch_size", 1), case["seq"],
                       case.get("seed", 0) + 1)
    res = run_case(cfg, params, params, batch, 1, device, feed=case["feed"],
                   greedy=case.get("greedy", 0), keep_logits=True)
    if device == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def full_width_cases() -> list[dict]:
    """(a): the four architectures at full width, tp = 2, each a
    ``PROMPT``-token prompt and ``GREEDY`` greedy steps.  gemma2-2b and
    whisper-small against tp = 1 on the card; recurrentgemma-9b and
    mamba2-370m against the same workers on the CPU at ``CPU_DEPTH``
    layers (params drawn on the card and copied; a ``CPU_PROMPT``-token
    forward, ``CPU_FEED`` + ``CPU_GREEDY`` decode steps), and at
    full depth (recurrentgemma-9b's cut to ``RG_DEPTH`` layers, its
    widths kept, and so named) twice on the card, bit for bit."""
    from repro_torch.configs import get
    base = {"seq": PROMPT, "feed": PROMPT, "greedy": GREEDY, "seed": 0}
    cases = [dict(base, name=f"{a} tp2", arch=a, runs=["cuda"],
                  against="tp1") for a in ("gemma2-2b", "whisper-small")]
    for a in ("recurrentgemma-9b", "mamba2-370m"):
        cases.append(dict(base, name=f"{a} tp2 {CPU_DEPTH[a]} layers",
                          arch=a, over={"n_layers": CPU_DEPTH[a]},
                          seq=CPU_PROMPT, feed=CPU_FEED, greedy=CPU_GREEDY,
                          runs=["cpu", "cuda"], draw="cuda",
                          force_first=True, keep_logits=True,
                          against="cpu"))
        name, over = f"{a} tp2", {}
        if a == "recurrentgemma-9b":
            name += (f" at {RG_DEPTH} of {get(a).n_layers} layers (depth "
                     f"cut, widths kept)")
            over = {"n_layers": RG_DEPTH}
        cases.append(dict(base, name=name, arch=a, over=over,
                          runs=["cuda", "cuda"], against="repeat"))
    return cases


REDUCED_PROMPT, REDUCED_GREEDY = 32, 8


def reduced_cases() -> list[dict]:
    """(b): tp = 4 at reduced size, batch 2, a ``REDUCED_PROMPT``-token
    prompt and ``REDUCED_GREEDY`` greedy steps."""
    base = {"seq": REDUCED_PROMPT, "feed": REDUCED_PROMPT,
            "greedy": REDUCED_GREEDY, "seed": 0, "reduced": True,
            "batch_size": 2}
    return [dict(base, name="gemma2-2b reduced tp4", arch="gemma2-2b",
                 runs=["cuda"], against="tp1"),
            dict(base, name="recurrentgemma-9b reduced tp4",
                 arch="recurrentgemma-9b", runs=["cpu", "cuda"], draw="cpu",
                 force_first=True, keep_logits=True, against="cpu"),
            dict(base, name="mixtral-8x22b reduced ep_a2a tp4",
                 arch="mixtral-8x22b", over={"moe_impl": "ep_a2a"},
                 runs=["cuda"], against="tp1")]


def run_tp_cases(cases: list[dict], tp: int, device_line: str,
                 device: str = "cuda") -> list[dict]:
    """Every case at ``tp`` on the card, each held as its ``against``
    says; the tp = 1 runs first in this process (each model freed before
    the workers start).  Prints a line a case; raises on any failed
    check.  ``device="cpu"`` rehearses the phase on the CPU (each case's
    "cuda" runs on the CPU)."""
    if device != "cuda":
        cases = [dict(c, runs=[device if r == "cuda" else r
                               for r in c["runs"]]) for c in cases]
    want = {}
    for case in cases:
        # a repeat case's tp = 1 run is its tp = 1 timing only
        if case["against"] in ("tp1", "repeat"):
            want[case["name"]] = tp1_reference(case, device)
        if case["against"] == "tp1":
            case["force"] = greedy_inputs(want[case["name"]], case["feed"])
    t0 = time.time()
    results = spawn_job(cases, tp)
    job_s = time.time() - t0
    records = []
    for case in cases:
        name = case["name"]
        ranks_agree(results, name)
        runs = results[0][name]
        card = runs[-1]
        if case["against"] == "tp1":
            gaps = hold(want[name], card, CARD_TOL, f"{name} against tp 1")
            tp1_ms = want[name]["decode_ms_per_token"]
        elif case["against"] == "cpu":
            gaps = hold(runs[0], card, CARD_TOL, f"{name} card against CPU")
            tp1_ms = None
        else:
            same_bits(runs[0], card, f"{name} on the card")
            gaps = {"repeat": "bit for bit"}
            tp1_ms = want[name]["decode_ms_per_token"]
        rec = {"name": name, "tp": tp, **gaps,
               "ms_per_token": card["decode_ms_per_token"],
               "tp1_ms_per_token": tp1_ms,
               "collectives_per_token": card["collectives_per_token"],
               "collective_ms_per_token": card["collective_ms_per_token"],
               "forward_ms": card["forward_ms"],
               "peak_gib": [r[name][-1].get("peak_bytes", 0) / 2**30
                            for r in results],
               "case_s": runs[0].get("case_s")}
        records.append(rec)
        print(f"tp {name}: {rec} [{device_line}]", flush=True)
    print(f"tp job (tp = {tp}, {len(cases)} cases): {job_s:.1f} s",
          flush=True)
    return records


def tp_phase(device_line: str) -> dict:
    """``chip_smoke.py``'s tp phase: (a) the four architectures at full
    width with two workers on the card; (b) the tp = 4 reduced cases
    with four.  Raises on any failed check."""
    t0 = time.time()
    a = run_tp_cases(full_width_cases(), 2, device_line)
    t1 = time.time()
    b = run_tp_cases(reduced_cases(), 4, device_line)
    out = {"tp2_full_width": a, "tp4_reduced": b,
           "tp2_s": t1 - t0, "tp4_s": time.time() - t1,
           "wall_s": time.time() - t0}
    print(f"tp phase wall {out['wall_s']:.1f} s (tp 2 {out['tp2_s']:.1f} s, "
          f"tp 4 {out['tp4_s']:.1f} s) [{device_line}]", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", nargs=2, metavar=("JOB", "OUT"),
                    help="run as one process of a tp job (REPRO_DIST_*)")
    args = ap.parse_args(argv)
    if args.worker:
        return worker_main(*args.worker)
    ap.error("the tp phase runs from chip_smoke.py; --worker JOB OUT runs "
             "a worker")
    return 2


if __name__ == "__main__":
    sys.exit(main())
