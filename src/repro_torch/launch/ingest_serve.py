"""FL ingest server: stream encoded client payloads through the
decode-and-accumulate pipeline and report payloads/s and MB/s.

Port of ``repro.launch.ingest_serve``: the serving face of
``repro_torch.fl.ingest``, the same :class:`StreamingIngest` stage the
engine runs behind ``EngineConfig.ingest="streaming"``, driven alone over
a synthetic cohort of paper-regime ternary payloads, so the server's
decode and fold rate is measured without training in the loop.

    PYTHONPATH=src python -m repro_torch.launch.ingest_serve --k 32 \\
        --rounds 3 [--engine vectorized|speculative|serial] [--workers 0] \\
        [--chunk 8] [--codec nnc-cabac] [--density 0.04] \\
        [--trace-out FILE] [--device cuda|cpu]

``--engine speculative`` turns on the multi-symbol CABAC decoder (and the
pointer-jump exp-Golomb walk for ``--codec golomb``).  ``--device`` is
where the running float64 sums live (the engine's device; CUDA unless
``cpu`` is asked for).  ``--trace-out`` writes the ``ingest.decode`` and
``ingest.fold`` spans as Chrome trace-event JSON.

``repro_torch.launch.serve`` without ``--arch`` lands here.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import comms, obs
from repro_torch.core import quant as quant_lib
from repro_torch.fl.ingest import IngestConfig, StreamingIngest
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import resolve_device
from repro_torch.tree import leaves, tree_map

# a client's template: two conv-like carriers and the bias and scales
# sections a real payload frames; about 160k elements, 0.6 MB of float32
_SHAPES = {"conv": {"w": (32, 16, 3, 3), "b": (32,)},
           "fc": {"w": (128, 1024)}}
_SCALE_SHAPES = {"s0": (32,), "s1": (128,)}


def _tree_of(fn, node):
    if isinstance(node, dict):
        return {k: _tree_of(fn, v) for k, v in node.items()}
    return fn(node)


def synthetic_cohort(k: int, density: float = 0.04, seed: int = 0):
    """K STC-regime client updates (+-1 levels at 1 - ``density``
    sparsity) and the WireSpec that frames them -> ``(upds, spec,
    raw_bytes)``.  Each client draws from its own numpy stream, as the
    reference's do, so the levels are the reference's bit for bit."""
    q = quant_lib.QuantConfig()
    fine = _tree_of(lambda s: len(s) < 2, _SHAPES)
    spec = comms.WireSpec(
        params=_tree_of(comms.LeafSpec, _SHAPES),
        scales=_tree_of(comms.LeafSpec, _SCALE_SHAPES),
        fine_mask=fine, step_size=q.step_size,
        fine_step_size=q.fine_step_size, ternary=True)
    upds = []
    for i in range(k):
        rng = np.random.default_rng(seed * 1000 + i)
        lv = _tree_of(
            lambda s: (rng.integers(-1, 2, s)
                       * (rng.random(s) < density)).astype(np.int32),
            _SHAPES)
        mag = np.float32(abs(rng.normal()) + 1e-3)
        recon = tree_map(lambda v: (mag * np.sign(v)).astype(np.float32), lv)
        s_lv = _tree_of(lambda s: rng.integers(-3, 4, s).astype(np.int32),
                        _SCALE_SHAPES)
        s_recon = tree_map(
            lambda v: v.astype(np.float32) * np.float32(q.fine_step_size),
            s_lv)
        upds.append(comms.ClientUpdate(lv, s_lv, recon, s_recon))
    n_elems = sum(int(np.prod(leaf.shape))
                  for leaf in leaves(spec.params) + leaves(spec.scales))
    return upds, spec, 4 * n_elems * k


def serve_cohort(codec, payloads, spec, cfg: IngestConfig, device="cpu"):
    """One server pass: ``payloads`` through a fresh ingest whose sums
    live on ``device``.  Returns the ``IngestResult``; its ``stats`` carry
    the pass's payloads/s and MB/s."""
    ing = StreamingIngest(codec, spec, cfg, device)
    for i, p in enumerate(payloads):
        ing.submit(i, p)
    return ing.finish()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="FL ingest server demo (decode-and-accumulate rate)")
    ap.add_argument("--k", type=int, default=32, help="cohort size")
    ap.add_argument("--rounds", type=int, default=3,
                    help="timed server passes over the cohort")
    ap.add_argument("--codec", default="nnc-cabac")
    ap.add_argument("--engine", default="vectorized",
                    help="decode engine (vectorized|serial|speculative "
                         "for nnc-cabac; vectorized|speculative for golomb)")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--workers", type=int, default=0,
                    help="decode worker threads (0 = inline)")
    ap.add_argument("--density", type=float, default=0.04,
                    help="fraction of nonzero ternary levels per update")
    ap.add_argument("--trace-out", default=None,
                    help="write ingest spans as Chrome trace-event JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the running sums live (cuda|cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    codec = comms.get_codec(args.codec)
    cfg = IngestConfig(chunk=args.chunk,
                       queue_depth=max(32, 2 * args.chunk),
                       workers=args.workers, decode_engine=args.engine)
    cfg.validate()

    upds, spec, raw = synthetic_cohort(args.k, density=args.density)
    with obs_trace.span("serve.encode_cohort", k=args.k):
        payloads = codec.encode_batch(upds, spec,
                                      clients=list(range(args.k)))
    wire = sum(len(p) for p in payloads)
    print(f"# cohort: K={args.k} ternary density={args.density} "
          f"raw={raw / 1e6:.1f} MB wire={wire / 1e6:.3f} MB "
          f"({raw / wire:.0f}x)")
    print(f"# ingest: codec={args.codec} engine={args.engine} "
          f"chunk={args.chunk} workers={args.workers} device={device}")

    tel = obs.make_telemetry("trace" if args.trace_out else "off")
    best = None
    with tel.activate():
        for r in range(args.rounds):
            res = serve_cohort(codec, payloads, spec, cfg, device)
            if res.accepted != args.k or res.rejected:
                raise RuntimeError(f"round {r}: {res.accepted} of {args.k} "
                                   f"payloads accepted, {len(res.rejected)} "
                                   f"rejected")
            s = res.stats
            print(f"round {r}: {s.payloads_per_s:8.1f} payloads/s  "
                  f"{s.mb_per_s:6.2f} MB/s  "
                  f"(decode {s.decode_s * 1e3:.0f} ms, "
                  f"fold {s.fold_s * 1e3:.0f} ms, "
                  f"resident<={s.max_resident})")
            if best is None or s.payloads_per_s > best.payloads_per_s:
                best = s
    print(f"best: {best.payloads_per_s:.1f} payloads/s, "
          f"{best.mb_per_s:.2f} MB/s wire "
          f"({best.mb_per_s * raw / wire:.1f} MB/s raw-equivalent)")
    if args.trace_out:
        n = tel.export_chrome_trace(args.trace_out)
        print(f"trace: {args.trace_out} ({n} events)")
    return best


if __name__ == "__main__":
    main()
