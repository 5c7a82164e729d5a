"""Drive the FL ingest server: encode a cohort of sparse ternary client
updates, then serve them through the streaming decode-and-accumulate
pipeline (``repro_torch.fl.ingest``) twice, block-decode vectorized and
speculative multi-symbol CABAC, and check that both give the aggregate
the gather path would.

Port of ``examples/serve_decode.py``.  This fronts the same
``StreamingIngest`` stage the engine runs behind
``EngineConfig.ingest="streaming"``, alone, so the server's decode rate
is visible (no training in the loop).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        [--k 16] [--chunk 8] [--density 0.04] [--device cuda|cpu]

``--device`` is where the ingest's running sums live (CUDA unless
``cpu``).  It raises unless both engines fold to the same bits and those
bits are the gather path's float64 mean of the decoded trees.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import comms
from repro_torch.fl.ingest import IngestConfig
from repro_torch.launch.ingest_serve import serve_cohort, synthetic_cohort
from repro_torch.runtime import resolve_device
from repro_torch.tree import leaves, tree_map

ENGINES = ("vectorized", "speculative")


def _host(tree):
    return [leaf.detach().cpu().numpy() if hasattr(leaf, "detach")
            else np.asarray(leaf) for leaf in leaves(tree)]


def run(k: int = 16, chunk: int = 8, density: float = 0.04,
        device=None) -> dict:
    """Encode K updates, serve them through both engines on ``device``
    (CUDA unless ``"cpu"``), print the reference script's lines and check
    the aggregates.  -> each engine's ``IngestResult``."""
    device = resolve_device(device)
    codec = comms.get_codec("nnc-cabac")
    upds, spec, raw = synthetic_cohort(k, density=density)
    payloads = codec.encode_batch(upds, spec, clients=list(range(k)))
    wire = sum(len(p) for p in payloads)
    print(f"encoded K={k} ternary updates: {raw / 1e6:.1f} MB raw -> "
          f"{wire / 1e6:.3f} MB wire ({raw / wire:.0f}x)")

    results = {}
    for engine in ENGINES:
        cfg = IngestConfig(chunk=chunk, decode_engine=engine)
        res = serve_cohort(codec, payloads, spec, cfg, device)
        if res.accepted != k or res.rejected:
            raise RuntimeError(f"{engine}: {res.accepted} of {k} payloads "
                               f"accepted, {len(res.rejected)} rejected")
        s = res.stats
        print(f"{engine:>12}: {s.payloads_per_s:8.1f} payloads/s  "
              f"{s.mb_per_s:5.2f} MB/s  (resident<={s.max_resident}, "
              f"cohort K={k} never materialised)")
        results[engine] = res

    # both engines fold to the same bits, and the ingest mean is the
    # gather path's mean over the same decoded trees
    a, b = (_host(results[e].delta_params) for e in ENGINES)
    decs = codec.decode_batch(payloads, spec)
    gather = tree_map(
        lambda *ls: np.mean(np.stack([np.asarray(x, np.float64) for x in ls]),
                            axis=0).astype(np.float32),
        *[d.params for d in decs])
    for la, lb, lg in zip(a, b, _host(gather)):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(la, lg)
    print("aggregates identical: vectorized == speculative == gather mean")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=16, help="cohort size")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--density", type=float, default=0.04)
    ap.add_argument("--device", default="cuda",
                    help="where the running sums live (cuda|cpu)")
    args = ap.parse_args(argv)
    return run(args.k, args.chunk, args.density, args.device)


if __name__ == "__main__":
    main()
