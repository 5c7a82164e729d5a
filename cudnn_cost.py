#!/usr/bin/env python3
"""What the port's cuDNN settings cost on one full-width round.

    python3 cudnn_cost.py [--src SRC] [--label NAME] [--rounds N]

Imports ``repro_torch`` from ``SRC`` (default: the ``src/`` beside this
script), so that another tree, such as an unpacked parent commit, can be
run on the same card in turn with this one.  It builds the CUDA kernels,
makes ``chip_smoke.py``'s full-width split (``vgg11_thinned``, 6,400
synthetic images over 8 clients), runs ``N`` rounds of
``sync_full_fedavg_fsfl`` (each round's wall, ``RoundRecord.wall_s``; the
first round also warms up), then one more round under ``torch.profiler``
(device activity only) for the device-busy share.  The last line is one
JSON object with the card, the cuDNN flags the run ended with, the walls
and the profile.  Needs one CUDA device; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("cudnn_cost: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke
    from repro_torch import data, fl, models
    from repro_torch.kernels import build

    t0 = time.time()
    build.build_all()
    build_s = time.time() - t0
    splits = chip_smoke.full_width_splits(torch, data)
    res = fl.run_scenario("sync_full_fedavg_fsfl", rounds=args.rounds,
                          model=models.vgg11_thinned(), splits=splits,
                          device="cuda")
    torch.cuda.synchronize()
    walls = [r.wall_s for r in res.records]
    prof = chip_smoke.profile_round(
        torch, lambda: fl.run_scenario(
            "sync_full_fedavg_fsfl", rounds=1, model=models.vgg11_thinned(),
            splits=splits, device="cuda"),
        f"sync_full_fedavg_fsfl ({args.label}, device activity only)",
        ("level_assign",), host=False)
    out = {"label": args.label, "src": args.src,
           "device": chip_smoke.device_line(),
           "cudnn_deterministic": torch.backends.cudnn.deterministic,
           "cudnn_benchmark": torch.backends.cudnn.benchmark,
           "build_s": build_s, "round_walls_s": walls,
           "up_bytes": [r.up_bytes for r in res.records],
           "profiled_wall_ms": prof["wall_ms"],
           "device_busy_ms": prof["busy_ms"],
           "device_busy_share": prof.get("busy_share")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
