"""Quickstart: 60 seconds of FSFL.

Port of ``examples/quickstart.py``: a 2-client federated run of the
paper's pipeline on a small CNN with synthetic CIFAR-like data, printing
accuracy and the exact DeepCABAC-coded bytes of each round for FedAvg and
FSFL.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Without ``--device cpu`` it runs on the card (and raises where none is
visible).  :func:`run` takes the model and splits, and may take each
configuration's initial state and the batch plan, so a test can feed it
the reference's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.fsfl import run_federated
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.data import federated, synthetic
from repro_torch.models import cnn
from repro_torch.runtime import resolve_device

ROUNDS = 5
SEED = 42


def setting():
    """-> (model, splits): 640 images of a 10-class task over 2 clients,
    drawn from seeds 0 and 1."""
    task = synthetic.ImageTask("quick", 10, 3, prototypes_per_class=2,
                               noise=0.3)
    x, y = synthetic.make_image_dataset(torch.Generator().manual_seed(0),
                                        task, 640)
    splits = federated.split_federated(torch.Generator().manual_seed(1), x,
                                       y, num_clients=2)
    model = cnn.make_vgg("vgg_quick", [8, 16, 32], 10, 3, dense_width=16,
                         pool_after=(0, 1, 2))
    return model, splits


def configs() -> dict[str, ProtocolConfig]:
    """The two protocols, uncompressed FedAvg and FSFL."""
    return {
        "fedavg": ProtocolConfig(name="fedavg", method="none",
                                 quantize=False, batch_size=32,
                                 local_lr=2e-3),
        "fsfl": ProtocolConfig(name="fsfl", method="sparse", scaling=True,
                               error_feedback=True, fixed_sparsity=0.96,
                               structured=False, scale_lr=2e-2,
                               scale_subepochs=2, batch_size=32,
                               local_lr=2e-3)}


def run(model, splits, rounds: int = ROUNDS, *, init_state=None, plan=None,
        device=None) -> dict:
    """Both protocols for ``rounds`` rounds from seed 42 on ``device``;
    ``init_state`` maps a protocol's name to its initial state.  Prints
    the reference script's lines; -> the RunResult of each protocol."""
    init_state = init_state or {}
    res = {}
    for (name, cfg), title in zip(configs().items(), (
            "=== FedAvg (uncompressed) ===",
            "=== FSFL (ours: sparse + scaled + DeepCABAC) ===")):
        print(title)
        res[name] = run_federated(model, cfg, splits, rounds, seed=SEED,
                                  init_state=init_state.get(name), plan=plan,
                                  device=device, verbose=True)
    r1, r2 = res["fedavg"], res["fsfl"]
    b1, b2 = r1.records[-1].cum_bytes, r2.records[-1].cum_bytes
    print(f"\nFedAvg: acc={r1.final_acc:.3f}  total={b1/1e6:.2f} MB")
    print(f"FSFL:   acc={r2.final_acc:.3f}  total={b2/1e6:.4f} MB "
          f"({b1/b2:.0f}x less data)")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model, splits = setting()
    return run(model, splits, device=device)


if __name__ == "__main__":
    main()
