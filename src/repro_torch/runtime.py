"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Asking for CUDA without a visible GPU raises; nothing carries
    on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is visible; "
                "pass device='cpu' to run the plain PyTorch path")
        # The port is held against the JAX reference in full float32.
        # cuDNN convolutions default to TF32 (about three decimal digits),
        # which would move training off the reference by far more than the
        # summation-order noise the parity tolerances allow.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # One seed gives the same bytes and model on every run, as the
        # reference's XLA programs do: cuDNN's default algorithms differ
        # from run to run, its deterministic ones do not.
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev
