"""Carry state between the JAX reference and the port.

The reference's ``ServerState`` (params, scales, BN state) and
``ClientPersistent`` (residual, optimizer states, schedule step) arrive as
trees of arrays (numpy, or anything ``np.asarray`` takes) and leave as
trees of numpy arrays; so do a transformer's ``init_params`` tree and its
``DecodeCache``.  Structures are read by field name, so this module
needs nothing of the reference package: dicts stay dicts, an optimizer
state with ``mu``/``nu`` is Adam's, one with ``momentum`` is SGD's.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.protocol import ClientPersistent, ServerState
from repro_torch.optim import AdamState, SGDState
from repro_torch.tree import tree_map


def to_tensors(tree: Any, device="cpu") -> Any:
    """dict tree of arrays -> dict tree of tensors (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return torch.as_tensor(np.array(tree)).to(device)


def to_numpy(tree: Any) -> Any:
    """Any tree of tensors -> the same structure with numpy leaves."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def server_state(ref, device="cpu") -> ServerState:
    """The reference's ServerState -> the port's, on ``device``."""
    return ServerState(params=to_tensors(ref.params, device),
                       scales=to_tensors(ref.scales, device),
                       bn_state=to_tensors(ref.bn_state, device))


def optimizer_state(ref, device="cpu"):
    step = to_tensors(ref.step, device)
    if hasattr(ref, "mu") and hasattr(ref, "nu"):
        return AdamState(step, to_tensors(ref.mu, device),
                         to_tensors(ref.nu, device))
    if hasattr(ref, "momentum"):
        return SGDState(step, to_tensors(ref.momentum, device))
    raise TypeError(f"unknown optimizer state {type(ref).__name__}")


def client_persistent(ref, device="cpu") -> ClientPersistent:
    """The reference's ClientPersistent -> the port's, on ``device``."""
    return ClientPersistent(
        residual=to_tensors(ref.residual, device),
        opt_state=optimizer_state(ref.opt_state, device),
        scale_opt_state=optimizer_state(ref.scale_opt_state, device),
        sched_step=to_tensors(ref.sched_step, device))


def initial_state(server_ref, persistent_ref, device="cpu"):
    """``(ServerState, ClientPersistent)`` for ``FederatedEngine(init_state=)``."""
    return server_state(server_ref, device), client_persistent(persistent_ref,
                                                               device)


def transformer_params(ref_params, cfg, device="cpu") -> dict:
    """The reference's ``init_params`` tree for ``cfg`` -> the port's, on
    ``device``.  Every key and shape must be those of the port's
    ``init_params`` for the same config, or this raises ``ValueError``."""
    from repro_torch.models.transformer import param_shapes
    want = param_shapes(cfg)

    def carry(ref, shapes, path):
        if isinstance(shapes, dict):
            if not isinstance(ref, dict) or set(ref) != set(shapes):
                got = sorted(ref) if isinstance(ref, dict) else type(ref)
                raise ValueError(f"{path or 'params'}: keys {got}, want "
                                 f"{sorted(shapes)}")
            return {k: carry(ref[k], shapes[k], f"{path}/{k}" if path else k)
                    for k in shapes}
        arr = np.asarray(ref)
        if tuple(arr.shape) != shapes:
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, want "
                             f"{shapes}")
        return torch.as_tensor(np.array(arr)).to(device)

    return carry(ref_params, want, "")


def decode_cache(ref_cache, device="cpu"):
    """The reference's ``DecodeCache`` -> the port's (``pos`` a Python int,
    the layers' tuples and dicts kept), on ``device``."""
    from repro_torch.models.decode import DecodeCache

    def carry(t):
        if isinstance(t, dict):
            return {k: carry(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(carry(v) for v in t)
        return torch.as_tensor(np.array(t)).to(device)

    return DecodeCache(int(np.asarray(ref_cache.pos)), carry(ref_cache.layers))
