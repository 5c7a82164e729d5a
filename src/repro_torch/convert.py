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
    _check_shapes(ref_params, param_shapes(cfg), "params")
    return to_tensors(ref_params, device)


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


# ---------------------------------------------------------------------------
# tensor-parallel shards of a tp = 1 tree
# ---------------------------------------------------------------------------

_ATTN = ("attn", "xattn")


def _block(t, dim: int, parts: int, i: int):
    n = t.shape[dim]
    if n % parts:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{parts} ways")
    return t.narrow(dim, i * (n // parts), n // parts)


def _sections(t, dim: int, sizes, cut: list):
    """Split ``t`` along ``dim`` into sections of ``sizes``; cut each with
    ``cut[k]`` (None keeps the section whole) and concatenate."""
    out, off = [], 0
    for n, c in zip(sizes, cut):
        sec = t.narrow(dim, off, n)
        out.append(sec if c is None else c(sec))
        off += n
    return torch.cat(out, dim=dim)


def shard_leaf(path: tuple, t, cfg, plan, rank: int):
    """Rank ``rank``'s shard of one leaf of a tp = 1 tree at ``plan``'s
    sharding (the reference's per-shard layout).  ``path`` is the leaf's
    keys from the root; a leaf under a layer stack keeps its leading
    layer axis (every cut counts dims from the end)."""
    tp, name = plan.tp, path[-1]
    parent = path[-2] if len(path) > 1 else None
    if tp == 1:
        return t
    if name in ("embed", "lm_head") and len(path) == 1:
        pad = cfg.padded_vocab(tp) - t.shape[-2]
        if pad:
            t = torch.cat([t, t.new_zeros((pad, t.shape[-1]))])
        return _block(t, -2, tp, rank)
    if parent in _ATTN:
        spec = cfg.attn_spec(tp, plan.attn_replicated)
        if spec.replicated:
            raise ValueError("attn_replicated has no tp = 1 equivalent to "
                             "split: its shards sum tp full projections")
        if plan.decode_layout:
            # wq, wk, wv: the heads of kv group rank // r; wo: the
            # n_heads / tp q heads this rank keeps, rank * keep onwards
            if name == "wo":
                return _block(t, -1, tp, rank)
            return _block(t, -2, spec.decode_kv_shards,
                          rank // spec.decode_seq_parts)
        if name == "wq":
            return _block(t, -2, tp, rank)
        if name == "wo":
            return _block(t, -1, tp, rank)
        return _block(t, -2, tp, rank) if spec.kv_sharded else t
    if parent == "mlp":
        return _block(t, -1 if name == "w_down" else -2, tp, rank)
    if parent == "moe":
        if name == "router":
            return t
        mspec = cfg.moe_spec()
        dim = -1 if name == "w_down" else -2
        if mspec.impl == "dense_tp":
            return _block(t, dim, tp, rank)
        E = mspec.n_experts
        if tp % E:
            raise ValueError(f"ep_a2a at tp {tp} needs tp % n_experts == 0 "
                             f"({E} experts)")
        ws = tp // E
        return _block(_block(t, -3, E, rank // ws), dim, ws, rank % ws)
    if parent == "ssm":
        sspec = cfg.ssm_spec()
        din, gn, H = sspec.d_inner, sspec.n_groups * sspec.d_state, \
            sspec.n_heads

        def mine(dim):
            return lambda sec: _block(sec, dim, tp, rank)
        if name == "in_proj":      # rows [z | x | B | C | dt]
            return _sections(t, -2, (din, din, gn, gn, H),
                             [mine(-2), mine(-2), None, None, mine(-2)])
        if name in ("conv_w", "conv_b"):   # channels [x | B | C]
            dim = -2 if name == "conv_w" else -1
            return _sections(t, dim, (din, gn, gn), [mine(dim), None, None])
        # out_proj's columns; A_log, D_skip, dt_bias, norm_g
        return _block(t, -1, tp, rank)
    if parent == "rec":
        if name in ("w_a", "w_i"):         # the diagonal block
            return _block(_block(t, -2, tp, rank), -1, tp, rank)
        if name == "w_out":
            return _block(t, -1, tp, rank)
        if name in ("w_in_x", "w_in_g", "conv_w"):
            return _block(t, -2, tp, rank)
        return _block(t, -1, tp, rank)     # conv_b, b_a, b_i, lam
    return t                               # norms: replicated


_STACKS = ("layers", "superblocks", "tail", "enc_layers", "dec_layers")


def _layout_dependent(path: tuple) -> bool:
    """Whether a leaf's shard differs between the prefill and the decode
    layout (the attention projections)."""
    return len(path) > 1 and path[-2] in _ATTN


def shard_transformer_params(full: dict, cfg, plan, rank: int) -> dict:
    """Rank ``rank``'s shard of the tp = 1 tree ``full`` (the port's
    ``init_params``, or one carried from the reference with
    :func:`transformer_params`) at ``plan``'s sharding, in its layout
    (``plan.decode_layout``): heads in contiguous blocks, ``d_ff`` and
    expert slices, the SSM's ``in_proj`` and conv cut section by
    section, the RG-LRU's (W x W) gates to their diagonal blocks, vocab
    rows padded with zeros to ``padded_vocab(tp)``.  Each shard is a
    copy: ``full`` may be freed.  Raises ``ValueError`` where ``full``
    or the result has other shapes than ``init_params``'s."""
    from repro_torch.models.transformer import SINGLE, param_shapes
    _check_shapes(full, param_shapes(cfg, SINGLE), "full")

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        return shard_leaf(path, t, cfg, plan, rank).clone()

    out = walk(full, ())
    _check_shapes(out, param_shapes(cfg, plan), f"rank {rank}'s shard")
    return out


def _check_shapes(tree, shapes, what: str, path: str = "") -> None:
    """Raise ``ValueError`` naming ``what`` and the path where ``tree``'s
    keys or leaf shapes part from ``shapes``."""
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{what}, {path or 'the root'}: keys {got}, "
                             f"want {sorted(shapes)}")
        for k in shapes:
            _check_shapes(tree[k], shapes[k], what,
                          f"{path}/{k}" if path else k)
    elif tuple(tree.shape) != shapes:
        raise ValueError(f"{what}, {path}: shape {tuple(tree.shape)}, want "
                         f"{shapes}")


def init_shard_params(gen, cfg, plans, rank: int) -> list[dict]:
    """Rank ``rank``'s shards, one for each plan of ``plans`` (the same
    tp; say the prefill and the decode layout), of the tp = 1 tree that
    ``init_params(gen, cfg)`` would draw, built one leaf at a time: each
    layer's leaves are drawn whole and only their slices kept, so the
    peak is the shards and one layer, not the full model.  The shards
    equal ``shard_transformer_params(init_params(gen, cfg), cfg, plan,
    rank)`` bit for bit (the same draws); a leaf whose cut is the same in
    every layout is one tensor shared by the trees."""
    from repro_torch.models.transformer import (SINGLE, init_params,
                                                param_shapes)
    plans = list(plans)
    extra = [{} for _ in plans[1:]]

    def keep(path, t):
        for store, plan in zip(extra, plans[1:]):
            if _layout_dependent(path):
                store.setdefault(path, []).append(
                    shard_leaf(path, t, cfg, plan, rank).clone())
        return shard_leaf(path, t, cfg, plans[0], rank).clone()

    first = init_params(gen, cfg, SINGLE, keep=keep)
    trees = [first]
    for store in extra:
        def swap(t, path):
            if isinstance(t, dict):
                return {k: swap(v, path + (k,)) for k, v in t.items()}
            got = store.get(path)
            if got is None:
                return t
            return torch.stack(got) if path[0] in _STACKS else got[0]
        trees.append(swap(first, ()))
    for tree, plan in zip(trees, plans):
        _check_shapes(tree, param_shapes(cfg, plan), f"rank {rank}'s shard")
    return trees
