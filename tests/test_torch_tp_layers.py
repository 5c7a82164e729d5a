"""Transformer tensor parallelism, layer by layer, against the reference.

Every collective of ``models.common`` (psum, pmax, pmin, the axis
index, the tiled gather with and without ``sp_int8``, the reduce-scatter
and its psum form, the grouped reduce of ``axis_index_groups``), both
``attn_forward`` branches (kv sharded; kv replicated, with several shards
sharing one kv group, and with a shard's q heads spanning whole groups,
reached where the heads do not divide by tp), ``decode_attn_forward``
with 2 and 4 sequence parts (one kv group, and two groups of 2 parts)
across a ring wrap, the MLP, MoE ``dense_tp`` at tp = 2 and ``ep_a2a``
at tp = 4 (also against ``dense_tp``, as ``tests/test_moe_ep.py``), the
SSD and RG-LRU blocks (forward with state, and a decode step), and
``embed_lookup``, ``vocab_parallel_xent`` and ``greedy_token`` with a
tie planted across two shards.

The same per-rank inputs, drawn with numpy from a seed (the shards of the
parameters cut by ``convert.shard_leaf``), go through the reference under
``shard_map`` over forced host devices, in ONE JAX subprocess for the
file (this file run with ``--reference``), and through the port in one
gloo job a tp size (this file run with ``--worker``, one process a
shard, torch on one thread).  Bounds: within ``TOL`` = 1e-5 of the
reference tensor's largest magnitude; the axis index, token ids and the
int8 gather (levels and float16 scales, dequantized) exactly.  The
meshes (``launch.mesh``) are held to the reference's shapes and axis
names, and to refusing a job of another size, in the 2-process job.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
B, S, D = 2, 16, 256


# ------------------------------------------------------------ the cases

def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cfg(arch):
    from repro_torch.configs import get
    return get(arch).reduced()


def _cut(path, full, cfg, tp, rank, decode_layout=False):
    """The port's splitter on one layer's leaves (no layer axis)."""
    from repro_torch import convert
    from repro_torch.models.transformer import ShardPlan
    plan = ShardPlan(tp, decode_layout=decode_layout)
    return {k: convert.shard_leaf(path + (k,), torch.as_tensor(v), cfg,
                                  plan, rank).numpy()
            for k, v in full.items()}


def collectives_case(tp):
    rng = _rng(10 + tp)
    per = [{"x": _f32(rng, B, S // tp, D),
            "full": _f32(rng, B, S, D, scale=3.0)} for _ in range(tp)]
    return {"kind": "collectives", "per": per}


def attn_case(tp, heads, kv, window=None, cap=None, causal=True, seq=S):
    """Attention weights of ``heads`` q and ``kv`` kv heads (hd 16), split
    as the reference's prefill layout does, on ``seq`` tokens."""
    from repro_torch.models.attention import AttnParamsSpec
    hd, d = 16, 64
    rng = _rng(heads * 7 + kv + tp)
    full = {"wq": _f32(rng, heads * hd, d, scale=d ** -0.5),
            "wk": _f32(rng, kv * hd, d, scale=d ** -0.5),
            "wv": _f32(rng, kv * hd, d, scale=d ** -0.5),
            "wo": _f32(rng, d, heads * hd, scale=(heads * hd) ** -0.5)}
    spec = AttnParamsSpec(heads, kv, hd, d, tp=tp)
    x = _f32(rng, B, seq, d)
    per = []
    for r in range(tp):
        ql = spec.q_local * hd
        p = {"wq": full["wq"][r * ql:(r + 1) * ql],
             "wo": full["wo"][:, r * ql:(r + 1) * ql]}
        for k in ("wk", "wv"):
            kl = spec.kv_local * hd
            p[k] = (full[k][r * kl:(r + 1) * kl] if spec.kv_sharded
                    else full[k])
        n = seq // tp
        per.append({"params": p, "x": x[:, r * n:(r + 1) * n]})
    return {"kind": "attn", "per": per,
            "opts": {"heads": heads, "kv": kv, "hd": hd, "d": d,
                     "window": window, "cap": cap, "causal": causal}}


def decode_case(tp, heads, kv, window=None, cap=None):
    """Decode-layout weights and a random ring of 4 slots a part; steps
    at positions 5, 9 (past a ring of 2 parts), 13, 19 (past a ring of 4)
    and 2 (slots past the position invalid again)."""
    from repro_torch.models.attention import AttnParamsSpec
    hd, d = 16, 64
    rng = _rng(100 + heads * 7 + kv + tp)
    full = {"wq": _f32(rng, heads * hd, d, scale=d ** -0.5),
            "wk": _f32(rng, kv * hd, d, scale=d ** -0.5),
            "wv": _f32(rng, kv * hd, d, scale=d ** -0.5),
            "wo": _f32(rng, d, heads * hd, scale=(heads * hd) ** -0.5)}
    spec = AttnParamsSpec(heads, kv, hd, d, tp=tp)
    K, r_parts = spec.decode_kv_shards, spec.decode_seq_parts
    s_loc = 4
    positions = [5, 9, 13, 19, 2]
    xs = _f32(rng, len(positions), B, d)
    per = []
    for r in range(tp):
        g = r // r_parts
        ql, kl = spec.decode_q_local * hd, spec.decode_kv_local * hd
        keep = heads // tp * hd
        p = {"wq": full["wq"][g * ql:(g + 1) * ql],
             "wk": full["wk"][g * kl:(g + 1) * kl],
             "wv": full["wv"][g * kl:(g + 1) * kl],
             "wo": full["wo"][:, r * keep:(r + 1) * keep]}
        per.append({"params": p, "xs": xs,
                    "ck": _f32(rng, B, spec.decode_kv_local, s_loc, hd),
                    "cv": _f32(rng, B, spec.decode_kv_local, s_loc, hd)})
    return {"kind": "decode_attn", "per": per,
            "opts": {"heads": heads, "kv": kv, "hd": hd, "d": d,
                     "window": window, "cap": cap,
                     "positions": positions}}


def mlp_case(tp):
    cfg = _cfg("gemma2-2b")
    rng = _rng(200 + tp)
    ff = cfg.d_ff
    full = {"w_up": _f32(rng, ff, D, scale=D ** -0.5),
            "w_gate": _f32(rng, ff, D, scale=D ** -0.5),
            "w_down": _f32(rng, D, ff, scale=ff ** -0.5)}
    x = _f32(rng, B, S, D)
    n = S // tp
    return {"kind": "mlp", "opts": {"act": "gelu_tanh"},
            "per": [{"params": _cut(("mlp",), full, cfg, tp, r),
                     "x": x[:, r * n:(r + 1) * n]} for r in range(tp)]}


def moe_case(tp, impl):
    cfg = dataclasses.replace(_cfg("mixtral-8x22b"), moe_impl=impl)
    rng = _rng(300)             # the same weights for both plans
    E, ff = cfg.n_experts, cfg.d_ff
    full = {"router": _f32(rng, E, D, scale=D ** -0.5),
            "w_gate": _f32(rng, E, ff, D, scale=D ** -0.5),
            "w_up": _f32(rng, E, ff, D, scale=D ** -0.5),
            "w_down": _f32(rng, E, D, ff, scale=ff ** -0.5)}
    x = _f32(rng, B, S, D)
    n = S // tp
    return {"kind": "moe", "opts": {"impl": impl},
            "per": [{"params": _cut(("moe",), full, cfg, tp, r),
                     "x": x[:, r * n:(r + 1) * n]} for r in range(tp)]}


def ssm_case(tp):
    from repro_torch.models import ssm
    cfg = _cfg("mamba2-370m")
    full = {k: v.numpy() for k, v in ssm.init_ssm(
        torch.Generator().manual_seed(400), cfg.ssm_spec()).items()}
    rng = _rng(400)
    full["A_log"] = full["A_log"] + _f32(rng, *full["A_log"].shape,
                                         scale=0.1)
    full["norm_g"] = _f32(rng, *full["norm_g"].shape, scale=0.1)
    x = _f32(rng, B, S, D)
    x1 = _f32(rng, B, D)
    n = S // tp
    return {"kind": "ssm", "per": [
        {"params": _cut(("ssm",), full, cfg, tp, r),
         "x": x[:, r * n:(r + 1) * n], "x1": x1} for r in range(tp)]}


def rglru_case(tp):
    from repro_torch.models import rglru
    cfg = _cfg("recurrentgemma-9b")
    full = {k: v.numpy() for k, v in rglru.init_rglru(
        torch.Generator().manual_seed(500), cfg.rglru_spec()).items()}
    rng = _rng(500)
    x = _f32(rng, B, S, D)
    x1 = _f32(rng, B, D)
    n = S // tp
    return {"kind": "rglru", "per": [
        {"params": _cut(("rec",), full, cfg, tp, r),
         "x": x[:, r * n:(r + 1) * n], "x1": x1} for r in range(tp)]}


def vocab_case(tp):
    """A vocab-parallel head (512 rows, softcapped as gemma's) with a tie
    planted across shards: row 10 (shard 0) is copied to the last shard's
    row 500 and ``x``'s first rows point along it, so both shards hold the
    largest logit and the lowest id must win."""
    cfg = _cfg("gemma2-2b")
    rng = _rng(600)
    V = cfg.padded_vocab(tp)
    emb = _f32(rng, V, D, scale=0.02)
    emb[500] = emb[10]
    x = _f32(rng, B, S, D, scale=0.1)
    x[:, :4] = emb[10] * 40.0
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, 0] = 500
    vl = V // tp
    return {"kind": "vocab", "per": [
        {"embed": emb[r * vl:(r + 1) * vl], "x": x, "tokens": tokens,
         "labels": labels} for r in range(tp)]}


def build_cases() -> dict:
    cases = {}
    for tp in (2, 4):
        cases[f"collectives tp{tp}"] = dict(collectives_case(tp), tp=tp)
        cases[f"attn kv sharded tp{tp}"] = dict(
            attn_case(tp, 8, 4, window=5, cap=20.0), tp=tp)
        cases[f"attn kv shared group tp{tp}"] = dict(
            attn_case(tp, 8, 1), tp=tp)
        cases[f"decode 1 group x {tp} parts"] = dict(
            decode_case(tp, 4, 1, cap=20.0), tp=tp)
    cases["attn kv whole groups tp3"] = dict(
        attn_case(3, 8, 4, window=7, seq=24), tp=3)
    cases["attn kv shared group noncausal tp2"] = dict(
        attn_case(2, 4, 1, causal=False), tp=2)
    cases["decode 2 groups x 2 parts tp4"] = dict(
        decode_case(4, 8, 2, window=6), tp=4)
    cases["mlp tp2"] = dict(mlp_case(2), tp=2)
    cases["moe dense_tp tp2"] = dict(moe_case(2, "dense_tp"), tp=2)
    cases["moe dense_tp tp4"] = dict(moe_case(4, "dense_tp"), tp=4)
    cases["moe ep_a2a tp4"] = dict(moe_case(4, "ep_a2a"), tp=4)
    cases["ssm tp2"] = dict(ssm_case(2), tp=2)
    cases["rglru tp2"] = dict(rglru_case(2), tp=2)
    cases["vocab tp2"] = dict(vocab_case(2), tp=2)
    cases["vocab tp4"] = dict(vocab_case(4), tp=4)
    return cases


# ------------------------------------------------------ the port's side

def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(v) for v in tree)
    return torch.as_tensor(np.asarray(tree))


def _n(tree):
    if isinstance(tree, dict):
        return {k: _n(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_n(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def port_probe(case: dict, inp: dict, tp: int) -> dict:
    """One case on this rank's inputs (the port, in a joined job)."""
    from repro_torch.models import attention, common, mlp, moe, rglru, ssm
    from repro_torch.models import transformer
    from repro_torch.models.common import ShardCtx
    ctx = ShardCtx(tp_axis="model", tp_size=tp)
    kind, o, i = case["kind"], case.get("opts", {}), _t(inp)
    if kind == "collectives":
        x, full = i["x"], i["full"]
        out = {"psum": common.psum_tp(x, ctx), "pmax": common.pmax_tp(x, ctx),
               "pmin": common.pmin_tp(x, ctx),
               "index": torch.tensor(common.axis_index(ctx)),
               "gather": common.sp_all_gather(x, ctx),
               "gather2": common.sp_all_gather(x, ctx, axis=2),
               "gather_int8": common.sp_all_gather(
                   x, dataclasses.replace(ctx, sp_int8=True)),
               "scatter": common.sp_reduce_scatter(full, ctx),
               "scatter_flat": common.sp_reduce_scatter(
                   full, dataclasses.replace(ctx, seq_parallel=False))}
        if tp == 4:
            groups = [[0, 1], [2, 3]]
            out["psum_groups"] = common.psum_tp(x, ctx, groups)
            out["pmax_groups"] = common.pmax_tp(x, ctx, groups)
        return out
    if kind in ("attn", "decode_attn"):
        spec = attention.AttnParamsSpec(o["heads"], o["kv"], o["hd"], o["d"],
                                        tp=tp)
        if kind == "attn":
            y, (k, v) = attention.attn_forward(
                i["params"], i["x"], spec, ctx, causal=o["causal"],
                window=o["window"], attn_softcap=o["cap"], q_chunk=8,
                kv_chunk=8, return_kv=True)
            return {"y": y, "k": k, "v": v}
        ck, cv = i["ck"].clone(), i["cv"].clone()
        ys = []
        for x, pos in zip(i["xs"], o["positions"]):
            y, ck, cv = attention.decode_attn_forward(
                i["params"], x, ck, cv, pos, spec, ctx, window=o["window"],
                attn_softcap=o["cap"])
            ys.append(y)
        return {"y": torch.stack(ys), "ck": ck, "cv": cv}
    if kind == "mlp":
        return {"y": mlp.mlp_forward(i["params"], i["x"], ctx, o["act"])}
    if kind == "moe":
        cfg = dataclasses.replace(_cfg("mixtral-8x22b"), moe_impl=o["impl"])
        y, aux = moe.moe_forward(i["params"], i["x"], cfg.moe_spec(), ctx)
        return {"y": y, "aux": aux}
    if kind == "ssm":
        spec = _cfg("mamba2-370m").ssm_spec()
        y, (st, tail) = ssm.ssm_forward(i["params"], i["x"], spec, ctx,
                                        return_state=True)
        y1, (st1, tail1) = ssm.ssm_decode_step(i["params"], i["x1"],
                                               (st, tail), spec, ctx)
        return {"y": y, "state": st, "tail": tail, "y1": y1, "state1": st1,
                "tail1": tail1}
    if kind == "rglru":
        spec = _cfg("recurrentgemma-9b").rglru_spec()
        y, (h, tail) = rglru.rglru_block_forward(i["params"], i["x"], spec,
                                                 ctx, return_state=True)
        y1, (h1, tail1) = rglru.rglru_decode_step(i["params"], i["x1"],
                                                  (h, tail), spec, ctx)
        return {"y": y, "h": h, "tail": tail, "y1": y1, "h1": h1,
                "tail1": tail1}
    if kind == "vocab":
        cfg = _cfg("gemma2-2b")
        plan = transformer.ShardPlan(tp)
        p = {"embed": i["embed"]}
        ids, best = transformer.greedy_token(i["x"][:, 0], p, cfg, ctx)
        return {"embed": transformer.embed_lookup(p, i["tokens"], cfg, plan,
                                                  ctx),
                "xent": transformer.vocab_parallel_xent(i["x"], i["labels"],
                                                        p, cfg, ctx),
                "greedy": ids, "greedy_max": best,
                "greedy_all": transformer.greedy_token(
                    i["x"].reshape(-1, D), p, cfg, ctx)[0]}
    raise ValueError(kind)


def mesh_probe(tp: int) -> dict:
    """In a joined job of ``tp``: the production meshes' refusals, and a
    (1, tp) ("data", "model") mesh whose model axis sums."""
    from repro_torch.launch import mesh
    from repro_torch.models import common
    out = {}
    for multi in (False, True):
        try:
            mesh.make_production_mesh(multi_pod=multi)
        except ValueError as e:
            out[f"production multi_pod={multi}"] = str(e)
    m = mesh.make_mesh((1, tp), ("data", "model"))
    ctxs = [common.ShardCtx(tp_axis=a, tp_size=n)
            for a, n in zip(m.axis_names, m.shape)]
    coords = tuple(int(common.axis_index(c)) for c in ctxs)
    out.update(shape=m.shape, axes=m.axis_names, coords=coords,
               ranks=m.ranks, data=dict(zip(m.axis_names, m.shape))["data"],
               model_index=coords[1],
               psum=float(common.psum_tp(
                   torch.tensor([float(coords[1] + 1)]), ctxs[1])[0]))
    return out


def _worker_main(src: str, out_dir: str) -> int:
    from repro_torch.dist import init_from_env
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    ctx = init_from_env()
    tp, rank = ctx.process_count, ctx.process_index
    make_mesh((tp,), ("model",))
    with open(src, "rb") as f:
        cases = pickle.load(f)
    out = {}
    with torch.inference_mode():
        for name, case in cases.items():
            if case["tp"] == tp:
                out[name] = _n(port_probe(case, case["per"][rank], tp))
    out["mesh"] = mesh_probe(tp)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    ctx.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


# ------------------------------------------------- the reference's side

def _reference_main(src: str, dst: str) -> None:
    """Every case through the reference under ``shard_map`` at its tp (4
    forced host devices), each rank's inputs its own shard."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import all_configs
    from repro.models import attention, common, mlp, moe, rglru, ssm
    from repro.models import transformer
    from repro.models.common import ShardCtx

    with open(src, "rb") as f:
        cases = pickle.load(f)

    def rcfg(arch):
        return all_configs()[arch].reduced()

    def probe(case, i, tp):
        ctx = ShardCtx(tp_axis="model", tp_size=tp)
        kind, o = case["kind"], case.get("opts", {})
        if kind == "collectives":
            x, full = i["x"], i["full"]
            out = {"psum": common.psum_tp(x, ctx),
                   "pmax": jax.lax.pmax(x, "model"),
                   "pmin": jax.lax.pmin(x, "model"),
                   "index": common.axis_index(ctx),
                   "gather": common.sp_all_gather(x, ctx),
                   "gather2": common.sp_all_gather(x, ctx, axis=2),
                   "gather_int8": common.sp_all_gather(
                       x, dataclasses.replace(ctx, sp_int8=True)),
                   "scatter": common.sp_reduce_scatter(full, ctx),
                   "scatter_flat": common.sp_reduce_scatter(
                       full, dataclasses.replace(ctx, seq_parallel=False))}
            if tp == 4:
                groups = [[0, 1], [2, 3]]
                out["psum_groups"] = jax.lax.psum(
                    x, "model", axis_index_groups=groups)
                out["pmax_groups"] = jax.lax.pmax(
                    x, "model", axis_index_groups=groups)
            return out
        if kind in ("attn", "decode_attn"):
            spec = attention.AttnParamsSpec(o["heads"], o["kv"], o["hd"],
                                            o["d"], tp=tp)
            if kind == "attn":
                y, (k, v) = attention.attn_forward(
                    i["params"], i["x"], spec, ctx, causal=o["causal"],
                    window=o["window"], attn_softcap=o["cap"], q_chunk=8,
                    kv_chunk=8, return_kv=True)
                return {"y": y, "k": k, "v": v}
            ck, cv = i["ck"], i["cv"]
            ys = []
            for x, pos in zip(i["xs"], o["positions"]):
                y, ck, cv = attention.decode_attn_forward(
                    i["params"], x, ck, cv, jnp.int32(pos), spec, ctx,
                    window=o["window"], attn_softcap=o["cap"])
                ys.append(y)
            return {"y": jnp.stack(ys), "ck": ck, "cv": cv}
        if kind == "mlp":
            return {"y": mlp.mlp_forward(i["params"], i["x"], ctx, o["act"])}
        if kind == "moe":
            cfg = dataclasses.replace(rcfg("mixtral-8x22b"),
                                      moe_impl=o["impl"])
            y, aux = moe.moe_forward(i["params"], i["x"], cfg.moe_spec(), ctx)
            return {"y": y, "aux": aux}
        if kind == "ssm":
            spec = rcfg("mamba2-370m").ssm_spec()
            y, (st, tail) = ssm.ssm_forward(i["params"], i["x"], spec, ctx,
                                            return_state=True)
            y1, (st1, tail1) = ssm.ssm_decode_step(i["params"], i["x1"],
                                                   (st, tail), spec, ctx)
            return {"y": y, "state": st, "tail": tail, "y1": y1,
                    "state1": st1, "tail1": tail1}
        if kind == "rglru":
            spec = rcfg("recurrentgemma-9b").rglru_spec()
            y, (h, tail) = rglru.rglru_block_forward(
                i["params"], i["x"], spec, ctx, return_state=True)
            y1, (h1, tail1) = rglru.rglru_decode_step(
                i["params"], i["x1"], (h, tail), spec, ctx)
            return {"y": y, "h": h, "tail": tail, "y1": y1, "h1": h1,
                    "tail1": tail1}
        if kind == "vocab":
            cfg = rcfg("gemma2-2b")
            plan = transformer.ShardPlan(tp)
            p = {"embed": i["embed"]}
            ids, best = transformer.greedy_token(i["x"][:, 0], p, cfg, ctx)
            return {"embed": transformer.embed_lookup(p, i["tokens"], cfg,
                                                      plan, ctx),
                    "xent": transformer.vocab_parallel_xent(
                        i["x"], i["labels"], p, cfg, ctx),
                    "greedy": ids, "greedy_max": best,
                    "greedy_all": transformer.greedy_token(
                        i["x"].reshape(-1, D), p, cfg, ctx)[0]}
        raise ValueError(kind)

    def one(item):
        name, case = item
        tp = case["tp"]
        mesh = jax.make_mesh((tp,), ("model",), devices=jax.devices()[:tp])
        stacked = jax.tree.map(lambda *a: np.stack(a), *case["per"])

        def per_chip(i):
            i = jax.tree.map(lambda a: a[0], i)
            return jax.tree.map(lambda a: jnp.asarray(a)[None],
                                probe(case, i, tp))
        f = jax.jit(jax.shard_map(per_chip, mesh=mesh, in_specs=P("model"),
                                  out_specs=P("model"), check_vma=False))
        return name, jax.tree.map(np.asarray, f(stacked))

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(4) as pool:
        out = dict(pool.map(one, cases.items()))
    with open(dst, "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------------- the tests

CASE_NAMES = list(build_cases()) if __name__ != "__main__" else []


@pytest.fixture(scope="module")
def runs():
    """name -> (reference (tp, ...) per output, [each rank's port
    outputs])."""
    from repro_torch.launch.dist_smoke import Job
    cases = build_cases()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "cases.pkl")
        with open(src, "wb") as f:
            pickle.dump(cases, f)
        tps = sorted({c["tp"] for c in cases.values()})
        jobs = {}
        for tp in tps:
            os.makedirs(os.path.join(tmp, str(tp)))
            jobs[tp] = Job([os.path.abspath(__file__), "--worker", src,
                            os.path.join(tmp, str(tp))], procs=tp)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(ROOT, "src"),
                        os.environ.get("PYTHONPATH", "")]))
        dst = os.path.join(tmp, "ref.pkl")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--reference", src, dst], env=env,
                              capture_output=True, text=True, timeout=300)
        port = {}
        for tp, job in jobs.items():
            outs = job.wait(300)
            for pid, (rc, _, err) in enumerate(outs):
                assert rc == 0, f"tp {tp} worker {pid}: {err[-4000:]}"
            port[tp] = []
            for r in range(tp):
                with open(os.path.join(tmp, str(tp), f"rank{r}.pkl"),
                          "rb") as f:
                    port[tp].append(pickle.load(f))
        assert proc.returncode == 0, proc.stderr[-4000:]
        with open(dst, "rb") as f:
            ref = pickle.load(f)
    out = {n: (ref[n], [p[n] for p in port[c["tp"]]])
           for n, c in cases.items()}
    out["mesh"] = (None, [p["mesh"] for p in port[2]])
    return out


def _gap(want, got) -> float:
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, (want.shape, got.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    diff = float(np.max(np.abs(want - got))) if want.size else 0.0
    return diff / scale if scale > 0 else diff


EXACT = {"index", "greedy", "greedy_all", "gather_int8"}


@pytest.mark.parametrize("name", CASE_NAMES)
def test_layer_matches_the_reference(name, runs):
    ref, port = runs[name]
    for r, got in enumerate(port):
        assert set(got) == set(ref), (sorted(got), sorted(ref))
        for k, want in ref.items():
            w = np.asarray(want[r])
            if k in EXACT:
                np.testing.assert_array_equal(got[k], w, err_msg=k)
            else:
                assert _gap(w, got[k]) <= TOL, (k, r, _gap(w, got[k]))


def test_planted_tie_across_shards_takes_the_lowest_id(runs):
    """Rows 10 (shard 0) and 500 (the last shard) are equal and hold the
    largest logit for the first 4 positions of each sequence."""
    for name in ("vocab tp2", "vocab tp4"):
        _, port = runs[name]
        for got in port:
            assert got["greedy"].tolist() == [10, 10]
            ids = got["greedy_all"].reshape(B, S)
            assert (ids[:, :4] == 10).all()


def test_int8_gather_within_one_level(runs):
    """The int8 gather is the exact gather within a level (amax / 127) a
    token."""
    ref, port = runs["collectives tp4"]
    for got in port:
        amax = np.max(np.abs(got["gather"]), axis=-1, keepdims=True)
        assert np.all(np.abs(got["gather_int8"] - got["gather"])
                      <= amax / 127 * (1 + 1e-3) + 1e-6)


def test_ep_a2a_matches_dense_tp(runs):
    """The two MoE plans on the same weights at tp = 4, as
    ``tests/test_moe_ep.py`` holds the reference's."""
    _, dense = runs["moe dense_tp tp4"]
    _, ep = runs["moe ep_a2a tp4"]
    for a, b in zip(dense, ep):
        np.testing.assert_allclose(a["y"], b["y"], rtol=2e-4, atol=2e-5)
        assert float(a["aux"]) == float(b["aux"])


def test_ring_wraps_in_the_decode_cases():
    """The decode positions pass the ring (4 slots a part) of every
    case."""
    for name, case in build_cases().items():
        if case["kind"] == "decode_attn":
            from repro_torch.models.attention import AttnParamsSpec
            o = case["opts"]
            spec = AttnParamsSpec(o["heads"], o["kv"], o["hd"], o["d"],
                                  tp=case["tp"])
            ring = spec.decode_seq_parts * case["per"][0]["ck"].shape[2]
            assert max(o["positions"]) >= ring, name


def test_production_mesh_shapes_are_the_references(monkeypatch):
    """``make_production_mesh``'s shapes and axis names are the
    reference's (its ``jax.make_mesh`` call captured)."""
    import repro.launch.mesh as ref_mesh
    from repro_torch.launch import mesh
    monkeypatch.setattr(ref_mesh.jax, "make_mesh", lambda s, a: (s, a))
    for multi in (False, True):
        assert mesh.production_shape(multi) == ref_mesh.make_production_mesh(
            multi_pod=multi)
    assert mesh.production_shape() == ((16, 16), ("data", "model"))
    assert mesh.production_shape(True) == ((2, 16, 16),
                                           ("pod", "data", "model"))


def test_mesh_refuses_a_job_of_another_size():
    """Outside a job (one process) a mesh of one entry builds; others
    are refused with both sizes named."""
    from repro_torch.launch import mesh
    from repro_torch.models import common
    m = mesh.make_mesh((1,), ("model",))
    assert (m.shape, m.axis_names, m.ranks, m.size) == ((1,), ("model",),
                                                         [0], 1)
    with pytest.raises(ValueError, match="needs 2 processes but the job "
                                         "has 1"):
        mesh.make_mesh((2,), ("model",))
    with pytest.raises(ValueError, match="needs 256 processes but the job "
                                         "has 1"):
        mesh.make_production_mesh()
    with pytest.raises(ValueError, match="2 axes but 1 names"):
        mesh.make_mesh((1, 1), ("model",))
    common.unbind_axes()


def test_meshes_in_a_two_process_job(runs):
    """In the 2-process job: both production meshes refused, naming 256
    (512) and 2; a (1, 2) ("data", "model") mesh with row-major ranks
    whose model axis sums over both processes."""
    _, port = runs["mesh"]
    for rank, got in enumerate(port):
        assert "needs 256 processes but the job has 2" in got[
            "production multi_pod=False"]
        assert "needs 512 processes but the job has 2" in got[
            "production multi_pod=True"]
        assert got["shape"] == (1, 2) and got["axes"] == ("data", "model")
        assert got["coords"] == (0, rank) and got["ranks"] == [[0, 1]]
        assert got["data"] == 1 and got["model_index"] == rank
        assert got["psum"] == 3.0


def test_grouped_reduce_refuses_other_groups(monkeypatch):
    from repro_torch.models import common
    monkeypatch.setattr(common, "_AXES", {})
    common.bind_axis(common.Axis("model", None, 0, 4, {2: None}))
    ctx = common.ShardCtx(tp_axis="model", tp_size=4)
    with pytest.raises(ValueError, match="consecutive"):
        common.psum_tp(torch.ones(2), ctx, [[0, 2], [1, 3]])
    with pytest.raises(RuntimeError, match="has 4 processes"):
        common.psum_tp(torch.ones(2), common.ShardCtx(tp_axis="model",
                                                      tp_size=2))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        _reference_main(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker_main(*sys.argv[2:4]))
