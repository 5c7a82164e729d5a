"""The transformer family's blocks against the reference's, on the same
inputs (numpy seeds): norms, RoPE and M-RoPE, softcap, activations, the
chunked attention on a grid of chunkings, windows and softcaps, the ring-
buffer decode across a wrap, the MoE router and capacity dispatch (ties,
drops), the SSD scan over several chunks and the RG-LRU scan and decode
steps.

Tolerance: floating outputs hold within ``TOL`` = 2e-5 of the reference
tensor's largest magnitude; integer outputs (positions, expert ids,
dispatch masks) are exact.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import frontend as r_frontend
from repro.models import mlp as r_mlp
from repro.models import moe as r_moe
from repro.models import rglru as r_rglru
from repro.models import ssm as r_ssm
from repro_torch.launch.arch_check import rel_gap
from repro_torch.models import attention as p_attn
from repro_torch.models import common as p_common
from repro_torch.models import frontend as p_frontend
from repro_torch.models import mlp as p_mlp
from repro_torch.models import moe as p_moe
from repro_torch.models import rglru as p_rglru
from repro_torch.models import ssm as p_ssm

# CPU parity: within 2e-5 of the reference tensor's largest magnitude,
# tightened from the 1e-4 bar (``arch_check.TOL``, the card's) to about
# three times the largest gap measured (6.85e-6, the SSD block on a
# 256-token sequence; 2.1e-6 at most on the whole models)
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def t(x):
    return torch.as_tensor(np.array(x))


def close(ref, got, tol=TOL):
    gap = rel_gap(np.asarray(ref), got)
    assert gap <= tol, gap


def tree_t(tree):
    return jax.tree.map(lambda a: t(np.asarray(a)), tree)


def jit(fn, *static, **kw):
    """The reference function compiled once (eager JAX dispatches its
    scans op by op, several times slower on this CPU)."""
    return jax.jit(functools.partial(fn, **kw), static_argnums=static)


# ------------------------------------------------------------ common / mlp

def test_norms_and_softcap():
    x, g, b = rnd(0, 3, 5, 64, scale=3.0), rnd(1, 64), rnd(2, 64)
    close(r_common.rms_norm(x, g), p_common.rms_norm(t(x), t(g)))
    close(r_common.layer_norm(x, g, b), p_common.layer_norm(t(x), t(g), t(b)))
    close(r_common.softcap(x * 30, 50.0), p_common.softcap(t(x) * 30, 50.0))
    assert p_common.softcap(t(x), None) is not None


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh", "relu"])
def test_act_fn(act):
    x = rnd(3, 1000, scale=4.0)
    close(r_mlp.act_fn(act)(x), p_mlp.act_fn(act)(t(x)), tol=1e-6)


def test_rglru_gelu_is_jax_default():
    x = rnd(4, 1000, scale=4.0)
    close(jax.nn.gelu(x), p_mlp.gelu(t(x)), tol=1e-6)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_forward(gated):
    d, f = 32, 48
    params = {"w_up": rnd(5, f, d), "w_down": rnd(6, d, f)}
    if gated:
        params["w_gate"] = rnd(7, f, d)
    x = rnd(8, 2, 6, d)
    close(r_mlp.mlp_forward(params, x, r_common.UNSHARDED, "gelu"),
          p_mlp.mlp_forward(tree_t(params), t(x), p_common.UNSHARDED, "gelu"))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    x = rnd(9, 2, 12, 3, 16)
    pos = np.arange(12)[None, :] + np.array([[0], [100]])
    close(r_common.apply_rope(x, jnp.asarray(pos), theta),
          p_common.apply_rope(t(x), t(pos), theta))


def test_mrope_and_positions():
    x = rnd(10, 2, 12, 3, 64)
    mp = r_frontend.mrope_positions(2, 12, image_start=1, grid_t=1,
                                    grid_h=2, grid_w=4)
    pmp = p_frontend.mrope_positions(2, 12, image_start=1, grid_t=1,
                                     grid_h=2, grid_w=4)
    assert pmp.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(mp), pmp.numpy())
    close(jit(r_common.apply_mrope, 2)(x, mp, (14, 9, 9)),
          p_common.apply_mrope(t(x), pmp, (14, 9, 9)))
    pos = jnp.arange(12)[None, :]
    np.testing.assert_array_equal(
        np.asarray(r_common.text_mrope_positions(pos)),
        p_common.text_mrope_positions(t(pos)).numpy())


@pytest.mark.parametrize("grid", [(1, 0, 0), (1, 2, 2), (2, 3, 2),
                                  (1, 1, 5)])
def test_mrope_positions_exact(grid):
    gt, gh, gw = grid
    ref = r_frontend.mrope_positions(3, 20, 2, gt, gh, gw)
    got = p_frontend.mrope_positions(3, 20, 2, gt, gh, gw)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_frontend_stubs_shapes():
    gen = torch.Generator().manual_seed(0)
    a = p_frontend.audio_embeds(gen, 2, 64, 32)
    ra = r_frontend.audio_embeds(jax.random.PRNGKey(0), 2, 64, 32)
    assert tuple(a.shape) == ra.shape and a.dtype == torch.float32
    emb, pos = p_frontend.vision_embeds(gen, 2, 8, 32, 16)
    remb, rpos = r_frontend.vision_embeds(jax.random.PRNGKey(0), 2, 8, 32, 16)
    assert tuple(emb.shape) == remb.shape and emb.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(rpos), pos.numpy())
    assert pos.dtype == torch.int32


def test_softmax_xent():
    lg, lab = rnd(11, 3, 7, 50), np.random.default_rng(12).integers(
        0, 50, (3, 7))
    valid = (np.random.default_rng(13).random((3, 7)) > 0.3).astype(
        np.float32)
    close(r_common.softmax_xent(lg, lab), p_common.softmax_xent(t(lg), t(lab)))
    close(r_common.softmax_xent(lg, lab, valid),
          p_common.softmax_xent(t(lg), t(lab), t(valid)))


def test_tensor_parallel_context_raises():
    """A tp > 1 context is static (it builds, as the reference's does);
    outside a joined job, with no mesh bound to its axis, its first
    collective raises an error that names the missing group."""
    p_common.unbind_axes()
    ctx = p_common.ShardCtx(tp_axis="model", tp_size=2)
    assert ctx.tp == 2
    with pytest.raises(RuntimeError,
                       match="no process group is bound to the mesh axis "
                             "'model'.*make_mesh"):
        p_common.psum_tp(torch.ones(3), ctx)
    with pytest.raises(RuntimeError, match="axis 'model'"):
        p_common.axis_index(ctx)
    assert p_common.ShardCtx(tp_axis=None, tp_size=2).tp == 1
    x = torch.ones(2, 4, 3)
    assert p_common.psum_tp(x, p_common.ShardCtx(tp_axis=None,
                                                 tp_size=2)) is x


# ------------------------------------------------------------ attention

GRID = list(itertools.product(
    [(16, 1, 2), (64, 2, 1)],        # (S, G, Hg)
    [8, 64],                         # chunk: several, one
    [None, 7, 16],                   # window
    [None, 30.0],                    # softcap
    [True, False]))                  # causal


@pytest.mark.parametrize("shape,chunk,window,cap,causal", GRID)
def test_chunked_attention_grid(shape, chunk, window, cap, causal):
    S, G, Hg = shape
    B, hd = 2, 8
    q = rnd(S + G, B, S, G, Hg, hd)
    k = rnd(S + G + 1, B, S, G, hd)
    v = rnd(S + G + 2, B, S, G, hd)
    kw = dict(causal=causal, window=window, attn_softcap=cap,
              q_chunk=chunk, kv_chunk=chunk)
    close(jit(r_attn.chunked_attention, **kw)(q, k, v),
          p_attn.chunked_attention(t(q), t(k), t(v), **kw))


@pytest.mark.parametrize("q_chunk,kv_chunk", [(16, 32), (32, 16), (16, 16)])
def test_chunked_attention_window_below_seq(q_chunk, kv_chunk):
    """Several query and kv chunks, a window shorter than the sequence:
    whole blocks fall outside it on both sides of the diagonal."""
    B, S, G, Hg, hd = 1, 128, 2, 2, 16
    q, k, v = rnd(20, B, S, G, Hg, hd), rnd(21, B, S, G, hd), rnd(
        22, B, S, G, hd)
    for causal in (True, False):
        kw = dict(causal=causal, window=24, attn_softcap=50.0,
                  q_chunk=q_chunk, kv_chunk=kv_chunk)
        close(jit(r_attn.chunked_attention, **kw)(q, k, v),
              p_attn.chunked_attention(t(q), t(k), t(v), **kw))


def _attn_params(seed, spec):
    hd, d = spec.head_dim, spec.d_model
    return {"wq": rnd(seed, spec.q_local * hd, d, scale=d ** -0.5),
            "wk": rnd(seed + 1, spec.kv_local * hd, d, scale=d ** -0.5),
            "wv": rnd(seed + 2, spec.kv_local * hd, d, scale=d ** -0.5),
            "wo": rnd(seed + 3, d, spec.q_local * hd, scale=d ** -0.5)}


@pytest.mark.parametrize("mrope", [False, True])
def test_attn_forward_gqa(mrope):
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, d_model=32)
    rspec, pspec = r_attn.AttnParamsSpec(**kw), p_attn.AttnParamsSpec(**kw)
    params = _attn_params(30, rspec)
    x = rnd(31, 2, 32, 32)
    extra = dict(mrope_sections=(4, 2, 2)) if mrope else {}
    ry, (rk, rv) = r_attn.attn_forward(params, x, rspec, r_common.UNSHARDED,
                                       window=8, attn_softcap=20.0,
                                       q_chunk=8, kv_chunk=16,
                                       return_kv=True, **extra)
    py, (pk, pv) = p_attn.attn_forward(tree_t(params), t(x), pspec,
                                       p_common.UNSHARDED, window=8,
                                       attn_softcap=20.0, q_chunk=8,
                                       kv_chunk=16, return_kv=True, **extra)
    close(ry, py)
    close(rk, pk)
    close(rv, pv)


def test_attn_spec_properties():
    for kw in (dict(n_heads=48, n_kv_heads=8, head_dim=128, d_model=6144),
               dict(n_heads=16, n_kv_heads=1, head_dim=256, d_model=4096,
                    replicated=True)):
        r, p = r_attn.AttnParamsSpec(**kw), p_attn.AttnParamsSpec(**kw)
        for name in ("q_local", "kv_sharded", "kv_local", "group_size",
                     "decode_kv_shards", "decode_seq_parts",
                     "decode_q_local", "decode_kv_local"):
            assert getattr(r, name) == getattr(p, name), name
    assert p_attn.decode_groups(p, p_common.UNSHARDED) is None


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attn_across_ring_wrap(window):
    """Thirteen steps into a ring of 8 slots: the write slot, the
    clamping and the slot-index validity arithmetic of the reference, step
    by step, the caches included."""
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, d_model=32)
    rspec, pspec = r_attn.AttnParamsSpec(**kw), p_attn.AttnParamsSpec(**kw)
    params = _attn_params(40, rspec)
    pparams = tree_t(params)
    ck = rnd(41, 2, 2, 8, 16)
    cv = rnd(42, 2, 2, 8, 16)
    pck, pcv = t(ck), t(cv)
    step = jit(r_attn.decode_attn_forward, 5, 6, window=window,
               attn_softcap=30.0)
    for pos in range(13):
        x = rnd(50 + pos, 2, 32)
        ry, ck, cv = step(params, x, ck, cv, jnp.int32(pos), rspec,
                          r_common.UNSHARDED)
        py, pck, pcv = p_attn.decode_attn_forward(
            pparams, t(x), pck, pcv, pos, pspec, p_common.UNSHARDED,
            window=window, attn_softcap=30.0)
        close(ry, py)
        close(ck, pck)
        close(cv, pcv)


def test_decode_cross_attention():
    kw = dict(n_heads=4, n_kv_heads=4, head_dim=8, d_model=32)
    rspec, pspec = r_attn.AttnParamsSpec(**kw), p_attn.AttnParamsSpec(**kw)
    params = _attn_params(60, rspec)
    xk, xv, x = rnd(61, 2, 4, 24, 8), rnd(62, 2, 4, 24, 8), rnd(63, 2, 32)
    ry, _, _ = r_attn.decode_attn_forward(
        params, x, xk, xv, jnp.int32(3), rspec, r_common.UNSHARDED,
        rope_theta=None, cross_kv=(xk, xv))
    py, _, _ = p_attn.decode_attn_forward(
        tree_t(params), t(x), t(xk), t(xv), 3, pspec, p_common.UNSHARDED,
        rope_theta=None, cross_kv=(t(xk), t(xv)))
    close(ry, py)


# ------------------------------------------------------------ MoE

def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.5, 0.25], [0.1, 0.3, 0.3, 0.3]],
                     np.float32)
    rv, ri = jax.lax.top_k(probs, 3)
    pv, pi = p_moe.top_k(t(probs), 3)
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_array_equal(np.asarray(rv), pv.numpy())
    assert pi[0].tolist() == [2, 0, 1]


def test_one_hot_maps_outside_indices_to_zero_rows():
    idx = np.array([-1, 0, 3, 4, 7], np.int32)
    np.testing.assert_array_equal(np.asarray(jax.nn.one_hot(idx, 4)),
                                  p_moe.one_hot(t(idx), 4).numpy())


def _moe(n_experts=4, top_k=2, cf=1.25, d=16, ff=24, act="silu"):
    kw = dict(n_experts=n_experts, top_k=top_k, d_model=d, d_ff=ff,
              capacity_factor=cf, act=act)
    params = {"router": rnd(70, n_experts, d, scale=d ** -0.5),
              "w_gate": rnd(71, n_experts, ff, d, scale=d ** -0.5),
              "w_up": rnd(72, n_experts, ff, d, scale=d ** -0.5),
              "w_down": rnd(73, n_experts, d, ff, scale=ff ** -0.5)}
    return r_moe.MoESpec(**kw), p_moe.MoESpec(**kw), params


def test_route_with_ties():
    """Router rows equal for experts 0, 1 and 3: every token ties."""
    rspec, pspec, params = _moe(top_k=3)
    router = params["router"].copy()
    router[1] = router[0]
    router[3] = router[0]
    x = rnd(74, 10, 16)
    rg, ri, rp = r_moe._route(x, router, rspec)
    pg, pi, pp = p_moe._route(t(x), t(router), pspec)
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    close(rg, pg)
    close(rp, pp)


@pytest.mark.parametrize("T", [8, 40, 200])
def test_dispatch_drops_at_capacity(T):
    """capacity_factor 1.25 and the router's bias toward expert 0: tokens
    over capacity are dropped as the reference drops them."""
    rspec, pspec, params = _moe(cf=1.25)
    router = params["router"].copy()
    router[0] += 0.5
    x = rnd(75, T, 16) + 0.5
    rg, ri, _ = r_moe._route(x, router, rspec)
    pg, pi, _ = p_moe._route(t(x), t(router), pspec)
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    cap = r_moe._capacity(T, rspec)
    assert p_moe._capacity(T, pspec) == cap
    rd, rc = r_moe._dispatch_tensors(rg, ri, T, cap, rspec)
    pd, pc = p_moe._dispatch_tensors(pg, pi, T, cap, pspec)
    np.testing.assert_array_equal(np.asarray(rd), pd.numpy())
    close(rc, pc)
    if T == 200:
        assert float(np.asarray(rd).sum()) < T * rspec.top_k   # dropped


@pytest.mark.parametrize("cf,S", [(1.25, 64), (4.0, 8), (1.25, 1)])
def test_moe_forward(cf, S):
    rspec, pspec, params = _moe(cf=cf)
    params["router"][0] += 0.3
    x = rnd(76, 2, S, 16)
    ry, raux = jit(r_moe.moe_forward, 2, 3)(params, x, rspec,
                                            r_common.UNSHARDED)
    py, paux = p_moe.moe_forward(tree_t(params), t(x), pspec,
                                 p_common.UNSHARDED)
    close(ry, py)
    close(raux, paux)


# ------------------------------------------------------------ SSD

def _ssm(d=32, n=16, hd=16, chunk=128):
    kw = dict(d_model=d, d_state=n, head_dim=hd, chunk=chunk)
    rspec, pspec = r_ssm.SSMSpec(**kw), p_ssm.SSMSpec(**kw)
    params = jax.tree.map(np.asarray, r_ssm.init_ssm(jax.random.PRNGKey(3),
                                                     rspec))
    params["dt_bias"] = rnd(80, *params["dt_bias"].shape, scale=0.5)
    params["norm_g"] = rnd(81, *params["norm_g"].shape, scale=0.1)
    return rspec, pspec, params


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_several_chunks(with_state):
    """S = 256 in chunks of 128 (and of 64: four chunks)."""
    for chunk in (128, 64):
        rspec, pspec, _ = _ssm(chunk=chunk)
        B, S, H, P, N = 2, 256, 4, 16, 16
        xbar = rnd(82, B, S, H, P)
        Bm, Cm = rnd(83, B, S, N), rnd(84, B, S, N)
        al = -np.abs(rnd(85, B, S, H, scale=0.1))
        init = rnd(86, B, H, N, P) if with_state else None
        ry, rs = jit(r_ssm.ssd_chunked, 4)(xbar, Bm, Cm, al, rspec, init)
        py, ps = p_ssm.ssd_chunked(t(xbar), t(Bm), t(Cm), t(al), pspec,
                                   None if init is None else t(init))
        close(ry, py)
        close(rs, ps)


def test_causal_conv():
    x, w, b = rnd(87, 2, 20, 6), rnd(88, 6, 4), rnd(89, 6)
    close(r_ssm._causal_conv(x, w, b), p_ssm._causal_conv(t(x), t(w), t(b)))


def test_ssm_forward_and_decode_step():
    rspec, pspec, params = _ssm()
    pparams = tree_t(params)
    x = rnd(90, 2, 256, 32)
    ry, (rs, rt) = jit(r_ssm.ssm_forward, 2, 3, return_state=True)(
        params, x, rspec, r_common.UNSHARDED)
    py, (ps, pt) = p_ssm.ssm_forward(pparams, t(x), pspec,
                                     p_common.UNSHARDED, return_state=True)
    close(ry, py)
    close(rs, ps)
    close(rt, pt)
    cache, pcache = (rs, rt), (ps, pt)
    for i in range(3):
        xs = rnd(91 + i, 2, 32)
        ry, cache = r_ssm.ssm_decode_step(params, xs, cache, rspec,
                                          r_common.UNSHARDED)
        py, pcache = p_ssm.ssm_decode_step(pparams, t(xs), pcache, pspec,
                                           p_common.UNSHARDED)
        close(ry, py)
        close(cache[0], pcache[0])
        close(cache[1], pcache[1])


# ------------------------------------------------------------ RG-LRU

@pytest.mark.parametrize("S", [1, 7, 64, 200])
def test_rglru_scan(S):
    a = np.random.default_rng(S).uniform(0.5, 1.0, (2, S, 16)).astype(
        np.float32)
    b = jnp.asarray(rnd(92, 2, S, 16))
    h0 = rnd(93, 2, 16)
    scan = jit(r_rglru.rglru_scan)
    close(scan(a, b), p_rglru.rglru_scan(t(a), t(b)))
    close(scan(a, b, h0),
          p_rglru.rglru_scan(t(a), t(b), t(h0)))


def test_rglru_block_and_decode_step():
    kw = dict(d_model=32, width=48)
    rspec, pspec = r_rglru.RGLRUSpec(**kw), p_rglru.RGLRUSpec(**kw)
    params = jax.tree.map(np.asarray, r_rglru.init_rglru(
        jax.random.PRNGKey(4), rspec))
    params["b_a"] = rnd(94, 48, scale=0.5)
    pparams = tree_t(params)
    x = rnd(95, 2, 40, 32)
    ry, (rh, rt) = jit(r_rglru.rglru_block_forward, 2, 3,
                       return_state=True)(params, x, rspec,
                                          r_common.UNSHARDED)
    py, (ph, pt) = p_rglru.rglru_block_forward(
        pparams, t(x), pspec, p_common.UNSHARDED, return_state=True)
    close(ry, py)
    close(rh, ph)
    close(rt, pt)
    cache, pcache = (rh, rt), (ph, pt)
    for i in range(3):
        xs = rnd(96 + i, 2, 32)
        ry, cache = r_rglru.rglru_decode_step(params, xs, cache, rspec,
                                              r_common.UNSHARDED)
        py, pcache = p_rglru.rglru_decode_step(pparams, t(xs), pcache, pspec,
                                               p_common.UNSHARDED)
        close(ry, py)
        close(cache[0], pcache[0])
        close(cache[1], pcache[1])
