"""The port's ``scaled_matmul`` (Eq. 4 at matmul time, ``x @ (s * W)^T``)
and its backward against the reference.

On the CPU the wrapper takes its plain PyTorch versions.  The forward is
held to the reference's oracle ``repro.kernels.ref.scaled_matmul`` and to
the Pallas kernel in interpret mode (``repro.kernels.ops.scaled_matmul``)
at the main path's shapes (M = 32, 120, 960 rows against the (128, 128)
and (10, 128) dense weights of ``vgg11_thinned``) and at ragged ones.
Tolerance: the float32 error bound of a sum of K products taken in any
order, ``2 (K + 2) u sum_k |x w s|`` per element with ``u = 2^-24`` (the
packages, and the kernel, sum in different orders and scale before or
after the sum).

The backward (``dx``, ``dW``, ``ds``) is held to ``torch.autograd``
through ``apply_scale`` (the port's route before Eq. 4 moved into the
product), with only the gradients asked for computed: the weight steps
ask for ``dx`` and ``dW``, the scale sub-epochs for ``dx`` and ``ds``; on
the card one launch computes them all, and every subset of the three is
held to its plain versions.
``ds`` sums over M products of ``dy`` and a sum over K, so its bound is
``2 (M + K + 2) u sum_m |dy| sum_k |x w|``: a ``ds`` set to zero fails it
at every main-path shape, and one taken in bfloat16 at M = 32 and 120.
A whole client round on the CPU, through the dense layers' new route, is
held to the reference's ``client_round`` within the slice bounds of
tests/test_torch_protocol.py, and its calls per direction are counted.

The ``gpu`` tests hold each CUDA kernel to its plain version on the card
within the same bound, the fused backward for every subset of the
gradients at the main path's shapes and ragged ones, and check that a
second run gives the same bits; they skip where no CUDA device is
visible.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as ref_protocol
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.models import cnn as ref_cnn
from repro_torch import convert
from repro_torch.core import protocol, scaling
from repro_torch.fl import scenarios
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scaled_matmul as sm
from repro_torch.models import cnn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


U = 2.0 ** -24
MAIN = [(m, n, 128) for m in (32, 120, 960) for n in (128, 10)]
RAGGED = [(1, 1, 1), (5, 3, 7), (33, 129, 130), (17, 16, 32), (2, 10, 16)]
STEP = 4.88e-4
FINE = 2.38e-6


def _inputs(m, n, k, seed=0):
    rng = np.random.default_rng(seed + 7 * m + 3 * n + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    s = rng.uniform(0.8, 1.2, n).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, s, dy


def _bound(a, b, r):
    """2 (r + 2) u (|a| @ |b|): the float32 error bound of two sums of r
    products, each also rounded by one scale multiply."""
    return 2 * (r + 2) * U * (np.abs(a.astype(np.float64))
                              @ np.abs(b.astype(np.float64)))


def _bounds(x, w, s, dy):
    """The bound of each direction, in numpy, from its operands."""
    (m, k), n = x.shape, w.shape[0]
    return {"forward": _bound(x, (w * s[:, None]).T, k),
            "dx": _bound(dy * s, w, n), "dw": _bound((dy * s).T, x, m),
            "ds": 2 * (m + k + 2) * U * np.sum(
                np.abs(dy) * (np.abs(x) @ np.abs(w).T), axis=0)}


def _within(got, want, bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= bound), float(np.max(err / np.maximum(bound, 1e-45)))


@pytest.mark.parametrize("shape", MAIN + RAGGED, ids=str)
def test_plain_forward_vs_reference_oracle_and_pallas_interpret(shape):
    x, w, s, _ = _inputs(*shape)
    got = ops.scaled_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(s)).numpy()
    bound = _bound(x, (w * s[:, None]).T, shape[2])
    exact = x.astype(np.float64) @ (w.astype(np.float64) * s[:, None]).T
    _within(got, exact, bound / 2)
    _within(got, ref_kernels.scaled_matmul(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(s)), bound)
    _within(got, ref_ops.scaled_matmul(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(s)), bound)
    assert torch.equal(ref.scaled_matmul(*map(torch.from_numpy, (x, w, s))),
                       torch.from_numpy(got))


# which of (x, W, s) require grad: the weight steps, the scale sub-epochs,
# all three, and s alone (the first dense layer's input frozen)
NEEDS = {"weight_step": (True, True, False), "scale_step": (True, False, True),
         "all": (True, True, True), "scale_only": (False, False, True)}


@pytest.mark.parametrize("need", list(NEEDS), ids=str)
@pytest.mark.parametrize("shape", [(32, 128, 128), (120, 10, 128),
                                   (17, 16, 32), (5, 3, 7)], ids=str)
def test_backward_vs_autograd_through_apply_scale(shape, need):
    x, w, s, dy = _inputs(*shape, seed=1)
    flags = NEEDS[need]

    def leaves():
        return [torch.from_numpy(v.copy()).requires_grad_(f)
                for v, f in zip((x, w, s), flags)]

    want_in = leaves()
    want_y = want_in[0] @ scaling.apply_scale(want_in[1], want_in[2]).T
    want = torch.autograd.grad(want_y, [t for t in want_in if t.requires_grad],
                               torch.from_numpy(dy))
    sm.reset_counters()
    got_in = leaves()
    got_y = sm.scaled_matmul(*got_in)
    got = torch.autograd.grad(got_y, [t for t in got_in if t.requires_grad],
                              torch.from_numpy(dy))
    assert sm.CALLS == {"forward": 1, "dx": int(flags[0]),
                        "dw": int(flags[1]), "ds": int(flags[2])}
    assert sm.LAUNCHES == dict.fromkeys(sm.KERNELS, 0)
    bounds = _bounds(x, w, s, dy)
    asked = [d for d, f in zip(("dx", "dw", "ds"), flags) if f]
    for d, g, t in zip(asked, got, want):
        _within(g.numpy(), t.numpy(), bounds[d])
    _within(got_y.detach().numpy(), want_y.detach().numpy(),
            bounds["forward"])


# every subset of (dx, dW, ds), the empty one only by a direct call
SUBSETS = list(itertools.product((False, True), repeat=3))


def _subset_id(flags):
    return "+".join(d for d, f in zip(("dx", "dw", "ds"), flags) if f) or (
        "none")


@pytest.mark.parametrize("flags", SUBSETS, ids=_subset_id)
def test_backward_computes_exactly_the_gradients_asked_for(flags):
    x, w, s, dy = (torch.from_numpy(v) for v in _inputs(17, 16, 32, seed=5))
    sm.reset_counters()
    got = sm.backward(dy, x, w, s, *flags)
    assert sm.CALLS == {"forward": 0, **{d: int(f) for d, f in zip(
        ("dx", "dw", "ds"), flags)}}
    assert sm.LAUNCHES == dict.fromkeys(sm.KERNELS, 0)
    want = (sm.dx_plain(dy, w, s), sm.dw_plain(dy, x, s),
            sm.ds_plain(dy, x, w))
    for f, g, t in zip(flags, got, want):
        assert (g is None) == (not f)
        if f:
            assert torch.equal(g, t)
    if any(flags):        # the same through autograd
        ins = [t.clone().requires_grad_(f) for t, f in zip((x, w, s), flags)]
        sm.reset_counters()
        grads = torch.autograd.grad(sm.scaled_matmul(*ins),
                                    [t for t in ins if t.requires_grad], dy)
        assert sm.CALLS == {"forward": 1, **{d: int(f) for d, f in zip(
            ("dx", "dw", "ds"), flags)}}
        for g, t in zip(grads, [t for f, t in zip(flags, want) if f]):
            assert torch.equal(g, t)


def _ds_exact_and_bound(shape):
    x, w, s, dy = _inputs(*shape, seed=4)
    exact = np.sum(dy.astype(np.float64) * (x.astype(np.float64)
                                            @ w.astype(np.float64).T), axis=0)
    return (dy, x, w), exact, _bounds(x, w, s, dy)["ds"]


@pytest.mark.parametrize("shape", MAIN, ids=str)
def test_ds_bound_holds_float32_and_rejects_zero(shape):
    args, exact, bound = _ds_exact_and_bound(shape)
    _within(sm.ds_plain(*map(torch.from_numpy, args)).numpy(), exact,
            bound / 2)
    assert np.any(np.abs(exact) > bound)


@pytest.mark.parametrize("shape", [(32, 128, 128), (32, 10, 128),
                                   (120, 128, 128), (120, 10, 128)], ids=str)
def test_ds_bound_rejects_bfloat16(shape):
    """At M = 960 the worst-case bound, linear in M, passes bfloat16."""
    args, exact, bound = _ds_exact_and_bound(shape)
    low = sm.ds_plain(*(torch.from_numpy(v).bfloat16() for v in args))
    assert np.any(np.abs(low.float().numpy() - exact) > bound)


def test_plain_directions_are_the_autograd_formulas():
    x, w, s, dy = (torch.from_numpy(v) for v in _inputs(24, 16, 32, seed=2))
    torch.testing.assert_close(sm.dx_plain(dy, w, s), (dy * s) @ w)
    torch.testing.assert_close(sm.dw_plain(dy, x, s), (dy * s).T @ x)
    torch.testing.assert_close(sm.ds_plain(dy, x, w),
                               torch.sum(dy * (x @ w.T), dim=0))


def test_dense_apply_routes_scaled_leaves_through_the_product():
    gen = torch.Generator().manual_seed(0)
    p = cnn.dense_init(gen, 10, 16, "cpu")
    x = torch.randn((4, 16), generator=gen)
    s = torch.rand(10, generator=gen) + 0.5
    sm.reset_counters()
    got = cnn.dense_apply(p, x, s)
    assert sm.CALLS["forward"] == 1
    assert torch.equal(got, x @ scaling.apply_scale(p["w"], s).T + p["b"])
    assert torch.equal(cnn.dense_apply(p, x), x @ p["w"].T + p["b"])
    assert torch.equal(cnn.dense_apply(p, x, torch.tensor(1.0)),
                       x @ p["w"].T + p["b"])
    assert sm.CALLS["forward"] == 1
    conv = torch.randn((10, 3, 3, 3), generator=gen)
    scaled = scaling.apply_scales_tree(
        {"fc": p, "conv": {"w": conv}},
        {"fc": {"w": s, "b": torch.tensor(1.0)}, "conv": {"w": s}})
    assert scaled["fc"]["w"] is p["w"]
    assert torch.equal(scaled["fc"]["b"], p["b"])
    assert torch.equal(scaled["conv"]["w"], scaling.apply_scale(conv, s))


def test_wrapper_rejects_bad_inputs():
    x, w, s = torch.zeros((2, 3)), torch.zeros((4, 3)), torch.zeros(4)
    with pytest.raises(ValueError):
        sm.scaled_matmul(x, w, torch.zeros(3))
    with pytest.raises(ValueError):
        sm.scaled_matmul(torch.zeros((2, 5)), w, s)
    with pytest.raises(TypeError):
        sm.scaled_matmul(x.double(), w, s)
    with pytest.raises(ValueError):
        sm.scaled_matmul(x.to("meta"), w.to("meta"), s.to("meta"))
    assert sm.scaled_matmul(torch.zeros((0, 3)), w, s).shape == (0, 4)


# ------------------------------------------------------------ client round

def _cfg(m):
    return m.baseline_configs(
        fixed_sparsity=0.9, batch_size=16, local_lr=2e-3, scale_lr=2e-2,
        scale_subepochs=2, scale_schedule="linear", total_rounds=2)["fsfl"]


def _flat(tree, to_np=np.asarray):
    return {f"{m}/{n}": to_np(v) for m, d in tree.items() for n, v in d.items()}


def test_client_round_with_dense_scales_at_matmul_vs_reference():
    """One client round (3 weight steps, 2 scale sub-epochs of 3 steps, 3
    validation passes) of the fsfl protocol on the tiny VGG, from the
    reference's state, data and batch order: every dense product goes
    through ``scaled_matmul``, and the round stays within the bounds of
    tests/test_torch_protocol.py."""
    seed = 0
    model = ref_cnn.make_vgg("t", [8, 16, 32], 10, 3, dense_width=16,
                             pool_after=(0, 1, 2))
    init, ref_round, _ = ref_protocol.make_protocol(
        model, _cfg(ref_protocol), 3)
    server, pers = init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)
    vx = rng.standard_normal((24, 32, 32, 3)).astype(np.float32)
    vy = rng.integers(0, 10, 24).astype(np.int32)
    bidx = rng.permutation(64)[:48].reshape(3, 16)
    ref_out = jax.device_get(jax.jit(ref_round)(
        server, pers, *map(jnp.asarray, (x, y, vx, vy, bidx))))

    _, port_round, _ = protocol.make_protocol(
        cnn.make_vgg("t", [8, 16, 32], 10, 3, dense_width=16,
                     pool_after=(0, 1, 2)), _cfg(protocol), 3)
    sm.reset_counters()
    with torch.no_grad():
        out = port_round(
            convert.server_state(jax.device_get(server)),
            convert.client_persistent(jax.device_get(pers)),
            torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
            torch.from_numpy(vx), torch.from_numpy(vy.astype(np.int64)),
            torch.from_numpy(bidx))
    # 2 dense layers: 3 weight steps, 6 scale steps, 3 validation passes
    assert sm.CALLS == {"forward": 2 * (3 + 6 + 3), "dx": 2 * (3 + 6),
                        "dw": 2 * 3, "ds": 2 * 6}
    assert sm.LAUNCHES == dict.fromkeys(sm.KERNELS, 0)
    assert float(out.metrics["scale_epoch"]) in (0.0, 1.0, 2.0)
    for m in ("val_acc_unscaled", "val_acc"):
        assert float(out.metrics[m]) == float(ref_out.metrics[m]), m
    ref_lv, port_lv = _flat(ref_out.levels_params), _flat(
        out.levels_params, lambda v: v.numpy())
    ref_rec, port_rec = _flat(ref_out.recon_delta_params), _flat(
        out.recon_delta_params, lambda v: v.numpy())
    moved = total = 0
    for k in ref_lv:
        np.testing.assert_allclose(port_rec[k], ref_rec[k], rtol=0,
                                   atol=STEP * 1.01, err_msg=k)
        moved += int(np.sum(port_lv[k] != ref_lv[k]))
        total += ref_lv[k].size
    assert moved <= 0.01 * total, (moved, total)
    ref_srec, port_srec = _flat(ref_out.recon_delta_scales), _flat(
        out.recon_delta_scales, lambda v: v.numpy())
    assert any(np.any(v) for v in ref_srec.values())
    for k, v in ref_srec.items():
        np.testing.assert_allclose(port_srec[k], v, rtol=0, atol=FINE * 1.01,
                                   err_msg=k)


def test_bidirectional_round_counts_every_dense_product():
    """``bidi_sync_full``, one round over 8 clients on the CPU: per client
    2 dense layers x (3 weight steps + 6 scale steps + 3 validation
    passes), plus the server's evaluation; no kernel launch on the CPU."""
    model, splits = scenarios.default_setting(8, n_samples=1280)
    sm.reset_counters()
    scenarios.run_scenario("bidi_sync_full", rounds=1, model=model,
                           splits=splits, device="cpu")
    assert sm.CALLS == {"forward": 8 * 2 * 12 + 2, "dx": 8 * 2 * 9,
                        "dw": 8 * 2 * 3, "ds": 8 * 2 * 6}
    assert sm.LAUNCHES == dict.fromkeys(sm.KERNELS, 0)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MAIN + RAGGED, ids=str)
def test_cuda_kernels_vs_plain(cuda, shape):
    x, w, s, dy = (torch.from_numpy(v).to(cuda) for v in _inputs(*shape))
    sm.reset_counters()
    got = {"forward": sm.forward(x, w, s), "dx": sm.dx(dy, w, s),
           "dw": sm.dw(dy, x, s), "ds": sm.ds(dy, x, w)}
    assert sm.LAUNCHES == {"forward": 1, "backward": 3}
    want = {"forward": sm.scaled_matmul_plain(x, w, s),
            "dx": sm.dx_plain(dy, w, s), "dw": sm.dw_plain(dy, x, s),
            "ds": sm.ds_plain(dy, x, w)}
    torch.cuda.synchronize()
    bounds = _bounds(*(v.cpu().numpy() for v in (x, w, s, dy)))
    for d in sm.DIRECTIONS:
        _within(got[d].cpu().numpy(), want[d].cpu().numpy(), bounds[d])


@pytest.mark.gpu
@pytest.mark.parametrize("need", list(NEEDS), ids=str)
def test_cuda_autograd_vs_cpu(cuda, need):
    x, w, s, dy = _inputs(32, 128, 128, seed=3)
    flags = NEEDS[need]
    grads = {}
    for dev in ("cpu", cuda):
        ins = [torch.from_numpy(v.copy()).to(dev).requires_grad_(f)
               for v, f in zip((x, w, s), flags)]
        y = sm.scaled_matmul(*ins)
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(
            y, [t for t in ins if t.requires_grad],
            torch.from_numpy(dy).to(dev))]
    bounds = _bounds(x, w, s, dy)
    asked = [d for d, f in zip(("dx", "dw", "ds"), flags) if f]
    for d, a, b in zip(asked, grads["cpu"], grads["cuda"]):
        _within(b.numpy(), a.numpy(), bounds[d])


FUSED_SHAPES = [(32, 128, 128), (32, 10, 128), (120, 128, 128),
                (960, 128, 128)] + RAGGED


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [f for f in SUBSETS if any(f)],
                         ids=_subset_id)
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=str)
def test_cuda_fused_backward_every_subset_and_deterministic(cuda, shape,
                                                            flags):
    x, w, s, dy = (torch.from_numpy(v).to(cuda) for v in _inputs(*shape))
    sm.reset_counters()
    first = sm.backward(dy, x, w, s, *flags)
    again = sm.backward(dy, x, w, s, *flags)
    y, y2 = sm.forward(x, w, s), sm.forward(x, w, s)
    assert sm.LAUNCHES == {"forward": 2, "backward": 2}
    want = (sm.dx_plain(dy, w, s), sm.dw_plain(dy, x, s),
            sm.ds_plain(dy, x, w))
    torch.cuda.synchronize()
    bounds = _bounds(*(v.cpu().numpy() for v in (x, w, s, dy)))
    for d, f, g, g2, t in zip(("dx", "dw", "ds"), flags, first, again, want):
        assert (g is None) == (not f)
        if f:
            _within(g.cpu().numpy(), t.cpu().numpy(), bounds[d])
            assert torch.equal(g.view(torch.int32), g2.view(torch.int32))
    _within(y.cpu().numpy(), sm.scaled_matmul_plain(x, w, s).cpu().numpy(),
            bounds["forward"])
    assert torch.equal(y.view(torch.int32), y2.view(torch.int32))
