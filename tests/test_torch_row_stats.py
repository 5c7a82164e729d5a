"""The port's ``row_stats`` kernel (the Eq. 3 filter scores) against the
reference.

On the CPU the wrapper takes its plain PyTorch version.  It is held at
rtol 1e-6 to the reference's ``repro.core.sparsify.row_scores`` (what the
main path must equal) and to the Pallas kernel ``repro.kernels.ops.
row_stats`` in interpret mode, at the ten ``vgg11_thinned`` weight leaves
(six distinct ``(M, N)`` views) and at ragged shapes.  Not bitwise: a
mean is a reduction, and the packages sum in different orders.

``row_scores`` sends a leaf of two or more dimensions through the wrapper
once, on its ``(M, -1)`` view; 0-d and 1-d leaves keep their own code.

The grouped entry ``row_stats_leaves`` scores a list of views (a client's
ten weight views, or ragged ones) in one call, which is ``row_stats`` per
view; the structured ``sparsify_tree`` takes every leaf's scores from one
such call and is bitwise equal to the per-leaf route and to the
reference's ``sparsify_tree`` on inputs away from ties, as is the
``fsfl_dyn`` downlink built on it.

The keep masks of Eq. 3 (``scores >= gamma * mean(scores)``) and the
``topk_rows`` indices are equal to the reference's on inputs built away
from ties: no row score lies within rtol 1e-6 of the threshold (counted,
and the count asserted 0), and no two scores within rtol 1e-6 of each
other.

The ``gpu`` tests hold the CUDA kernel to the plain version on the card at
rtol 1e-6 and bitwise to a numpy copy of its float order (lane ``l`` sums
elements ``l + 32 k`` in ``k`` order, then a butterfly); one launch scores
all the views of a call; they skip where no CUDA device is visible.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as ref_sparsify
from repro.kernels import ops as ref_ops
from repro_torch import comms
from repro_torch.core import quant, sparsify
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.fl import rounds
from repro_torch.kernels import ops, ref
from repro_torch.kernels import row_stats as rs
from repro_torch.tree import tree_map

RTOL = 1e-6
# the ten weight leaves of vgg11_thinned (OIHW convs, (out, in) dense)
VGG_LEAVES = [(32, 3, 3, 3), (64, 32, 3, 3), (128, 64, 3, 3)] + [
    (128, 128, 3, 3)] * 5 + [(128, 128), (10, 128)]
VGG_VIEWS = sorted({(s[0], int(np.prod(s[1:]))) for s in VGG_LEAVES})
RAGGED = [(1, 1), (3, 5), (7, 1000), (130, 513), (5, 1025)]


def _w(shape, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    rows = rng.uniform(0.2, 2.0, (shape[0],) + (1,) * (len(shape) - 1))
    return (1e-3 * rows * rng.standard_normal(shape)).astype(np.float32)


def test_vgg_views_are_the_six_main_path_shapes():
    assert VGG_VIEWS == [(10, 128), (32, 27), (64, 288), (128, 128),
                         (128, 576), (128, 1152)]


@pytest.mark.parametrize("shape", VGG_LEAVES[:3] + VGG_LEAVES[-3:],
                         ids=str)
def test_row_scores_vs_reference(shape):
    w = _w(shape)
    rs.reset_counters()
    got = sparsify.row_scores(torch.from_numpy(w))
    assert rs.CALLS["row_stats"] == 1 and rs.LAUNCHES["row_stats"] == 0
    want = np.asarray(ref_sparsify.row_scores(jnp.asarray(w)))
    assert got.shape == want.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("shape", VGG_VIEWS + RAGGED, ids=str)
def test_plain_vs_reference_oracle_and_pallas_interpret(shape):
    w = _w(shape, seed=1)
    got = ops.row_stats(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.mean(np.abs(w), axis=1,
                                            dtype=np.float64),
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, np.asarray(ref_ops.row_stats(
        jnp.asarray(w))), rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, np.asarray(ref_sparsify.row_scores(
        jnp.asarray(w))), rtol=RTOL, atol=0)


@pytest.mark.parametrize("shape", [(), (7,)])
def test_low_rank_leaves_keep_their_code(shape):
    w = torch.from_numpy(_w(shape if shape else (1,))).reshape(shape)
    rs.reset_counters()
    got = sparsify.row_scores(w)
    assert rs.CALLS["row_stats"] == 0
    want = np.asarray(ref_sparsify.row_scores(jnp.asarray(w.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)


def _away_from_ties(shape, gamma, seed):
    """A weight whose row scores sit at least 1e-4 (relative) from
    ``gamma * mean(scores)`` and from each other: rows too near are
    scaled up by 0.3% until none is."""
    w = _w(shape, seed)
    for _ in range(100):
        s = np.mean(np.abs(w.reshape(shape[0], -1)), axis=1,
                    dtype=np.float64)
        theta = gamma * s.mean()
        order = np.argsort(s)
        bump = np.abs(s - theta) < 1e-4 * theta
        bump[order[1:][np.diff(s[order]) < 1e-4 * s[order][1:]]] = True
        if not bump.any():
            return w
        w = w * np.where(bump, 1.003, 1.0).reshape(
            (-1,) + (1,) * (len(shape) - 1)).astype(np.float32)
    raise AssertionError("could not build an input away from ties")


def _near_ties(scores, theta):
    return int(np.sum(np.abs(scores - theta) <= RTOL * abs(theta)))


@pytest.mark.parametrize("gamma", [1.0, 0.5])
@pytest.mark.parametrize("shape", VGG_LEAVES[:3] + VGG_LEAVES[-2:], ids=str)
def test_keep_masks_equal_reference(shape, gamma):
    w = _away_from_ties(shape, gamma, seed=2)
    ref_scores = np.asarray(ref_sparsify.row_scores(jnp.asarray(w)))
    assert _near_ties(ref_scores, gamma * ref_scores.mean()) == 0
    got = sparsify.structured_keep_mask(torch.from_numpy(w), gamma).numpy()
    want = np.asarray(ref_sparsify.structured_keep_mask(jnp.asarray(w),
                                                        gamma))
    assert 0 < got.sum() < shape[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sparsify.sparsify_structured(torch.from_numpy(w), gamma).numpy(),
        np.asarray(ref_sparsify.sparsify_structured(jnp.asarray(w), gamma)))


@pytest.mark.parametrize("sparsity", [0.5, 0.9])
@pytest.mark.parametrize("shape", VGG_LEAVES[:3] + VGG_LEAVES[-2:], ids=str)
def test_topk_rows_equal_reference(shape, sparsity):
    w = _away_from_ties(shape, 1.0, seed=3)
    vals, idx = sparsify.topk_rows(torch.from_numpy(w), sparsity)
    rvals, ridx = ref_sparsify.topk_rows(jnp.asarray(w), sparsity)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


def test_empty_shapes_and_ref_module():
    assert rs.row_stats(torch.zeros((0, 4))).shape == (0,)
    w = torch.from_numpy(_w((9, 40)))
    assert torch.equal(ref.row_stats(w), rs.row_stats_plain(w))


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        rs.row_stats(torch.zeros(5))
    with pytest.raises(TypeError):
        rs.row_stats(torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        rs.row_stats(torch.zeros((2, 3), device="meta"))



# ---------------------------------------------------------------- grouped

VIEW_SETS = {"vgg11_thinned": [(s[0], int(np.prod(s[1:]))) for s in
                               VGG_LEAVES],
             "ragged": RAGGED + [(2, 0), (0, 3), (4, 1281)]}


def _views(name, seed):
    return [_w(shape, seed + i) for i, shape in enumerate(VIEW_SETS[name])]


@pytest.mark.parametrize("name", VIEW_SETS)
def test_leaves_plain_vs_reference_oracle_and_pallas_interpret(name):
    ws = _views(name, seed=6)
    rs.reset_counters()
    got = rs.row_stats_leaves([torch.from_numpy(w) for w in ws])
    assert rs.CALLS["row_stats"] == len(ws) and rs.LAUNCHES["row_stats"] == 0
    assert len(got) == len(ws)
    for w, g in zip(ws, got):
        assert g.shape == (w.shape[0],) and g.dtype == torch.float32
        torch.testing.assert_close(g, rs.row_stats_plain(
            torch.from_numpy(w)), rtol=0, atol=0, equal_nan=True)
        if w.size == 0:
            continue
        np.testing.assert_allclose(g.numpy(), np.mean(
            np.abs(w), axis=1, dtype=np.float64), rtol=RTOL, atol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_ops.row_stats(
            jnp.asarray(w))), rtol=RTOL, atol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(
            ref_sparsify.row_scores(jnp.asarray(w))), rtol=RTOL, atol=0)


def test_leaves_of_no_views_and_views_without_columns():
    assert rs.row_stats_leaves([]) == []
    empty, nocols = rs.row_stats_leaves([torch.zeros((0, 4)),
                                         torch.zeros((3, 0))])
    assert empty.shape == (0,) and torch.isnan(nocols).all()


def test_leaves_wrapper_rejects_bad_inputs():
    w = torch.from_numpy(_w((4, 9)))
    with pytest.raises(ValueError, match="one device"):
        rs.row_stats_leaves([w, w.to("meta")])
    with pytest.raises(TypeError):
        rs.row_stats_leaves([w, w.double()])
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        rs.row_stats_leaves([w, w.reshape(-1)])
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        rs.row_stats_leaves([w[None]])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rs.row_stats_leaves([w.to("meta")])


def _vgg_tree(seed, gamma=1.0, shapes=VGG_LEAVES):
    """Weight leaves (away from ties at ``gamma``) and a bias."""
    tree = {f"l{i}": {"w": torch.from_numpy(
        _away_from_ties(shape, gamma, seed + i))}
        for i, shape in enumerate(shapes)}
    tree[f"l{len(shapes) - 1}"]["b"] = torch.from_numpy(_w((10,), seed))
    return tree


def _eq2_near_ties(tree, cfg) -> int:
    """Elements of the reference's Eq. 3 output within rtol 1e-6 of its
    Eq. 2 threshold (0 where the config has no Eq. 2 stage)."""
    if not cfg.unstructured or cfg.fixed_sparsity is not None:
        return 0
    n = 0
    for d in tree.values():
        for x in d.values():
            x = jnp.asarray(x.numpy())
            if x.ndim >= 2:
                x = ref_sparsify.sparsify_structured(x, cfg.gamma)
            th = float(ref_sparsify.unstructured_threshold(
                x, cfg.delta, cfg.step_size))
            n += int(np.sum(np.abs(np.abs(np.asarray(x)) - th)
                            <= RTOL * th))
    return n


STRUCTURED = {"eqs23": sparsify.SparsifyConfig(),
              "eq3": sparsify.SparsifyConfig(unstructured=False, gamma=0.5),
              "topk_rows": sparsify.SparsifyConfig(fixed_sparsity=0.5)}


@pytest.mark.parametrize("name", STRUCTURED)
def test_structured_sparsify_tree_is_one_call_and_the_per_leaf_route(
        name, monkeypatch):
    cfg = STRUCTURED[name]
    tree = _vgg_tree(7, cfg.gamma)
    assert _eq2_near_ties(tree, cfg) == 0
    calls = []
    grouped = sparsify.row_stats_leaves
    monkeypatch.setattr(sparsify, "row_stats_leaves",
                        lambda views: calls.append(len(views))
                        or grouped(views))
    rs.reset_counters()
    got = sparsify.sparsify_tree(tree, cfg)
    assert calls == [len(VGG_LEAVES)]
    assert rs.CALLS["row_stats"] == len(VGG_LEAVES)
    per_leaf = tree_map(lambda x: sparsify.sparsify(x, cfg), tree)
    ref_cfg = ref_sparsify.SparsifyConfig(**dataclasses.asdict(cfg))
    want = ref_sparsify.sparsify_tree(tree_map(
        lambda x: jnp.asarray(x.numpy()), tree), ref_cfg)
    for m, d in tree.items():
        for k in d:
            g = got[m][k].numpy().view(np.int32)
            np.testing.assert_array_equal(
                g, per_leaf[m][k].numpy().view(np.int32))
            np.testing.assert_array_equal(
                g, np.asarray(want[m][k]).view(np.int32))


def test_unstructured_sparsify_tree_scores_nothing():
    rs.reset_counters()
    sparsify.sparsify_tree(_vgg_tree(8), sparsify.SparsifyConfig(
        structured=False))
    assert rs.CALLS["row_stats"] == 0


DYN = dict(name="fsfl_dyn", method="sparse", delta=1.0, gamma=1.0,
           error_feedback=True, scaling=True, batch_size=32,
           local_lr=2e-3, scale_lr=2e-2, scale_subepochs=2)


SMALL = VGG_LEAVES[:3] + VGG_LEAVES[-2:]


def _per_leaf_sparsify_tree(tree, cfg):
    return tree_map(lambda x: sparsify.sparsify(x, cfg), tree)


@pytest.mark.parametrize("codec", ["nnc-cabac", "int8-blockscale"])
def test_fsfl_dyn_downlink_grouped_equals_per_leaf_route(codec,
                                                         monkeypatch):
    """The ``fsfl_dyn`` downlink (Eqs. 2+3 at ``STEP_SIZE_BI``) over three
    broadcasts: one grouped ``row_stats`` call per broadcast, and the
    recon, residual and payload of the per-leaf route, bit for bit."""
    cfg = ProtocolConfig(**DYN)
    params0 = _vgg_tree(9, shapes=SMALL)
    runs = {}
    for route in ("grouped", "per_leaf"):
        if route == "per_leaf":
            monkeypatch.setattr(sparsify, "sparsify_tree",
                                _per_leaf_sparsify_tree)
        dl = rounds.Downlink(cfg, quant.STEP_SIZE_BI, params0,
                             comms.get_codec(codec), True)
        assert dl.active and not dl.stages.fused
        out = []
        for trip in range(3):
            rs.reset_counters()
            bc, down = dl.compress(_vgg_tree(20 + trip, shapes=SMALL), 2,
                                   True)
            assert rs.CALLS["row_stats"] == len(SMALL)
            recon = (bc.recon if bc.int8 is None else
                     bc.apply(tree_map(torch.zeros_like, params0)))
            out.append((down, dl.last_payload_bytes, recon, dl.residual))
        runs[route] = out
    for a, b in zip(runs["grouped"], runs["per_leaf"]):
        assert a[:2] == b[:2]
        for ta, tb in zip(a[2:], b[2:]):
            for m, d in ta.items():
                for k, v in d.items():
                    np.testing.assert_array_equal(
                        v.numpy().view(np.int32),
                        tb[m][k].numpy().view(np.int32))


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", VGG_VIEWS + RAGGED, ids=str)
def test_cuda_kernel_vs_plain(cuda, shape):
    w = torch.from_numpy(_w(shape, seed=4)).to(cuda)
    rs.reset_counters()
    got = rs.row_stats(w)
    assert rs.LAUNCHES["row_stats"] == 1
    want = rs.row_stats_plain(w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", VGG_LEAVES[:3] + VGG_LEAVES[-2:], ids=str)
def test_cuda_row_scores_and_keep_masks(cuda, shape):
    w = _away_from_ties(shape, 1.0, seed=5)
    wc = torch.from_numpy(w).to(cuda)
    rs.reset_counters()
    mask = sparsify.structured_keep_mask(wc, 1.0)
    assert rs.LAUNCHES["row_stats"] == 1
    want = sparsify.structured_keep_mask(torch.from_numpy(w), 1.0)
    assert torch.equal(mask.cpu(), want)


def _warp_order_mean(w: np.ndarray) -> np.ndarray:
    """The kernel's float order in numpy float32: lane ``l`` sums
    ``|w[:, l + 32 k]|`` in ``k`` order, a butterfly adds the 32 partial
    sums (xor 16, 8, 4, 2, 1), lane 0's sum is divided by ``N``."""
    m, n = w.shape
    a = np.abs(w.astype(np.float32))
    part = np.zeros((m, 32), np.float32)
    for k in range(0, n, 32):
        chunk = np.zeros((m, 32), np.float32)
        chunk[:, :min(32, n - k)] = a[:, k:k + 32]
        part = part + chunk      # a lane past the row's end adds 0
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, np.arange(32) ^ o]
    return part[:, 0] / np.float32(n)


def test_warp_order_copy_is_a_mean():
    for shape in VGG_VIEWS + RAGGED:
        w = _w(shape, seed=10)
        np.testing.assert_allclose(_warp_order_mean(w), np.mean(
            np.abs(w), axis=1, dtype=np.float64), rtol=RTOL, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", VIEW_SETS)
def test_cuda_leaves_one_launch_bitwise_to_its_float_order(cuda, name):
    ws = [w for w in _views(name, seed=11) if w.shape[1] > 0]
    wc = [torch.from_numpy(w).to(cuda) for w in ws]
    rs.reset_counters()
    got = rs.row_stats_leaves(wc)
    assert rs.LAUNCHES["row_stats"] == 1
    singles = [rs.row_stats(w) for w in wc]
    torch.cuda.synchronize()
    for w, g, one, want in zip(ws, got, singles, rs.row_stats_leaves_plain(
            wc)):
        torch.testing.assert_close(g, want, rtol=RTOL, atol=0)
        assert torch.equal(g.view(torch.int32), one.view(torch.int32))
        np.testing.assert_array_equal(
            g.cpu().numpy().view(np.int32),
            _warp_order_mean(w).view(np.int32))


@pytest.mark.gpu
def test_cuda_leaves_unaligned_rows_and_above_the_cap(cuda):
    """Views that start anywhere in one flat buffer (the 4-byte head and
    tail copies), and more views than one launch's table holds."""
    shapes = [(3, 27), (5, 1152), (2, 1281), (7, 5), (1, 4000)] * 14
    flat = torch.from_numpy(_w((1, sum(m * n + 1 for m, n in shapes)),
                               seed=12).reshape(-1)).to(cuda)
    views, o = [], 1
    for m, n in shapes:
        views.append(flat[o:o + m * n].view(m, n))
        o += m * n + 1
    rs.reset_counters()
    got = rs.row_stats_leaves(views)
    assert rs.LAUNCHES["row_stats"] == -(-len(shapes) // 64) == 2
    for v, g in zip(views, got):
        np.testing.assert_array_equal(
            g.cpu().numpy().view(np.int32),
            _warp_order_mean(v.cpu().numpy()).view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", STRUCTURED)
def test_cuda_structured_stage_is_one_launch(cuda, name):
    cfg = STRUCTURED[name]
    tree = _vgg_tree(13, cfg.gamma)
    rs.reset_counters()
    got = sparsify.sparsify_tree(tree_map(lambda x: x.to(cuda), tree), cfg)
    assert rs.LAUNCHES["row_stats"] == 1
    want = sparsify.sparsify_tree(tree, cfg)
    for m, d in want.items():
        for k, v in d.items():
            assert torch.equal(got[m][k].cpu(), v), (m, k)
