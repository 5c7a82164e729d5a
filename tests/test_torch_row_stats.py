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

The keep masks of Eq. 3 (``scores >= gamma * mean(scores)``) and the
``topk_rows`` indices are equal to the reference's on inputs built away
from ties: no row score lies within rtol 1e-6 of the threshold (counted,
and the count asserted 0), and no two scores within rtol 1e-6 of each
other.

The ``gpu`` tests hold the CUDA kernel to the plain version on the card at
rtol 1e-6; they skip where no CUDA device is visible.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as ref_sparsify
from repro.kernels import ops as ref_ops
from repro_torch.core import sparsify
from repro_torch.kernels import ops, ref
from repro_torch.kernels import row_stats as rs

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
