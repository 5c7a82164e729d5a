"""The port's ``level_assign`` kernel and the fused client stage chain
against the reference.

On the CPU the wrapper takes its plain PyTorch version, which must be
BITWISE equal (levels and the float32 carry, compared as bit patterns) to
the reference's eager-jnp oracle ``repro.kernels.ref.level_assign``.
Against the Pallas kernel in interpret mode the levels are bitwise and the
carry is held to one ulp of ``max |carried|``: interpret mode may contract
``carried - lv * step`` into an FMA (kernels/README.md).

Inputs cover values on exact half-steps (a power-of-two step makes
``(m + 0.5) * step`` exact), values equal to theta (theta taken from the
data), theta = 0, levels clipped at ``max_level``, and K > 1 rows of
ragged n.

``UpstreamStages.compress_carry`` (one launch per leaf) is held bitwise to
the reference's ``carry_residual -> compress -> new_residual`` on random
trees with fine and coarse leaves: levels, reconstruction, new residual
and ``update_sparsity``.

The ``gpu`` tests hold the CUDA kernel bitwise to the plain version on the
card; they skip where no CUDA device is visible.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import stages as ref_stages
from repro.core import sparsify as ref_sparsify
from repro.kernels import ref as ref_oracle
from repro.kernels.level_assign import level_assign as ref_pallas
from repro_torch.comms import stages
from repro_torch.core import sparsify
from repro_torch.kernels import level_assign as la
from repro_torch.kernels import ops, ref

STEP_POW2 = 2.0 ** -11          # 4.8828125e-4: half-steps are exact
STEP_UNI = 4.88e-4
NS = [1, 5, 127, 1000, 1031]
KS = [1, 3, 8]


def _inputs(k, n, seed=0, step=STEP_POW2):
    """(d, r, theta) float32: random values plus exact half-steps and
    theta ties; theta is one of the |d + r| values."""
    rng = np.random.default_rng(seed + 13 * n + k)
    d = (1e-2 * rng.standard_normal((k, n))).astype(np.float32)
    r = (1e-3 * rng.standard_normal((k, n))).astype(np.float32)
    m = rng.integers(-40, 40, (k, n))
    half = rng.random((k, n)) < 0.3          # exact half-steps, r = 0
    d = np.where(half, ((m + 0.5) * step).astype(np.float32), d)
    r = np.where(half, np.float32(0.0), r)
    carried = d + r
    theta = np.float32(np.abs(carried).reshape(-1)[(7 * n) % (k * n)])
    ties = rng.random((k, n)) < 0.05         # values equal to +-theta
    d = np.where(ties, np.sign(rng.standard_normal((k, n))) * theta,
                 d).astype(np.float32)
    r = np.where(ties, np.float32(0.0), r).astype(np.float32)
    return d, r, theta


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("step", [STEP_POW2, STEP_UNI])
@pytest.mark.parametrize("theta_mode", ["data", "zero"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_plain_bitwise_vs_reference_oracle(n, k, theta_mode, step):
    d, r, theta = _inputs(k, n, step=step)
    theta = theta if theta_mode == "data" else np.float32(0.0)
    rl, rc = ref_oracle.level_assign(jnp.asarray(d), jnp.asarray(r),
                                     theta, step)
    la.reset_counters()
    pl, pc = ops.level_assign(torch.from_numpy(d), torch.from_numpy(r),
                              torch.tensor(theta), torch.tensor(step,
                                                                dtype=torch.float32))
    assert la.CALLS["level_assign"] == 1 and la.LAUNCHES["level_assign"] == 0
    assert pl.dtype == torch.int32 and pc.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(rl), pl.numpy())
    np.testing.assert_array_equal(_bits(rc), _bits(pc.numpy()))
    kept = np.abs(d + r) >= theta
    if theta_mode == "data":      # the tied values are kept
        assert kept[np.abs(d + r) == theta].all()


def test_inputs_hold_half_steps_and_ties():
    d, r, theta = _inputs(3, 1000)
    x = (d + r) / np.float32(STEP_POW2)
    assert int(np.sum(x - np.floor(x) == 0.5)) > 500
    assert int(np.sum(np.abs(d + r) == theta)) > 50


@pytest.mark.parametrize("max_level", [7, 2**23])
def test_plain_clips_at_max_level(max_level):
    d = np.array([[1e6, -1e6, 0.0, 2e3, -2e3, 3e-4]], np.float32)
    r = np.zeros_like(d)
    rl, rc = ref_oracle.level_assign(jnp.asarray(d), jnp.asarray(r), 0.0,
                                     1e-4, max_level)
    pl, pc = la.level_assign(torch.from_numpy(d), torch.from_numpy(r), 0.0,
                             1e-4, max_level=max_level)
    np.testing.assert_array_equal(np.asarray(rl), pl.numpy())
    np.testing.assert_array_equal(_bits(rc), _bits(pc.numpy()))
    assert pl[0, 0] == max_level and pl[0, 1] == -max_level


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("n", [5, 257, 1000])
def test_plain_vs_pallas_interpret(n, k):
    d, r, theta = _inputs(k, n, seed=3, step=STEP_UNI)
    rl, rc = ref_pallas(jnp.asarray(d), jnp.asarray(r), theta, STEP_UNI,
                        interpret=True)
    pl, pc = la.level_assign(torch.from_numpy(d), torch.from_numpy(r),
                             float(theta), STEP_UNI)
    np.testing.assert_array_equal(np.asarray(rl), pl.numpy())
    ulp = np.spacing(np.max(np.abs(d + r)))
    np.testing.assert_allclose(np.asarray(rc), pc.numpy(), rtol=0, atol=ulp)


def test_empty_shapes_return_without_a_launch():
    for shape in [(0, 5), (3, 0)]:
        lv, c = la.level_assign(torch.zeros(shape), torch.zeros(shape), 0.0,
                                1.0)
        assert lv.shape == c.shape == shape and lv.dtype == torch.int32


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((2, 3))
    with pytest.raises(TypeError):
        la.level_assign(x.double(), x.double(), 0.0, 1.0)
    with pytest.raises(ValueError):
        la.level_assign(x, torch.zeros((2, 4)), 0.0, 1.0)
    with pytest.raises(ValueError):
        la.level_assign(x, x, torch.zeros(2), 1.0)
    with pytest.raises(ValueError):
        la.level_assign(x.to("meta"), x.to("meta"), 0.0, 1.0)


def test_ref_module_is_the_plain_version():
    d, r, theta = _inputs(2, 300)
    a = ref.level_assign(torch.from_numpy(d), torch.from_numpy(r), theta,
                         STEP_UNI)
    b = la.level_assign_plain(torch.from_numpy(d), torch.from_numpy(r),
                              theta, STEP_UNI)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- stages

SHAPES = {"conv0": {"w": (8, 3, 3, 3), "b": (8,)},
          "bn0": {"gamma": (8,), "beta": (8,)},
          "conv1": {"w": (16, 8, 3, 3)}, "fc0": {"w": (10, 16), "b": (10,)}}
N_LEAVES = 7

FUSED = {
    "fixed_0.9": dict(fixed_sparsity=0.9, structured=False),
    "fixed_0.96": dict(fixed_sparsity=0.96, structured=False),
    "eq2_only": dict(fixed_sparsity=None, structured=False),
}


def _tree(seed, scale):
    rng = np.random.default_rng(seed)
    return {m: {k: (scale * rng.standard_normal(s)).astype(np.float32)
                for k, s in leaves.items()} for m, leaves in SHAPES.items()}


def _t(tree):
    return {m: {k: torch.tensor(v) for k, v in d.items()}
            for m, d in tree.items()}


def _j(tree):
    return {m: {k: jnp.asarray(v) for k, v in d.items()}
            for m, d in tree.items()}


def _eq_bits(a, b):
    for m in a:
        for k in a[m]:
            ra, pb = np.asarray(a[m][k]), b[m][k].numpy()
            assert ra.dtype == pb.dtype, (m, k)
            np.testing.assert_array_equal(ra.view(np.int32),
                                          pb.view(np.int32),
                                          err_msg=f"{m}/{k}")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", sorted(FUSED))
def test_fused_stages_bitwise_vs_reference_chain(mode, seed):
    kw = FUSED[mode]
    raw, res = _tree(seed, 1e-3), _tree(seed + 10, 3e-4)
    ref_up = ref_stages.UpstreamStages(
        sparsify=ref_sparsify.SparsifyConfig(**kw))
    port_up = stages.UpstreamStages(sparsify=sparsify.SparsifyConfig(**kw))
    assert port_up.fused
    fine = ref_stages.path_fine_mask(_j(raw))
    carried = ref_stages.carry_residual(_j(raw), _j(res), True)
    r_lv, r_rec, r_sp = ref_up.compress(carried, fine)
    r_res = ref_stages.new_residual(carried, r_rec, True, _j(res))
    r_sparsity = ref_sparsify.tree_sparsity(r_sp)

    la.reset_counters()
    p_lv, p_rec, p_res, p_sparsity = port_up.compress_carry(
        _t(raw), _t(res), stages.path_fine_mask(_t(raw)))
    assert la.CALLS["level_assign"] == N_LEAVES
    _eq_bits(r_lv, p_lv)
    _eq_bits(r_rec, p_rec)
    _eq_bits(r_res, p_res)
    assert np.float32(r_sparsity) == p_sparsity.numpy()
    # the unfused port chain agrees as well
    p_carried = stages.carry_residual(_t(raw), _t(res), True)
    u_lv, u_rec, u_sp = port_up.compress(p_carried,
                                         stages.path_fine_mask(_t(raw)))
    _eq_bits(_numpy(u_lv), p_lv)
    _eq_bits(_numpy(stages.new_residual(p_carried, u_rec, True, _t(res))),
             p_res)
    assert sparsify.tree_sparsity(u_sp) == p_sparsity


def _numpy(tree):
    return {m: {k: v.numpy() for k, v in d.items()} for m, d in tree.items()}


def test_kept_elements_that_round_to_zero_count_as_kept():
    """update_sparsity is the zero share of the sparsified tensor: with a
    coarse step every kept element rounds to level 0, yet the sparsity
    stays that of the top-k."""
    raw = _tree(4, 1e-6)
    res = {m: {k: np.zeros_like(v) for k, v in d.items()}
           for m, d in raw.items()}
    up = stages.UpstreamStages(sparsify=sparsify.SparsifyConfig(
        fixed_sparsity=0.9, structured=False))
    lv, _, _, sp = up.compress_carry(_t(raw), _t(res), {
        m: {k: False for k in d} for m, d in raw.items()})
    assert all(int(torch.count_nonzero(v)) == 0 for d in lv.values()
               for v in d.values())
    assert float(sp) < 0.95


@pytest.mark.parametrize("kw", [
    dict(method="sparse", sparsify=sparsify.SparsifyConfig(
        fixed_sparsity=0.9, structured=True)),
    dict(method="sparse", sparsify=sparsify.SparsifyConfig(structured=True)),
    dict(method="sparse", quantize=False, sparsify=sparsify.SparsifyConfig(
        fixed_sparsity=0.9, structured=False)),
    dict(method="ternary"), dict(method="none")])
def test_other_stage_chains_stay_unfused(kw):
    up = stages.UpstreamStages(**kw)
    assert not up.fused
    with pytest.raises(ValueError):
        up.compress_carry(_t(_tree(0, 1e-3)), _t(_tree(1, 1e-3)),
                          stages.path_fine_mask(_t(_tree(0, 1e-3))))


def test_leaf_threshold_matches_reference():
    x = torch.from_numpy(_tree(5, 1e-3)["conv1"]["w"])
    np.testing.assert_array_equal(
        float(sparsify.leaf_threshold(x, sparsify.SparsifyConfig(
            fixed_sparsity=0.9, structured=False))),
        float(np.sort(np.abs(x.numpy()).ravel())[::-1][
            ref_sparsify.keep_count(x.numel(), 0.9) - 1]))
    np.testing.assert_allclose(
        float(sparsify.leaf_threshold(x, sparsify.SparsifyConfig(
            structured=False))),
        float(ref_sparsify.unstructured_threshold(jnp.asarray(x.numpy()),
                                                  1.0, 4.88e-4)), rtol=1e-6)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("theta_mode", ["data", "zero"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_cuda_kernel_bitwise_vs_plain(cuda, n, k, theta_mode):
    d, r, theta = _inputs(k, n)
    theta = theta if theta_mode == "data" else np.float32(0.0)
    d, r = torch.from_numpy(d).to(cuda), torch.from_numpy(r).to(cuda)
    th = torch.tensor(theta, device=cuda)
    la.reset_counters()
    lv, c = la.level_assign(d, r, th, STEP_POW2)
    assert la.LAUNCHES["level_assign"] == 1
    pl, pc = la.level_assign_plain(d, r, th, STEP_POW2)
    torch.cuda.synchronize()
    assert torch.equal(lv, pl)
    assert torch.equal(c.view(torch.int32), pc.view(torch.int32))


@pytest.mark.gpu
def test_cuda_kernel_cohort_shape_and_unaligned_rows(cuda):
    d, r, theta = _inputs(8, 849_834)
    d, r = torch.from_numpy(d).to(cuda), torch.from_numpy(r).to(cuda)
    for dd, rr in ((d, r), (d[:, 1:], r[:, 1:]), (d[3, 5:][None],
                                                   r[3, 5:][None])):
        lv, c = la.level_assign(dd, rr, float(theta), STEP_UNI)
        pl, pc = la.level_assign_plain(dd, rr, float(theta), STEP_UNI)
        torch.cuda.synchronize()
        assert torch.equal(lv, pl)
        assert torch.equal(c.view(torch.int32), pc.view(torch.int32))
