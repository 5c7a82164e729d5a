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

The grouped entry ``level_assign_leaves`` (a list of leaves, each with
its own theta and step, one launch per 64 leaves on the card) is held
bitwise to ``level_assign_plain`` per leaf and to the reference oracle at
every ``vgg11_thinned`` leaf shape and at ragged sizes, with the same
half-steps and ties; its chunk-offset table is checked above the
per-launch cap.

``UpstreamStages.compress_carry`` (one grouped call) is held bitwise to
the reference's ``carry_residual -> compress -> new_residual`` on random
trees with fine and coarse leaves: levels, reconstruction, new residual
and ``update_sparsity``.

The ``gpu`` tests hold the CUDA kernels bitwise to the plain versions on
the card; they skip where no CUDA device is visible.
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
from repro_torch.models import vgg11_thinned

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
    """Bad shapes, devices and types raise; on the CPU the plain version
    takes tensors of one floating type (float64 where the port is held
    against the reference under x64), mixed or integer types raise."""
    x = torch.zeros((2, 3))
    with pytest.raises(TypeError):
        la.level_assign(x, x.double(), 0.0, 1.0)
    with pytest.raises(TypeError):
        la.level_assign(x.int(), x.int(), 0.0, 1.0)
    assert la.level_assign(x.double(), x.double(), 0.0, 1.0)[1].dtype == (
        torch.float64)
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


# ---------------------------------------------------------------- grouped

def _vgg_shapes():
    params, _ = vgg11_thinned().init(torch.Generator().manual_seed(0))
    return [tuple(v.shape) for d in params.values() for v in d.values()]


def _leaves(shapes, seed=0):
    """(deltas, residuals, thetas, steps) in numpy: each leaf from
    ``_inputs`` (half-steps and theta ties) with its own theta, steps
    alternating between a power of two and the uniform step."""
    ds, rs, ths, steps = [], [], [], []
    for i, sh in enumerate(shapes):
        step = (STEP_POW2, STEP_UNI)[i % 2]
        n = int(np.prod(sh))
        if n == 0:
            d = r = np.zeros(0, np.float32)
            theta = np.float32(0.0)
        else:
            d, r, theta = _inputs(1, n, seed=seed + i, step=step)
        ds.append(d.reshape(sh))
        rs.append(r.reshape(sh))
        ths.append(theta if i % 5 else np.float32(0.0))
        steps.append(step)
    return ds, rs, np.array(ths, np.float32), steps


def _grouped_vs_references(shapes, seed=0):
    ds, rs, ths, steps = _leaves(shapes, seed)
    la.reset_counters()
    lvs, cs = la.level_assign_leaves([torch.from_numpy(d) for d in ds],
                                     [torch.from_numpy(r) for r in rs],
                                     torch.from_numpy(ths), steps)
    assert la.CALLS["level_assign"] == len(shapes)
    assert la.LAUNCHES["level_assign"] == 0
    for d, r, th, step, lv, c in zip(ds, rs, ths, steps, lvs, cs):
        assert lv.shape == c.shape == d.shape
        pl, pc = la.level_assign_plain(torch.from_numpy(d.reshape(1, -1)),
                                       torch.from_numpy(r.reshape(1, -1)),
                                       th, step)
        assert torch.equal(lv.reshape(1, -1), pl)
        assert torch.equal(c.reshape(1, -1).view(torch.int32),
                           pc.view(torch.int32))
        rl, rc = ref_oracle.level_assign(jnp.asarray(d.reshape(1, -1)),
                                         jnp.asarray(r.reshape(1, -1)), th,
                                         step)
        np.testing.assert_array_equal(np.asarray(rl), pl.numpy())
        np.testing.assert_array_equal(_bits(rc), _bits(pc.numpy()))
    return ds, rs


def test_grouped_plain_bitwise_at_every_vgg11_thinned_leaf():
    shapes = _vgg_shapes()
    assert len(shapes) == 28
    ds, rs = _grouped_vs_references(shapes)
    carried = np.concatenate([(d + r).ravel() for d, r in zip(ds, rs)])
    steps = np.concatenate([np.full(d.size, (STEP_POW2, STEP_UNI)[i % 2],
                                    np.float32) for i, d in enumerate(ds)])
    x = carried / steps
    assert int(np.sum(x - np.floor(x) == 0.5)) > 1000   # half-steps kept


@pytest.mark.parametrize("shapes", [[(1,), (5,), (1027,)],
                                    [(1027,), (1,), (3, 5), (0,), (5,)],
                                    [(2, 2, 2)] * 3], ids=str)
def test_grouped_plain_bitwise_at_ragged_sizes(shapes):
    _grouped_vs_references(shapes, seed=7)


def test_grouped_wrapper_rejects_bad_inputs():
    x, th = torch.zeros((2, 3)), torch.zeros(2)
    call = la.level_assign_leaves
    with pytest.raises(ValueError):          # lists of other lengths
        call([x, x], [x], th, [1.0, 1.0])
    with pytest.raises(ValueError):
        call([x, x], [x, x], th, [1.0])
    with pytest.raises(ValueError):          # one theta too few
        call([x, x], [x, x], torch.zeros(1), [1.0, 1.0])
    with pytest.raises(ValueError):          # a residual of another shape
        call([x, x], [x, torch.zeros(6)], th, [1.0, 1.0])
    with pytest.raises(TypeError):
        call([x, x.double()], [x, x.double()], th, [1.0, 1.0])
    with pytest.raises(TypeError):
        call([x, x], [x, x], th.double(), [1.0, 1.0])
    with pytest.raises(ValueError):          # leaves on two devices
        call([x, x.to("meta")], [x, x.to("meta")], th, [1.0, 1.0])
    with pytest.raises(ValueError):          # no kernel for this device
        call([x.to("meta")], [x.to("meta")], th[:1].to("meta"), [1.0])
    with pytest.raises(ValueError):
        call([x], [x], th[:1], [1.0], max_level=0)
    assert call([], [], torch.zeros(0), []) == ([], [])


@pytest.mark.parametrize("sizes", [
    [1000] * 28, [1] * 64, [5] * 65, [1024, 1025, 0, 3] * 40,
    list(range(0, 3000, 17))], ids=lambda s: f"{len(s)}_leaves")
def test_chunk_table_and_offsets(sizes):
    table = la.chunk_table(sizes)
    assert [lo for lo, _, _ in table] == list(range(0, len(sizes),
                                                    la.MAX_LEAVES))
    assert table[-1][1] == len(sizes)
    for lo, hi, starts in table:
        assert 0 < hi - lo <= la.MAX_LEAVES and len(starts) == hi - lo + 1
        assert starts[0] == 0
        for i, n in enumerate(sizes[lo:hi]):
            assert starts[i + 1] - starts[i] == -(-n // la.CHUNK)
    # every element of every leaf falls in exactly one chunk of its launch
    for lo, hi, starts in table:
        seen = []
        for b in range(starts[-1]):
            leaf = max(i for i in range(hi - lo) if starts[i] <= b)
            base = (b - starts[leaf]) * la.CHUNK
            assert base < sizes[lo + leaf]
            seen.append((leaf, base))
        assert len(set(seen)) == len(seen)
    offsets, total = la.leaf_offsets(sizes)
    assert all(o % 4 == 0 for o in offsets)
    ends = [o + n for o, n in zip(offsets, sizes)]
    assert all(e <= o2 for e, o2 in zip(ends, offsets[1:] + [total]))
    assert total - ends[-1] < 4


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


def _grouped_on_card(cuda, shapes, seed=0):
    ds, rs, ths, steps = _leaves(shapes, seed)
    d = [torch.from_numpy(v).to(cuda) for v in ds]
    r = [torch.from_numpy(v).to(cuda) for v in rs]
    th = torch.from_numpy(ths).to(cuda)
    return d, r, th, steps


def _grouped_bitwise(d, r, th, steps, launches):
    la.reset_counters()
    lvs, cs = la.level_assign_leaves(d, r, th, steps)
    assert la.LAUNCHES["level_assign"] == launches
    assert la.CALLS["level_assign"] == len(d)
    pls, pcs = la.level_assign_leaves_plain(d, r, th, steps)
    torch.cuda.synchronize()
    for lv, c, pl, pc in zip(lvs, cs, pls, pcs):
        assert torch.equal(lv, pl)
        assert torch.equal(c.view(torch.int32), pc.view(torch.int32))


@pytest.mark.gpu
def test_cuda_grouped_kernel_bitwise_at_28_leaves(cuda):
    _grouped_bitwise(*_grouped_on_card(cuda, _vgg_shapes()), launches=1)


@pytest.mark.gpu
def test_cuda_grouped_kernel_unaligned_leaves(cuda):
    d, r, th, steps = _grouped_on_card(cuda, [(1,), (5,), (1027,), (3, 7),
                                              (0,), (4097,)], seed=3)
    # views that start 4, 8 and 12 bytes past an alignment boundary
    d = [v.reshape(-1)[1:] if v.numel() > 1 else v for v in d]
    r = [v.reshape(-1)[1:] if v.numel() > 1 else v for v in r]
    _grouped_bitwise(d, r, th, steps, launches=1)


@pytest.mark.gpu
def test_cuda_grouped_kernel_above_the_cap(cuda):
    shapes = [(n,) for n in range(1, 3000, 19)]      # 158 leaves
    assert len(shapes) > 2 * la.MAX_LEAVES
    _grouped_bitwise(*_grouped_on_card(cuda, shapes, seed=5),
                     launches=-(-len(shapes) // la.MAX_LEAVES))
