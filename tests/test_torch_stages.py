"""Port vs reference: quantization, sparsification and the upstream stage
chain (``comms/stages.py``), on random trees made from a numpy seed.

Levels are compared bitwise everywhere; so are reconstructions built from
levels by one float32 multiply.  The ternary magnitude and the Eq. 2
threshold are reductions and are held to rtol 1e-6 (summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import stages as ref_stages
from repro.core import quant as ref_quant
from repro.core import sparsify as ref_sparsify
from repro_torch.comms import stages
from repro_torch.core import quant, sparsify

SHAPES = {"conv0": {"w": (8, 3, 3, 3)}, "bn0": {"gamma": (8,), "beta": (8,)},
          "conv1": {"w": (16, 8, 3, 3)}, "fc0": {"w": (10, 16), "b": (10,)}}


def _tree(seed, scale=1e-3):
    rng = np.random.default_rng(seed)
    return {m: {k: (scale * rng.standard_normal(s)).astype(np.float32)
                for k, s in leaves.items()} for m, leaves in SHAPES.items()}


def _t(tree):
    return {m: {k: torch.tensor(np.asarray(v)) for k, v in d.items()}
            for m, d in tree.items()}


def _j(tree):
    return {m: {k: jnp.asarray(v) for k, v in d.items()}
            for m, d in tree.items()}


def _eq(a, b):
    for m in a:
        for k in a[m]:
            np.testing.assert_array_equal(np.asarray(a[m][k]),
                                          b[m][k].numpy(), err_msg=f"{m}/{k}")


CONFIGS = {
    "fixed_unstructured": dict(fixed_sparsity=0.9, structured=False),
    "fixed_structured": dict(fixed_sparsity=0.5, structured=True),
    "eq2_eq3": dict(fixed_sparsity=None, structured=True),
    "eq2_only": dict(fixed_sparsity=None, structured=False),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", ["none", "sparse", "ternary"])
@pytest.mark.parametrize("mode", sorted(CONFIGS))
def test_upstream_compress_levels_bitwise(seed, method, mode):
    kw = CONFIGS[mode]
    if method == "ternary" and kw["fixed_sparsity"] is None:
        kw = dict(kw, fixed_sparsity=0.96)
    carried = _tree(seed)
    ref = ref_stages.UpstreamStages(
        method=method, sparsify=ref_sparsify.SparsifyConfig(**kw),
        ternary_sparsity=kw["fixed_sparsity"] or 0.96)
    port = stages.UpstreamStages(
        method=method, sparsify=sparsify.SparsifyConfig(**kw),
        ternary_sparsity=kw["fixed_sparsity"] or 0.96)
    r_lv, r_rec, r_sp = ref.compress(_j(carried),
                                     ref_stages.path_fine_mask(_j(carried)))
    p_lv, p_rec, p_sp = port.compress(_t(carried),
                                      stages.path_fine_mask(_t(carried)))
    _eq(r_lv, p_lv)
    if method == "ternary":   # mu is a reduction
        for m in r_rec:
            for k in r_rec[m]:
                np.testing.assert_allclose(np.asarray(r_rec[m][k]),
                                           p_rec[m][k].numpy(), rtol=1e-6)
    else:
        _eq(r_rec, p_rec)
        _eq(r_sp, p_sp)


def test_fine_mask_matches_reference():
    t = _tree(0)
    assert stages.path_fine_mask(_t(t)) == {
        m: {k: bool(v) for k, v in d.items()}
        for m, d in ref_stages.path_fine_mask(_j(t)).items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_scales_delta_bitwise(seed):
    rng = np.random.default_rng(seed)
    s = {"conv0": {"w": (1e-4 * rng.standard_normal(8)).astype(np.float32)},
         "fc0": {"b": np.float32(3e-6) * np.ones((), np.float32)}}
    r_lv, r_rec = ref_stages.quantize_scales_delta(_j(s), 2.38e-6)
    p_lv, p_rec = stages.quantize_scales_delta(_t(s), 2.38e-6)
    _eq(r_lv, p_lv)
    _eq(r_rec, p_rec)


def test_quantize_rounds_half_to_even():
    step = 4.88e-4
    x = (np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.49, 1e9])
         * step).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(ref_quant.quantize(jnp.asarray(x), step)),
        quant.quantize(torch.from_numpy(x), step).numpy())


@pytest.mark.parametrize("n", [1, 7, 10, 25, 50, 128, 1000, 3456])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.75, 0.9, 0.96, 0.99])
def test_keep_count_matches(n, sparsity):
    assert sparsify.keep_count(n, sparsity) == ref_sparsify.keep_count(
        n, sparsity)


def test_topk_mask_with_ties():
    # many equal magnitudes straddling the k-th largest
    x = np.array([0.3, -0.3, 0.3, 0.1, -0.3, 0.2, 0.3, 0.05, -0.2, 0.3],
                 np.float32)
    for sp in (0.5, 0.7, 0.8, 0.9):
        np.testing.assert_array_equal(
            np.asarray(ref_sparsify.topk_mask_unstructured(jnp.asarray(x), sp)),
            sparsify.topk_mask_unstructured(torch.from_numpy(x), sp).numpy())


def test_topk_rows_breaks_ties_by_index():
    # rows 1, 3, 4 share the top score; k = 2 must take the lower indices
    w = np.zeros((6, 4), np.float32)
    w[[1, 3, 4]] = 1.0
    w[5] = 0.5
    r_vals, r_idx = ref_sparsify.topk_rows(jnp.asarray(w), 1 - 2 / 6)
    p_vals, p_idx = sparsify.topk_rows(torch.from_numpy(w), 1 - 2 / 6)
    np.testing.assert_array_equal(np.asarray(r_idx), p_idx.numpy())
    np.testing.assert_array_equal(np.asarray(r_vals), p_vals.numpy())
    assert p_idx.tolist() == [1, 3]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unstructured_threshold_is_population_std(seed):
    x = np.random.default_rng(seed).standard_normal(257).astype(np.float32)
    ref = float(ref_sparsify.unstructured_threshold(jnp.asarray(x), 1.0,
                                                    4.88e-4))
    port = float(sparsify.unstructured_threshold(torch.from_numpy(x), 1.0,
                                                 4.88e-4))
    np.testing.assert_allclose(port, ref, rtol=1e-6)
    ddof1 = max(abs(x.mean() - x.std(ddof=1)), abs(x.mean() + x.std(ddof=1)))
    assert abs(port - ddof1) > 1e-4 * abs(ddof1)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_error_feedback_bitwise(seed):
    from repro.core import residual as ref_residual
    from repro_torch.core import residual

    raw, res = _tree(seed), _tree(seed + 10, scale=3e-4)
    ref_up = ref_stages.UpstreamStages(
        sparsify=ref_sparsify.SparsifyConfig(fixed_sparsity=0.9,
                                             structured=False))
    port_up = stages.UpstreamStages(
        sparsify=sparsify.SparsifyConfig(fixed_sparsity=0.9,
                                         structured=False))
    r_c, r_res = ref_residual.apply_error_feedback(
        _j(raw), _j(res), lambda t: ref_up.compress(
            t, ref_stages.path_fine_mask(t))[1])
    p_c, p_res = residual.apply_error_feedback(
        _t(raw), _t(res), lambda t: port_up.compress(
            t, stages.path_fine_mask(t))[1])
    _eq(r_c, p_c)
    _eq(r_res, p_res)
