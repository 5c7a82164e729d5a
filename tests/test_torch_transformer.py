"""Whole models of the transformer family against the reference: for each
of the ten reduced architectures, the reference's ``init_params`` tree goes
through ``convert.transformer_params``, and ``forward_full``'s output, its
MoE auxiliary loss and ``loss_fn`` are held to the reference's on the same
batch (``make_inputs`` of the reference, seq 64).  Two variants run too:
recurrentgemma reduced with ``n_layers=5`` (one superblock of (R, R, A)
and a tail of two layers) and gemma2 reduced with ``parallel_block=True``.

Tolerance: within ``TOL`` = 2e-5 of the reference tensor's largest
magnitude.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_configs, make_inputs
from repro.models import transformer as rt
from repro.models.common import UNSHARDED as R_CTX
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch.launch.arch_check import rel_gap
from repro_torch.models import transformer as pt
from repro_torch.models.common import UNSHARDED as P_CTX

# CPU parity: within 2e-5 of the reference tensor's largest magnitude,
# tightened from the 1e-4 bar (``arch_check.TOL``, the card's) to about
# three times the largest gap measured (6.85e-6, the SSD block on a
# 256-token sequence; 2.1e-6 at most on the whole models)
TOL = 2e-5

VARIANTS = {"recurrentgemma-9b+tail": ("recurrentgemma-9b", {"n_layers": 5}),
            "gemma2-2b+parallel": ("gemma2-2b", {"parallel_block": True})}
CASES = sorted(all_configs()) + sorted(VARIANTS)
EXTRA_KEYS = ("enc_embeds", "patch_embeds", "patch_positions",
              "mrope_positions")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(case):
    """(reference config, port config) of one case, reduced."""
    arch, over = VARIANTS.get(case, (case, {}))
    return (dataclasses.replace(all_configs()[arch].reduced(), **over),
            dataclasses.replace(pconfigs.get(arch).reduced(), **over))


@pytest.fixture(scope="module")
def reference():
    """case -> (numpy params, numpy batch, x, aux, loss), once a module."""
    memo = {}

    def run(case):
        if case not in memo:
            cfg, _ = configs(case)
            params = rt.init_params(jax.random.PRNGKey(0), cfg, rt.SINGLE)
            batch = make_inputs(jax.random.PRNGKey(1), cfg, 2, 64)

            @jax.jit
            def both(p, b):
                x, aux, _ = rt.forward_full(
                    p, b["tokens"], cfg, rt.SINGLE, R_CTX,
                    **{k: b.get(k) for k in EXTRA_KEYS})
                return x, aux, rt.loss_fn(p, b, cfg, rt.SINGLE, R_CTX)

            x, aux, loss = both(params, batch)
            memo[case] = (jax.tree.map(np.asarray, params),
                          {k: np.asarray(v) for k, v in batch.items()},
                          np.asarray(x), np.asarray(aux), np.asarray(loss))
        return memo[case]
    return run


@pytest.mark.parametrize("case", CASES)
def test_forward_full_and_loss(case, reference):
    params, batch, x, aux, loss = reference(case)
    _, cfg = configs(case)
    pp = convert.transformer_params(params, cfg)
    pb = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
    with torch.inference_mode():
        px, paux, cache = pt.forward_full(pp, pb["tokens"], cfg, pt.SINGLE,
                                          P_CTX, **{k: pb.get(k)
                                                    for k in EXTRA_KEYS})
        ploss = pt.loss_fn(pp, pb, cfg, pt.SINGLE, P_CTX)
    assert cache is None
    assert rel_gap(x, px) <= TOL
    assert rel_gap(aux, torch.as_tensor(float(paux))) <= TOL
    assert rel_gap(loss, ploss) <= TOL
    assert np.isfinite(float(ploss)) and float(ploss) < 3 * np.log(cfg.vocab)


def test_variants_reach_their_branches():
    ref, cfg = configs("recurrentgemma-9b+tail")
    shapes = pt.param_shapes(cfg)
    assert shapes["tail"]["rec"]["w_a"][0] == 2        # R, R of the tail
    assert shapes["superblocks"]["sub2"]["attn"]["wq"][0] == 1
    assert configs("gemma2-2b+parallel")[1].parallel_block


def test_transformer_params_checks_keys_and_shapes(reference):
    params, *_ = reference("gemma2-2b")
    _, cfg = configs("gemma2-2b")
    bad = jax.tree.map(lambda a: a, params)
    del bad["final_ln"]
    with pytest.raises(ValueError, match="keys"):
        convert.transformer_params(bad, cfg)
    bad = jax.tree.map(lambda a: a, params)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="layers/attn/wq: shape"):
        convert.transformer_params(bad, cfg)


def test_param_shapes_match_the_reference_init(reference):
    for case in ("mamba2-370m", "whisper-small", "qwen2-vl-72b"):
        params, *_ = reference(case)
        _, cfg = configs(case)
        assert pt.param_shapes(cfg) == jax.tree.map(lambda a: a.shape,
                                                    params)


def test_init_params_draws_from_the_generator():
    _, cfg = configs("mixtral-8x22b")
    a = pt.init_params(torch.Generator().manual_seed(0), cfg)
    b = pt.init_params(torch.Generator().manual_seed(0), cfg)
    c = pt.init_params(torch.Generator().manual_seed(1), cfg)
    wa, wb, wc = (p["layers"]["moe"]["w_up"] for p in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.dtype == torch.float32 and a["lm_head"].shape == (512, 256)
    ref_std = float(np.std(np.asarray(rt.init_params(
        jax.random.PRNGKey(0), configs("mixtral-8x22b")[0],
        rt.SINGLE)["layers"]["moe"]["w_up"])))
    assert abs(float(wa.std()) - ref_std) < 0.05 * ref_std
