"""The port's VGG, optimizers and schedules against the reference.

Weights come from the reference's own init and cross through
``repro_torch.convert``; inputs are made from a numpy seed.  The forward
pass is held to rtol/atol 1e-5: the convolutions and BN reductions sum in
another order than XLA's.  Optimizer and schedule values are held to
rtol 1e-6 (float32 ``pow`` and ``cos`` may differ by an ulp between
libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as ref_cnn
from repro.optim import adam as ref_adam
from repro.optim import schedule as ref_schedule
from repro_torch import convert
from repro_torch.models import cnn
from repro_torch.optim import adam
from repro_torch.optim import schedule

TOL = dict(rtol=1e-5, atol=1e-5)

MODELS = {
    "tiny": (lambda m: m.make_vgg("t", [8, 16, 32], 10, 3, dense_width=16,
                                  pool_after=(0, 1, 2))),
    "vgg11_thinned": (lambda m: m.vgg11_thinned()),
}


def _allclose_tree(ref, port, **tol):
    for k, v in ref.items():
        if isinstance(v, dict):
            _allclose_tree(v, port[k], **tol)
        else:
            np.testing.assert_allclose(np.asarray(v), port[k].numpy(),
                                       err_msg=k, **tol)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_vgg_forward_matches(name, train):
    ref_model, port_model = MODELS[name](ref_cnn), MODELS[name](cnn)
    params, state = ref_model.init(jax.random.PRNGKey(3))
    x = np.random.default_rng(0).standard_normal((6, 32, 32, 3)).astype(
        np.float32)
    r_logits, r_state = ref_model.apply(params, state, jnp.asarray(x),
                                        train=train)
    p_logits, p_state = port_model.apply(
        convert.to_tensors(jax.device_get(params)),
        convert.to_tensors(jax.device_get(state)),
        torch.from_numpy(x), train=train)
    np.testing.assert_allclose(np.asarray(r_logits), p_logits.numpy(), **TOL)
    _allclose_tree(jax.device_get(r_state), p_state, **TOL)


def test_vgg11_counts_match_the_paper_model():
    params, _ = cnn.vgg11_thinned().init(torch.Generator().manual_seed(0))
    leaves = [v for d in params.values() for v in d.values()]
    assert len(leaves) == 28
    assert sum(v.numel() for v in leaves) == 849_834
    ref_params, _ = ref_cnn.vgg11_thinned().init(jax.random.PRNGKey(0))
    assert {k: {n: tuple(v.shape) for n, v in d.items()}
            for k, d in params.items()} == {
        k: {n: tuple(v.shape) for n, v in d.items()}
        for k, d in ref_params.items()}


@pytest.mark.parametrize("lr_kind", ["constant", "linear"])
def test_adam_steps_match(lr_kind):
    rng = np.random.default_rng(1)
    p = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
         "b": {"b": rng.standard_normal(5).astype(np.float32)}}
    grads = [{"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
              "b": {"b": rng.standard_normal(5).astype(np.float32)}}
             for _ in range(4)]
    lr_ref = (2e-3 if lr_kind == "constant"
              else ref_schedule.linear(2e-2, 6))
    lr_port = 2e-3 if lr_kind == "constant" else schedule.linear(2e-2, 6)
    r_opt, p_opt = ref_adam(lr_ref), adam(lr_port)
    r_state = r_opt.init(jax.tree.map(jnp.asarray, p))
    p_state = p_opt.init(convert.to_tensors(p))
    for g in grads:
        r_upd, r_state = r_opt.update(jax.tree.map(jnp.asarray, g), r_state)
        p_upd, p_state = p_opt.update(convert.to_tensors(g), p_state)
        _allclose_tree(jax.device_get(r_upd), p_upd, rtol=1e-6, atol=1e-9)
    assert int(p_state.step) == int(r_state.step) == len(grads)


@pytest.mark.parametrize("which", ["constant", "linear", "cawr"])
def test_schedules_match(which):
    make = {"constant": lambda m: m.constant(0.02),
            "linear": lambda m: m.linear(0.02, 37),
            "cawr": lambda m: m.cawr(0.02, 9)}[which]
    r_fn, p_fn = make(ref_schedule), make(schedule)
    for step in [0, 1, 4, 8, 9, 17, 36, 37, 50]:
        np.testing.assert_allclose(
            float(p_fn(torch.tensor(step, dtype=torch.int32))),
            float(r_fn(jnp.asarray(step, jnp.int32))), rtol=1e-6)


def test_convert_carries_reference_state_in_and_out():
    from repro.core import protocol as ref_protocol

    model = MODELS["tiny"](ref_cnn)
    cfg = ref_protocol.baseline_configs(fixed_sparsity=0.9)["fsfl"]
    init, _, _ = ref_protocol.make_protocol(model, cfg, 2)
    server, pers = jax.device_get(init(jax.random.PRNGKey(1)))
    p_server, p_pers = convert.initial_state(server, pers)
    assert isinstance(p_pers.opt_state, type(p_pers.scale_opt_state))
    for ref, port in ((server, p_server), (pers, p_pers)):
        ref_leaves = jax.tree.leaves(ref)
        back = jax.tree.leaves(convert.to_numpy(port))
        assert len(back) == len(ref_leaves)
        for a, b in zip(ref_leaves, back):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)
