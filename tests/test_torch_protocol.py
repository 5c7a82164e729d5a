"""``client_round`` of the port against the reference's.

Teacher-forced: the reference's own model and Adam produce the
post-training params, and those, with a random Eq. 5 residual, go through
both stage chains (delta -> error feedback -> top-k -> quantize); levels,
reconstructions and the new residual must be bitwise equal.  Scale deltas
from the reference go through both scale quantizers, also bitwise.

A whole client round, from the same state, data and batch order, agrees
within a stated tolerance: training sums in another order than XLA
(float32, ~1e-6 relative), which may move an element across a rounding
boundary, so reconstructions and residuals are held to one quantization
step per element and at most 1% of the levels may differ; loss and BN
statistics to rtol 1e-4.  (An element that crosses the top-k threshold
instead moves by its whole value; these inputs have none, and
tests/test_torch_slice.py bounds that case.)  The Eq. 4 sub-epochs are
held too: the validation accuracies that the accept rule compares must be
equal, the scale levels at most one fine step apart at no more than 3% of
the scale elements, and the scale optimizer's Adam moments within 1e-4 of
each leaf's largest (the sums differ at ~1e-6 of it).  The seeds cover
the accept rule's three outcomes: a sub-epoch that improves, one that ties
``perf >= best_perf``, and none accepted (a zero scale delta).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import stages as ref_stages
from repro.core import protocol as ref_protocol
from repro.core import scaling as ref_scaling
from repro.models import cnn as ref_cnn
from repro.optim import adam as ref_adam
from repro.optim import apply_updates as ref_apply
from repro_torch import convert
from repro_torch.comms import stages
from repro_torch.core import protocol
from repro_torch.core import sparsify
from repro_torch.models import cnn

STEP = 4.88e-4
FINE = 2.38e-6


def _model(m):
    return m.make_vgg("t", [8, 16, 32], 10, 3, dense_width=16,
                      pool_after=(0, 1, 2))


def _cfg(m, **kw):
    base = dict(fixed_sparsity=0.9, batch_size=16, local_lr=2e-3,
                scale_lr=2e-2, scale_subepochs=2, scale_schedule="linear",
                total_rounds=2)
    return m.baseline_configs(**dict(base, **kw))["fsfl"]


def _data(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)
    vx = rng.standard_normal((24, 32, 32, 3)).astype(np.float32)
    vy = rng.integers(0, 10, 24).astype(np.int32)
    bidx = rng.permutation(64)[:48].reshape(3, 16)
    return x, y, vx, vy, bidx


def _ref_setup(seed, **kw):
    model, cfg = _model(ref_cnn), _cfg(ref_protocol, **kw)
    init, client_round, _ = ref_protocol.make_protocol(model, cfg, 3)
    server, pers = init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    pers = pers._replace(residual=jax.tree.map(
        lambda r: jnp.asarray((2e-4 * rng.standard_normal(r.shape))
                              .astype(np.float32)), pers.residual))
    return model, cfg, server, pers, client_round


def _port_round(server, pers, **kw):
    model, cfg = _model(cnn), _cfg(protocol, **kw)
    _, client_round, _ = protocol.make_protocol(model, cfg, 3)
    return client_round, convert.server_state(jax.device_get(server)), \
        convert.client_persistent(jax.device_get(pers))


def _ref_post_training(model, cfg, server, pers, x, y, bidx):
    """The reference protocol's W-training loop, written out."""
    opt = ref_adam(cfg.local_lr)
    params, bn, st = server.params, server.bn_state, pers.opt_state
    for idx in bidx:
        def loss(p, bn=bn, idx=idx):
            logits, nbn = model.apply(
                ref_scaling.apply_scales_tree(p, server.scales), bn,
                jnp.asarray(x[idx]), train=True)
            lp = jax.nn.log_softmax(logits)
            return jnp.mean(-lp[jnp.arange(len(idx)), y[idx]]), nbn
        (_, bn), g = jax.value_and_grad(loss, has_aux=True)(params)
        upd, st = opt.update(g, st, params)
        params = ref_apply(params, upd)
    return params


def _flat(tree):
    return {f"{m}/{n}": np.asarray(v) for m, d in tree.items()
            for n, v in d.items()}


def _flat_port(tree):
    return {f"{m}/{n}": v.detach().numpy() for m, d in tree.items()
            for n, v in d.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_chain_teacher_forced_bitwise(seed):
    model, cfg, server, pers, _ = _ref_setup(seed)
    x, y, *_, bidx = _data(seed)
    params1 = _ref_post_training(model, cfg, server, pers, x, y, bidx)
    up = ref_stages.UpstreamStages(
        method="sparse", sparsify=ref_protocol.sparsify_lib.SparsifyConfig(
            fixed_sparsity=0.9, structured=False))
    fine = ref_stages.path_fine_mask(server.params)
    carried = ref_stages.carry_residual(
        ref_stages.extract_delta(params1, server.params), pers.residual, True)
    r_lv, r_rec, _ = up.compress(carried, fine)
    r_res = ref_stages.new_residual(carried, r_rec, True, pers.residual)

    p_params0 = convert.to_tensors(jax.device_get(server.params))
    p_carried = stages.carry_residual(
        stages.extract_delta(convert.to_tensors(jax.device_get(params1)),
                             p_params0),
        convert.to_tensors(jax.device_get(pers.residual)), True)
    p_up = stages.UpstreamStages(
        method="sparse", sparsify=sparsify.SparsifyConfig(
            fixed_sparsity=0.9, structured=False))
    p_lv, p_rec, _ = p_up.compress(p_carried, stages.path_fine_mask(p_params0))
    p_res = stages.new_residual(p_carried, p_rec, True, None)
    for ref, port in ((r_lv, p_lv), (r_rec, p_rec), (r_res, p_res)):
        a, b = _flat(ref), _flat_port(port)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_scale_levels_teacher_forced_bitwise(seed):
    _, _, server, _, _ = _ref_setup(seed)
    rng = np.random.default_rng(seed)
    scales1 = jax.tree.map(
        lambda s: s + jnp.asarray((3e-4 * rng.standard_normal(s.shape))
                                  .astype(np.float32)), server.scales)
    s_delta = jax.tree.map(lambda a, b: a - b, scales1, server.scales)
    r_lv, r_rec = ref_stages.quantize_scales_delta(s_delta, 2.38e-6)
    p_delta = jax.tree.map(lambda a, b: a - b,
                           convert.to_tensors(jax.device_get(scales1)),
                           convert.to_tensors(jax.device_get(server.scales)))
    p_lv, p_rec = stages.quantize_scales_delta(p_delta, 2.38e-6)
    for ref, port in ((r_lv, p_lv), (r_rec, p_rec)):
        a, b = _flat(ref), _flat_port(port)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,accept", [
    (0, "improves"), (1, "ties"), (2, "rejects")])
def test_whole_client_round_within_tolerance(seed, accept):
    model, cfg, server, pers, ref_round = _ref_setup(seed)
    x, y, vx, vy, bidx = _data(seed)
    ref = jax.device_get(jax.jit(ref_round)(
        server, pers, jnp.asarray(x), jnp.asarray(y), jnp.asarray(vx),
        jnp.asarray(vy), jnp.asarray(bidx)))
    port_round, p_server, p_pers = _port_round(server, pers)
    with torch.no_grad():
        out = port_round(p_server, p_pers, torch.from_numpy(x),
                         torch.from_numpy(y.astype(np.int64)),
                         torch.from_numpy(vx),
                         torch.from_numpy(vy.astype(np.int64)),
                         torch.from_numpy(bidx))
    # local training: loss and BN statistics follow the reference closely
    np.testing.assert_allclose(float(out.metrics["train_loss"]),
                               float(ref.metrics["train_loss"]), rtol=1e-4)
    for k, v in _flat(ref.bn_state).items():
        np.testing.assert_allclose(_flat_port(out.bn_state)[k], v,
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # stage outputs: at most one quantization step apart, at few elements
    ref_rec, port_rec = _flat(ref.recon_delta_params), _flat_port(
        out.recon_delta_params)
    ref_lv, port_lv = _flat(ref.levels_params), _flat_port(out.levels_params)
    moved = total = 0
    for k in ref_rec:
        np.testing.assert_allclose(port_rec[k], ref_rec[k], rtol=0,
                                   atol=STEP * 1.01, err_msg=k)
        moved += int(np.sum(port_lv[k] != ref_lv[k]))
        total += ref_lv[k].size
    assert moved <= 0.01 * total, (moved, total)
    np.testing.assert_allclose(float(out.metrics["update_sparsity"]),
                               float(ref.metrics["update_sparsity"]),
                               atol=0.01)
    # Eq. 5 residual: carried - recon, so it inherits the same bound
    for k, v in _flat(ref.persistent.residual).items():
        np.testing.assert_allclose(_flat_port(out.persistent.residual)[k], v,
                                   rtol=0, atol=STEP * 1.01, err_msg=k)
    assert int(out.persistent.opt_state.step) == int(
        ref.persistent.opt_state.step)
    assert int(out.persistent.sched_step) == int(ref.persistent.sched_step)

    # Eq. 4 sub-epochs: these inputs reach the accept rule's outcome named
    ref_slv, port_slv = _flat(ref.levels_scales), _flat_port(out.levels_scales)
    gain = float(ref.metrics["val_acc"]) - float(
        ref.metrics["val_acc_unscaled"])
    sent = any(np.any(v) for v in ref_slv.values())
    assert {"improves": gain > 0 and sent, "ties": gain == 0 and sent,
            "rejects": not sent}[accept], (gain, sent)
    # the accept rule compares the same accuracies, so decides the same
    for m in ("val_acc_unscaled", "val_acc"):
        assert float(out.metrics[m]) == float(ref.metrics[m]), m
    ref_srec, port_srec = (_flat(ref.recon_delta_scales),
                           _flat_port(out.recon_delta_scales))
    moved = total = 0
    for k in ref_slv:
        np.testing.assert_allclose(port_srec[k], ref_srec[k], rtol=0,
                                   atol=FINE * 1.01, err_msg=k)
        moved += int(np.sum(port_slv[k] != ref_slv[k]))
        total += ref_slv[k].size
    assert moved <= 0.03 * total, (moved, total)
    # the scale optimizer: Adam moments of the last sub-epoch's step
    ref_so, port_so = (ref.persistent.scale_opt_state,
                       out.persistent.scale_opt_state)
    assert int(port_so.step) == int(ref_so.step)
    for name in ("mu", "nu"):
        port_m = _flat_port(getattr(port_so, name))
        for k, v in _flat(getattr(ref_so, name)).items():
            np.testing.assert_allclose(port_m[k], v, rtol=0,
                                       atol=1e-4 * np.abs(v).max(),
                                       err_msg=f"{name} {k}")
