"""The paper's MobileNetV2 setting in the port against the reference.

Weights come from the reference's own init and cross through
``repro_torch.convert``; inputs are made from a numpy seed, or, for the
runs, from the reference's draws at data seed 1 and key 42, as in
tests/test_torch_cnn_families.py, whose recording helpers this file uses.

* The depthwise ``conv_apply(..., groups=C)`` against
  ``lax.conv_general_dilated(..., feature_group_count=C)`` for strides 1
  and 2 and sizes 32, 16, 8 and 7, at rtol and atol 1e-5 (a stride-2
  depthwise convolution on an even size pads 0 before and 1 after).
* ``relu6``'s gradient at -1, 0, 3, 6 and 7 equal to ``jax.nn.relu6``'s,
  ``[0, 0, 1, 0, 0]`` (``torch.clamp`` would pass it at the bounds).
* The forward pass (logits and new BN state, training and evaluation) of
  full-width ``mobilenetv2_small(20, 3)`` and of the reduced MobileNet
  ``make_mobilenet("mobilenet_t", 20, 3, blocks=((16, 1), (24, 2)),
  expand=1)`` (a residual block, a stride-2 depthwise block without one,
  and a residual block after it) at rtol and atol 1e-5; their trees and
  the sorted-path wire order; the scales' init and Table 1's scale counts
  under the default and the paper's projection-only predicate
  (``mobilenet_proj_only_predicate``); ``convert`` carrying the
  reference's params, BN state and client state across and back.
* Gradients of the reduced MobileNet: in float64 on both sides within
  1e-10 of the tree's largest; in float32 each leaf no farther from the
  float64 gradient than the reference's own float32 one.  The stage chain
  of a client round teacher-forced, levels and the nnc-cabac payload
  bitwise, under both predicates.
* Whole runs of the reduced MobileNet on VOC-like data with the paper's
  projection-only scales (4 clients, 200 images, batch 16: 2 local steps;
  2 rounds of ``run_federated``; XLA's depthwise convolutions on the CPU
  take seconds a step in float64, so the run is cut in clients and
  images, not in rounds): the engine with the reference's client outputs
  teacher-forced (bytes equal, the server within 2 ulps, accuracy within
  one test image); and the port's own training, each round from the
  reference's state, held by ``chip_smoke.forced_round_check`` in float64
  on both sides, with at most one client a round counted apart.

The ``gpu`` tests hold the kernels to their plain versions at the shapes
``mobilenetv2_small`` gives them: the int8 encode of its 124 entries in
two launches (a message and a cohort of 4, under both predicates),
``row_stats`` on its 21 weight views (the depthwise rows of 9),
``level_assign`` and ``delta_apply`` on its 62 leaves.
"""
import dataclasses
import importlib.util
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_cnn_families as fam
from repro_torch import comms, convert, fl
from repro_torch.comms import stages
from repro_torch.core import fsfl, scaling, sparsify
from repro_torch.core.protocol import baseline_configs
from repro_torch.fl import rounds
from repro_torch.kernels import delta_apply as da
from repro_torch.kernels import delta_compress as dc
from repro_torch.kernels import level_assign as la
from repro_torch.kernels import row_stats as rs
from repro_torch.models import cnn
from repro_torch.tree import items, sorted_items, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import comms as ref_comms
    from repro.comms import stages as ref_stages
    from repro.core import fsfl as ref_fsfl
    from repro.core import protocol as ref_protocol
    from repro.core import scaling as ref_scaling
    from repro.data import federated as ref_federated
    from repro.data import synthetic as ref_synthetic
    from repro.fl import rounds as ref_rounds
    from repro.models import cnn as ref_cnn
    from repro.optim import adam as ref_adam
    from repro.optim import apply_updates as ref_apply
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, comms=ref_comms, stages=ref_stages, fsfl=ref_fsfl,
        protocol=ref_protocol, scaling=ref_scaling, federated=ref_federated,
        synthetic=ref_synthetic, rounds=ref_rounds, cnn=ref_cnn,
        adam=ref_adam, apply=ref_apply)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  fam.ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOL = dict(rtol=1e-5, atol=1e-5)


def _mobilenet_t(m):
    return m.make_mobilenet("mobilenet_t", 20, 3, blocks=((16, 1), (24, 2)),
                            expand=1)


MODELS = {"mobilenetv2_small": lambda m: m.mobilenetv2_small(20, 3),
          "mobilenet_t": _mobilenet_t}


def _predicate(m, name):
    """The default scale predicate or the paper's projection-only one, of
    the reference (``m`` its cnn module) or of the port."""
    if name == "default":
        return None
    return m.mobilenet_proj_only_predicate


PREDICATES = ("default", "proj_only")


def _scales(module, params, pred):
    return (module.init_scales(params) if pred is None
            else module.init_scales(params, pred))


def _mask(module, params, pred):
    return (module.scale_mask(params) if pred is None
            else module.scale_mask(params, pred))


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("size", [32, 16, 8, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv_matches_jax(ref, stride, size):
    jax, jnp = ref.jax, ref.jnp
    rng = np.random.default_rng(0)
    c = 6
    x = rng.standard_normal((2, size, size, c)).astype(np.float32)
    w = rng.standard_normal((c, 1, 3, 3)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "OIHW", "NHWC"), feature_group_count=c)
    got = cnn.conv_apply({"w": torch.from_numpy(w)},
                         torch.from_numpy(x).permute(0, 3, 1, 2), stride,
                         groups=c)
    assert got.shape[2:] == (-(-size // stride),) * 2
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


def test_relu6_gradient_at_its_bounds(ref):
    points = [-1.0, 0.0, 3.0, 6.0, 7.0]
    want = np.asarray(ref.jax.vmap(ref.jax.grad(ref.jax.nn.relu6))(
        ref.jnp.asarray(points)))
    x = torch.tensor(points, requires_grad=True)
    cnn.relu6(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 0.0, 1.0, 0.0, 0.0])


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_reference(ref, name, train):
    make = MODELS[name]
    ref_model, port_model = make(ref.cnn), make(cnn)
    params, state = fam._ref_init(ref, ref_model, 3)
    x = np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    r_logits, r_state = ref.jax.jit(ref_model.apply, static_argnums=3)(
        params, state, ref.jnp.asarray(x), train)
    p_logits, p_state = port_model.apply(
        convert.to_tensors(ref.jax.device_get(params)),
        convert.to_tensors(ref.jax.device_get(state)),
        torch.from_numpy(x), train=train)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits), **TOL)
    fam._allclose_tree(ref.jax.device_get(r_state), p_state, **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_trees_and_wire_order_match_reference(ref, name):
    make = MODELS[name]
    params, state = make(cnn).init(torch.Generator().manual_seed(0))
    r_params, r_state = fam._ref_init(ref, make(ref.cnn), 0)
    for port_tree, ref_tree in ((params, r_params), (state, r_state)):
        flat = ref.jax.tree_util.tree_flatten_with_path(ref_tree)[0]
        ref_order = [(ref.scaling.path_str(kp), tuple(v.shape))
                     for kp, v in flat]
        assert [(p, tuple(v.shape)) for p, v in sorted_items(port_tree)] == (
            ref_order)


def test_full_width_sizes():
    params, _ = cnn.mobilenetv2_small(20, 3).init(
        torch.Generator().manual_seed(0))
    leaves = [v for _, v in items(params)]
    assert len(leaves) == 62
    assert sum(v.numel() for v in leaves) == 54_436
    views = [v for v in leaves if v.ndim >= 2]
    assert len(views) == 21
    assert sum(1 for v in views if tuple(v.shape[1:]) == (1, 3, 3)) == 6


@pytest.mark.parametrize("pred,want", [("default", 1_508),
                                       ("proj_only", 340)])
def test_num_scale_params_table1(ref, pred, want):
    params, _ = cnn.mobilenetv2_small(20, 3).init(
        torch.Generator().manual_seed(0))
    p_pred = _predicate(cnn, pred)
    got = scaling.num_scale_params(_scales(scaling, params, p_pred),
                                   _mask(scaling, params, p_pred))
    r_params, _ = fam._ref_init(ref, ref.cnn.mobilenetv2_small(20, 3), 0)
    r_pred = _predicate(ref.cnn, pred)
    assert got == ref.scaling.num_scale_params(
        _scales(ref.scaling, r_params, r_pred),
        _mask(ref.scaling, r_params, r_pred)) == want


@pytest.mark.parametrize("pred", PREDICATES)
def test_init_scales_and_masks_match_reference(ref, pred):
    params, _ = cnn.mobilenetv2_small(20, 3).init(
        torch.Generator().manual_seed(0))
    r_params, _ = fam._ref_init(ref, ref.cnn.mobilenetv2_small(20, 3), 0)
    p_pred, r_pred = _predicate(cnn, pred), _predicate(ref.cnn, pred)
    got = _scales(scaling, params, p_pred)
    want = fam._flat(_scales(ref.scaling, r_params, r_pred))
    assert {p: (tuple(v.shape), v.dtype) for p, v in sorted_items(got)} == {
        p: (v.shape, torch.float32) for p, v in want.items()}
    assert all(bool((v == 1).all()) for _, v in items(got))
    assert dict(sorted_items(_mask(scaling, params, p_pred))) == {
        p: bool(m) for p, m in sorted_items(
            _mask(ref.scaling, r_params, r_pred))}


def test_convert_round_trip(ref):
    """The reference's server and client state of a MobileNet round
    through ``convert`` and back: every leaf, name and dtype kept."""
    jax = ref.jax
    cfg = ref.protocol.baseline_configs(**fam.COMMON)["fsfl"]
    init, _, _ = ref.protocol.make_protocol(ref.cnn.mobilenetv2_small(20, 3),
                                            cfg, 3)
    server, pers = jax.device_get(jax.jit(init)(jax.random.PRNGKey(0)))
    p_server, p_pers = convert.initial_state(server, pers)
    for want, got in ((server.params, p_server.params),
                      (server.scales, p_server.scales),
                      (server.bn_state, p_server.bn_state),
                      (pers.residual, p_pers.residual),
                      (pers.opt_state.mu, p_pers.opt_state.mu),
                      (pers.scale_opt_state.nu, p_pers.scale_opt_state.nu)):
        back = convert.to_numpy(got)
        flat = fam._flat(want)
        assert {p: v for p, v in sorted_items(back)}.keys() == flat.keys()
        for p, v in sorted_items(back):
            assert v.dtype == flat[p].dtype
            np.testing.assert_array_equal(v, flat[p], err_msg=p)


# ---------------------------------------------------------------- gradients

def _grads(ref, train: bool, x64: bool):
    """Params and scales gradients of the reduced MobileNet, the
    reference's and the port's, from one init with scales off 1, on 8
    images; with ``x64`` both in float64 (the reference under its global
    x64 switch)."""
    jax = ref.jax
    model = _mobilenet_t(ref.cnn)
    params, state = fam._ref_init(ref, model, 3)
    rng = np.random.default_rng(0)
    scales = jax.tree.map(
        lambda s: s + (0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        if s.ndim else s, ref.scaling.init_scales(params))
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 20, 8)
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        if x64:
            params, scales, state = (fam._as64(ref, t)
                                     for t in (params, scales, state))
            x = x.astype(np.float64)
        r_gp, r_gs = jax.device_get(jax.jit(jax.grad(
            fam._ref_loss(ref, model, state, x, y, train),
            argnums=(0, 1)))(params, scales))
    finally:
        jax.config.update("jax_enable_x64", before)
    p_params, p_scales, p_state = (convert.to_tensors(jax.device_get(t))
                                   for t in (params, scales, state))
    p = tree_map(lambda t: t.clone().requires_grad_(True), p_params)
    s = tree_map(lambda t: t.clone().requires_grad_(True), p_scales)
    logits, _ = _mobilenet_t(cnn).apply(scaling.apply_scales_tree(p, s),
                                        p_state, torch.tensor(x),
                                        train=train, scales=s)
    F.cross_entropy(logits, torch.from_numpy(y.astype(np.int64))).backward()
    return ((r_gp, tree_map(lambda t: t.grad, p)),
            (r_gs, tree_map(lambda t: t.grad, s)))


def _largest(tree) -> float:
    """The largest gradient element of a tree."""
    return max(float(np.abs(v).max()) for v in fam._flat(tree).values())


@pytest.mark.parametrize("train", [True, False])
def test_gradients_float64_match_reference(ref, train):
    """In float64 on both sides every gradient element within 1e-10 of the
    largest gradient element of the tree: no ReLU6 input lies within
    float64 noise of a bound."""
    for want, got in _grads(ref, train, True)[:1 if train else 2]:
        scale = _largest(want)
        flat = fam._flat_port(got)
        for k, v in fam._flat(want).items():
            np.testing.assert_allclose(flat[k], v, rtol=0,
                                       atol=1e-10 * scale, err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_gradients_match_reference(ref, train):
    """In float32, each leaf's gradient no farther from the float64 one
    than the reference's float32 gradient is (or within 1e-5 of its norm):
    the BN parameters that a ReLU6 bound or a following training-mode BN
    almost cancel have gradients 1e-5 to 1e-16 of the others', where the
    two float32 summation orders part by percents (the reference's by up
    to 9% of such a leaf's norm on this batch), so a leaf-relative bound
    alone cannot hold; the float64 test above holds the port strictly."""
    for (want, got), (want64, _) in zip(
            _grads(ref, train, False)[:1 if train else 2],
            _grads(ref, train, True)[:1 if train else 2]):
        ref32, port32 = fam._flat(want), fam._flat_port(got)
        for k, v in fam._flat(want64).items():
            if v.ndim == 0:
                continue
            port_err = float(np.linalg.norm(port32[k] - v))
            ref_err = float(np.linalg.norm(ref32[k] - v))
            assert port_err <= max(ref_err, 1e-5 * float(np.linalg.norm(v))),\
                (k, port_err, ref_err)


# ---------------------------------------------------------------- stage chain

@pytest.mark.parametrize("pred", PREDICATES)
@pytest.mark.parametrize("seed", [0, 1])
def test_stage_chain_teacher_forced_bitwise(ref, seed, pred):
    jax, jnp = ref.jax, ref.jnp
    model = _mobilenet_t(ref.cnn)
    cfg = ref.protocol.baseline_configs(
        fixed_sparsity=0.9, batch_size=16, local_lr=2e-3, scale_lr=2e-2,
        scale_subepochs=2, scale_schedule="linear", total_rounds=2,
        scale_predicate=_predicate(ref.cnn, pred))["fsfl"]
    init, _, _ = ref.protocol.make_protocol(model, cfg, 3)
    server, pers = jax.jit(init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    pers = pers._replace(residual=jax.tree.map(
        lambda r: jnp.asarray((2e-4 * rng.standard_normal(r.shape))
                              .astype(np.float32)), pers.residual))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 20, 64).astype(np.int32)
    bidx = rng.permutation(64)[:48].reshape(3, 16)
    params1 = fam._ref_post_training(ref, model, cfg, server, pers, x, y,
                                     bidx)
    s_delta = jax.tree.map(
        lambda s: jnp.asarray((3e-4 * rng.standard_normal(s.shape))
                              .astype(np.float32)), server.scales)

    up = ref.stages.UpstreamStages(
        method="sparse", sparsify=ref.protocol.sparsify_lib.SparsifyConfig(
            fixed_sparsity=0.9, structured=False))
    fine = ref.stages.path_fine_mask(server.params)
    carried = ref.stages.carry_residual(
        ref.stages.extract_delta(params1, server.params), pers.residual, True)
    r_lv, r_rec, _ = up.compress(carried, fine)
    r_res = ref.stages.new_residual(carried, r_rec, True, pers.residual)
    r_slv, r_srec = ref.stages.quantize_scales_delta(s_delta,
                                                     cfg.fine_step_size)

    p_params0 = convert.to_tensors(jax.device_get(server.params))
    p_scales0 = convert.to_tensors(jax.device_get(server.scales))
    assert {p: tuple(v.shape) for p, v in sorted_items(p_scales0)} == {
        p: tuple(v.shape) for p, v in sorted_items(_scales(
            scaling, p_params0, _predicate(cnn, pred)))}
    p_up = stages.UpstreamStages(
        method="sparse", sparsify=sparsify.SparsifyConfig(
            fixed_sparsity=0.9, structured=False))
    p_lv, p_rec, p_res, _ = p_up.compress_carry(
        stages.extract_delta(convert.to_tensors(jax.device_get(params1)),
                             p_params0),
        convert.to_tensors(jax.device_get(pers.residual)),
        stages.path_fine_mask(p_params0))
    p_slv, p_srec = stages.quantize_scales_delta(
        convert.to_tensors(jax.device_get(s_delta)), cfg.fine_step_size)
    for r, p in ((r_lv, p_lv), (r_rec, p_rec), (r_res, p_res),
                 (r_slv, p_slv), (r_srec, p_srec)):
        want, got = fam._flat(jax.device_get(r)), fam._flat_port(p)
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    ref_spec = ref.comms.WireSpec(
        params=ref.comms.shape_template(server.params),
        scales=ref.comms.shape_template(server.scales), fine_mask=fine,
        step_size=cfg.step_size, fine_step_size=cfg.fine_step_size)
    port_spec = comms.WireSpec(
        params=comms.shape_template(p_params0),
        scales=comms.shape_template(p_scales0),
        fine_mask=stages.path_fine_mask(p_params0), step_size=cfg.step_size,
        fine_step_size=cfg.fine_step_size)
    ref_payload = ref.comms.get_codec("nnc-cabac").encode(
        ref.comms.ClientUpdate(r_lv, r_slv, r_rec, r_srec), ref_spec)
    port_payload = comms.get_codec("nnc-cabac").encode(
        comms.ClientUpdate(p_lv, p_slv, p_rec, p_srec), port_spec)
    assert port_payload == ref_payload


# ---------------------------------------------------------------- whole runs

SETTING = (_mobilenet_t, "VOC_LIKE")
CLIENTS, N_SAMPLES, BATCH = 4, 200, 16
PRED = "proj_only"      # the paper's MobileNet variant


@pytest.fixture(scope="module")
def ref_runs(ref):
    """The reference's recorded 2-round runs of the reduced MobileNet with
    projection-only scales, once a float type."""
    runs = {}

    def get(x64):
        if x64 not in runs:
            runs[x64] = fam._record_ref_run(
                ref, "mobilenet_t", x64, SETTING,
                {"scale_predicate": _predicate(ref.cnn, PRED),
                 "batch_size": BATCH}, CLIENTS, N_SAMPLES)
        return runs[x64]
    return get


def _port_scenario():
    return fl.Scenario(fam.SCENARIO, num_clients=CLIENTS, protocol_overrides=(
        ("scale_predicate", _predicate(cnn, PRED)), ("batch_size", BATCH)))


@pytest.fixture(scope="module")
def own_training(ref, ref_runs, smoke):
    """The port's own training in float64, each round from the reference's
    float64 state, held by ``chip_smoke.forced_round_check``; with
    ``faulty`` the port's dense layer scales twice (one recording of the
    reference serves both)."""
    checked = {}

    def get(faulty: bool = False):
        if faulty not in checked:
            run = ref_runs(True)
            assert run.local_steps == 2
            s = _port_scenario()
            cfg = fl.build_protocol(s, fam.ROUNDS)
            log = fam._ref_log(ref, run, cfg)
            dense = cnn.dense_apply
            if faulty:
                cnn.dense_apply = fam._dense_scaled_twice(dense)
            try:
                port = smoke.record_small_run(
                    torch, fl, rounds, s, "cpu", _mobilenet_t(cnn),
                    fam._port_splits(ref, run), forced=log,
                    init_state=convert.initial_state(run.server0,
                                                     run.pers0),
                    plan=run.plan)
            finally:
                cnn.dense_apply = dense
            checked[faulty] = smoke.forced_round_check(torch, cfg, log,
                                                       port[1])
            smoke.print_forced(
                "mobilenet_t (projection-only scales) port against "
                "reference in float64"
                f"{' (dense layer scaling twice)' if faulty else ''}",
                checked[faulty][0])
        return checked[faulty]
    return get


def test_own_training_float64_each_round_from_reference_state(own_training):
    rounds_, failures = own_training()
    assert len(rounds_) == fam.ROUNDS
    assert not failures, failures


def test_own_training_float64_counts_at_most_one_client_apart(
        smoke, own_training):
    counted = [len(r["counted"]) for r in own_training()[0]]
    assert max(counted) <= smoke.MAX_COUNTED, counted


def test_own_training_cap_fails_a_faulty_model(smoke, own_training):
    """The control at this file's size (4 clients, 200 images): the same
    float64 check on a port whose dense layer scales twice counts more
    clients apart than the cap allows, so the cap can fail here."""
    counted = [len(r["counted"]) for r in own_training(faulty=True)[0]]
    assert max(counted) > smoke.MAX_COUNTED, counted


def test_run_federated_teacher_forced_clients_match_reference(
        ref, ref_runs, monkeypatch):
    """2 rounds with the reference's client outputs in place of the port's
    training: the port's wire, aggregation, server step and evaluation
    give the reference's bytes, its server within 2 ulps and its accuracy
    within one test image."""
    run = ref_runs(False)
    outs, servers, plan = run.outs, run.servers, run.plan
    trained = []

    def train_cohort(self, idx, batch_idx, server):
        r = len(trained)
        fam._server_close(server, servers[r - 1] if r else run.server0)
        assert list(idx) == list(plan[r][0])
        out = outs[r]
        trained.append(r)
        persistent = convert.client_persistent(out.persistent)
        self.state = persistent
        return fam.round_output(out, persistent)

    monkeypatch.setattr(rounds.LocalTrain, "train_cohort", train_cohort)
    cfg = dataclasses.replace(baseline_configs(**fam.COMMON)["fsfl"],
                              scale_predicate=cnn.mobilenet_proj_only_predicate,
                              batch_size=BATCH)
    res_port = fsfl.run_federated(
        _mobilenet_t(cnn), cfg, fam._port_splits(ref, run), fam.ROUNDS,
        init_state=convert.initial_state(run.server0, run.pers0), plan=plan,
        device="cpu")
    assert trained == list(range(fam.ROUNDS))
    n_test = len(run.splits.test_y)
    for r, p in zip(run.res.records, res_port.records):
        assert p.participants == r.participants == tuple(range(CLIENTS))
        assert p.up_bytes == r.up_bytes
        assert abs(p.test_acc - r.test_acc) <= 1 / n_test + 1e-6
    fam._server_close(res_port.server, servers[-1])


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _shapes(pred="default"):
    """(params leaf shapes, scales leaf shapes) of mobilenetv2_small."""
    params, _ = cnn.mobilenetv2_small(20, 3).init(
        torch.Generator().manual_seed(0))
    sc = _scales(scaling, params, _predicate(cnn, pred))
    return ([tuple(v.shape) for _, v in items(params)],
            [tuple(v.shape) for _, v in items(sc)])


@pytest.mark.gpu
@pytest.mark.parametrize("pred", PREDICATES)
@pytest.mark.parametrize("k", [1, 4])
def test_cuda_int8_encode_two_launches(cuda, pred, k):
    gen = torch.Generator().manual_seed(k)
    p_shapes, s_shapes = _shapes(pred)
    p = [(1e-3 * torch.randn((k,) + sh, generator=gen)
          * (torch.rand((k,) + sh, generator=gen) < 0.1)).to(cuda)
         for sh in p_shapes]
    s = [(1e-5 * torch.randn((k,) + sh, generator=gen)).to(cuda)
         for sh in s_shapes]
    assert len(p) + len(s) == 124
    dc.reset_counters()
    body = dc.int8_encode_leaves(p, s, 0.0, 128, batched=k > 1)
    launches = sum(dc.LAUNCHES.values())
    plain = dc.int8_encode_leaves_plain(p, s, 0.0, 128)
    torch.cuda.synchronize()
    assert launches == 2
    assert torch.equal(body, plain)


@pytest.mark.gpu
def test_cuda_row_stats_on_the_depthwise_views(cuda):
    gen = torch.Generator().manual_seed(9)
    views = [(1e-3 * torch.randn((sh[0], int(np.prod(sh[1:]))),
                                 generator=gen)).to(cuda)
             for sh in _shapes()[0] if len(sh) >= 2]
    assert len(views) == 21 and sum(v.shape[1] == 9 for v in views) == 6
    rs.reset_counters()
    got = rs.row_stats_leaves(views)
    assert rs.LAUNCHES["row_stats"] == 1
    for v, g in zip(views, got):
        want = rs.row_stats_plain(v)
        torch.cuda.synchronize()
        assert torch.equal(g.view(torch.int32),
                           rs.row_stats(v).view(torch.int32))
        torch.testing.assert_close(g, want, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_cuda_level_assign_and_delta_apply_on_every_leaf(cuda):
    gen = torch.Generator().manual_seed(5)
    shapes = _shapes()[0]
    assert len(shapes) == 62
    d = [(1e-2 * torch.randn(sh, generator=gen)).to(cuda) for sh in shapes]
    r = [(1e-3 * torch.randn(sh, generator=gen)).to(cuda) for sh in shapes]
    th = torch.stack([x.abs().reshape(-1).median() for x in d])
    steps = [(2.0 ** -11, 4.88e-4)[i % 2] for i in range(len(d))]
    la.reset_counters()
    lvs, cs = la.level_assign_leaves(d, r, th, steps)
    assert la.LAUNCHES["level_assign"] == 1
    pls, pcs = la.level_assign_leaves_plain(d, r, th, steps)
    torch.cuda.synchronize()
    for lv, c, pl, pc in zip(lvs, cs, pls, pcs):
        assert torch.equal(lv, pl)
        assert torch.equal(c.view(torch.int32), pc.view(torch.int32))
    sizes = [int(np.prod(sh)) for sh in shapes]
    qs = [torch.randint(-127, 128, (n,), generator=gen,
                        dtype=torch.int8).to(cuda) for n in sizes]
    ss = [(1e-3 * torch.rand(-(-n // 128), generator=gen) + 1e-6).to(cuda)
          for n in sizes]
    for coef in (1.0, -1.0):
        da.reset_counters()
        got = da.delta_apply_leaves(d, qs, ss, coef)
        assert da.LAUNCHES["delta_apply"] == 1
        want = da.delta_apply_leaves_plain(d, qs, ss, coef, 128)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.gpu
def test_cuda_wrappers_take_float32_only(cuda):
    """The plain versions follow a float64 input on the CPU (the float64
    parity runs); on the card the kernels take float32 and nothing else."""
    from repro_torch.kernels import scaled_matmul as sm
    x = torch.zeros((2, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        la.level_assign_leaves([x], [x], torch.zeros(1, dtype=torch.float64,
                                                     device=cuda), [1.0])
    with pytest.raises(TypeError):
        sm.scaled_matmul(x, torch.zeros((4, 3), dtype=torch.float64,
                                        device=cuda),
                         torch.ones(4, device=cuda))
    cpu = torch.zeros((2, 3), dtype=torch.float64)
    assert la.level_assign_leaves([cpu], [cpu], torch.zeros(
        1, dtype=torch.float64), [1.0])[1][0].dtype == torch.float64
