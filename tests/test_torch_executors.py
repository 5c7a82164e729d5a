"""The port's cohort executors (``repro_torch.fl.executors``) against the
reference's, on the CPU, on the tiny setting of ``tests/test_executors.py``
(a 2-conv VGG on 480 images over 4 clients, cohorts of 3):

* the registry, ``mesh_shape`` and scenario checks of the reference's
  ``test_executors.py``, with the port's defaults (``"vmap"``) and its 34
  registered scenarios;
* ``gather_clients``, ``scatter_clients`` and ``pad_clients`` bitwise the
  reference's on the same numpy trees;
* the cohort forms of the tiny VGG, the reduced ResNet and the reduced
  MobileNet with K = 3 distinct clients (one grouped convolution and one
  BatchNorm call a layer): in float32 each row's logits and BN
  statistics against the port's own per-client apply within 1e-6 of the
  client's largest (its gradients within 1e-5), and all of them against
  ``jax.vmap`` of the reference's within 1e-5; in float64 each row
  within 1e-12 of its client's;
* the batched stage chain (``compress_carry_cohort``, one
  ``level_assign`` call for the cohort) teacher-forced from the serial
  round's post-training params: levels, residuals and nnc-cabac bytes
  bitwise;
* serial, vmap and sharded on one cohort, held to the reference's own
  executor contract (decoded deltas within 1.5 steps, scales within 1.5
  fine steps, BN within rtol 1e-5, bytes within 2%, accuracy within
  0.02); sharded on an explicit two-entry CPU mesh with a ragged cohort
  of 3 (padded to 4, the padded row dropped);
* the same three backends in float64 on the scenario VGG at 1, 3 and 7
  local steps a client: decoded deltas, scales and bytes bit for bit,
  BN within 1e-12 (the grouped route sums in another order, and float64
  keeps that order below every quantization and top-k decision, so the
  batched round is held to the serial round's function itself);
* one local step at a time (``chip_smoke.step_gaps``): from each state
  the serial round steps from, the cohort route's step against the
  serial one, within ``STEP_FACTOR`` of the control (the serial step with
  its params one ulp up) in float32 and within 1e-12 in float64; a
  grouped convolution with two clients' weights swapped fails it;
* the port's vmap run against the reference's default (vmap) run of one
  round, under the same contract;
* ``run_stacked`` against ``run_shared``, and async dispatch windows
  trained in one executor call, deterministic across backends;
* on the card (``gpu``): the two cohort kernels, ``scaled_matmul`` and
  ``level_assign_leaves``, against their plain versions, and each row
  against the kernel's launch on that row alone.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import quant as ref_quant
from repro.core import scaling as ref_scaling
from repro.core.protocol import ProtocolConfig as RefProtocolConfig
from repro.data import federated as ref_federated
from repro.data import synthetic as ref_synthetic
from repro.data.federated import client_epoch_batches as ref_batches
from repro.fl import EngineConfig as RefEngineConfig
from repro.fl import FederatedEngine as RefEngine
from repro.fl import SamplingConfig as RefSamplingConfig
from repro.fl import sampling as ref_sampling
from repro.models import cnn as ref_cnn
from repro_torch import convert
from repro_torch.comms import stages
from repro_torch.core import protocol, scaling, sparsify
from repro_torch.data.federated import FederatedSplits
from repro_torch.fl import engine, executors, sampling, scenarios
from repro_torch.fl.async_buffer import AsyncConfig
from repro_torch.fl.executors import (SerialExecutor, ShardedExecutor,
                                      VmapExecutor, make_executor)
from repro_torch.kernels import level_assign as la
from repro_torch.kernels import scaled_matmul as sm
from repro_torch.launch.mesh import make_cohort_mesh
from repro_torch.models import cnn
from repro_torch.tree import items, row, sorted_items, stack, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = torch.device("cpu")
# the reference's executor tests' protocol, and the paper's FSFL round on
# the same setting (error feedback, the fused stage chain, Eq. 4 scales)
PROTOS = {
    "exec": dict(method="sparse", fixed_sparsity=0.9, batch_size=32,
                 local_lr=2e-3),
    "fsfl": dict(method="sparse", fixed_sparsity=0.9, batch_size=32,
                 local_lr=2e-3, structured=False, error_feedback=True,
                 scaling=True, scale_lr=2e-2, scale_subepochs=2),
}
STEP = ref_quant.QuantConfig().step_size
FINE_STEP = ref_quant.QuantConfig().fine_step_size
SEED = 5


# ------------------------------------------------------------- settings

@pytest.fixture(scope="module")
def tiny4():
    """``tests/test_executors.py``'s tiny setting, the reference's arrays,
    as both packages' splits and models."""
    task = ref_synthetic.ImageTask("t", num_classes=4, channels=3, size=32,
                                   prototypes_per_class=2, noise=0.25)
    x, y = ref_synthetic.make_image_dataset(jax.random.PRNGKey(0), task, 480)
    ref_splits = ref_federated.split_federated(jax.random.PRNGKey(1), x, y,
                                               num_clients=4)
    port_splits = FederatedSplits.from_numpy(*jax.device_get((
        ref_splits.client_x, ref_splits.client_y, ref_splits.client_val_x,
        ref_splits.client_val_y, ref_splits.test_x, ref_splits.test_y)))
    return ref_splits, port_splits


def _vgg(m):
    return m.make_vgg("vgg_tiny_exec", [8, 16], 4, 3, dense_width=16,
                      pool_after=(0, 1))


def _port_engine(tiny4, proto="exec", executor="vmap", cohort=3, **ecfg):
    return engine.FederatedEngine(
        _vgg(cnn), protocol.ProtocolConfig(name="exec", **PROTOS[proto]),
        tiny4[1], seed=SEED, device="cpu",
        engine_cfg=engine.EngineConfig(
            executor=executor,
            sampling=sampling.SamplingConfig(cohort_size=cohort), **ecfg))


def _capture(eng):
    """The engine's aggregated contributions, in order."""
    seen = []
    orig = eng.aggregate

    def capture(contribs, weights=None):
        seen.extend(contribs)
        return orig(contribs, weights)

    eng.aggregate = capture
    return seen


def _np(tree):
    return {p: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v)
            for p, v in sorted_items(tree)}


def _close(a, b, rtol=1e-5, atol=1e-6):
    fa, fb = _np(a), _np(b)
    assert fa.keys() == fb.keys()
    for k, v in fb.items():
        np.testing.assert_allclose(fa[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


def _contract(seen, rec, ref, ref_rec):
    """The reference's executor contract (``tests/test_executors.py``)."""
    assert [c.client for c in seen] == [c.client for c in ref]
    for a, b in zip(seen, ref):
        _close(a.delta_params, b.delta_params, rtol=0, atol=1.5 * STEP)
        _close(a.delta_scales, b.delta_scales, rtol=0, atol=1.5 * FINE_STEP)
        _close(a.bn_state, b.bn_state)
    assert abs(rec.up_bytes - ref_rec.up_bytes) <= 0.02 * ref_rec.up_bytes
    np.testing.assert_allclose(rec.test_acc, ref_rec.test_acc, atol=0.02)


# ------------------------------------------------------------- registry

def test_executor_registry():
    assert isinstance(make_executor("serial"), SerialExecutor)
    assert isinstance(make_executor("vmap"), VmapExecutor)
    sh = make_executor("sharded", mesh_shape=(1,), device="cpu")
    assert isinstance(sh, ShardedExecutor) and sh.mesh_size == 1
    assert sh.mesh == [CPU]
    assert ShardedExecutor(mesh=["cpu", "cpu"]).mesh_size == 2
    with pytest.raises(ValueError, match="unknown executor"):
        make_executor("warp")
    with pytest.raises(NotImplementedError, match=executors.DIST_ITEM):
        make_executor("dist")
    assert executors.EXECUTORS == ("serial", "vmap", "sharded", "dist")


def test_batched_executor_is_the_default():
    assert engine.EngineConfig().executor == "vmap"
    assert scenarios.Scenario("x").executor == "vmap"
    assert len(scenarios.SCENARIOS) == 34
    assert scenarios.get_scenario("sharded_cohort_full").executor == "sharded"
    assert scenarios.NOT_PORTED["dist_cohort_full"] == executors.DIST_ITEM
    with pytest.raises(NotImplementedError, match=executors.DIST_ITEM):
        scenarios.get_scenario("dist_cohort_full")


def test_vmap_executor_needs_a_cohort_form():
    with pytest.raises(TypeError, match="cohort form"):
        VmapExecutor().bind(lambda *a: None)


def test_cohort_mesh():
    assert make_cohort_mesh(None, "cpu") == [CPU]
    assert make_cohort_mesh((1,), "cpu") == [CPU]
    with pytest.raises(ValueError, match="1-D"):
        make_cohort_mesh((1, 1), "cpu")
    with pytest.raises(ValueError, match="devices"):
        make_cohort_mesh((2,), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_cohort_mesh(None)
    else:
        assert make_cohort_mesh(None) == [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_engine_config_validates_executor_axes():
    with pytest.raises(ValueError, match="unknown executor"):
        engine.EngineConfig(executor="warp").validate()
    with pytest.raises(ValueError, match="mesh_shape"):
        engine.EngineConfig(executor="serial", mesh_shape=(1,)).validate()
    with pytest.raises(ValueError, match="mesh_shape"):
        engine.EngineConfig(mesh_shape=(1,)).validate()
    with pytest.raises(ValueError, match="1-D"):
        engine.EngineConfig(executor="sharded", mesh_shape=(1, 1)).validate()
    with pytest.raises(ValueError, match="devices"):
        engine.EngineConfig(executor="sharded",
                            mesh_shape=(4096,)).validate()
    with pytest.raises(ValueError, match="dispatch_window"):
        engine.EngineConfig(
            async_cfg=AsyncConfig(dispatch_window=-0.5)).validate()
    with pytest.raises(ValueError, match="dispatch_window"):
        engine.EngineConfig(
            mode="sync", async_cfg=AsyncConfig(dispatch_window=0.5)).validate()
    engine.EngineConfig(executor="sharded", mesh_shape=(1,)).validate()
    engine.EngineConfig(executor="sharded").validate()
    # the same verdicts as the reference's on every case
    for bad in (dict(executor="warp"), dict(mesh_shape=(1,)),
                dict(executor="sharded", mesh_shape=(1, 1)),
                dict(executor="sharded", mesh_shape=(4096,))):
        with pytest.raises(ValueError):
            RefEngineConfig(**bad).validate()


def test_scenario_registration_validates_executor_axes():
    v = scenarios.validate_scenario
    with pytest.raises(ValueError, match="unknown executor"):
        v(scenarios.Scenario("bad_exec", executor="warp"))
    with pytest.raises(ValueError, match="mesh_shape"):
        v(scenarios.Scenario("bad_mesh", mesh_shape=(1,)))
    with pytest.raises(ValueError, match="devices"):
        v(scenarios.Scenario("bad_mesh_size", executor="sharded",
                             mesh_shape=(4096,)))
    with pytest.raises(ValueError, match="dispatch_window"):
        v(scenarios.Scenario("bad_sync_window", dispatch_window=0.5))
    v(scenarios.Scenario("ok_sharded", executor="sharded"))
    v(scenarios.Scenario("ok_window", mode="async", dispatch_window=0.5))
    built = scenarios.build_engine(scenarios.Scenario(
        "m", executor="sharded", mesh_shape=(1,)))
    assert (built.executor, built.mesh_shape) == ("sharded", (1,))


# ------------------------------------------------------- gather/scatter/pad

def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            tree_map(torch.from_numpy, tree))


def _bitwise(ref_tree, port_tree):
    r, p = dict(sorted_items(jax.device_get(ref_tree))), _np(port_tree)
    assert r.keys() == p.keys()
    for k, v in r.items():
        v = np.asarray(v)
        assert p[k].shape == v.shape and p[k].dtype == v.dtype, k
        assert p[k].tobytes() == v.tobytes(), k


def test_gather_scatter_bitwise_the_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": np.arange(5, dtype=np.int32)}}
    idx = np.array([0, 2, 4])
    ref_t, port_t = _both(tree)
    cohort_r = ref_sampling.gather_clients(ref_t, idx)
    cohort_p = sampling.gather_clients(port_t, idx)
    _bitwise(cohort_r, cohort_p)
    _bitwise(ref_sampling.scatter_clients(ref_t, cohort_r, idx),
             sampling.scatter_clients(port_t, cohort_p, idx))
    moved_r = jax.tree.map(lambda x: x + 100, cohort_r)
    moved_p = tree_map(lambda x: x + 100, cohort_p)
    out = sampling.scatter_clients(port_t, moved_p, idx)
    _bitwise(ref_sampling.scatter_clients(ref_t, moved_r, idx), out)
    # a new tree: the full one is left as it was
    _bitwise(ref_t, port_t)
    np.testing.assert_array_equal(out["b"]["c"].numpy(),
                                  [100, 1, 102, 3, 104])


def test_pad_clients_bitwise_the_reference():
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((3, 2)).astype(np.float32),
            "s": np.arange(3, dtype=np.float32)}
    ref_t, port_t = _both(tree)
    for total in (3, 5, 2):
        _bitwise(ref_sampling.pad_clients(ref_t, total),
                 sampling.pad_clients(port_t, total))
    padded = sampling.pad_clients(port_t, 5)
    assert torch.equal(padded["w"][3], port_t["w"][2])
    assert torch.equal(tree_map(lambda x: x[:3], padded)["s"], port_t["s"])


def test_pad_clients_empty_cohort_raises():
    empty = {"w": torch.zeros((0, 2)), "s": torch.zeros((0,))}
    with pytest.raises(sampling.EmptyCohortError, match="empty cohort"):
        sampling.pad_clients(empty, 4)
    assert sampling.pad_clients(empty, 0)["w"].shape == (0, 2)


# ------------------------------------------------------------- cohort forms

def _resnet_t(m):
    return m.make_resnet("t", [8, 16, 32, 32], 1, 20)


def _mobilenet_t(m):
    return m.make_mobilenet("mobilenet_t", 20, 3, blocks=((16, 1), (24, 2)),
                            expand=1)


MODELS = {"vgg_tiny": (_vgg, 4), "resnet_t": (_resnet_t, 20),
          "mobilenet_t": (_mobilenet_t, 20)}
K = 3
# a grouped convolution's weight gradient sums its batch and pixels in
# another order than each client's own convolution: in float32 up to
# 1.6e-6 of the client's largest gradient on the reduced ResNet, where
# the forward (logits, BN statistics) stays within 1e-6
GRAD_SHARE = 1e-5


def _ref_cohort(name, seed=0):
    """K distinct clients of the reference's model: params, BN state and
    scales (1 plus noise) stacked, images and labels (K, 8, ...)."""
    make, classes = MODELS[name]
    model = make(ref_cnn)
    rng = np.random.default_rng(seed)
    clients = [jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(c)))
               for c in range(K)]
    params = jax.tree.map(lambda *x: np.stack(x), *[p for p, _ in clients])
    state = jax.tree.map(lambda *x: np.stack(x), *[s for _, s in clients])
    scales = jax.tree.map(
        lambda s: (s + 0.05 * rng.standard_normal(s.shape)).astype(
            np.float32),
        jax.vmap(ref_scaling.init_scales)(params))
    x = rng.standard_normal((K, 8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, classes, (K, 8)).astype(np.int32)
    return model, make(cnn), params, state, scales, x, y


def _ref_grads(model, params, scales, state, x, y, train):
    def loss(p, s, st, xb, yb):
        logits, new = model.apply(ref_scaling.apply_scales_tree(p, s), st,
                                  xb, train=train)
        lp = jax.nn.log_softmax(logits)
        return jnp.mean(-lp[jnp.arange(len(yb)), yb]), (logits, new)

    grad = jax.grad(loss, argnums=(0, 1), has_aux=True)
    return jax.device_get(jax.jit(jax.vmap(grad))(params, scales, state, x,
                                                  y))


def _port_grads(model, params, scales, state, x, y, train):
    """Logits, BN state and gradients of the sum of the rows' mean losses
    (a cohort) or of one client's mean loss."""
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    s = tree_map(lambda t: t.clone().requires_grad_(True), scales)
    cohort = x.ndim == 5
    logits, new = model.apply(scaling.apply_scales_tree(p, s, cohort), state,
                              x, train=train, scales=s)
    lp = F.log_softmax(logits, -1)
    loss = torch.mean(-lp.gather(-1, y[..., None].long())[..., 0], dim=-1)
    leaves_p, leaves_s = [v for _, v in items(p)], [v for _, v in items(s)]
    grads = torch.autograd.grad(torch.sum(loss), leaves_p + leaves_s)
    it = iter(grads)
    gp = tree_map(lambda _: next(it), p)
    gs = tree_map(lambda _: next(it), s)
    return logits.detach(), new, gp, gs


def _largest(tree):
    return max(float(np.abs(v).max()) for v in _np(tree).values())


def _rows_close(cohort_tree, per_client, share):
    """Row k of each leaf within ``share`` of client k's largest entry."""
    for k, tree in enumerate(per_client):
        atol = share * _largest(tree)
        got = _np(tree_map(lambda t: t[k], cohort_tree))
        for path, v in _np(tree).items():
            np.testing.assert_allclose(got[path], v, rtol=0, atol=atol,
                                       err_msg=f"client {k} {path}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_cohort_forward_and_gradients(name, train, dtype):
    """Each client of the cohort form (one grouped convolution and one
    BatchNorm call a layer) against the port's own per-client apply: in
    float32 logits and BN statistics within 1e-6 of the client's largest
    and gradients within ``GRAD_SHARE``, and all of them against
    ``jax.vmap`` of the reference's within 1e-5 of the client's largest;
    in float64 every part within 1e-12 of the client's largest."""
    ref_model, model, params, state, scales, x, y = _ref_cohort(name)
    wide = getattr(torch, dtype)
    tp, ts, tsc = (tree_map(lambda t: t.to(wide), convert.to_tensors(t))
                   for t in (params, state, scales))
    tx, ty = torch.from_numpy(x).to(wide), torch.from_numpy(y)
    logits, new, gp, gs = _port_grads(model, tp, tsc, ts, tx, ty, train)
    assert logits.shape == (K, 8, MODELS[name][1])
    singles = [_port_grads(model, row(tp, k), row(tsc, k), row(ts, k), tx[k],
                           ty[k], train) for k in range(K)]
    for part, cohort_tree in enumerate((logits, new, gp, gs)):
        if part == 3 and train:
            continue    # scales are trained with BN frozen
        _rows_close({"t": cohort_tree} if part == 0 else cohort_tree,
                    [{"t": s[0]} if part == 0 else s[part] for s in singles],
                    1e-12 if dtype == "float64" else
                    1e-6 if part < 2 else GRAD_SHARE)
    if dtype == "float64":
        return
    (r_gp, r_gs), (r_logits, r_new) = _ref_grads(ref_model, params, scales,
                                                 state, x, y, train)
    for part, (mine, want) in enumerate(((logits, r_logits), (new, r_new),
                                         (gp, r_gp), (gs, r_gs))):
        if part == 3 and train:
            continue
        if part == 0:
            mine, want = {"t": mine}, {"t": want}
        want = {p: np.asarray(v) for p, v in sorted_items(want)}
        _rows_close(mine, [{p: torch.as_tensor(np.asarray(v[k])) for p, v
                            in want.items()} for k in range(K)], 1e-5)


def test_cohort_stage_chain_teacher_forced_bitwise():
    """The batched stage chain on the serial rounds' own post-training
    deltas (round 2, so the residuals are not zero): levels, the new
    residuals, the reconstruction and the sparsity bitwise each client's
    ``compress_carry``, and the nnc-cabac bytes equal."""
    model, splits = scenarios.default_setting(4, n_samples=640)
    cfg = protocol.ProtocolConfig(**{k: v for k, v in PROTOS["fsfl"].items()})
    init, client_round, _ = protocol.make_protocol(model, cfg, 2)
    server, pers0 = init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    raw = []
    extract0 = stages.extract_delta

    def extract(after, before):
        d = extract0(after, before)
        raw.append(d)
        return d

    outs, residuals = [], []
    stages.extract_delta = extract
    try:
        for c in range(4):
            bidx = torch.stack([torch.randperm(splits.n_train, generator=gen)
                                [:32] for _ in range(2)])
            args = (splits.client_x[c], splits.client_y[c],
                    splits.client_val_x[c], splits.client_val_y[c], bidx)
            first = client_round(server, pers0, *args)
            residuals.append(first.persistent.residual)
            outs.append(client_round(server, first.persistent, *args))
    finally:
        stages.extract_delta = extract0
    deltas = raw[1::2]
    chain = stages.UpstreamStages(
        method="sparse", sparsify=sparsify.SparsifyConfig(
            structured=False, fixed_sparsity=0.9))
    fine = stages.path_fine_mask(server.params)
    levels, recon, new_res, sparsity = chain.compress_carry_cohort(
        stack(deltas), stack(residuals), fine)
    for k in range(4):
        lv, rc, nr, sp = chain.compress_carry(deltas[k], residuals[k], fine)
        for a, b in ((levels, lv), (recon, rc), (new_res, nr)):
            for path, v in items(b):
                got = dict(items(a))[path][k]
                assert got.dtype == v.dtype and torch.equal(got, v), path
        assert torch.equal(sparsity[k], sp)
        # the serial round itself took the same levels and residual
        for path, v in items(outs[k].levels_params):
            assert torch.equal(dict(items(levels))[path][k], v), path
        for path, v in items(outs[k].persistent.residual):
            assert torch.equal(dict(items(new_res))[path][k], v), path
    s_levels = stack([o.levels_scales for o in outs])
    cohort_bytes = engine.measure_update_bytes(levels, s_levels, 4, False)
    serial_bytes = sum(engine.encode_client_bytes(
        o.levels_params, o.levels_scales, False) for o in outs)
    assert cohort_bytes == serial_bytes


# ------------------------------------------------------------- whole rounds

def _sharded_on_two_cpus(eng):
    """The engine's executor swapped for the sharded one over an explicit
    two-entry CPU mesh, bound to the same round."""
    serial = eng.local_train.executor
    sh = ShardedExecutor(mesh=[CPU, CPU])
    sh.bind(serial.round)
    eng.local_train.executor = sh
    return sh


@pytest.mark.parametrize("proto", sorted(PROTOS))
def test_backends_hold_the_executor_contract(tiny4, proto):
    """Serial, vmap and sharded (two CPU entries, a ragged cohort of 3)
    on one cohort give contributions within the reference's contract; the
    sharded backend runs its blocks of 2 rows, the padded row dropped."""
    got = {}
    blocks = []
    for ex in ("serial", "vmap", "sharded"):
        eng = _port_engine(tiny4, proto,
                           executor="serial" if ex == "sharded" else ex)
        if ex == "sharded":
            sh = _sharded_on_two_cpus(eng)
            cohort = sh.cohort

            def spy(*args, _c=cohort):
                blocks.append(int(args[2].shape[0]))
                return _c(*args)

            sh.cohort = spy
        seen = _capture(eng)
        res = eng.run(1)
        got[ex] = (seen, res.records[0])
    assert blocks == [2, 2]
    ref, ref_rec = got["vmap"]
    assert len(ref) == 3 and ref_rec.up_bytes > 0
    for ex in ("serial", "sharded"):
        _contract(*got[ex], ref, ref_rec)


def _float64_engine(n_samples, proto, executor):
    """The scenario VGG over 8 clients on ``n_samples`` images, cohorts
    of 3, its params, BN state, optimizer state and images in float64."""
    model, data = scenarios.default_setting(8, n_samples=n_samples)
    cfg = protocol.ProtocolConfig(name="exec", **PROTOS[proto])
    steps = max(1, data.n_train // cfg.batch_size)
    init = protocol.make_protocol(model, cfg, steps)[0]

    def wide(t):
        return (t.to(torch.float64) if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t)

    state = tuple(tree_map(wide, part)
                  for part in init(torch.Generator().manual_seed(SEED), CPU))
    data = FederatedSplits(*(wide(getattr(data, f.name))
                             for f in dataclasses.fields(data)))
    return engine.FederatedEngine(
        model, cfg, data, device="cpu", init_state=state,
        engine_cfg=engine.EngineConfig(
            executor="serial" if executor == "sharded" else executor,
            sampling=sampling.SamplingConfig(cohort_size=3)))


@pytest.mark.parametrize("n_samples,steps", [(640, 1), (1280, 3),
                                             (2560, 7)])
def test_backends_bitwise_in_float64(n_samples, steps):
    """Serial, vmap and sharded (two CPU entries) whole FSFL rounds (the
    paper's: error feedback, the fused stage chain, Eq. 4 scales; the
    structured chain's ``row_stats`` takes float32 only) in float64:
    the batched round's grouped convolutions and BatchNorm sum in another
    order than each client's own, a difference float64 keeps far below
    every top-k, quantization and accept decision, so the decoded deltas,
    scales and bytes are the serial round's bit for bit and BN within
    1e-12.  In float32 the same rounds part at 1 step (a top-k boundary
    inside a plateau of equal Adam first steps) and at 7."""
    got = {}
    for ex in ("serial", "vmap", "sharded"):
        eng = _float64_engine(n_samples, "fsfl", ex)
        assert eng.local_train.n_train // 32 == steps
        if ex == "sharded":
            _sharded_on_two_cpus(eng)
        seen = _capture(eng)
        got[ex] = (seen, eng.run(1).records[0])
    ref, ref_rec = got["serial"]
    assert len(ref) == 3
    for ex in ("vmap", "sharded"):
        seen, rec = got[ex]
        assert [c.client for c in seen] == [c.client for c in ref]
        assert rec.up_bytes == ref_rec.up_bytes
        assert rec.test_acc == ref_rec.test_acc
        for a, b in zip(seen, ref):
            _close(a.delta_params, b.delta_params, rtol=0, atol=0)
            _close(a.delta_scales, b.delta_scales, rtol=0, atol=0)
            _close(a.bn_state, b.bn_state, rtol=1e-12, atol=1e-15)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _step_engine(dtype: str):
    """``exec_serial_k4``'s setting on the scenario VGG, 1,280 images over
    8 clients (3 W-steps and 2 x 3 S-steps a round), on the serial
    executor; in float64 its state and images widened."""
    model, data = scenarios.default_setting(8, n_samples=1280)
    s = scenarios.get_scenario("exec_serial_k4")
    cfg = scenarios.build_protocol(s, 1)
    state = None
    if dtype == "float64":
        init = protocol.make_protocol(model, cfg, data.n_train // 32)[0]

        def wide(t):
            return (t.to(torch.float64) if isinstance(t, torch.Tensor)
                    and t.is_floating_point() else t)

        state = tuple(tree_map(wide, part) for part in init(
            torch.Generator().manual_seed(SEED), CPU))
        data = FederatedSplits(*(wide(getattr(data, f.name))
                                 for f in dataclasses.fields(data)))
    return engine.FederatedEngine(model, cfg, data, device="cpu",
                                  init_state=state,
                                  engine_cfg=scenarios.build_engine(s))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_one_step_cohort_route_against_the_control(dtype):
    """``chip_smoke.step_gaps`` on the CPU: from each state the serial
    route steps from (3 W-steps, 6 S-steps, 4 clients), one step of the
    cohort route (the 4 clients in one grouped call) against one of the
    serial route, and both again with their ReLU and max-pool routing
    forced to the serial forward's.  In float32 it is held to
    ``step_verdict``: the gradient gap and the count of stepped values
    apart by more than 1e-6 at most ``STEP_FACTOR`` times the control's
    (the serial step with the params one ulp up), with and without the
    forced routing, and no routing decision flipped.  In float64 the
    gradients within 1e-12 of their norm and no stepped value apart by
    more than 1e-12; the grouped convolutions sum in another order, so a
    float64 step is the serial one to its rounding (about 1e-15), not bit
    for bit."""
    smoke = _smoke()
    if dtype == "float64":
        smoke.STEP_PARAM_TOL = 1e-12
    gaps = smoke.step_gaps(torch, _step_engine(dtype), 4)
    assert [(g["kind"], g["step"]) for g in gaps] == (
        [("w", t) for t in range(3)] + [("s", t) for t in range(6)])
    verdict = smoke.step_verdict(gaps)
    assert verdict["broken"] == verdict["broken_forced"] == [], verdict
    assert all(g["flips"] == 0 for g in gaps)
    if dtype == "float64":
        assert max(g["gap"]["cohort"] for g in gaps) <= 1e-12
        assert all(g["apart"]["cohort"] == 0 for g in gaps)


def test_one_step_check_fails_a_faulty_grouped_convolution(monkeypatch):
    """The faulty twin: the cohort route's first grouped convolution with
    two clients' weight rows swapped breaks the rule at every W-step,
    with its routing forced to the serial forward's too."""
    smoke = _smoke()
    conv0 = cnn.conv_apply

    def swapped(p, x, stride=1, groups=1):
        w = p["w"]
        if w.ndim == 5 and w.shape[2] == 3:      # the first layer's
            w = w[torch.tensor([1, 0] + list(range(2, w.shape[0])))]
        return conv0({**p, "w": w}, x, stride, groups)

    monkeypatch.setattr(cnn, "conv_apply", swapped)
    verdict = smoke.step_verdict(
        smoke.step_gaps(torch, _step_engine("float32"), 4))
    assert {"w0", "w1", "w2"} <= set(verdict["broken_forced"]), verdict
    assert verdict["worst_forced"]["gap"][0] > 1e3


def _ref_plan(ref_splits, cfg, n_clients, cohort, rounds, seed=SEED):
    """The reference engine's cohorts and batch orders (its key
    discipline replayed)."""
    n_train = ref_splits.client_x.shape[1]
    key = jax.random.PRNGKey(seed)
    _, key = jax.random.split(key)
    plan = []
    scfg = RefSamplingConfig(cohort_size=cohort)
    for _ in range(rounds):
        key, kb = jax.random.split(key)
        key, ks = jax.random.split(key)
        idx = ref_sampling.sample_cohort(ks, n_clients, scfg)
        plan.append((np.asarray(idx), np.asarray(ref_batches(
            kb, len(idx), n_train, cfg.batch_size))))
    return plan


@pytest.mark.parametrize("proto", sorted(PROTOS))
def test_vmap_run_holds_the_contract_against_the_reference(tiny4, proto):
    """One round of the port's default (vmap) engine against the
    reference's default (vmap) engine, from the reference's initial state
    along its cohort and batch order, under the executor contract."""
    ref_splits, port_splits = tiny4
    cfg = RefProtocolConfig(name="exec", **PROTOS[proto])
    ref_eng = RefEngine(_vgg(ref_cnn), cfg, ref_splits,
                        jax.random.PRNGKey(SEED), engine_cfg=RefEngineConfig(
                            sampling=RefSamplingConfig(cohort_size=3)))
    assert ref_eng.engine_cfg.executor == "vmap"
    server0 = jax.device_get(ref_eng.server)
    pers0 = jax.device_get(jax.tree.map(lambda x: x[0],
                                        ref_eng.local_train.persistent))
    ref_seen = []
    agg0 = ref_eng.aggregate

    def capture(contribs, weights=None):
        ref_seen.extend(contribs)
        return agg0(contribs, weights)

    ref_eng.aggregate = capture
    ref_rec = ref_eng.run(1).records[0]
    plan = _ref_plan(ref_splits, cfg, 4, 3, 1)
    assert ref_rec.participants == tuple(int(i) for i in plan[0][0])
    port = engine.FederatedEngine(
        _vgg(cnn), protocol.ProtocolConfig(name="exec", **PROTOS[proto]),
        port_splits, device="cpu", plan=plan,
        init_state=convert.initial_state(server0, pers0),
        engine_cfg=engine.EngineConfig(
            sampling=sampling.SamplingConfig(cohort_size=3)))
    assert isinstance(port.local_train.executor, VmapExecutor)
    seen = _capture(port)
    rec = port.run(1).records[0]
    ref_contribs = [dataclasses.replace(
        c, delta_params=convert.to_tensors(jax.device_get(c.delta_params)),
        delta_scales=convert.to_tensors(jax.device_get(c.delta_scales)),
        bn_state=convert.to_tensors(jax.device_get(c.bn_state)))
        for c in ref_seen]
    _contract(seen, rec, ref_contribs, ref_rec)


def test_stacked_server_entry_point_matches_shared(tiny4):
    """``run_stacked`` with every row carrying the same snapshot agrees
    with ``run_shared`` (the reference's bounds)."""
    eng = _port_engine(tiny4, "fsfl")
    lt = eng.local_train
    s = lt.splits
    bidx = lt.batches(torch.Generator().manual_seed(3), 4)
    args = (lt.state, s.client_x, s.client_y, s.client_val_x,
            s.client_val_y, bidx)
    shared = lt.executor.run_shared(eng.server, *args)
    stacked = lt.executor.run_stacked([eng.server] * 4, *args)
    _close(shared.recon_delta_params, stacked.recon_delta_params, rtol=0,
           atol=1.5 * STEP)
    _close(shared.bn_state, stacked.bn_state)
    for key, atol in [("train_loss", 1e-4), ("update_sparsity", 1e-6),
                      ("val_acc", 0.06)]:
        np.testing.assert_allclose(shared.metrics[key].numpy(),
                                   stacked.metrics[key].numpy(), rtol=1e-4,
                                   atol=atol)
    # distinct snapshots: row i trains from servers[i]
    other = eng.server._replace(params=tree_map(lambda t: t * 0.5,
                                                eng.server.params))
    mixed = lt.executor.run_stacked([eng.server, other, eng.server, other],
                                    *args)
    serial = SerialExecutor()
    serial.bind(_round(eng))
    want = serial.run_stacked([eng.server, other, eng.server, other], *args)
    _close(mixed.recon_delta_params, want.recon_delta_params, rtol=0,
           atol=1.5 * STEP)


def _round(eng):
    """The engine's per-client round (its protocol rebuilt)."""
    steps = max(1, eng.local_train.n_train
                // eng.protocol_cfg.batch_size)
    return protocol.make_protocol(_vgg(cnn), eng.protocol_cfg, steps)[1]


def _async_engine(tiny4, executor, sharded=False, proto="exec", seed=9,
                  **acfg):
    eng = engine.FederatedEngine(
        _vgg(cnn), protocol.ProtocolConfig(name="exec_async",
                                           **PROTOS[proto]),
        tiny4[1], seed=seed, device="cpu", engine_cfg=engine.EngineConfig(
            mode="async", executor=executor, async_cfg=AsyncConfig(**acfg)))
    if sharded:
        _sharded_on_two_cpus(eng)
    return eng


def test_async_window_batches_into_one_executor_call(tiny4):
    """A window wider than the latency spread trains the whole in-flight
    set in ONE call of the cohort form; the buffer aggregates everything
    that arrived."""
    eng = _async_engine(tiny4, "vmap", proto="fsfl", seed=SEED,
                        buffer_size=4, concurrency=4, dispatch_window=100.0)
    ex = eng.local_train.executor
    calls, cohort = [], ex.cohort

    def spy(*args):
        calls.append(int(args[2].shape[0]))
        return cohort(*args)

    ex.cohort = spy
    res = eng.run(2)
    assert eng.scheduler.batch_sizes == [4, 4] and calls == [4, 4]
    assert all(len(r.participants) == 4 for r in res.records)
    assert res.records[0].sim_time_s < res.records[1].sim_time_s


def test_async_windowed_deterministic_across_backends(tiny4):
    """Same seed, same schedule: the (arrival time, client) intake order
    makes it a function of the simulated clock, so serial, vmap and
    sharded replay the same participants, window sizes and times."""
    def run(executor, sharded=False):
        eng = _async_engine(tiny4, executor, sharded, buffer_size=2,
                            concurrency=3, dispatch_window=0.75)
        res = eng.run(2)
        return ([r.participants for r in res.records],
                [r.sim_time_s for r in res.records],
                list(eng.scheduler.batch_sizes))

    a, b = run("vmap"), run("vmap")
    assert a == b
    for parts, times, sizes in (run("serial"), run("serial", sharded=True)):
        assert parts == a[0] and sizes == a[2]
        np.testing.assert_allclose(times, a[1], rtol=1e-12)


def test_sharded_scenario_runs_on_the_cpu():
    res = scenarios.run_scenario("sharded_cohort_full", rounds=1,
                                 device="cpu")
    assert res.records[0].participants == tuple(range(8))
    assert res.records[0].up_bytes > 0


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(32, 128), (32, 10), (32, 20), (120, 128)])
def test_cuda_cohort_scaled_matmul(cuda, m, n):
    """K = 8 rows in one launch each way: forward and every backward
    within the float32 error bound of the plain version, and each row
    bitwise the kernel's launch on that row alone."""
    g = torch.Generator().manual_seed(m + n)
    x, w = (torch.randn(8, r, 128, generator=g).to(cuda) for r in (m, n))
    s = (1 + 0.1 * torch.randn(8, n, generator=g)).to(cuda)
    dy = torch.randn(8, m, n, generator=g).to(cuda)
    sm.reset_counters()
    y = sm.forward(x, w, s)
    dx, dw, ds = sm.backward(dy, x, w, s, True, True, True)
    assert sm.LAUNCHES == {"forward": 1, "backward": 1}
    u = 2.0 ** -24
    for got, want, mag in (
            (y, sm.scaled_matmul_plain(x, w, s),
             x.abs() @ (w.abs() * s.abs()[..., None]).transpose(-1, -2)),
            (dx, sm.dx_plain(dy, w, s),
             dy.abs() @ (w.abs() * s.abs()[..., None])),
            (dw, sm.dw_plain(dy, x, s),
             (dy.abs().transpose(-1, -2) @ x.abs()) * s.abs()[..., None])):
        r = got.shape[-1] if got is dy else 128
        assert bool(((got - want).abs() <= 2 * (r + 2) * u * mag + 1e-30)
                    .all())
    np.testing.assert_allclose(ds.cpu().numpy(),
                               sm.ds_plain(dy, x, w).cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    for k in range(8):
        assert torch.equal(y[k], sm.forward(x[k], w[k], s[k]))
        one = sm.backward(dy[k], x[k], w[k], s[k], True, True, True)
        for a, b in zip((dx, dw, ds), one):
            assert torch.equal(a[k], b)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["vgg11_thinned", "resnet18_small",
                                   "mobilenetv2_small"])
def test_cuda_cohort_level_assign(cuda, model):
    """A cohort of 8 over every leaf of the model in one launch: bitwise
    the plain version and each row's own grouped launch."""
    params, _ = getattr(cnn, model)().init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    shapes = [tuple(v.shape) for _, v in items(params)]
    d = [(1e-3 * torch.randn((8,) + sh, generator=g)).to(cuda)
         for sh in shapes]
    r = [(1e-4 * torch.randn((8,) + sh, generator=g)).to(cuda)
         for sh in shapes]
    th = (torch.rand(8, len(shapes), generator=g) * 1e-3).to(cuda)
    steps = [4.88e-4 if len(sh) > 1 else 2.38e-6 for sh in shapes]
    la.reset_counters()
    lv, cr = la.level_assign_leaves(d, r, th, steps)
    assert la.LAUNCHES["level_assign"] == 1
    plv, pcr = la.level_assign_leaves_plain([t.cpu() for t in d],
                                            [t.cpu() for t in r], th.cpu(),
                                            steps)
    for a, b in zip(lv + cr, plv + pcr):
        assert torch.equal(a.cpu(), b)
    for k in range(8):
        one_lv, one_cr = la.level_assign_leaves(
            [t[k] for t in d], [t[k] for t in r], th[k].contiguous(), steps)
        for a, b in zip(lv + cr, one_lv + one_cr):
            assert torch.equal(a[k], b)
