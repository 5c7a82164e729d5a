"""The port's multi-process runtime (``repro_torch.dist``,
``executor="dist"``) against the reference's and against the port's own
sharded executor, on the CPU.

The reference's sharded and dist backends fail on this tree ("Resource
axis: clients ... not found in mesh", ROADMAP §3.4), so the dist backend
is held three ways:

* against the reference's ``DistConfig`` and ``CrossHostClientStore``
  directly, where those run in one process: ``validate`` and ``from_env``
  give the same result or message on a table of cases; the cross-host
  wrapper over the port's in-memory and sharded stores gives gather,
  scatter and ``stats()`` bit for bit the reference's wrapper over the
  reference's stores, on one index sequence;
* bit for bit against the port's sharded executor on the same block
  layout: one process (``dist_cohort_full`` on the local mesh), and ONE
  real two-process gloo job (``launch.dist_smoke.Job``, fresh
  interpreters, a localhost port, killed after ``TIMEOUT_S``) running
  ``tests/test_dist_fl.py``'s seed-pin setting (fsfl, stc, fedavg_nnc: 2
  clients, 2 rounds) and its handoff setting (8 clients, cohorts of 2,
  ternary with error feedback, 4 rounds; here behind the sharded store),
  the data, initial state and cohorts the reference's (``PRNGKey(0/1)``
  through ``convert``), and ``async_windowed_b4`` on the port's own data
  (windows through ``run_stacked``): both workers print the same
  records, and those are the in-process sharded run's on ``[cpu,
  cpu]``, server state included; the handoff run moves clients between
  the processes;
* against the reference's live vmap run of the same settings: the
  participants exactly; every round's decoded deltas within 1.5
  quantization steps, scales within 1.5 fine steps, bytes within 2% and
  accuracy within 0.02, the reference's executor contract
  (``test_vmap_run_holds_the_contract_against_the_reference``) for
  params, scales, bytes and accuracy.  The ternary handoff setting's
  top-k ranks a plateau of equal Adam steps, so summation-order noise
  moves elements at its ties, from round 1 on (and from round 2 the
  trajectories start from servers a step apart): an element off by more
  than 1.5 steps must there be a top-k flip (zero on one side), at most
  ``FLIP_SHARE`` of a client's update; the pins hold without one.

A faulted twin (the workers' gather serving the template to a client
that moved) fails the bitwise check; a row holding ``-0.0`` handed from
one process to the other keeps its sign bit (a sum of the owners' rows,
the reference's route, would not).  The job skips only where a localhost
socket cannot be bound.
"""
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import quant as ref_quant
from repro.core.protocol import ProtocolConfig as RefProtocolConfig
from repro.data import federated as ref_federated
from repro.data import synthetic as ref_synthetic
from repro.data.federated import client_epoch_batches as ref_batches
from repro.dist import CrossHostClientStore as RefCrossHost
from repro.dist import DistConfig as RefDistConfig
from repro.dist import DistContext as RefDistContext
from repro.dist import init_from_env as ref_init_from_env
from repro.fl import EngineConfig as RefEngineConfig
from repro.fl import FederatedEngine as RefEngine
from repro.fl import SamplingConfig as RefSamplingConfig
from repro.fl import population as ref_pop
from repro.fl import sampling as ref_sampling
from repro.fl.server_opt import ServerOptConfig as RefServerOptConfig
from repro.models import cnn as ref_cnn
from repro_torch import convert
from repro_torch.data.federated import FederatedSplits
from repro_torch.dist import (CrossHostClientStore, DistConfig, DistContext,
                              context, init_from_env)
from repro_torch.fl import executors, population
from repro_torch.launch import dist_smoke
from repro_torch.launch.mesh import (CohortMesh, make_cohort_mesh,
                                     make_multihost_cohort_mesh)
from repro_torch.tree import items, sorted_items


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the workers run: oneDNN's reductions may
    round otherwise with another count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_job_environment(monkeypatch):
    for var in (context.ENV_COORD, context.ENV_NPROCS, context.ENV_PID):
        monkeypatch.delenv(var, raising=False)


CPU = torch.device("cpu")
STEP = ref_quant.QuantConfig().step_size
FINE_STEP = ref_quant.QuantConfig().fine_step_size
TIMEOUT_S = 180
FLIP_SHARE = 0.05
PINS = ("fsfl", "stc", "fedavg_nnc")
JOB_RUNS = PINS + ("handoff",)
# runs on the port's own data: async windows through run_stacked
OWN_RUNS = ("async_windowed",)


# ------------------------------------------------------------- the config

CONFIGS = {
    "single": dict(),
    "no_coordinator": dict(num_processes=2),
    "pid_out_of_range": dict(coordinator="localhost:1", num_processes=2,
                             process_id=2),
    "negative_pid": dict(coordinator="localhost:1", num_processes=2,
                         process_id=-1),
    "no_processes": dict(num_processes=0),
    "two": dict(coordinator="localhost:1", num_processes=2, process_id=1),
}


def _validate(cls, kw):
    try:
        cls(**kw).validate()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_dist_config_validate_as_the_reference(case):
    assert _validate(DistConfig, CONFIGS[case]) == _validate(
        RefDistConfig, CONFIGS[case])


ENVS = {
    "none": {},
    "coordinator": {"REPRO_DIST_COORD": "localhost:123"},
    "nprocs": {"REPRO_DIST_NPROCS": "3"},
    "all": {"REPRO_DIST_COORD": "localhost:123", "REPRO_DIST_NPROCS": "2",
            "REPRO_DIST_PID": "1"},
}


@pytest.mark.parametrize("case", sorted(ENVS))
def test_dist_config_from_env_as_the_reference(case, monkeypatch):
    for k, v in ENVS[case].items():
        monkeypatch.setenv(k, v)
    port, ref = DistConfig.from_env(), RefDistConfig.from_env()
    assert (port is None) == (ref is None)
    if ref is not None:
        assert ((port.coordinator, port.num_processes, port.process_id)
                == (ref.coordinator, ref.num_processes, ref.process_id))
    assert (context.ENV_COORD, context.ENV_NPROCS, context.ENV_PID) == (
        "REPRO_DIST_COORD", "REPRO_DIST_NPROCS", "REPRO_DIST_PID")


def test_init_from_env_refuses_a_single_process():
    with pytest.raises(RuntimeError) as ref_err:
        ref_init_from_env()
    with pytest.raises(RuntimeError) as port_err:
        init_from_env()
    assert str(port_err.value) == str(ref_err.value)


def test_single_process_context_is_the_identity():
    ctx = DistContext()
    assert (ctx.process_index, ctx.process_count) == (0, 1)
    assert ctx.is_coordinator
    assert ctx.local_devices("cpu") == [CPU]
    assert ctx.global_devices("cpu") == [(0, CPU)]
    mesh = ctx.cohort_mesh("cpu")
    assert isinstance(mesh, CohortMesh) and mesh.owners == [0]
    assert mesh == make_cohort_mesh(None, "cpu")
    tree = {"a": torch.tensor([-0.0, 1.0]), "b": [torch.arange(3)]}
    assert ctx.all_gather_tree(tree) == [tree]
    assert ctx.sum_across_processes(tree) is tree
    ctx.barrier()


class _HalfJoined:
    """A context whose second process never joined."""
    process_index, process_count = 0, 2

    def global_devices(self, device):
        return [(0, CPU)]


def test_multihost_mesh_must_cover_every_process():
    with pytest.raises(RuntimeError, match="not fully joined"):
        make_multihost_cohort_mesh("cpu", ctx=_HalfJoined())


# ------------------------------------------------------------ the store

def _template():
    gen = torch.Generator().manual_seed(0)
    return {"residual": torch.randn((3, 4), generator=gen),
            "step": torch.zeros((), dtype=torch.int32)}


def _rows(template, ids, salt):
    ids = torch.as_tensor(np.asarray(ids))
    res = template["residual"][None] + (ids + salt)[:, None, None].to(
        torch.float32)
    res[:, 0, 0] = -0.0
    return {"residual": res, "step": (ids + salt).to(torch.int32)}


def _stores(backend, tpl, n):
    ref_tpl = {k: v.numpy() for k, v in tpl.items()}
    if backend == "memory":
        return (population.InMemoryStore(tpl, n),
                ref_pop.InMemoryStore(jax.tree.map(jax.numpy.asarray,
                                                   ref_tpl), n))
    cfg = dict(backend="sharded", shard_size=4, max_hot_shards=2)
    return (population.ShardedLazyStore(tpl, n,
                                        population.StoreConfig(**cfg)),
            ref_pop.ShardedLazyStore(ref_tpl, n, ref_pop.StoreConfig(**cfg)))


@pytest.mark.parametrize("owners", ["own", "mixed"])
@pytest.mark.parametrize("backend", ["memory", "sharded"])
def test_crosshost_store_bitwise_the_reference(backend, owners):
    """One process, the same random gathers and scatters through the
    port's wrapper and the reference's: rows (every written row holds a
    ``-0.0``), counters and stats equal.
    ``mixed`` owners name a second process for some positions (rows it
    "trains" are not written here, and read back as zeros), so handoffs
    and the zero fill are exercised too."""
    tpl = _template()
    n = 48
    inner, ref_inner = _stores(backend, tpl, n)
    rng = np.random.default_rng(1)
    plan = [(rng.choice(n, size=5, replace=False),
             rng.integers(0, 2 if owners == "mixed" else 1, 5),
             int(rng.integers(0, 100)), rng.random() < 0.7)
            for _ in range(20)]
    given = [iter([o for _, o, _, _ in plan]) for _ in range(2)]
    port = CrossHostClientStore(inner, DistContext(),
                                lambda k: next(given[0])[:k], tpl)
    ref = RefCrossHost(ref_inner, RefDistContext(),
                       lambda k: next(given[1])[:k],
                       {k: v.numpy() for k, v in tpl.items()})
    for ids, _, salt, write in plan:
        got, want = port.gather(ids), ref.gather(ids)
        for p, leaf in items(got):
            assert isinstance(leaf, torch.Tensor)
            assert leaf.numpy().tobytes() == np.asarray(want[p]).tobytes(), p
        rows = _rows(tpl, ids, salt) if write else got
        port.scatter(ids, rows)
        ref.scatter(ids, {k: v.numpy() for k, v in rows.items()})
        assert port.stats() == ref.stats()
    st = port.stats()
    assert st["crosshost_cold_gathers"] > 0
    assert (st["handoffs"] > 0) == (owners == "mixed")
    if backend == "sharded":
        assert st["spills"] > 0 and st["loads"] > 0
    port.close()


# ---------------------------------------------- the executor, one process

def test_make_executor_builds_the_dist_backend():
    ex = executors.make_executor("dist", device="cpu")
    assert isinstance(ex, executors.DistExecutor)
    assert isinstance(ex, executors.ShardedExecutor)
    assert ex.mesh == [CPU] and list(ex.owners) == [0]
    assert ex.ctx.process_count == 1
    assert ex.position_owners(5).tolist() == [0] * 5
    assert ex.local_rows(5) == (0, 5)


def test_dist_single_process_matches_sharded_on_the_local_mesh():
    """No ``REPRO_DIST_*``: ``dist_cohort_full`` runs on the local mesh,
    bit for bit the sharded run there (records and server state)."""
    dist = dist_smoke.run_records("cohort_full", "dist", "cpu")
    sharded = dist_smoke.run_records("cohort_full", "sharded", "cpu",
                                     mesh=make_cohort_mesh(None, "cpu"))
    assert dist["records"] == sharded["records"]
    assert dist["digest"] == sharded["digest"]
    assert dist["all_gather"] == {}
    assert len(dist["records"]) == 2


# ------------------------------------------------- the two-process job

def _ref_setting(n):
    task = ref_synthetic.ImageTask("t", num_classes=4, channels=3, size=32,
                                   prototypes_per_class=2, noise=0.25)
    x, y = ref_synthetic.make_image_dataset(jax.random.PRNGKey(0), task, 480)
    splits = ref_federated.split_federated(jax.random.PRNGKey(1), x, y,
                                           num_clients=n)
    model = ref_cnn.make_vgg("vgg_tiny_comms", [8, 16], 4, 3,
                             dense_width=16, pool_after=(0, 1))
    return model, splits


def _ref_run(name):
    """The reference's engine of a job run (its live vmap backend):
    ``(engine, clients, cohort, rounds, key seed)``."""
    if name == "handoff":
        cfg = RefProtocolConfig(name="handoff", method="ternary",
                                error_feedback=True, fixed_sparsity=0.9,
                                structured=False, batch_size=32,
                                local_lr=2e-3)
        n, cohort = 8, 2
    else:
        cfg = RefProtocolConfig(name=name, batch_size=32, local_lr=2e-3,
                                **dist_smoke.PINS[name])
        n, cohort = 2, None
    run = dist_smoke.RUNS[name]
    model, splits = _ref_setting(n)
    eng = RefEngine(model, cfg, splits, jax.random.PRNGKey(run.seed),
                    engine_cfg=RefEngineConfig(
                        sampling=RefSamplingConfig(cohort_size=cohort),
                        server_opt=RefServerOptConfig(name="fedavg", lr=1.0),
                        mode="sync", measure_bytes=True))
    assert eng.engine_cfg.executor == "vmap"
    return eng, splits, cfg, n, cohort, run.rounds, run.seed


def _ref_plan(splits, batch_size, n, cohort, rounds, seed):
    """The reference's cohorts and batch orders (its key discipline:
    ``key, kb = split(key)`` a round, then ``key, ks = split(key)`` where a
    cohort is sampled)."""
    n_train = splits.client_x.shape[1]
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    plan = []
    for _ in range(rounds):
        key, kb = jax.random.split(key)
        if cohort is None:
            idx = np.arange(n)
        else:
            key, ks = jax.random.split(key)
            idx = np.asarray(ref_sampling.sample_cohort(
                ks, n, RefSamplingConfig(cohort_size=cohort)))
        plan.append((idx, np.asarray(ref_batches(kb, len(idx), n_train,
                                                 batch_size))))
    return plan


def _capture(eng, into):
    agg = eng.aggregate

    def capture(contribs, weights=None):
        into.append(list(contribs))
        return agg(contribs, weights)

    eng.aggregate = capture


WORKER = """
import json, sys
import numpy as np, torch
from repro_torch.dist import CrossHostClientStore, init_from_env
from repro_torch.fl import population
from repro_torch.launch import dist_smoke
from repro_torch.tree import items, rebuild

ctx = init_from_env()
inputs = torch.load(sys.argv[1], weights_only=False)
out = {name: dist_smoke.run_records(name, "dist", "cpu", inputs=inputs)
       for name in sys.argv[2].split(",")}

# a -0.0 handed from the process that trained it to the one that trains it
# next: (client 0 at position 0, client 1 at position 1), then swapped
tpl = {"r": torch.zeros(3)}
owners = iter([np.array([0, 1]), np.array([0, 1])])
store = CrossHostClientStore(population.InMemoryStore(tpl, 2), ctx,
                             lambda n: next(owners), tpl)
store.scatter([0, 1], {"r": torch.tensor([[-0.0, 1.0, 2.0],
                                          [-0.0, 3.0, 4.0]])})
got = store.gather([1, 0])
store.scatter([1, 0], got)
out["signed_zero"] = {"signbit": torch.signbit(got["r"][:, 0]).tolist(),
                      "handoffs": store.handoffs}
out["sum"] = ctx.sum_across_processes(
    {"x": torch.tensor([ctx.process_index + 1.0, 2.0])})["x"].tolist()
out["mesh"] = [str(d) for d in ctx.cohort_mesh("cpu")]
out["owners"] = ctx.cohort_mesh("cpu").owners

# the faulted twin: a client that moved gets the template, not its state
gather = CrossHostClientStore.gather

def faulty(self, idx):
    rows = gather(self, idx)
    now = self.owner_fn(len(idx))
    moved = [i for i, c in enumerate(idx)
             if self._owner.get(int(c), now[i]) != now[i]]
    def serve(path, leaf):
        leaf = leaf.clone()
        for i in moved:
            leaf[i] = torch.from_numpy(self._template_leaves[
                self._paths.index(path)])
        return leaf
    return rebuild(rows, {p: serve(p, v) for p, v in items(rows)})

CrossHostClientStore.gather = faulty
out["handoff_faulted"] = dist_smoke.run_records("handoff", "dist", "cpu",
                                                inputs=inputs)
print(dist_smoke.PREFIX + json.dumps(out), flush=True)
ctx.barrier()
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The reference's runs, the port's sharded runs on ``[cpu, cpu]``
    and ONE two-process gloo job (started first, collected last)."""
    try:
        dist_smoke.free_port()
    except OSError as e:  # pragma: no cover - sandbox-dependent
        pytest.skip(f"cannot bind a localhost socket here: {e}")
    ref, inputs = {}, {}
    for name in JOB_RUNS:
        eng, splits, cfg, n, cohort, rounds, seed = _ref_run(name)
        server0 = jax.device_get(eng.server)
        pers0 = jax.device_get(jax.tree.map(lambda x: x[0],
                                            eng.local_train.persistent))
        inputs[name] = {
            "splits": FederatedSplits.from_numpy(*jax.device_get((
                splits.client_x, splits.client_y, splits.client_val_x,
                splits.client_val_y, splits.test_x, splits.test_y))),
            "init_state": convert.initial_state(server0, pers0),
            "plan": _ref_plan(splits, cfg.batch_size, n, cohort, rounds,
                              seed)}
        ref[name] = eng
    path = str(tmp_path_factory.mktemp("dist") / "inputs.pt")
    torch.save(inputs, path)
    workers = dist_smoke.Job(["-c", textwrap.dedent(WORKER), path,
                              ",".join(JOB_RUNS + OWN_RUNS)])
    try:
        ref_out = {}
        for name, eng in ref.items():
            seen = []
            _capture(eng, seen)
            ref_out[name] = (eng.run(dist_smoke.RUNS[name].rounds).records,
                             seen)
        sharded = {}
        for name in JOB_RUNS + OWN_RUNS:
            seen = []
            got = dist_smoke.run_records(
                name, "sharded", "cpu", mesh=[CPU, CPU], inputs=inputs,
                on_engine=lambda e, s=seen: _capture(e, s))
            sharded[name] = (got, seen)
    finally:
        outs = workers.wait(TIMEOUT_S)
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} exit {rc}\n{out[-2000:]}\n{err[-4000:]}"
    return {"ref": ref_out, "sharded": sharded,
            "workers": [dist_smoke.records_line(out) for _, out, _ in outs]}


def test_workers_print_identical_records(job):
    a, b = job["workers"]
    assert a is not None and b is not None
    for name in JOB_RUNS + OWN_RUNS + ("handoff_faulted",):
        assert a[name]["records"] == b[name]["records"], name
        assert a[name]["digest"] == b[name]["digest"], name


@pytest.mark.parametrize("name", JOB_RUNS)
def test_dist_job_bitwise_the_sharded_run(job, name):
    want = job["sharded"][name][0]
    for got in job["workers"]:
        assert got[name]["records"] == want["records"]
        assert got[name]["digest"] == want["digest"]
    # the workers gathered through the host: one fetch a round, and one
    # store gather a round whose cohort holds a client trained before
    rounds = dist_smoke.RUNS[name].rounds
    seen, warm = set(), 0
    for rec in want["records"]:
        warm += bool(seen & set(rec[3]))
        seen |= set(rec[3])
    assert 0 < warm < rounds
    for got in job["workers"]:
        gathers = got[name]["all_gather"]
        assert gathers["executor.fetch"]["calls"] == rounds
        assert gathers["store.gather"]["calls"] == warm
    assert dist_smoke.compare({name: want},
                              [{name: w[name]} for w in job["workers"]]) == []


@pytest.mark.parametrize("name", JOB_RUNS)
def test_participants_equal_the_reference(job, name):
    ref_records = job["ref"][name][0]
    want = [list(r.participants) for r in ref_records]
    for got in job["workers"]:
        assert [r[3] for r in got[name]["records"]] == want


def _np(tree):
    return {p: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v)
            for p, v in sorted_items(tree)}


def _deltas_within(port, ref, step, rnd, ternary_ties: bool, what: str):
    """Every element within 1.5 ``step``s; with ternary ties, an element
    beyond is a top-k flip (zero on one side), at most ``FLIP_SHARE`` of
    the update."""
    flips = total = 0
    for p, want in _np(ref).items():
        got = _np(port)[p]
        far = np.abs(got - want) > 1.5 * step
        total += want.size
        if far.any():
            assert ternary_ties, (
                f"round {rnd} {what} {p}: {int(far.sum())} elements beyond "
                f"1.5 steps")
            flip = (got == 0) != (want == 0)
            assert flip[far].all(), f"round {rnd} {what} {p}: not a flip"
            flips += int(far.sum())
    assert flips <= FLIP_SHARE * total, (what, rnd, flips, total)
    return flips


@pytest.mark.parametrize("name", JOB_RUNS)
def test_sharded_run_holds_the_contract_against_the_reference(job, name):
    """The in-process sharded run, bit for bit the workers' (above),
    against the reference's live vmap run: the reference's executor
    contract."""
    ref_records, ref_seen = job["ref"][name]
    got, seen = job["sharded"][name]
    flips = []
    for rnd, (mine, theirs) in enumerate(zip(seen, ref_seen), 1):
        assert [c.client for c in mine] == [c.client for c in theirs]
        count = 0
        for a, b in zip(mine, theirs):
            count += _deltas_within(a.delta_params,
                                    jax.device_get(b.delta_params), STEP,
                                    rnd, name == "handoff", "params")
            if b.delta_scales is not None:
                _deltas_within(a.delta_scales,
                               jax.device_get(b.delta_scales), FINE_STEP,
                               rnd, False, "scales")
        flips.append(count)
    print(f"{name}: top-k flips against the reference a round {flips}")
    assert len(seen) == len(ref_seen) == len(ref_records)
    for mine, theirs in zip(got["records"], ref_records):
        assert abs(mine[0] - theirs.up_bytes) <= 0.02 * theirs.up_bytes
        assert abs(mine[1] - theirs.test_acc) <= 0.02


def test_handoff_moves_clients_between_processes(job):
    records = job["sharded"]["handoff"][0]["records"]
    assert len({tuple(r[3]) for r in records}) > 1
    for got in job["workers"]:
        store = got["handoff"]["store"]
        assert store["handoffs"] > 0
        assert store["spills"] > 0
        # each process keeps only the clients its block trained last
        assert 0 < store["owned_clients"] < 8


def test_faulted_handoff_fails_the_check(job):
    want = job["sharded"]["handoff"][0]
    faulted = [{"handoff": w["handoff_faulted"]} for w in job["workers"]]
    bad = dist_smoke.compare({"handoff": want}, faulted)
    assert bad, "serving the template to a moved client went unnoticed"
    assert faulted[0]["handoff"]["records"] != want["records"]


def test_dist_job_runs_async_windows_bitwise(job):
    """``async_windowed_b4``: windows of clients that finish together train
    in one ``run_stacked`` call, each row against its own server
    snapshot, their blocks split across the two processes."""
    want = job["sharded"]["async_windowed"][0]
    windows = sum(len(r[3]) for r in want["records"])
    for got in job["workers"]:
        run = got["async_windowed"]
        assert run["records"] == want["records"]
        assert run["digest"] == want["digest"]
        assert 2 <= run["all_gather"]["executor.fetch"]["calls"] < windows
        assert run["store"]["handoffs"] > 0


def test_two_process_context(job):
    for got in job["workers"]:
        assert got["sum"] == [3.0, 4.0]
        assert got["mesh"] == ["cpu", "cpu"] and got["owners"] == [0, 1]


def test_handoff_keeps_the_sign_of_zero(job):
    for got in job["workers"]:
        assert got["signed_zero"] == {"signbit": [True, True], "handoffs": 2}
    # the reference's route, a sum of the owners' rows, would lose it
    assert not np.signbit(np.float32(0.0) + np.float32(-0.0))
