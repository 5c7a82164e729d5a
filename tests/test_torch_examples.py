"""The twins of ``examples/`` and ``scripts/trace_smoke.py`` on the CPU,
each against the reference script it ports:

* ``quickstart`` (both protocols) and ``federated_cifar`` (its FSFL run,
  and ``--scenario sync_k4_fedadam``, both sides in float64), 2 rounds,
  on the reference
  script's own data, initial state and batch plan (the reference script
  run with its ``run_federated``/``run_scenario`` and ``Evaluate``
  spied on), held to the whole-run tolerances of
  ``test_torch_sampling.py`` (params within a quantization step times the
  server's gain, but for 5 flips and 34 params off by more than 1e-6;
  scales within a fine step a round; accuracy within an image; bytes
  within 2%); their printed lines the reference's with the numbers taken
  out; the twin's checkpoint read back by ``repro.checkpoint.restore`` to
  the port's server state bit for bit;
* ``federated_cifar`` in its own float32, both cases, one round from
  the same state: every param level a client gives apart from the
  reference's is a top-k boundary flip or a one-level rounding crossing;
* ``federated_cifar``'s flag error (``--telemetry`` without
  ``--scenario``) word for word the reference's;
* every twin raises, with no GPU, unless told the CPU;
* ``serve_decode``'s aggregates bitwise the reference script's at the
  same K, chunk and density;
* ``multipod_train --procs 2 --rounds 2``: two gloo workers' records the
  port's own sharded run's on ``[cpu, cpu]`` (the reference's sharded and
  dist runs fail on this tree, ROADMAP §3.4);
* ``launch.trace_smoke`` exits 0, its trace holding every span name the
  reference script requires (read from that script's AST).

Torch runs on one thread (a module fixture), as the slow files do.
"""
import ast
import contextlib
import dataclasses
import importlib.util
import inspect
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_checkpoint
from repro.core.protocol import make_protocol as ref_make_protocol
from repro.data.federated import client_epoch_batches
from repro.fl import rounds as ref_rounds
from repro.fl import sampling as ref_sampling
from repro.fl.scenarios import build_engine as ref_build_engine
from repro.fl.scenarios import build_protocol as ref_build_protocol
from repro_torch import convert
from repro_torch.data.federated import FederatedSplits
from repro_torch.examples import (federated_cifar, multipod_train,
                                  quickstart, serve_decode)
from repro_torch.fl import rounds as rounds_mod
from repro_torch.launch import trace_smoke
from test_torch_sampling import _flat, check_whole_run

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_script(rel: str):
    """A script of the repository (not a package module) as a module."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "ref_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spy_servers(monkeypatch, module, log, to_np):
    """Keep the server state each round's evaluation sees."""
    call0 = module.Evaluate.__call__

    def call(self, server):
        log.append(to_np(server))
        return call0(self, server)

    monkeypatch.setattr(module.Evaluate, "__call__", call)


@contextlib.contextmanager
def x64(on: bool = True):
    """JAX's float64 mode, switched globally for the duration."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def _as64(tree):
    """Every float32 leaf of ``tree`` as float64 (under x64)."""
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a, np.float64))
        if np.asarray(a).dtype == np.float32 else a, tree)


def spy_runs(monkeypatch, module, name: str, log: list,
             float64: bool = False, rounds: int = ROUNDS):
    """Each call of ``module.<name>`` (``run_federated`` or
    ``run_scenario``) at ``rounds`` rounds, its arguments and result
    kept.  With ``float64`` the run is JAX's float64 mode with the
    model's params and BN state and the images in float64 (the
    reference's own float32 pins stay: the scales' init, the steps, the
    learning rates)."""
    real = getattr(module, name)
    sig = inspect.signature(real)

    def run(*args, **kw):
        call = sig.bind(*args, **kw)
        call.arguments["rounds"] = rounds
        with x64(float64):
            if float64:
                model = call.arguments["model"]
                splits = call.arguments["splits"]
                call.arguments["model"] = type(model)(
                    model.name, lambda key: _as64(model.init(key)),
                    model.apply)
                call.arguments["splits"] = dataclasses.replace(splits, **{
                    f: _as64(getattr(splits, f))
                    for f in ("client_x", "client_val_x", "test_x")})
            res = real(*call.args, **call.kwargs)
        log.append(dict(call.arguments, res=res, float64=float64))
        return res

    monkeypatch.setattr(module, name, run)


def ref_inputs(model, cfg, splits, eng_cfg=None, rounds: int = ROUNDS):
    """The reference engine's initial state and cohorts/batch orders from
    key 42 (``k_init, key = split(key)``; a round: ``key, kb =
    split(key)``, then, when sampling, ``key, ks = split(key)``)."""
    n = splits.client_x.shape[0]
    n_train = splits.client_x.shape[1]
    steps = max(1, n_train // cfg.batch_size)
    k_init, key = jax.random.split(jax.random.PRNGKey(42))
    plan = []
    for _ in range(rounds):
        key, kb = jax.random.split(key)
        if eng_cfg is None or eng_cfg.sampling.is_full(n):
            idx = np.arange(n)
        else:
            key, ks = jax.random.split(key)
            idx = ref_sampling.sample_cohort(ks, n, eng_cfg.sampling)
        plan.append((idx, np.asarray(client_epoch_batches(
            kb, len(idx), n_train, cfg.batch_size))))
    float64 = splits.client_x.dtype == np.float64
    with x64(float64):
        init, _, _ = ref_make_protocol(model, cfg, steps)
        server0, pers0 = jax.device_get(init(k_init))
    arrays = jax.device_get((splits.client_x, splits.client_y,
                             splits.client_val_x, splits.client_val_y,
                             splits.test_x, splits.test_y))
    port_splits = FederatedSplits.from_numpy(*arrays)
    if float64:
        port_splits = dataclasses.replace(port_splits, **{
            f: torch.from_numpy(np.array(a)) for f, a in zip(
                ("client_x", "client_val_x", "test_x"), arrays[0::2])})
    return (port_splits, convert.initial_state(server0, pers0), plan,
            len(splits.test_y))


def shape_of(lines: str, *paths) -> list[str]:
    """Printed lines with the given paths and every number taken out."""
    for p in paths:
        lines = lines.replace(str(p), "<out>")
    return [re.sub(r"\d+(\.\d+)?", "#", ln) for ln in lines.splitlines()]


def _records(log, per):
    return [log[i:i + per] for i in range(0, len(log), per)]


def test_quickstart_matches_reference(monkeypatch, capsys):
    ref_mod = load_script("examples/quickstart.py")
    calls, ref_servers, port_servers = [], [], []
    spy_runs(monkeypatch, ref_mod, "run_federated", calls)
    spy_servers(monkeypatch, ref_rounds, ref_servers, jax.device_get)
    spy_servers(monkeypatch, rounds_mod, port_servers, convert.to_numpy)
    ref_mod.main()
    ref_out = capsys.readouterr().out
    assert [c["cfg"].name for c in calls] == ["fedavg", "fsfl"]
    inits = {}
    for c in calls:
        port_splits, init, plan, n_test = ref_inputs(c["model"], c["cfg"],
                                                     c["splits"])
        inits[c["cfg"].name] = init
    res = quickstart.run(quickstart.setting()[0], port_splits, ROUNDS,
                         init_state=inits, plan=plan, device="cpu")
    assert shape_of(capsys.readouterr().out) == shape_of(ref_out)
    for c, ref_srv, port_srv in zip(calls, _records(ref_servers, ROUNDS),
                                    _records(port_servers, ROUNDS)):
        name = c["cfg"].name
        cfg = quickstart.configs()[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(c["cfg"])
        check_whole_run(cfg, c["res"].records, ref_srv, res[name].records,
                        port_srv, n_test)


def spy_intake(monkeypatch, module, log, to_np):
    """Keep each round's stacked client outputs as the uplink takes them,
    with the clients of their rows."""
    intake0 = module.Uplink.intake

    def intake(self, out, clients):
        log.append((list(clients), to_np(out)))
        return intake0(self, out, clients)

    monkeypatch.setattr(module.Uplink, "intake", intake)


def federated_cifar_pair(monkeypatch, capsys, tmp_path, scenario,
                         float64: bool, rounds: int = ROUNDS):
    """The reference script and the twin at the same flags, the twin fed
    the reference's data, initial state and batch plan: the reference's
    run (with ``float64``, JAX's float64 mode), then the twin's in the
    same float type.  -> each side's printed lines, result, server
    state and client outputs a round, and the run's protocol and server
    gain."""
    ref_mod = load_script("examples/federated_cifar.py")
    flags = ["--rounds", str(rounds)] + (
        ["--scenario", scenario] if scenario else [])
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
    ref_out_file = tmp_path / "ref" / "fsfl_server.ckpt"
    out_file = tmp_path / "port" / "fsfl_server.ckpt"
    calls, got = [], {k: [] for k in ("ref_servers", "port_servers",
                                      "ref_outs", "port_outs")}
    spy_runs(monkeypatch, ref_mod,
             "run_scenario" if scenario else "run_federated", calls,
             float64=float64, rounds=rounds)
    spy_servers(monkeypatch, ref_rounds, got["ref_servers"], jax.device_get)
    spy_servers(monkeypatch, rounds_mod, got["port_servers"],
                convert.to_numpy)
    spy_intake(monkeypatch, ref_rounds, got["ref_outs"], jax.device_get)
    spy_intake(monkeypatch, rounds_mod, got["port_outs"], convert.to_numpy)
    monkeypatch.setattr(sys, "argv", ["federated_cifar.py", *flags,
                                      "--out", str(ref_out_file)])
    ref_mod.main()
    ref_out = capsys.readouterr().out
    (call,) = calls
    model, splits = call["model"], call["splits"]
    if scenario:
        ref_s = call["scenario"]
        cfg, eng_cfg = ref_build_protocol(ref_s, rounds), ref_build_engine(
            ref_s)
        gain = eng_cfg.server_opt.lr / eng_cfg.server_opt.eps
    else:
        cfg, eng_cfg, gain = call["cfg"], None, 1.0
    port_splits, init, plan, n_test = ref_inputs(model, cfg, splits, eng_cfg,
                                                 rounds)
    args, port_s = federated_cifar.parse(flags + ["--out", str(out_file),
                                                  "--device", "cpu"])
    res = federated_cifar.run(args, port_s, federated_cifar.setting(args)[0],
                              port_splits, init_state=init, plan=plan,
                              device="cpu")
    return dict(got, ref=call["res"], ref_lines=shape_of(ref_out,
                                                         ref_out_file),
                port=res, port_lines=shape_of(capsys.readouterr().out,
                                              out_file),
                out_file=out_file, cfg=cfg, gain=gain, n_test=n_test)


@pytest.mark.parametrize("scenario", [None, "sync_k4_fedadam"])
def test_federated_cifar_matches_reference(scenario, monkeypatch, capsys,
                                           tmp_path):
    run = federated_cifar_pair(monkeypatch, capsys, tmp_path, scenario,
                               float64=True)
    cfg, res = run["cfg"], run["port"]
    assert run["port_lines"] == run["ref_lines"]
    if not scenario:
        assert dataclasses.asdict(federated_cifar.protocol(ROUNDS)) == \
            dataclasses.asdict(cfg)
    check_whole_run(cfg, run["ref"].records, run["ref_servers"], res.records,
                    run["port_servers"], run["n_test"], run["gain"])

    # the port's checkpoint read back by the reference
    back = ref_checkpoint.restore(str(run["out_file"]))
    assert float(back["acc"]) == res.records[-1].test_acc
    server = convert.to_numpy(res.server)
    for part in ("params", "scales", "bn_state"):
        want = getattr(server, part)
        for m, d in want.items():
            for k, v in d.items():
                got = np.asarray(back[part][m][k])
                assert got.dtype == v.dtype and got.tobytes() == v.tobytes()


def _level_flips(ref_intake, port_intake, part: str) -> dict:
    """Per client of one round's stacked outputs (each side's rows in its
    own cohort order), its ``part`` levels that differ, by kind: a top-k
    boundary flip (0 on one side, on the other the smallest kept
    magnitude of that client's leaf there), a rounding crossing (both
    kept, one level apart), or another difference."""
    (ref_clients, ref_out), (port_clients, port_out) = ref_intake, port_intake
    assert sorted(ref_clients) == sorted(port_clients)
    ref_l = _flat(getattr(ref_out, part))
    port_l = _flat(getattr(port_out, part))
    flips = {}
    for i, c in enumerate(ref_clients):
        j = port_clients.index(c)
        n = dict.fromkeys(("topk", "rounding", "other"), 0)
        for p, v in ref_l.items():
            a = np.asarray(v[i], np.int64)
            b = np.asarray(port_l[p][j], np.int64)
            for x, y in zip(a[a != b], b[a != b]):
                kept, side = (y, b) if x == 0 else (x, a)
                if x == 0 or y == 0:
                    edge = np.abs(side[side != 0]).min()
                    n["topk" if abs(kept) == edge else "other"] += 1
                else:
                    n["rounding" if abs(x - y) == 1 else "other"] += 1
        flips[c] = n
    return flips


@pytest.mark.parametrize("scenario", [None, "sync_k4_fedadam"])
def test_federated_cifar_float32_round_parts_only_at_boundaries(
        scenario, monkeypatch, capsys, tmp_path):
    """The twin's own float32 setting, which the whole-run tolerances do
    not hold (the test above runs both sides in float64), one round from
    the reference's state, data and batches: every param level a client
    gives apart from the reference's is a discrete decision taken on
    float32 summation noise, a top-k flip at the boundary of what that
    client keeps or a rounding crossing of one level, and a client with
    none of them gives the reference's scale levels within one level (a
    client with one trains its scales on another model).  Under
    ``sync_k4_fedadam`` the clients part at many top-k boundaries: Adam's
    local steps move an element by about its rate whatever the size of
    its gradient, so deltas tie in magnitude (every kept bias level of a
    client is the same) and float32's last bit decides the tie.  A FedAdam
    server then carries each flip as up to a whole Adam step, and the
    second round starts from different states, which is why the float32
    run is held here a round at a time."""
    run = federated_cifar_pair(monkeypatch, capsys, tmp_path, scenario,
                               float64=False, rounds=1)
    assert run["port_lines"] == run["ref_lines"]
    ((ref_rec,), (port_rec,)) = run["ref"].records, run["port"].records
    assert port_rec.participants == ref_rec.participants
    (ref_in,), (port_in,) = run["ref_outs"], run["port_outs"]
    params = _level_flips(ref_in, port_in, "levels_params")
    scales = _level_flips(ref_in, port_in, "levels_scales")
    print(f"levels apart per client: params {params}, scales {scales}")
    assert all(n["other"] == 0 for n in params.values()), params
    (ref_c, ref_out), (port_c, port_out) = ref_in, port_in
    ref_s, port_s = _flat(ref_out.levels_scales), _flat(port_out.levels_scales)
    for i, c in enumerate(ref_c):
        if any(params[c].values()):
            continue
        j = port_c.index(c)
        for p, v in ref_s.items():
            d = np.abs(np.asarray(port_s[p][j], np.int64)
                       - np.asarray(v[i], np.int64))
            assert d.max() <= 1, (c, p)


def test_federated_cifar_flag_error_is_the_references(monkeypatch, capsys):
    ref_mod = load_script("examples/federated_cifar.py")
    monkeypatch.setattr(sys, "argv", ["federated_cifar.py", "--telemetry",
                                      "metrics"])
    with pytest.raises(SystemExit) as ref_exit:
        ref_mod.main()
    ref_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as port_exit:
        federated_cifar.main(["--telemetry", "metrics"])
    assert port_exit.value.code == ref_exit.value.code == 2
    assert capsys.readouterr().err.splitlines()[-1] == ref_err
    assert "need --scenario" in ref_err


@pytest.mark.parametrize("entry", [
    "quickstart.main", "federated_cifar.main", "multipod_train.main",
    "serve_decode.main", "serve_decode.run", "trace_smoke.main"])
def test_entry_point_asks_for_cuda_unless_told_the_cpu(entry, monkeypatch):
    """Without ``--device cpu`` (``device="cpu"``) every twin runs on
    CUDA, and with no GPU visible it raises before any work: nothing
    carries on on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, fn = entry.split(".")
    call = getattr({"quickstart": quickstart,
                    "federated_cifar": federated_cifar,
                    "multipod_train": multipod_train,
                    "serve_decode": serve_decode,
                    "trace_smoke": trace_smoke}[mod], fn)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        call([]) if fn == "main" else call()


def test_serve_decode_aggregate_is_the_references(monkeypatch, capsys):
    ref_mod = load_script("examples/serve_decode.py")
    served = []
    serve0 = ref_mod.serve_cohort

    def serve(*args, **kw):
        served.append(serve0(*args, **kw))
        return served[-1]

    monkeypatch.setattr(ref_mod, "serve_cohort", serve)
    flags = ["--k", "4", "--chunk", "2", "--density", "0.05"]
    monkeypatch.setattr(sys, "argv", ["serve_decode.py", *flags])
    ref_mod.main()
    ref_out = capsys.readouterr().out
    res = serve_decode.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == ref_out.splitlines()[0]   # the bytes
    assert out.splitlines()[-1] == ref_out.splitlines()[-1]
    for ref_res, engine in zip(served, serve_decode.ENGINES):
        for part in ("delta_params", "delta_scales"):
            want = jax.tree.leaves(getattr(ref_res, part))
            got = [np.asarray(v) for v in jax.tree.leaves(
                convert.to_numpy(getattr(res[engine], part)))]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.tobytes() == np.asarray(w).tobytes()


def test_multipod_train_matches_the_sharded_run(capsys):
    assert multipod_train.main(["--procs", "2", "--rounds", "2",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "OK: 2-process records match" in out
    ref = [ln.split("] ", 1)[1] for ln in out.splitlines()
           if ln.startswith("[reference] round")]
    assert len(ref) == 2
    for pid in range(2):
        got = [ln.split("] ", 1)[1] for ln in out.splitlines()
               if ln.startswith(f"[worker {pid}] round")]
        assert got == ref


def _reference_trace_names() -> tuple[set, set]:
    """``STAGES`` and the ``required`` loop's names of the reference's
    ``scripts/trace_smoke.py``, from its AST."""
    tree = ast.parse((ROOT / "scripts" / "trace_smoke.py").read_text())
    stages = next(ast.literal_eval(n.value) for n in tree.body
                  if isinstance(n, ast.Assign)
                  and any(getattr(t, "id", None) == "STAGES"
                          for t in n.targets))
    required = next(ast.literal_eval(n.iter) for n in ast.walk(tree)
                    if isinstance(n, ast.For)
                    and getattr(n.target, "id", None) == "required")
    return set(stages), set(required)


def test_trace_smoke_passes_with_the_references_spans(monkeypatch,
                                                      tmp_path):
    import json
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert trace_smoke.main(["--device", "cpu"]) == 0
    doc = json.loads((tmp_path / "trace_smoke.trace.json").read_text())
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    stages, required = _reference_trace_names()
    assert stages <= {n.split(".")[0] for n in names}
    assert required <= names
    assert (set(trace_smoke.STAGES), set(trace_smoke.REQUIRED)) == (
        stages, required)
