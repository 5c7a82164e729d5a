"""Transformer tensor parallelism, whole models, against the reference.

The ten reduced architectures at tp = 2 (and gemma2-2b with
``parallel_block``, one gather and one reduce-scatter a layer), and
gemma2-2b, recurrentgemma-9b and mixtral-8x22b with
``moe_impl="ep_a2a"`` at tp = 4:
a tp = 1 tree drawn from a seed (the port's ``init_params`` on the CPU)
is cut into each rank's shards, in the prefill and the decode layout, by
``convert.shard_transformer_params``.  The same shards go

* through the reference under ``shard_map`` over forced host devices, in
  ONE JAX subprocess for the whole file (this file run as a script with
  ``--reference``), and
* through the port's gloo job at the same tp (``launch.tp_check``, one
  job a tp size, torch on one thread), each worker cutting its own
  shards from the same seed (``convert.init_shard_params``).

Each run is ``forward_full`` and ``loss_fn`` on a batch of 2 x 64
tokens, then 3 prompt tokens fed through ``decode_step`` from
``init_cache`` (the reference's way at tp > 1), with each shard's cache.

Bounds: floating outputs (final hidden states, aux, loss, caches) within
``TOL`` = 1e-5 of the reference tensor's largest magnitude; greedy tokens
equal but where the port's top two logits lie within that bound.

The splitter is pinned to the reference's layout: for the dense, MoE,
VLM and enc-dec families the reference at tp = k on the split matches
the reference at tp = 1 on the whole tree (and the port at tp = k the
port at tp = 1).  The SSM and hybrid families are not the tp = 1
function when sharded, by the reference's design: Mamba-2's gated RMS
norm normalises over the shard's own ``d_inner`` slice
(``src/repro/models/ssm.py:170`` and ``207``), and the RG-LRU gates
``w_a``, ``w_i`` are per shard, (W/tp x W/tp), so block-diagonal
(``src/repro/models/rglru.py:54`` and ``56``).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.launch import tp_check
from repro_torch.launch.arch_check import rel_gap, token_misses
from repro_torch.models import transformer as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
B, SEQ, FEED = 2, 64, 3
ARCHS = ["dbrx-132b", "gemma2-2b", "gemma2-9b", "internlm2-1.8b",
         "mamba2-370m", "mistral-large-123b", "mixtral-8x22b",
         "qwen2-vl-72b", "recurrentgemma-9b", "whisper-small"]
TP4 = {"gemma2-2b": {}, "recurrentgemma-9b": {},
       "mixtral-8x22b": {"moe_impl": "ep_a2a"}}
CASES = ([(a, 2, {}) for a in ARCHS]
         + [("gemma2-2b", 2, {"parallel_block": True})]
         + [(a, 4, over) for a, over in TP4.items()])
NOT_TP1 = {"ssm": "ssm.py:170, 207 (gated norm over the shard's d_inner)",
           "hybrid": "rglru.py:54, 56 (per-shard W/tp x W/tp gates)"}


def name_of(arch, tp, over):
    return f"{arch} tp{tp}" + "".join(f" {k}={v}" for k, v in over.items())


IDS = [name_of(*c) for c in CASES]


def case_dict(arch, tp, over) -> dict:
    return {"name": name_of(arch, tp, over), "arch": arch, "reduced": True,
            "over": over, "seq": SEQ, "feed": FEED, "batch_size": B,
            "seed": 0, "draw": "cpu", "runs": ["cpu"], "keep_cache": True,
            "keep_logits": True}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def flat(tree) -> list:
    """Leaves in the reference's order (dict keys sorted, tuples in
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in flat(v)]
    return [np.asarray(tree)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(one_thread):
    """name -> {"ref": reference at tp, "ref1": reference at tp = 1,
    "port": [each rank's result], "port1": the port at tp = 1}."""
    cases = [case_dict(*c) for c in CASES]
    jobs = {tp: tp_check.TPJob([c for c, (_, t, _) in zip(cases, CASES)
                                if t == tp], tp) for tp in (2, 4)}
    ref_in = []
    port1 = {}
    for c, (arch, tp, over) in zip(cases, CASES):
        cfg = tp_check.cfg_of(c)
        full = pt.init_params(torch.Generator().manual_seed(0), cfg)
        batch = tp_check.make_batch(cfg, B, SEQ, 1)
        shards = [[_np(convert.shard_transformer_params(
            full, cfg, pt.ShardPlan(tp, decode_layout=dl), r))
            for r in range(tp)] for dl in (False, True)]
        ref_in.append({"name": c["name"], "arch": arch, "over": over,
                       "tp": tp, "full": _np(full), "shards": shards,
                       "batch": _np(batch)})
        port1[c["name"]] = tp_check.run_case(
            cfg, full, full, batch, 1, "cpu", feed=FEED, greedy=0,
            keep_cache=True, keep_logits=True)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(ref_in, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(ROOT, "src"),
                        os.environ.get("PYTHONPATH", "")]))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--reference", src, dst], env=env,
                               capture_output=True, text=True, timeout=420)
        port = {tp: job.results() for tp, job in jobs.items()}
        assert proc.returncode == 0, proc.stderr[-4000:]
        with open(dst, "rb") as f:
            ref = pickle.load(f)
    out = {}
    for c, (_, tp, _) in zip(cases, CASES):
        n = c["name"]
        out[n] = {"ref": ref[n]["tp"], "ref1": ref[n]["tp1"],
                  "port": [r[n][0] for r in port[tp]], "port1": port1[n]}
    return out


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_and_loss_match_the_reference(case, runs):
    """Each rank's final hidden states (whole after the last gather),
    aux and loss against the reference's shard."""
    run = runs[name_of(*case)]
    for r, got in enumerate(run["port"]):
        assert rel_gap(run["ref"]["x"][r], got["x"]) <= TOL
        assert rel_gap(run["ref"]["loss"][r], got["loss"]) <= TOL
        assert rel_gap(run["ref"]["aux"][r], got["aux"]) <= TOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_steps_and_caches_match_the_reference(case, runs):
    """3 decode steps from ``init_cache``: each rank's tokens and every
    leaf of its cache against the reference's shard."""
    run = runs[name_of(*case)]
    for r, got in enumerate(run["port"]):
        want_t = run["ref"]["tokens"][:, r]
        ties, misses = token_misses(got["logits"], got["tokens"], want_t,
                                    TOL)
        assert not misses and len(ties) <= 1, (ties, misses)
        want_c, got_c = run["ref"]["cache"][r], flat(got["cache"])
        assert len(want_c) == len(got_c)
        for w, g in zip(want_c, got_c):
            assert w.shape == g.shape
            assert rel_gap(w, g) <= TOL


def _same_function(arch):
    return tp_check.cfg_of({"arch": arch, "reduced": True}).family \
        not in NOT_TP1


TP1_CASES = [c for c in CASES if _same_function(c[0])]
OTHER = [c for c in CASES if not _same_function(c[0])]


@pytest.mark.parametrize("case", TP1_CASES, ids=[name_of(*c)
                                                 for c in TP1_CASES])
def test_reference_split_matches_its_tp1_run(case, runs):
    """The splitter cuts the reference's layout: the reference at tp = k
    on the shards equals the reference at tp = 1 on the whole tree."""
    run = runs[name_of(*case)]
    ref, ref1 = run["ref"], run["ref1"]
    for r in range(case[1]):
        assert rel_gap(ref1["x"], ref["x"][r]) <= TOL
        assert rel_gap(ref1["loss"], ref["loss"][r]) <= TOL
        ties, misses = token_misses(run["port1"]["logits"], ref1["tokens"],
                                    ref["tokens"][:, r], TOL)
        assert not misses


@pytest.mark.parametrize("case", TP1_CASES, ids=[name_of(*c)
                                                 for c in TP1_CASES])
def test_port_split_matches_port_tp1(case, runs):
    """The port at tp = k on ``shard_transformer_params(full)`` against
    the port at tp = 1 on ``full``: hidden states, each decode step's
    hidden state, loss, tokens."""
    run = runs[name_of(*case)]
    rec = tp_check.hold(run["port1"], run["port"][0], TOL, name_of(*case))
    assert rec["misses"] == 0


@pytest.mark.parametrize("case", OTHER, ids=[name_of(*c) for c in OTHER])
def test_ssm_and_hybrid_split_is_another_function(case, runs):
    """Named exceptions: sharded Mamba-2 and RG-LRU are not the tp = 1
    function of the same weights (``NOT_TP1``), in the reference and in
    the port alike."""
    run = runs[name_of(*case)]
    fam = tp_check.cfg_of({"arch": case[0], "reduced": True}).family
    assert fam in NOT_TP1
    assert rel_gap(run["ref1"]["x"], run["ref"]["x"][0]) > 1e-3
    assert rel_gap(run["port1"]["x"], run["port"][0]["x"]) > 1e-3


def test_ranks_agree_on_replicated_outputs(runs):
    for name, run in runs.items():
        tp_check.ranks_agree([{name: [p]} for p in run["port"]], name)


def test_init_shard_params_equals_the_split_of_the_full_draw():
    """A worker's shards drawn one leaf at a time equal the split of the
    whole tree drawn from the same seed, in both layouts, bit for bit."""
    for arch, over in (("recurrentgemma-9b", {}),
                       ("mixtral-8x22b", {"moe_impl": "ep_a2a"}),
                       ("mamba2-370m", {}), ("whisper-small", {})):
        cfg = dataclasses.replace(tp_check.cfg_of(
            {"arch": arch, "reduced": True}), **over)
        full = pt.init_params(torch.Generator().manual_seed(3), cfg)
        plans = [pt.ShardPlan(4), pt.ShardPlan(4, decode_layout=True)]
        for rank in (0, 3):
            got = convert.init_shard_params(
                torch.Generator().manual_seed(3), cfg, plans, rank)
            for tree, plan in zip(got, plans):
                want = convert.shard_transformer_params(full, cfg, plan,
                                                        rank)
                assert all(np.array_equal(a, b) for a, b in
                           zip(flat(_np(tree)), flat(_np(want))))


def test_splitter_refuses_what_has_no_tp1_equivalent():
    cfg = tp_check.cfg_of({"arch": "gemma2-2b", "reduced": True})
    full = pt.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="attn_replicated"):
        convert.shard_transformer_params(
            full, cfg, pt.ShardPlan(2, attn_replicated=True), 0)
    moe = dataclasses.replace(tp_check.cfg_of(
        {"arch": "mixtral-8x22b", "reduced": True}), moe_impl="ep_a2a")
    with pytest.raises(ValueError, match="tp % n_experts"):
        convert.shard_transformer_params(
            pt.init_params(torch.Generator().manual_seed(0), moe), moe,
            pt.ShardPlan(2), 0)
    bad = dict(full, final_ln=full["final_ln"][:-1])
    with pytest.raises(ValueError, match="final_ln: shape"):
        convert.shard_transformer_params(bad, cfg, pt.ShardPlan(2), 0)


# ------------------------------------------------- the reference's side

def _reference_main(src: str, dst: str) -> None:
    """Every case through the reference: under ``shard_map`` at its tp
    on its shards, and at tp = 1 on its whole tree (this process has 4
    forced host devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import all_configs
    from repro.models import decode as rd
    from repro.models import transformer as rt
    from repro.models.common import UNSHARDED, ShardCtx

    with open(src, "rb") as f:
        cases = pickle.load(f)
    keys = tp_check.EXTRA_KEYS

    def run(cfg, tp, params, dparams, batch, wrap):
        plan = rt.ShardPlan(tp)
        dplan = rt.ShardPlan(tp, decode_layout=True)
        ctx = ShardCtx(tp_axis="model", tp_size=tp) if tp > 1 else UNSHARDED

        def fwd(p, b):
            p = wrap.take(p)
            x, aux, _ = rt.forward_full(p, b["tokens"], cfg, plan, ctx,
                                        **{k: b.get(k) for k in keys})
            loss = rt.loss_fn(p, b, cfg, plan, ctx)
            return wrap.put((x, jnp.asarray(aux, jnp.float32), loss))

        def step(p, cache, tok):
            p, cache = wrap.take(p), wrap.take(cache)
            nxt, cache = rd.decode_step(p, cache, tok, cfg, dplan, ctx)
            return wrap.put((nxt, cache))

        x, aux, loss = wrap.jit(fwd, 2)(params, batch)
        cache = rd.init_cache(cfg, dplan, B, 8,
                              enc_ctx=cfg.encoder_ctx
                              if cfg.family == "encdec" else None)
        cache = wrap.stack(cache)
        stepper = wrap.jit(step, 3)
        toks = []
        for i in range(FEED):
            nxt, cache = stepper(dparams, cache, batch["tokens"][:, i])
            toks.append(np.asarray(nxt))
        layers = jax.tree.map(np.asarray, cache.layers)
        return {"x": np.asarray(x), "aux": np.asarray(aux),
                "loss": np.asarray(loss), "tokens": np.stack(toks),
                "layers": layers}

    class Single:
        @staticmethod
        def take(t):
            return t

        put = take
        stack = take

        @staticmethod
        def jit(f, n):
            return jax.jit(f)

    class Sharded:
        def __init__(self, tp):
            self.tp = tp
            self.mesh = jax.make_mesh((tp,), ("model",),
                                      devices=jax.devices()[:tp])

        @staticmethod
        def take(t):
            return jax.tree.map(lambda a: a[0], t)

        @staticmethod
        def put(t):
            return jax.tree.map(lambda a: jnp.asarray(a)[None], t)

        def stack(self, t):
            return jax.tree.map(
                lambda a: jnp.broadcast_to(a, (self.tp,) + a.shape), t)

        def jit(self, f, n):
            specs = (P("model"),) + ((P("model"),) if n == 3 else ()) + (
                P(),)
            return jax.jit(jax.shard_map(f, mesh=self.mesh, in_specs=specs,
                                         out_specs=P("model"),
                                         check_vma=False))

    def one(c):
        cfg = dataclasses.replace(all_configs()[c["arch"]].reduced(),
                                  **c["over"])
        tp = c["tp"]
        batch = {k: jnp.asarray(v) for k, v in c["batch"].items()}
        stacked = [jax.tree.map(lambda *a: np.stack(a), *layout)
                   for layout in c["shards"]]
        sharded = run(cfg, tp, stacked[0], stacked[1], batch, Sharded(tp))
        leaves = flat(sharded.pop("layers"))
        sharded["cache"] = [[a[r] for a in leaves] for r in range(tp)]
        one = run(cfg, 1, c["full"], c["full"], batch, Single)
        one.pop("layers")
        return c["name"], {"tp": sharded, "tp1": one}

    # XLA compiles outside the GIL: the cases' compilations overlap
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(4) as pool:
        out = dict(pool.map(one, cases))
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference_main(*sys.argv[2:4])
