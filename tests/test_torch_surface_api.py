"""The public names the port took over from the reference in one slice,
each held against the reference's on the same numpy-seeded inputs:

* ``core.delta``: ``CompressionConfig``, ``compress_delta`` and
  ``delta_levels``, levels and reconstructions bitwise, with and without
  a fine mask (Eqs. 2+3, fixed-rate top-k, the identity);
* ``core.quant``: ``quantize_int8``/``dequantize_int8`` bitwise (a zero
  tensor gets scale 1); ``core.scaling``: ``path_str``, ``bake_scales``,
  ``masked_update`` exact;
* ``fl.server_opt.server_step`` for all five servers, within the
  tolerance of ``test_torch_server_opt.py`` (bitwise with a correctly
  rounded sqrt, 2 ulps with torch's CPU one);
* ``optim.global_norm``/``clip_by_global_norm`` (rtol 1e-6),
  ``optim.schedule.make`` exact for every name, and its ``ValueError``;
* ``data.federated.host_batch_iterator``'s batches and
  ``data.synthetic.make_markov_lm``'s walk (on the reference's three
  drawn arrays) bitwise;
* ``fl.rounds``: ``RoundScheduler`` the base of both schedulers,
  ``client_slice``; ``list_scenarios``, ``list_codecs``,
  ``executors.COHORT_AXIS`` and ``obs.trace.device_span``;
* every export of the reference's ``fl``, ``core``, ``data``, ``comms``
  and ``optim`` packages is an attribute of the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comms as ref_comms
from repro.core import delta as ref_delta
from repro.core import quant as ref_quant
from repro.core import scaling as ref_scaling
from repro.core import sparsify as ref_sparsify
from repro.data import federated as ref_federated
from repro.data import synthetic as ref_synthetic
from repro.fl import executors as ref_executors
from repro.fl import rounds as ref_rounds
from repro.fl import scenarios as ref_scenarios
from repro.fl import server_opt as ref_server_opt
from repro.optim import optim as ref_optim
from repro.optim import schedule as ref_schedule
from repro_torch import comms, convert, optim
from repro_torch.core import delta, quant, scaling, sparsify
from repro_torch.data import federated, synthetic
from repro_torch.fl import executors, rounds, scenarios, server_opt
from repro_torch.obs import trace
from repro_torch.optim import schedule
from repro_torch.tree import sorted_items
from test_torch_server_opt import _exact_sqrt, _ulps

SHAPES = {"conv0": {"w": (8, 3, 3, 3), "b": (8,)},
          "fc0": {"w": (10, 16), "b": (10,)}}


def _tree(seed: int, scale: float = 1e-3):
    rng = np.random.default_rng(seed)
    return {m: {k: (scale * rng.standard_normal(s)).astype(np.float32)
                for k, s in d.items()} for m, d in SHAPES.items()}


def _fine(tree):
    return {m: {k: v.ndim < 2 for k, v in d.items()} for m, d in tree.items()}


def _bitwise(ref_tree, port_tree):
    want = dict(sorted_items(jax.device_get(ref_tree)))
    got = dict(sorted_items(port_tree))
    assert sorted(want) == sorted(got)
    for path, v in got.items():
        w = np.asarray(want[path])
        v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        assert v.dtype == w.dtype and v.shape == w.shape, path
        assert v.tobytes() == w.tobytes(), path


SPARSIFY = {"eqs23": {}, "topk": dict(fixed_sparsity=0.9, structured=False),
            "topk_rows": dict(fixed_sparsity=0.9)}


@pytest.mark.parametrize("fine", [False, True])
@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("name", list(SPARSIFY))
def test_compress_delta_and_levels_bitwise(name, enabled, fine):
    d = _tree(0)
    mask = _fine(d) if fine else None
    rcfg = ref_delta.CompressionConfig(
        sparsify=ref_sparsify.SparsifyConfig(**SPARSIFY[name]),
        enabled=enabled)
    pcfg = delta.CompressionConfig(
        sparsify=sparsify.SparsifyConfig(**SPARSIFY[name]), enabled=enabled)
    assert pcfg.replace(enabled=not enabled).enabled is not enabled
    rd, pd = jax.tree.map(jnp.asarray, d), convert.to_tensors(d)
    _bitwise(ref_delta.delta_levels(rd, rcfg, mask),
             delta.delta_levels(pd, pcfg, mask))
    _bitwise(ref_delta.compress_delta(rd, rcfg, mask),
             delta.compress_delta(pd, pcfg, mask))


@pytest.mark.parametrize("case", ["max_abs", "zero", "given_scale"])
def test_quantize_int8_bitwise(case):
    x = (np.random.default_rng(1).standard_normal((7, 33)) * 0.3
         ).astype(np.float32)
    if case == "zero":
        x[:] = 0.0
    scale = np.float32(0.0071) if case == "given_scale" else None
    rq, rs = ref_quant.quantize_int8(
        jnp.asarray(x), None if scale is None else jnp.asarray(scale))
    pq, ps = quant.quantize_int8(
        torch.from_numpy(x), None if scale is None else torch.tensor(scale))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert ps.numpy().tobytes() == np.asarray(rs, np.float32).tobytes()
    if case == "zero":
        assert float(ps) == 1.0
    np.testing.assert_array_equal(
        quant.dequantize_int8(pq, ps).numpy(),
        np.asarray(ref_quant.dequantize_int8(rq, rs)))


def test_scaling_names_exact():
    params = _tree(2, 1.0)
    scales = {m: {k: (1.0 + 0.1 * np.random.default_rng(3).standard_normal(
        v.shape[0])).astype(np.float32) if v.ndim >= 2
        else np.ones((), np.float32) for k, v in d.items()}
        for m, d in params.items()}
    rp = jax.tree.map(jnp.asarray, params)
    rs = jax.tree.map(jnp.asarray, scales)
    pp, ps = convert.to_tensors(params), convert.to_tensors(scales)
    (rb, r1), (pb, p1) = (ref_scaling.bake_scales(rp, rs),
                          scaling.bake_scales(pp, ps))
    _bitwise(rb, pb)
    _bitwise(r1, p1)
    mask = ref_scaling.scale_mask(rp)
    assert scaling.scale_mask(pp) == mask
    upd = _tree(4, 1e-2)
    upd = {m: {k: upd[m][k][:, 0, 0, 0] if upd[m][k].ndim == 4
               else upd[m][k][:, 0] if upd[m][k].ndim == 2
               else np.float32(upd[m][k][0]) for k in d}
           for m, d in upd.items()}
    _bitwise(ref_scaling.masked_update(rs, jax.tree.map(jnp.asarray, upd),
                                       mask),
             scaling.masked_update(ps, convert.to_tensors(upd), mask))
    # key paths from JAX and plain key tuples give the same strings
    paths, _ = jax.tree_util.tree_flatten_with_path(params)
    for kp, _ in paths:
        assert scaling.path_str(kp) == ref_scaling.path_str(kp)
        assert scaling.path_str([k.key for k in kp]) == \
            ref_scaling.path_str(kp)


@pytest.mark.parametrize("name", ["fedavg", "fedavgm", "fedadam", "fedyogi",
                                  "fedadagrad"])
@pytest.mark.parametrize("exact_sqrt", [False, True])
def test_server_step_matches_reference(name, exact_sqrt, monkeypatch):
    if exact_sqrt:
        monkeypatch.setattr(torch, "sqrt", _exact_sqrt)
    lr = 1.0 if name == "fedavg" else 1e-2
    ropt = ref_server_opt.make_server_opt(
        ref_server_opt.ServerOptConfig(name=name, lr=lr))
    popt = server_opt.make_server_opt(
        server_opt.ServerOptConfig(name=name, lr=lr))
    params = _tree(5, 1.0)
    rp, pp = jax.tree.map(jnp.asarray, params), convert.to_tensors(params)
    r_state, p_state = ropt.init(rp), popt.init(pp)
    bitwise = exact_sqrt or name in ("fedavg", "fedavgm")
    for d in (_tree(6 + i) for i in range(4)):
        rp, r_state = ref_server_opt.server_step(
            ropt, rp, r_state, jax.tree.map(jnp.asarray, d))
        pp, p_state = server_opt.server_step(popt, pp, p_state,
                                             convert.to_tensors(d))
        assert _ulps(rp, pp) <= (0 if bitwise else 2)
    assert int(p_state.step) == int(r_state.step) == 4


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_global_norm_and_clip(max_norm):
    g = _tree(7, 1e-2)
    rg, pg = jax.tree.map(jnp.asarray, g), convert.to_tensors(g)
    np.testing.assert_allclose(float(optim.global_norm(pg)),
                               float(ref_optim.global_norm(rg)), rtol=1e-6)
    rc = dict(sorted_items(jax.device_get(
        ref_optim.clip_by_global_norm(rg, max_norm))))
    for path, v in sorted_items(optim.clip_by_global_norm(pg, max_norm)):
        np.testing.assert_allclose(v.numpy(), rc[path], rtol=1e-6)


@pytest.mark.parametrize("name,period", [("none", None), ("constant", None),
                                         ("linear", None), ("cawr", None),
                                         ("cawr", 7)])
def test_schedule_make_exact(name, period):
    rf = ref_schedule.make(name, 2e-3, 90, period)
    pf = schedule.make(name, 2e-3, 90, period)
    for step in range(0, 100, 3):
        want = np.asarray(rf(jnp.asarray(step, jnp.int32)), np.float32)
        got = pf(torch.tensor(step, dtype=torch.int32)).numpy()
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), \
            (step, got, want)


def test_schedule_make_rejects_an_unknown_name():
    with pytest.raises(ValueError) as ref_err:
        ref_schedule.make("cosine", 1.0, 10)
    with pytest.raises(ValueError) as port_err:
        schedule.make("cosine", 1.0, 10)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("tensors", [False, True])
def test_host_batch_iterator_same_batches(tensors):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((50, 3)).astype(np.float32)
    y = rng.integers(0, 10, 50)
    ref_it = ref_federated.host_batch_iterator(x, y, 16, seed=3)
    it = federated.host_batch_iterator(
        *((torch.from_numpy(x), torch.from_numpy(y)) if tensors
          else (x, y)), 16, seed=3)
    for _ in range(10):          # over three passes: 3 batches each
        (rx, ry), (px, py) = next(ref_it), next(it)
        np.testing.assert_array_equal(np.asarray(px), rx)
        np.testing.assert_array_equal(np.asarray(py), ry)


def test_markov_lm_walk_bitwise_on_the_reference_draws():
    key = jax.random.PRNGKey(3)
    vocab, num_seqs, seq_len, branching = 64, 32, 16, 4
    ref_x, ref_y = ref_synthetic.make_markov_lm(key, vocab, num_seqs,
                                                seq_len, branching)
    kt, ks, kw = jax.random.split(key, 3)
    succ = jax.random.randint(kt, (vocab, branching), 0, vocab)
    start = jax.random.randint(ks, (num_seqs,), 0, vocab)
    choice = jax.random.randint(kw, (num_seqs, seq_len), 0, branching)
    x, y = synthetic._markov_walk(*(torch.from_numpy(np.array(a)).long()
                                    for a in (succ, start, choice)))
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref_x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref_y))


def test_markov_lm_has_structure():
    """The port's own draw, as ``test_substrate.py`` checks the
    reference's: shifted inputs, at most ``branching`` successors."""
    x, y = synthetic.make_markov_lm(torch.Generator().manual_seed(3),
                                    vocab=64, num_seqs=32, seq_len=16)
    assert x.shape == y.shape == (32, 16)
    np.testing.assert_array_equal(x[:, 1:].numpy(), y[:, :-1].numpy())
    succ = {}
    for a, b in zip(x.ravel().tolist(), y.ravel().tolist()):
        succ.setdefault(a, set()).add(b)
    assert max(len(v) for v in succ.values()) <= 4


def test_schedulers_share_the_base_class():
    for cls in (rounds.SyncScheduler, rounds.BufferedAsyncScheduler):
        assert issubclass(cls, rounds.RoundScheduler)
    assert {m: c.__name__ for m, c in rounds.SCHEDULERS.items()} == {
        m: c.__name__ for m, c in ref_rounds.SCHEDULERS.items()}
    base = rounds.RoundScheduler()
    for call in (lambda: base.bind(None, torch.Generator()),
                 base.next_round, lambda: base.log_line(None, None)):
        with pytest.raises(NotImplementedError):
            call()


def test_client_slice_and_registries():
    stacked = {m: {k: np.stack([v, 2 * v]) for k, v in d.items()}
               for m, d in _tree(9).items()}
    _bitwise(ref_rounds.client_slice(jax.tree.map(jnp.asarray, stacked), 1),
             rounds.client_slice(convert.to_tensors(stacked), 1))
    assert scenarios.list_scenarios() == ref_scenarios.list_scenarios()
    assert comms.list_codecs() == ref_comms.list_codecs()
    assert executors.COHORT_AXIS == ref_executors.COHORT_AXIS
    assert trace.device_span is trace.span
    assert trace.device_span("x") is trace.span("y")   # telemetry off


@pytest.mark.parametrize("package", ["fl", "core", "data", "comms", "optim"])
def test_package_exports_resolve(package):
    import importlib
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert set(ref.__all__) <= set(port.__all__)
