"""The port's coding stack and level codecs against the reference's, byte
for byte.

Level trees are made from a numpy seed in mixed shapes (0-d, 1-d, 2-d,
4-d, and empty leaves) at densities 0, 0.04, 0.1 and 1, some with levels
near the quantizer's clip at +-2**23.  Every comparison is exact:

* ``nnc.encode_tree`` (vectorized and serial engines) and
  ``encode_tree_batch`` give the reference's bytes;
* each package decodes the other's bytes with every engine to the same
  levels;
* the golomb and nnc-cabac codecs' payloads (plain and ternary) equal the
  reference's and decode to equal float32 trees;
* ``encode_client_bytes`` / ``measure_update_bytes`` equal the reference's;
* the device cohort encodes (``nnc_encode_cohort``, ``golomb_encode_cohort``)
  on CPU tensors give row i byte-equal to the host ``encode`` and to the
  reference's device encode, and the golomb range guard declines levels
  whose int32 zigzag would wrap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comms as ref_comms
from repro.coding import nnc as ref_nnc
from repro.comms import device as ref_device
from repro.core.protocol import RoundOutput as RefRoundOutput
from repro.fl import engine as ref_engine
from repro_torch import comms, convert
from repro_torch.coding import CorruptPayloadError, nnc
from repro_torch.comms import device
from repro_torch.core.protocol import RoundOutput
from repro_torch.fl import engine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = {"conv0": {"w": (6, 3, 3, 3), "b": (6,)},
          "bn0": {"gamma": (6,), "beta": (6,)},
          "fc0": {"w": (10, 24), "b": (10,)},
          "empty": {"v": (0,), "m": (4, 0)}}
SCALE_SHAPES = {"conv0": {"w": (6,), "b": ()}, "fc0": {"w": (10,), "b": ()}}
# a ternary tail is the max |recon| of each tensor: no empty leaves there
TERNARY_SHAPES = {m: d for m, d in SHAPES.items() if m != "empty"}
DENSITIES = [0.0, 0.04, 0.1, 1.0]
ENGINES = ["vectorized", "serial", "speculative"]


def _levels(shapes, seed, density, lead=(), big=False):
    """int32 level tree: Laplace-like magnitudes, ``density`` nonzero, and
    with ``big`` a few levels near +-2**23."""
    rng = np.random.default_rng(seed)

    def leaf(shape):
        shape = lead + shape
        mag = np.ceil(rng.exponential(2.0, shape)).astype(np.int64)
        sign = np.where(rng.random(shape) < 0.5, -1, 1)
        lv = (mag * sign * (rng.random(shape) < density)).astype(np.int32)
        if big and lv.size:
            flat = lv.reshape(-1)
            idx = rng.choice(flat.size, min(3, flat.size), replace=False)
            flat[idx] = rng.choice([2**23, -2**23, 2**23 - 1, 7_000_001],
                                   idx.size)
        return lv

    return {m: {n: leaf(s) for n, s in d.items()} for m, d in shapes.items()}


def _eq_trees(a, b):
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        if isinstance(v, dict):
            _eq_trees(v, b[k])
        else:
            assert np.asarray(v).shape == np.asarray(b[k]).shape, k
            np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]),
                                          err_msg=k)


CASES = [(d, big) for d in DENSITIES for big in (False, True)]


@pytest.mark.parametrize("density,big", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_nnc_encode_bytes_identical(seed, density, big):
    msg = {"p": _levels(SHAPES, seed, density, big=big),
           "s": _levels(SCALE_SHAPES, seed + 50, density)}
    for engine_name in ("vectorized", "serial"):
        assert (nnc.encode_tree(msg, engine_name)
                == ref_nnc.encode_tree(msg, engine_name))
    trees = [msg, {"p": _levels(SHAPES, seed + 9, density, big=big),
                   "s": _levels(SCALE_SHAPES, seed + 59, density)}]
    assert nnc.encode_tree_batch(trees) == ref_nnc.encode_tree_batch(trees)
    assert nnc.encode_tree_batch(trees) == [nnc.encode_tree(t)
                                            for t in trees]


@pytest.mark.parametrize("density,big", CASES)
@pytest.mark.parametrize("engine_name", ENGINES)
def test_nnc_cross_decode(engine_name, density, big):
    msg = {"p": _levels(SHAPES, 3, density, big=big),
           "s": _levels(SCALE_SHAPES, 4, density)}
    data = ref_nnc.encode_tree(msg)
    _eq_trees(msg, nnc.decode_tree(data, nnc.shapes_of(msg), engine_name))
    _eq_trees(msg, ref_nnc.decode_tree(nnc.encode_tree(msg),
                                       ref_nnc.shapes_of(msg), engine_name))
    port_batch = nnc.decode_tree_batch([data, data], nnc.shapes_of(msg),
                                       engine_name)
    for tree in port_batch:
        _eq_trees(msg, tree)


def test_nnc_rejects_truncated_and_mismatched_payloads():
    msg = {"p": _levels(SHAPES, 5, 0.1)}
    data = nnc.encode_tree(msg)
    with pytest.raises(CorruptPayloadError):
        nnc.decode_tree(data[:-3], nnc.shapes_of(msg))
    other = {"p": _levels({"conv0": {"w": (6, 3, 3, 3)}}, 5, 0.1)}
    with pytest.raises(CorruptPayloadError):
        nnc.decode_tree(data, nnc.shapes_of(other))
    with pytest.raises(ValueError, match="structurally identical"):
        nnc.encode_tree_batch([msg, other])


# ---------------------------------------------------------------- codecs

def _update(seed, density, ternary=False, lead=(), big=False):
    """(levels_p, levels_s, recon_p, recon_s) numpy trees, as the graph
    stages make them (recon = levels * step, or mu * sign for ternary)."""
    lv_p = _levels(TERNARY_SHAPES if ternary else SHAPES, seed, density,
                   lead=lead, big=big)
    lv_s = _levels(SCALE_SHAPES, seed + 100, density, lead=lead)
    if ternary:
        lv_p = {m: {n: np.sign(v).astype(np.int32) for n, v in d.items()}
                for m, d in lv_p.items()}
        mu = np.random.default_rng(seed).uniform(1e-4, 1e-2, lead)
        mu = np.asarray(mu, np.float32)
        recon_p = {m: {n: (v.astype(np.float32)
                           * mu.reshape(lead + (1,) * (v.ndim - len(lead))))
                       for n, v in d.items()} for m, d in lv_p.items()}
    else:
        recon_p = {m: {n: v.astype(np.float32) * np.float32(
            2.38e-6 if v.ndim - len(lead) < 2 or "bn" in m else 4.88e-4)
            for n, v in d.items()} for m, d in lv_p.items()}
    recon_s = {m: {n: v.astype(np.float32) * np.float32(2.38e-6)
                   for n, v in d.items()} for m, d in lv_s.items()}
    return lv_p, lv_s, recon_p, recon_s


def _specs(ternary):
    tmpl_p = {m: {n: np.zeros(s, np.float32) for n, s in d.items()}
              for m, d in (TERNARY_SHAPES if ternary else SHAPES).items()}
    tmpl_s = {m: {n: np.zeros(s, np.float32) for n, s in d.items()}
              for m, d in SCALE_SHAPES.items()}
    ref = ref_comms.WireSpec(
        params=ref_comms.shape_template(tmpl_p),
        scales=ref_comms.shape_template(tmpl_s),
        fine_mask=ref_comms.path_fine_mask(jax.tree.map(jnp.asarray,
                                                        tmpl_p)),
        ternary=ternary)
    port_p = convert.to_tensors(tmpl_p)
    port = comms.WireSpec(params=comms.shape_template(port_p),
                          scales=comms.shape_template(
                              convert.to_tensors(tmpl_s)),
                          fine_mask=comms.path_fine_mask(port_p),
                          ternary=ternary)
    return ref, port


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("name", ["golomb", "nnc-cabac"])
def test_level_codec_payloads_identical(name, density, ternary):
    upd = _update(7, density, ternary=ternary, big=not ternary)
    ref_spec, port_spec = _specs(ternary)
    ref_codec, port_codec = ref_comms.get_codec(name), comms.get_codec(name)
    ref_payload = ref_codec.encode(ref_comms.ClientUpdate(*upd), ref_spec)
    port_payload = port_codec.encode(
        comms.ClientUpdate(*(convert.to_tensors(t) for t in upd)), port_spec)
    assert port_payload == ref_payload
    engines = (["vectorized", "speculative"] if name == "golomb"
               else ENGINES)
    ref_dec = ref_codec.decode(ref_payload, ref_spec)
    for engine_name in engines:
        dec = port_codec.with_decode_engine(engine_name).decode(
            ref_payload, port_spec)
        _eq_trees(jax.device_get(ref_dec.params), dec.params)
        _eq_trees(jax.device_get(ref_dec.scales), dec.scales)
    if not ternary:   # lossless: the decode is the encoder's recon
        _eq_trees(upd[2], ref_dec.params)


@pytest.mark.parametrize("name", ["golomb", "nnc-cabac"])
def test_level_codec_batch_calls_equal_per_message(name):
    upds = [_update(s, 0.1) for s in (11, 12, 13)]
    _, spec = _specs(False)
    codec = comms.get_codec(name)
    cupds = [comms.ClientUpdate(*u) for u in upds]
    payloads = codec.encode_batch(cupds, spec, clients=[0, 1, 2])
    assert payloads == [codec.encode(u, spec) for u in cupds]
    for dec, p in zip(codec.decode_batch(payloads, spec), payloads):
        _eq_trees(codec.decode(p, spec).params, dec.params)
    with pytest.raises(ValueError):
        codec.encode_batch(cupds, spec, clients=[0, 0, 1])


def test_auto_codec_is_nnc_cabac():
    assert comms.resolve_codec("auto", quantize=True).name == "nnc-cabac"
    assert comms.resolve_codec("auto", quantize=False).name == "raw-fp32"


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("density", [0.04, 1.0])
def test_encode_client_bytes_equal(density, ternary):
    k = 3
    lv_p, lv_s, _, _ = _update(21, density, ternary=ternary, lead=(k,))
    for i in range(k):
        row_p = jax.tree.map(lambda x: x[i], lv_p)
        row_s = jax.tree.map(lambda x: x[i], lv_s)
        assert engine.encode_client_bytes(
            convert.to_tensors(row_p), convert.to_tensors(row_s),
            ternary) == ref_engine.encode_client_bytes(row_p, row_s, ternary)
    assert engine.measure_update_bytes(
        convert.to_tensors(lv_p), convert.to_tensors(lv_s), k,
        ternary) == ref_engine.measure_update_bytes(lv_p, lv_s, k, ternary)


# ---------------------------------------------------------------- device

def _outputs(upd):
    lv_p, lv_s, recon_p, recon_s = upd
    port = RoundOutput(*(convert.to_tensors(t) for t in upd), None, None, {})
    ref = RefRoundOutput(*(jax.tree.map(jnp.asarray, t) for t in upd),
                         None, None, {})
    return ref, port


@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("name", ["golomb", "nnc-cabac"])
def test_device_cohort_encode_equals_host(name, density, ternary):
    k = 4
    upd = _update(31, density, ternary=ternary, lead=(k,), big=not ternary)
    ref_spec, port_spec = _specs(ternary)
    ref_out, port_out = _outputs(upd)
    codec = comms.get_codec(name)
    before = device.dispatch_count()
    rows = codec.encode_cohort(port_out, port_spec, clients=list(range(k)))
    assert device.dispatch_count() == before + 1
    ref_rows = ref_comms.get_codec(name).encode_cohort(ref_out, ref_spec)
    assert rows == ref_rows
    for i in range(k):
        one = comms.ClientUpdate(*(jax.tree.map(lambda x: x[i], t)
                                   for t in upd))
        assert codec.encode(one, port_spec) == rows[i]


def test_golomb_range_guard_declines_wrapping_levels():
    k = 2
    upd = list(_update(41, 0.1, lead=(k,)))
    upd[0]["fc0"]["w"][1, 0, 0] = 2**30
    ref_spec, port_spec = _specs(False)
    ref_out, port_out = _outputs(upd)
    codec = comms.get_codec("golomb")
    assert codec.encode_cohort(port_out, port_spec) is None
    assert ref_device.golomb_encode_cohort(
        ref_comms.get_codec("golomb"), ref_out, ref_spec) is None
    one = comms.ClientUpdate(*(jax.tree.map(lambda x: x[1], t) for t in upd))
    payload = codec.encode(one, port_spec)   # the host int64 path
    assert codec.decode(payload, port_spec).params["fc0"]["w"][0, 0] == (
        np.float32(2**30) * np.float32(4.88e-4))


def test_device_encode_cabac_scenario_bytes_equal_host_path():
    """Two tiny rounds of ``device_encode_cabac`` and of its host twin
    (``sync_full_fedavg_fsfl``) from one seed: equal bytes each round."""
    from repro_torch.fl import scenarios
    model, splits = scenarios.default_setting(8)
    recs = {}
    for name in ("device_encode_cabac", "sync_full_fedavg_fsfl"):
        before = device.dispatch_count()
        recs[name] = scenarios.run_scenario(
            name, rounds=2, model=model, splits=splits, device="cpu").records
        dispatched = device.dispatch_count() - before
        assert dispatched == (2 if name == "device_encode_cabac" else 0)
    for a, b in zip(recs["device_encode_cabac"],
                    recs["sync_full_fedavg_fsfl"]):
        assert a.up_bytes == b.up_bytes > 0
        assert a.test_acc == b.test_acc
