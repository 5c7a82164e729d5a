"""Wire schema v2 and layer-selective send masks: the port's codecs
against the reference's, byte for byte, and the engine's v2 round.

For the same update (levels and their reconstructions in the tiny scenario
VGG's shapes, and BN statistics) every registered codec, under a v1 spec
with a send mask (the classifier only), a v2 spec, and a v2 spec with the
mask, must give the reference's payload bytes, decode to the reference's
trees (BN bitwise), split into the reference's ``payload_sections``, and
refuse a payload whose header names another schema.  The port's device
cohort encodes frame each row as its per-message encode does.

The reference's int8 codec runs with its eager oracle as the kernel (see
``tests/test_torch_codec.py``), so its bytes are exact.

The engine: ``wire_schema=2`` gives the server the v1 run's BN statistics
bit for bit, and ``up_bytes`` grow by ``1 + 4 * (BN scalars)`` per client;
a codec that poisons the decoded BN section poisons the server's, so the
server reads the payload and nothing beside it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comms as ref_comms
from repro.comms.codecs import Int8BlockScaleCodec as RefInt8
from repro.kernels import ref as ref_oracle
from repro.models import cnn as ref_cnn
from repro_torch import comms, convert
from repro_torch.comms import device
from repro_torch.core.protocol import ProtocolConfig, RoundOutput
from repro_torch.fl import engine, scenarios
from repro_torch.tree import sorted_items


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CODECS = ["raw-fp32", "fp16", "int8-blockscale", "golomb", "nnc-cabac"]
DEVICE_CODECS = ["int8-blockscale", "golomb", "nnc-cabac"]
# (version, classifier-only send mask)
SPECS = {"v1+mask": (1, True), "v2": (2, False), "v2+mask": (2, True)}
STEP, FINE = 4.88e-4, 2.38e-6


def _fc_only(path, leaf):
    return path.startswith("fc")


@pytest.fixture
def eager_ref_int8(monkeypatch):
    monkeypatch.setattr(
        RefInt8, "_kernel",
        lambda self: lambda flat: ref_oracle.delta_compress(
            jnp.asarray(flat), 0.0, self.block))


def _template():
    params, bn = ref_cnn.make_vgg("t", [8, 16, 32], 10, 3, dense_width=16,
                                  pool_after=(0, 1, 2)).init(
        jax.random.PRNGKey(0))
    return jax.device_get(params), jax.device_get(bn)


def _update(seed, k=None):
    """(levels params, levels scales, recon params, recon scales, bn) numpy
    trees, stacked over a leading axis when ``k`` is set; the recon is
    ``levels * step`` (fine step for 1-D leaves)."""
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    tmpl, bn0 = _template()
    lv_p, rc_p, lv_s, rc_s = {}, {}, {}, {}
    for m, d in tmpl.items():
        lv_p[m], rc_p[m], lv_s[m], rc_s[m] = {}, {}, {}, {}
        for n, v in d.items():
            shape = lead + v.shape
            lv = (rng.integers(-9, 10, shape)
                  * (rng.random(shape) < 0.3)).astype(np.int32)
            lv_p[m][n] = lv
            rc_p[m][n] = lv.astype(np.float32) * np.float32(
                FINE if v.ndim < 2 else STEP)
            s_shape = lead + (v.shape[:1] if v.ndim >= 2 else ())
            slv = rng.integers(-5, 6, s_shape).astype(np.int32)
            lv_s[m][n] = slv
            rc_s[m][n] = slv.astype(np.float32) * np.float32(FINE)
    bn = {m: {n: rng.standard_normal(lead + v.shape).astype(np.float32)
              for n, v in d.items()} for m, d in bn0.items()}
    return lv_p, lv_s, rc_p, rc_s, bn


def _specs(upd, version, masked):
    lv_p, lv_s, rc_p, rc_s, bn = upd
    ref = ref_comms.WireSpec(
        params=ref_comms.shape_template(rc_p),
        scales=ref_comms.shape_template(rc_s),
        fine_mask=ref_comms.path_fine_mask(jax.tree.map(jnp.asarray, rc_p)),
        send_mask=(ref_comms.make_send_mask(rc_p, _fc_only) if masked
                   else None),
        bn=ref_comms.shape_template(bn) if version == 2 else None,
        version=version)
    p = convert.to_tensors(rc_p)
    port = comms.WireSpec(
        params=comms.shape_template(p),
        scales=comms.shape_template(convert.to_tensors(rc_s)),
        fine_mask=comms.path_fine_mask(p),
        send_mask=comms.make_send_mask(p, _fc_only) if masked else None,
        bn=(comms.shape_template(convert.to_tensors(bn)) if version == 2
            else None),
        version=version)
    return ref, port


def _flat(tree):
    return {p: np.asarray(v) for p, v in sorted_items(tree)}


def _assert_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        assert v.dtype == fb[k].dtype == np.float32, k
        assert np.array_equal(v.view(np.int32), fb[k].view(np.int32)), k


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("name", CODECS)
def test_payloads_equal_reference(name, spec_name, eager_ref_int8):
    version, masked = SPECS[spec_name]
    upd = _update(3)
    ref_spec, port_spec = _specs(upd, version, masked)
    ref_codec, codec = ref_comms.get_codec(name), comms.get_codec(name)
    ref_payload = ref_codec.encode(ref_comms.ClientUpdate(*upd), ref_spec)
    payload = codec.encode(comms.ClientUpdate(
        *(convert.to_tensors(t) for t in upd)), port_spec)
    assert payload == ref_payload
    if masked:
        assert sorted(port_spec.sent_paths) == sorted(
            p for p, _ in port_spec.param_items()) == [
            "fc0/b", "fc0/w", "fc1/b", "fc1/w"]
    assert codec.payload_sections(payload, port_spec) == \
        ref_codec.payload_sections(ref_payload, ref_spec)
    assert sum(codec.payload_sections(payload, port_spec).values()) == \
        len(payload)

    ref_dec = jax.device_get(ref_codec.decode(ref_payload, ref_spec))
    for dec in (codec.decode(payload, port_spec),
                codec.decode_batch([payload], port_spec, clients=[5])[0]):
        _assert_bitwise(dec.params, ref_dec.params)
        _assert_bitwise(dec.scales, ref_dec.scales)
        if version == 1:
            assert dec.bn is None and ref_dec.bn is None
        else:
            _assert_bitwise(dec.bn, ref_dec.bn)
            _assert_bitwise(dec.bn, upd[4])
        if masked:   # unsent leaves decode to zeros
            for path, v in _flat(dec.params).items():
                if not path.startswith("fc"):
                    assert not v.any(), path


@pytest.mark.parametrize("name", CODECS)
def test_header_mismatch_raises(name):
    upd = _update(4)
    ref_spec, port_spec = _specs(upd, 2, False)
    codec = comms.get_codec(name)
    payload = codec.encode(comms.ClientUpdate(*upd), port_spec)
    assert payload[0] == 2
    bad = b"\x07" + payload[1:]
    for c, spec in ((codec, port_spec),
                    (ref_comms.get_codec(name), ref_spec)):
        with pytest.raises(ValueError, match="schema mismatch"):
            c.decode(bad, spec)
        with pytest.raises(ValueError, match="schema mismatch"):
            c.decode_batch([bad], spec)
        with pytest.raises(ValueError, match="schema mismatch"):
            c.decode(b"", spec)


@pytest.mark.parametrize("name", CODECS)
def test_v2_is_v1_plus_header_and_bn_tail(name):
    upd = _update(5)
    _, v2 = _specs(upd, 2, True)
    v1 = dataclasses.replace(v2, bn=None, version=1)
    codec = comms.get_codec(name)
    p1 = codec.encode(comms.ClientUpdate(*upd), v1)
    p2 = codec.encode(comms.ClientUpdate(*upd), v2)
    bn_scalars = sum(v.size for _, v in sorted_items(upd[4]))
    assert v2.bn_nbytes == 4 * bn_scalars
    assert p2 == bytes([2]) + p1 + b"".join(
        v.astype("<f4").tobytes() for _, v in sorted_items(upd[4]))


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("name", DEVICE_CODECS)
def test_cohort_encode_rows_equal_per_message(name, spec_name):
    version, masked = SPECS[spec_name]
    k = 3
    stacked = _update(6, k=k)
    row0 = jax.tree.map(lambda x: x[0], stacked)
    _, spec = _specs(row0, version, masked)
    t = [convert.to_tensors(tree) for tree in stacked]
    out = RoundOutput(t[0], t[1], t[2], t[3], t[4], None, {})
    codec = comms.get_codec(name)
    before = device.dispatch_count()
    rows = codec.encode_cohort(out, spec, clients=[4, 0, 7])
    assert rows is not None and len(rows) == k
    assert device.dispatch_count() == before + 1
    for i in range(k):
        upd = comms.ClientUpdate(*jax.tree.map(lambda x: x[i], stacked))
        assert rows[i] == codec.encode(upd, spec), i


def test_bn_rows_come_in_one_copy(monkeypatch):
    stacked = _update(7, k=2)
    _, spec = _specs(jax.tree.map(lambda x: x[0], stacked), 2, False)
    bn = convert.to_tensors(stacked[4])
    copies = []
    cpu = torch.Tensor.cpu

    def counted(self, *a, **kw):
        copies.append(tuple(self.shape))
        return cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    rows = device.bn_rows(bn, spec, 2)
    assert copies == [(2, spec.bn_nbytes // 4)]
    for i in range(2):
        assert rows[i].astype("<f4").tobytes() == b"".join(
            v[i].astype("<f4").tobytes() for _, v in sorted_items(stacked[4]))
    assert device.bn_rows(bn, dataclasses.replace(spec, bn=None, version=1),
                          2) is None


# ---------------------------------------------------------------- engine

def _tiny():
    model, splits = scenarios.default_setting(2, n_samples=480)
    cfg = ProtocolConfig(name="fsfl", method="sparse", fixed_sparsity=0.9,
                         batch_size=32, local_lr=2e-3)
    return model, splits, cfg


def _run(codec="auto", schema=1, **kw):
    model, splits, cfg = _tiny()
    return engine.run_simulation(
        model, cfg, splits, 1, seed=7,
        engine=engine.EngineConfig(codec=codec, wire_schema=schema, **kw),
        device="cpu")


@pytest.mark.parametrize("codec,device_encode", [
    ("auto", False), ("int8-blockscale", True)])
def test_engine_v2_bn_equals_v1_and_bytes_grow_by_the_tail(codec,
                                                           device_encode):
    v1 = _run(codec, 1, device_encode=device_encode)
    v2 = _run(codec, 2, device_encode=device_encode)
    _assert_bitwise(convert.to_numpy(v2.server.bn_state),
                    convert.to_numpy(v1.server.bn_state))
    bn_scalars = sum(v.numel() for _, v in sorted_items(v1.server.bn_state))
    assert v2.records[0].up_bytes == v1.records[0].up_bytes + 2 * (
        1 + 4 * bn_scalars)


def test_engine_aggregates_bn_from_decoded_wire_only():
    class PoisonBn(comms.Codec):
        """nnc-cabac whose decoded BN section is zeroed."""
        name = "poison-bn"
        needs = ("levels",)

        def __init__(self):
            self.inner = comms.get_codec("nnc-cabac")

        def _encode_body(self, upd, spec):
            return self.inner._encode_body(upd, spec)

        def _decode_body(self, payload, spec):
            return self.inner._decode_body(payload, spec)

        def decode(self, payload, spec):
            dec = super().decode(payload, spec)
            return dec._replace(bn={m: {n: np.zeros_like(v)
                                        for n, v in d.items()}
                                    for m, d in dec.bn.items()})

    honest = _run("auto", 2)
    poisoned = _run(PoisonBn(), 2)
    for _, leaf in sorted_items(poisoned.server.bn_state):
        assert not leaf.any()
    assert any(leaf.any() for _, leaf in sorted_items(honest.server.bn_state))
    assert poisoned.records[0].up_bytes == honest.records[0].up_bytes
