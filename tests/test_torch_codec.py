"""The port's wire codecs against the reference's, byte for byte.

For the same reconstruction update (a numpy-seeded tree in the tiny
scenario VGG's shapes) the raw-fp32, fp16 and int8-blockscale payloads of
both packages must be byte-equal and decode equally, and the port's cohort
encode (``int8_encode_cohort``) row i must be byte-equal to its per-client
``encode``.

The reference's int8 codec quantizes through its Pallas kernel, which on
the CPU runs in interpret mode, where ``amax / 127`` may come out one ulp
off the correctly rounded quotient (kernels/README.md).  The port divides
exactly, like the reference's eager oracle.  So the byte-equality tests
run the reference codec with ``repro.kernels.ref.delta_compress`` as its
kernel, and against the interpret-mode codec the int8 levels and the
scales section are held bitwise and the block scales to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comms as ref_comms
from repro.comms import device as ref_device
from repro.comms.codecs import Int8BlockScaleCodec as RefInt8
from repro.core.protocol import RoundOutput as RefRoundOutput
from repro.kernels import ref as ref_oracle
from repro.models import cnn as ref_cnn
from repro_torch import comms, convert
from repro_torch.comms import device
from repro_torch.core.protocol import RoundOutput
from repro_torch.kernels import delta_compress as dc
from repro_torch.models import cnn
from repro_torch.tree import sorted_items

CODECS = ["raw-fp32", "fp16", "int8-blockscale"]


def _model(m):
    return m.make_vgg("t", [8, 16, 32], 10, 3, dense_width=16,
                      pool_after=(0, 1, 2))


def _template():
    params, _ = _model(ref_cnn).init(jax.random.PRNGKey(0))
    return jax.device_get(params)


def _update(seed, k=None):
    """(params recon, scales recon) numpy trees; stacked when k is set."""
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    tmpl = _template()
    params = {m: {n: (1e-3 * rng.standard_normal(lead + v.shape)
                      * (rng.random(lead + v.shape) < 0.2)).astype(np.float32)
                  for n, v in d.items()} for m, d in tmpl.items()}
    scales = {m: {n: ((1e-5 * rng.standard_normal(lead + v.shape[:1]))
                      if v.ndim >= 2 else np.zeros(lead, np.float32)
                      ).astype(np.float32)
                  for n, v in d.items()} for m, d in tmpl.items()}
    return params, scales


def _specs(params, scales):
    ref = ref_comms.WireSpec(
        params=ref_comms.shape_template(params),
        scales=ref_comms.shape_template(scales),
        fine_mask=ref_comms.path_fine_mask(jax.tree.map(jnp.asarray, params)))
    port_p = convert.to_tensors(params)
    port = comms.WireSpec(params=comms.shape_template(port_p),
                          scales=comms.shape_template(
                              convert.to_tensors(scales)),
                          fine_mask=comms.path_fine_mask(port_p))
    return ref, port


@pytest.fixture
def eager_ref_int8(monkeypatch):
    """The reference int8 codec with its eager-jnp oracle as the kernel."""
    monkeypatch.setattr(
        RefInt8, "_kernel",
        lambda self: lambda flat: ref_oracle.delta_compress(
            jnp.asarray(flat), 0.0, self.block))


def _int8_sections(payload, spec):
    """-> (int8 level bytes, block scales, scales-section bytes)."""
    q, bs, off = [], [], 0
    for _, s in spec.param_items():
        n = int(np.prod(s.shape)) if s.shape else 1
        padded = n + (-n) % 128
        q.append(payload[off:off + padded])
        off += padded
        bs.append(np.frombuffer(payload, "<f4", padded // 128, off))
        off += 4 * (padded // 128)
    return b"".join(q), np.concatenate(bs), payload[off:]


def _assert_int8_close(port_payload, ref_payload, spec):
    assert len(port_payload) == len(ref_payload)
    pq, pbs, ps = _int8_sections(port_payload, spec)
    rq, rbs, rs = _int8_sections(ref_payload, spec)
    assert pq == rq and ps == rs
    np.testing.assert_allclose(pbs, rbs, rtol=1e-6)


def _assert_trees_equal(a, b):
    for k, v in a.items():
        if isinstance(v, dict):
            _assert_trees_equal(v, b[k])
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CODECS)
def test_payload_bytes_equal_and_decode_agrees(name, seed, eager_ref_int8):
    params, scales = _update(seed)
    ref_spec, port_spec = _specs(params, scales)
    ref_codec, port_codec = ref_comms.get_codec(name), comms.get_codec(name)
    ref_payload = ref_codec.encode(
        ref_comms.ClientUpdate(None, None, params, scales), ref_spec)
    port_payload = port_codec.encode(
        comms.ClientUpdate(None, None, convert.to_tensors(params),
                           convert.to_tensors(scales)), port_spec)
    assert port_payload == ref_payload
    # numpy leaves take the same path
    assert port_codec.encode(comms.ClientUpdate(None, None, params, scales),
                             port_spec) == ref_payload
    ref_dec = ref_codec.decode(ref_payload, ref_spec)
    port_dec = port_codec.decode(port_payload, port_spec)
    _assert_trees_equal(jax.device_get(ref_dec.params), port_dec.params)
    _assert_trees_equal(jax.device_get(ref_dec.scales), port_dec.scales)


def _round_output(params, scales, k):
    p, s = convert.to_tensors(params), convert.to_tensors(scales)
    zeros = jax.tree.map(lambda x: np.zeros(x.shape, np.int32), params)
    port = RoundOutput(None, None, p, s, None, None, {})
    ref = RefRoundOutput(zeros, None, jax.tree.map(jnp.asarray, params),
                         jax.tree.map(jnp.asarray, scales), None, None, {})
    return ref, port


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_vs_interpret_mode_reference(seed):
    params, scales = _update(seed)
    ref_spec, port_spec = _specs(params, scales)
    ref_payload = ref_comms.get_codec("int8-blockscale").encode(
        ref_comms.ClientUpdate(None, None, params, scales), ref_spec)
    port_payload = comms.get_codec("int8-blockscale").encode(
        comms.ClientUpdate(None, None, params, scales), port_spec)
    _assert_int8_close(port_payload, ref_payload, port_spec)


@pytest.mark.parametrize("k", [1, 4])
def test_cohort_encode_rows_equal_per_client_and_reference(k,
                                                           eager_ref_int8):
    params, scales = _update(5, k=k)
    ref_spec, port_spec = _specs(jax.tree.map(lambda x: x[0], params),
                                 jax.tree.map(lambda x: x[0], scales))
    ref_out, port_out = _round_output(params, scales, k)
    codec = comms.get_codec("int8-blockscale")
    dc.reset_counters()
    before = device.dispatch_count()
    rows = codec.encode_cohort(port_out, port_spec, clients=list(range(k)))
    assert device.dispatch_count() == before + 1
    assert dc.CALLS == {"delta_compress": 0, "delta_compress_batch": 1}
    ref_codec = ref_comms.get_codec("int8-blockscale")
    ref_rows = ref_device.int8_encode_cohort(ref_codec, ref_out, ref_spec)
    for i in range(k):
        params_i = jax.tree.map(lambda x: x[i], params)
        scales_i = jax.tree.map(lambda x: x[i], scales)
        assert codec.encode(comms.ClientUpdate(None, None, params_i,
                                               scales_i), port_spec) == rows[i]
        assert ref_codec.encode(ref_comms.ClientUpdate(
            None, None, params_i, scales_i), ref_spec) == rows[i]
        _assert_int8_close(rows[i], ref_rows[i], port_spec)
    assert dc.CALLS["delta_compress"] == k


def test_cohort_encode_rejects_duplicate_clients():
    params, scales = _update(6, k=2)
    _, port_spec = _specs(jax.tree.map(lambda x: x[0], params),
                          jax.tree.map(lambda x: x[0], scales))
    _, port_out = _round_output(params, scales, 2)
    with pytest.raises(ValueError):
        comms.get_codec("int8-blockscale").encode_cohort(
            port_out, port_spec, clients=[3, 3])


def test_vgg11_int8_payload_size():
    """One v1 int8 payload of the paper's VGG11: 850,304 padded int8
    levels, 6,643 block scales and 1,020 scale floats."""
    params, _ = cnn.vgg11_thinned().init(torch.Generator().manual_seed(0))
    recon = {m: {n: torch.zeros_like(v) for n, v in d.items()}
             for m, d in params.items()}
    scales = {m: {n: torch.zeros(v.shape[:1] if v.ndim >= 2 else ())
                  for n, v in d.items()} for m, d in params.items()}
    spec = comms.WireSpec(params=comms.shape_template(recon),
                          scales=comms.shape_template(scales))
    payload = comms.get_codec("int8-blockscale").encode(
        comms.ClientUpdate(None, None, recon, scales), spec)
    assert len(payload) == 850_304 + 4 * 6_643 + 4 * 1_020 == 880_956


@pytest.mark.parametrize("name", ["golomb", "nnc-cabac", "auto"])
def test_unported_codecs_raise(name):
    """The level codecs are ported (``"auto"`` is nnc-cabac); the part of
    them still queued, the schema-v2 frame with BN on the wire, raises."""
    codec = comms.resolve_codec(name, quantize=True)
    assert codec.name == ("nnc-cabac" if name == "auto" else name)
    template = comms.shape_template(convert.to_tensors(_template()))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        comms.WireSpec(params=template, bn=template, version=2)


# ------------------------------------------- the grouped encode's plain body

# params leaf shapes: n mod 4 in {0, 1, 2, 3}, n < 128, n a multiple of 128
RAGGED = {"a": (8,), "b": (3, 43), "c": (130,), "d": (131,), "e": (5,),
          "f": (2, 128), "g": (3, 128), "h": (1,)}


def _tree_update(shapes, seed, k=None, scales=True):
    """(params, scales or None) numpy trees of one module ``m``: sparse
    deltas, a few exact zeros, and per weight its scale vector."""
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    params = {"m": {n: (1e-3 * rng.standard_normal(lead + s)
                        * (rng.random(lead + s) < 0.3)).astype(np.float32)
                    for n, s in shapes.items()}}
    if not scales:
        return params, None
    return params, {"m": {n: (1e-5 * rng.standard_normal(
        lead + (s[:1] if len(s) >= 2 else ()))).astype(np.float32)
        for n, s in shapes.items()}}


def _vgg11_shapes():
    params, _ = cnn.vgg11_thinned().init(torch.Generator().manual_seed(0))
    return {f"{m}.{n}": tuple(v.shape) for m, d in params.items()
            for n, v in d.items()}


def _stacked_leaves(tree, lead):
    """The port's leaves of a numpy tree in wire order, each (K, ...)."""
    if tree is None:
        return []
    return [torch.from_numpy(np.ascontiguousarray(leaf)).reshape(
        (1,) + leaf.shape) if lead else torch.from_numpy(leaf)
        for _, leaf in sorted_items(tree)]


@pytest.mark.parametrize("case", ["vgg11_thinned", "ragged",
                                  "ragged_no_scales"])
def test_plain_int8_body_equals_reference_codec(case, eager_ref_int8):
    shapes = _vgg11_shapes() if case == "vgg11_thinned" else RAGGED
    params, scales = _tree_update(shapes, 11,
                                  scales=case != "ragged_no_scales")
    spec = ref_comms.WireSpec(
        params=ref_comms.shape_template(params),
        scales=None if scales is None else ref_comms.shape_template(scales))
    ref_body = RefInt8()._encode_body(
        ref_comms.ClientUpdate(None, None, params, scales), spec)
    p = _stacked_leaves(params, lead=True)
    s = _stacked_leaves(scales, lead=True)
    body = dc.int8_encode_leaves_plain(p, s, 0.0, 128)
    assert body.dtype == torch.uint8 and body.shape == (1, len(ref_body))
    assert body[0].numpy().tobytes() == ref_body
    dc.reset_counters()
    assert torch.equal(dc.int8_encode_leaves(p, s, 0.0, 128, batched=False),
                       body)
    assert dc.CALLS == {"delta_compress": 1, "delta_compress_batch": 0}
    if case == "vgg11_thinned":
        assert len(ref_body) == 880_956
        # the wrapper's layout is the body's
        q_offs, s_offs, length = dc.body_layout(
            [x[0].numel() for x in p], [x[0].numel() for x in s], 128)
        assert length == len(ref_body) and q_offs[0] == 0
        assert q_offs[len(p)] == 876_876


@pytest.mark.parametrize("scales", [True, False])
def test_plain_int8_cohort_rows_equal_bodies_and_reference(scales,
                                                           eager_ref_int8):
    k = 3
    params, scale_tree = _tree_update(RAGGED, 12, k=k, scales=scales)
    p = _stacked_leaves(params, lead=False)
    s = _stacked_leaves(scale_tree, lead=False)
    rows = dc.int8_encode_leaves_plain(p, s, 0.0, 128)
    for i in range(k):
        single = dc.int8_encode_leaves_plain([x[i][None] for x in p],
                                             [x[i][None] for x in s], 0.0, 128)
        assert torch.equal(single[0], rows[i])
    # the live reference's cohort encode (Pallas interpret mode)
    ref_p = jax.tree.map(lambda x: x[0], params)
    ref_s = (None if scale_tree is None
             else jax.tree.map(lambda x: x[0], scale_tree))
    ref_spec = ref_comms.WireSpec(
        params=ref_comms.shape_template(ref_p),
        scales=None if ref_s is None else ref_comms.shape_template(ref_s))
    port_spec = comms.WireSpec(
        params=comms.shape_template(convert.to_tensors(ref_p)),
        scales=(None if ref_s is None
                else comms.shape_template(convert.to_tensors(ref_s))))
    zeros = jax.tree.map(lambda x: np.zeros(x.shape, np.int32), params)
    ref_out = RefRoundOutput(
        zeros, None, jax.tree.map(jnp.asarray, params),
        None if scale_tree is None else jax.tree.map(jnp.asarray, scale_tree),
        None, None, {})
    ref_rows = ref_device.int8_encode_cohort(RefInt8(), ref_out, ref_spec)
    for i in range(k):
        _assert_int8_close(rows[i].numpy().tobytes(), ref_rows[i], port_spec)
