"""The port's ``delta_apply`` kernel against the reference.

On the CPU the wrapper takes its plain PyTorch version, which must be
BITWISE equal to the reference's eager-jnp oracle
``repro.kernels.ref.delta_apply`` and to the Pallas kernel
``repro.kernels.ops.delta_apply`` run in interpret mode, for ragged ``n``
and ``coef`` in {+1, -1, 0.5}.  For those coefficients ``coef * (q * s)``
is exact, so a contraction of ``w + coef * deq`` into an FMA could not
move a bit either.  The reference oracle reshapes to whole blocks, so it
gets zero-padded ``w`` and ``q`` and its result is cut to ``n``.

On the ``int8-blockscale`` payload layout (every leaf padded to 128, its
int8 levels then its float32 block scales), the codec's device sections
applied with ``coef = +1`` give ``w + decode(payload)`` and with
``coef = -1`` give ``carried - decode(payload)``, bit for bit.

The grouped entry ``delta_apply_leaves`` takes a list of leaves of any
shapes (the 28 ``vgg11_thinned`` leaves, or ragged ones), each with its
own levels and scales: its plain version is ``delta_apply_plain`` per
leaf, bitwise equal to the reference's oracle and Pallas kernel per leaf
for coef +1 and -1; on the codec's device sections of a real payload
(levels padded to the block) it gives the host decode plus add.  The
launch tables (``kernels.grouped``) keep every leaf 16-byte aligned in
the flat output and split more than 64 leaves over launches.

The ``gpu`` tests hold the CUDA kernel bitwise to the plain version on the
card, with levels at every offset mod 16 and values that are views into
one flat buffer, and count one launch per call and per broadcast apply;
they skip where no CUDA device is visible.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch import comms
from repro_torch.fl import rounds
from repro_torch.kernels import delta_apply as da
from repro_torch.kernels import grouped, ops, ref

NS = [1, 5, 127, 128, 129, 1000, 1031]
# the 28 leaves of vgg11_thinned (849,834 elements) and ragged leaves
LEAF_SETS = {
    "vgg11_thinned": [(32,), (32,), (64,), (64,)] + [(128,)] * 12 + [
        (32, 3, 3, 3), (64, 32, 3, 3), (128, 64, 3, 3)] + [
        (128, 128, 3, 3)] * 5 + [(128,), (128, 128), (10,), (10, 128)],
    "ragged": [(1,), (5,), (0,), (127,), (3, 43), (1031,), (2, 2, 2)]}
BLOCKS = [128, 1024]
COEFS = [1.0, -1.0, 0.5]


def _inputs(n, block, seed=0):
    """w float32 (n,), q int8 (n,) over the full range, scales (nblk,)
    float32 like ``amax / 127`` of small updates."""
    rng = np.random.default_rng(seed + 31 * n + block)
    w = (0.1 * rng.standard_normal(n)).astype(np.float32)
    q = rng.integers(-127, 128, n).astype(np.int8)
    nblk = -(-n // block)
    s = (1e-3 * rng.random(nblk) + 1e-6).astype(np.float32)
    if n > 3:
        q[:3] = 0                # zero levels: w must come back as it is
        w[3] = q[3] * s[0]       # w + (-1) q s cancels to +0
    return w, q, s


def _bits(x):
    return np.asarray(x).view(np.int32)


def _oracle(w, q, s, block, coef):
    pad = (-len(w)) % block
    out = ref_oracle.delta_apply(jnp.asarray(np.pad(w, (0, pad))),
                                 jnp.asarray(np.pad(q, (0, pad))),
                                 jnp.asarray(s), block, coef)
    return np.asarray(out)[:len(w)]


@pytest.mark.parametrize("coef", COEFS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", NS)
def test_plain_bitwise_vs_reference_oracle(n, block, coef):
    w, q, s = _inputs(n, block)
    da.reset_counters()
    out = ops.delta_apply(torch.from_numpy(w), torch.from_numpy(q),
                          torch.from_numpy(s), coef, block=block)
    assert da.CALLS["delta_apply"] == 1 and da.LAUNCHES["delta_apply"] == 0
    assert out.dtype == torch.float32 and out.shape == (n,)
    np.testing.assert_array_equal(_bits(_oracle(w, q, s, block, coef)),
                                  _bits(out.numpy()))


@pytest.mark.parametrize("coef", COEFS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", [5, 129, 1031])
def test_plain_bitwise_vs_pallas_interpret(n, block, coef):
    w, q, s = _inputs(n, block, seed=1)
    want = ref_ops.delta_apply(jnp.asarray(w), jnp.asarray(q),
                               jnp.asarray(s), coef, block=block)
    got = da.delta_apply(torch.from_numpy(w), torch.from_numpy(q),
                         torch.from_numpy(s), coef, block=block)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


def test_minus_one_is_the_exact_difference():
    """coef = -1 gives ``w - q * s`` as one rounded subtraction, with the
    sign of zero of IEEE ``a - b`` (``x - x`` is +0)."""
    w, q, s = _inputs(1000, 128, seed=2)
    deq = (q.astype(np.float32).reshape(-1) * np.repeat(s, 128)[:1000])
    got = da.delta_apply(torch.from_numpy(w), torch.from_numpy(q),
                         torch.from_numpy(s), -1.0).numpy()
    np.testing.assert_array_equal(_bits(w - deq), _bits(got))
    assert _bits(got)[3] == 0    # +0, not -0


def _tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"conv0": {"w": (8, 3, 3, 3), "b": (8,)},
              "bn0": {"gamma": (8,)}, "fc0": {"w": (10, 16), "b": (10,)}}
    return {m: {k: torch.tensor((1e-3 * rng.standard_normal(sh))
                                .astype(np.float32))
                for k, sh in d.items()} for m, d in shapes.items()}


def test_codec_sections_apply_equals_host_decode_plus_add():
    codec = comms.get_codec("int8-blockscale")
    recon, w, carried = _tree(0), _tree(1), _tree(2)
    spec = comms.WireSpec(params=comms.shape_template(recon))
    payload = codec.encode(comms.ClientUpdate(None, None, recon, None), spec)
    assert len(payload) == sum(-(-v.numel() // 128) * (128 + 4)
                               for d in recon.values() for v in d.values())
    decoded = codec.decode(payload, spec).params
    sections = codec.device_sections(payload, spec, "cpu")
    da.reset_counters()
    for m, d in w.items():
        for k, v in d.items():
            q, sc = sections[f"{m}/{k}"]
            assert q.dtype == torch.int8 and q.numel() % 128 == 0
            assert sc.dtype == torch.float32 and sc.numel() == q.numel() // 128
            deq = (q.float().reshape(-1, 128) * sc[:, None]).reshape(-1)
            np.testing.assert_array_equal(
                _bits(deq[:v.numel()].reshape(v.shape).numpy()),
                _bits(decoded[m][k]))
            applied = rounds.apply_int8(v, q, sc, 1.0, 128)
            np.testing.assert_array_equal(
                _bits(applied.numpy()), _bits(v.numpy() + decoded[m][k]))
            resid = rounds.apply_int8(carried[m][k], q, sc, -1.0, 128)
            np.testing.assert_array_equal(
                _bits(resid.numpy()),
                _bits(carried[m][k].numpy() - decoded[m][k]))
    assert da.CALLS["delta_apply"] == 2 * 5


def test_codec_sections_reject_a_short_payload():
    codec = comms.get_codec("int8-blockscale")
    recon = _tree(0)
    spec = comms.WireSpec(params=comms.shape_template(recon))
    payload = codec.encode(comms.ClientUpdate(None, None, recon, None), spec)
    with pytest.raises(ValueError, match="ends inside leaf"):
        codec.device_sections(payload[:-1], spec, "cpu")


def test_empty_and_ref_module():
    e = torch.zeros(0)
    out = da.delta_apply(e, torch.zeros(0, dtype=torch.int8),
                         torch.zeros(0), 1.0)
    assert out.shape == (0,)
    w, q, s = _inputs(300, 128)
    a = ref.delta_apply(torch.from_numpy(w), torch.from_numpy(q),
                        torch.from_numpy(s), 128, -1.0)
    b = da.delta_apply_plain(torch.from_numpy(w), torch.from_numpy(q),
                             torch.from_numpy(s), -1.0, 128)
    assert torch.equal(a, b)


def test_wrapper_rejects_bad_inputs():
    w, q, s = (torch.from_numpy(x) for x in _inputs(300, 128))
    with pytest.raises(ValueError):
        da.delta_apply(w[None], q[None], s)
    with pytest.raises(ValueError):
        da.delta_apply(w, q[:-1], s)
    with pytest.raises(ValueError):
        da.delta_apply(w, q, s[:-1])
    with pytest.raises(TypeError):
        da.delta_apply(w.double(), q, s)
    with pytest.raises(TypeError):
        da.delta_apply(w, q.to(torch.int32), s)
    with pytest.raises(ValueError):
        da.delta_apply(w.to("meta"), q.to("meta"), s.to("meta"))



# ---------------------------------------------------------------- grouped

def _leaves(name, seed, padded=False):
    """Per leaf: w (its shape), q (flat; padded to 128 with zeros like the
    wire's sections if ``padded``), scales (block 128)."""
    out = []
    for i, shape in enumerate(LEAF_SETS[name]):
        n = int(np.prod(shape))
        w, q, s = _inputs(n, 128, seed + 7 * i)
        if padded:
            q = np.pad(q, (0, (-n) % 128))
        out.append((w.reshape(shape), q, s))
    return out


def test_vgg_leaf_set_is_the_main_path_model():
    assert len(LEAF_SETS["vgg11_thinned"]) == 28
    assert sum(int(np.prod(s)) for s in LEAF_SETS["vgg11_thinned"]) == (
        849_834)


@pytest.mark.parametrize("coef", [1.0, -1.0])
@pytest.mark.parametrize("name", LEAF_SETS)
def test_leaves_plain_bitwise_vs_reference_per_leaf(name, coef):
    leaves = _leaves(name, seed=3, padded=name == "ragged")
    da.reset_counters()
    got = da.delta_apply_leaves(*[[torch.from_numpy(x[i]) for x in leaves]
                                  for i in range(3)], coef)
    assert da.CALLS["delta_apply"] == len(leaves)
    assert da.LAUNCHES["delta_apply"] == 0
    for (w, q, s), g in zip(leaves, got):
        assert g.shape == w.shape and g.dtype == torch.float32
        n = w.size
        want = _oracle(w.reshape(-1), q[:n], s, 128, coef)
        np.testing.assert_array_equal(_bits(want),
                                      _bits(g.numpy().reshape(-1)))
        if name == "ragged" and n:
            pallas = ref_ops.delta_apply(
                jnp.asarray(w.reshape(-1)), jnp.asarray(q[:n]),
                jnp.asarray(s), coef, block=128)
            np.testing.assert_array_equal(_bits(pallas),
                                          _bits(g.numpy().reshape(-1)))


def test_leaves_on_a_payloads_sections_equal_host_decode_plus_add():
    """One grouped call over the codec's device sections (each leaf's
    levels padded to the block, views into one copy of the payload), for
    the server's apply (+1) and the downlink's residual (-1)."""
    codec = comms.get_codec("int8-blockscale")
    recon, w, carried = _tree(3), _tree(4), _tree(5)
    spec = comms.WireSpec(params=comms.shape_template(recon))
    payload = codec.encode(comms.ClientUpdate(None, None, recon, None), spec)
    decoded = codec.decode(payload, spec).params
    sections = codec.device_sections(payload, spec, "cpu")
    paths = sorted(sections)
    for coef, base in ((1.0, w), (-1.0, carried)):
        flat = {f"{m}/{k}": v for m, d in base.items() for k, v in d.items()}
        da.reset_counters()
        got = da.delta_apply_leaves([flat[p] for p in paths],
                                    [sections[p][0] for p in paths],
                                    [sections[p][1] for p in paths], coef)
        assert da.CALLS["delta_apply"] == len(paths)
        tree = rounds.apply_int8_tree(base, sections, coef, 128)
        for p, g in zip(paths, got):
            m, k = p.split("/")
            want = flat[p].numpy() + coef * decoded[m][k]
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(want))
            np.testing.assert_array_equal(_bits(tree[m][k].numpy()),
                                          _bits(want))


@pytest.mark.parametrize("chunk", [8, 1024])
def test_grouped_tables(chunk):
    sizes = [0, 1, 5, 1024, 1025, 3, 147_456] * 10 + [7]
    table = grouped.chunk_table(sizes, chunk)
    assert len(sizes) > grouped.MAX_LEAVES
    assert [(lo, hi) for lo, hi, _ in table] == [(0, 64), (64, 71)]
    for lo, hi, starts in table:
        assert starts[0] == 0 and len(starts) == hi - lo + 1
        assert [b - a for a, b in zip(starts, starts[1:])] == [
            -(-n // chunk) for n in sizes[lo:hi]]
    offsets, total = grouped.leaf_offsets(sizes)
    assert all(o % 4 == 0 for o in offsets)
    assert all(o + n <= nxt for o, n, nxt in zip(offsets, sizes,
                                                  offsets[1:] + [total]))
    assert total == sum(-(-n // 4) * 4 for n in sizes)
    flat = torch.arange(total, dtype=torch.float32)
    shapes = [torch.empty((n,)) for n in sizes]
    for o, v, n in zip(offsets, grouped.views(flat, offsets, shapes), sizes):
        assert v.shape == (n,) and v.is_contiguous()
        assert n == 0 or v[0] == o


def test_leaves_wrapper_rejects_bad_inputs():
    (w, q, s), (w2, q2, s2) = [
        tuple(torch.from_numpy(x) for x in leaf)
        for leaf in _leaves("ragged", seed=4)[4:6]]
    good = ([w, w2], [q, q2], [s, s2])
    assert len(da.delta_apply_leaves(*good)) == 2
    assert da.delta_apply_leaves([], [], []) == []
    with pytest.raises(ValueError, match="one device"):
        da.delta_apply_leaves([w, w2.to("meta")], [q, q2], [s, s2])
    with pytest.raises(ValueError, match="one device"):
        da.delta_apply_leaves([w, w2], [q, q2], [s, s2.to("meta")])
    with pytest.raises(TypeError):
        da.delta_apply_leaves([w, w2.double()], [q, q2], [s, s2])
    with pytest.raises(TypeError):
        da.delta_apply_leaves([w, w2], [q, q2.to(torch.int32)], [s, s2])
    with pytest.raises(TypeError):
        da.delta_apply_leaves([w, w2], [q, q2], [s, s2.half()])
    with pytest.raises(ValueError, match="levels"):
        da.delta_apply_leaves([w, w2], [q, q2[:-1]], [s, s2])
    with pytest.raises(ValueError, match="levels"):
        da.delta_apply_leaves([w, w2], [q, q2.reshape(1, -1)], [s, s2])
    with pytest.raises(ValueError, match="scales"):
        da.delta_apply_leaves([w, w2], [q, q2], [s, s2[:-1]])
    with pytest.raises(ValueError, match="as many"):
        da.delta_apply_leaves([w, w2], [q], [s, s2])
    with pytest.raises(ValueError, match="block"):
        da.delta_apply_leaves(*good, block=0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        da.delta_apply_leaves([w.to("meta")], [q.to("meta")],
                              [s.to("meta")])


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("coef", COEFS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", NS + [849_834])
def test_cuda_kernel_bitwise_vs_plain(cuda, n, block, coef):
    w, q, s = (torch.from_numpy(x).to(cuda) for x in _inputs(n, block))
    da.reset_counters()
    out = da.delta_apply(w, q, s, coef, block=block)
    assert da.LAUNCHES["delta_apply"] == 1
    want = da.delta_apply_plain(w, q, s, coef, block)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_cuda_kernel_unaligned_views(cuda):
    """Views that start off a 16-byte boundary take the scalar pass."""
    w, q, s = (torch.from_numpy(x).to(cuda) for x in _inputs(4097, 128))
    for lo in (1, 2, 3):
        n = 4097 - lo
        ws, qs = w[lo:], q[:n]
        ss = s[:-(-n // 128)]
        out = da.delta_apply(ws, qs, ss, -1.0)
        want = da.delta_apply_plain(ws, qs, ss, -1.0, 128)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("coef", [1.0, -1.0])
@pytest.mark.parametrize("name", LEAF_SETS)
def test_cuda_leaves_one_launch_bitwise_vs_plain(cuda, name, coef):
    leaves = [[torch.from_numpy(x).to(cuda) for x in leaf]
              for leaf in _leaves(name, seed=5, padded=True)]
    ws, qs, ss = (list(col) for col in zip(*leaves))
    da.reset_counters()
    got = da.delta_apply_leaves(ws, qs, ss, coef)
    assert da.LAUNCHES["delta_apply"] == 1
    want = da.delta_apply_leaves_plain(ws, qs, ss, coef, 128)
    singles = [da.delta_apply(w.reshape(-1), q[:w.numel()], s, coef)
               for w, q, s in zip(ws, qs, ss)]
    torch.cuda.synchronize()
    for g, p, one in zip(got, want, singles):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))
        assert torch.equal(g.reshape(-1).view(torch.int32),
                           one.view(torch.int32))


@pytest.mark.gpu
def test_cuda_leaves_levels_at_every_offset_and_values_in_one_buffer(cuda):
    """q views at every byte offset mod 16 (the float4 path needs them
    4-byte aligned, the scalar path takes the rest), and w views into one
    flat buffer, some off a 16-byte boundary."""
    sizes = [1, 5, 127, 128, 1000, 1031, 4096, 5000]
    rng = np.random.default_rng(6)
    wbuf = torch.from_numpy((0.1 * rng.standard_normal(
        sum(sizes) + 3 * len(sizes))).astype(np.float32)).to(cuda)
    qbuf = torch.from_numpy(rng.integers(-127, 128, 16 + sum(sizes) + 128)
                            .astype(np.int8)).to(cuda)
    for q_off in range(16):
        ws, qs, ss, o, qo = [], [], [], 0, q_off
        for i, n in enumerate(sizes):
            o += i % 4                    # w at element offsets 0, 1, 2, 3
            ws.append(wbuf[o:o + n])
            qs.append(qbuf[qo:qo + n])
            ss.append(torch.from_numpy((1e-3 * rng.random(-(-n // 128))
                                        + 1e-6).astype(np.float32)).to(cuda))
            o += n
            qo += n
        for coef in (1.0, -1.0):
            got = da.delta_apply_leaves(ws, qs, ss, coef)
            want = da.delta_apply_leaves_plain(ws, qs, ss, coef, 128)
            torch.cuda.synchronize()
            for g, p in zip(got, want):
                assert torch.equal(g.view(torch.int32), p.view(torch.int32))


@pytest.mark.gpu
def test_cuda_leaves_above_the_cap(cuda):
    leaves = [[torch.from_numpy(x).to(cuda) for x in leaf]
              for _ in range(10) for leaf in _leaves("ragged", seed=7)]
    ws, qs, ss = (list(col) for col in zip(*leaves))
    da.reset_counters()
    got = da.delta_apply_leaves(ws, qs, ss, -1.0)
    assert len(ws) == 70 and da.LAUNCHES["delta_apply"] == 2
    for g, p in zip(got, da.delta_apply_leaves_plain(ws, qs, ss, -1.0, 128)):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))


@pytest.mark.gpu
def test_cuda_broadcast_apply_and_residual_one_launch_each(cuda):
    codec = comms.get_codec("int8-blockscale")
    recon, w, carried = _tree(8), _tree(9), _tree(10)
    spec = comms.WireSpec(params=comms.shape_template(recon))
    payload = codec.encode(comms.ClientUpdate(None, None, recon, None), spec)
    decoded = codec.decode(payload, spec).params
    sections = codec.device_sections(payload, spec, cuda)
    bc = rounds.Broadcast(int8=sections, block=codec.block)
    for coef, base in ((1.0, w), (-1.0, carried)):
        on_card = {m: {k: v.to(cuda) for k, v in d.items()}
                   for m, d in base.items()}
        da.reset_counters()
        got = (bc.apply(on_card) if coef > 0 else
               rounds.apply_int8_tree(on_card, sections, coef, codec.block))
        assert da.LAUNCHES["delta_apply"] == 1
        for m, d in base.items():
            for k, v in d.items():
                np.testing.assert_array_equal(
                    _bits(got[m][k].cpu().numpy()),
                    _bits(v.numpy() + coef * decoded[m][k]))
