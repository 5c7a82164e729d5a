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

The ``gpu`` tests hold the CUDA kernel bitwise to the plain version on the
card; they skip where no CUDA device is visible.
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
from repro_torch.kernels import ops, ref

NS = [1, 5, 127, 128, 129, 1000, 1031]
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
