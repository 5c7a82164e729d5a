"""The port's ``delta_compress`` kernels against the reference.

On the CPU the wrappers take their plain PyTorch versions, which must be
BITWISE equal (q and scales) to the reference's eager-jnp oracles in
``repro.kernels.ref``.  Against the Pallas kernels run in interpret mode q
is bitwise and the scales are held to rtol 1e-6: interpret-mode
``amax / 127`` may differ from eager jnp by one ulp (kernels/README.md).

The ``gpu`` tests hold the CUDA kernel bitwise to the plain version on the
card; they skip where no CUDA device is visible.  The reference is imported
inside a fixture, so the ``gpu`` tests also run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import delta_compress as dc
from repro_torch.kernels import ops, ref

NS = [0, 5, 127, 128, 777, 1000]
KS = [1, 4, 8]
THETAS = [0.0, 0.05]
BLOCKS = [128, 1024]


@pytest.fixture
def jref():
    """(jax.numpy, repro.kernels.ref, repro.kernels.delta_compress)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import delta_compress as ref_pallas
    from repro.kernels import ref as ref_oracle
    return jnp, ref_oracle, ref_pallas


def _deltas(k, n, seed=0):
    rng = np.random.default_rng(seed + 7 * n + k)
    d = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    if n > 3:
        d[:, :3] = 0.0          # an exact-zero run
        d[0, -1] = 0.05         # a value on the threshold
    return d


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("n", NS)
def test_plain_single_bitwise_vs_reference_oracle(jref, n, theta, block):
    jnp, ref_oracle, _ = jref
    d = _deltas(1, n)[0]
    rq, rs = ref_oracle.delta_compress(jnp.asarray(d), theta, block)
    pq, ps = ops.delta_compress_flat(torch.from_numpy(d), theta, block=block)
    np.testing.assert_array_equal(np.asarray(rq), pq.numpy())
    np.testing.assert_array_equal(np.asarray(rs), ps.numpy())


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_plain_batch_bitwise_vs_reference_oracle(jref, n, k, theta, block):
    jnp, ref_oracle, _ = jref
    d = _deltas(k, n)
    rq, rs = ref_oracle.delta_compress_batch(jnp.asarray(d), theta, block)
    pq, ps = ops.delta_compress_batch(torch.from_numpy(d), theta, block=block)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert tuple(pq.shape) == (k, n) and tuple(ps.shape) == (k, -(-n // block))
    np.testing.assert_array_equal(np.asarray(rq).reshape(k, n), pq.numpy())
    np.testing.assert_array_equal(np.asarray(rs).reshape(k, -1), ps.numpy())


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("n", [5, 777, 1000])
def test_plain_vs_pallas_interpret(jref, n, k, theta, block):
    jnp, _, ref_pallas = jref
    d = _deltas(k, n, seed=1)
    rq, rs = ref_pallas.delta_compress_batch(jnp.asarray(d), theta,
                                             block=block, interpret=True)
    pq, ps = dc.delta_compress_batch(torch.from_numpy(d), theta, block=block)
    np.testing.assert_array_equal(np.asarray(rq), pq.numpy())
    np.testing.assert_allclose(np.asarray(rs), ps.numpy(), rtol=1e-6)
    sq, ss = ref_pallas.delta_compress(jnp.asarray(d[0]), theta, block=block,
                                       interpret=True)
    np.testing.assert_array_equal(np.asarray(sq), pq[0].numpy())
    np.testing.assert_allclose(np.asarray(ss), ps[0].numpy(), rtol=1e-6)


@pytest.mark.parametrize("k", KS)
def test_batch_rows_equal_single_calls(k):
    d = torch.from_numpy(_deltas(k, 777))
    bq, bs = dc.delta_compress_batch(d, 0.05, block=128)
    for i in range(k):
        q, s = dc.delta_compress(d[i], 0.05, block=128)
        assert torch.equal(q, bq[i]) and torch.equal(s, bs[i])


def test_all_zero_blocks_get_scale_one():
    q, s = dc.delta_compress(torch.zeros(300), 0.0, block=128)
    assert torch.equal(s, torch.ones(3)) and not q.any()


def test_cpu_wrappers_count_calls_not_launches():
    dc.reset_counters()
    d = torch.from_numpy(_deltas(4, 256))
    dc.delta_compress_batch(d, 0.0)
    dc.delta_compress(d[0], 0.0, block=128)
    assert dc.CALLS == {"delta_compress": 1, "delta_compress_batch": 1}
    assert dc.LAUNCHES == {"delta_compress": 0, "delta_compress_batch": 0}


@pytest.mark.parametrize("bad", [dict(block=64), dict(block=1152),
                                 dict(block=200)])
def test_wrapper_rejects_unsupported_block(bad):
    with pytest.raises(ValueError):
        dc.delta_compress(torch.zeros(10), 0.0, **bad)


def test_wrapper_rejects_non_float32():
    with pytest.raises(TypeError):
        dc.delta_compress(torch.zeros(10, dtype=torch.float64), 0.0)


def test_ref_module_is_the_plain_version():
    d = torch.from_numpy(_deltas(2, 300))
    for a, b in zip(ref.delta_compress_batch(d, 0.0, 128),
                    dc.delta_compress_batch_plain(d, 0.0, 128)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_cuda_kernel_bitwise_vs_plain(cuda, n, k, theta, block):
    d = torch.from_numpy(_deltas(k, n)).to(cuda)
    dc.reset_counters()
    q, s = dc.delta_compress_batch(d, theta, block=block)
    assert dc.LAUNCHES["delta_compress_batch"] == (1 if n else 0)
    pq, ps = dc.delta_compress_batch_plain(d, theta, block)
    torch.cuda.synchronize()
    assert torch.equal(q, pq) and torch.equal(s, ps)
    if k == 1:
        q1, s1 = dc.delta_compress(d[0], theta, block=block)
        assert torch.equal(q1, pq[0]) and torch.equal(s1, ps[0])


@pytest.mark.gpu
def test_cuda_kernel_main_path_shape(cuda):
    d = torch.from_numpy(_deltas(4, 850_304)).to(cuda)
    q, s = dc.delta_compress_batch(d, 0.0, block=128)
    pq, ps = dc.delta_compress_batch_plain(d, 0.0, 128)
    torch.cuda.synchronize()
    assert torch.equal(q, pq) and torch.equal(s, ps)
