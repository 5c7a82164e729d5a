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
from repro_torch.models import cnn

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


# ------------------------------------------------- the grouped encode's table

def test_body_layout_offsets():
    q, s, length = dc.body_layout([10, 128, 129, 0], [3, 1], 128)
    assert q == [0, 132, 264, 528, 528, 540]
    assert s == [128, 260, 520, 528, 0, 0]
    assert length == 544
    assert all(o % 4 == 0 for o in q + s)


def test_encode_table_bits_and_group_ranges():
    sizes = [10, 1024, 1025, 2048, 0, 3, 7]     # 5 params leaves, 2 raw
    ptrs = [0, 16, 20, 48, 64, 4, 32]
    table = dc.encode_table(sizes, 5, ptrs, rows=1, block=128, per_warp=1)
    assert table == [(0, 7, [0, 1, 9, 18, 34, 34, 35, 36], 0b1100000,
                      0b1011011)]
    # stacked rows start 16-byte aligned only where n % 4 == 0
    table = dc.encode_table(sizes, 5, ptrs, rows=4, block=128, per_warp=2)
    assert table == [(0, 7, [0, 1, 5, 10, 18, 18, 19, 20], 0b1100000,
                      0b0011010)]
    # 8 groups of one warp to a CTA at block 128, 2 of 4 warps at 512
    assert dc.launch_ctas(sizes, 128, 1) == 5
    assert dc.launch_ctas([4096], 512, 2) == 2
    assert dc.groups_per_cta(384) == 2


def test_encode_table_splits_past_the_cap():
    sizes = [128] * 60 + [4] * 10
    ptrs = [16 * i for i in range(70)]
    table = dc.encode_table(sizes, 60, ptrs, rows=2, block=128, per_warp=1)
    assert [(lo, hi) for lo, hi, *_ in table] == [(0, 64), (64, 70)]
    assert table[0][2] == list(range(65))
    assert table[0][3] == ((1 << 64) - 1) & ~((1 << 60) - 1)
    assert table[0][4] == (1 << 64) - 1
    assert table[1][2] == list(range(7))
    assert table[1][3] == table[1][4] == (1 << 6) - 1


def test_pick_per_warp_keeps_the_grid_within_two_waves():
    params, _ = cnn.vgg11_thinned().init(torch.Generator().manual_seed(0))
    leaves = [v for d in params.values() for v in d.values()]
    sizes = ([v.numel() for v in leaves]
             + [v.shape[0] if v.ndim >= 2 else 1 for v in leaves])
    assert sum(sizes) == 849_834 + 1_020 and len(sizes) == 56
    # 6,643 blocks of params and 28 raw leaves of at most 128 floats
    assert dc.launch_ctas(sizes, 128, 1) == -(-6_671 // 8) == 834
    assert dc.PER_WARP == (1, 2)
    # an H100's 132 SMs: two waves are 2,112 CTAs
    assert dc.pick_per_warp(sizes, 1, 128, 132) == 1
    assert dc.pick_per_warp(sizes, 2, 128, 132) == 1
    assert dc.pick_per_warp(sizes, 4, 128, 132) == 2
    assert dc.pick_per_warp(sizes, 64, 128, 132) == 2
    # half the SMs: two rows no longer fit at 1 slot a warp
    assert dc.pick_per_warp(sizes, 1, 128, 66) == 1
    assert dc.pick_per_warp(sizes, 2, 128, 66) == 2


def test_grouped_wrapper_checks_and_counts():
    p = [torch.zeros(2, 10), torch.zeros(2, 3, 4)]
    s = [torch.zeros(2)]
    dc.reset_counters()
    body = dc.int8_encode_leaves(p, s, 0.0, 128)
    assert body.shape == (2, 128 + 4 + 128 + 4 + 4)
    assert dc.CALLS == {"delta_compress": 0, "delta_compress_batch": 1}
    assert dc.LAUNCHES == {"delta_compress": 0, "delta_compress_batch": 0}
    with pytest.raises(TypeError):
        dc.int8_encode_leaves([torch.zeros(1, 4, dtype=torch.float64)], [],
                              0.0, 128)
    with pytest.raises(ValueError):
        dc.int8_encode_leaves(p, [torch.zeros(3)], 0.0, 128)
    with pytest.raises(ValueError):
        dc.int8_encode_leaves(p, s, 0.0, 128, batched=False)
    with pytest.raises(ValueError):
        dc.int8_encode_leaves(p, s, 0.0, 64)
    with pytest.raises(ValueError):
        dc.int8_encode_leaves([], [], 0.0, 128)


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


# the grouped encode on the card: bodies byte-equal to the plain version

def _flat_views(cuda, rng, sizes, k, shifts):
    """(K, n_i) float32 views of one card buffer, leaf i starting at an
    element offset of ``shifts[i]`` mod 4 (so at each 4-byte offset mod
    16), with rows n_i apart."""
    offs, total = [], 0
    for n, sh in zip(sizes, shifts):
        total += (sh - total) % 4
        offs.append(total)
        total += k * n
    flat = torch.from_numpy(
        (0.05 * rng.standard_normal(total + 4)).astype(np.float32)).to(cuda)
    return [flat[o:o + k * n].view(k, n) for o, n in zip(offs, sizes)]


def _assert_body_equal(p, s, theta=0.0, block=128, batched=True):
    name = "delta_compress_batch" if batched else "delta_compress"
    dc.reset_counters()
    body = dc.int8_encode_leaves(p, s, theta, block, batched=batched)
    launches = dc.LAUNCHES[name]
    plain = dc.int8_encode_leaves_plain(p, s, theta, block)
    torch.cuda.synchronize()
    assert body.shape == plain.shape and body.dtype == torch.uint8
    assert torch.equal(body, plain)
    return body, launches


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_cuda_encode_leaf_views_at_every_offset(cuda, shift):
    rng = np.random.default_rng(30 + shift)
    sizes = [10, 127, 128, 300, 1000, 4099, 40_000, 3, 17]
    leaves = _flat_views(cuda, rng, sizes, 1,
                         [(shift + i) % 4 for i in range(len(sizes))])
    _, launches = _assert_body_equal(leaves[:7], leaves[7:], batched=False)
    assert launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_cuda_encode_stacked_rows(cuda, r):
    """Rows n apart with n mod 4 = r: 16-byte aligned rows only at r = 0;
    every leaf ends in a partial block but the first."""
    rng = np.random.default_rng(40 + r)
    k = 3
    p = [torch.from_numpy((0.05 * rng.standard_normal((k, n)))
                          .astype(np.float32)).to(cuda)
         for n in (1024 + r, 641 + r, 64 + r, 3077 + r)]
    s = [torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
         .to(cuda) for n in (3, 1)]
    _, launches = _assert_body_equal(p, s)
    assert launches == 1
    # and as views at every offset
    views = _flat_views(cuda, rng, [10 + r, 130 + r, 1000 + r], k,
                        [1, 2, 3])
    _assert_body_equal(views, [])


def _tie_leaf(rng, k, nblk):
    """Blocks whose maximum is 127 * 2^-10 (scale exactly 2^-10) and whose
    other values are (j + 1/2) * 2^-10: every quotient an exact half-way
    tie; every third block all zero."""
    step = 2.0 ** -10
    j = rng.integers(-127, 127, size=(k, nblk, 128))
    d = ((j + 0.5) * step).astype(np.float32)
    d[:, :, 0] = 127 * step
    d[:, ::3, :] = 0.0
    return d.reshape(k, -1)


@pytest.mark.gpu
@pytest.mark.parametrize("theta", [0.0, 40.25 * 2.0 ** -10])
def test_cuda_encode_ties_zero_blocks_and_threshold(cuda, theta):
    rng = np.random.default_rng(50)
    k = 2
    leaves = [torch.from_numpy(_tie_leaf(rng, k, nblk)).to(cuda)
              for nblk in (1, 5, 33)]
    body, _ = _assert_body_equal(leaves, [], theta=theta)
    # the second leaf's sections: 640 levels, then 5 block scales; its
    # all-zero blocks 0 and 3 carry the scale-1 sentinel, the others 2^-10
    off = 128 + 4
    scales = (body[:, off + 640:off + 660].cpu().contiguous()
              .view(torch.float32))
    assert scales[:, 0].eq(1.0).all() and scales[:, 3].eq(1.0).all()
    assert scales[:, [1, 2, 4]].eq(2.0 ** -10).all()
    q = (body[:, off:off + 640].cpu().contiguous().view(torch.int8)
         .reshape(k, 5, 128)[:, [1, 2, 4], 1:].to(torch.int32).abs())
    assert (q % 2 == 0).all()                      # ties to even
    if theta:            # |j + 1/2| <= 39.5 dropped, the rest round to >= 40
        assert ((q == 0) | (q >= 40)).all() and (q == 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("per_warp", dc.PER_WARP)
def test_cuda_encode_at_every_per_warp(cuda, monkeypatch, per_warp, block):
    """Every built slot count, whatever the wrapper would pick: leaves of
    one to many groups, each ending in a partial block or a partial group,
    stacked rows and views at unaligned offsets."""
    monkeypatch.setattr(dc, "pick_per_warp", lambda *args: per_warp)
    rng = np.random.default_rng(70 + per_warp)
    k = 3
    p = [torch.from_numpy((0.05 * rng.standard_normal((k, n)))
                          .astype(np.float32)).to(cuda)
         for n in (4 * 1024, 5 * 256 + 7, 3 * 128, 130, 9)]
    s = [torch.from_numpy(rng.standard_normal((k, 5)).astype(np.float32))
         .to(cuda)]
    _, launches = _assert_body_equal(p, s, block=block)
    assert launches == 1
    views = _flat_views(cuda, rng, [10, 1000, 7 * 128 + 1], 1, [1, 2, 3])
    _assert_body_equal(views[:2], views[2:], block=block, batched=False)


@pytest.mark.gpu
def test_cuda_encode_past_the_leaf_cap(cuda):
    rng = np.random.default_rng(60)
    k = 2
    sizes = [int(n) for n in rng.integers(1, 700, size=60)]
    p = [torch.from_numpy((0.05 * rng.standard_normal((k, n)))
                          .astype(np.float32)).to(cuda) for n in sizes]
    s = [torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
         .to(cuda) for n in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10)]
    _, launches = _assert_body_equal(p, s)
    assert launches == 2


def _main_path_deltas():
    """(4, 850,304) float32 at the main path's density, from a frozen
    numpy stream."""
    rng = np.random.RandomState(19)
    d = 1e-3 * rng.standard_normal((4, 850_304))
    return (d * (rng.random_sample((4, 850_304)) < 0.1)).astype(np.float32)


# sha256 of q's then the scales' bytes that the one-buffer kernel before
# the grouped design gave on _main_path_deltas() (an H100): the batch at
# theta 0, and row 0 alone at theta 0.05 * 1e-3
PRE_GROUPED = {
    128: ["e8d78ca5296c66c28db5cda020d0b176e5919997933a77b02adb8084bd4c41a6",
          "ae06995497d8c001a14c2962a38196d6f1be3d838e87668b22cab5d186759b9c"],
    256: ["490b25dd0bd5aa14c75037d7afcbff580901298577e587f0ed81ddb254293631",
          "8864e12521859aeca74e404ec5a292e1f9b6dfbdb63aaf6b91b9d9e3d99df811"],
    512: ["35ca3181343e48a0d0f3b836f0ad317e8795b0ffeec64cf90ed559a1a32c5550",
          "f93f852a3594aab060f6cf09977f50e79f0742cef60915c094864ec3a8221094"],
    1024: ["c2829b0e93c6f25db9bb2a5c52b2411d2a7420cb59cac76a6c7931c0ebb4de42",
           "3975e3bba38abda0e5131dfbb10b8e1e3b92a97730ce1839e164f26e42e000d4"]}


@pytest.mark.gpu
@pytest.mark.parametrize("block", [128, 256, 512, 1024])
def test_cuda_single_buffer_entries_main_path_shape(cuda, block):
    import hashlib
    d = torch.from_numpy(_main_path_deltas()).to(cuda)
    dc.reset_counters()
    q, s = dc.delta_compress_batch(d, 0.0, block=block)
    q1, s1 = dc.delta_compress(d[0], 0.05e-3, block=block)
    assert dc.LAUNCHES == {"delta_compress": 1, "delta_compress_batch": 1}
    pq, ps = dc.delta_compress_batch_plain(d, 0.0, block)
    pq1, ps1 = dc.delta_compress_plain(d[0], 0.05e-3, block)
    torch.cuda.synchronize()
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(q1, pq1) and torch.equal(s1, ps1)
    got = [hashlib.sha256(a.cpu().numpy().tobytes()
                          + b.cpu().numpy().tobytes()).hexdigest()
           for a, b in ((q, s), (q1, s1))]
    assert got == PRE_GROUPED[block]
