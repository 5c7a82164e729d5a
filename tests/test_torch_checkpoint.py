"""The port's checkpoint format (``repro_torch.checkpoint.io``) against the
reference's (``repro.checkpoint.io``):

* the port's hand-written msgpack subset (nil, integers in every width,
  strings, binary, arrays and maps at every length header) writes
  ``msgpack.packb(..., use_bin_type=True)``'s bytes and reads them back as
  ``msgpack.unpackb(..., raw=False)`` does;
* the uncompressed payload of a tree (dicts, lists, tuples, ``None``,
  numpy arrays and tensors of several dtypes) equals msgpack's packing of
  the reference's encoding of the tree as its ``save`` sees it (after
  ``jax.tree.map``, which rebuilds every dict with sorted keys), byte for
  byte, and so does each compressed file;
* files cross both ways, under zlib (this machine has no zstandard) and
  under a zstd stand-in, with ``target`` restoring the structure;
* restored arrays view the file's bytes (read-only), as the reference's
  do, which is why the sharded store copies them.
"""
import zlib

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ref_io
from repro_torch.checkpoint import io
from repro_torch.tree import items

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
        -2**31 - 1, -2**63]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _msgpack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


@pytest.mark.parametrize("v", INTS)
def test_integers_as_msgpack(v):
    assert io.packb(v) == _msgpack(v)
    assert io.unpackb(_msgpack(v)) == v


@pytest.mark.parametrize("n", LENGTHS)
def test_length_headers_as_msgpack(n):
    for obj in ("é" * (n // 2) + "x" * (n % 2), b"\x00\xff" * (n // 2),
                list(range(n)), {f"k{i}": [i, None] for i in range(n)}):
        assert io.packb(obj) == _msgpack(obj), (n, type(obj))
        assert io.unpackb(_msgpack(obj)) == msgpack.unpackb(
            _msgpack(obj), raw=False)
    with pytest.raises(TypeError):
        io.packb(1.5)
    with pytest.raises(ValueError):
        io.unpackb(_msgpack(1) + b"\x00")


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"conv0": {"w": rng.standard_normal((4, 3, 3, 3))
                             .astype(np.float32)},
                   "fc0": (rng.integers(-9, 9, 7).astype(np.int32),
                           np.zeros((), np.int64))},
        "steps": [np.arange(3, dtype=np.uint8), None,
                  rng.standard_normal(300).astype(np.float64)],
        "empty": np.zeros((0, 5), np.float32),
        "long": np.arange(70_000, dtype=np.int16),
    }


def _equal(a, b):
    pa, pb = sorted(items(a)), sorted(items(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert x.tobytes() == y.tobytes(), p


def _ref_payload(tree) -> bytes:
    """What the reference's ``save`` packs (its first two steps)."""
    return _msgpack(ref_io._encode(jax.tree.map(np.asarray, tree)))


def test_payload_bytes_equal_msgpack_of_the_reference_encoding():
    tree = _tree()
    assert io.payload(tree) == _ref_payload(tree)
    unsorted = {"b": np.ones(2, np.float32), "a": {"z": None, "y": [1]}}
    unsorted["a"]["y"] = [np.int8(1)]
    assert io.payload(unsorted) == _ref_payload(unsorted)
    # tensors go to the host first: the same bytes as their numpy arrays
    as_tensors = {"w": torch.from_numpy(tree["params"]["conv0"]["w"]),
                  "i": torch.tensor([3, -4], dtype=torch.int32)}
    assert io.payload(as_tensors) == _ref_payload(
        {"w": tree["params"]["conv0"]["w"],
         "i": np.asarray([3, -4], np.int32)})


class _FakeZstd:
    """A zstd stand-in (this machine has no zstandard): zlib behind the
    zstd magic, enough to drive both packages' zstd branches."""
    magic = b"\x28\xb5\x2f\xfd"

    class ZstdCompressor:
        def __init__(self, level):
            self.level = level

        def compress(self, data):
            return _FakeZstd.magic + zlib.compress(data, min(self.level, 9))

    class ZstdDecompressor:
        def decompress(self, data):
            return zlib.decompress(data[4:])


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_files_cross_both_ways(tmp_path, monkeypatch, codec):
    tree = _tree()
    for mod in (io, ref_io):
        monkeypatch.setattr(mod, "zstandard",
                            _FakeZstd if codec == "zstd" else None)
    n_port = io.save(str(tmp_path / "port.ckpt"), tree, level=1)
    n_ref = ref_io.save(str(tmp_path / "ref.ckpt"), tree, level=1)
    assert n_port == n_ref
    assert (tmp_path / "port.ckpt").read_bytes() == (
        tmp_path / "ref.ckpt").read_bytes()
    head = (tmp_path / "port.ckpt").read_bytes()[:4]
    assert (head == _FakeZstd.magic) == (codec == "zstd")
    _equal(ref_io.restore(str(tmp_path / "port.ckpt")), tree)
    _equal(io.restore(str(tmp_path / "ref.ckpt")), tree)
    # target= restores the structure (tuples included)
    back = io.restore(str(tmp_path / "ref.ckpt"), target=tree)
    assert isinstance(back["params"]["fc0"], tuple)
    _equal(back, tree)


def test_zstd_file_without_zstandard_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(io, "zstandard", _FakeZstd)
    io.save(str(tmp_path / "z.ckpt"), {"a": np.ones(3)})
    monkeypatch.setattr(io, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        io.restore(str(tmp_path / "z.ckpt"))


def test_restored_buffers_are_read_only(tmp_path):
    path = str(tmp_path / "leaves.ckpt")
    leaves = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.zeros(4, np.int32)]
    io.save(path, leaves)
    for mod in (io, ref_io):
        back = mod.restore(path)
        assert isinstance(back, list) and len(back) == 2
        for got, want in zip(back, leaves):
            assert isinstance(got, np.ndarray)
            assert not got.flags.writeable
            np.testing.assert_array_equal(got, want)
