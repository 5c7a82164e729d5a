"""Tree checkpointing: msgpack + zstandard (or zlib), the reference's format.

Port of ``repro.checkpoint.io``.  A tree of dicts, lists, tuples, ``None``
and arrays (numpy arrays or tensors, which go to the host) is stored as
msgpack with every array as ``{"__nd__": 1, "dtype", "shape", "data"}``
(numpy's dtype string, the shape as a list, the raw bytes) and every
dict's keys in sorted order, the reference's bytes exactly, compressed
with zstandard when it is installed and with zlib otherwise.  Files
cross between the two packages both ways.

The port encodes and decodes the msgpack it needs itself (nil, integers,
strings, binary, arrays, maps, in the smallest form, as
``msgpack.packb(..., use_bin_type=True)`` writes them), so it needs no
msgpack package.  ``restore`` returns numpy arrays that view the file's
bytes (read-only); ``restore(path, target=...)`` puts them into
``target``'s structure, leaf by leaf in path order.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any

import numpy as np

from repro_torch.tree import items, rebuild

try:  # zstandard is optional: stdlib zlib when absent, as the reference
    import zstandard
except ImportError:  # pragma: no cover - depends on the environment
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


# ---------------------------------------------------------------- msgpack

def _pack_len(out: list, n: int, fix: int | None, fix_max: int,
              codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form of ``codes`` (None where msgpack has no such form)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack length {n} is too large")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 128:
        out.append(bytes((v,)))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < top:
                out.append(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)),
                               (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)),
                               (0xd3, ">q", -(1 << 63))):
            if v >= low:
                out.append(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack(out: list, obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        raise TypeError("booleans are not part of the checkpoint format")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for nil, int, str, bytes,
    lists/tuples and dicts."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack payload")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
         0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def _unpack(r: _Reader) -> Any:
    code = r.num(">B")
    if code <= 0x7f:
        return code
    if code >= 0xe0:
        return code - 0x100
    if code == 0xc0:
        return None
    if code in _INTS:
        return r.num(_INTS[code])
    if 0xa0 <= code <= 0xbf:
        kind, n = "str", code & 0x1f
    elif 0x90 <= code <= 0x9f:
        kind, n = "array", code & 0x0f
    elif 0x80 <= code <= 0x8f:
        kind, n = "map", code & 0x0f
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = r.num(fmt)
    else:
        raise ValueError(f"msgpack type 0x{code:02x} is not part of the "
                         "checkpoint format")
    if kind == "str":
        return bytes(r.take(n)).decode("utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the types ``packb``
    writes (arrays as lists)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# ---------------------------------------------------------------- format

def _compress(payload: bytes, level: int) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=level).compress(payload)
    return zlib.compress(payload, min(level, 9))  # zlib caps at 9, zstd at 22


def _decompress(data: bytes) -> bytes:
    if data[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError("checkpoint is zstd-compressed but zstandard "
                               "is not installed")
        return zstandard.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):             # a tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _encode(tree: Any) -> Any:
    # a dict's keys in sorted order, as the reference's save writes them
    # (its tree map rebuilds every dict with sorted keys)
    if isinstance(tree, dict):
        return {str(k): _encode(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_encode(v) for v in tree]
    if tree is None:
        return None
    arr = _host(tree)
    return {"__nd__": 1, "dtype": arr.dtype.str, "shape": list(arr.shape),
            "data": arr.tobytes()}


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict) and obj.get("__nd__") == 1:
        return np.frombuffer(obj["data"], np.dtype(obj["dtype"])).reshape(
            obj["shape"])
    if isinstance(obj, dict):
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def payload(tree: Any) -> bytes:
    """The uncompressed msgpack bytes ``save`` writes for ``tree``."""
    return packb(_encode(tree))


def save(path: str, tree: Any, level: int = 3) -> int:
    """Write a tree checkpoint; returns the compressed byte count."""
    data = _compress(payload(tree), level)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return len(data)


def restore(path: str, target: Any | None = None) -> Any:
    """Read a checkpoint; with ``target``, its leaves in ``target``'s
    structure (matched by path)."""
    with open(path, "rb") as f:
        tree = _decode(unpackb(_decompress(f.read())))
    if target is None:
        return tree
    return rebuild(target, dict(items(tree)))
