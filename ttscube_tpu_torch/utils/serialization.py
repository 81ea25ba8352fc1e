"""flax's msgpack checkpoint format in Python and numpy alone, with no `msgpack` import:
counterpart of `flax.serialization.msgpack_serialize` / `msgpack_restore`, which the
JAX package's `.model`, `.best`, `.last` and `.opt.last` files are written with.

What flax writes, and so what is covered here:
  * maps with str keys, lists, ints, floats (always float64), bools, None, str, bytes;
  * every numpy array as extension type 1, whose payload is itself msgpack: the array
    (shape, dtype name, the raw C-order bytes);
  * a numpy scalar as extension type 3, the same payload with shape ();
  * an array above 2^30 bytes as a map {"__msgpack_chunked_array__": True, "shape":
    {"0": ..}, "chunks": {"0": flat array, ..}} of flat chunks of at most 2^30 bytes.

`msgpack_serialize(tree)` writes each map in its own order and gives the bytes of
flax's `to_bytes` for the state dict it writes (flax's `msgpack_serialize` first
rebuilds its tree through jax.tree_util, which sorts the keys: for a sorted tree the
bytes are its bytes too); `msgpack_restore(data)` gives the tree flax gives, with
read-only numpy arrays.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax's MAX_CHUNK_SIZE: arrays above this many bytes are written as chunks (msgpack
# holds at most 2^32 − 1 bytes in one object)
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"


# -- writing --------------------------------------------------------------------------


def _int(out: list, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0x80 <= v <= 0xFF:
        out.append(struct.pack("BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0xFF < v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < -0x80:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _header(out: list, n: int, small: int | None, small_limit: int, codes: tuple) -> None:
    """A length header: the fix form (`small` | n) below `small_limit`, else the
    8/16/32-bit form from `codes` (an 8-bit code of None means there is none)."""
    if small is not None and n < small_limit:
        out.append(struct.pack("B", small | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack("BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack holds at most 2^32 - 1 entries or bytes, got {n}")


def _bytes(out: list, b: bytes) -> None:
    _header(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
    out.append(bytes(b))


def _ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("B", fixed[n]))
    elif n <= 0xFF:
        out.append(struct.pack("BB", 0xC7, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC8, n))
    else:
        out.append(struct.pack(">BI", 0xC9, n))
    out.append(struct.pack("b", code))
    out.append(data)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack of (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.names:
        raise ValueError(f"arrays of dtype {arr.dtype} cannot be serialized")
    return _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _write(out: list, x) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _int(out, x)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif t is str:
        b = x.encode("utf-8")
        _header(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif t in (bytes, bytearray):
        _bytes(out, x)
    elif t in (list, tuple):
        _header(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _write(out, v)
    elif t is dict:
        _header(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _write(out, k)
            _write(out, v)
    elif isinstance(x, np.ndarray):
        _ext(out, EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} {x!r}")


def _pack(x) -> bytes:
    out: list = []
    _write(out, x)
    return b"".join(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax's `_chunk`: a flat array cut into chunks of at most MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i: i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunked(x):
    """The tree with every array above MAX_CHUNK_SIZE bytes in chunked form (a copy of
    the maps; the arrays are not copied)."""
    if isinstance(x, dict):
        return {k: _chunked(v) for k, v in x.items()}
    if isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def msgpack_serialize(tree) -> bytes:
    """The flax msgpack bytes of a tree of dicts, lists and numpy or Python leaves."""
    return _pack(_chunked(tree))


# -- reading --------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        c = self.unpack("B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.text(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in fmts:
            return self.unpack(fmts[c])
        lens = {0xC4: "B", 0xC5: ">H", 0xC6: ">I", 0xD9: "B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: "B", 0xC8: ">H",
                0xC9: ">I"}
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(lens[c])))
        if c in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack(lens[c]))
        if c in (0xDC, 0xDD):
            return self.array(self.unpack(lens[c]))
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(lens[c]))
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        if c in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(lens[c]))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not supported")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not supported")
        arr = _ndarray_from_payload(data)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray_from_payload(data) -> np.ndarray:
    r = _Reader(data)
    payload = r.obj()
    if r.pos != len(r.data) or not isinstance(payload, list) or len(payload) != 3:
        raise ValueError("malformed array payload")
    shape, name, buf = payload
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"array dtype {name!r} is not a numpy dtype") from None
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _unchunked(x):
    if isinstance(x, dict):
        if CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            flat = np.concatenate([x["chunks"][str(i)] for i in range(len(x["chunks"]))])
            return flat.reshape(shape)
        return {k: _unchunked(v) for k, v in x.items()}
    return x


def msgpack_restore(data: bytes):
    """The tree of flax msgpack bytes, chunked arrays joined."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes follow the msgpack object")
    return _unchunked(tree)
