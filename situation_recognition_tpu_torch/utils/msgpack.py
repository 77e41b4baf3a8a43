"""flax's msgpack format, read and written without the ``msgpack`` package.

The JAX package keeps its checkpoints, converted backbones and serving
weight files as ``flax.serialization.msgpack_serialize`` writes them: a
msgpack document of maps, arrays, strings, numbers, nil and booleans whose
array leaves are msgpack *ext* objects:

* ext type 1, an ndarray: the payload is itself msgpack, the triple
  ``(shape, dtype name, C-order bytes)``;
* ext type 3, a numpy scalar: the same payload with shape ``()``;
* an array above ``MAX_CHUNK_SIZE`` bytes is split into flat chunks,
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks":
  {"0": .., "1": ..}}``.

Tuples become index dicts (``{"0": a, "1": b}``, flax's
``_tuple_to_dict``); ``tuple_list`` turns one back into a list.

``read`` / ``loads`` return nested dicts and lists with numpy arrays as
leaves; an array of dtype ``bfloat16``, which numpy does not have, comes
back as a ``torch.bfloat16`` tensor.  The file is read into one buffer and
every array is a view of it: a whole 1–2 GB checkpoint costs its size in
memory once (a chunked array is joined, which copies it once).  ``write`` /
``dumps`` produce what ``flax.serialization.msgpack_restore`` reads.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

#: flax's chunk limit (msgpack's bin objects hold at most 2**32 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """A msgpack decoder over one buffer; ``value`` decodes the object at
    the cursor."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        lo = self.pos
        if lo + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos = lo + n
        return self.buf[lo:lo + n]

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self, raw_str: bool = False) -> Any:
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f, raw_str)
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f, raw_str)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        if b in (0xc4, 0xc5, 0xc6):                       # bin 8/16/32
            return self._take(self._unpack({0xc4: ">B", 0xc5: ">H",
                                             0xc6: ">I"}[b]))
        if b in (0xc7, 0xc8, 0xc9):                       # ext 8/16/32
            n = self._unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
            return self._ext(n)
        if 0xd4 <= b <= 0xd8:                             # fixext 1..16
            return self._ext(1 << (b - 0xd4))
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        if b in (0xd9, 0xda, 0xdb):                       # str 8/16/32
            return self._str(self._unpack({0xd9: ">B", 0xda: ">H",
                                           0xdb: ">I"}[b]), raw_str)
        if b in (0xdc, 0xdd):
            return self._array(self._unpack(">H" if b == 0xdc else ">I"),
                               raw_str)
        if b in (0xde, 0xdf):
            return self._map(self._unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no "
                         f"msgpack object")

    def _str(self, n: int, raw: bool):
        data = self._take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def _array(self, n: int, raw_str: bool) -> list:
        return [self.value(raw_str) for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, n: int):
        code = self._take(1)[0]
        data = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not flax's")
        inner = _Reader(data)
        shape, name, payload = inner.value(raw_str=True)
        arr = _array_from(payload, name.decode() if isinstance(
            name, (bytes, bytearray)) else name, tuple(shape))
        if code == _EXT_NPSCALAR:
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        return arr


def _array_from(payload: memoryview, dtype: str, shape: tuple):
    """A view of ``payload`` as an array of ``dtype`` and ``shape`` (numpy
    takes a view at any offset; a bf16 tensor is copied where the payload
    is read-only or not 2-byte aligned)."""
    if dtype == "bfloat16":
        if len(payload) == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        if payload.readonly or np.frombuffer(payload, np.uint8).ctypes.data % 2:
            payload = bytearray(payload)
        return torch.frombuffer(payload, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(payload, dtype=np.dtype(dtype)).reshape(shape)


def tuple_list(d) -> list:
    """flax's ``_tuple_to_dict`` form ``{"0": a, "1": b, ...}`` → [a, b]."""
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(int(x) for x in tuple_list(tree["shape"]))
            chunks = tuple_list(tree["chunks"])
            if chunks and torch.is_tensor(chunks[0]):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def loads(data) -> Any:
    """msgpack bytes (any buffer) → the tree; array leaves are views of
    ``data`` (``bytearray`` data gives writable arrays)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         f"msgpack object")
    return _unchunk(tree)


def read(path: str) -> Any:
    """A flax msgpack file → its tree (``loads``), read in one piece."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    return loads(buf)


# ------------------------------------------------------------------ write


def _head(out, small: int, codes: tuple, n: int, small_max: int) -> None:
    """A length header: a fix-form byte up to ``small_max``, else the
    8/16/32-bit form (``codes``; the 8-bit one may be None)."""
    if n <= small_max:
        out(bytes([small | n]))
    elif codes[0] is not None and n < 1 << 8:
        out(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        out(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"a msgpack object of {n} elements or bytes")


def _bin_head(n: int) -> bytes:
    if n < 1 << 8:
        return struct.pack(">BB", 0xc4, n)
    if n < 1 << 16:
        return struct.pack(">BH", 0xc5, n)
    return struct.pack(">BI", 0xc6, n)


def _int(out, v: int) -> None:
    if 0 <= v <= 0x7f:
        out(bytes([v]))
        return
    if -32 <= v < 0:
        out(struct.pack(">b", v))
        return
    forms = ((">B", 0xcc), (">H", 0xcd), (">I", 0xce), (">Q", 0xcf)) \
        if v >= 0 else ((">b", 0xd0), (">h", 0xd1), (">i", 0xd2),
                        (">q", 0xd3))
    for fmt, code in forms:
        try:
            out(struct.pack(">B", code) + struct.pack(fmt, v))
            return
        except struct.error:
            continue
    raise ValueError(f"integer {v} does not fit msgpack")


def _leaf(x) -> tuple:
    """(shape, dtype name, its C-order bytes as a flat uint8 array) of a
    numpy array or a tensor."""
    if torch.is_tensor(x):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return (tuple(t.shape), "bfloat16",
                    t.view(torch.int16).numpy().reshape(-1).view(np.uint8))
        x = t.numpy()
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")                 # (ascontiguousarray is >= 1-D)
    return a.shape, a.dtype.name, a.reshape(-1).view(np.uint8)


def _ext_array(out, code: int, x) -> None:
    """An ndarray (code 1) or numpy scalar (code 3) ext object; the array's
    bytes go to ``out`` as they are, uncopied."""
    shape, name, data = _leaf(x)
    pieces: list = []
    _head(pieces.append, 0x90, (None, 0xdc, 0xdd), 3, 15)
    _head(pieces.append, 0x90, (None, 0xdc, 0xdd), len(shape), 15)
    for s in shape:
        _int(pieces.append, int(s))
    _pack(pieces.append, name)
    pieces.append(_bin_head(data.nbytes))
    head = b"".join(pieces)
    n = len(head) + data.nbytes
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out(bytes([fixed[n], code]))
    elif n < 1 << 8:
        out(struct.pack(">BBB", 0xc7, n, code))
    elif n < 1 << 16:
        out(struct.pack(">BHB", 0xc8, n, code))
    else:
        out(struct.pack(">BIB", 0xc9, n, code))
    out(head)
    out(data)


def _chunked(x):
    """``x`` in flax's chunked form when it is above ``MAX_CHUNK_SIZE``
    bytes, else ``x``."""
    itemsize = x.element_size() if torch.is_tensor(x) else x.dtype.itemsize
    count = x.numel() if torch.is_tensor(x) else x.size
    if count * itemsize <= MAX_CHUNK_SIZE:
        return x
    flat = x.reshape(-1)
    step = max(1, MAX_CHUNK_SIZE // itemsize)
    chunks = [flat[i:i + step] for i in range(0, count, step)]
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out, v) -> None:
    if v is None:
        out(b"\xc0")
    elif v is True or v is False:
        out(b"\xc3" if v else b"\xc2")
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        c = _chunked(v)
        if isinstance(c, dict):
            _pack(out, c)
        else:
            _ext_array(out, _EXT_NDARRAY, v)
    elif isinstance(v, np.generic):
        _ext_array(out, _EXT_NPSCALAR, np.asarray(v))
    elif type(v) is int:
        _int(out, v)
    elif type(v) is float:
        out(struct.pack(">Bd", 0xcb, v))
    elif type(v) is str:
        data = v.encode("utf-8")
        _head(out, 0xa0, (0xd9, 0xda, 0xdb), len(data), 31)
        out(data)
    elif isinstance(v, (bytes, bytearray)):
        out(_bin_head(len(v)))
        out(bytes(v))
    elif isinstance(v, dict):
        _head(out, 0x80, (None, 0xde, 0xdf), len(v), 15)
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, (list, tuple)):
        _head(out, 0x90, (None, 0xdc, 0xdd), len(v), 15)
        for x in v:
            _pack(out, x)
    else:
        raise TypeError(f"cannot write {type(v).__name__} as flax msgpack")


def dumps(tree) -> bytes:
    """A tree of dicts, lists, Python scalars, numpy arrays and scalars and
    tensors → flax msgpack bytes (arrays above ``MAX_CHUNK_SIZE`` bytes
    chunked as flax chunks them)."""
    out: list = []
    _pack(out.append, tree)
    return b"".join(out)


def write(path: str, tree) -> None:
    """The msgpack of ``tree`` to ``path``, streamed (no array is copied
    into one big buffer), through a temporary file and a rename."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        _pack(f.write, tree)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
