"""The JAX package's checkpoint format, read and written without flax.

``kstar_tpu/train/state.py save_checkpoint`` writes
``flax.serialization.to_bytes`` of ``{"step", "params", "batch_stats",
"opt_state", "rng"}``: a msgpack map whose containers are maps with string
keys (tuples and lists as ``{"0": ..., "1": ...}``, namedtuples by field
name, an empty state as ``{}``) and whose arrays are msgpack extension
types:

  * type 1, an ndarray: the msgpack array ``(shape, dtype name, raw
    C-order bytes)`` packed inside the extension's payload;
  * type 3, a numpy scalar: the same payload for a 0-d array.

A leaf over ``MAX_CHUNK_SIZE`` bytes is stored as the map
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
{"0": <flat ndarray>, ...}}`` (flax's ``_chunk``).

This module decodes and encodes that subset of msgpack itself (maps,
arrays, str, bin, ints, floats, nil, bool, ext), so the port needs neither
flax nor the ``msgpack`` package. Dtype names map straight onto torch
dtypes, ``bfloat16`` and ``uint32`` (JAX's raw key data) included, so no
numpy extension dtype is needed either.

``read_flax_checkpoint`` returns the tree as nested dicts of CPU tensors
(a numpy scalar as a 0-d tensor; Python scalars, strings and lists as they
are), copying each leaf's bytes once out of the file's buffer.
``write_flax_checkpoint`` writes the bytes ``flax.serialization.to_bytes``
writes for the same tree. ``is_flax_checkpoint`` tells such a file from a
``torch.save`` one by its first byte.
"""

from __future__ import annotations

import os
import struct
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30          # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3

# the dtypes the JAX package's checkpoints hold: parameters, moments and
# statistics (f32, or bf16/f16 where stored so), step and counts (int32,
# int64), JAX's raw key data (uint32), masks (uint8, bool)
DTYPES = {
    "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int32": torch.int32, "int64": torch.int64, "uint32": torch.uint32,
    "uint8": torch.uint8, "bool": torch.bool,
}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

class _Array(NamedTuple):
    """An ndarray extension (type 1 or 3) not yet copied out of the buffer."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    data: memoryview


# msgpack type bytes past the fixed ranges -> the struct format of what
# follows them: a value, or the length of a str, bin, array, map or ext
_NIL_BOOL = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
            0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


class _Decoder:
    """msgpack values from a buffer, front to back. Bin payloads stay
    memoryviews into the buffer; ndarray extensions become ``_Array``."""

    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"flax checkpoint: truncated at byte {self.pos} (need {n})")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return self._list(b & 0x0F)
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if b in _NIL_BOOL:
            return _NIL_BOOL[b]
        if b in _NUMBERS:
            return self._unpack(_NUMBERS[b])
        if b in _STR:
            return self._str(self._unpack(_STR[b]))
        if b in _BIN:
            return self._take(self._unpack(_BIN[b]))
        if b in _ARRAY:
            return self._list(self._unpack(_ARRAY[b]))
        if b in _MAP:
            return self._map(self._unpack(_MAP[b]))
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b in _EXT:
            return self._ext(self._unpack(_EXT[b]))
        raise ValueError(f"flax checkpoint: unknown msgpack type byte {b:#04x} "
                         f"at byte {self.pos - 1}")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _list(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, n: int) -> _Array:
        code = self._unpack(">b")
        payload = self._take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"flax checkpoint: unsupported msgpack extension type {code}")
        shape, name, data = _Decoder(payload).value()
        if isinstance(name, memoryview):        # a raw (bin) dtype name
            name = str(name, "utf-8")
        if name not in DTYPES:
            raise ValueError(f"flax checkpoint: unsupported dtype {name!r}")
        dtype = DTYPES[name]
        if len(data) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
            raise ValueError(f"flax checkpoint: {len(data)} bytes for {name} {shape}")
        return _Array(tuple(shape), dtype, data)


def _tensor(arr: _Array) -> torch.Tensor:
    """One copy of the array's bytes into a tensor of its own."""
    out = torch.empty(arr.shape, dtype=arr.dtype)
    if out.numel():
        out.view(-1).view(torch.uint8).copy_(torch.frombuffer(arr.data, dtype=torch.uint8))
    return out


def _unchunk(node: dict) -> torch.Tensor:
    """flax's chunked form -> one tensor, each chunk copied once into it."""
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    out = torch.empty(shape, dtype=chunks[0].dtype)
    flat, at = out.view(-1).view(torch.uint8), 0
    for c in chunks:
        flat[at:at + len(c.data)].copy_(torch.frombuffer(c.data, dtype=torch.uint8))
        at += len(c.data)
    if at != flat.numel():
        raise ValueError(f"flax checkpoint: chunks of {at} bytes for shape {shape}")
    return out


def _materialize(node: Any) -> Any:
    if isinstance(node, dict):
        if node.get(CHUNKED) is True:
            return _unchunk(node)
        return {k: _materialize(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_materialize(v) for v in node]
    if isinstance(node, _Array):
        return _tensor(node)
    if isinstance(node, memoryview):
        return bytes(node)
    return node


def read_flax_checkpoint(path: str) -> dict:
    """A file ``flax.serialization.to_bytes`` (or ``write_flax_checkpoint``)
    wrote -> the tree as nested dicts of CPU tensors."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"flax checkpoint {path}: short read")
    dec = _Decoder(memoryview(buf))
    tree = dec.value()
    if dec.pos != len(buf):
        raise ValueError(f"flax checkpoint {path}: {len(buf) - dec.pos} bytes after the tree")
    return _materialize(tree)


def is_flax_checkpoint(path: str) -> bool:
    """True when the file starts with a msgpack map of one or more entries
    (a flax checkpoint), False for anything else: ``torch.save``'s zip
    starts ``PK\\x03\\x04`` and its legacy pickle ``0x80``, which as msgpack
    would be an empty map."""
    with open(path, "rb") as f:
        head = f.read(1)
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


# ---------------------------------------------------------------------------
# encoding (msgpack-python's packer rules, as flax calls it)
# ---------------------------------------------------------------------------

def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return struct.pack(">B", v)
    if -0x20 <= v < 0:
        return struct.pack(">b", v)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
                              (0, 0xFFFF, 0xCD, ">H"), (-0x8000, -1, 0xD1, ">h"),
                              (0, 0xFFFFFFFF, 0xCE, ">I"), (-0x80000000, -1, 0xD2, ">i"),
                              (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                              (-0x8000000000000000, -1, 0xD3, ">q")):
        if lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"flax checkpoint: integer {v} does not fit in 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes: Tuple[int, int, int]) -> bytes:
    """The header of a str/bin/array/map/ext of n elements."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"flax checkpoint: {n} elements or bytes do not fit in msgpack")


def _str_bytes(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB)) + raw


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6))


class _Leaf(NamedTuple):
    """An array to encode: its shape, dtype name and C-order bytes."""
    shape: Tuple[int, ...]
    name: str
    data: memoryview


def _leaf(x) -> _Leaf:
    """A tensor or numpy array (or numpy scalar) as a ``_Leaf``, its bytes
    viewed without a copy where it is contiguous."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in DTYPE_NAMES:
            raise ValueError(f"flax checkpoint: unsupported dtype {t.dtype}")
        return _Leaf(tuple(t.shape), DTYPE_NAMES[t.dtype],
                     memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    if a.dtype.name not in DTYPES:
        raise ValueError(f"flax checkpoint: unsupported dtype {a.dtype.name}")
    return _Leaf(a.shape, a.dtype.name, memoryview(a.reshape(-1).view(np.uint8)))


def _ext_parts(leaf: _Leaf, code: int) -> List:
    """An ndarray extension as byte pieces: the headers, then the array's
    own bytes as a view."""
    inner = (b"".join([_sized(len(leaf.shape), 0x90, 0x0F, (None, 0xDC, 0xDD))]
                      + [_int(int(s)) for s in leaf.shape])
             + _str_bytes(leaf.name) + _bin_header(len(leaf.data)))
    n = 1 + len(inner) + len(leaf.data)      # the payload: fixarray(3), then the three
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixext[n]]) if n in fixext
            else _sized(n, None, 0, (0xC7, 0xC8, 0xC9)))
    return [head + struct.pack(">b", code) + b"\x93" + inner, leaf.data]


def _encode(x, out: List, in_dict: bool = False) -> None:
    if isinstance(x, dict):
        out.append(_sized(len(x), 0x80, 0x0F, (None, 0xDE, 0xDF)))
        for k, v in x.items():
            if type(k) is not str:
                raise TypeError(f"flax checkpoint: map key {k!r} is not a str")
            out.append(_str_bytes(k))
            _encode(v, out, in_dict=True)
    elif x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        out.append(_str_bytes(x))
    elif type(x) is bytes:
        out.append(_bin_header(len(x)) + x)
    elif isinstance(x, _Leaf):
        out.extend(_ext_parts(x, EXT_NDARRAY))
    elif isinstance(x, np.generic):
        out.extend(_ext_parts(_leaf(x), EXT_NPSCALAR))
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        leaf = _leaf(x)
        if in_dict and len(leaf.data) > MAX_CHUNK_SIZE:
            _encode(_chunked(leaf), out)
        else:
            out.extend(_ext_parts(leaf, EXT_NDARRAY))
    else:
        raise TypeError(f"flax checkpoint: cannot encode {type(x).__name__}")


def _chunked(leaf: _Leaf) -> dict:
    """flax's ``_chunk``: flat pieces of ``MAX_CHUNK_SIZE // itemsize``
    elements each."""
    item = DTYPES[leaf.name].itemsize
    step = max(1, int(MAX_CHUNK_SIZE / item)) * item
    pieces = [leaf.data[a:a + step] for a in range(0, len(leaf.data), step)]
    return {CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(leaf.shape)},
            "chunks": {str(i): _Leaf((len(p) // item,), leaf.name, p)
                       for i, p in enumerate(pieces)}}


def write_flax_checkpoint(path: str, tree: dict) -> None:
    """Write ``tree`` (nested dicts with str keys; tensor, numpy or Python
    scalar leaves) as ``flax.serialization.to_bytes`` of the same tree
    would, array bytes straight from the tensors."""
    parts: List = []
    _encode(tree, parts)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.writelines(parts)
