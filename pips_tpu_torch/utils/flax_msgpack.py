"""Reader of the JAX package's checkpoints: the ``model-%09d.msgpack`` files
that ``pips_tpu/utils/saverloader.py`` writes with
``flax.serialization.to_bytes`` (a train state ``{step, params, opt_state}``,
or a bare variables tree ``{"params": ...}``).

It decodes the part of msgpack that flax writes, with no ``msgpack`` package:
maps, arrays, str, bin, ints, floats, bool and nil, and flax's extension
types

* 1, an ndarray: a packed ``(shape, dtype name, C-order bytes)``;
* 2, a complex number: a packed ``(real, imag)``;
* 3, a numpy scalar, packed as a 0-d ndarray.

Maps become dicts, msgpack arrays lists, ndarrays and numpy scalars CPU
tensors of the dtype the file names (``bfloat16`` too, from its raw bytes;
numpy scalars 0-d). Arrays that flax split into chunks
(``__msgpack_chunked_array__``) are put back together as
``flax.serialization.msgpack_restore`` does. Bytes that are not such a
document raise ``DecodeError``.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Optional

import torch

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_PATTERN = re.compile(r"model-(\d{9})\.msgpack$")

_DTYPES = {name: getattr(torch, name) for name in (
    "float16", "bfloat16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8",
    "uint16", "uint32", "uint64", "complex64", "complex128")}
_DTYPES["bool"] = torch.bool


class DecodeError(ValueError):
    """The bytes are not a msgpack document of the kind flax writes."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise DecodeError(f"truncated: wanted {n} bytes at offset {self.pos} of "
                              f"{len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _LENGTHS:
            kind, fmt = _LENGTHS[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise DecodeError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack value")

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError(f"a str at offset {self.pos - n} is not UTF-8") from e

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload).reshape(())
        if code == EXT_COMPLEX:
            real, imag = _document(payload)
            return complex(real, imag)
        raise DecodeError(f"msgpack extension type {code} is none of flax's (1, 2, 3)")


# length-prefixed types: first byte -> (kind, length format)
_LENGTHS = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _document(data: bytes) -> Any:
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise DecodeError(f"{len(reader.data) - reader.pos} bytes after the document's end")
    return out


def _ndarray(payload: bytes) -> torch.Tensor:
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes)."""
    try:
        shape, name, buf = _document(payload)
    except (TypeError, ValueError) as e:  # not a 3-element array
        raise DecodeError(f"an ndarray payload is not (shape, dtype, bytes): {e}") from e
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _DTYPES:
        raise DecodeError(f"unsupported array dtype {name!r}")
    dtype = _DTYPES[name]
    shape = tuple(int(d) for d in shape)
    count = 1
    for d in shape:
        count *= d
    if len(buf) != count * dtype.itemsize:
        raise DecodeError(f"a {name} array of shape {shape} holds {len(buf)} bytes")
    if not count:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(buf), dtype=dtype).reshape(shape)


def _unchunk(d: dict) -> torch.Tensor:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_leaves(d: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: the top level and every
    nested dict, not lists."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def restore(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore(data)`` gives, with
    every array and numpy scalar a CPU tensor."""
    return _unchunk_leaves(_document(data))


def ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"model-{step:09d}.msgpack")


def list_steps(ckpt_dir: str) -> list[int]:
    """The steps of the JAX checkpoints in ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_PATTERN.match, os.listdir(ckpt_dir)) if m)


def load_raw(ckpt_dir: str, step: Optional[int] = None) -> tuple[Any, int]:
    """The tree at the largest (or the given) step of ``ckpt_dir``, as the JAX
    package's ``saverloader.load_raw`` gives it. Returns (tree, step); raises
    ``FileNotFoundError`` if no checkpoint exists."""
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no model-*.msgpack checkpoint found in {ckpt_dir}")
    step = step if step is not None else steps[-1]
    with open(ckpt_path(ckpt_dir, step), "rb") as f:
        return restore(f.read()), step
