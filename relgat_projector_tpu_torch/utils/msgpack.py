"""A reader for the JAX package's msgpack checkpoints, in pure Python.

The JAX package writes ``relgat-model.msgpack`` and ``train-state.msgpack``
with ``flax.serialization.to_bytes``. This module reads exactly what that
emits (flax 0.12's ``serialization.py``), without flax or msgpack:

- msgpack nil, bool, int (fixint, negative fixint, 8- to 64-bit signed
  and unsigned), float32/64, str, bin, arrays and maps, with 8-, 16- and
  32-bit length headers;
- ext type 1 (``ndarray``) and ext type 3 (``npscalar``), in any of the
  ext formats (fixext 1/2/4/8/16, ext 8/16/32): a nested msgpack array of
  (shape, dtype name, C-order little-endian bytes). Each becomes a CPU
  tensor of that type, a scalar a 0-d tensor (``"float16"`` a
  ``torch.float16`` one). ``"bfloat16"``, which numpy does not know, is
  read as ``uint16`` and viewed as ``torch.bfloat16``, so it comes across
  bit for bit;
- the ``__msgpack_chunked_array__`` dicts that flax writes for leaves above
  ``MAX_CHUNK_SIZE`` (2^30 bytes), joined back into one tensor.

Flax stores lists as dicts keyed ``"0"``, ``"1"``, ...; ``from_bytes``
rebuilds them from a template tree, as flax's ``from_bytes`` does. Anything
else (another ext type, a reserved byte, a truncated or trailing buffer)
raises ``ValueError`` naming the byte offset.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"

# (format byte) -> (struct code, byte count) of the fixed-width numbers
_NUMBERS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# (format byte) -> byte count of the length header
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def fail(self, what: str, at: int) -> None:
        raise ValueError(f"msgpack: {what} at byte {at}")

    def take(self, n: int) -> memoryview:
        start = self.pos
        if start + n > len(self.data):
            self.fail(f"{n} bytes wanted, {len(self.data) - start} left",
                      start)
        self.pos = start + n
        return self.data[start:start + n]

    def uint(self, n: int) -> int:
        return struct.unpack(_UINT[n], self.take(n))[0]

    def read(self) -> Any:
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.read_str(b & 0x1F, at)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _NUMBERS:
            code, n = _NUMBERS[b]
            return struct.unpack(code, self.take(n))[0]
        if b in _BIN:
            return bytes(self.take(self.uint(_BIN[b])))
        if b in _STR:
            return self.read_str(self.uint(_STR[b]), at)
        if b in _ARRAY:
            return [self.read() for _ in range(self.uint(_ARRAY[b]))]
        if b in _MAP:
            return self.read_map(self.uint(_MAP[b]))
        if b in _FIXEXT:
            return self.read_ext(_FIXEXT[b], at)
        if b in _EXT:
            return self.read_ext(self.uint(_EXT[b]), at)
        self.fail(f"reserved format byte 0x{b:02x}", at)

    def read_str(self, n: int, at: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError:
            self.fail("a str that is not UTF-8", at)

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_ext(self, n: int, at: int) -> torch.Tensor:
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            self.fail(f"ext type {code}, not an ndarray (1) or npscalar (3)",
                      at)
        try:
            return _ndarray(payload)
        except ValueError as exc:
            self.fail(f"bad ndarray ({exc})", at)


def _ndarray(payload: memoryview) -> torch.Tensor:
    """A CPU tensor from flax's ``(shape, dtype name, C-order bytes)``."""
    inner = _Reader(payload)
    tpl = inner.read()
    if inner.pos != len(payload):
        raise ValueError("trailing bytes in the ndarray payload")
    if not (isinstance(tpl, list) and len(tpl) == 3):
        raise ValueError(f"expected (shape, dtype, bytes), got {tpl!r:.80}")
    shape, name, buf = tpl
    if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0
                                            for d in shape)):
        raise ValueError(f"shape {shape!r}")
    if not isinstance(name, str) or not isinstance(buf, bytes):
        raise ValueError(f"dtype {name!r} with a {type(buf).__name__} buffer")
    bf16 = name == "bfloat16"
    try:
        dtype = np.dtype(np.uint16 if bf16 else name).newbyteorder("<")
    except TypeError:
        raise ValueError(f"unknown dtype {name!r}") from None
    if dtype.hasobject or dtype.fields is not None:
        raise ValueError(f"unsupported dtype {name!r}")
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != len(buf):
        raise ValueError(f"{len(buf)} bytes for shape {shape} of {name}")
    arr = np.frombuffer(buf, dtype=dtype).astype(dtype.newbyteorder("="))
    out = torch.from_numpy(arr.reshape(shape))
    return out.view(torch.bfloat16) if bf16 else out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills ``data`` exactly."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        reader.fail(f"{len(reader.data) - reader.pos} trailing bytes",
                    reader.pos)
    return out


def _unchunk(d: Any) -> Any:
    """Join flax's chunked leaves back into tensors, in dicts of dicts."""
    if not isinstance(d, dict):
        return d
    if d.get(_CHUNKED) is True:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return torch.cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in d.items()}


def msgpack_restore(data: bytes) -> Any:
    """The state dict that ``flax.serialization.to_bytes`` wrote: dicts,
    Python scalars and CPU tensors, lists still keyed ``"0"``, ``"1"``..."""
    return _unchunk(unpackb(data))


def restore_like(template: Any, state: Any, path: Tuple[str, ...] = ()) -> Any:
    """``state`` in ``template``'s structure: a list of the template is the
    dict keyed ``"0"``..``"n-1"`` in ``state``; dict keys must match."""
    where = "/".join(path) or "the root"
    if isinstance(template, dict):
        if not isinstance(state, dict) or set(state) != set(template):
            got = sorted(state) if isinstance(state, dict) else type(state)
            raise ValueError(f"at {where}: keys {got}, expected "
                             f"{sorted(template)}")
        return {k: restore_like(template[k], state[k], path + (k,))
                for k in template}
    if isinstance(template, (list, tuple)):
        keys = [str(i) for i in range(len(template))]
        if not isinstance(state, dict) or sorted(state) != sorted(keys):
            raise ValueError(f"at {where}: expected a list of "
                             f"{len(template)} items")
        return type(template)(restore_like(t, state[k], path + (k,))
                              for t, k in zip(template, keys))
    return state


def from_bytes(template: Any, data: bytes) -> Any:
    """``flax.serialization.from_bytes`` for trees of dicts and lists."""
    return restore_like(template, msgpack_restore(data))
