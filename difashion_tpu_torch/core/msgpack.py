"""flax's msgpack checkpoint format, both ways, without the msgpack or flax
packages (neither is installed beside the card).

The format (`flax.serialization.to_bytes` / `msgpack_restore`):
  * the tree is first made a state dict: dicts keep their (string) keys and
    order, lists and tuples become dicts keyed "0", "1", ..., namedtuples
    dicts keyed by their fields;
  * an array is msgpack ext type 1 whose data is itself msgpack: the array
    (shape, dtype name, row-major bytes), e.g. (("3", "4"), "float32", b"...");
    a numpy scalar is ext type 3 with the same payload and shape ();
  * an array of more than MAX_CHUNK_SIZE bytes is stored as the dict
    {"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
    "chunks": {"0": flat[0:n], ...}} of 1-D chunks of MAX_CHUNK_SIZE bytes;
  * everything else is plain msgpack (str keys, ints, floats as float64,
    bools, nil, bin), packed in the smallest encoding, as msgpack-python
    packs it.

`dump` / `packb` write that byte for byte (torch tensors, numpy arrays and
numpy scalars as leaves). `MappedFile` reads a file through mmaps: its
tree's array leaves are `Blob`s (offset, shape, dtype) that `tensor()` turns
into tensors over a map of just their bytes, without a copy, unmapped with
the tensor; so a 14 GB checkpoint is never held in memory twice, or at
once. `unpackb` decodes bytes into a tree of tensors (copies). The dtype
name "bfloat16" is read as int16 and viewed as torch.bfloat16.
"""
from __future__ import annotations

import io
import math
import mmap
import os
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30     # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_PAGE = mmap.PAGESIZE


# ---- encoding ------------------------------------------------------------------

def to_state_dict(tree) -> Any:
    """flax's `to_state_dict`: lists, tuples and namedtuples as dicts, with
    arrays past MAX_CHUNK_SIZE bytes chunked (`msgpack_serialize`)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            v = to_state_dict(v)
            out[str(k)] = _chunk(v) if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE else v
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return to_state_dict({f: getattr(tree, f) for f in tree._fields})
    if isinstance(tree, (list, tuple)):
        return to_state_dict({str(i): x for i, x in enumerate(tree)})
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(arr) -> dict:
    flat = arr.reshape(-1)
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    n = flat.shape[0]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _len_header(n: int, fix: int, fix_max: int, c8, c16: int, c32: int) -> bytes:
    """A str / bin / array / map length header in its smallest form."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    if c8 is not None and n <= 0xFF:
        return bytes([c8, n])
    if n <= 0xFFFF:
        return bytes([c16]) + struct.pack(">H", n)
    return bytes([c32]) + struct.pack(">I", n)


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if -0x80 <= n < 0:
        return b"\xd0" + struct.pack(">b", n)
    if 0xFF < n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if -0x8000 <= n < -0x80:
        return b"\xd1" + struct.pack(">h", n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    if -0x80000000 <= n < -0x8000:
        return b"\xd2" + struct.pack(">i", n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", n)
    if -0x8000000000000000 <= n < -0x80000000:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _len_header(len(b), 0xA0, 0x1F, 0xD9, 0xDA, 0xDB) + b


def _array_payload(arr) -> Tuple[bytes, memoryview]:
    """(header, raw bytes) of an array's inner msgpack (shape, dtype, data)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu", memory_format=torch.contiguous_format)
        name = _NAMES[t.dtype]
        raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else np.empty(0, np.uint8)
        shape = tuple(t.shape)
    else:
        a = np.asarray(arr, order="C")   # (ascontiguousarray makes 0-d arrays 1-d)
        name, shape = a.dtype.name, a.shape
        raw = a.reshape(-1).view(np.uint8)
    head = (b"\x93" + _len_header(len(shape), 0x90, 0x0F, None, 0xDC, 0xDD)
            + b"".join(_int(int(d)) for d in shape) + _str(name)
            + _len_header(raw.nbytes, None, 0, 0xC4, 0xC5, 0xC6))
    return head, memoryview(raw)


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    elif n <= 0xFF:
        head = bytes([0xC7, n])
    elif n <= 0xFFFF:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack("b", code)


def _pack(obj, f: BinaryIO) -> None:
    if obj is None:
        f.write(b"\xc0")
    elif obj is True:
        f.write(b"\xc3")
    elif obj is False:
        f.write(b"\xc2")
    elif isinstance(obj, dict):
        f.write(_len_header(len(obj), 0x80, 0x0F, None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, f)
            _pack(v, f)
    elif isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        code = EXT_NPSCALAR if isinstance(obj, np.generic) else EXT_NDARRAY
        head, raw = _array_payload(np.asarray(obj) if code == EXT_NPSCALAR else obj)
        f.write(_ext_header(code, len(head) + raw.nbytes))
        f.write(head)
        f.write(raw)
    elif isinstance(obj, int):
        f.write(_int(obj))
    elif isinstance(obj, float):
        f.write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        f.write(_str(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        f.write(_len_header(len(obj), None, 0, 0xC4, 0xC5, 0xC6))
        f.write(obj)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def dump(tree, f: BinaryIO) -> None:
    """Write `tree` to the binary file `f` as `flax.serialization.to_bytes`
    writes it, array by array (nothing is assembled in memory)."""
    _pack(to_state_dict(tree), f)


def packb(tree) -> bytes:
    buf = io.BytesIO()
    dump(tree, buf)
    return buf.getvalue()


# ---- decoding ------------------------------------------------------------------

@dataclass
class Blob:
    """An array in the file: its bytes at [offset, offset + nbytes)."""

    offset: int
    nbytes: int
    shape: Tuple[int, ...]
    dtype: str
    scalar: bool = False      # ext type 3 (a numpy scalar)


@dataclass
class Bin:
    """A msgpack bin value in the file: its bytes at [offset, offset + nbytes)."""

    offset: int
    nbytes: int


@dataclass
class Chunked:
    """A chunked array: its shape and its 1-D chunks in order."""

    shape: Tuple[int, ...]
    chunks: List[Blob]


class _Reader:
    def __init__(self, buf, base: int = 0):
        self.buf, self.pos, self.base = buf, 0, base

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lens:
            return str(self.take(self.unpack(lens[b])), "utf-8")
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in bins:
            n = self.unpack(bins[b])
            self.take(n)
            return Bin(self.base + self.pos - n, n)
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            n = fixext[b]
        elif b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        else:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        code = self.unpack("b")
        start = self.pos
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, raw = _Reader(data, self.base + start).obj()
        return Blob(raw.offset, raw.nbytes, tuple(int(d) for d in shape), name,
                    scalar=code == EXT_NPSCALAR)

    def array(self, n: int):
        return [self.obj() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if out.get(CHUNKED) is True:
            return Chunked(tuple(out["shape"][str(i)] for i in range(len(out["shape"]))),
                           [out["chunks"][str(i)] for i in range(len(out["chunks"]))])
        return out


def _dtype(blob: Blob) -> Tuple[torch.dtype, torch.dtype, int]:
    """(dtype, dtype read as, element count); bfloat16 is read as int16."""
    dtype = _DTYPES.get(blob.dtype)
    if dtype is None:
        raise ValueError(f"unsupported array dtype {blob.dtype!r}")
    read_as = torch.int16 if dtype == torch.bfloat16 else dtype
    count = math.prod(blob.shape)
    need = count * torch.empty((), dtype=read_as).element_size()
    if need != blob.nbytes:
        raise ValueError(f"array of shape {blob.shape} in {blob.dtype} needs {need} bytes, "
                         f"the file holds {blob.nbytes}")
    return dtype, read_as, count


def _blob_tensor(buf, blob: Blob, base: int = 0) -> torch.Tensor:
    """The blob as a tensor over `buf` (which starts at file offset `base`)."""
    dtype, read_as, count = _dtype(blob)
    if count == 0:
        return torch.empty(blob.shape, dtype=dtype)
    t = torch.frombuffer(buf, dtype=read_as, count=count, offset=blob.offset - base)
    return t.view(dtype).reshape(blob.shape)


class MappedFile:
    """A flax msgpack file read through mmaps. `tree` is the decoded tree,
    with `Blob` / `Chunked` leaves (the structure is parsed from one map of
    the file, unmapped again at once). `tensor(leaf)` maps that array's own
    window of the file (a private map: no copy until the tensor is copied
    elsewhere) and returns a tensor over it; the window is unmapped when the
    last tensor over it is freed. So reading a file leaf by leaf keeps about
    one leaf's pages mapped, whatever the file's size."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        size = os.fstat(self._f.fileno()).st_size
        mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ) if size else b""
        view = memoryview(mm)
        try:
            self.tree = _Reader(view).obj()
        finally:
            view.release()
            if size:
                mm.close()

    def tensor(self, leaf) -> torch.Tensor:
        """The leaf as a tensor over its mapped bytes (a chunked array is
        concatenated: a copy)."""
        if isinstance(leaf, Chunked):
            return torch.cat([self.tensor(c) for c in leaf.chunks]).reshape(leaf.shape)
        if leaf.nbytes == 0:
            return _blob_tensor(b"", leaf)
        start = leaf.offset // mmap.ALLOCATIONGRANULARITY * mmap.ALLOCATIONGRANULARITY
        window = mmap.mmap(self._f.fileno(), leaf.offset + leaf.nbytes - start,
                           access=mmap.ACCESS_COPY, offset=start)
        return _blob_tensor(window, leaf, base=start)

    def close(self) -> None:
        """Close the file; tensors already made keep their windows."""
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def unpackb(data: bytes):
    """Decode bytes into a tree of dicts with tensors (copies) as leaves."""
    buf = bytearray(data)
    reader = _Reader(memoryview(buf))
    tree = reader.obj()

    def materialize(x):
        if isinstance(x, dict):
            return {k: materialize(v) for k, v in x.items()}
        if isinstance(x, Chunked):
            return torch.cat([materialize(c) for c in x.chunks]).reshape(x.shape)
        if isinstance(x, Blob):
            return _blob_tensor(buf, x).clone()
        if isinstance(x, Bin):
            return bytes(buf[x.offset:x.offset + x.nbytes])
        if isinstance(x, list):
            return [materialize(v) for v in x]
        return x

    return materialize(tree)
