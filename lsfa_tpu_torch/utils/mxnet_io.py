"""Pure-Python reader/writer for the MXNet NDArray ``.params`` format; a
copy of ``lsfa_tpu.utils.mxnet_io`` (numpy only), which the port cannot
import.

The reference checkpoints are flat dicts of ``arg:<name>`` / ``aux:<name>``
NDArrays written by ``mx.nd.save`` (lib/utils/save_model.py:11-25) and read
back by ``mx.nd.load`` (lib/utils/load_model.py:11-31). This module
implements that binary format without an MXNet dependency so the
reference's released weights can be imported directly.

Format (mxnet src/ndarray/ndarray.cc, dmlc-core serializers):

  file      := u64 kMXAPINDArrayListMagic(0x112) | u64 reserved(0)
               | vec<ndarray> | vec<string-keys>
  vec<T>    := u64 count | T*count
  string    := u64 len | bytes
  ndarray   := u32 magic?                       (legacy files omit it)
               [V2/V3: i32 stype (dense = 1)]
               shape | i32 dev_type | i32 dev_id | i32 type_flag | raw data
  shape     := u32 ndim | dims  (i64 each for V1+; u32 each for legacy,
               where the leading u32 read doubles as ndim)

Only dense (kDefaultStorage) arrays are supported — the reference never
saves sparse parameters. The reader views the file's bytes without
slicing them, so each array is copied once, out of one ``np.frombuffer``
(a flagship checkpoint is about 0.4 GB).
"""

from __future__ import annotations

import struct

import numpy as np

_LIST_MAGIC = 0x112
_NDARRAY_V1_MAGIC = 0xF993FAC8
_NDARRAY_V2_MAGIC = 0xF993FAC9
_NDARRAY_V3_MAGIC = 0xF993FACA
_MAGICS = (_NDARRAY_V1_MAGIC, _NDARRAY_V2_MAGIC, _NDARRAY_V3_MAGIC)

# MXNet type_flag -> numpy dtype (mshadow/base.h)
_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16,
           3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_DTYPE_FLAGS = {np.dtype(v): k for k, v in _DTYPES.items()}
_DENSE_STORAGE = 1  # kDefaultStorage


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> int:
        """Advance by n bytes; returns the offset they start at."""
        if self.pos + n > len(self.buf):
            raise ValueError("truncated .params file")
        self.pos += n
        return self.pos - n

    def unpack(self, fmt: str):
        return struct.unpack_from(fmt, self.buf, self.take(struct.calcsize(fmt)))

    def u32(self) -> int:
        return self.unpack("<I")[0]

    def i32(self) -> int:
        return self.unpack("<i")[0]

    def u64(self) -> int:
        return self.unpack("<Q")[0]

    def i64s(self, n: int):
        return self.unpack(f"<{n}q")

    def array(self, dt: np.dtype, n: int) -> np.ndarray:
        return np.frombuffer(self.buf, dtype=dt, count=n, offset=self.take(n * dt.itemsize))


def _read_ndarray(r: _Reader) -> np.ndarray:
    first = r.u32()
    if first in _MAGICS:
        if first in (_NDARRAY_V2_MAGIC, _NDARRAY_V3_MAGIC):
            stype = r.i32()
            if stype != _DENSE_STORAGE:
                raise NotImplementedError(f"sparse ndarray (stype={stype})")
        ndim = r.u32()
        shape = tuple(r.i64s(ndim))
    else:
        # legacy: `first` was the ndim of a u32 shape
        ndim = first
        shape = tuple(r.u32() for _ in range(ndim))
    r.i32()  # dev_type
    r.i32()  # dev_id
    type_flag = r.i32()
    dt = np.dtype(_DTYPES[type_flag])
    n = int(np.prod(shape)) if shape else 1
    return r.array(dt, n).reshape(shape).copy()


def load_params(path: str) -> dict[str, np.ndarray]:
    """Read a .params file -> {name: array} (names keep arg:/aux: prefixes)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.u64() != _LIST_MAGIC:
        raise ValueError(f"{path}: not an MXNet NDArray file")
    r.u64()  # reserved
    arrays = [_read_ndarray(r) for _ in range(r.u64())]
    names = []
    for _ in range(r.u64()):
        n = r.u64()
        names.append(bytes(r.buf[r.take(n):r.pos]).decode("utf-8"))
    if len(names) != len(arrays):
        raise ValueError(f"{path}: {len(names)} names vs {len(arrays)} arrays")
    return dict(zip(names, arrays))


def split_arg_aux(raw: dict[str, np.ndarray]):
    """arg:/aux:-prefixed dict -> (arg_params, aux_params), the reference's
    load_checkpoint split (lib/utils/load_model.py:22-31)."""
    arg, aux = {}, {}
    for k, v in raw.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg[name] = v
        elif tp == "aux":
            aux[name] = v
        else:  # un-prefixed entries load as args (mx.nd.load semantics)
            arg[k] = v
    return arg, aux


def save_params(path: str, named: dict[str, np.ndarray]):
    """Write {name: array} in MXNet V2 dense format (test fixtures +
    exporting our checkpoints back to the reference toolchain)."""
    out = bytearray()
    out += struct.pack("<QQ", _LIST_MAGIC, 0)
    items = list(named.items())
    out += struct.pack("<Q", len(items))
    for _, arr in items:
        a = np.ascontiguousarray(arr)
        if a.dtype not in _DTYPE_FLAGS:
            raise TypeError(f"unsupported dtype {a.dtype}")
        out += struct.pack("<I", _NDARRAY_V2_MAGIC)
        out += struct.pack("<i", _DENSE_STORAGE)
        out += struct.pack("<I", a.ndim)
        out += struct.pack(f"<{a.ndim}q", *a.shape)
        out += struct.pack("<ii", 1, 0)  # cpu(0)
        out += struct.pack("<i", _DTYPE_FLAGS[a.dtype])
        out += a.tobytes()
    out += struct.pack("<Q", len(items))
    for name, _ in items:
        b = name.encode("utf-8")
        out += struct.pack("<Q", len(b)) + b
    with open(path, "wb") as f:
        f.write(out)
