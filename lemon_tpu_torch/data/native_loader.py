"""The native row gather of :class:`~lemon_tpu_torch.data.streaming.ShardedUint8Store`
(port of lemon_tpu/data/native_loader.py:31-120).

``csrc/shard_gather.cc`` preads each requested row from its shard file on a
thread pool. It is compiled with ``g++`` at first use, never at import, into
``build/lemon_tpu_torch/`` at the checkout root, keyed by a hash of the
source and the flags. A build that fails raises: nothing falls back to the
memmap read, which a caller selects with ``gather="numpy"``.
``NativeShardGather.gathers`` counts the native gathers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "shard_gather.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lemon_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
N_THREADS = 8


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"shard_gather_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The gather library, compiled on first use; raises if it cannot be."""
    out = library_path()
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("native shard gather: g++ not found on PATH")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native shard gather: g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.shard_gather.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        i64p, i64p, i64p, ctypes.c_int64,
        i64p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]
    lib.shard_gather.restype = ctypes.c_int64
    return lib


def _npy_data_offset(path: Path) -> int:
    """Byte offset of the array data in a .npy file (format 1, 2 or 3)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic[:6] != b"\x93NUMPY":
            raise ValueError(f"{path}: not a .npy file")
        if magic[6] == 1:
            return 10 + int(np.frombuffer(f.read(2), "<u2")[0])
        return 12 + int(np.frombuffer(f.read(4), "<u4")[0])


class NativeShardGather:
    """Row gather over a ``ShardedUint8Store`` (its ``_paths``,
    ``_offsets`` and ``_row_shape``) through the native pread engine. Each
    ``.npy`` must be C-ordered, as ``ShardWriter`` writes it."""

    gathers = 0

    def __init__(self, store):
        self._lib = library()
        for p in store._paths:
            if not np.load(p, mmap_mode="r").flags["C_CONTIGUOUS"]:
                raise ValueError(f"{p}: a Fortran-ordered shard cannot be read row by row")
        self._paths = [str(p).encode() for p in store._paths]
        self._c_paths = (ctypes.c_char_p * len(self._paths))(*self._paths)
        offsets = np.asarray(store._offsets, np.int64)
        self._first_row = np.ascontiguousarray(offsets[:-1])
        self._rows = np.ascontiguousarray(np.diff(offsets))
        self._data_off = np.asarray([_npy_data_offset(Path(p)) for p in store._paths], np.int64)
        self._row_shape = tuple(store._row_shape)
        self._row_bytes = int(np.prod(self._row_shape))
        self._n = int(offsets[-1])

    def gather(self, idx) -> np.ndarray:
        """Rows ``idx`` (non-negative, below the store's length) as one
        uint8 array."""
        idx = np.ascontiguousarray(np.asarray(idx, np.int64).ravel())
        if idx.size and (idx.min() < 0 or idx.max() >= self._n):
            raise IndexError(f"index out of range for a store of {self._n} rows")
        out = np.empty((len(idx),) + self._row_shape, np.uint8)
        if len(idx) == 0:
            return out
        rc = self._lib.shard_gather(
            self._c_paths, len(self._paths), self._first_row, self._rows, self._data_off,
            self._row_bytes, idx, len(idx), out.reshape(len(idx), -1), N_THREADS,
        )
        if rc != 0:
            raise OSError(f"shard_gather failed (code {rc}: -1 a shard did not open, else the failed row + 1)")
        NativeShardGather.gathers += 1
        return out
