"""The host C++ exact kNN (port of lemon_tpu/knn/cpp_backend.py).

``csrc/exact_knn.cc`` (the JAX package's source, copied) is compiled with
``g++`` at first use, never at import, into ``build/lemon_tpu_torch/`` at
the checkout root, keyed by a hash of the source, the flags (the JAX
package's, ``-march=native`` among them) and the host's CPU model. A build that fails raises. It is exact search for
embeddings held in host memory and an oracle for the device search, that
shares no code with it (FAISS semantics: 'ip' descending, 'l2' ascending
squared distances, ties to the lower index, padding slots ``-inf``/``+inf``
with index ``len(xb)``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "exact_knn.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lemon_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-shared", "-fPIC", "-std=c++17")


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` builds for it, so a
    build directory shared by hosts keeps one library each."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_cpu_model().encode())
    return BUILD_ROOT / f"exact_knn_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The kNN library, compiled on first use; raises if it cannot be."""
    out = library_path()
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("host C++ kNN: g++ not found on PATH")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host C++ kNN: g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.exact_knn_search.argtypes = [
        f32, ctypes.c_int64, f32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, f32, i32,
    ]
    lib.exact_knn_search.restype = None
    lib.pair_distance.argtypes = [f32, f32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, f32]
    lib.pair_distance.restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads here (for a test's skip; the
    index's ``backend="cpp"`` calls :func:`library` and raises)."""
    try:
        library()
        return True
    except (OSError, RuntimeError):
        return False


def search(xb: np.ndarray, xq: np.ndarray, k: int, metric: str = "ip") -> Tuple[np.ndarray, np.ndarray]:
    """FAISS-compatible exact search on the host: (scores, indices), both
    (len(xq), k). ``k > len(xb)`` pads the tail slots with ``-inf`` ('ip';
    ``+inf`` for 'l2') and index ``len(xb)``."""
    if metric not in ("ip", "l2"):
        raise ValueError(metric)
    xb = np.ascontiguousarray(xb, np.float32)
    xq = np.ascontiguousarray(xq, np.float32)
    if xb.ndim != 2 or xq.ndim != 2 or xb.shape[1] != xq.shape[1] or k < 1:
        raise ValueError(f"search of {xq.shape} queries in {xb.shape} rows with k={k}")
    scores = np.empty((len(xq), k), np.float32)
    idx = np.empty((len(xq), k), np.int32)
    library().exact_knn_search(xb, len(xb), xq, len(xq), xb.shape[1], k, 0 if metric == "ip" else 1, scores, idx)
    return scores, idx


def pair_distances(a: np.ndarray, b: np.ndarray, metric: str = "cosine") -> np.ndarray:
    """The distance of each row of ``a`` to the same row of ``b``: 1 - cosine
    ('cosine') or the squared L2 distance, summed in float64."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if a.shape != b.shape or a.ndim != 2:  # the C function reads len(a) rows of both
        raise ValueError(f"pair_distances of {a.shape} and {b.shape}")
    out = np.empty(len(a), np.float32)
    library().pair_distance(a, b, len(a), a.shape[1], 0 if metric == "cosine" else 1, out)
    return out
