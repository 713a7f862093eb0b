"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
    nvcc -shared

The library goes to ``build/lemon_tpu_torch/<hash>/`` at the checkout root,
keyed by a hash of the sources (``*.cu`` and ``*.cuh``), the flags and what
``nvcc --version`` prints, so an edited kernel or another toolkit rebuilds
and an unchanged one loads. The build happens at first
use, never at import: the CPU tests import every module on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lemon_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # x, hi, lo, N, D, Dp, stream
    "lemon_split_bf16": [_P, _P, _P, _L, _I, _I, _P],
    # x, hi, mid, lo, N, D, Dp, stream
    "lemon_split_bf16x3": [_P, _P, _P, _P, _L, _I, _I, _P],
    # q0, q1, q2, db0, db1, db2, qsq, dbsq, s, bmax, B, T, Dp, start, n_valid, pieces, l2, out, stream
    "lemon_scores_blockmax": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _I, _P],
    # x, vals, idx, B, W, k, variant, stream
    "lemon_topk": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, cid, vals, ids, B, W, k, variant, stream
    "lemon_topk_colids": [_P, _P, _P, _P, _I, _I, _I, _P],
    # a, w, c, M, N, K, stream
    "lemon_matmul_int8": [_P, _P, _P, _I, _I, _I, _P],
    "lemon_matmul_bf16": [_P, _P, _P, _I, _I, _I, _P],
    # q, k, v, o, B, L, H, D, stride_b, stride_l, scale, causal, stream
    "lemon_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, ctypes.c_float, _I, _P],
    "lemon_flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, ctypes.c_float, _I, _P],
    # sb, block_ids, vals, idx, B, n_blocks, k, stream
    "lemon_gather_topk": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def nvcc_version() -> str:
    """What ``nvcc --version`` prints: the toolkit the library is built with."""
    return subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True).stdout


def library_path() -> Path:
    """Where the library for the current sources and toolkit lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "liblemon_kernels.so"


def _run_all(cmds):
    """Run the commands in parallel; (return codes, combined log)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(f"$ {' '.join(c)}\n{o}" for c, o in zip(cmds, outs))
    return [p.returncode for p in procs], log


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The kernel library, compiled on first use. ``build_log()`` has what
    ``nvcc -Xptxas -v`` printed (registers, shared memory, spills)."""
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        sources = sorted(CSRC.glob("*.cu"))
        objects = [out.with_name(f"{src.stem}.{tag}.o") for src in sources]
        t0 = time.perf_counter()
        codes, log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(sources, objects)])
        if not any(codes):
            tmp = out.with_name(f"{out.name}.{tag}")
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
            codes, link_log = _run_all([link])
            log += link_log
        out.with_suffix(".log").write_text(log)
        for o in objects:
            o.unlink(missing_ok=True)
        if any(codes):
            raise RuntimeError(f"nvcc failed ({codes}):\n{log}")
        os.replace(tmp, out)
        print(f"[lemon_tpu_torch] built {out} in {time.perf_counter() - t0:.1f} s", flush=True)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    path = library_path().with_suffix(".log")
    return path.read_text() if path.exists() else ""


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_handle(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
