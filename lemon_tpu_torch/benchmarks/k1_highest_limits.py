"""Where K1 ``highest``'s main loop waits on the card. Three builds of
``ops/csrc/scoremax.cu``, each compiled alone with ``nvcc -shared``:

- ``as_built``: the kernel as it is;
- ``no_loads``: the producer loads the ring once and then only arrives on
  each stage's barrier, so the consumers multiply stale tiles: the products
  and their shared-memory reads, without the loads from L2;
- ``one_product``: the loads as they are and ``hi.hi`` alone, one of the six
  products: the loads, nearly without the products.

Each is timed as K1 (``scores_blockmax``) and as P3 (``block_maxima``, no
store of s), ip at 8192x512 . 16000x512, in turns over three rounds (the
builds' outputs other than ``as_built``'s are not scores). Prints the card
and one JSON line, ``K1_HIGHEST_LIMITS {...}``.

Run on the card: ``python3 -m lemon_tpu_torch.benchmarks.k1_highest_limits``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

from lemon_tpu_torch.ops import _build

B, T, D = 8192, 16000, 512
ROUNDS = 3

_LOADS = """          mbar_arrive_expect_tx(full(pos.stage), XSTAGE_BYTES);
"""
_NO_LOADS = """          if (tile != blockIdx.x || kt >= XSTAGES) {  // the ring was loaded once: arrive without bytes
            mbar_arrive(full(pos.stage));
            pos.advance();
            continue;
          }
          mbar_arrive_expect_tx(full(pos.stage), XSTAGE_BYTES);
"""
_SMALL_PRODUCTS = """        wgmma_m64n128k16(acc_x, qh, dm);
        wgmma_m64n128k16(acc_x, qm, dh);
        wgmma_m64n128k16(acc_x, qh, dl);
        wgmma_m64n128k16(acc_x, qm, dm);
        wgmma_m64n128k16(acc_x, ql, dh);
"""


def variant_sources(src: str) -> dict:
    """{build: source of scoremax.cu}; raises if the kernel no longer has
    the lines a build edits."""
    for piece in (_LOADS, _SMALL_PRODUCTS):
        if src.count(piece) != 1:
            raise ValueError(f"scoremax.cu no longer holds exactly one of:\n{piece}")
    return {"as_built": src, "no_loads": src.replace(_LOADS, _NO_LOADS),
            "one_product": src.replace(_SMALL_PRODUCTS, "")}


def _build_variants(out_dir: Path) -> dict:
    sources = variant_sources((_build.CSRC / "scoremax.cu").read_text())
    nvcc = _build._nvcc()
    procs = {}
    for name, src in sources.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
        (d / "scoremax.cu").write_text(src)
        procs[name] = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                                        str(d / "scoremax.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> dict:
    import torch

    from lemon_tpu_torch.benchmarks._timing import cuda_ms, device_line, require_cuda
    from lemon_tpu_torch.ops import scoremax

    device = require_cuda("k1_highest_limits")
    print(device_line(), flush=True)
    libs = _build_variants(_build.BUILD_ROOT / "k1_highest_limits")
    g = torch.Generator(device=device).manual_seed(0)
    q, db = (torch.nn.functional.normalize(torch.randn(n, D, generator=g, device=device), dim=1) for n in (B, T))
    library = _build.library
    times = {}
    try:
        for r in range(ROUNDS):
            for name in libs if r % 2 == 0 else list(libs)[::-1]:
                _build.library = lambda lib=libs[name]: lib  # the wrappers launch this build's kernels
                times.setdefault(f"K1 {name}", []).append(
                    cuda_ms(lambda: scoremax.scores_blockmax(q, db, "ip", None, 0, None, "highest"), 20))
                times.setdefault(f"P3 {name}", []).append(cuda_ms(lambda: scoremax.block_maxima(q, db, "highest"), 20))
    finally:
        _build.library = library
    print("K1_HIGHEST_LIMITS " + json.dumps({"shape": [B, T, D], "ms": times}), flush=True)
    return times


if __name__ == "__main__":
    main()
