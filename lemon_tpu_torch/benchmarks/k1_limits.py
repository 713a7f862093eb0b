"""Where K1's main loop waits on the card, at both of its piece counts
(``high``: two bf16 pieces, three products; ``highest``: three pieces, six
products). Four builds of ``ops/csrc/scoremax.cu``, each compiled alone
with ``nvcc -shared``:

- ``as_built``: the kernel as it is;
- ``no_loads``: the producer loads the ring once and then only arrives on
  each stage's barrier, so the consumers multiply stale tiles: the products
  and their shared-memory reads, without the loads from L2;
- ``one_product``: the loads as they are and ``hi.hi`` alone: the loads,
  nearly without the products;
- ``direct_store``: the consumers store s from registers (``__stcs`` of
  float2, as the cp.async kernel that ``high`` replaced did) instead of
  staging it for TMA stores: what the staged epilogue saves (the same
  outputs).

Each build is timed at both precisions as K1 (``scores_blockmax``) and as P3
(``block_maxima``, no store of s), ip at 8192x512 . 16000x512, in turns over
three rounds (the outputs of ``no_loads`` and ``one_product`` are not
scores). Prints the card and one JSON line, ``K1_LIMITS {...}``.

Run on the card: ``python3 -m lemon_tpu_torch.benchmarks.k1_limits``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

from lemon_tpu_torch.ops import _build

B, T, D = 8192, 16000, 512
ROUNDS = 3
PRECISIONS = ("high", "highest")

_LOADS = """          mbar_arrive_expect_tx(full(pos.stage), L::kStageBytes);
"""
_NO_LOADS = """          if (tile != blockIdx.x || kt >= STAGES) {  // the ring was loaded once: arrive without bytes
            mbar_arrive(full(pos.stage));
            pos.advance();
            continue;
          }
          mbar_arrive_expect_tx(full(pos.stage), L::kStageBytes);
"""
# the products after hi.hi: the two of both piece counts, then highest's three more
_SMALL_PRODUCTS = """        wgmma_m64n128k16(acc_x, q0, d1);  // hi.lo ('high'), hi.mid ('highest')
        wgmma_m64n128k16(acc_x, q1, d0);  // lo.hi, mid.hi
"""
_HIGHEST_PRODUCTS = """          wgmma_m64n128k16(acc_x, q0, d2);  // hi.lo
          wgmma_m64n128k16(acc_x, q1, d1);  // mid.mid
          wgmma_m64n128k16(acc_x, q2, d0);  // lo.hi
"""


# the staged epilogue, from its first line to the kernel's wait for its stores,
# and what stores s from registers in its place (through a pointer the maps carry)
_EPILOGUE = ("    const int col0 = tn * TN;\n", "  if (OUT != Out::kMaxOnly && lead) bulk_wait_all();\n")
_DIRECT_EPILOGUE = """    const int col0 = tn * TN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = tm * TM + cw * 64 + warp * 16 + g + 8 * h;
      const float qs = (L2 && gr < B) ? qsq[gr] : 0.f;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < TN / 8; ++i) {
        const int c = col0 + 8 * i + 2 * t;
        const float2 v = score_pair<L2>(acc[4 * i + 2 * h], acc_x[4 * i + 2 * h], acc[4 * i + 2 * h + 1],
                                        acc_x[4 * i + 2 * h + 1], qs, dbsq, c, start, n_valid);
        if (OUT != Out::kMaxOnly && gr < B)
          __stcs(reinterpret_cast<float2*>(maps.s_out + static_cast<long long>(gr) * T + c), v);
        m = fmaxf(m, fmaxf(v.x, v.y));
      }
      m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
      m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
      if (t == 0 && gr < B) bmax[bmax_at<OUT>(gr, tn, B, n_strips)] = m;
    }
  }
"""
_MAPS = ("  CUtensorMap s;\n};\n", "  CUtensorMap s;\n  float* s_out;\n};\n")
_HOST_MAPS = ("  SplitMaps maps;\n", "  SplitMaps maps;\n  maps.s_out = s;\n")


def variant_sources(src: str) -> dict:
    """{build: source of scoremax.cu}; raises if the kernel no longer has
    the lines a build edits."""
    for piece in (_LOADS, _SMALL_PRODUCTS, _HIGHEST_PRODUCTS, *_EPILOGUE, _MAPS[0], _HOST_MAPS[0]):
        if src.count(piece) != 1:
            raise ValueError(f"scoremax.cu no longer holds exactly one of:\n{piece}")
    head, rest = src.split(_EPILOGUE[0])
    tail = rest.split(_EPILOGUE[1])[1]
    direct = (head + _DIRECT_EPILOGUE + tail).replace(*_MAPS).replace(*_HOST_MAPS)
    return {"as_built": src, "no_loads": src.replace(_LOADS, _NO_LOADS),
            "one_product": src.replace(_SMALL_PRODUCTS, "").replace(_HIGHEST_PRODUCTS, ""),
            "direct_store": direct}


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

    device = require_cuda("k1_limits")
    print(device_line(), flush=True)
    libs = _build_variants(_build.BUILD_ROOT / "k1_limits")
    g = torch.Generator(device=device).manual_seed(0)
    q, db = (torch.nn.functional.normalize(torch.randn(n, D, generator=g, device=device), dim=1) for n in (B, T))
    library = _build.library
    times = {}
    try:
        for r in range(ROUNDS):
            for name in libs if r % 2 == 0 else list(libs)[::-1]:
                _build.library = lambda lib=libs[name]: lib  # the wrappers launch this build's kernels
                for p in PRECISIONS:
                    times.setdefault(f"K1 {p} {name}", []).append(
                        cuda_ms(lambda: scoremax.scores_blockmax(q, db, "ip", None, 0, None, p), 20))
                    times.setdefault(f"P3 {p} {name}", []).append(
                        cuda_ms(lambda: scoremax.block_maxima(q, db, p), 20))
    finally:
        _build.library = library
    print("K1_LIMITS " + json.dumps({"shape": [B, T, D], "ms": times}), flush=True)
    return times


if __name__ == "__main__":
    main()
