"""Where the selects of K2, P1 and K4 spend their time on the card
(``ops/csrc/select_rows.cuh``, launched by ``topk.cu`` and ``select.cu``).
More builds of those two files, each compiled alone with ``nvcc -shared``
and one compile-time switch of the selects.

The block select (K2's radix variant, P1, K4 at k > 8), by default:

- ``stage``: ``-DLEMON_SELECT_STOP=1``, each row staged (bulk copies, or
  plain loads where a bulk copy cannot take the row) and nothing selected;
- ``histogram``: ``-DLEMON_SELECT_STOP=2``, the staging, the first digit's
  histogram over the row and its scan;
- ``filter``: ``-DLEMON_SELECT_STOP=3``, all that and the filter (the
  second pass over the row), without ordering the list and the winners;
- ``counted``: ``-DLEMON_SELECT_COUNT``, the select as built with a device
  counter of its passes over whole rows (histograms and filters);

timed beside the library as built (``as_built``, ``_build.library()``) in
turns over ``ROUNDS`` rounds, at (8192, 6528) k=51 as K2 (variant
``radix``), as P1 (``topk_colids``) and, over 8192 x 1024 blocks of 128, as
K4 (``fused_gather_topk``) at k=51, on tie-heavy rows (multiples of 1/4 in
[0, 10), chip_smoke's) and on Gaussian rows. The counted build's passes
on the first ``CHECK_ROWS`` rows are held to
``ops.topk.select_rounds_plain``'s on the same rows.

``--parent DIR`` (an older checkout whose select is the threshold select,
``threshold()`` and ``select_top_k()`` in its ``select_rows.cuh``) builds
that tree's two files four times, as they are and with ``stage``,
``histogram`` and ``counted`` put in by textual edits (raises if its source no longer holds the
lines they edit), times both trees' builds in the same turns, and then
times both trees as built at every radix shape of chip_smoke's K2 (radix
forced), P1 and K4 k=51.

The warp select (K2's warp variant, P1 on narrow rows, K4 at k <= 8),
``--warp``: the same switches cut the warp select off at

- ``loads``: ``-DLEMON_SELECT_STOP=1``, each row loaded into registers as
  keys and nothing selected;
- ``first_max``: ``-DLEMON_SELECT_STOP=2``, the loads and the warp's
  first max (each lane's maximum, then the warp's);
- ``list``: ``-DLEMON_SELECT_STOP=3``, all that, the k-th largest lane
  maximum and the list of the entries at or above it, unranked;

timed beside the library as built, device only (one replay of a CUDA graph
of 20 calls) and by events around 20 calls, in turns over ``ROUNDS`` rounds
at chip_smoke's warp shapes (``WARP_SHAPES``: phase 4's K2 rows with the
variant forced to ``warp``, phase 8's K4 k=5 over 1024 blocks), on
tie-heavy and on Gaussian rows. With ``--parent DIR`` the older tree's
library as built (its warp kernels) is timed in the same turns, and at the
crossover rows (``CROSSOVER``, tie-heavy) this tree's warp and radix
variants and the older tree's warp variant.

Either way it prints the card and one JSON line, ``SELECT_LIMITS {...}``.
Run on the card: ``python3 -m lemon_tpu_torch.benchmarks.select_limits
[--warp] [--parent DIR]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

from lemon_tpu_torch.ops import _build

B, W, K, N_BLOCKS = 8192, 6528, 51, 1024
ROUNDS = 3
CHECK_ROWS = 1024  # rows whose passes are held to the plain restatement's
ROWS = ("ties", "gaussian")
BUILDS = {"stage": ("-DLEMON_SELECT_STOP=1",), "histogram": ("-DLEMON_SELECT_STOP=2",),
          "filter": ("-DLEMON_SELECT_STOP=3",), "counted": ("-DLEMON_SELECT_COUNT",)}
# (W, k) of the radix variant that chip_smoke holds (phase 4): the paper's
# --knn_k grid at 20000 B/32 pairs (a 16000-row tile) and the wide-k rows
RADIX_SHAPES = ((6528, 51), (1408, 11), (16000, 51), (1024, 200), (125, 31), (3968, 31))
_PASSES = ("lemon_topk_row_passes", "lemon_gather_topk_row_passes")  # the counted builds' device counters
WARP_BUILDS = {"loads": ("-DLEMON_SELECT_STOP=1",), "first_max": ("-DLEMON_SELECT_STOP=2",),
               "list": ("-DLEMON_SELECT_STOP=3",)}
# chip_smoke's warp shapes: phase 4's K2 rows of W <= 1024 (the main path's
# block maxima and candidates at --knn_k 5 first), phase 8's K4 at k=5
WARP_SHAPES = (("K2", 125, 6), ("K2", 768, 6), ("K2", 640, 5), ("K2", 125, 31), ("K2", 1024, 200),
               ("K4", N_BLOCKS, 5))
# (W, k) of chip_smoke's K2_CROSSOVER within the warp variant's reach (tie-heavy rows)
CROSSOVER = ((1024, 16), (1024, 32), (640, 51), (1024, 96), (1024, 200))

_COUNTER = """#ifndef LEMON_SELECT_STOP
#define LEMON_SELECT_STOP 0
#endif
#ifdef LEMON_SELECT_COUNT
static __device__ unsigned long long row_passes;
#endif
"""
_EXPORT = """
#ifdef LEMON_SELECT_COUNT
extern "C" unsigned long long {name}() {{
  unsigned long long n = 0;
  const unsigned long long zero = 0;
  cudaMemcpyFromSymbol(&n, lemon_select::row_passes, sizeof n);
  cudaMemcpyToSymbol(lemon_select::row_passes, &zero, sizeof zero);
  return n;
}}
#endif
"""
# the threshold select (select_rows.cuh until this probe's select replaced
# it): where each switch goes, as (file, line, the line and what follows it)
_PARENT_EDITS = (
    ("select_rows.cuh", "namespace lemon_select {\n", "namespace lemon_select {\n" + _COUNTER),
    ("select_rows.cuh", "    const unsigned n = n_listed ? n_listed : W;\n",
     "    const unsigned n = n_listed ? n_listed : W;\n#ifdef LEMON_SELECT_COUNT\n"
     "    if (threadIdx.x == 0 && n_listed == 0) atomicAdd(&row_passes, 1ull);\n#endif\n"),
    ("select_rows.cuh", "    if (sm.done) break;\n  }\n  return pre;",
     "    if (sm.done || LEMON_SELECT_STOP == 2) break;\n  }\n  return pre;"),
    ("select_rows.cuh", "    const unsigned long long thr = threshold<THREADS>(key_at, W, done_out + n, sm);\n",
     "    const unsigned long long thr = threshold<THREADS>(key_at, W, done_out + n, sm);\n"
     "    if (LEMON_SELECT_STOP == 2) return;\n#ifdef LEMON_SELECT_COUNT\n"
     "    if (threadIdx.x == 0) atomicAdd(&row_passes, 1ull);  // the collect\n#endif\n"),
    ("topk.cu", "    __syncthreads();\n  }\n  const float* row = STAGED ? staged : xr;\n",
     "    __syncthreads();\n  }\n  if (LEMON_SELECT_STOP == 1) {\n    if (threadIdx.x == 0) vals[r * k] = staged[W - 1];\n"
     "    return;\n  }\n  const float* row = STAGED ? staged : xr;\n"),
    ("select.cu", "  __syncthreads();\n  lemon_select::select_top_k<THREADS, MAX_K>(",
     "  __syncthreads();\n  if (LEMON_SELECT_STOP == 1) {\n    if (threadIdx.x == 0) vals[r * k] = cand[w - 1];\n"
     "    return;\n  }\n  lemon_select::select_top_k<THREADS, MAX_K>("),
)


def tree_sources(csrc: Path) -> dict:
    """{file: source} of a tree's select, with the switches put into an
    older tree's threshold select; raises if that tree lacks an edited line."""
    files = {name: (csrc / name).read_text() for name in ("select_rows.cuh", "hopper.cuh", "topk.cu", "select.cu")
             if (csrc / name).exists()}
    if "block_select" in files["select_rows.cuh"]:
        return files
    for name, old, new in _PARENT_EDITS:
        if files[name].count(old) != 1:
            raise ValueError(f"{csrc / name} no longer holds exactly one of:\n{old}")
        files[name] = files[name].replace(old, new)
    for name, fn in (("topk.cu", "lemon_topk_row_passes"), ("select.cu", "lemon_gather_topk_row_passes")):
        files[name] += _EXPORT.format(name=fn)
    return files


def build_all(plan: dict, out_dir: Path) -> dict:
    """{(tree, build): CDLL} for plan {(tree, build): (that tree's csrc,
    nvcc flags)}, compiled in parallel."""
    nvcc = _build._nvcc()
    procs = {}
    for (tree, name), (csrc, flags) in plan.items():
        files = tree_sources(csrc)
        d = out_dir / tree / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(d / "lib.so"), str(d / "topk.cu"),
               str(d / "select.cu")]
        procs[(tree, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for key, (proc, d) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        for fn in _PASSES:
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = []
                getattr(lib, fn).restype = ctypes.c_ulonglong
        libs[key] = lib
    return libs


def inputs(torch, rows: str, device):
    """x (B, W), its ids cid (sorted blocks x 128 + lane), and K4's scores
    sb (B, N_BLOCKS, 128) with the block ids of each row's top-K maxima."""
    from lemon_tpu_torch.ops import topk

    g = torch.Generator(device=device).manual_seed(17)
    if rows == "ties":
        x = torch.randint(0, 40, (B, W), generator=g, device=device).float() / 4
        sb = torch.randint(0, 40, (B, N_BLOCKS, 128), generator=g, device=device).float() / 4
    else:
        x = torch.randn(B, W, generator=g, device=device)
        sb = torch.randn(B, N_BLOCKS, 128, generator=g, device=device)
    blocks = torch.rand(B, N_BLOCKS, generator=g, device=device).argsort(dim=1)[:, : W // 128].sort(dim=1).values
    cid = (blocks.to(torch.int32)[:, :, None] * 128 + torch.arange(128, device=device, dtype=torch.int32)).view(B, W)
    ids = topk.topk(sb.amax(2), K)[1].sort(dim=1).values
    return x, cid, sb, ids


def main(argv=None) -> dict:
    import torch

    from lemon_tpu_torch.benchmarks._timing import cuda_ms, device_line, require_cuda
    from lemon_tpu_torch.ops import select, topk

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--parent", type=Path, help="an older checkout whose select to measure beside this one")
    args.add_argument("--warp", action="store_true", help="the warp select's split instead of the block select's")
    args = args.parse_args(argv)
    device = require_cuda("select_limits")
    print(device_line(), flush=True)
    trees = {"this": _build.CSRC}
    if args.parent:
        trees["parent"] = args.parent.resolve() / "lemon_tpu_torch" / "ops" / "csrc"
    if args.warp:
        return warp_limits(torch, trees, device)
    plan = {("this", name): (_build.CSRC, flags) for name, flags in BUILDS.items()}
    for tree, csrc in trees.items():
        if tree != "this":  # the threshold select has no filter pass
            plan.update({(tree, name): (csrc, flags) for name, flags in BUILDS.items() if name != "filter"})
            plan[(tree, "as_built")] = (csrc, ())
    libs = build_all(plan, _build.BUILD_ROOT / "select_limits")
    libs[("this", "as_built")] = _build.library()
    order = sorted(libs)
    calls = {"K2": lambda x, cid, sb, ids: topk.topk(x, K, "radix"),
             "P1": lambda x, cid, sb, ids: select.topk_colids(x, cid, K),
             "K4": lambda x, cid, sb, ids: select.fused_gather_topk(sb, ids, K)}
    library = _build.library
    ms, passes = {}, {}
    try:
        for rows in ROWS:
            data = inputs(torch, rows, device)
            for r in range(ROUNDS):
                for key in order if r % 2 == 0 else order[::-1]:
                    _build.library = lambda lib=libs[key]: lib  # the wrappers launch this build's kernels
                    for name, call in calls.items():
                        ms.setdefault(f"{key[0]} {name} {rows} {key[1]}", []).append(
                            cuda_ms(lambda: call(*data), 10))
            x, cid, sb, ids = data
            gathered = sb[:CHECK_ROWS].gather(1, ids[:CHECK_ROWS, :, None].expand(CHECK_ROWS, K, 128))
            plain = {"K2": topk.select_rounds_plain(x[:CHECK_ROWS].cpu(), K)[2].sum(),
                     "K4": topk.select_rounds_plain(gathered.reshape(CHECK_ROWS, -1).cpu(), K, select.MAX_K)[2].sum()}
            for tree in trees:
                lib = libs[(tree, "counted")]
                _build.library = lambda lib=lib: lib
                for name, counter in (("K2", "lemon_topk_row_passes"), ("K4", "lemon_gather_topk_row_passes")):
                    for n_rows in (B, CHECK_ROWS):
                        torch.cuda.synchronize()
                        getattr(lib, counter)()
                        calls[name](x[:n_rows], cid[:n_rows], sb[:n_rows], ids[:n_rows])
                        torch.cuda.synchronize()
                        n = getattr(lib, counter)()
                        if n_rows == B:
                            passes[f"{tree} {name} {rows}"] = n / B
                        elif tree == "this" and n != plain[name]:
                            raise RuntimeError(f"select_limits: {name} on {CHECK_ROWS} {rows} rows made {n} passes, "
                                               f"its plain restatement {plain[name]}")
            del data, x, cid, sb, ids, gathered
        shapes = {}
        if args.parent:
            g = torch.Generator(device=device).manual_seed(18)
            for w, k in RADIX_SHAPES:
                x = torch.randint(0, 40, (B, w), generator=g, device=device).float() / 4
                for r in range(ROUNDS):
                    for tree in trees if r % 2 == 0 else list(trees)[::-1]:
                        _build.library = lambda lib=libs[(tree, "as_built")]: lib
                        shapes.setdefault(f"{tree} K2 radix ({B}, {w}) k={k}", []).append(
                            cuda_ms(lambda: topk.topk(x, k, "radix"), 20))
                del x
    finally:
        _build.library = library
    result = {"shape": [B, W, K], "k4_blocks": N_BLOCKS, "ms": ms, "passes_per_row": passes, "radix_shapes_ms": shapes}
    print("SELECT_LIMITS " + json.dumps(result), flush=True)
    return result


def warp_limits(torch, trees: dict, device) -> dict:
    """The warp select's split (``WARP_BUILDS``) and, with an older tree,
    its warp kernels and the crossover rows; prints ``SELECT_LIMITS``."""
    from lemon_tpu_torch.benchmarks._timing import cuda_ms, graph_ms
    from lemon_tpu_torch.ops import select, topk

    plan = {("this", name): (_build.CSRC, flags) for name, flags in WARP_BUILDS.items()}
    plan.update({(tree, "as_built"): (csrc, ()) for tree, csrc in trees.items() if tree != "this"})
    libs = build_all(plan, _build.BUILD_ROOT / "select_limits_warp")
    libs[("this", "as_built")] = _build.library()
    order = sorted(libs)
    library = _build.library
    device_only, events, crossover = {}, {}, {}

    def timed(label, key, call):
        _build.library = lambda lib=libs[key]: lib  # the wrappers launch this build's kernels
        device_only.setdefault(f"{key[0]} {label} {key[1]}", []).append(graph_ms(call, 20))
        events.setdefault(f"{key[0]} {label} {key[1]}", []).append(cuda_ms(call, 20))

    try:
        g = torch.Generator(device=device).manual_seed(19)
        for rows in ROWS:
            for name, w, k in WARP_SHAPES:
                if name == "K2":
                    x = (torch.randint(0, 40, (B, w), generator=g, device=device).float() / 4 if rows == "ties"
                         else torch.randn(B, w, generator=g, device=device))
                    call = lambda x=x, k=k: topk.topk(x, k, "warp")
                    label = f"K2 warp ({B}, {w}) k={k} {rows}"
                else:
                    sb = (torch.randint(0, 40, (B, w, 128), generator=g, device=device).float() / 4 if rows == "ties"
                          else torch.randn(B, w, 128, generator=g, device=device))
                    ids = topk.topk(sb.amax(2), k)[1].sort(dim=1).values
                    call = lambda sb=sb, ids=ids, k=k: select.fused_gather_topk(sb, ids, k)
                    label = f"K4 ({B}, {w} blocks) k={k} {rows}"
                for r in range(ROUNDS):
                    for key in order if r % 2 == 0 else order[::-1]:
                        timed(label, key, call)
                del call
        if len(trees) > 1:
            for w, k in CROSSOVER:
                x = torch.randint(0, 40, (B, w), generator=g, device=device).float() / 4
                for r in range(ROUNDS):
                    for tree, variant in [("this", "warp"), ("this", "radix"), ("parent", "warp")][:: 1 - 2 * (r % 2)]:
                        _build.library = lambda lib=libs[(tree, "as_built")]: lib
                        call = lambda: topk.topk(x, k, variant)
                        crossover.setdefault(f"{tree} K2 {variant} ({B}, {w}) k={k} ties", []).append(
                            [graph_ms(call, 20), cuda_ms(call, 20)])
                del x
    finally:
        _build.library = library
    result = {"warp": True, "device_only_ms": device_only, "event_ms": events, "crossover_device_and_event_ms": crossover}
    print("SELECT_LIMITS " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
