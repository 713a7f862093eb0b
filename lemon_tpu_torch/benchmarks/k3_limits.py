"""Where K3's fp32 kernels (``ops/csrc/attention.cu``, 3xTF32 flash attention)
spend their time on the card. Builds of that file, each compiled alone with
``nvcc -shared`` and one compile-time switch:

- ``loads``: ``-DLEMON_K3_STOP=1``, the kernel's loads of q, k and v, its
  barriers and its store of o, with no split and no product;
- ``split``: ``-DLEMON_K3_STOP=2``, that and the TF32 splits of q, k and v
  (v transposed into v^T);
- ``split_s``: ``-DLEMON_K3_STOP=3``, that and ``S = q . k^T`` with its
  softmax and the split of P, without ``P . v``;
- ``no_splits``: ``-DLEMON_K3_STOP=4``, everything but the splits of k and
  v (the products read them unsplit);
- ``self_fed``: ``-DLEMON_K3_SPLITTER=0``, the whole kernel with the
  self-fed schedule at every shape, where the library as built runs the
  split schedule for unmasked heads at D = 64 (its output is held to
  ``flash_attention_plain`` at ``K3_TOL``, as the library's is);

timed beside the library as built (``as_built``, ``_build.library()``)
through ``ops.attention.flash_attention`` in turns over ``ROUNDS`` rounds, at
chip_smoke's six K3 shapes (B = 128, q, k and v strided views of one fused
QKV tensor). The outputs of the stopped builds are not attention.

``--parent DIR`` (an older checkout whose fp32 kernel is the
register-staged ``flash_attention_kernel<D, BKV>``) builds that tree's
``attention.cu`` as it is and with the first three stops put in by textual
edits (raises if its source no longer holds the lines they edit), and times
them in the same turns. (Its ``loads`` build keeps the loaded values only
through an empty asm statement, which ptxas may drop with the loads: that
row is no time of its loads.) Prints the card and one JSON line,
``K3_LIMITS {...}`` (ms of each round, by tree, build and shape).

Run on the card: ``python3 -m lemon_tpu_torch.benchmarks.k3_limits
[--parent DIR]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

from lemon_tpu_torch.ops import _build

B = 128
ROUNDS = 3
K3_TOL = 2e-5  # the built kernels against flash_attention_plain (chip_smoke's bar)
# (L, heads, head dim, causal): chip_smoke's K3_SHAPES, the towers' four first
SHAPES = ((197, 12, 64, False), (256, 8, 64, True), (50, 12, 64, False), (77, 8, 64, True),
          (197, 24, 32, False), (256, 4, 128, True))
BUILDS = {"loads": ("-DLEMON_K3_STOP=1",), "split": ("-DLEMON_K3_STOP=2",), "split_s": ("-DLEMON_K3_STOP=3",),
          "no_splits": ("-DLEMON_K3_STOP=4",), "self_fed": ("-DLEMON_K3_SPLITTER=0",)}
_STOP = "#ifndef LEMON_K3_STOP\n#define LEMON_K3_STOP 0\n#endif\n"
_PV = ("        wgmma_rs<D>(acc, p_hi[i], p_hi[i + 2], p_hi[i + 1], p_hi[i + 3], dv_hi + vo);\n"
       "        wgmma_rs<D>(acc, p_hi[i], p_hi[i + 2], p_hi[i + 1], p_hi[i + 3], dv_lo + vo);\n"
       "        wgmma_rs<D>(acc, p_lo[i], p_lo[i + 2], p_lo[i + 1], p_lo[i + 3], dv_hi + vo);\n")
_S = ("        wgmma_ss<BKV>(s, dq_hi + qo, dk_hi + ko);\n"
      "        wgmma_ss<BKV>(s, dq_hi + qo, dk_lo + ko);\n"
      "        wgmma_ss<BKV>(s, dq_lo + qo, dk_hi + ko);\n")
_SOFTMAX = "      // Online softmax over this tile; the row max is a quad max.\n"
_P_SPLIT = "        split(p, p_hi[i], p_lo[i]);\n      }\n"
_STORE = "  uint4 h, l;\n  split(a, h.x, l.x);\n"
# the register-staged kernel (attention.cu until the TMA-fed one replaced
# it): where each stop goes, as (the text, what replaces it)
_PARENT_EDITS = (
    ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n\n' + _STOP),
    # loads only: each staged value is consumed by an empty asm instead of split and stored
    (_STORE, '#if LEMON_K3_STOP == 1\n  asm volatile("" ::"f"(a), "f"(b), "f"(c), "f"(d));\n  return;\n#endif\n' + _STORE),
    (_S, "#if LEMON_K3_STOP == 0 || LEMON_K3_STOP >= 3\n" + _S + "#endif\n"),
    (_SOFTMAX, "#if LEMON_K3_STOP == 1 || LEMON_K3_STOP == 2\n      float alpha[2] = {1.f, 1.f};\n"
               "      uint32_t p_hi[NS], p_lo[NS];\n#pragma unroll\n"
               "      for (int i = 0; i < NS; ++i) p_hi[i] = p_lo[i] = 0u;\n#else\n" + _SOFTMAX),
    (_P_SPLIT, _P_SPLIT + "#endif\n"),
    (_PV, "#if LEMON_K3_STOP == 0\n" + _PV + "#endif\n"),
)


def tree_sources(csrc: Path) -> dict:
    """{file: source} of a tree's K3, with the stops put into an older
    tree's register-staged kernel; raises if that tree lacks an edited line."""
    files = {name: (csrc / name).read_text() for name in ("attention.cu", "hopper.cuh")}
    if "LEMON_K3_STOP" in files["attention.cu"]:
        return files
    for old, new in _PARENT_EDITS:
        if files["attention.cu"].count(old) != 1:
            raise ValueError(f"{csrc / 'attention.cu'} no longer holds exactly one of:\n{old}")
        files["attention.cu"] = files["attention.cu"].replace(old, new)
    return files


def build_all(trees: dict, out_dir: Path) -> dict:
    """{(tree, build): CDLL}: every build of every tree (an older tree also
    as it is, without the builds its source has no switch for), compiled in
    parallel."""
    nvcc = _build._nvcc()
    procs = {}
    for tree, csrc in trees.items():
        files = tree_sources(csrc)
        builds = dict(BUILDS)
        if tree != "this":
            del builds["self_fed"], builds["no_splits"]
            builds["as_built"] = ()
        for name, flags in builds.items():
            d = out_dir / tree / name
            d.mkdir(parents=True, exist_ok=True)
            for fname, text in files.items():
                (d / fname).write_text(text)
            cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(d / "lib.so"), str(d / "attention.cu")]
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
        libs[key] = lib
    return libs


def main(argv=None) -> dict:
    import torch

    from lemon_tpu_torch.benchmarks._timing import cuda_ms, device_line, require_cuda
    from lemon_tpu_torch.ops import attention

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--parent", type=Path, help="an older checkout whose K3 to measure beside this one")
    args = args.parse_args(argv)
    device = require_cuda("k3_limits")
    print(device_line(), flush=True)
    trees = {"this": _build.CSRC}
    if args.parent:
        trees["parent"] = args.parent.resolve() / "lemon_tpu_torch" / "ops" / "csrc"
    libs = build_all(trees, _build.BUILD_ROOT / "k3_limits")
    libs[("this", "as_built")] = _build.library()
    order = sorted(libs)
    g = torch.Generator(device=device).manual_seed(3)
    inputs = {}
    for l, h, d, causal in SHAPES:
        x = torch.randn(B, l, 3 * h * d, device=device, generator=g)
        inputs[(l, h, d, causal)] = tuple(t.reshape(B, l, h, d) for t in x.split(h * d, dim=-1))
    library = _build.library
    ms, errors = {}, {}
    try:
        for key in order:  # each build at each shape once, the whole kernels held to the plain version
            _build.library = lambda lib=libs[key]: lib  # the wrapper launches this build's kernel
            for shape, (q, k, v) in inputs.items():
                out = attention.flash_attention(q, k, v, shape[3])
                if key[1] in ("as_built", "self_fed"):
                    err = (out - attention.flash_attention_plain(q, k, v, shape[3])).abs().max().item()
                    errors[f"{key[0]} {key[1]} {shape}"] = err
                    if err > K3_TOL:
                        raise RuntimeError(f"k3_limits: {key} at {shape}: error {err} > {K3_TOL}")
        for r in range(ROUNDS):
            for key in order if r % 2 == 0 else order[::-1]:
                _build.library = lambda lib=libs[key]: lib
                for shape, (q, k, v) in inputs.items():
                    ms.setdefault(f"{key[0]} {key[1]} {shape}", []).append(
                        cuda_ms(lambda: attention.flash_attention(q, k, v, shape[3]), 20))
    finally:
        _build.library = library
    result = {"batch": B, "shapes": [list(s) for s in SHAPES], "ms": ms, "max_abs_err": errors}
    print("K3_LIMITS " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
