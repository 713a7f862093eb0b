"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The last line of standard output is the result (``correct``,
``attempted`` and ``failed`` detections, ``metrics``, ``device``, with
``--trace 1`` the per-layer metrics and a ``breakdown``, and ``checks``
last: each number compared with its limit); the checks are also the last
lines of standard error. Exits non-zero, printing no result, without the
cards, without the program (``lemon_tpu_torch``) in the checkout, or if the
JAX package or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout (the
# kernel library itself is built into <checkout>/build/lemon_tpu_torch/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    from portbench import harness

    cell = harness.Cell.load(bench, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import lemon_tpu_torch
    except ImportError as e:
        print(f"portbench: the program is not in this checkout ({e})", file=sys.stderr)
        return 3
    if ROOT not in Path(lemon_tpu_torch.__file__).resolve().parents:
        print(f"portbench: lemon_tpu_torch comes from {lemon_tpu_torch.__file__}, outside {ROOT}", file=sys.stderr)
        return 3

    result = harness.run(bench, cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START,
                         count=chips)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
