"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests.tiny import TINY

PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "lemon_tpu", "benchmarks"}


def _roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_roots(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not set(_roots(path)) & {"lemon_tpu_torch", "lemon_tpu"}


def test_an_architectures_reference_loads_nothing_of_the_program():
    """Every architecture module imports the program only inside ``encoder``:
    importing each, and the weights, reference and FLOPs of ``openai_clip``
    at a tiny size, leave no program, JAX or JAX package in ``sys.modules``."""
    code = (
        "import sys, importlib, pkgutil, torch, numpy as np\n"
        "import portbench.arch as a\n"
        "[importlib.import_module('portbench.arch.' + m.name) for m in pkgutil.iter_modules(a.__path__)]\n"
        "from portbench.weights import make_weights\n"
        f"cfg = {TINY!r}\n"
        "m, W = a.of(cfg), make_weights(cfg, 3, torch.device('cpu'))\n"
        "m.encode_image(W, cfg, m.preprocess(torch.zeros(2, 40, 40, 3, dtype=torch.uint8), cfg))\n"
        "m.encode_text(W, cfg, torch.from_numpy(m.tokenize(['a cat', 'a dog'], cfg)))\n"
        "m.image_flops(cfg) + m.text_flops(cfg, m.text_lengths(['a cat'], cfg)[0])\n"
        "print(sorted({k.split('.')[0] for k in sys.modules} & {'jax', 'jaxlib', 'flax', 'lemon_tpu', "
        "'lemon_tpu_torch'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().split("\n")[-1] == "[]"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every module a run imports, and a tiny detection driven through it on
    the CPU, leave no forbidden top-level name in ``sys.modules``."""
    code = (
        "import sys, importlib, torch\n"
        "from portbench import harness, check, control, run, roofline\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "import pkgutil, portbench.metrics as m\n"
        "[importlib.import_module('portbench.metrics.' + i.name) for i in pkgutil.iter_modules(m.__path__)]\n"
        "bench = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "r = harness.run(bench, tiny_cell(), 7, 0.01, False, torch.device('cpu'), 0.0)\n"
        "print(sorted({k.split('.')[0] for k in sys.modules} & {'jax', 'jaxlib', 'flax', 'lemon_tpu'}), r['correct'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().split("\n")[-1] == "[] True"
