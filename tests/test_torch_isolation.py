"""The port stands alone: no module of lemon_tpu_torch/ and nothing in
chip_smoke.py imports the JAX package or JAX, and its public entry points
run on the CUDA card unless they are given another device."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from lemon_tpu_torch.knn.index import ExactKnnIndex
from lemon_tpu_torch.scoring.lemon import NeighborLogs
from lemon_tpu_torch.scoring.optimize import maximize_metric

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("lemon_tpu", "jax", "flax", "optax")
SOURCES = sorted((REPO / "lemon_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = sorted({root for root in _imported_roots(path) if root in FORBIDDEN})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_scan_sees_every_module():
    assert len(SOURCES) > 30 and all(p.exists() for p in SOURCES)
    assert {"tokenizer.py", "encoder.py", "index.py", "chip_smoke.py"} <= {p.name for p in SOURCES}


def _tiny_logs(n=40, k=3, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.random(shape).astype(np.float32)  # noqa: E731
    return NeighborLogs(d_1=f(n), dists_n=f(n, k), D_n=f(n, k), dists_tr_n=f(n, k), dists_m=f(n, k), D_m=f(n, k),
                        dists_tr_m=f(n, k), is_mislabel=(rng.random(n) < 0.3).astype(np.int32),
                        sset=np.full(n, "val"))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExactKnnIndex()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        maximize_metric(_tiny_logs(), grid={"beta": [0, 1]})
    assert ExactKnnIndex(device=torch.device("cpu")).device.type == "cpu"
