"""The port stands alone: no module of lemon_tpu_torch/ and nothing in
chip_smoke.py imports the JAX package, JAX, flax, optax, orbax, the JAX
probes of benchmarks/, or scikit-learn, transformers and safetensors (which
the GPU machine lacks), and its
public entry points run on the CUDA card unless they are given another
device."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from lemon_tpu_torch.core.profiling import PhaseTimer
from lemon_tpu_torch.knn.index import ExactKnnIndex
from lemon_tpu_torch.ops.image import preprocess_device
from lemon_tpu_torch.scoring.lemon import NeighborLogs
from lemon_tpu_torch.scoring.optimize import maximize_metric

REPO = Path(__file__).resolve().parents[1]
# the port's probes must not reach the JAX ones in benchmarks/
FORBIDDEN = ("lemon_tpu", "jax", "flax", "optax", "orbax", "benchmarks", "sklearn", "transformers", "safetensors")
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
    assert {"tokenizer.py", "encoder.py", "index.py", "chip_smoke.py", "probe_knn_select3.py", "streaming.py",
            "native_loader.py", "resnet.py", "bert_text.py", "biomed.py", "wordpiece.py", "mesh.py",
            "contrastive.py", "preemption.py", "filtering.py", "train_clip.py", "cpp_backend.py", "classifier.py",
            "torch_backbones.py", "downstream.py", "run_downstream.py", "training_dependent.py", "safetensors_io.py",
            "blip_itm.py", "capfilt.py", "captioner.py", "qformer.py", "blip2.py", "gpt2_bpe.py",
            "captioning.py"} <= {
        p.name for p in SOURCES}


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


@pytest.mark.parametrize("entry", ["preprocess_device", "PhaseTimer"])
def test_preprocess_and_timer_default_to_the_card(monkeypatch, entry):
    images = np.zeros((1, 8, 8, 3), np.uint8)
    call = {"preprocess_device": lambda **kw: preprocess_device(images, size=8, **kw),
            "PhaseTimer": lambda **kw: PhaseTimer(**kw)}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    call(device=torch.device("cpu"))


def test_preprocess_keeps_a_tensor_on_its_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = preprocess_device(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), size=8)
    assert out.device.type == "cpu" and out.shape == (1, 8, 8, 3)
