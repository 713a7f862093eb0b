"""The in-process caches of repeated detections (``lemon_tpu_torch.detect``:
the encoder cache and, under ``--embedding_cache``, the device embedding
cache), on the CPU.

A warm repeat builds no encoder, uploads no embedding, renders no pixel and
writes bit-identical outputs; a change of precision mode or of model
misses; the device cache keeps at most four entries; without
``--embedding_cache`` no embedding is cached, as in the JAX package
(lemon_tpu/detect.py:184-229, :492-520).
"""

import pickle
import sys

import numpy as np
import pytest
import torch

from lemon_tpu_torch import detect
from lemon_tpu_torch.cli.run_lemon import main
from lemon_tpu_torch.data.streaming import LazyRenderUint8Store
from lemon_tpu_torch.models import registry
from lemon_tpu_torch.models.clip import ClipConfig

ARGV = ["--platform", "cpu", "--dataset", "synthetic_caption", "--noise_type", "random", "--synthetic_n", "300",
        "--clip_model", "tiny", "--knn_k", "5", "--batch_size", "64"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_caches():
    detect._ENCODER_CACHE.clear()
    detect._DEV_EMB_CACHE.clear()
    yield
    detect._ENCODER_CACHE.clear()
    detect._DEV_EMB_CACHE.clear()


def _counts():
    return (detect._cached_encoder.builds, detect._device_embs.misses, detect._device_embs.hits,
            LazyRenderUint8Store.renders)


def _run(out_dir, *extra):
    stdout, stderr = sys.stdout, sys.stderr
    before = _counts()
    try:  # the CLI tees stdout/stderr into its output directory
        main(["--output_dir", str(out_dir), *ARGV, *extra])
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    builds, misses, hits, renders = (b - a for a, b in zip(before, _counts()))
    return {"builds": builds, "misses": misses, "hits": hits, "renders": renders}


def _outputs(out_dir):
    with open(out_dir / "res.pkl", "rb") as f:
        res = pickle.load(f)
    return res, (out_dir / "know_val_labels_scores.csv").read_bytes()


def test_warm_repeat_builds_uploads_and_renders_nothing(tmp_path):
    cache = ["--embedding_cache", str(tmp_path / "emb")]
    cold = _run(tmp_path / "a", *cache)
    warm = _run(tmp_path / "b", *cache)
    assert cold == {"builds": 1, "misses": 3, "hits": 0, "renders": 1}  # comparison set, val, test
    assert warm == {"builds": 0, "misses": 0, "hits": 3, "renders": 0}
    (res_a, csv_a), (res_b, csv_b) = _outputs(tmp_path / "a"), _outputs(tmp_path / "b")
    assert csv_a == csv_b
    assert res_a["df"].equals(res_b["df"])
    assert res_a["agg_results"] == res_b["agg_results"]
    assert "encoder cache hit (tiny); precision: Precision(" in (tmp_path / "b" / "out.txt").read_text()


@pytest.mark.parametrize("change", ["precision", "clip_model"])
def test_a_change_of_mode_or_model_misses(tmp_path, monkeypatch, change):
    cache = ["--embedding_cache", str(tmp_path / "emb")]
    _run(tmp_path / "a", *cache)
    if change == "precision":
        monkeypatch.setenv("LEMON_TPU_PRECISION", "bf16")
        extra = []
    else:  # the same towers under another registry name: another model, other weights
        monkeypatch.setitem(registry.MODEL_CONFIGS, "rn50", ClipConfig.tiny_rn())
        extra = ["--clip_model", "rn50"]
    counts = _run(tmp_path / "b", *cache, *extra)
    assert counts["builds"] == 1 and counts["misses"] == 3 and counts["hits"] == 0
    log = (tmp_path / "b" / "out.txt").read_text()
    assert "encoder cache hit" not in log
    if change == "precision":
        assert "compute_dtype=torch.bfloat16" in log
    again = _run(tmp_path / "c", *cache, *extra)  # and the new key is warm in turn
    assert again["builds"] == 0 and again["misses"] == 0


def test_the_device_cache_keeps_four_entries():
    cpu = torch.device("cpu")
    rows = np.ones((3, 4), np.float32)
    first = detect._device_embs("k0", rows, rows, cpu)
    for i in range(1, 6):
        detect._device_embs(f"k{i}", rows * i, rows * i, cpu)
    assert list(detect._DEV_EMB_CACHE) == [(f"k{i}", "cpu") for i in range(2, 6)]
    hits = detect._device_embs.hits
    got = detect._device_embs("k3", rows, rows, cpu)
    assert detect._device_embs.hits == hits + 1 and torch.equal(got[0], torch.from_numpy(rows * 3))
    assert list(detect._DEV_EMB_CACHE)[-1] == ("k3", "cpu")  # most recently used last
    assert detect._device_embs("k0", rows, rows, cpu) is not first  # evicted: uploaded anew


def test_without_embedding_cache_no_embedding_is_cached(tmp_path):
    cold = _run(tmp_path / "a")
    warm = _run(tmp_path / "b")
    assert not detect._DEV_EMB_CACHE
    assert cold["misses"] == warm["misses"] == 3 and warm["hits"] == 0
    assert warm["builds"] == 0  # the encoder cache holds regardless, as in JAX
    assert warm["renders"] == 1  # the embeddings are computed again, from rendered pixels
    assert _outputs(tmp_path / "a")[1] == _outputs(tmp_path / "b")[1]
