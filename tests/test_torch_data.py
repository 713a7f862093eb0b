"""The port's large-scale classification datasets (``mini_imagenet``,
``stanford_cars``) and their stratified split against the JAX package.

- ``stratified_50_25_25`` equals the JAX package's (sklearn's
  ``train_test_split(..., stratify=)``) index for index, over seeds, sizes
  and strata: binary, multi-class, odd counts, string classes and classes of
  two or three rows; a class of one row raises in both.
- ``load_large_scale_dataset`` on a fixture written to ``tmp_path``
  (``multimodal_mislabel_split.csv`` and PNGs of mixed sizes) gives the JAX
  package's splits, labels and paths, and ``run_lemon --dataset
  mini_imagenet --platform cpu`` runs on it.
"""

import sys

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from lemon_tpu.data import datasets as jdatasets
from lemon_tpu.data.splits import stratified_50_25_25 as jax_stratified
from lemon_tpu_torch.data import datasets
from lemon_tpu_torch.data.splits import stratified_50_25_25


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strata(kind: str, n: int, rng) -> np.ndarray:
    if kind == "binary":
        return rng.random(n) < 0.8  # is_clean: mostly clean
    if kind == "multiclass":
        return rng.integers(0, 7, n)
    if kind == "strings":
        return np.array([f"class_{c}" for c in rng.integers(0, 4, n)])
    y = rng.integers(0, 5, n)  # "small": classes of two and three rows beside large ones
    y[:2], y[2:5] = 90, 91
    return y


KINDS = ("binary", "multiclass", "strings", "small")


@pytest.mark.parametrize("kind", KINDS)
def test_stratified_split_matches_sklearn(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    n_cases = 0
    for n in (20, 41, 97, 250, 1001):
        for seed in (0, 1, 7, 42, 1234):
            strata = _strata(kind, n, rng)
            try:
                want = jax_stratified(strata, seed)
            except ValueError:  # too few rows for the classes: both refuse
                with pytest.raises(ValueError):
                    stratified_50_25_25(strata, seed)
                continue
            got = stratified_50_25_25(strata, seed)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            n_cases += 1
    assert n_cases >= 16  # the rest are too small for their classes in both packages


def test_a_class_of_one_row_raises_as_in_sklearn():
    strata = np.array([0] * 30 + [1] * 30 + [2])
    with pytest.raises(ValueError):
        jax_stratified(strata, 0)
    with pytest.raises(ValueError, match="only 1 member"):
        stratified_50_25_25(strata, 0)


@pytest.fixture
def mini_imagenet(tmp_path, monkeypatch):
    """60 rows: labels 1-99, a third noisy, PNGs of two sizes."""
    root = tmp_path / "mini_imagenet"
    (root / "img").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(60):
        size = (40, 32) if i % 3 else (32, 48)
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(root / "img" / f"{i}.png")
        rows.append({"filename": f"img/{i}.png", "label": int(rng.integers(1, 100)), "is_clean": bool(i % 3)})
    pd.DataFrame(rows).to_csv(root / "multimodal_mislabel_split.csv", index=False)
    monkeypatch.setenv("LEMON_TPU_DATA_ROOT", str(tmp_path))
    return root


@pytest.mark.parametrize("name", ["mini_imagenet", "stanford_cars"])
def test_large_scale_dataset_matches_jax(mini_imagenet, monkeypatch, name):
    monkeypatch.setenv(f"LEMON_TPU_PATH_{name.upper()}", str(mini_imagenet))
    for seed in (0, 3):
        ours = datasets.get_dataset(name, seed, noise_type="real")
        theirs = jdatasets.get_dataset(name, seed, noise_type="real")
        assert [len(s) for s in ours] == [30, 15, 15]
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.y_noisy, b.y_noisy)
            np.testing.assert_array_equal(a.y_clean, b.y_clean)
            assert a.paths == b.paths and a.images is None
    with pytest.raises(ValueError, match="real"):
        datasets.get_dataset(name, 0, noise_type="symmetric")


def test_run_lemon_on_mini_imagenet(mini_imagenet, tmp_path):
    from lemon_tpu_torch.cli.run_lemon import main

    out = tmp_path / "out"
    stdout, stderr = sys.stdout, sys.stderr
    try:
        main(["--output_dir", str(out), "--platform", "cpu", "--dataset", "mini_imagenet", "--clip_model", "tiny",
              "--knn_k", "3", "--batch_size", "16"])
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    assert (out / "done").exists()
    scores = pd.read_csv(out / "know_val_labels_scores.csv")
    assert len(scores) == 60 and np.isfinite(scores["pred_score"]).all()
    assert scores["is_mislabel"].sum() == 20  # the noisy rows, whose clean label is label - 1
