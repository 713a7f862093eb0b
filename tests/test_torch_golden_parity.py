"""The port's CLIs on the live-reference goldens.

Same fixtures and bars as tests/test_live_reference_parity.py (re-stated
here, not imported): a tiny HF CLIP checkpoint and synthetic datasets in the
reference's on-disk formats, built by tests/reference_harness/fixture.py.
``run_lemon`` (``--platform cpu --strict_hparam_parity``): val and test AUROC
within 1e-3 of the goldens, ``pred_score`` within 2e-3,
``sset``/``idx``/``is_mislabel`` bit-exact. ``run_baseline`` (``--platform
cpu``): clip_sim's and zero_shot's ``dists.npy`` within 1e-4; discrepancy's
``dis_y`` and ``div_x`` ``scores.csv`` within 1e-4, ``is_mislabel`` exact,
val and test AUROC within 1e-3.
"""

import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

HARNESS = Path(__file__).parent / "reference_harness"
GOLDENS = json.loads((HARNESS / "goldens" / "goldens.json").read_text())


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    sys.path.insert(0, str(HARNESS))
    try:
        from fixture import build_caption_fixture, build_checkpoint, build_cifar_fixture
    finally:
        sys.path.pop(0)
    base = tmp_path_factory.mktemp("torch_golden")
    return {
        "ckpt": build_checkpoint(base / "ckpt")["state_dict_pt"],
        "caption": build_caption_fixture(base / "caption"),
        "cifar_root": build_cifar_fixture(base / "cifar" / "data"),
        # batch-divisible splits (512/64/64) for the npy-contract baselines
        "cifar640_root": build_cifar_fixture(base / "cifar640" / "data", n_train=640),
    }


def _run_port(out_dir, golden_key, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    cfg = GOLDENS[golden_key]["config"]
    from lemon_tpu_torch.cli.run_lemon import main

    argv = [
        "--output_dir", str(out_dir), "--platform", "cpu", "--strict_hparam_parity",
        "--dataset", cfg["dataset"], "--noise_type", cfg["noise_type"],
        "--noise_level", str(cfg["noise_level"]), "--knn_k", str(cfg["knn_k"]),
        "--seed", str(cfg["seed"]), "--data_seed", str(cfg["data_seed"]),
    ]
    stdout, stderr = sys.stdout, sys.stderr
    try:
        main(argv)
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    with open(Path(out_dir) / "res.pkl", "rb") as f:
        return pickle.load(f)["agg_results"]["know_val_labels"]


@pytest.mark.parametrize("golden_key,csv", [("caption", "ref_caption_scores.csv"), ("cifar", "ref_cifar_scores.csv")])
def test_port_matches_live_reference_golden(fixtures, tmp_path, monkeypatch, golden_key, csv):
    if golden_key == "caption":
        env = {"LEMON_TPU_PATH_MSCOCO": fixtures["caption"]}
    else:
        env = {"LEMON_TPU_DATA_ROOT": fixtures["cifar_root"]}
    env["LEMON_TPU_CKPT_HUGGINGFACE_CLIP"] = fixtures["ckpt"]
    out = tmp_path / golden_key
    agg = _run_port(out, golden_key, env, monkeypatch)
    golden = GOLDENS[golden_key]
    assert abs(float(agg["val"]["AUROC"]) - golden["val_AUROC"]) <= 1e-3
    assert abs(float(agg["test"]["AUROC"]) - golden["test_AUROC"]) <= 1e-3

    ref = pd.read_csv(HARNESS / "goldens" / csv)
    got = pd.read_csv(out / "know_val_labels_scores.csv")
    assert len(ref) == len(got)
    assert (ref["sset"].values == got["sset"].values).all()
    np.testing.assert_array_equal(ref["idx"].values, got["idx"].values)
    np.testing.assert_array_equal(ref["is_mislabel"].values, got["is_mislabel"].values)
    d = np.abs(ref["pred_score"].values - got["pred_score"].values).max()
    assert d <= 2e-3, f"pred_score drifted from the live-reference golden: max abs diff {d}"


def _run_port_baseline(out_dir, env, monkeypatch, argv):
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    from lemon_tpu_torch.cli.run_baseline import main

    stdout, stderr = sys.stdout, sys.stderr
    try:
        main(["--output_dir", str(out_dir), "--platform", "cpu", *argv])
    finally:
        sys.stdout, sys.stderr = stdout, stderr


@pytest.mark.parametrize("method", ["dis_y", "div_x"])
def test_port_discrepancy_matches_live_reference_golden(fixtures, tmp_path, monkeypatch, method):
    out = tmp_path / f"disc_{method}"
    _run_port_baseline(
        out, {"LEMON_TPU_PATH_MSCOCO": fixtures["caption"], "LEMON_TPU_CKPT_HUGGINGFACE_CLIP": fixtures["ckpt"]},
        monkeypatch,
        ["--baseline", "discrepancy", "--method", method, "--dataset", "mscoco", "--noise_type", "random",
         "--noise_level", "0.4", "--knn_k", "5", "--seed", "0", "--data_seed", "0"],
    )
    ref = pd.read_csv(HARNESS / "goldens" / f"ref_disc_{method}_scores.csv")
    got = pd.read_csv(out / "scores.csv")
    np.testing.assert_array_equal(ref["is_mislabel"].values, got["is_mislabel"].values)
    d = np.abs(ref["pred_score"].values - got["pred_score"].values).max()
    assert d <= 1e-4, f"discrepancy {method} drifted from the live-reference golden: {d}"
    with open(out / "res.pkl", "rb") as f:
        agg = pickle.load(f)["agg_results"]
    for s in ("val", "test"):
        assert abs(float(agg[s]["AUROC"]) - GOLDENS[f"disc_{method}"][f"{s}_AUROC"]) <= 1e-3


@pytest.mark.parametrize("baseline,golden", [("zero_shot", "ref_zero_shot_dists.npy"),
                                             ("clip_sim", "ref_clip_sim_dists.npy")])
def test_port_dists_match_live_reference_golden(fixtures, tmp_path, monkeypatch, baseline, golden):
    """clip_sim's golden guards the bare-class-word text contract (no 'A
    photo of a' prompt); zero_shot's the confidences before negation."""
    out = tmp_path / baseline
    _run_port_baseline(
        out, {"LEMON_TPU_DATA_ROOT": fixtures["cifar640_root"], "LEMON_TPU_CKPT_HUGGINGFACE_CLIP": fixtures["ckpt"]},
        monkeypatch,
        ["--baseline", baseline, "--dataset", "cifar10", "--noise_type", "symmetric", "--noise_level", "0.4",
         "--seed", "0", "--data_seed", "0"],
    )
    ref = np.load(HARNESS / "goldens" / golden)
    got = np.load(out / "dists.npy")
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= 1e-4
