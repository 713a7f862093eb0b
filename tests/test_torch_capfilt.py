"""The port's capfilt baseline on the live-reference golden, on the CPU.

Same fixtures and bars as
``tests/test_live_reference_parity.py::test_capfilt_parity_vs_live_reference_golden``
(re-stated here): the caption fixture and tiny HF CLIP of
tests/reference_harness/fixture.py, and the tiny BLIP-ITM checkpoint of
``tests/tiny_checkpoints.build_tiny_blip_itm`` (built with ``transformers``
by the test; the port reads it without). ``run_baseline --baseline
capfilt --platform cpu`` must give the golden's flips exactly and its
P(match) within 1e-5, and the JAX CLI's output files. A missing
``--itm_checkpoint`` raises ``SystemExit`` before any scoring.
"""

import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HARNESS = Path(__file__).parent / "reference_harness"
ARGV = ["--baseline", "capfilt", "--dataset", "mscoco", "--noise_type", "cat", "--noise_level", "0.3", "--seed", "0",
        "--data_seed", "0"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    sys.path.insert(0, str(HARNESS))
    sys.path.insert(0, str(Path(__file__).parent))
    try:
        from fixture import build_caption_fixture, build_checkpoint
        from tiny_checkpoints import build_tiny_blip_itm
    finally:
        sys.path.pop(0)
        sys.path.pop(0)
    base = tmp_path_factory.mktemp("torch_capfilt")
    return {"ckpt": build_checkpoint(base / "ckpt")["state_dict_pt"], "caption": build_caption_fixture(base / "caption"),
            "itm": build_tiny_blip_itm(base / "blip_itm")}


def _run(main, argv, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    stdout, stderr = sys.stdout, sys.stderr
    try:
        return main(argv)
    finally:
        sys.stdout, sys.stderr = stdout, stderr


def test_port_capfilt_matches_live_reference_golden(fixtures, tmp_path, monkeypatch):
    from lemon_tpu_torch.cli.run_baseline import main

    out = tmp_path / "port"
    env = {"LEMON_TPU_PATH_MSCOCO": fixtures["caption"], "LEMON_TPU_CKPT_HUGGINGFACE_CLIP": fixtures["ckpt"]}
    _run(main, ["--output_dir", str(out), "--platform", "cpu", "--itm_checkpoint", fixtures["itm"], *ARGV], env,
         monkeypatch)
    ref = np.load(HARNESS / "goldens" / "ref_capfilt.npz")
    with open(out / "full_loss_dict.pkl", "rb") as f:
        got = pickle.load(f)
    with open(out / "flip_labels.pkl", "rb") as f:
        got_flips = pickle.load(f)
    for s in ("train", "val", "test"):
        np.testing.assert_array_equal(ref[f"flips_{s}"], np.asarray(got_flips[s]).astype(np.int64))
        d = np.abs(ref[f"pmatch_{s}"] - np.asarray(got[s])).max()
        assert d <= 1e-5, f"capfilt {s} drifted from the live reference: {d}"
    args = json.loads((out / "args.json").read_text())
    assert args["platform"] == "cpu" and args["baseline"] == "capfilt"


def test_port_capfilt_writes_the_jax_clis_files(fixtures, tmp_path, monkeypatch):
    from lemon_tpu.cli.run_baseline import main as jax_main
    from lemon_tpu_torch.cli.run_baseline import main

    env = {"LEMON_TPU_PATH_MSCOCO": fixtures["caption"], "LEMON_TPU_CKPT_HUGGINGFACE_CLIP": fixtures["ckpt"]}
    itm = ["--itm_checkpoint", fixtures["itm"]]
    _run(jax_main, ["--output_dir", str(tmp_path / "jax"), *itm, *ARGV], env, monkeypatch)
    res = _run(main, ["--output_dir", str(tmp_path / "port"), "--platform", "cpu", *itm, *ARGV], env, monkeypatch)
    assert {p.name for p in (tmp_path / "port").iterdir()} == {p.name for p in (tmp_path / "jax").iterdir()}
    import pandas as pd

    j = pd.read_csv(tmp_path / "jax" / "scores.csv")
    p = pd.read_csv(tmp_path / "port" / "scores.csv")
    assert (j["is_mislabel"].values == p["is_mislabel"].values).all()
    assert np.abs(j["pred_score"].values - p["pred_score"].values).max() <= 1e-5
    assert set(res) >= {"df", "agg_results"}


def test_a_missing_itm_checkpoint_raises(tmp_path, monkeypatch):
    from lemon_tpu_torch.cli.run_baseline import main

    with pytest.raises(SystemExit, match="--itm_checkpoint does not exist"):
        _run(main, ["--output_dir", str(tmp_path), "--platform", "cpu", "--baseline", "capfilt", "--clip_model",
                    "tiny", "--dataset", "synthetic_caption", "--synthetic_n", "60",
                    "--itm_checkpoint", str(tmp_path / "nowhere")], {}, monkeypatch)
    assert not (tmp_path / "res.pkl").exists()
