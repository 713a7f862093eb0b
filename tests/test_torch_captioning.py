"""The port's captioning trainer (``train/captioning.py``) and
``run_downstream --task captioning`` against the JAX package's, on the CPU.

Both packages start from one init: each package's ``init_captioner`` is
replaced inside the test by the JAX init (the port's through
``captioner_from_flax``). Same seeded synthetic caption splits, same
detector scores. After 2 epochs of AdamW on the warmup-cosine schedule:
``val_loss_best`` within 1e-4 relative, the loss-based
``detection_scores`` within 1e-4, the same output files. Also: the frozen
vision tower stays bit-stable under AdamW's decay, a split smaller than a
batch still trains, and the CLI raises without a card unless told
``--platform cpu``.
"""

import dataclasses
import json
import pickle
import sys

import numpy as np
import pytest
import torch
from captioner_bridge import port_config, port_model

import lemon_tpu.train.captioning as jcap
import lemon_tpu_torch.train.captioning as pcap
from lemon_tpu.data.datasets import synthetic_captioning as jax_synthetic
from lemon_tpu.models.blip2 import Blip2Config as JaxBlip2Config
from lemon_tpu.models.captioner import CaptionerConfig as JaxCaptionerConfig
from lemon_tpu.models.captioner import init_captioner as jax_init
from lemon_tpu.models.qformer import QFormerConfig as JaxQFormerConfig
from lemon_tpu_torch.data.datasets import synthetic_captioning

CPU = torch.device("cpu")
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def shared_init(monkeypatch):
    """Replace both packages' ``init_captioner`` with one JAX init a config."""
    inits = {}

    def jax_side(cfg, seed=0):
        if cfg not in inits:
            inits[cfg] = jax_init(cfg, seed)
        return inits[cfg]

    def port_side(cfg, seed=0, device=None):
        jcfg = next(k for k in inits if port_config(k) == cfg)
        return port_model(inits[jcfg][1], jcfg).to(device or CPU)

    monkeypatch.setattr(jcap, "init_captioner", jax_side)
    monkeypatch.setattr(pcap, "init_captioner", port_side)
    return inits


def _splits(package_fn, n=120):
    return dict(zip(("train", "val", "test"), package_fn(n, data_seed=0, noise_level=0.3)))


# BLIP-2's tiny checkpoint-free run takes the crc32 word-hash tokens
CASES = {"git": (JaxCaptionerConfig.tiny(), False), "qformer_lora": (JaxQFormerConfig.tiny(), True),
         "blip2_lora": (JaxBlip2Config.tiny(), True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_captioner_matches_jax(case, shared_init, tmp_path):
    jcfg, lora = CASES[case]
    if lora:
        jcfg = dataclasses.replace(jcfg, lora_rank=4)
    jsplits, psplits = _splits(jax_synthetic), _splits(synthetic_captioning)
    scores = np.random.default_rng(0).random(len(psplits["train"]))
    common = dict(epochs=2, batch_size=16, es_patience=5, lora_only=lora)
    jres = jcap.train_captioner(jcap.CaptionTrainConfig(model_cfg=jcfg, **common), jsplits,
                                detector_scores=scores, out_dir=tmp_path / "jax")
    pres = pcap.train_captioner(pcap.CaptionTrainConfig(model_cfg=port_config(jcfg), **common),
                                psplits, detector_scores=scores, out_dir=tmp_path / "port",
                                device=CPU)
    assert pres["n_train"] == jres["n_train"] == int((scores <= np.percentile(scores, 60)).sum())
    assert abs(pres["val_loss_best"] - jres["val_loss_best"]) <= REL * abs(jres["val_loss_best"])
    assert abs(pres["train_loss_final"] - jres["train_loss_final"]) <= REL * abs(jres["train_loss_final"])
    det_j, det_p = (np.load(tmp_path / s / "detection_scores.npy") for s in ("jax", "port"))
    assert det_p.shape == det_j.shape == (len(psplits["test"]),) and np.abs(det_p - det_j).max() <= 1e-4
    assert abs(pres["test_loss_detection_AUROC"] - jres["test_loss_detection_AUROC"]) <= 1e-6
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())
    with open(tmp_path / "port" / "captions.pkl", "rb") as f:
        caps = pickle.load(f)
    assert len(caps["generated"]) == len(caps["gold"]) == len(psplits["test"])
    with open(tmp_path / "jax" / "flip_labels.pkl", "rb") as f:
        flips = pickle.load(f)
    with open(tmp_path / "port" / "flip_labels.pkl", "rb") as f:
        assert np.array_equal(pickle.load(f), flips)


def test_frozen_vision_is_bit_stable_and_the_rest_trains():
    from lemon_tpu_torch.models.captioner import init_captioner
    from lemon_tpu_torch.models.qformer import QFormerConfig

    splits = _splits(synthetic_captioning, 40)
    mc = QFormerConfig.tiny()
    before = {k: v.clone() for k, v in init_captioner(mc, 0).state_dict().items()}
    cfg = pcap.CaptionTrainConfig(epochs=1, batch_size=16, model_cfg=mc, learning_rate=1e-2, weight_decay=0.5)
    after = pcap.train_captioner(cfg, splits, device=CPU)["model"].state_dict()
    for k, v in before.items():
        if k.startswith("visual."):
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["lm_head.weight"], before["lm_head.weight"])


def test_a_split_smaller_than_a_batch_still_trains():
    splits = _splits(synthetic_captioning, 40)
    splits["train"] = splits["train"].subset(np.arange(10))
    res = pcap.train_captioner(pcap.CaptionTrainConfig(epochs=2, batch_size=16, es_patience=5), splits, device=CPU)
    assert np.isfinite(res["val_loss_best"]) and np.isfinite(res["train_loss_final"])


def _run(main, argv):
    stdout, stderr = sys.stdout, sys.stderr
    try:
        return main(argv)
    finally:
        sys.stdout, sys.stderr = stdout, stderr


def test_cli_matches_the_jax_cli(shared_init, tmp_path):
    from lemon_tpu.cli.run_downstream import main as jax_main
    from lemon_tpu_torch.cli.run_downstream import main as port_main

    argv = ["--task", "captioning", "--synthetic_n", "80", "--epochs", "2", "--batch_size", "16", "--lora",
            "--captioner_arch", "blip2"]
    _run(jax_main, ["--output_dir", str(tmp_path / "jax"), "--platform", "cpu", *argv])
    res = _run(port_main, ["--output_dir", str(tmp_path / "port"), "--platform", "cpu", *argv])
    names = {p.name for p in (tmp_path / "port").iterdir()}
    assert names == {p.name for p in (tmp_path / "jax").iterdir()} >= {"captions.pkl", "results.json", "done"}
    got, want = (json.loads((tmp_path / s / "results.json").read_text()) for s in ("port", "jax"))
    assert set(got) == set(want)
    assert abs(got["val_loss_best"] - want["val_loss_best"]) <= REL * abs(want["val_loss_best"])
    det_j, det_p = (np.load(tmp_path / s / "detection_scores.npy") for s in ("jax", "port"))
    assert np.abs(det_p - det_j).max() <= 1e-4
    assert res["val_loss_best"] == got["val_loss_best"]
    assert "Device: cpu" in (tmp_path / "port" / "out.txt").read_text()


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    from lemon_tpu_torch.cli.run_downstream import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(port_main, ["--task", "captioning", "--output_dir", str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcap.train_captioner(pcap.CaptionTrainConfig(), _splits(synthetic_captioning, 40))
