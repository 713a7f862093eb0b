"""The port's downstream classification (``lemon_tpu_torch.train.downstream``,
``cli/run_downstream.py``, ``data/datasets.load_cifar10c``) against the JAX
package's, on the CPU.

Both packages start from one set of weights: the JAX ``init_classifier``
variables, handed to the port through ``classifier_from_flax`` (each
package's ``init_classifier`` is replaced inside the test; the JAX one by
the same init under ``jax.jit``, which only compiles it faster). The data
are the seeded synthetic splits of both packages. Bars:

- after one AdamW step (one epoch of one batch): the updated parameters
  within 1e-5 of JAX's, except where a gradient is rounding noise. AdamW's
  first step divides each gradient by its own magnitude, so such an element
  (the key bias, whose exact gradient is 0 under the softmax) moves by
  about the learning rate with the sign of the noise: every element within
  2 x the learning rate, and at most 1e-3 of the elements beyond 1e-5. The
  validation and test probabilities within 1e-5, the predictions and
  accuracies equal;
- ``freeze_backbone``: the backbone takes no gradient but AdamW's decay,
  ``p·(1 - lr·wd)``, within 1e-7 relative, as JAX's stop_gradient gives it;
- a 2-epoch run of both CLIs: the same output files, probabilities within
  1e-4 (two epochs of AdamW on the rounding noise above), predictions and
  accuracies equal;
- the CIFAR-10-C robustness mode on both checkpoints (``ckpt.pt`` and
  ``ckpt.msgpack``): predictions and the results pkls equal.
"""

import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lemon_tpu.train.downstream as jds
from lemon_tpu.data.datasets import get_dataset as jax_get_dataset
from lemon_tpu.data.datasets import load_cifar10c as jax_load_cifar10c
from lemon_tpu.models import classifier as jclf
from lemon_tpu.models.clip import ClipConfig as JaxClipConfig
from lemon_tpu_torch.data.datasets import get_dataset, load_cifar10c
from lemon_tpu_torch.models.classifier import ImageClassifier
from lemon_tpu_torch.models.clip import ClipConfig
from lemon_tpu_torch.models.convert import classifier_from_flax
from lemon_tpu_torch.train import downstream as pds

CPU = torch.device("cpu")
LR, WD = 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(cfg, num_classes, seed=0, freeze_backbone=False, backbone_params=None):
    model = jclf.ImageClassifier(cfg, num_classes, freeze_backbone=freeze_backbone)
    res = cfg.image_resolution
    return model, jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, res, res, 3), jnp.float32))


@pytest.fixture
def one_init(monkeypatch):
    """Both packages' trainers start from the JAX init of their config."""
    monkeypatch.setattr(jds, "init_classifier", _jax_init)

    def port_init(cfg, num_classes, seed=0, freeze_backbone=False, backbone_state=None):
        jcfg = JaxClipConfig.tiny() if cfg == ClipConfig.tiny() else JaxClipConfig.vit_b32()
        model = ImageClassifier(cfg, num_classes, freeze_backbone=freeze_backbone)
        model.load_state_dict(classifier_from_flax(_jax_init(jcfg, num_classes, seed)[1]))
        return model

    monkeypatch.setattr(pds, "init_classifier", port_init)
    monkeypatch.setenv("LEMON_TPU_NO_COMPILE_CACHE", "1")


@pytest.fixture()
def cifar10c_root(tmp_path, monkeypatch):
    """The CIFAR-10-C layout of tests/test_downstream.py: {corruption}.npy
    stacks 5 severities of a 20-image 'test set', labels.npy shared."""
    rng = np.random.default_rng(0)
    base = tmp_path / "CIFAR-10-C"
    base.mkdir(parents=True)
    labels = np.tile(rng.integers(0, 10, 20), 5)
    images = rng.integers(0, 256, (100, 32, 32, 3), np.uint8)
    np.save(base / "gaussian_noise.npy", images)
    np.save(base / "labels.npy", labels)
    monkeypatch.setenv("LEMON_TPU_DATA_ROOT", str(tmp_path))
    return tmp_path, images, labels


def _splits(n=120, seed=0, noise=0.2):
    return (dict(zip(("train", "val", "test"), jax_get_dataset("synthetic", seed, noise_level=noise, synthetic_n=n))),
            dict(zip(("train", "val", "test"), get_dataset("synthetic", seed, noise_level=noise, synthetic_n=n))))


def _jax_checkpoint(path, freeze_backbone=False):
    """A JAX ckpt.msgpack as the port's state dict."""
    from flax import serialization

    _, template = _jax_init(JaxClipConfig.tiny(), 10, 0, freeze_backbone)
    return classifier_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       serialization.from_bytes(template, path.read_bytes())))


def test_load_cifar10c_matches_jax(cifar10c_root):
    _, images, labels = cifar10c_root
    for severity in (None, 3):
        ours, theirs = load_cifar10c("gaussian_noise", severity), jax_load_cifar10c("gaussian_noise", severity)
        for field in ("images", "y_clean", "y_noisy"):
            np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))
    np.testing.assert_array_equal(load_cifar10c("gaussian_noise", 3).images, images[40:60])
    np.testing.assert_array_equal(load_cifar10c("gaussian_noise").y_clean, labels)
    with pytest.raises(ValueError, match="cifar10c needs corruption_name"):
        get_dataset("cifar10c", data_seed=0)
    with pytest.raises(ValueError, match="severity must be 1-5"):
        load_cifar10c("gaussian_noise", 6)


def test_filter_and_detector_scores_match_jax(tmp_path):
    import pandas as pd

    jsplits, splits = _splits(n=200, noise=0.4)
    rng = np.random.default_rng(1)
    scores = splits["train"].is_mislabel + rng.uniform(0, 0.1, len(splits["train"]))
    for pct in (30.0, 60.0, 100.0):
        ours, theirs = pds.filter_split(splits["train"], scores, pct), jds.filter_split(jsplits["train"], scores, pct)
        np.testing.assert_array_equal(ours.images, theirs.images)
        np.testing.assert_array_equal(ours.y_noisy, theirs.y_noisy)
    # a baseline's dists.npy + datasplit.npy, and a run_lemon scores CSV
    tags = np.array(["train"] * 5 + ["val"] * 3 + ["test"] * 2, dtype=object)
    np.save(tmp_path / "dists.npy", np.arange(10.0))
    np.save(tmp_path / "datasplit.npy", tags)
    pd.DataFrame({"sset": tags, "pred_score": np.arange(10.0) / 2}).to_csv(tmp_path / "s_scores.csv")
    for name in ("dists.npy", "s_scores.csv"):
        for split in ("train", "test"):
            np.testing.assert_array_equal(pds.load_detector_scores(tmp_path / name, split),
                                          jds.load_detector_scores(tmp_path / name, split))
    pd.DataFrame({"x": [1]}).to_csv(tmp_path / "bad.csv")
    with pytest.raises(ValueError, match="not a detector scores CSV"):
        pds.load_detector_scores(tmp_path / "bad.csv")


@pytest.mark.parametrize("freeze_backbone", [False, True])
def test_one_step_matches_jax(tmp_path, one_init, freeze_backbone):
    """One epoch of one batch (the train split fits in it), then the
    evaluation of the updated weights."""
    jsplits, splits = _splits()
    kw = dict(num_classes=10, epochs=1, batch_size=128, learning_rate=LR, weight_decay=WD,
              freeze_backbone=freeze_backbone)
    jres = jds.train_downstream(jds.DownstreamConfig(model_cfg=JaxClipConfig.tiny(), **kw), jsplits,
                                out_dir=tmp_path / "jax")
    res = pds.train_downstream(pds.DownstreamConfig(model_cfg=ClipConfig.tiny(), **kw), splits,
                               out_dir=tmp_path / "port", device=CPU)
    before = classifier_from_flax(_jax_init(JaxClipConfig.tiny(), 10)[1])
    want = _jax_checkpoint(tmp_path / "jax" / "ckpt.msgpack", freeze_backbone)
    got = torch.load(tmp_path / "port" / "ckpt.pt", weights_only=True)
    assert got.keys() == want.keys()
    diff = torch.cat([(got[k] - want[k]).abs().reshape(-1) for k in got])
    assert float(diff.max()) <= 2 * LR and float((diff > 1e-5).float().mean()) <= 1e-3
    assert not torch.equal(got["head.weight"], before["head.weight"])  # the head learned
    if freeze_backbone:
        for k in (k for k in got if k.startswith("backbone.")):
            decayed = before[k] * (1 - LR * WD)
            torch.testing.assert_close(got[k], decayed, rtol=1e-7, atol=0.0)
            torch.testing.assert_close(want[k], decayed, rtol=1e-7, atol=0.0)
    for split in ("val", "test"):
        np.testing.assert_allclose(np.load(tmp_path / "port" / f"{split}_probs.npy"),
                                   np.load(tmp_path / "jax" / f"{split}_probs.npy"), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"{split}_pred_y.npy"),
                                      np.load(tmp_path / "jax" / f"{split}_pred_y.npy"))
        assert res[split]["accuracy"] == jres[split]["accuracy"]
        assert res[split]["worst_group_accuracy"] == jres[split]["worst_group_accuracy"]
    assert res["val_acc_best"] == jres["val_acc_best"]


def _run(main, argv):
    stdout, stderr = sys.stdout, sys.stderr
    try:  # the CLIs tee stdout/stderr into their output directories
        return main(argv)
    finally:
        sys.stdout, sys.stderr = stdout, stderr


def test_cli_two_epochs_and_robustness_match_jax(tmp_path, one_init, cifar10c_root):
    from lemon_tpu.cli.run_downstream import main as jax_main
    from lemon_tpu_torch.cli.run_downstream import main as port_main

    argv = ["--task", "classification", "--dataset", "synthetic", "--noise_level", "0.2", "--synthetic_n", "160",
            "--epochs", "2", "--batch_size", "32"]
    _run(jax_main, ["--output_dir", str(tmp_path / "jax"), "--platform", "cpu", *argv])
    res = _run(port_main, ["--output_dir", str(tmp_path / "port"), "--platform", "cpu", *argv])
    jax_files = {p.name for p in (tmp_path / "jax").iterdir()}
    assert {p.name for p in (tmp_path / "port").iterdir()} == jax_files - {"ckpt.msgpack"} | {"ckpt.pt"}
    jres = json.loads((tmp_path / "jax" / "results.json").read_text())
    assert json.loads((tmp_path / "port" / "results.json").read_text()).keys() == jres.keys()
    for split in ("val", "test"):
        np.testing.assert_allclose(np.load(tmp_path / "port" / f"{split}_probs.npy"),
                                   np.load(tmp_path / "jax" / f"{split}_probs.npy"), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"{split}_pred_y.npy"),
                                      np.load(tmp_path / "jax" / f"{split}_pred_y.npy"))
        assert res[split]["accuracy"] == jres[split]["accuracy"]
        assert res[split]["groups"] == {int(k): v for k, v in jres[split]["groups"].items()}
    assert "Device: cpu" in (tmp_path / "port" / "out.txt").read_text()

    # robustness mode: each package's checkpoint, twice (the reference loops over 3 seeds)
    rob = ["--task", "classification", "--epochs", "0", "--cifar10_corruption_name", "gaussian_noise"]
    _run(jax_main, ["--output_dir", str(tmp_path / "jax_rob"), "--platform", "cpu", *rob, "--eval_checkpoints",
                    *[str(tmp_path / "jax" / "ckpt.msgpack")] * 2])
    out = _run(port_main, ["--output_dir", str(tmp_path / "port_rob"), "--platform", "cpu", *rob,
                           "--eval_checkpoints", *[str(tmp_path / "port" / "ckpt.pt")] * 2])
    assert {p.name for p in (tmp_path / "port_rob").iterdir()} == {p.name for p in (tmp_path / "jax_rob").iterdir()}
    for mc in (0, 1):
        for kind in ("pred", "true"):
            name = f"test_{kind}_y_gaussian_noise_{mc}.npy"
            np.testing.assert_array_equal(np.load(tmp_path / "port_rob" / name), np.load(tmp_path / "jax_rob" / name))
        with open(tmp_path / "port_rob" / f"results_gaussian_noise_{mc}.pkl", "rb") as f:
            ours = pickle.load(f)
        with open(tmp_path / "jax_rob" / f"results_gaussian_noise_{mc}.pkl", "rb") as f:
            assert ours == pickle.load(f) == out[mc]


def test_cli_refusals(tmp_path, monkeypatch):
    from lemon_tpu_torch.cli.run_downstream import main as port_main

    # captioning, once refused, now runs (tests/test_torch_captioning.py holds it to JAX)
    res = _run(port_main, ["--task", "captioning", "--output_dir", str(tmp_path / "cap"), "--platform", "cpu",
                           "--synthetic_n", "60", "--epochs", "1", "--batch_size", "16"])
    assert (tmp_path / "cap" / "done").exists() and np.isfinite(res["val_loss_best"])
    with pytest.raises(SystemExit, match="needs --eval_checkpoints"):
        _run(port_main, ["--task", "classification", "--output_dir", str(tmp_path / "r"), "--platform", "cpu",
                         "--epochs", "0", "--cifar10_corruption_name", "fog"])
    with pytest.raises(SystemExit, match="requires --dataset cifar10c"):
        _run(port_main, ["--task", "classification", "--output_dir", str(tmp_path / "r"), "--platform", "cpu",
                         "--cifar10_corruption_name", "fog"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(port_main, ["--task", "classification", "--output_dir", str(tmp_path / "d")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pds.train_downstream(pds.DownstreamConfig(), _splits()[1])
