"""The port's AUM and Datamap baselines (``lemon_tpu_torch.baselines.
training_dependent`` behind ``run_baseline --baseline aum|datamap``) against
the JAX package's, on the CPU.

Both packages train from one set of weights: the JAX ``init_classifier``
variables of the backbone, handed to the port through
``classifier_from_flax`` (each package's ``init_classifier`` is replaced
inside the test; the JAX one by the same init under ``jax.jit``). SGD with
momentum has no division by the gradient, so the two trajectories stay
close. Bars: every per-epoch probability (the ``{val,test}_epoch_{e}.pkl``
``prediction``) and every ``pred_score`` within 1e-5 for the ViTs (aum
through the CLIs on the google-ViT, datamap on the CLIP tower);
``true_class``, ``label_flips`` and the frame's labels exact; the same
output files.

The ResNet is held at the JAX package's own bar for it, 2e-4
(tests/test_torch_backbones.py:62), at a rate of 1e-5. At the CLI's 1e-3 its
training on these splits is chaotic in fp32: BatchNorm over a batch of 32
(a padded last batch repeats one row) amplifies rounding, and the port
against itself with 1 and 4 CPU threads (another summation order) differs
by 0.14 in a probability after 2 epochs, JAX against the port by 0.17. At
1e-5 JAX and the port stay within 1.2e-4. Its probabilities are the
train-mode softmax, on batch statistics, so BatchNorm's running variance
(unbiased in torch, biased in flax) does not reach them.
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import lemon_tpu.baselines.training_dependent as jtd
from lemon_tpu.models import classifier as jclf
from lemon_tpu.models import torch_backbones as jtb
from lemon_tpu.models.clip import ClipConfig as JaxClipConfig
from lemon_tpu_torch.baselines import training_dependent as ptd
from lemon_tpu_torch.models import torch_backbones as tb
from lemon_tpu_torch.models.classifier import ImageClassifier, TvResNetSpec
from lemon_tpu_torch.models.clip import ClipConfig
from lemon_tpu_torch.models.convert import classifier_from_flax

TOL = 1e-5
JAX_CONFIG = {ClipConfig.tiny(): JaxClipConfig.tiny(), TvResNetSpec.tiny(): jclf.TvResNetSpec.tiny(),
              tb.GoogleViTConfig.tiny(): jtb.GoogleViTConfig.tiny()}


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
    monkeypatch.setattr(jtd, "init_classifier", _jax_init)

    def port_init(cfg, num_classes, seed=0, freeze_backbone=False, backbone_state=None):
        model = ImageClassifier(cfg, num_classes, freeze_backbone=freeze_backbone)
        model.load_state_dict(classifier_from_flax(_jax_init(JAX_CONFIG[cfg], num_classes, seed)[1]))
        return model

    monkeypatch.setattr(ptd, "init_classifier", port_init)
    monkeypatch.setenv("LEMON_TPU_NO_COMPILE_CACHE", "1")


def _assert_runs_match(jax_dir, port_dir, epochs, tol=TOL):
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in jax_dir.iterdir())
    for phase in ("val", "test"):
        for e in range(epochs):
            with open(port_dir / f"{phase}_epoch_{e}.pkl", "rb") as f:
                ours = pickle.load(f)
            with open(jax_dir / f"{phase}_epoch_{e}.pkl", "rb") as f:
                theirs = pickle.load(f)
            assert ours.keys() == theirs.keys() == {"prediction", "true_class", "label_flips"}
            np.testing.assert_allclose(ours["prediction"], theirs["prediction"], rtol=tol, atol=tol)
            np.testing.assert_array_equal(ours["true_class"], theirs["true_class"])
            np.testing.assert_array_equal(ours["label_flips"], theirs["label_flips"])
    ours, theirs = pd.read_csv(port_dir / "scores.csv"), pd.read_csv(jax_dir / "scores.csv")
    assert list(ours.columns) == list(theirs.columns)
    for col in ("sset", "idx", "actual_label", "noisy_label", "is_mislabel"):
        assert ours[col].tolist() == theirs[col].tolist(), col
    np.testing.assert_allclose(ours["pred_score"], theirs["pred_score"], rtol=tol, atol=tol)
    assert np.isfinite(ours["pred_score"]).all()


@pytest.mark.parametrize("method,backbone,lr,tol", [("datamap", "clip", 1e-3, TOL), ("aum", "resnet50_tiny", 1e-5, 2e-4)])
def test_run_training_dependent_matches_jax(tmp_path, one_init, method, backbone, lr, tol):
    from lemon_tpu.baselines.common import BaselineConfig as JaxConfig
    from lemon_tpu_torch.baselines.common import BaselineConfig
    from lemon_tpu_torch.cli.run_baseline import classifier_config

    kw = dict(dataset="synthetic", noise_type="symmetric", noise_level=0.4, synthetic_n=120, batch_size=32,
              method=method)
    cfg = classifier_config(backbone)
    jres = jtd.run_training_dependent(JaxConfig(**kw), tmp_path / "jax", epochs=2, lr=lr,
                                      model_cfg=None if cfg is None else JAX_CONFIG[cfg])
    res = ptd.run_training_dependent(BaselineConfig(platform="cpu", **kw), tmp_path / "port", epochs=2, lr=lr,
                                     model_cfg=cfg)
    _assert_runs_match(tmp_path / "jax", tmp_path / "port", epochs=2, tol=tol)
    for split in ("val", "test"):
        assert res["agg_results"][split].keys() == jres["agg_results"][split].keys()
    assert float(np.load(tmp_path / "port" / "runtime.npy")[0]) > 0


def _run(main, argv):
    stdout, stderr = sys.stdout, sys.stderr
    try:  # the CLIs tee stdout/stderr into their output directories
        return main(argv)
    finally:
        sys.stdout, sys.stderr = stdout, stderr


def test_cli_aum_matches_jax_cli(tmp_path, one_init):
    """``run_baseline --baseline aum`` through both CLIs (the google-ViT
    backbone at test scale); then the reference's runnable configuration,
    ``--img_base_name resnet50`` at test scale, through the port's CLI alone:
    the JAX CLI's files, finite scores, and BatchNorm's running statistics
    moved by the training."""
    from lemon_tpu.cli.run_baseline import main as jax_main
    from lemon_tpu_torch.cli.run_baseline import main as port_main

    argv = ["--baseline", "aum", "--dataset", "synthetic", "--noise_type", "symmetric", "--noise_level", "0.4",
            "--synthetic_n", "120", "--epochs", "2", "--batch_size", "32"]
    _run(jax_main, ["--output_dir", str(tmp_path / "jax"), "--platform", "cpu", *argv, "--img_base_name", "vit_tiny"])
    res = _run(port_main, ["--output_dir", str(tmp_path / "port"), "--platform", "cpu", *argv,
                           "--img_base_name", "vit_tiny"])
    _assert_runs_match(tmp_path / "jax", tmp_path / "port", epochs=2)
    assert set(res) >= {"df", "agg_results"} and (tmp_path / "port" / "done").exists()

    models = []
    init = ptd.init_classifier
    ptd.init_classifier = lambda *a, **k: models.append(init(*a, **k)) or models[-1]
    try:
        _run(port_main, ["--output_dir", str(tmp_path / "rn"), "--platform", "cpu", *argv,
                         "--img_base_name", "resnet50_tiny"])
    finally:
        ptd.init_classifier = init
    assert sorted(p.name for p in (tmp_path / "rn").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert np.isfinite(pd.read_csv(tmp_path / "rn" / "scores.csv")["pred_score"]).all()
    bn = models[0].backbone.bn1
    assert int(bn.num_batches_tracked) == 2 * 5 and not torch.equal(bn.running_var, torch.ones_like(bn.running_var))


def test_unknown_method_and_the_default_device(monkeypatch):
    from lemon_tpu_torch.baselines.common import BaselineConfig

    with pytest.raises(ValueError, match="'aum' or 'datamap'"):
        ptd.run_training_dependent(BaselineConfig(platform="cpu", method="dis_x"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptd.run_training_dependent(BaselineConfig(method="aum", dataset="synthetic"))
