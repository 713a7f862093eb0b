"""The port's classifier and its backbones (``lemon_tpu_torch.models.classifier``,
``torch_backbones``, ``convert.classifier_from_flax``) against the JAX
package's, at tiny sizes.

Both packages hold the same weights: a JAX ``init_classifier`` tree with
every leaf perturbed by seeded noise (a fresh init has zero biases and
identity BatchNorms, which would hide a swapped or missing one), converted
with ``classifier_from_flax``; the pixels are seeded numpy. Bars:

- logits in eval and train mode within 1e-5 for the two ViTs (fp32 with
  another summation order) and 2e-4 for the ResNet (the JAX package's own
  bar for it, tests/test_torch_backbones.py:62, deeper fp32 sums through
  BatchNorm);
- BatchNorm's update: the running means within 1e-6 of JAX's; the running
  variances equal JAX's once its biased batch term is made unbiased, that is
  ``0.9·old + (jax_new - 0.9·old)·n/(n-1)`` with ``n`` the rows each layer
  normalised, within 1e-6 relative (torch keeps the unbiased running
  variance, ROADMAP: handled divergences);
- the torchvision and HF loaders against the JAX converters on the same
  state dicts (the torchvision shim of tests/reference_harness; a seeded
  state dict in HF ViTModel's layout): forward within the bars above;
- ``classification_loss`` (CE, BCE, masked) within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemon_tpu.models import classifier as jclf
from lemon_tpu.models import torch_backbones as jtb
from lemon_tpu.models.clip import ClipConfig as JaxClipConfig
from lemon_tpu_torch.models import torch_backbones as tb
from lemon_tpu_torch.models.classifier import (
    ImageClassifier,
    TvResNetSpec,
    apply_classifier_train,
    classification_loss,
    init_classifier,
)
from lemon_tpu_torch.models.clip import ClipConfig
from lemon_tpu_torch.models.convert import classifier_from_flax

BACKBONES = {
    "clip": (JaxClipConfig.tiny, ClipConfig.tiny, 1e-5),
    "resnet50": (jclf.TvResNetSpec.tiny, TvResNetSpec.tiny, 2e-4),
    "vit": (jtb.GoogleViTConfig.tiny, tb.GoogleViTConfig.tiny, 1e-5),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_init_classifier(jcfg, num_classes, seed=0, freeze_backbone=False, backbone_params=None):
    """``lemon_tpu.models.classifier.init_classifier`` with ``model.init``
    under ``jax.jit`` (the same variables, compiled once rather than op by op)."""
    assert backbone_params is None
    model = jclf.ImageClassifier(jcfg, num_classes, freeze_backbone=freeze_backbone)
    res = jcfg.image_resolution
    return model, jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, res, res, 3), jnp.float32))


def perturbed_jax_classifier(jcfg, num_classes=10, seed=0, freeze_backbone=False):
    """(JAX model, variables): the JAX init, every parameter perturbed and
    the BatchNorm statistics moved (variances kept positive)."""
    model, variables = jax_init_classifier(jcfg, num_classes, seed, freeze_backbone)
    rng = np.random.default_rng(seed + 100)
    out = {"params": jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (np.asarray(a) * rng.uniform(0.75, 1.25, np.shape(a))
                       + 0.1 * rng.standard_normal(np.shape(a)) * (np.asarray(a) == 0)).astype(np.float32),
            variables["batch_stats"])
    return model, out


def port_classifier(cfg, variables, num_classes=10, freeze_backbone=False):
    model = ImageClassifier(cfg, num_classes, freeze_backbone=freeze_backbone)
    model.load_state_dict(classifier_from_flax(variables))
    return model


def _pixels(cfg, b=4, seed=1):
    res = cfg.image_resolution
    return np.random.default_rng(seed).standard_normal((b, res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("name", BACKBONES)
def test_eval_and_train_forward_match_jax(name):
    jcfg_fn, cfg_fn, tol = BACKBONES[name]
    jmodel, variables = perturbed_jax_classifier(jcfg_fn())
    model = port_classifier(cfg_fn(), variables)
    x = _pixels(cfg_fn())
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x)).numpy()
        got_train = apply_classifier_train(model, torch.from_numpy(x)).numpy()
    want_eval = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    want_train, _ = jax.jit(jclf.apply_classifier_train, static_argnums=0)(jmodel, variables, jnp.asarray(x))
    assert got_eval.shape == (4, 10)
    np.testing.assert_allclose(got_eval, want_eval, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_train, np.asarray(want_train), rtol=tol, atol=tol)
    if name != "resnet50":  # no train-only layer: train and eval agree
        np.testing.assert_array_equal(got_train, got_eval)


def test_batchnorm_update_against_jax():
    jmodel, variables = perturbed_jax_classifier(jclf.TvResNetSpec.tiny())
    model = port_classifier(TvResNetSpec.tiny(), variables)
    rows = {}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(
                lambda m, inp, name=mod_name: rows.__setitem__(name, inp[0].numel() // inp[0].shape[1]))
    old = {k: v.clone() for k, v in model.state_dict().items()}
    x = _pixels(TvResNetSpec.tiny(), seed=2)
    with torch.no_grad():
        apply_classifier_train(model, torch.from_numpy(x))
    _, new_vars = jax.jit(jclf.apply_classifier_train, static_argnums=0)(jmodel, variables, jnp.asarray(x))
    jax_sd = classifier_from_flax(jax.tree_util.tree_map(np.asarray, new_vars))
    sd = model.state_dict()
    assert len(rows) == 17  # the stem, 3 per block and one downsample per stage
    for name, n in rows.items():
        key = f"{name}.running_var"
        np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(), jax_sd[f"{name}.running_mean"].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        base = 0.9 * old[key].double()
        unbiased = base + (jax_sd[key].double() - base) * n / (n - 1)
        np.testing.assert_allclose(sd[key].double().numpy(), unbiased.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
        assert not torch.allclose(sd[key], jax_sd[key], rtol=1e-6, atol=1e-7)  # the divergence shows
        assert int(sd[f"{name}.num_batches_tracked"]) == 1


def test_torchvision_state_dict_loads_as_jax_converts_it():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent / "reference_harness" / "shims"))
    try:
        from torchvision.models import resnet50
    finally:
        sys.path.pop(0)
    torch.manual_seed(0)
    tv = resnet50(width=8, layers=(1, 1, 1, 1), num_classes=32)
    with torch.no_grad():
        for mod in tv.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.add_(torch.randn_like(mod.running_mean) * 0.1)
                mod.running_var.mul_(torch.rand_like(mod.running_var) * 0.5 + 0.75)
    sd = {k: v.numpy() for k, v in tv.state_dict().items() if not k.endswith("num_batches_tracked")}
    ours = tb.TvResNet50(embed_dim=32, stage_sizes=(1, 1, 1, 1), width=8)
    ours.load_state_dict(tb.from_tv_resnet50(sd))
    assert set(ours.state_dict()) == set(tv.state_dict())  # torchvision's names, buffers included
    jvars = jtb.convert_tv_resnet50(sd, embed_dim=32, stage_sizes=(1, 1, 1, 1))
    x = _pixels(TvResNetSpec.tiny(), seed=3)
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jtb.TvResNet50(embed_dim=32, stage_sizes=(1, 1, 1, 1), width=8).apply)(
        jvars, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _hf_vit_state_dict(cfg, seed=0):
    """A random state dict in HF ViTModel's layout (its names and shapes)."""
    rng = np.random.default_rng(seed)
    w, n = cfg.width, (cfg.image_size // cfg.patch_size) ** 2 + 1
    sd = {"embeddings.patch_embeddings.projection.weight": (w, 3, cfg.patch_size, cfg.patch_size),
          "embeddings.patch_embeddings.projection.bias": (w,), "embeddings.cls_token": (1, 1, w),
          "embeddings.position_embeddings": (1, n, w), "layernorm.weight": (w,), "layernorm.bias": (w,)}
    for i in range(cfg.layers):
        for name, out, inp in (("layernorm_before", w, None), ("attention.attention.query", w, w),
                               ("attention.attention.key", w, w), ("attention.attention.value", w, w),
                               ("attention.output.dense", w, w), ("layernorm_after", w, None),
                               ("intermediate.dense", cfg.mlp_dim, w), ("output.dense", w, cfg.mlp_dim)):
            sd[f"encoder.layer.{i}.{name}.weight"] = (out,) if inp is None else (out, inp)
            sd[f"encoder.layer.{i}.{name}.bias"] = (out,)
    return {k: (0.1 * rng.standard_normal(shape)).astype(np.float32) for k, shape in sd.items()}


@pytest.mark.parametrize("prefix", ["", "vit."])
def test_hf_vit_state_dict_loads_as_jax_converts_it(prefix):
    """HF ViTModel's layout, and ViTForImageClassification's ``vit.``-prefixed one."""
    cfg = tb.GoogleViTConfig.tiny()
    sd = {prefix + k: v for k, v in _hf_vit_state_dict(cfg).items()}
    if prefix:
        sd["classifier.weight"] = np.zeros((10, cfg.width), np.float32)
    ours = tb.GoogleViTEncoder(cfg)
    ours.load_state_dict(tb.from_hf_vit(sd, cfg))
    jcfg = jtb.GoogleViTConfig.tiny()
    jvars = jtb.convert_hf_vit(sd, jcfg)
    x = _pixels(cfg, b=3, seed=4)
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jtb.GoogleViTEncoder(jcfg).apply)(jvars, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("classes", [10, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_classification_loss_matches_jax(classes, masked):
    rng = np.random.default_rng(classes)
    logits = (3 * rng.standard_normal((8, classes))).astype(np.float32)
    labels = rng.integers(0, max(classes, 2), 8).astype(np.int32)
    mask = (np.arange(8) < 5) if masked else None
    want = float(jclf.classification_loss(jnp.asarray(logits), jnp.asarray(labels),
                                          None if mask is None else jnp.asarray(mask)))
    got = float(classification_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                                    None if mask is None else torch.from_numpy(mask)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_init_and_warm_start():
    """The port's own init: every backbone builds from a seed (the same
    weights from the same seed), the google-ViT's CLS token at zero and
    BatchNorm at identity; a backbone state dict warm-starts the backbone
    and leaves the head as the seed made it."""
    a = init_classifier(tb.GoogleViTConfig.tiny(), 10, seed=3)
    b = init_classifier(tb.GoogleViTConfig.tiny(), 10, seed=3)
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())
    assert not a.backbone.cls_token.any() and float(a.backbone.position_embeddings.detach().std()) == pytest.approx(0.02, rel=0.2)
    r = init_classifier(TvResNetSpec.tiny(), 10, seed=0)
    assert torch.equal(r.backbone.bn1.weight, torch.ones(8)) and torch.equal(r.backbone.bn1.running_var, torch.ones(8))
    c = init_classifier(ClipConfig.tiny(), 10, seed=1)
    warm = init_classifier(ClipConfig.tiny(), 10, seed=2, backbone_state=c.backbone.state_dict())
    assert all(torch.equal(warm.backbone.state_dict()[k], v) for k, v in c.backbone.state_dict().items())
    assert torch.equal(warm.head.weight, init_classifier(ClipConfig.tiny(), 10, seed=2).head.weight)
    with pytest.raises(TypeError, match="no classifier backbone"):
        ImageClassifier(object(), 10)
