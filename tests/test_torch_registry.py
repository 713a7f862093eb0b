"""The port's registry models and OpenAI-format checkpoints against the JAX
package.

An OpenAI-format state dict (fused ``attn.in_proj_weight``; the layout of
``chexzero`` and the from-scratch ViT-B/16 models) made from a numpy seed
goes through both packages' loaders; the embeddings of the two towers must
agree within 1e-5. Every ``--clip_model`` name of the JAX CLI is accepted by
the port's CLI (which also takes ``rn50``), and the port's registry configs
equal the JAX ones field by field (the port's ``attention_impl="plain"`` is
the JAX ``'xla'``). ``rn50`` and ``biomed_clip`` build, each with its own
random-init fingerprint, and the CLI runs both (at tiny sizes here).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemon_tpu.cli.run_lemon import build_parser as jax_parser
from lemon_tpu.models import clip as jclip
from lemon_tpu.models import registry as jregistry
from lemon_tpu_torch.cli.run_lemon import build_parser
from lemon_tpu_torch.models import registry
from lemon_tpu_torch.models.clip import ClipConfig, ClipModel
from lemon_tpu_torch.models.loader import detect_and_convert, openai_config_from_state_dict

REPO_ROOT = Path(__file__).resolve().parents[1]
NEW_NAMES = ["chexzero", "mimic_clip_from_scratch_random", "mimic_clip_from_scratch_cat", "cc3m_clip_from_scratch"]
# ViT-B/16 geometry at narrow width: 64 px in 16 px patches, context 24
OPENAI_CFG = ClipConfig(
    embed_dim=48, image_resolution=64, vision_layers=2, vision_width=128, vision_patch_size=16,
    context_length=24, vocab_size=500, text_width=64, text_heads=1, text_layers=3,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _openai_state_dict(cfg: ClipConfig, seed: int) -> dict:
    """A random OpenAI-format ViT CLIP state dict (chexzero_clip.py layout)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape, scale=None):
        fan_in = shape[-1] if len(shape) > 1 else 1
        sd[name] = (rng.standard_normal(shape) * (scale or fan_in ** -0.5)).astype(np.float32)

    def blocks(prefix, width, n):
        for i in range(n):
            p = f"{prefix}.{i}"
            put(f"{p}.attn.in_proj_weight", 3 * width, width)
            put(f"{p}.attn.in_proj_bias", 3 * width, scale=0.02)
            put(f"{p}.attn.out_proj.weight", width, width)
            put(f"{p}.attn.out_proj.bias", width, scale=0.02)
            for ln in ("ln_1", "ln_2"):
                sd[f"{p}.{ln}.weight"] = (1 + 0.1 * rng.standard_normal(width)).astype(np.float32)
                put(f"{p}.{ln}.bias", width, scale=0.1)
            put(f"{p}.mlp.c_fc.weight", 4 * width, width)
            put(f"{p}.mlp.c_fc.bias", 4 * width, scale=0.02)
            put(f"{p}.mlp.c_proj.weight", width, 4 * width)
            put(f"{p}.mlp.c_proj.bias", width, scale=0.02)

    vw, tw, g = cfg.vision_width, cfg.text_width, cfg.image_resolution // cfg.vision_patch_size
    put("visual.conv1.weight", vw, 3, cfg.vision_patch_size, cfg.vision_patch_size, scale=0.05)
    put("visual.class_embedding", vw, scale=0.1)
    put("visual.positional_embedding", g * g + 1, vw, scale=0.1)
    for ln in ("visual.ln_pre", "visual.ln_post", "ln_final"):
        w = tw if ln == "ln_final" else vw
        sd[f"{ln}.weight"] = (1 + 0.1 * rng.standard_normal(w)).astype(np.float32)
        put(f"{ln}.bias", w, scale=0.1)
    blocks("visual.transformer.resblocks", vw, cfg.vision_layers)
    put("visual.proj", vw, cfg.embed_dim)
    put("token_embedding.weight", cfg.vocab_size, tw, scale=0.1)
    put("positional_embedding", cfg.context_length, tw, scale=0.1)
    blocks("transformer.resblocks", tw, cfg.text_layers)
    put("text_projection", tw, cfg.embed_dim)
    sd["logit_scale"] = np.array(np.log(1 / 0.07), np.float32)
    return sd


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((b, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    tokens = np.zeros((b, cfg.context_length), np.int32)
    for r in range(b):  # SOT, a few ids, EOT (the max id), zero padding
        n = 4 + 5 * r
        tokens[r, 0] = cfg.vocab_size - 2
        tokens[r, 1 : n + 1] = rng.integers(1, cfg.vocab_size - 2, n)
        tokens[r, n + 1] = cfg.vocab_size - 1
    return pixels, tokens


def _jax_fields(cfg: ClipConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "attention_impl"}


def test_openai_state_dict_config_matches_jax():
    sd = _openai_state_dict(OPENAI_CFG, seed=0)
    cfg = openai_config_from_state_dict(sd)
    assert cfg == OPENAI_CFG
    _, jcfg = jregistry.detect_and_convert(sd)
    assert _jax_fields(cfg) == {k: getattr(jcfg, k) for k in _jax_fields(cfg)}


@pytest.mark.parametrize("attention_impl", ["plain", "flash"])
def test_openai_checkpoint_loads_like_the_jax_loader(tmp_path, attention_impl):
    """Through both registries' checkpoint loaders (a ``.pt`` file, as a
    chexzero checkpoint arrives), then both packages' towers."""
    sd = _openai_state_dict(OPENAI_CFG, seed=1)
    path = tmp_path / "chexzero.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    state, cfg = registry.load_checkpoint(path, registry.MODEL_CONFIGS["chexzero"])
    assert cfg == OPENAI_CFG
    model = ClipModel(dataclasses.replace(cfg, attention_impl=attention_impl))
    model.load_state_dict(state)
    jparams, jcfg = jregistry._load_params(path, jregistry.MODEL_CONFIGS["chexzero"])
    jmodel = jclip.ClipModel(jcfg)
    pixels, tokens = _inputs(cfg, 3, seed=2)
    with torch.no_grad():
        img = model.eval().encode_image(torch.from_numpy(pixels)).numpy()
        txt = model.encode_text(torch.from_numpy(tokens).long()).numpy()
    jimg = np.asarray(jmodel.apply(jparams, jnp.asarray(pixels), method="encode_image"))
    jtxt = np.asarray(jmodel.apply(jparams, jnp.asarray(tokens), method="encode_text"))
    assert img.shape == (3, 48) and txt.shape == (3, 48)
    np.testing.assert_allclose(img, jimg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(txt, jtxt, rtol=1e-5, atol=1e-5)


def test_resnet_openai_state_dict_raises():
    """Without ``visual.proj`` a state dict is read as a ModifiedResNet (rn50)
    one, as chexzero_clip.py:420 reads it; a ViT state dict without it has no
    ResNet layers and raises, in both packages."""
    sd = _openai_state_dict(OPENAI_CFG, seed=0)
    del sd["visual.proj"]
    with pytest.raises(KeyError, match="visual.layer1.0.conv1.weight"):
        detect_and_convert(sd)
    with pytest.raises(KeyError, match="visual.layer1.0.conv1.weight"):
        jregistry.detect_and_convert(sd)


def test_cli_takes_the_jax_clip_model_choices():
    def choices(parser):
        return next(a.choices for a in parser._actions if a.dest == "clip_model")

    ours, theirs = choices(build_parser()), choices(jax_parser())
    assert ours[: len(theirs)] == theirs and ours[len(theirs) :] == ["rn50", "laion_vit_h14"]
    for name in NEW_NAMES + ["rn50", "biomed_clip", "laion_vit_h14"]:
        assert build_parser().parse_args(["--output_dir", "x", "--clip_model", name]).clip_model == name


@pytest.mark.parametrize("name", NEW_NAMES + ["huggingface_clip", "tiny", "rn50"])
def test_registry_config_matches_jax(name, monkeypatch):
    """The config ``create_encoder`` builds for a name (random init skipped:
    the full-width towers are allocated, not filled)."""
    monkeypatch.setattr(registry, "init_weights", lambda model, seed: model)
    monkeypatch.setattr(registry, "checkpoint_path", lambda name: None)
    cfg = registry.create_encoder(name, device=torch.device("cpu")).cfg
    assert cfg == registry.MODEL_CONFIGS[name] and cfg.attention_impl == "plain"
    jcfg = jregistry.MODEL_CONFIGS[name]
    assert jcfg.attention_impl == "xla"
    assert _jax_fields(cfg) == {k: getattr(jcfg, k) for k in _jax_fields(cfg)}


def test_from_scratch_presets():
    b16 = ClipConfig.from_scratch_mimic()
    assert (b16.vision_patch_size, b16.embed_dim, b16.context_length) == (16, 768, 256)
    assert b16.image_resolution // b16.vision_patch_size == 14  # 196 patches + CLS = 197 tokens
    assert ClipConfig.vit_b16(768, 77) == registry.MODEL_CONFIGS["cc3m_clip_from_scratch"]
    assert _jax_fields(b16) == {k: getattr(jclip.ClipConfig.from_scratch_mimic(), k) for k in _jax_fields(b16)}


def test_random_init_cache_key_folds_in_the_model(monkeypatch):
    """Without a checkpoint, two models with one seed are two sets of
    weights, so their --embedding_cache keys differ; one model twice is one
    key."""
    from lemon_tpu_torch.data.datasets import synthetic_captioning

    monkeypatch.setattr(registry, "checkpoint_path", lambda name: None)
    split = synthetic_captioning(40, data_seed=0)[0]
    texts = list(split.sentence)
    cpu = torch.device("cpu")
    key = lambda name: registry.create_encoder(name, cpu, seed=0).cache_key(split, texts)  # noqa: E731
    tiny = key("tiny")
    assert key("huggingface_clip") != tiny
    assert key("tiny") == tiny


def test_checkpoint_fingerprint_is_the_file():
    cfg = registry.MODEL_CONFIGS["tiny"]
    a, b = (registry.checkpoint_fingerprint(None, 0, registry.MODEL_CONFIGS[n]) for n in ("tiny", "huggingface_clip"))
    assert a != b and a == registry.checkpoint_fingerprint(None, 0, cfg)
    assert registry.checkpoint_fingerprint(None, 1, cfg) != a
    path = REPO_ROOT / "pyproject.toml"
    st = path.stat()
    assert registry.checkpoint_fingerprint(path, 0, cfg) == f"{path.resolve()}:{st.st_mtime_ns}:{st.st_size}"


@pytest.mark.parametrize("name", ["rn50", "biomed_clip"])
def test_new_models_build(name, monkeypatch):
    """``rn50`` (ModifiedResNet) and ``biomed_clip`` (timm ViT-B/16 +
    PubMedBERT) at full width, the random init skipped; their random-init
    fingerprints differ from each other's and from every other model's."""
    from lemon_tpu_torch.models.biomed import BiomedClipConfig, BiomedClipModel

    monkeypatch.setattr(registry, "init_weights", lambda model, seed: model)
    monkeypatch.setattr(registry, "init_biomed", lambda model, seed: model)
    monkeypatch.setattr(registry, "checkpoint_path", lambda name: None)
    monkeypatch.delenv("LEMON_TPU_BIOMED_VOCAB", raising=False)
    enc = registry.create_encoder(name, device=torch.device("cpu"))
    if name == "rn50":
        assert enc.cfg.is_resnet and enc.cfg.embed_dim == 1024 and enc.cfg.v_heads == 32
        assert type(enc.model.visual).__name__ == "ResNetVisionTower"
    else:
        assert isinstance(enc.model, BiomedClipModel) and enc.cfg == BiomedClipConfig()
        assert (enc.cfg.embed_dim, enc.cfg.context_length, enc.cfg.image_resolution) == (512, 256, 224)
        tokens = enc._tokenize(["a chest x-ray"])  # clipped CLIP-BPE ids without a vocabulary
        assert tokens.shape == (1, 256) and tokens.max() < enc.cfg.text.vocab_size
    prints = {registry.checkpoint_fingerprint(None, 0, c)
              for c in (*registry.MODEL_CONFIGS.values(), BiomedClipConfig())}
    assert len(prints) == len(set(map(repr, registry.MODEL_CONFIGS.values()))) + 1


@pytest.mark.parametrize("name", ["rn50", "biomed_clip"])
def test_cli_runs_the_new_models(name, tmp_path, monkeypatch):
    """The CLI path of each name, with the registry's config cut to a tiny
    one (the full-width towers are the GPU smoke test's)."""
    import sys

    from lemon_tpu_torch import detect
    from lemon_tpu_torch.cli.run_lemon import main
    from lemon_tpu_torch.models.biomed import BiomedClipConfig

    monkeypatch.setitem(registry.MODEL_CONFIGS, "rn50", ClipConfig.tiny_rn())
    monkeypatch.setattr(registry, "BiomedClipConfig", BiomedClipConfig.tiny)
    monkeypatch.setattr(registry, "checkpoint_path", lambda name: None)
    detect._ENCODER_CACHE.clear()
    stdout, stderr = sys.stdout, sys.stderr
    try:
        main(["--output_dir", str(tmp_path), "--platform", "cpu", "--dataset", "synthetic_caption", "--noise_type",
              "random", "--synthetic_n", "120", "--clip_model", name, "--knn_k", "3", "--batch_size", "32"])
    finally:
        sys.stdout, sys.stderr = stdout, stderr
        detect._ENCODER_CACHE.clear()
    import pandas as pd

    scores = pd.read_csv(tmp_path / "know_val_labels_scores.csv")["pred_score"].to_numpy()
    assert (tmp_path / "done").exists() and len(scores) == 120 and np.isfinite(scores).all()
