"""The port's CLIP towers, weights bridge, HF loader and preprocessing
against the JAX package.

Both packages hold the same weights: a JAX ``init_params`` tree goes through
``from_flax_params``; an HF checkpoint goes through each package's loader.
Bars: tower outputs rtol 1e-4 / atol 1e-4 (tests/test_clip_parity.py's bar;
fp32 with different summation order); preprocessing within PIL's uint8
rounding (tests/test_image.py's bars).
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lemon_tpu.models import clip as jclip
from lemon_tpu.models.registry import _load_params
from lemon_tpu.ops.image import preprocess_device as jax_preprocess
from lemon_tpu.ops.image import preprocess_pil
from lemon_tpu_torch.models.clip import ClipConfig, ClipModel, init_weights
from lemon_tpu_torch.models.convert import from_flax_params, load_flax_npz
from lemon_tpu_torch.models.registry import load_checkpoint
from lemon_tpu_torch.ops.image import preprocess_device

HARNESS = Path(__file__).parent / "reference_harness"

CONFIGS = {
    "tiny": ClipConfig.tiny(),
    # full ViT-B/32 widths (768 vision, 512 text, 512 embed), one layer each
    "vit_b32_1layer": ClipConfig(vision_layers=1, text_layers=1),
    # the from-scratch MIMIC model's widths: ViT-B/16 (197 tokens), embed
    # 768, text context 256, one layer each
    "vit_b16_ctx256_1layer": dataclasses.replace(ClipConfig.from_scratch_mimic(), vision_layers=1, text_layers=1),
}
JAX_IMPL = {"plain": "xla", "flash": "pallas"}


def _jax_cfg(cfg: ClipConfig) -> jclip.ClipConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["attention_impl"] = JAX_IMPL[cfg.attention_impl]
    return jclip.ClipConfig(**fields)


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((b, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    tokens = np.zeros((b, cfg.context_length), np.int32)
    for r in range(b):  # SOT, a few ids, EOT (the max id), zero padding
        n = 3 + r
        tokens[r, 0] = cfg.vocab_size - 2
        tokens[r, 1 : n + 1] = rng.integers(1, cfg.vocab_size - 2, n)
        tokens[r, n + 1] = cfg.vocab_size - 1
    return pixels, tokens


def _torch_model(state, cfg):
    model = ClipModel(cfg)
    model.load_state_dict(state)
    return model.eval()


def _encode(model, pixels, tokens):
    with torch.no_grad():
        return (model.encode_image(torch.from_numpy(pixels)).numpy(),
                model.encode_text(torch.from_numpy(tokens).long()).numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_towers_match_jax_with_shared_weights(name):
    cfg = CONFIGS[name]
    jmodel, params = jclip.init_params(_jax_cfg(cfg), seed=1)
    model = _torch_model(from_flax_params(params), cfg)
    pixels, tokens = _inputs(cfg, 4, seed=0)
    img, txt = _encode(model, pixels, tokens)
    jimg = np.asarray(jmodel.apply(params, jnp.asarray(pixels), method="encode_image"))
    jtxt = np.asarray(jmodel.apply(params, jnp.asarray(tokens), method="encode_text"))
    assert img.shape == (4, cfg.embed_dim) and txt.shape == (4, cfg.embed_dim)
    np.testing.assert_allclose(img, jimg, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(txt, jtxt, rtol=1e-4, atol=1e-4)


def test_flax_npz_round_trip(tmp_path):
    """The "/"-flattened .npz layout the registries read."""
    cfg = CONFIGS["tiny"]
    _, params = jclip.init_params(_jax_cfg(cfg), seed=2)
    flat = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = np.asarray(val)

    walk(params, "")
    np.savez(tmp_path / "tiny.npz", **flat)
    a = from_flax_params(params)
    b = from_flax_params(load_flax_npz(tmp_path / "tiny.npz"))
    assert a.keys() == b.keys() and a.keys() == ClipModel(cfg).state_dict().keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_hf_checkpoint_loads_like_the_jax_loader(tmp_path):
    sys.path.insert(0, str(HARNESS))
    try:
        from fixture import build_checkpoint
    finally:
        sys.path.pop(0)
    ckpt = build_checkpoint(tmp_path / "ckpt")["state_dict_pt"]
    state, cfg = load_checkpoint(ckpt, ClipConfig.vit_b32())
    assert (cfg.vision_width, cfg.text_width, cfg.embed_dim, cfg.vision_layers) == (64, 64, 32, 2)
    model = _torch_model(state, cfg)
    jparams, jcfg = _load_params(ckpt, jclip.ClipConfig.vit_b32())
    jmodel = jclip.ClipModel(jcfg)
    pixels, tokens = _inputs(cfg, 3, seed=4)
    img, txt = _encode(model, pixels, tokens)
    np.testing.assert_allclose(img, np.asarray(jmodel.apply(jparams, jnp.asarray(pixels), method="encode_image")), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(txt, np.asarray(jmodel.apply(jparams, jnp.asarray(tokens), method="encode_text")), rtol=1e-4, atol=1e-4)


def test_random_init_is_seeded_and_scaled():
    cfg = CONFIGS["tiny"]
    a = init_weights(ClipModel(cfg), seed=0).state_dict()
    b = init_weights(ClipModel(cfg), seed=0).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["visual.blocks.0.mlp_fc.weight"]  # lecun_normal: variance 1/fan_in
    assert abs(w.std().item() * np.sqrt(w.shape[1]) - 1.0) < 0.1
    assert a["visual.blocks.0.ln_1.weight"].eq(1).all()


@pytest.mark.parametrize("h,w", [(32, 32), (224, 224), (480, 640), (96, 128)])
def test_preprocess_matches_pil_and_jax(h, w):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack(
        [128 + 100 * np.sin(2 * np.pi * xx / w * (c + 1)) * np.cos(2 * np.pi * yy / h * (c + 2)) for c in range(3)],
        axis=-1,
    )
    img = np.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
    ours = preprocess_device(img[None], device=torch.device("cpu")).numpy()[0]
    ref = preprocess_pil(Image.fromarray(img))
    assert ours.shape == ref.shape == (224, 224, 3)
    diff = np.abs(ours - ref)
    assert diff.max() < 0.022, diff.max()  # one uint8 step is ~0.0146
    assert (diff > 1e-6).mean() < 1e-3
    jax_out = np.asarray(jax_preprocess(img[None]))[0]
    assert (np.abs(ours - jax_out) > 1e-6).mean() < 1e-3


def test_encoder_paths_agree():
    """encode_images / encode_texts (tail-padded batches) and embed_split
    (prefetched batches) give the same L2-normalised embeddings."""
    from lemon_tpu_torch.data.datasets import synthetic_captioning
    from lemon_tpu_torch.models.encoder import ClipEncoder

    cfg = CONFIGS["tiny"]
    enc = ClipEncoder(init_weights(ClipModel(cfg), seed=0), torch.device("cpu"), batch_size=16)
    split = synthetic_captioning(60, data_seed=0)[0]  # 48 rows: 3 batches
    texts = list(split.sentence)
    img, txt = enc.embed_split(split, texts)
    assert img.shape == txt.shape == (48, cfg.embed_dim)
    np.testing.assert_allclose(np.linalg.norm(img, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(enc.encode_images(split.images[:40]), img[:40], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(enc.encode_texts(texts[:40]), txt[:40], rtol=1e-5, atol=1e-6)
