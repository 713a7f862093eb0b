"""LAION's OpenCLIP ViT-H/14 in the port (registry ``laion_vit_h14``).

Its entry at the published widths; its checkpoints, which must load with
the entry's heads of 80 and exact GELU (the shapes cannot tell them from
``width // 64`` heads and QuickGELU); the port at a tiny config of its
shape against the benchmark's plain reference
(``portbench/reference/clip.py``), on weights from ``portbench.weights``;
and every benchmark configuration that names a registry entry against it.

The tiny shape, ``H_TINY``: vision 320 wide in 4 heads of 80, the narrowest
width at which ``width // 64`` heads (5) are another count, as 20 and 16
are at 1280; text in heads of 64, as published; patch 14; exact GELU.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from lemon_tpu_torch.core.precision import Precision
from lemon_tpu_torch.models import registry
from lemon_tpu_torch.models.clip import ClipConfig, ClipModel
from lemon_tpu_torch.models.convert import from_flax_params
from lemon_tpu_torch.models.loader import from_openai_state_dict, openai_config_from_state_dict
from portbench.arch import openai_clip
from portbench.reference import clip as reference
from portbench.weights import make_weights
from test_torch_registry import _openai_state_dict

REPO_ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
H_TINY = ClipConfig(embed_dim=48, image_resolution=28, vision_layers=2, vision_width=320, vision_patch_size=14,
                    vision_heads=4, context_length=16, vocab_size=1000, text_width=128, text_heads=2, text_layers=2,
                    quick_gelu=False)
# bf16 against the fp32 reference, rms of the L2-normalised embeddings of
# both towers over 64 rows: bf16 products, softmax and residual stream leave
# 1.07e-3 and 1.15e-3 on seeds 0 and 1; the same model with QuickGELU reads
# 1.51e-3 and 1.65e-3, with heads of 64 about 3e-2; fp32 reads under 1e-6
BF16_RMS = 1.3e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(cfg: ClipConfig) -> dict:
    """The benchmark's configuration keys of ``cfg`` (heads as resolved)."""
    return {k: cfg.v_heads if k == "vision_heads" else getattr(cfg, k) for k in openai_clip.KEYS}


def test_the_registry_entry_is_vit_h14():
    cfg = registry.MODEL_CONFIGS["laion_vit_h14"]
    assert cfg == ClipConfig.vit_h14()
    assert (cfg.vision_layers, cfg.vision_width, cfg.v_heads, cfg.vision_width // cfg.v_heads) == (32, 1280, 16, 80)
    assert (cfg.vision_patch_size, cfg.image_resolution, cfg.grid ** 2 + 1) == (14, 224, 257)
    assert (cfg.text_layers, cfg.text_width, cfg.text_heads, cfg.context_length, cfg.vocab_size) == (24, 1024, 16, 77,
                                                                                                  49408)
    assert cfg.embed_dim == 1024 and not cfg.quick_gelu and cfg.attention_impl == "plain"
    # open_clip's counts for ViT-H-14: 632.08M in the image tower, 354.03M in the text tower
    shapes = reference.param_shapes(_keys(cfg))
    count = lambda tower: sum(math.prod(s) for n, s in shapes if n.startswith(tower))  # noqa: E731
    assert round(count("visual.") / 1e6, 2) == 632.08 and round(count("text.") / 1e6, 2) == 354.03


def test_benchmark_configs_build_their_registry_entry():
    """A cell measures what ``run_lemon --clip_model <registry>`` builds:
    each configuration that names an entry holds its values, key for key."""
    named = 0
    for path in sorted((REPO_ROOT / "portbench" / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        if cfg.get("registry") in registry.MODEL_CONFIGS:
            named += 1
            assert {k: cfg[k] for k in openai_clip.KEYS} == _keys(registry.MODEL_CONFIGS[cfg["registry"]]), path.name
    assert named >= 4


def _hf_state_dict(sd: dict, cfg: ClipConfig) -> dict:
    """The same weights under transformers' ``CLIPModel`` names."""
    out = {"logit_scale": sd["logit_scale"], "visual_projection.weight": sd["visual.proj"].T,
           "text_projection.weight": sd["text_projection"].T}
    ve, te = "vision_model.embeddings", "text_model.embeddings"
    out.update({f"{ve}.patch_embedding.weight": sd["visual.conv1.weight"],
                f"{ve}.class_embedding": sd["visual.class_embedding"],
                f"{ve}.position_embedding.weight": sd["visual.positional_embedding"],
                f"{te}.token_embedding.weight": sd["token_embedding.weight"],
                f"{te}.position_embedding.weight": sd["positional_embedding"]})
    for ours, theirs in (("visual.ln_pre", "vision_model.pre_layrnorm"), ("visual.ln_post", "vision_model.post_layernorm"),
                         ("ln_final", "text_model.final_layer_norm")):
        for leaf in ("weight", "bias"):
            out[f"{theirs}.{leaf}"] = sd[f"{ours}.{leaf}"]
    for ours, theirs, n in (("visual.transformer.resblocks", "vision_model.encoder.layers", cfg.vision_layers),
                            ("transformer.resblocks", "text_model.encoder.layers", cfg.text_layers)):
        for i in range(n):
            a, b = f"{ours}.{i}", f"{theirs}.{i}"
            for leaf in ("weight", "bias"):
                for x, name in zip(np.split(sd[f"{a}.attn.in_proj_{leaf}"], 3), ("q_proj", "k_proj", "v_proj")):
                    out[f"{b}.self_attn.{name}.{leaf}"] = x
                for x, y in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                             ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
                    out[f"{b}.{y}.{leaf}"] = sd[f"{a}.{x}.{leaf}"]
    return out


def _inputs(cfg: ClipConfig, b: int, seed: int):
    """Normalised NHWC pixels, and ids: SOT, a few ids, EOT (the largest), zero padding."""
    rng = np.random.default_rng(seed)
    pixels = torch.from_numpy(rng.standard_normal((b, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32))
    tokens = np.zeros((b, cfg.context_length), np.int64)
    for r in range(b):
        n = 2 + r % (cfg.context_length - 3)
        tokens[r, 0] = cfg.vocab_size - 2
        tokens[r, 1:n + 1] = rng.integers(1, cfg.vocab_size - 2, n)
        tokens[r, n + 1] = cfg.vocab_size - 1
    return pixels, torch.from_numpy(tokens)


@torch.no_grad()
def _features(model: ClipModel, pixels, tokens):
    img, txt = model.eval().features(pixels, tokens)
    return img.numpy(), txt.numpy()


@pytest.mark.parametrize("fmt", ["openai", "hf"])
def test_a_vit_h14_checkpoint_loads_with_its_heads_and_gelu(fmt, tmp_path, monkeypatch):
    """Through ``create_encoder``: an OpenAI-format file by ``checkpoint=``
    (``--checkpoint``), an HF one by ``LEMON_TPU_CKPT_LAION_VIT_H14``, under
    the entry (cut to ``H_TINY``), embed exactly as the same weights loaded
    straight into ``ClipModel(H_TINY)``. From the shapes alone they would
    load as 5 heads of 64 with QuickGELU, and embed otherwise; under an entry
    of other shapes they still load, with the shapes' config."""
    sd = _openai_state_dict(H_TINY, seed=3)
    path = tmp_path / f"laion_vit_h14_{fmt}.bin"
    torch.save({k: torch.from_numpy(v) for k, v in (sd if fmt == "openai" else _hf_state_dict(sd, H_TINY)).items()},
               path)
    monkeypatch.setitem(registry.MODEL_CONFIGS, "laion_vit_h14", H_TINY)
    if fmt == "hf":
        monkeypatch.setenv("LEMON_TPU_CKPT_LAION_VIT_H14", str(path))
    else:
        monkeypatch.delenv("LEMON_TPU_CKPT_LAION_VIT_H14", raising=False)
    encoder = registry.create_encoder("laion_vit_h14", CPU, checkpoint=str(path) if fmt == "openai" else None,
                                      precision=Precision.fp32())
    assert encoder.cfg == H_TINY

    state = from_flax_params(from_openai_state_dict(sd, H_TINY)[0])
    direct = ClipModel(H_TINY)
    direct.load_state_dict(state)
    pixels, tokens = _inputs(H_TINY, 6, seed=4)
    want = _features(direct, pixels, tokens)
    got = _features(encoder.model, pixels, tokens)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])

    shaped = openai_config_from_state_dict(sd)
    assert (shaped.v_heads, shaped.quick_gelu) == (5, True)
    wrong = ClipModel(shaped)
    wrong.load_state_dict(state)
    assert all(np.abs(a - b).max() > 1e-3 for a, b in zip(_features(wrong, pixels, tokens), want))
    state, cfg = registry.load_checkpoint(path, registry.MODEL_CONFIGS["huggingface_clip"])
    assert cfg == shaped


def _against_reference(cfg: ClipConfig, precision: Precision, seed: int):
    """The port's embeddings of 64 rows and the fp32 reference's, on the
    benchmark's weights for ``H_TINY`` (drawn by ``make_weights``)."""
    bench_cfg = dict(_keys(H_TINY), precision="fp32")
    W = make_weights(bench_cfg, seed, CPU)
    model = ClipModel(cfg, precision)
    model.load_state_dict(W)
    pixels, tokens = _inputs(H_TINY, 64, seed)
    with torch.no_grad():
        want = reference.encode_image(W, bench_cfg, pixels), reference.encode_text(W, bench_cfg, tokens)
    return _features(model, pixels, tokens), tuple(x.numpy() for x in want)


def test_fp32_matches_the_plain_reference():
    """Both towers in fp32 within 1e-5 of the reference (fp32 products, TF32
    off: on a card TF32 would round the operands to 10 bits, a 1e-3 change
    that this limit would catch). On the CPU only the order of the sums can
    differ."""
    got, want = _against_reference(H_TINY, Precision.fp32(), seed=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_matches_the_plain_reference_and_a_wrong_model_does_not(seed):
    """bf16 within ``BF16_RMS`` of the fp32 reference, a limit the fp32 path
    meets and the same weights in bf16 as QuickGELU, or as ``width // 64``
    heads, exceed."""
    rms = lambda got, want: float(np.sqrt(np.mean(np.square(np.concatenate(got) - np.concatenate(want)))))  # noqa: E731
    assert rms(*_against_reference(H_TINY, Precision.bf16(), seed)) < BF16_RMS
    assert rms(*_against_reference(H_TINY, Precision.fp32(), seed)) < 1e-6
    for wrong in (dataclasses.replace(H_TINY, quick_gelu=True), dataclasses.replace(H_TINY, vision_heads=None)):
        assert rms(*_against_reference(wrong, Precision.bf16(), seed)) > BF16_RMS


def test_run_lemon_takes_laion_vit_h14(tmp_path, monkeypatch):
    """``run_lemon --clip_model laion_vit_h14`` through the registry, its
    config cut to ``H_TINY`` (the full-width towers are the card's)."""
    import sys

    import pandas as pd

    from lemon_tpu_torch import detect
    from lemon_tpu_torch.cli.run_lemon import main

    monkeypatch.setitem(registry.MODEL_CONFIGS, "laion_vit_h14", dataclasses.replace(H_TINY, vocab_size=49408))
    monkeypatch.setattr(registry, "checkpoint_path", lambda name: None)
    detect._ENCODER_CACHE.clear()
    stdout, stderr = sys.stdout, sys.stderr
    try:
        main(["--output_dir", str(tmp_path), "--platform", "cpu", "--dataset", "synthetic_caption", "--noise_type",
              "random", "--synthetic_n", "120", "--clip_model", "laion_vit_h14", "--knn_k", "3", "--batch_size", "32"])
    finally:
        sys.stdout, sys.stderr = stdout, stderr
        detect._ENCODER_CACHE.clear()
    scores = pd.read_csv(tmp_path / "know_val_labels_scores.csv")["pred_score"].to_numpy()
    assert (tmp_path / "done").exists() and len(scores) == 120 and np.isfinite(scores).all()
