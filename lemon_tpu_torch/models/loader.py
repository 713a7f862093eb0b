"""CLIP checkpoints -> flax-layout parameter trees.

The numpy logic of lemon_tpu/models/loader.py for the two families the
towers load: HuggingFace ``CLIPModel`` state dicts and OpenAI-format ones
(fused ``attn.in_proj_weight``; ``chexzero``, the from-scratch ViT-B/16
models and ``rn50``, chexzero_clip.py:419-479). An OpenAI-format state dict
with ``visual.proj`` holds a ViT tower, one without it a ModifiedResNet
(:147-215, :231). The tree goes through the same bridge as a JAX tree
(:func:`lemon_tpu_torch.models.convert.from_flax_params`), so every
checkpoint route shares one converter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from lemon_tpu_torch.models.clip import ClipConfig


def load_torch_file(path) -> Dict[str, np.ndarray]:
    """Read a torch ``.pt``/``.bin`` checkpoint into numpy (host side)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v) for k, v in obj.items()}


def _conv_to_patch_kernel(w: np.ndarray) -> np.ndarray:
    """(width, 3, P, P) conv kernel -> (P*P*3, width), patch elements in
    (ph, pw, channel) order."""
    return np.transpose(w, (2, 3, 1, 0)).reshape(-1, w.shape[0])


def _block_params(q_w, q_b, k_w, k_b, v_w, v_b, out_w, out_b, ln1_w, ln1_b, ln2_w, ln2_b, fc_w, fc_b, proj_w, proj_b):
    """One transformer block; torch Linear weights are (out, in)."""
    return {
        "ln_1": {"scale": ln1_w, "bias": ln1_b},
        "ln_2": {"scale": ln2_w, "bias": ln2_b},
        "attn": {
            "qkv": {"kernel": np.concatenate([q_w.T, k_w.T, v_w.T], axis=1), "bias": np.concatenate([q_b, k_b, v_b])},
            "out": {"kernel": out_w.T, "bias": out_b},
        },
        "mlp_fc": {"kernel": fc_w.T, "bias": fc_b},
        "mlp_proj": {"kernel": proj_w.T, "bias": proj_b},
    }


def hf_config_from_state_dict(sd: Mapping[str, np.ndarray]) -> ClipConfig:
    vision_width = sd["vision_model.embeddings.class_embedding"].shape[0]
    patch = sd["vision_model.embeddings.patch_embedding.weight"].shape[-1]
    n_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
    grid = int(round((n_pos - 1) ** 0.5))
    text_width = sd["text_model.final_layer_norm.weight"].shape[0]
    return ClipConfig(
        embed_dim=sd["text_projection.weight"].shape[0],
        image_resolution=patch * grid,
        vision_layers=len({k.split(".")[3] for k in sd if k.startswith("vision_model.encoder.layers.")}),
        vision_width=vision_width,
        vision_patch_size=patch,
        context_length=sd["text_model.embeddings.position_embedding.weight"].shape[0],
        vocab_size=sd["text_model.embeddings.token_embedding.weight"].shape[0],
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=len({k.split(".")[3] for k in sd if k.startswith("text_model.encoder.layers.")}),
    )


def from_hf_state_dict(sd: Mapping[str, np.ndarray], cfg: ClipConfig | None = None):
    """A transformers ``CLIPModel`` state dict -> (flax-layout tree, config)."""
    cfg = cfg or hf_config_from_state_dict(sd)

    def block(prefix: str) -> dict:
        g = lambda name: np.asarray(sd[f"{prefix}.{name}"])
        return _block_params(
            g("self_attn.q_proj.weight"), g("self_attn.q_proj.bias"),
            g("self_attn.k_proj.weight"), g("self_attn.k_proj.bias"),
            g("self_attn.v_proj.weight"), g("self_attn.v_proj.bias"),
            g("self_attn.out_proj.weight"), g("self_attn.out_proj.bias"),
            g("layer_norm1.weight"), g("layer_norm1.bias"),
            g("layer_norm2.weight"), g("layer_norm2.bias"),
            g("mlp.fc1.weight"), g("mlp.fc1.bias"),
            g("mlp.fc2.weight"), g("mlp.fc2.bias"),
        )

    a = lambda key: np.asarray(sd[key])
    params = {
        "visual": {
            "patch_embedding": _conv_to_patch_kernel(a("vision_model.embeddings.patch_embedding.weight")),
            "class_embedding": a("vision_model.embeddings.class_embedding"),
            "positional_embedding": a("vision_model.embeddings.position_embedding.weight"),
            "ln_pre": {"scale": a("vision_model.pre_layrnorm.weight"), "bias": a("vision_model.pre_layrnorm.bias")},
            "transformer": {f"block_{i}": block(f"vision_model.encoder.layers.{i}") for i in range(cfg.vision_layers)},
            "ln_post": {"scale": a("vision_model.post_layernorm.weight"), "bias": a("vision_model.post_layernorm.bias")},
            "proj": a("visual_projection.weight").T,
        },
        "text": {
            "token_embedding": a("text_model.embeddings.token_embedding.weight"),
            "positional_embedding": a("text_model.embeddings.position_embedding.weight"),
            "transformer": {f"block_{i}": block(f"text_model.encoder.layers.{i}") for i in range(cfg.text_layers)},
            "ln_final": {"scale": a("text_model.final_layer_norm.weight"), "bias": a("text_model.final_layer_norm.bias")},
            "text_projection": a("text_projection.weight").T,
        },
        "logit_scale": a("logit_scale"),
    }
    return {"params": params}, cfg


def _text_config_fields(sd: Mapping[str, np.ndarray]) -> dict:
    text_width = sd["ln_final.weight"].shape[0]
    return dict(
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}),
    )


def rn_config_from_state_dict(sd: Mapping[str, np.ndarray]) -> ClipConfig:
    """Shapes of an OpenAI-format ModifiedResNet state dict (the RN branch of
    chexzero_clip.py:429-436)."""
    counts = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}.")}) for b in (1, 2, 3, 4))
    vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
    n_pos = sd["visual.attnpool.positional_embedding"].shape[0]
    output_width = int(round((n_pos - 1) ** 0.5))
    if output_width ** 2 + 1 != n_pos:
        raise ValueError(f"visual.attnpool.positional_embedding has {n_pos} rows, not a square grid plus one")
    return ClipConfig(
        image_resolution=output_width * 32,
        vision_layers=counts,
        vision_width=vision_width,
        **_text_config_fields(sd),
    )


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch (out, in, kh, kw) -> the flax conv kernel (kh, kw, in, out)."""
    return np.transpose(w, (2, 3, 1, 0))


def _bn_params(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"scale": np.asarray(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"]),
            "mean": np.asarray(sd[f"{prefix}.running_mean"]), "var": np.asarray(sd[f"{prefix}.running_var"])}


def _rn_visual_params(sd: Mapping[str, np.ndarray], cfg: ClipConfig) -> dict:
    """``visual.*`` of a ModifiedResNet state dict -> the ResNet tower's tree."""
    conv = lambda key: {"kernel": _conv_kernel(np.asarray(sd[key]))}  # noqa: E731
    visual = {}
    for i in (1, 2, 3):
        visual[f"stem_conv{i}"] = conv(f"visual.conv{i}.weight")
        visual[f"stem_bn{i}"] = _bn_params(sd, f"visual.bn{i}")
    for stage, n_blocks in enumerate(cfg.vision_layers, start=1):
        for j in range(n_blocks):
            p = f"visual.layer{stage}.{j}"
            blk = {}
            for c in (1, 2, 3):
                blk[f"conv{c}"] = conv(f"{p}.conv{c}.weight")
                blk[f"bn{c}"] = _bn_params(sd, f"{p}.bn{c}")
            # the downsample Sequential: "-1" the average pool (no parameters), "0" conv, "1" bn
            if f"{p}.downsample.0.weight" in sd:
                blk["down_conv"] = conv(f"{p}.downsample.0.weight")
                blk["down_bn"] = _bn_params(sd, f"{p}.downsample.1")
            visual[f"layer{stage}_{j}"] = blk
    visual["attnpool"] = {
        "positional_embedding": np.asarray(sd["visual.attnpool.positional_embedding"]),
        **{proj: {"kernel": np.asarray(sd[f"visual.attnpool.{proj}.weight"]).T,
                  "bias": np.asarray(sd[f"visual.attnpool.{proj}.bias"])}
           for proj in ("q_proj", "k_proj", "v_proj", "c_proj")},
    }
    return visual


def openai_config_from_state_dict(sd: Mapping[str, np.ndarray]) -> ClipConfig:
    """Shapes of an OpenAI-format ViT state dict (chexzero_clip.py:419-456)."""
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    return ClipConfig(
        image_resolution=patch * grid,
        vision_layers=len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")}),
        vision_width=sd["visual.conv1.weight"].shape[0],
        vision_patch_size=patch,
        **_text_config_fields(sd),
    )


def from_openai_state_dict(sd: Mapping[str, np.ndarray], cfg: ClipConfig | None = None):
    """An OpenAI-format CLIP state dict (fused in_proj) -> (flax-layout
    tree, config). ``visual.proj`` marks the ViT tower, its absence the
    ModifiedResNet one (chexzero_clip.py:420)."""
    is_vit = "visual.proj" in sd
    if cfg is None:
        cfg = openai_config_from_state_dict(sd) if is_vit else rn_config_from_state_dict(sd)

    def block(prefix: str) -> dict:
        g = lambda name: np.asarray(sd[f"{prefix}.{name}"])
        in_w, in_b = g("attn.in_proj_weight"), g("attn.in_proj_bias")  # rows stacked [q; k; v]
        d = in_w.shape[1]
        return _block_params(
            in_w[:d], in_b[:d], in_w[d : 2 * d], in_b[d : 2 * d], in_w[2 * d :], in_b[2 * d :],
            g("attn.out_proj.weight"), g("attn.out_proj.bias"),
            g("ln_1.weight"), g("ln_1.bias"),
            g("ln_2.weight"), g("ln_2.bias"),
            g("mlp.c_fc.weight"), g("mlp.c_fc.bias"),
            g("mlp.c_proj.weight"), g("mlp.c_proj.bias"),
        )

    a = lambda key: np.asarray(sd[key])
    ln = lambda prefix: {"scale": a(f"{prefix}.weight"), "bias": a(f"{prefix}.bias")}
    visual = {
        "patch_embedding": _conv_to_patch_kernel(a("visual.conv1.weight")),
        "class_embedding": a("visual.class_embedding"),
        "positional_embedding": a("visual.positional_embedding"),
        "ln_pre": ln("visual.ln_pre"),
        "transformer": {f"block_{i}": block(f"visual.transformer.resblocks.{i}") for i in range(cfg.vision_layers)},
        "ln_post": ln("visual.ln_post"),
        "proj": a("visual.proj"),
    } if is_vit else _rn_visual_params(sd, cfg)
    params = {
        "visual": visual,
        "text": {
            "token_embedding": a("token_embedding.weight"),
            "positional_embedding": a("positional_embedding"),
            "transformer": {f"block_{i}": block(f"transformer.resblocks.{i}") for i in range(cfg.text_layers)},
            "ln_final": ln("ln_final"),
            "text_projection": a("text_projection"),
        },
        "logit_scale": a("logit_scale"),
    }
    return {"params": params}, cfg


# the config fields a checkpoint's shapes give; not the heads, whose width
# they cannot tell apart from their count, nor the GELU
SHAPE_FIELDS = ("embed_dim", "image_resolution", "vision_layers", "vision_width", "vision_patch_size",
                "context_length", "vocab_size", "text_width", "text_layers")


def with_entry_heads(shaped: ClipConfig, entry: ClipConfig) -> ClipConfig:
    """The config a checkpoint loads with: ``shaped`` (from its shapes,
    ``width // 64`` heads and QuickGELU) with the registry ``entry``'s
    ``vision_heads``, ``text_heads`` and ``quick_gelu`` when the shapes are
    the entry's, else ``shaped`` as it is (any checkpoint loads under any
    name)."""
    if any(getattr(shaped, f) != getattr(entry, f) for f in SHAPE_FIELDS):
        return shaped
    return dataclasses.replace(shaped, vision_heads=entry.vision_heads, text_heads=entry.text_heads,
                               quick_gelu=entry.quick_gelu)


def detect_and_convert(sd: Mapping[str, np.ndarray]):
    if any(k.startswith("vision_model.") for k in sd):
        return from_hf_state_dict(sd)
    if any(k.startswith("visual.") for k in sd):
        return from_openai_state_dict(sd)
    raise ValueError("Unrecognized CLIP state-dict format")
