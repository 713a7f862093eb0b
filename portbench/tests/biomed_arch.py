"""A second architecture that a test supplies alone: the port's BiomedCLIP
(a timm-style ViT and a BERT text tower pooled at CLS, in fp32 whatever the
mode) at ``BiomedClipConfig.tiny()``'s widths, with the registry's stand-in
tokens (CLIP BPE ids clipped to the BERT vocabulary).

Its reference is the program's own fp32 forward, and its FLOP count a
rough one: it proves the harness's plumbing, not the model.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from lemon_tpu_torch.models.bert_text import BertTextConfig
from lemon_tpu_torch.models.biomed import BiomedClipConfig, BiomedClipModel
from lemon_tpu_torch.models.clip import ClipConfig
from lemon_tpu_torch.models.encoder import ClipEncoder
from lemon_tpu_torch.models.tokenizer import tokenize_batch
from portbench.reference.preprocess import preprocess as _preprocess

KEYS = ("embed_dim", "image_resolution", "vision_layers", "vision_width", "vision_patch_size", "context_length",
        "vocab_size", "text_width", "text_heads", "text_layers", "text_intermediate_size", "text_positions")

# BiomedClipConfig.tiny() in the keys above
TINY = {"embed_dim": 16, "image_resolution": 32, "vision_layers": 2, "vision_width": 64, "vision_patch_size": 16,
        "context_length": 16, "vocab_size": 200, "text_width": 32, "text_heads": 2, "text_layers": 2,
        "text_intermediate_size": 64, "text_positions": 32}


def model_config(cfg: dict) -> BiomedClipConfig:
    vision = ClipConfig(embed_dim=cfg["embed_dim"], image_resolution=cfg["image_resolution"],
                        vision_layers=cfg["vision_layers"], vision_width=cfg["vision_width"],
                        vision_patch_size=cfg["vision_patch_size"], quick_gelu=False, vision_patch_bias=True,
                        vision_ln_pre=False)
    text = BertTextConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["text_width"], num_layers=cfg["text_layers"],
                          num_heads=cfg["text_heads"], intermediate_size=cfg["text_intermediate_size"],
                          max_position_embeddings=cfg["text_positions"], context_length=cfg["context_length"],
                          embed_dim=cfg["embed_dim"])
    return BiomedClipConfig(vision=vision, text=text)


def _model(cfg: dict, W=None) -> BiomedClipModel:
    model = BiomedClipModel(model_config(cfg))
    if W is not None:
        model.load_state_dict({k: v.float() for k, v in W.items()})
    return model


def encoder(cfg: dict, precision, W, device: torch.device, batch_size: int, fingerprint: str) -> ClipEncoder:
    return ClipEncoder(_model(cfg, W), device, batch_size=batch_size, weights_fingerprint=fingerprint,
                       tokenize_fn=lambda texts: tokenize(texts, cfg))


def param_shapes(cfg: dict):
    with torch.device("meta"):
        return [(k, tuple(v.shape)) for k, v in _model(cfg).state_dict().items()]


def scale(name: str, shape, cfg: dict):
    if name == "logit_scale":
        return 0.0, math.log(1 / 0.07)
    if len(shape) == 1:  # LayerNorm gains about 1; biases and the class token about 0
        return 0.02, 1.0 if name.endswith(".weight") else 0.0
    if "embedding" in name:
        return 0.02, 0.0
    return min(shape) ** -0.5, 0.0


def preprocess(images_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    return _preprocess(images_u8, cfg["image_resolution"])


def tokenize(texts: Sequence[str], cfg: dict) -> np.ndarray:
    return (np.asarray(tokenize_batch(list(texts), cfg["context_length"])) % cfg["vocab_size"]).astype(np.int32)


@torch.no_grad()
def encode_image(W, cfg: dict, pixels: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    out = _model(cfg, W).to(pixels.device).encode_image(pixels.float())
    return out / out.norm(dim=-1, keepdim=True)


@torch.no_grad()
def encode_text(W, cfg: dict, tokens: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    out = _model(cfg, W).to(tokens.device).encode_text(tokens)
    return out / out.norm(dim=-1, keepdim=True)


def embed_dim(cfg: dict) -> int:
    return cfg["embed_dim"]


def image_flops(cfg: dict) -> float:
    n = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1
    return 24.0 * n * cfg["vision_width"] ** 2 * cfg["vision_layers"]


def text_flops(cfg: dict, length: int) -> float:
    w = cfg["text_width"]
    return 2.0 * length * (4 * w * w + 2 * w * cfg["text_intermediate_size"]) * cfg["text_layers"]


def text_lengths(texts: Sequence[str], cfg: dict) -> List[int]:
    return [cfg["context_length"]] * len(texts)
