"""OpenAI CLIP: a ViT with a class token and a causal text transformer
pooled at the first EOT, over CLIP's BPE (the registry's
``huggingface_clip``, ``chexzero``, ``mimic_clip_from_scratch_*`` and
``cc3m_clip_from_scratch``).

- Program: ``lemon_tpu_torch.models.clip.ClipModel`` in the cell's
  precision, in a ``ClipEncoder`` with the program's own CLIP BPE, as
  ``models/registry.create_encoder`` builds it.
- Reference: :mod:`portbench.reference.clip` (the towers),
  :mod:`portbench.reference.preprocess` (PIL's bicubic resize, the centre
  crop, CLIP's mean and std) and :mod:`portbench.reference.tokenizer` (the
  BPE).
- Weights: projections ``N(0, 1/fan_in)``, biases ``N(0, 0.02^2)``,
  LayerNorm gains ``1 + N(0, 0.05^2)`` and offsets ``N(0, 0.02^2)``, the
  class and vision position embeddings ``N(0, 1/width)``, the token
  embedding ``N(0, 0.02^2)``, the text positions ``N(0, 0.01^2)``, the
  temperature ``log(1 / 0.07)``.
- FLOPs: :func:`portbench.roofline.image_flops` and
  :func:`~portbench.roofline.text_flops`; a text counts its positions up to
  and with its EOT.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence

import numpy as np
import torch

from portbench.reference.clip import encode_image, encode_text, param_shapes  # noqa: F401 (the module's surface)
from portbench.reference.preprocess import preprocess as _preprocess
from portbench.reference.tokenizer import Tokenizer
from portbench.roofline import image_flops, text_flops  # noqa: F401 (the module's surface)

KEYS = ("embed_dim", "image_resolution", "vision_layers", "vision_width", "vision_patch_size", "vision_heads",
        "context_length", "vocab_size", "text_width", "text_heads", "text_layers", "quick_gelu", "attention_impl")


def encoder(cfg: dict, precision, W, device: torch.device, batch_size: int, fingerprint: str):
    from lemon_tpu_torch.models.clip import ClipConfig, ClipModel
    from lemon_tpu_torch.models.encoder import ClipEncoder

    with torch.device(device):
        model = ClipModel(ClipConfig(**{k: cfg[k] for k in KEYS}), precision)
    model.load_state_dict(W)
    return ClipEncoder(model, device, batch_size=batch_size, weights_fingerprint=fingerprint)


def scale(name: str, shape, cfg: dict):
    if name == "logit_scale":
        return 0.0, math.log(1 / 0.07)
    if name.endswith(("ln_1.weight", "ln_2.weight", "ln_pre.weight", "ln_post.weight", "ln_final.weight")):
        return 0.05, 1.0
    if name.endswith(".bias"):
        return 0.02, 0.0
    if name in ("visual.class_embedding", "visual.positional_embedding"):
        return cfg["vision_width"] ** -0.5, 0.0
    if name == "text.token_embedding.weight":
        return 0.02, 0.0
    if name == "text.positional_embedding":
        return 0.01, 0.0
    if name in ("visual.proj", "text.text_projection"):  # (in, out)
        return shape[0] ** -0.5, 0.0
    return shape[1] ** -0.5, 0.0  # (out, in) projections


def preprocess(images_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    return _preprocess(images_u8, cfg["image_resolution"])


@functools.lru_cache(maxsize=None)
def _tokenizer() -> Tokenizer:
    return Tokenizer()


def tokenize(texts: Sequence[str], cfg: dict) -> np.ndarray:
    return _tokenizer()(texts, cfg["context_length"])


def embed_dim(cfg: dict) -> int:
    return cfg["embed_dim"]


def text_lengths(texts: Sequence[str], cfg: dict) -> List[int]:
    tok, ctx = _tokenizer(), cfg["context_length"]
    return [min(len(tok.encode(t)) + 2, ctx) for t in texts]
