"""BiomedCLIP: a timm-style ViT-B/16 trunk and a PubMedBERT text tower (port
of lemon_tpu/models/biomed.py).

The reference's ``biomed_clip`` (lib/models/utils.py:72-79, open_clip's
BiomedCLIP-PubMedBERT_256-vit_base_patch16_224):

- vision: ViT-B/16 at 224 px with timm's conventions (patch-embedding bias,
  no pre-LayerNorm, GELU: the tanh approximation, as the JAX tower computes
  it, where timm's is exact) and a linear head to the 512-d space, the
  port's :class:`~lemon_tpu_torch.models.clip.VisionTower`;
- text: :class:`~lemon_tpu_torch.models.bert_text.BertTextTower`, BERT-base,
  CLS pooling, MLP projection, context 256;
- tokens: WordPiece (:mod:`lemon_tpu_torch.models.wordpiece`) from a local
  PubMedBERT ``vocab.txt``.

The JAX registry builds it without a precision mode
(lemon_tpu/models/registry.py:127-169), so it runs in fp32 here as well.
:func:`from_open_clip_state_dict` converts an open_clip state dict
(``visual.trunk.*`` timm keys, ``visual.head.proj``, ``text.transformer.*``
HF-BERT keys, ``text.proj.*``) to the JAX package's tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from lemon_tpu_torch.core.precision import Precision
from lemon_tpu_torch.models.bert_text import BertTextConfig, BertTextTower, bert_params_from_hf
from lemon_tpu_torch.models.clip import ClipConfig, VisionTower, init_layers_, init_vit_
from lemon_tpu_torch.models.loader import _conv_to_patch_kernel


def biomed_vision_config() -> ClipConfig:
    return ClipConfig(embed_dim=512, vision_patch_size=16, vision_width=768, vision_layers=12,
                      quick_gelu=False, vision_patch_bias=True, vision_ln_pre=False)


@dataclasses.dataclass(frozen=True)
class BiomedClipConfig:
    vision: ClipConfig = dataclasses.field(default_factory=biomed_vision_config)
    text: BertTextConfig = dataclasses.field(default_factory=BertTextConfig.pubmedbert)

    @staticmethod
    def tiny() -> "BiomedClipConfig":
        return BiomedClipConfig(
            vision=dataclasses.replace(ClipConfig.tiny(), quick_gelu=False, vision_patch_bias=True,
                                       vision_ln_pre=False, embed_dim=16),
            text=BertTextConfig.tiny(),
        )

    @property
    def embed_dim(self) -> int:
        return self.text.embed_dim

    @property
    def image_resolution(self) -> int:
        return self.vision.image_resolution

    @property
    def context_length(self) -> int:
        return self.text.context_length


class BiomedClipModel(nn.Module):
    """The two towers and a learned temperature, in fp32."""

    def __init__(self, cfg: BiomedClipConfig):
        super().__init__()
        self.cfg = cfg
        self.precision = Precision.fp32()
        self.visual = VisionTower(cfg.vision, self.precision)
        self.text = BertTextTower(cfg.text)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual(pixels)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)


@torch.no_grad()
def init_biomed(model: BiomedClipModel, seed: int = 0) -> BiomedClipModel:
    """Random weights with the JAX towers' distributions (flax's defaults;
    BERT's embeddings normal(0.02)); the numbers differ from ``jax.random``'s."""
    g = torch.Generator().manual_seed(seed)
    init_layers_(model, g)
    init_vit_(model.visual, g)
    t = model.text
    for param in (t.word_embeddings, t.position_embeddings, t.token_type_embeddings):
        param.normal_(0.0, 0.02, generator=g)
    model.logit_scale.fill_(math.log(1 / 0.07))
    return model


def from_open_clip_state_dict(sd: Mapping[str, np.ndarray], cfg: Optional[BiomedClipConfig] = None):
    """An open_clip BiomedCLIP state dict -> (the JAX package's
    ``BiomedClipModel`` tree, config)."""
    cfg = cfg or BiomedClipConfig()
    g = lambda name: np.asarray(sd[name])  # noqa: E731
    dense = lambda name: {"kernel": g(name + ".weight").T, "bias": g(name + ".bias")}  # noqa: E731
    ln = lambda name: {"scale": g(name + ".weight"), "bias": g(name + ".bias")}  # noqa: E731
    blocks = {}
    for i in range(cfg.vision.vision_layers):
        bp = f"visual.trunk.blocks.{i}."
        blocks[f"block_{i}"] = {
            "ln_1": ln(bp + "norm1"),
            "ln_2": ln(bp + "norm2"),
            "attn": {"qkv": dense(bp + "attn.qkv"), "out": dense(bp + "attn.proj")},  # qkv rows [q; k; v]
            "mlp_fc": dense(bp + "mlp.fc1"),
            "mlp_proj": dense(bp + "mlp.fc2"),
        }
    visual = {
        "patch_embedding": _conv_to_patch_kernel(g("visual.trunk.patch_embed.proj.weight")),
        "patch_bias": g("visual.trunk.patch_embed.proj.bias"),
        "class_embedding": g("visual.trunk.cls_token").reshape(-1),
        "positional_embedding": g("visual.trunk.pos_embed").reshape(-1, cfg.vision.vision_width),
        "transformer": blocks,
        "ln_post": ln("visual.trunk.norm"),
        "proj": g("visual.head.proj.weight").T,
    }
    text = bert_params_from_hf(sd, cfg.text)["params"]
    return {"params": {"visual": visual, "text": text, "logit_scale": g("logit_scale")}}, cfg
