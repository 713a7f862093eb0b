"""BLIP-2-style captioner: frozen vision tower -> Q-Former -> causal LM (port
of lemon_tpu/models/qformer.py).

- the vision tower's token states, detached under ``freeze_vision``
  (:180-181), as BLIP-2 freezes its image encoder;
- ``n_queries`` learned query tokens refined by post-LN BERT-style blocks
  (:class:`QFormerBlock`: self-attention, cross-attention into the image
  tokens every ``cross_attention_freq`` layers, a tanh-GELU MLP, eps 1e-5 as
  the JAX ``FpLayerNorm``), then ``language_projection`` into the LM width;
- a pre-LN causal LM (:class:`LMBlock`) with separate q/k/v projections
  and LoRA on ``q_proj`` and ``k_proj`` only (downstream_captioning.py:220),
  under the prefix-LM mask of :class:`CaptioningModel`, whose
  ``forward``/``per_sample_loss``/``generate`` it inherits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from lemon_tpu_torch.models.captioner import CaptionerConfig, CaptioningModel, LoraLinear
from lemon_tpu_torch.models.clip import ClipConfig, FpLayerNorm, VisionTower, attend, quick_gelu


@dataclasses.dataclass(frozen=True)
class QFormerConfig(CaptionerConfig):
    """``decoder_*`` fields configure the LM; ``qformer_*`` the Q-Former."""

    n_queries: int = 32
    qformer_width: int = 64
    qformer_layers: int = 2
    qformer_heads: int = 2
    cross_attention_freq: int = 2
    freeze_vision: bool = True

    @property
    def n_image_tokens(self) -> int:  # the LM prefix is the query set
        return self.n_queries

    @staticmethod
    def tiny() -> "QFormerConfig":
        return QFormerConfig(vocab_size=512, n_queries=8)

    @staticmethod
    def base() -> "QFormerConfig":
        """ViT-B/32, a 12-layer 768-wide Q-Former with 32 queries, a 6-layer
        512-wide LM at context 40, LoRA rank 16."""
        return QFormerConfig(vision=ClipConfig.vit_b32(), decoder_width=512, decoder_layers=6, decoder_heads=8,
                             max_text_len=40, n_queries=32, qformer_width=768, qformer_layers=12, qformer_heads=12,
                             lora_rank=16)


class QFormerBlock(nn.Module):
    """Post-LN block over the queries: self-attention, optional
    cross-attention into the image tokens, tanh-GELU MLP (flax's
    ``nn.gelu`` default)."""

    def __init__(self, width: int, heads: int, has_cross: bool, image_width: int):
        super().__init__()
        self.heads = heads
        self.has_cross = has_cross
        self.self_q, self.self_k, self.self_v = (nn.Linear(width, width) for _ in range(3))
        self.self_out = nn.Linear(width, width)
        self.ln_self = FpLayerNorm(width)
        if has_cross:
            self.cross_q = nn.Linear(width, width)
            self.cross_k, self.cross_v = nn.Linear(image_width, width), nn.Linear(image_width, width)
            self.cross_out = nn.Linear(width, width)
            self.ln_cross = FpLayerNorm(width)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)
        self.ln_mlp = FpLayerNorm(width)

    def forward(self, x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        att = self.self_out(attend(self.self_q(x), self.self_k(x), self.self_v(x), self.heads))
        x = self.ln_self(x + att)
        if self.has_cross:
            att = self.cross_out(attend(self.cross_q(x), self.cross_k(img), self.cross_v(img), self.heads))
            x = self.ln_cross(x + att)
        y = self.mlp_proj(F.gelu(self.mlp_fc(x), approximate="tanh"))
        return self.ln_mlp(x + y)


class LMBlock(nn.Module):
    """Pre-LN causal LM block, LoRA on ``q_proj`` and ``k_proj``, QuickGELU."""

    def __init__(self, width: int, heads: int, lora_rank: int = 0):
        super().__init__()
        self.heads = heads
        self.ln_1 = FpLayerNorm(width)
        self.q_proj = LoraLinear(width, width, lora_rank)
        self.k_proj = LoraLinear(width, width, lora_rank)
        self.v_proj = nn.Linear(width, width)
        self.out = nn.Linear(width, width)
        self.ln_2 = FpLayerNorm(width)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = self.ln_1(x)
        x = x + self.out(attend(self.q_proj(y), self.k_proj(y), self.v_proj(y), self.heads, mask))
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


class QFormerCaptioner(CaptioningModel):
    def _build(self, c: QFormerConfig) -> None:
        self.visual = VisionTower(c.vision, tokens_only=True)
        self.query_tokens = nn.Parameter(torch.empty(c.n_queries, c.qformer_width))
        self.qformer_blocks = nn.ModuleList(
            QFormerBlock(c.qformer_width, c.qformer_heads, i % c.cross_attention_freq == 0, c.vision.vision_width)
            for i in range(c.qformer_layers))
        self.language_projection = nn.Linear(c.qformer_width, c.decoder_width)
        self.token_embedding = nn.Parameter(torch.empty(c.vocab_size, c.decoder_width))
        self.positional_embedding = nn.Parameter(torch.empty(c.n_queries + c.max_text_len, c.decoder_width))
        self.blocks = nn.ModuleList(LMBlock(c.decoder_width, c.decoder_heads, c.lora_rank)
                                    for _ in range(c.decoder_layers))
        self.ln_final = FpLayerNorm(c.decoder_width)
        self.lm_head = nn.Linear(c.decoder_width, c.vocab_size, bias=False)

    def init_embeddings_(self, g: torch.Generator) -> None:
        super().init_embeddings_(g)
        self.query_tokens.normal_(0.0, 0.02, generator=g)

    def encode_image_prefix(self, pixels: torch.Tensor) -> torch.Tensor:
        img = self.visual(pixels)
        if self.cfg.freeze_vision:
            img = img.detach()
        x = self.query_tokens.expand(pixels.shape[0], -1, -1)
        for block in self.qformer_blocks:
            x = block(x, img)
        return self.language_projection(x)

