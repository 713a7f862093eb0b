"""CLIP vision and text towers in PyTorch (port of lemon_tpu/models/clip.py).

The fp32 path of the JAX ``ClipModel``, module for module:

- ``LayerNorm``: fp32 statistics, eps 1e-5 (:166);
- QuickGELU, ``x * sigmoid(1.702 x)`` (:193);
- fused-QKV attention (:457-534): under ``attention_impl="plain"`` a matmul
  + softmax with an additive -1e9 causal mask for text, under ``"flash"``
  kernel K3 (:func:`lemon_tpu_torch.ops.attention.flash_attention`), which
  builds the causal mask itself. ``"plain"`` and ``"flash"`` are the
  counterparts of the JAX ``attention_impl`` values ``'xla'`` and
  ``'pallas'`` (:58);
- the ViT patch embedding as a reshape + matmul, not a conv (:670-682);
- text pooling at the first EOT token, ``argmax`` of the ids (:790).

Inputs keep the JAX layout: pixels are NHWC. Left out, because they are
TPU layout workarounds or later precision modes and are all off on the fp32
path (lemon_tpu/core/precision.py:35-44): attention packing (the port never
packs, so the flash route has nothing to turn off), the pooled last block,
the folded LayerNorm, ``QuantDense`` and the ResNet tower.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lemon_tpu_torch.ops.attention import flash_attention

ATTENTION_IMPLS = ("plain", "flash")


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    vision_heads: Optional[int] = None  # default: width // 64
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    # "plain" | "flash": the counterparts of the JAX package's "xla" |
    # "pallas". "flash" runs both towers' attention through kernel K3.
    attention_impl: str = "plain"

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {self.attention_impl!r}")

    @property
    def v_heads(self) -> int:
        return self.vision_heads or self.vision_width // 64

    @property
    def grid(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @staticmethod
    def vit_b32() -> "ClipConfig":
        """openai/clip-vit-base-patch32 (run_lemon.py:113)."""
        return ClipConfig()

    @staticmethod
    def vit_b16(embed_dim: int = 512, context_length: int = 77) -> "ClipConfig":
        """ViT-B/16 of the from-scratch MIMIC/CC3M models
        (chexzero_clip.py:458-470: embed 768, context 256)."""
        return ClipConfig(embed_dim=embed_dim, vision_patch_size=16, context_length=context_length)

    @staticmethod
    def from_scratch_mimic() -> "ClipConfig":
        return ClipConfig.vit_b16(embed_dim=768, context_length=256)

    @staticmethod
    def tiny(vocab_size: int = 49408) -> "ClipConfig":
        """Small config for tests: full code path, toy sizes."""
        return ClipConfig(
            embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=16, context_length=16, vocab_size=vocab_size,
            text_width=64, text_heads=2, text_layers=2,
        )


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _layer_norm(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=1e-5)


_MASK = -1e9  # additive mask value of the JAX towers (finite: no inf - inf)


class Attention(nn.Module):
    """Multi-head self-attention with a fused QKV projection; ``causal``
    lets token i see tokens j <= i. The plain route adds a -1e9 mask, the
    flash route (K3) masks itself (lemon_tpu/models/clip.py:511-514)."""

    def __init__(self, width: int, heads: int, impl: str = "plain", causal: bool = False):
        super().__init__()
        self.heads = heads
        self.impl = impl
        self.causal = causal
        self.qkv = nn.Linear(width, 3 * width)
        self.out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.heads
        # (B, L, H, hd) views of the fused projection, the JAX layout
        q, k, v = (t.reshape(b, l, self.heads, hd) for t in self.qkv(x).split(d, dim=-1))
        if self.impl == "flash":
            return self.out(flash_attention(q, k, v, causal=self.causal).reshape(b, l, d))
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        logits = (q * hd ** -0.5) @ k.transpose(-1, -2)
        if self.causal:
            logits = logits + torch.full((l, l), _MASK, dtype=x.dtype, device=x.device).triu(1)
        out = torch.softmax(logits, dim=-1) @ v
        return self.out(out.transpose(1, 2).reshape(b, l, d))


class TransformerBlock(nn.Module):
    """Pre-LN residual block (chexzero_clip.py:190-200)."""

    def __init__(self, width: int, heads: int, impl: str = "plain", causal: bool = False):
        super().__init__()
        self.ln_1 = _layer_norm(width)
        self.attn = Attention(width, heads, impl, causal)
        self.ln_2 = _layer_norm(width)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


class VisionTower(nn.Module):
    """ViT with class token, learned positions and a final projection
    (chexzero_clip.py:226-260)."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.cfg = cfg
        p, w, g = cfg.vision_patch_size, cfg.vision_width, cfg.grid
        self.patch_embed = nn.Linear(p * p * 3, w, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(g * g + 1, w))
        self.ln_pre = _layer_norm(w)
        self.blocks = nn.ModuleList(
            TransformerBlock(w, cfg.v_heads, cfg.attention_impl) for _ in range(cfg.vision_layers)
        )
        self.ln_post = _layer_norm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """``pixels``: (B, H, W, 3) NHWC, already normalised."""
        b = pixels.shape[0]
        p, g, w = self.cfg.vision_patch_size, self.cfg.grid, self.cfg.vision_width
        # patch elements in (ph, pw, channel) order, as the JAX tower unfolds them
        x = pixels.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
        x = self.patch_embed(x)
        x = torch.cat([self.class_embedding.expand(b, 1, w), x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        for block in self.blocks:
            x = block(x)
        return self.ln_post(x[:, 0, :]) @ self.proj


class TextTower(nn.Module):
    """Causal text transformer with first-EOT pooling (chexzero_clip.py:355-376)."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        w = cfg.text_width
        self.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, w))
        self.blocks = nn.ModuleList(
            TransformerBlock(w, cfg.text_heads, cfg.attention_impl, causal=True) for _ in range(cfg.text_layers)
        )
        self.ln_final = _layer_norm(w)
        self.text_projection = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, l = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[:l]
        for block in self.blocks:
            x = block(x)
        x = self.ln_final(x)
        # ids peak at the EOT token; argmax returns its first occurrence
        eot = tokens.argmax(dim=-1)
        return x[torch.arange(b, device=x.device), eot] @ self.text_projection


class ClipModel(nn.Module):
    """Two-tower CLIP with a learned temperature (chexzero_clip.py:263-392)."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTower(cfg)
        self.text = TextTower(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual(pixels)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` for a torch (out, in) weight: a normal
    truncated at two standard deviations, rescaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def init_weights(model: ClipModel, seed: int = 0) -> ClipModel:
    """Random initialisation with the JAX towers' distributions
    (lemon_tpu/models/clip.py initialisers). The numbers differ from
    ``jax.random``'s; tests that need identical weights load a JAX tree
    through :func:`lemon_tpu_torch.models.convert.from_flax_params`."""
    g = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, g)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    v, t = model.visual, model.text
    for param, std in (
        (v.class_embedding, v.cfg.vision_width ** -0.5),
        (v.positional_embedding, v.cfg.vision_width ** -0.5),
        (v.proj, v.cfg.vision_width ** -0.5),
        (t.token_embedding.weight, 0.02),
        (t.positional_embedding, 0.01),
        (t.text_projection, model.cfg.text_width ** -0.5),
    ):
        param.normal_(0.0, std, generator=g)
    model.logit_scale.fill_(math.log(1 / 0.07))
    return model
