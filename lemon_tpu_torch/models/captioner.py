"""Image captioning: a CLIP vision prefix and a causal text decoder (port of
lemon_tpu/models/captioner.py; reference downstream_captioning.py).

GIT-style: the vision tower's token states (:class:`VisionTower` with
``tokens_only``) are projected into the decoder width and prepended as a
prefix; the decoder runs over [image tokens, BOS, caption] under the
prefix-LM mask (the prefix bidirectional, the text causal and seeing the
whole prefix, :155-164) with a text-position-only LM head. Also here:

- :class:`LoraLinear`: a linear layer plus ``(x A) B * alpha / r`` with B
  zero-initialised (``LoraDense``); its factors are the parameters named
  ``lora_a``/``lora_b``, which :func:`lora_trainable_mask` finds;
- ``per_sample_loss``: the shifted LM loss with padding masked (:178-188);
- ``generate``: fixed-length greedy or temperature decoding that recomputes
  the whole sequence each step as the JAX scan does (:190-221); temperature
  draws come from an explicit ``torch.Generator``;
- :func:`init_captioner`, which dispatches on the config type (:224-243),
  and the two masks as predicates on parameter names (:246-280).

Module names follow the JAX tree (``block_{i}`` -> ``blocks.{i}``), so
:func:`lemon_tpu_torch.models.convert.captioner_from_flax` maps one onto the
other. Attention is plain fp32 matmul and softmax, as the JAX einsums: no
kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lemon_tpu_torch.core.device import resolve_device
from lemon_tpu_torch.models.clip import (ClipConfig, FpLayerNorm, VisionTower, attend, init_layers_, init_vit_,
                                         quick_gelu)


class LoraLinear(nn.Linear):
    """``nn.Linear`` with an optional low-rank adapter: ``y = x W^T + b +
    (x A) B * (alpha / rank)``. ``lora_a`` is (in, rank), ``lora_b`` (rank,
    out), as the JAX factors are laid out; ``rank=0`` is a plain linear."""

    def __init__(self, in_features: int, out_features: int, rank: int = 0, alpha: float = 16.0):
        super().__init__(in_features, out_features)
        self.rank = rank
        self.scale = alpha / rank if rank else 0.0
        if rank:
            self.lora_a = nn.Parameter(torch.zeros(in_features, rank))
            self.lora_b = nn.Parameter(torch.zeros(rank, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight, self.bias)
        if self.rank:
            y = y + (x @ self.lora_a) @ self.lora_b * self.scale
        return y


@dataclasses.dataclass(frozen=True)
class CaptionerConfig:
    vision: ClipConfig = dataclasses.field(default_factory=ClipConfig.tiny)
    decoder_width: int = 64
    decoder_layers: int = 2
    decoder_heads: int = 2
    max_text_len: int = 32
    vocab_size: int = 49408
    lora_rank: int = 0  # on the decoder's attention projections
    # the CLIP-BPE captioners pad with 0; OPT-based BLIP-2 pads with 1, BOS/EOS 2
    pad_token_id: int = 0
    bos_token_id: int = 0
    eos_token_id: int = 0

    @property
    def n_image_tokens(self) -> int:
        return self.vision.grid ** 2 + 1

    @staticmethod
    def tiny() -> "CaptionerConfig":
        return CaptionerConfig(vocab_size=512)

    @staticmethod
    def base() -> "CaptionerConfig":
        """ViT-B/32 and a 6-layer, 512-wide decoder at context 40."""
        return CaptionerConfig(vision=ClipConfig.vit_b32(), decoder_width=512, decoder_layers=6, decoder_heads=8,
                               max_text_len=40)


class DecoderBlock(nn.Module):
    """Pre-LN decoder block with a fused QKV projection (LoRA on it) and
    QuickGELU."""

    def __init__(self, width: int, heads: int, lora_rank: int = 0):
        super().__init__()
        self.heads = heads
        self.ln_1 = FpLayerNorm(width)
        self.qkv = LoraLinear(width, 3 * width, lora_rank)
        self.out = nn.Linear(width, width)
        self.ln_2 = FpLayerNorm(width)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(self.ln_1(x)).chunk(3, dim=-1)
        x = x + self.out(attend(q, k, v, self.heads, mask))
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


def prefix_lm_mask(n_img: int, l_txt: int, device) -> torch.Tensor:
    """(1, 1, T, T) additive mask: every position sees the image prefix; a
    text position also sees the text at or before it."""
    pos = torch.arange(n_img + l_txt, device=device)
    is_txt = pos >= n_img
    allowed = (~is_txt)[None, :] | (is_txt[:, None] & is_txt[None, :] & (pos[None, :] <= pos[:, None]))
    return torch.where(allowed, 0.0, -math.inf)[None, None]


class CaptioningModel(nn.Module):
    """The GIT-style captioner; the Q-Former and BLIP-2 captioners subclass
    it, changing ``_build``, the prefix encoder and (BLIP-2) the decoder."""

    def __init__(self, cfg: CaptionerConfig):
        super().__init__()
        self.cfg = cfg
        self._build(cfg)

    def _build(self, c: CaptionerConfig) -> None:
        self.visual = VisionTower(c.vision, tokens_only=True)
        self.vision_proj = nn.Linear(c.vision.vision_width, c.decoder_width)
        self.token_embedding = nn.Parameter(torch.empty(c.vocab_size, c.decoder_width))
        self.positional_embedding = nn.Parameter(torch.empty(c.n_image_tokens + c.max_text_len, c.decoder_width))
        self.blocks = nn.ModuleList(DecoderBlock(c.decoder_width, c.decoder_heads, c.lora_rank)
                                    for _ in range(c.decoder_layers))
        self.ln_final = FpLayerNorm(c.decoder_width)
        self.lm_head = nn.Linear(c.decoder_width, c.vocab_size, bias=False)

    def init_embeddings_(self, g: torch.Generator) -> None:
        """The ViT's embeddings, tokens N(0, 0.02), text positions N(0, 0.01)."""
        init_vit_(self.visual, g)
        self.token_embedding.normal_(0.0, 0.02, generator=g)
        self.positional_embedding.normal_(0.0, 0.01, generator=g)

    def encode_image_prefix(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.vision_proj(self.visual(pixels))

    def _decode(self, image_tokens: torch.Tensor, text_tokens: torch.Tensor) -> torch.Tensor:
        """Logits over the text positions (B, L_txt, V)."""
        n_img, l_txt = image_tokens.shape[1], text_tokens.shape[1]
        x = torch.cat([image_tokens, self.token_embedding[text_tokens]], dim=1)
        x = x + self.positional_embedding[: n_img + l_txt]
        mask = prefix_lm_mask(n_img, l_txt, x.device)
        for block in self.blocks:
            x = block(x, mask)
        return self.lm_head(self.ln_final(x)[:, n_img:])

    def forward(self, pixels: torch.Tensor, text_tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forcing logits (B, L_txt, V)."""
        return self._decode(self.encode_image_prefix(pixels), text_tokens)

    def per_sample_loss(self, pixels: torch.Tensor, text_tokens: torch.Tensor,
                        pad_id: Optional[int] = None) -> torch.Tensor:
        """Shifted LM loss per example (downstream_captioning.py:51-79): token
        t+1 from tokens <= t, padding targets masked out."""
        pad_id = self.cfg.pad_token_id if pad_id is None else pad_id
        logits = self(pixels, text_tokens)
        targets = text_tokens[:, 1:]
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tok_lp = logp.gather(2, targets[:, :, None])[:, :, 0]
        mask = (targets != pad_id).float()
        return -(tok_lp * mask).sum(1) / mask.sum(1).clamp_min(1.0)

    @torch.no_grad()
    def generate(self, pixels: torch.Tensor, bos_id: int, eot_id: int, max_len: Optional[int] = None,
                 temperature: float = 0.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, max_len) tokens: BOS, then one token a step, each step
        decoding the whole sequence; 0 after a row's EOT. ``temperature`` 0
        is greedy (the first maximum on a tie, as ``jnp.argmax``)."""
        max_len = max_len or self.cfg.max_text_len
        if max_len > self.cfg.max_text_len:
            raise ValueError(f"max_len {max_len} exceeds the decoder's max_text_len {self.cfg.max_text_len}")
        prefix = self.encode_image_prefix(pixels)
        b = prefix.shape[0]
        tokens = torch.zeros(b, max_len, dtype=torch.long, device=prefix.device)
        tokens[:, 0] = bos_id
        done = torch.zeros(b, dtype=torch.bool, device=prefix.device)
        for t in range(max_len - 1):
            step_logits = self._decode(prefix, tokens)[:, t]
            if temperature > 0:
                probs = torch.softmax(step_logits.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = step_logits.argmax(dim=-1)
            nxt = torch.where(done, 0, nxt)
            done = done | (nxt == eot_id)
            tokens[:, t + 1] = nxt
        return tokens


@torch.no_grad()
def init_weights_(model: CaptioningModel, seed: int = 0) -> CaptioningModel:
    """The JAX initialisers' distributions, from ``seed``: flax's defaults
    for every linear, conv and LayerNorm (:func:`init_layers_`), then each
    model's embeddings (``init_embeddings_``), LoRA A N(0, 0.02) and B zero.
    The numbers differ from ``jax.random``'s; a test that needs the JAX
    weights converts them (:func:`convert.captioner_from_flax`)."""
    g = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    init_layers_(model, g)
    model.init_embeddings_(g)
    for name, p in model.named_parameters():
        if name.endswith("lora_a"):
            p.normal_(0.0, 0.02, generator=g)
        elif name.endswith("lora_b"):
            p.zero_()
    return model


def init_captioner(cfg: CaptionerConfig, seed: int = 0, device: Optional[torch.device] = None) -> CaptioningModel:
    """The captioner of the config's type, randomly initialised on
    ``device`` (default: the CUDA card, raising without one; pass
    ``torch.device("cpu")`` to build on the CPU): a ``Blip2Config`` the
    HF-exact BLIP-2 (:mod:`blip2`), a ``QFormerConfig`` the Q-Former
    captioner (:mod:`qformer`), a plain ``CaptionerConfig`` the GIT-style
    model."""
    from lemon_tpu_torch.models.blip2 import Blip2Captioner, Blip2Config
    from lemon_tpu_torch.models.qformer import QFormerCaptioner, QFormerConfig

    if isinstance(cfg, Blip2Config):
        cls = Blip2Captioner
    elif isinstance(cfg, QFormerConfig):
        cls = QFormerCaptioner
    else:
        cls = CaptioningModel
    with torch.device(resolve_device("cuda") if device is None else device):
        model = cls(cfg)
    return init_weights_(model, seed)


def lora_trainable_mask(name: str) -> bool:
    """Whether a parameter trains under LoRA fine-tuning: the LoRA factors
    and the LM head (the JAX mask's rule, :246-259; BLIP-2 ties its head to
    ``embed_tokens`` and has no ``lm_head``, so only its factors train)."""
    return "lora_a" in name or "lora_b" in name or "lm_head" in name


def frozen_vision_mask(name: str) -> bool:
    """Whether a parameter lies outside the vision tower (:262-280): under
    ``freeze_vision`` only these are updated, so AdamW's decay cannot shrink
    the frozen tower."""
    return "visual" not in name.split(".")
