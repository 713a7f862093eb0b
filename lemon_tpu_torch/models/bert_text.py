"""BERT text tower of the BiomedCLIP family (port of lemon_tpu/models/bert_text.py).

open_clip's BiomedCLIP-PubMedBERT_256-vit_base_patch16_224 pairs a timm
ViT-B/16 with a PubMedBERT encoder behind open_clip's HFTextEncoder: BERT-base
post-LN (embeddings: word + position + token type, LayerNorm; each layer
self-attention -> add & LN -> GELU FFN -> add & LN), CLS pooling and an MLP
projection to the shared space. Padded keys get a ``-inf`` bias (:103);
LayerNorm eps is 1e-12, GELU exact. :func:`bert_params_from_hf` maps a
HuggingFace ``BertModel`` state dict (bare or prefixed, as in open_clip's
``text.transformer.*``) to the JAX package's parameter tree.

BLIP's text encoder (``transformers/models/blip/modeling_blip_text.py``,
re-stated here: the GPU machine has no ``transformers``) is the same post-LN
layer with a cross-attention sublayer after self-attention
(``BertTextConfig.cross_attention``): queries from the text, keys and
values of width ``encoder_hidden_size`` from the image tokens, then add &
LN. :class:`BlipTextEncoder` gives it BLIP's embeddings (word plus absolute
position, LayerNorm, no token types) and a key-padding mask on
self-attention, HF's additive ``(1 - mask) * finfo.min``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lemon_tpu_torch.models.clip import FpLayerNorm, attend

BERT_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class BertTextConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    context_length: int = 256
    embed_dim: int = 512  # the shared CLIP space
    pooling: str = "cls"  # 'cls' | 'mean'
    projection: str = "mlp"  # 'linear' | 'mlp' (open_clip's BiomedCLIP: mlp)
    layer_norm_eps: float = BERT_EPS
    # BLIP: a cross-attention sublayer into image tokens of this width
    cross_attention: bool = False
    encoder_hidden_size: int = 0

    @staticmethod
    def pubmedbert(embed_dim: int = 512) -> "BertTextConfig":
        return BertTextConfig(embed_dim=embed_dim)

    @staticmethod
    def tiny() -> "BertTextConfig":
        return BertTextConfig(
            vocab_size=200, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=32, context_length=16, embed_dim=16,
        )


class BertLayer(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.heads = cfg.num_heads
        self.q, self.k, self.v = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.ln_attn = FpLayerNorm(d, eps=eps)
        self.cross = cfg.cross_attention
        if self.cross:
            e = cfg.encoder_hidden_size or d
            self.cross_q, self.cross_k, self.cross_v = nn.Linear(d, d), nn.Linear(e, d), nn.Linear(e, d)
            self.cross_out = nn.Linear(d, d)
            self.ln_cross = FpLayerNorm(d, eps=eps)
        self.ffn_in = nn.Linear(d, cfg.intermediate_size)
        self.ffn_out = nn.Linear(cfg.intermediate_size, d)
        self.ln_ffn = FpLayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, img: torch.Tensor | None = None) -> torch.Tensor:
        """``img``: the (B, N, encoder_hidden_size) image tokens that a
        cross-attention layer needs, every one attended to."""
        att = attend(self.q(x), self.k(x), self.v(x), self.heads, bias)
        x = self.ln_attn(x + self.attn_out(att))
        if self.cross:
            att = attend(self.cross_q(x), self.cross_k(img), self.cross_v(img), self.heads)
            x = self.ln_cross(x + self.cross_out(att))
        return self.ln_ffn(x + self.ffn_out(F.gelu(self.ffn_in(x))))


class BertTextTower(nn.Module):
    """(B, L) token ids -> (B, embed_dim) fp32; id 0 is BERT's padding, and
    no query attends to a padded key."""

    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.empty(cfg.vocab_size, h))
        self.position_embeddings = nn.Parameter(torch.empty(cfg.max_position_embeddings, h))
        self.token_type_embeddings = nn.Parameter(torch.empty(cfg.type_vocab_size, h))
        self.ln_emb = FpLayerNorm(h, eps=BERT_EPS)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))
        if cfg.projection == "linear":
            self.proj = nn.Linear(h, cfg.embed_dim, bias=False)
        else:
            self.proj_fc = nn.Linear(h, (h + cfg.embed_dim) // 2)
            self.proj_out = nn.Linear((h + cfg.embed_dim) // 2, cfg.embed_dim, bias=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        l = tokens.shape[1]
        attention_mask = tokens != 0
        x = self.word_embeddings[tokens] + self.position_embeddings[None, :l] + self.token_type_embeddings[0]
        x = self.ln_emb(x)
        bias = torch.where(attention_mask[:, None, None, :], 0.0, -torch.inf).to(x.dtype)
        for layer in self.layers:
            x = layer(x, bias)
        if c.pooling == "cls":
            pooled = x[:, 0]
        else:
            mask = attention_mask[:, :, None].to(x.dtype)
            pooled = (x * mask).sum(1) / mask.sum(1).clamp_min(1.0)
        if c.projection == "linear":
            return self.proj(pooled)
        return self.proj_out(F.gelu(self.proj_fc(pooled)))


def padding_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """HF's additive mask of a (B, L) 0/1 key mask: ``(1 - mask) *
    finfo.min``, shaped (B, 1, 1, L)."""
    return ((1.0 - mask.to(dtype)) * torch.finfo(dtype).min)[:, None, None, :]


class BlipTextEncoder(nn.Module):
    """BLIP's text encoder (``BlipTextModel`` without its pooler): (B, L)
    ids, their 0/1 attention mask and (B, N, encoder_hidden_size) image
    tokens -> (B, L, hidden) states. Every image token is attended to
    (``modeling_blip.py``'s all-ones image mask)."""

    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        if not cfg.cross_attention:
            raise ValueError("BlipTextEncoder needs BertTextConfig(cross_attention=True)")
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.empty(cfg.vocab_size, h))
        self.position_embeddings = nn.Parameter(torch.empty(cfg.max_position_embeddings, h))
        self.ln_emb = FpLayerNorm(h, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor, image_states: torch.Tensor) -> torch.Tensor:
        x = self.ln_emb(self.word_embeddings[tokens] + self.position_embeddings[None, : tokens.shape[1]])
        bias = padding_bias(attention_mask, x.dtype)
        for layer in self.layers:
            x = layer(x, bias, image_states)
        return x


def bert_params_from_hf(sd: Mapping[str, np.ndarray], cfg: BertTextConfig) -> dict:
    """A HuggingFace ``BertModel`` state dict (bare, or prefixed ``bert.``,
    ``text.transformer.`` or ``transformer.``) -> the JAX package's
    ``BertTextTower`` tree; open_clip's projection head (``text.proj.*``) is
    mapped when present."""
    pfx = ""
    if not any(k.startswith("embeddings.") for k in sd):
        for cand in ("bert.", "text.transformer.", "transformer."):
            if any(k.startswith(cand + "embeddings.") for k in sd):
                pfx = cand
                break
    g = lambda name: np.asarray(sd[pfx + name])  # noqa: E731
    dense = lambda name: {"kernel": g(name + ".weight").T, "bias": g(name + ".bias")}  # noqa: E731
    ln = lambda name: {"scale": g(name + ".weight"), "bias": g(name + ".bias")}  # noqa: E731
    params = {
        "word_embeddings": g("embeddings.word_embeddings.weight"),
        "position_embeddings": g("embeddings.position_embeddings.weight"),
        "token_type_embeddings": g("embeddings.token_type_embeddings.weight"),
        "ln_emb": ln("embeddings.LayerNorm"),
    }
    for i in range(cfg.num_layers):
        lp = f"encoder.layer.{i}."
        params[f"layer_{i}"] = {
            "q": dense(lp + "attention.self.query"),
            "k": dense(lp + "attention.self.key"),
            "v": dense(lp + "attention.self.value"),
            "attn_out": dense(lp + "attention.output.dense"),
            "ln_attn": ln(lp + "attention.output.LayerNorm"),
            "ffn_in": dense(lp + "intermediate.dense"),
            "ffn_out": dense(lp + "output.dense"),
            "ln_ffn": ln(lp + "output.LayerNorm"),
        }
    if "text.proj.weight" in sd:
        params["proj"] = {"kernel": np.asarray(sd["text.proj.weight"]).T}
    elif "text.proj.0.weight" in sd:
        params["proj_fc"] = {"kernel": np.asarray(sd["text.proj.0.weight"]).T, "bias": np.asarray(sd["text.proj.0.bias"])}
        params["proj_out"] = {"kernel": np.asarray(sd["text.proj.2.weight"]).T}
    return {"params": params}
