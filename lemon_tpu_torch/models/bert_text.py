"""BERT text tower of the BiomedCLIP family (port of lemon_tpu/models/bert_text.py).

open_clip's BiomedCLIP-PubMedBERT_256-vit_base_patch16_224 pairs a timm
ViT-B/16 with a PubMedBERT encoder behind open_clip's HFTextEncoder: BERT-base
post-LN (embeddings: word + position + token type, LayerNorm; each layer
self-attention -> add & LN -> GELU FFN -> add & LN), CLS pooling and an MLP
projection to the shared space. Padded keys get a ``-inf`` bias (:103);
LayerNorm eps is 1e-12, GELU exact. :func:`bert_params_from_hf` maps a
HuggingFace ``BertModel`` state dict (bare or prefixed, as in open_clip's
``text.transformer.*``) to the JAX package's parameter tree.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lemon_tpu_torch.models.clip import FpLayerNorm

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
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q, self.k, self.v = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.ln_attn = FpLayerNorm(d, eps=BERT_EPS)
        self.ffn_in = nn.Linear(d, cfg.intermediate_size)
        self.ffn_out = nn.Linear(cfg.intermediate_size, d)
        self.ln_ffn = FpLayerNorm(d, eps=BERT_EPS)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.heads
        q, k, v = (p(x).reshape(b, l, self.heads, hd).transpose(1, 2) for p in (self.q, self.k, self.v))
        logits = (q * hd ** -0.5) @ k.transpose(-1, -2) + bias
        att = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, l, d)
        x = self.ln_attn(x + self.attn_out(att))
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
