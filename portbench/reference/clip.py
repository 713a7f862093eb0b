"""The plain CLIP forward that judges the program's embeddings.

OpenAI CLIP's two towers (ViT with class token, learned positions, pre-LN
blocks, a 4x MLP with QuickGELU, or the exact (erf) GELU where the
configuration's ``quick_gelu`` is false, fused q|k|v projection; a causal
text transformer pooled at the first EOT, the largest id), written in plain
PyTorch over a dict of weights named as the benchmark makes them
(:func:`param_shapes`). Every block runs on every token; softmax and
LayerNorm in fp32. ``mode`` sets the precision of the products' operands
(:mod:`portbench.reference.operands`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.operands import attention_operand, linear, round_tf32  # noqa: F401 (round_tf32: re-exported)


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight of the two towers, in the program's state-dict names."""
    w, p, g = cfg["vision_width"], cfg["vision_patch_size"], cfg["image_resolution"] // cfg["vision_patch_size"]
    t, e = cfg["text_width"], cfg["embed_dim"]

    def blocks(prefix: str, n: int, d: int):
        out = []
        for i in range(n):
            b = f"{prefix}.blocks.{i}."
            out += [(b + "ln_1.weight", (d,)), (b + "ln_1.bias", (d,)),
                    (b + "attn.qkv.weight", (3 * d, d)), (b + "attn.qkv.bias", (3 * d,)),
                    (b + "attn.out.weight", (d, d)), (b + "attn.out.bias", (d,)),
                    (b + "ln_2.weight", (d,)), (b + "ln_2.bias", (d,)),
                    (b + "mlp_fc.weight", (4 * d, d)), (b + "mlp_fc.bias", (4 * d,)),
                    (b + "mlp_proj.weight", (d, 4 * d)), (b + "mlp_proj.bias", (d,))]
        return out

    return ([("logit_scale", ()),
             ("visual.class_embedding", (w,)), ("visual.positional_embedding", (g * g + 1, w)),
             ("visual.proj", (w, e)), ("visual.patch_embed.weight", (w, p * p * 3)),
             ("visual.ln_pre.weight", (w,)), ("visual.ln_pre.bias", (w,))]
            + blocks("visual", cfg["vision_layers"], w)
            + [("visual.ln_post.weight", (w,)), ("visual.ln_post.bias", (w,)),
               ("text.positional_embedding", (cfg["context_length"], t)), ("text.text_projection", (t, e)),
               ("text.token_embedding.weight", (cfg["vocab_size"], t))]
            + blocks("text", cfg["text_layers"], t)
            + [("text.ln_final.weight", (t,)), ("text.ln_final.bias", (t,))])


def _layer_norm(x, W: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"].float(), W[name + ".bias"].float(), 1e-5)


def _block(x: torch.Tensor, W, prefix: str, heads: int, causal: bool, quick_gelu: bool, mode: str) -> torch.Tensor:
    b, n, d = x.shape
    hd = d // heads
    qkv = linear(_layer_norm(x, W, prefix + "ln_1"), W[prefix + "attn.qkv.weight"], W[prefix + "attn.qkv.bias"], mode)
    q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2) for t in qkv.split(d, dim=-1))
    logits = attention_operand(q * hd ** -0.5, mode) @ attention_operand(k, mode).transpose(-1, -2)
    if causal:
        logits = logits.masked_fill(torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
    attn = attention_operand(torch.softmax(logits, dim=-1), mode) @ attention_operand(v, mode)
    x = x + linear(attn.transpose(1, 2).reshape(b, n, d), W[prefix + "attn.out.weight"], W[prefix + "attn.out.bias"],
                   mode)
    h = linear(_layer_norm(x, W, prefix + "ln_2"), W[prefix + "mlp_fc.weight"], W[prefix + "mlp_fc.bias"], mode)
    h = h * torch.sigmoid(1.702 * h) if quick_gelu else F.gelu(h)
    return x + linear(h, W[prefix + "mlp_proj.weight"], W[prefix + "mlp_proj.bias"], mode)


def encode_image(W, cfg: dict, pixels: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """(B, H, W, 3) normalised pixels -> (B, embed_dim) L2-normalised."""
    b = pixels.shape[0]
    p, w = cfg["vision_patch_size"], cfg["vision_width"]
    g = cfg["image_resolution"] // p
    x = pixels.float().reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
    x = linear(x, W["visual.patch_embed.weight"], None, mode)
    x = torch.cat([W["visual.class_embedding"].float().expand(b, 1, w), x], dim=1)
    x = _layer_norm(x + W["visual.positional_embedding"].float(), W, "visual.ln_pre")
    heads = cfg["vision_heads"]
    for i in range(cfg["vision_layers"]):
        x = _block(x, W, f"visual.blocks.{i}.", heads, False, cfg["quick_gelu"], mode)
    out = linear(_layer_norm(x[:, 0], W, "visual.ln_post"), W["visual.proj"].t(), None, mode)
    return out / out.norm(dim=-1, keepdim=True)


def encode_text(W, cfg: dict, tokens: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
    """(B, context) token ids -> (B, embed_dim) L2-normalised."""
    n = tokens.shape[1]
    x = W["text.token_embedding.weight"].float()[tokens] + W["text.positional_embedding"].float()[:n]
    for i in range(cfg["text_layers"]):
        x = _block(x, W, f"text.blocks.{i}.", cfg["text_heads"], True, cfg["quick_gelu"], mode)
    pooled = _layer_norm(x, W, "text.ln_final")[torch.arange(len(tokens), device=x.device), tokens.argmax(dim=-1)]
    out = linear(pooled, W["text.text_projection"].t(), None, mode)
    return out / out.norm(dim=-1, keepdim=True)
