"""The precision of the reference's products, shared by every architecture.

``mode`` sets the precision of the products' operands: ``fp32`` is the
reference (TF32 off); the controls stand in for the program at the nearest
precision below the one a configuration states: ``tf32`` rounds every
operand to TF32's 10-bit mantissa (what TF32 tensor cores read), ``int8``
quantises the projections' activations per token and their weights per
output channel, symmetric, and rounds the attention's operands to bf16 (the
program's int8 path keeps attention in bf16). Products of rounded operands
are taken in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "int8")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to nearest even at TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float().bfloat16().float()


def int8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Symmetric int8 quantisation along ``dim``, returned dequantised."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def linear(x: torch.Tensor, weight: torch.Tensor, bias, mode: str) -> torch.Tensor:
    """``x @ weight^T + bias`` (``weight`` as (out, in))."""
    if mode == "tf32":
        x, weight = round_tf32(x), round_tf32(weight)
    elif mode == "int8":
        x, weight = int8(x.float(), -1), int8(weight.float(), 1)
    return F.linear(x.float(), weight.float(), None if bias is None else bias.float())


def attention_operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    """An operand of q.k or p.v: TF32 under ``tf32``, bf16 under ``int8``."""
    return round_tf32(x) if mode == "tf32" else round_bf16(x) if mode == "int8" else x
