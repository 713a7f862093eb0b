"""CLIP vision and text towers in PyTorch (port of lemon_tpu/models/clip.py).

The JAX ``ClipModel`` module for module, in every mode of
:class:`lemon_tpu_torch.core.precision.Precision`:

- ``FpLayerNorm`` (:166-190): fp32 statistics on any input dtype, eps 1e-5,
  the normalise/affine tail in fp32 or, when ``ln_dtype`` is bf16, in bf16;
- QuickGELU, ``x * sigmoid(1.702 x)`` (:193);
- fused-QKV attention (:457-534): under ``attention_impl="plain"`` a matmul
  + softmax in ``softmax_dtype`` with an additive -1e9 causal mask for text,
  under ``"flash"`` kernel K3
  (:func:`lemon_tpu_torch.ops.attention.flash_attention`, fp32 or bf16),
  which builds the causal mask itself. ``"plain"`` and ``"flash"`` are the
  counterparts of the JAX ``attention_impl`` values ``'xla'`` and
  ``'pallas'`` (:58);
- the ViT patch embedding as a reshape + matmul, not a conv (:670-682);
- text pooling at the first EOT token, ``argmax`` of the ids (:790);
- the pooled last block (:503-510, :557-560, :706-717, :791): with
  ``Precision.pool_last_block`` and ``ClipConfig.pool_last_block`` the last
  vision block computes only the CLS row (the text tower's first-EOT row
  with ``pool_last_block_text``), never under ``"flash"``;
- ``ln_folded_dense`` under ``Precision.fold_ln`` (:222-246, :566-578);
- ``QuantLinear``, the W8A8 projections of the int8 modes (:249-334), with
  :func:`quantize_clip_params` and :func:`calibrate_act_scales`.

In the bf16 modes the residual stream and the projections are bf16: the
projections' weights are cast once, when the weights are loaded (JAX casts
the fp32 parameters at use; both round to nearest even). Where JAX asks for
an fp32 result of bf16 operands (the patch embedding and the two
projections), the operands are upcast and multiplied in fp32. LayerNorm
weights and the class, position and token embeddings stay fp32 and are cast
at use, as in JAX.

Inputs keep the JAX layout: pixels are NHWC. A tuple ``vision_layers``
selects the ModifiedResNet tower (:mod:`lemon_tpu_torch.models.resnet`,
:834-837), as in the JAX package; ``quick_gelu``, ``vision_patch_bias`` and
``vision_ln_pre`` carry the timm ViT of BiomedCLIP (the exact GELU, where
the JAX tower takes ``jax.nn.gelu``'s tanh approximation; a patch bias; no
pre-LayerNorm; :57, :75-76). Left out: attention packing, a TPU
layout workaround (the port never packs, so the pooled vision rows are
``[[0]]`` and the flash route has nothing to turn off).

Tensor parallelism (``ClipModel(..., mesh=...)`` with ``mesh.model > 1``,
the layout of lemon_tpu/train/contrastive.py:91-136): each block's ``qkv``
and ``mlp_fc`` are column-parallel, ``attn.out`` and ``mlp_proj``
row-parallel over the mesh's model group, Megatron's split. The fused
``qkv`` is split by heads: rank ``m`` holds heads ``[m H/M, (m+1) H/M)`` of
each of q, k and v (JAX's ``P(None, 'model')`` cuts the ``[q | k | v]``
columns into contiguous blocks and GSPMD reshards them). A sublayer whose
heads (attention) or hidden width (MLP) the model axis does not divide is
built whole, with no collective, as ``train_state_shardings`` replicates a
leaf it cannot split. Embeddings, LayerNorms, the final projections and
``logit_scale`` are replicated. The fp32 and bf16 training towers only.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from lemon_tpu_torch.core.mesh import Mesh
from lemon_tpu_torch.core.precision import Precision
from lemon_tpu_torch.ops.attention import flash_attention

ATTENTION_IMPLS = ("plain", "flash")


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    # an int selects the ViT tower, a 4-tuple of Bottleneck counts the
    # ModifiedResNet one (chexzero_clip.py:283-303)
    vision_layers: int | tuple = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    vision_heads: Optional[int] = None  # default: width // 64
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    # QuickGELU (x * sigmoid(1.702 x)), as OpenAI CLIP checkpoints use;
    # False: exact GELU (timm)
    quick_gelu: bool = True
    # "plain" | "flash": the counterparts of the JAX package's "xla" |
    # "pallas". "flash" runs both towers' attention through kernel K3.
    attention_impl: str = "plain"
    # The last block computes only the pooled row (exact per row: K and V
    # still come from every token). Active only with
    # Precision.pool_last_block, and never under "flash".
    pool_last_block: bool = True
    # The same for the text tower's first-EOT row; off as in JAX.
    pool_last_block_text: bool = False
    # timm-style ViT (BiomedCLIP's trunk): a patch-embedding bias, no ln_pre
    vision_patch_bias: bool = False
    vision_ln_pre: bool = True

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {self.attention_impl!r}")

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision_layers, (tuple, list))

    @property
    def v_heads(self) -> int:
        if self.vision_heads:
            return self.vision_heads
        # the ResNet attention pool's heads: width * 32 // 64 (chexzero_clip.py:300)
        return (self.vision_width * 32 if self.is_resnet else self.vision_width) // 64

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
    def vit_h14() -> "ClipConfig":
        """LAION's OpenCLIP ViT-H/14 (laion2b_s32b_b79k; open_clip's
        ``ViT-H-14.json``): vision 32 x 1280 in 16 heads of 80 (not
        ``width // 64``), patch 14 at 224 px; text 24 x 1024 in 16 heads;
        embed 1024; the exact GELU."""
        return ClipConfig(embed_dim=1024, vision_layers=32, vision_width=1280, vision_patch_size=14, vision_heads=16,
                          text_width=1024, text_heads=16, text_layers=24, quick_gelu=False)

    @staticmethod
    def rn50() -> "ClipConfig":
        """OpenAI CLIP RN50 (ModifiedResNet vision tower)."""
        return ClipConfig(embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64)

    @staticmethod
    def tiny_rn() -> "ClipConfig":
        """Test-scale ModifiedResNet config (full code path, toy sizes)."""
        return ClipConfig(
            embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=8,
            context_length=16, text_width=64, text_heads=2, text_layers=2,
        )

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


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, mask=None) -> torch.Tensor:
    """(B, Lq, D) queries over (B, Lk, D) keys and values: plain multi-head
    attention, ``heads`` heads, with an additive ``mask`` broadcast to
    (B, H, Lq, Lk). The captioners, BLIP's and BLIP-2's towers share it."""
    b, lq, d = q.shape
    hd = d // heads
    q, k, v = (t.reshape(b, t.shape[1], heads, hd).transpose(1, 2) for t in (q, k, v))
    logits = (q * hd ** -0.5) @ k.transpose(-1, -2)
    if mask is not None:
        logits = logits + mask
    return (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, lq, d)


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an fp32 result: JAX's ``preferred_element_type=float32``
    on operands of any dtype (bf16 products are exact in fp32)."""
    return x.float() @ w.float()


class FpLayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics on any input dtype, returned in the
    input's dtype; ``dtype`` is the normalise/affine tail's (fp32, or bf16
    on the fast path: the statistics stay fp32)."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32, eps: float = 1e-5):
        super().__init__(width, eps=eps)
        self.tail_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tail_dtype == torch.float32:
            return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        dt = self.tail_dtype
        inv = torch.rsqrt(var + self.eps).to(dt)
        y = (x.to(dt) - mean.to(dt)) * inv
        return (y * self.weight.to(dt) + self.bias.to(dt)).to(x.dtype)


def ln_folded_dense(x, weight, bias, g, beta, *, compute_dtype, eps: float = 1e-5) -> torch.Tensor:
    """``Linear(LN(x))`` without materialising ``LN(x)``
    (lemon_tpu/models/clip.py:222-246): ``LN(x) W^T = r (x (g W)^T) -
    (r mu) colsum(g W) + (W beta + b)`` with per-row fp32 statistics (mu, r);
    ``weight`` is (out, in) as ``nn.Linear`` holds it, every parameter fp32.
    The product takes ``compute_dtype`` operands and an fp32 result."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    w_scaled = weight * g[None, :]
    c1 = w_scaled.sum(1)
    c2 = weight @ beta + bias
    z = _f32_product(x.to(compute_dtype), w_scaled.to(compute_dtype).T)
    return (z * r - (r * mu) * c1 + c2).to(compute_dtype)


def _div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` rounded once, as the CPU and the JAX package divide. CUDA
    divides by a host scalar as a product with its rounded reciprocal, which
    is one bit off at times, so the divisor is a scalar on ``x``'s device."""
    return x / x.new_full((), 127.0)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w^T`` of int8 (M, K) and (N, K), exact in int32 (XLA's int8
    ``dot_general`` in the JAX package): ``torch._int_mm``. On the card it
    takes M > 16 and K, N multiples of 8, so fewer rows are zero-padded."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a, w.t())[:m]


class QuantLinear(nn.Module):
    """W8A8 ``nn.Linear`` of the int8 modes (``QuantDense``,
    lemon_tpu/models/clip.py:249-334): int8 ``weight_q`` (out, in) with
    per-output-channel ``weight_scale``, made once by
    :func:`quantize_clip_params`; ``bias`` fp32; the dequantisation in fp32;
    the result in ``dtype``. Activation scales are per token and computed on
    the fly, or one calibrated scalar ``act_scale`` (``static_act``, filled
    by :func:`calibrate_act_scales`). ``weight_only`` (the pooled last
    block, whose M is one row an image) dequantises the weight and runs an
    ordinary product of unquantised activations, with the same buffers.
    While ``act_amax`` is a tensor, the layer records its input's max-abs
    there (the JAX ``sow`` that calibration reads)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.bfloat16,
                 static_act: bool = False, weight_only: bool = False):
        super().__init__()
        self.dtype = dtype
        self.static_act = static_act
        self.weight_only = weight_only
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        if static_act:
            self.register_buffer("act_scale", torch.ones(()))
        self.act_amax: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, d = x.shape[:-1], x.shape[-1]
        x = x.reshape(-1, d)
        xf = x.float()
        if self.act_amax is not None:
            self.act_amax = torch.maximum(self.act_amax, xf.abs().amax())
        if self.weight_only:
            w = (self.weight_q.float() * self.weight_scale[:, None]).to(self.dtype)
            y = F.linear(x.to(self.dtype).float(), w.float(), self.bias)
        elif self.static_act:
            a_q = torch.clamp(torch.round(xf / self.act_scale), -127, 127).to(torch.int8)
            y = int8_matmul(a_q, self.weight_q).float() * (self.act_scale * self.weight_scale) + self.bias
        else:
            a_scale = _div127(xf.abs().amax(-1, keepdim=True).clamp_min(1e-12))
            a_q = torch.round(xf / a_scale).to(torch.int8)
            y = int8_matmul(a_q, self.weight_q).float() * a_scale * self.weight_scale + self.bias
        return y.reshape(*lead, -1).to(self.dtype)


# the vision tower's projections that the int8 modes quantise (LN, softmax,
# the attention core and the towers' heads stay float; the text tower is
# never quantised, as in JAX)
_QUANT_WEIGHT = re.compile(r"visual\.blocks\.\d+\.(?:attn\.qkv|attn\.out|mlp_fc|mlp_proj)\.weight")


def quantize_clip_params(state: dict, static_act: bool = False) -> dict:
    """A float :class:`ClipModel` state dict -> the one the int8 modes load:
    each vision projection's ``weight`` becomes per-output-channel symmetric
    ``weight_q`` (int8) and ``weight_scale``, plus an all-ones ``act_scale``
    placeholder under ``static_act`` (:func:`calibrate_act_scales` fills
    it). The port of both JAX variants (lemon_tpu/models/clip.py:342-403):
    it runs where the tensors lie, and from fp32 weights gives the JAX
    package's int8 weights and scales bit for bit. Everything else passes
    through."""
    out = {}
    for key, val in state.items():
        if not _QUANT_WEIGHT.fullmatch(key):
            out[key] = val
            continue
        prefix = key[: -len("weight")]
        w = val.float()
        scale = _div127(w.abs().amax(dim=1).clamp_min(1e-12))
        out[prefix + "weight_q"] = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
        out[prefix + "weight_scale"] = scale
        if static_act:
            out[prefix + "act_scale"] = torch.ones((), device=w.device)
    return out


@torch.no_grad()
def calibrate_act_scales(model: "ClipModel", pixels=None, tokens=None, margin: float = 1.0) -> "ClipModel":
    """Fill the static ``act_scale`` of every ``QuantLinear`` from the input
    max-abs it sees on one ``encode_image(pixels)`` and/or
    ``encode_text(tokens)``: ``act_scale = max(amax * margin, 1e-6) / 127``
    (lemon_tpu/models/clip.py:406-438). Layers the calls do not reach keep
    their scales, so calibrating one tower at a time composes."""
    layers = [m for m in model.modules() if isinstance(m, QuantLinear) and m.static_act]
    for m in layers:
        m.act_amax = torch.full((), -1.0, device=m.weight_q.device)  # below any max-abs: "not reached"
    try:
        if pixels is not None:
            model.encode_image(pixels)
        if tokens is not None:
            model.encode_text(tokens)
        amaxes = [float(m.act_amax) for m in layers]
    finally:
        for m in layers:
            m.act_amax = None
    for m, amax in zip(layers, amaxes):
        if amax >= 0:
            m.act_scale.fill_(float(np.float32(max(amax * margin, 1e-6) / 127.0)))
    return model


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to ``compute_dtype`` at
    use: a no-op when they are held in it (inference), the bf16 cast of the
    fp32 master weights when a model is trained (``ClipModel(...,
    fp32_master=True)``), as flax casts ``param_dtype`` to ``dtype``."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype, dtype: torch.dtype,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x, self.weight.to(cd), None if self.bias is None else self.bias.to(cd))


def _linear(in_features: int, out_features: int, precision: Precision, quant: bool = False,
            weight_only: bool = False, fp32: bool = False, master: bool = False) -> nn.Module:
    """A projection of the towers: ``QuantLinear`` in the int8 modes, else a
    :class:`Linear` held in the compute dtype (fp32 where ``fold_ln`` folds
    it, or as ``master`` weights)."""
    if quant:
        return QuantLinear(in_features, out_features, precision.compute_dtype, precision.int8_static_act, weight_only)
    held = torch.float32 if fp32 or master else precision.compute_dtype
    return Linear(in_features, out_features, precision.compute_dtype, held)


def _take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[b, rows[b]]``: (B, L, ...) -> (B, S, ...) for (B, S) indices."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], rows]


_MASK = -1e9  # additive mask value of the JAX towers (finite: no inf - inf)


def model_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over a model group, into a new tensor of ``x``'s dtype;
    the sum is taken in fp32 (one rounding to a lower precision, after it).
    ``model_sum.bytes`` counts the bytes all-reduced."""
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device).copy_(x)
    model_sum.bytes += y.numel() * y.element_size()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


model_sum.bytes = 0


class _CopyToModel(torch.autograd.Function):
    """The input of a column-parallel product: identity forward; backward,
    the gradient summed over the model group (each rank's shard of the
    product contributes a part of the replicated input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The output of a row-parallel product: the partial products summed
    over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return model_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _split(mesh: Optional[Mesh], n: int) -> Optional[Mesh]:
    """``mesh`` where its model axis splits ``n`` heads or hidden units,
    else None (the sublayer is built whole)."""
    return mesh if mesh is not None and mesh.model > 1 and n % mesh.model == 0 else None


def _column_input(x: torch.Tensor, tp: Optional[Mesh]) -> torch.Tensor:
    return x if tp is None else _CopyToModel.apply(x, tp.model_group)


def _row_parallel(linear: Linear, x: torch.Tensor, tp: Optional[Mesh]) -> torch.Tensor:
    """``linear(x)`` where ``linear`` holds this rank's input features: the
    partial products summed over the model group, then the bias, added once
    (added on each rank, it would count ``model`` times)."""
    if tp is None:
        return linear(x)
    cd = linear.compute_dtype
    return _ReduceFromModel.apply(F.linear(x, linear.weight.to(cd)), tp.model_group) + linear.bias.to(cd)


class Attention(nn.Module):
    """Multi-head self-attention with a fused QKV projection; ``causal``
    lets token i see tokens j <= i. The plain route adds a -1e9 mask, the
    flash route (K3) masks itself (lemon_tpu/models/clip.py:511-514).
    ``rows`` (B, S) restricts the queries, the output projection and the
    result to those token rows (K and V still span every token); ``ln``
    folds the preceding LayerNorm into the QKV projection. With ``tp`` (a
    mesh whose model axis divides ``heads``) this rank holds ``heads /
    model`` heads: its rows of q, k and v in ``qkv`` and their input columns
    of ``out``."""

    def __init__(self, width: int, heads: int, impl: str = "plain", causal: bool = False,
                 precision: Precision = Precision(), quant: bool = False, pooled: bool = False, fold: bool = False,
                 master: bool = False, tp: Optional[Mesh] = None):
        super().__init__()
        self.tp = tp
        self.head_dim = width // heads
        self.heads = heads if tp is None else heads // tp.model  # this rank's heads
        self.impl = impl
        self.causal = causal
        self.compute_dtype = precision.compute_dtype
        self.softmax_dtype = precision.softmax_dtype
        inner = self.heads * self.head_dim
        # qkv stays W8A8 in the pooled block: its input is full-length
        self.qkv = _linear(width, 3 * inner, precision, quant, fp32=fold, master=master)
        self.out = _linear(inner, width, precision, quant, weight_only=pooled, master=master)

    def forward(self, x: torch.Tensor, rows: Optional[torch.Tensor] = None, ln: Optional[nn.LayerNorm] = None) -> torch.Tensor:
        b, l, _ = x.shape
        hd = self.head_dim
        d = self.heads * hd
        if ln is not None:
            qkv = ln_folded_dense(x, self.qkv.weight, self.qkv.bias, ln.weight, ln.bias, compute_dtype=self.compute_dtype)
        else:
            qkv = self.qkv(_column_input(x, self.tp))
        # (B, L, H, hd) views of the fused projection, the JAX layout
        q, k, v = (t.reshape(b, l, self.heads, hd) for t in qkv.split(d, dim=-1))
        if self.impl == "flash":
            return _row_parallel(self.out, flash_attention(q, k, v, causal=self.causal).reshape(b, l, d), self.tp)
        if rows is not None:
            q = _take_rows(q, rows)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sd = self.softmax_dtype
        logits = (q * hd ** -0.5).to(sd) @ k.to(sd).transpose(-1, -2)
        if self.causal:
            query = rows if rows is not None else torch.arange(l, device=x.device)[None]
            hidden = torch.arange(l, device=x.device)[None, None, :] > query[:, :, None]  # (B or 1, S, L)
            logits = logits + torch.where(hidden, _MASK, 0.0).to(logits.dtype)[:, None]
        out = torch.softmax(logits, dim=-1).to(v.dtype) @ v
        return _row_parallel(self.out, out.transpose(1, 2).reshape(b, q.shape[2], d), self.tp)


class TransformerBlock(nn.Module):
    """Pre-LN residual block (chexzero_clip.py:190-200). ``pooled``: this is
    the pooled last block, run on the rows ``forward`` is given (its int8
    projections after the attention core run weight-only). ``tp``: the mesh
    whose model axis splits the attention's heads and the MLP's hidden
    units, each where it divides them."""

    def __init__(self, width: int, heads: int, impl: str = "plain", causal: bool = False,
                 precision: Precision = Precision(), quant: bool = False, pooled: bool = False, quick: bool = True,
                 master: bool = False, tp: Optional[Mesh] = None):
        super().__init__()
        # quick=False: the exact GELU of timm's ViT (BiomedCLIP). The JAX
        # towers call jax.nn.gelu, whose default is the tanh approximation
        # (ROADMAP: handled divergences)
        self.act = quick_gelu if quick else F.gelu
        # fold_ln folds ln_1/ln_2 into qkv/mlp_fc, but not under flash (:566)
        self.fold = precision.fold_ln and impl != "flash"
        self.compute_dtype = precision.compute_dtype
        self.ln_1 = FpLayerNorm(width, precision.ln_dtype)
        self.attn = Attention(width, heads, impl, causal, precision, quant, pooled, self.fold, master,
                              _split(tp, heads))
        self.ln_2 = FpLayerNorm(width, precision.ln_dtype)
        self.mlp_tp = _split(tp, 4 * width)
        hidden = 4 * width if self.mlp_tp is None else 4 * width // tp.model  # this rank's hidden units
        self.mlp_fc = _linear(width, hidden, precision, quant, weight_only=pooled, fp32=self.fold, master=master)
        self.mlp_proj = _linear(hidden, width, precision, quant, weight_only=pooled, master=master)

    def forward(self, x: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        base = x if rows is None else _take_rows(x, rows)
        if self.fold:
            x = base + self.attn(x, rows, ln=self.ln_1)
            y = ln_folded_dense(x, self.mlp_fc.weight, self.mlp_fc.bias, self.ln_2.weight, self.ln_2.bias,
                                compute_dtype=self.compute_dtype)
        else:
            x = base + self.attn(self.ln_1(x), rows)
            y = self.mlp_fc(_column_input(self.ln_2(x), self.mlp_tp))
        return x + _row_parallel(self.mlp_proj, self.act(y), self.mlp_tp)


class VisionTower(nn.Module):
    """ViT with class token, learned positions and a final projection
    (chexzero_clip.py:226-260). ``tokens_only``: no projection; ``forward``
    returns every token state after ``ln_post`` (the JAX tower's
    ``return_tokens=True``, lemon_tpu/models/clip.py:658-739: the
    captioners' image prefix)."""

    def __init__(self, cfg: ClipConfig, precision: Precision = Precision(), master: bool = False,
                 tokens_only: bool = False, tp: Optional[Mesh] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = cd = precision.compute_dtype
        held = torch.float32 if master else cd
        p, w, g = cfg.vision_patch_size, cfg.vision_width, cfg.grid
        self.pooled = (precision.pool_last_block and cfg.pool_last_block and cfg.attention_impl != "flash"
                       and not tokens_only)
        self.patch_embed = nn.Linear(p * p * 3, w, bias=False, dtype=held)
        # added after the product's cast, as in JAX (:683-685)
        self.patch_bias = nn.Parameter(torch.zeros(w)) if cfg.vision_patch_bias else None
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(g * g + 1, w))
        self.ln_pre = FpLayerNorm(w, precision.ln_dtype) if cfg.vision_ln_pre else None
        last = cfg.vision_layers - 1
        self.blocks = nn.ModuleList(
            TransformerBlock(w, cfg.v_heads, cfg.attention_impl, precision=precision, quant=precision.matmul_int8,
                             pooled=self.pooled and i == last, quick=cfg.quick_gelu, master=master, tp=tp)
            for i in range(cfg.vision_layers)
        )
        self.ln_post = FpLayerNorm(w)  # fp32 tail in every mode (:732, :741)
        self.proj = None if tokens_only else nn.Parameter(torch.empty(w, cfg.embed_dim, dtype=held))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """``pixels``: (B, H, W, 3) NHWC, already normalised; fp32 result."""
        b = pixels.shape[0]
        p, g, w = self.cfg.vision_patch_size, self.cfg.grid, self.cfg.vision_width
        cd = self.compute_dtype
        # patch elements in (ph, pw, channel) order, as the JAX tower unfolds them
        x = pixels.to(cd).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
        x = F.linear(x.float(), self.patch_embed.weight.to(cd).float()).to(cd)
        if self.patch_bias is not None:
            x = x + self.patch_bias.to(cd)
        x = torch.cat([self.class_embedding.to(cd).expand(b, 1, w), x], dim=1) + self.positional_embedding.to(cd)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        # the pooled last block computes the CLS row only (exact; :706-717)
        rows = torch.zeros(b, 1, dtype=torch.long, device=x.device) if self.pooled else None
        for i, block in enumerate(self.blocks):
            x = block(x, rows if i == len(self.blocks) - 1 else None)
        if self.proj is None:
            return self.ln_post(x)
        return _f32_product(self.ln_post(x[:, 0, :]), self.proj.to(cd))


class TextTower(nn.Module):
    """Causal text transformer with first-EOT pooling (chexzero_clip.py:355-376).
    Never quantised: the int8 modes cover the vision tower only."""

    def __init__(self, cfg: ClipConfig, precision: Precision = Precision(), master: bool = False,
                 tp: Optional[Mesh] = None):
        super().__init__()
        w = cfg.text_width
        self.compute_dtype = cd = precision.compute_dtype
        self.pooled = precision.pool_last_block and cfg.pool_last_block_text and cfg.attention_impl != "flash"
        self.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, w))
        last = cfg.text_layers - 1
        self.blocks = nn.ModuleList(
            TransformerBlock(w, cfg.text_heads, cfg.attention_impl, causal=True, precision=precision,
                             pooled=self.pooled and i == last, quick=cfg.quick_gelu, master=master, tp=tp)
            for i in range(cfg.text_layers)
        )
        self.ln_final = FpLayerNorm(w, precision.ln_dtype)
        self.text_projection = nn.Parameter(torch.empty(w, cfg.embed_dim, dtype=torch.float32 if master else cd))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, l = tokens.shape
        cd = self.compute_dtype
        x = self.token_embedding(tokens).to(cd) + self.positional_embedding[:l].to(cd)
        # ids peak at the EOT token; argmax returns its first occurrence
        eot = tokens.argmax(dim=-1)
        rows = eot[:, None] if self.pooled else None
        for i, block in enumerate(self.blocks):
            x = block(x, rows if i == len(self.blocks) - 1 else None)
        if self.pooled:
            pooled = self.ln_final(x[:, 0, :])
        else:
            pooled = self.ln_final(x)[torch.arange(b, device=x.device), eot]
        return _f32_product(pooled, self.text_projection.to(cd))


class ClipModel(nn.Module):
    """Two-tower CLIP with a learned temperature (chexzero_clip.py:263-392),
    in one :class:`Precision` mode. A float state dict loads into every
    mode (:meth:`load_state_dict`). ``fp32_master=True`` (training) holds
    every parameter in fp32 and casts the projections to the compute dtype
    at use, as JAX trains ``Precision.bf16()`` (``param_dtype`` fp32,
    lemon_tpu/core/precision.py:84-96); the inference models hold them in
    the compute dtype, cast once when the weights load. Both give the same
    products. A ``mesh`` with ``model > 1`` builds this rank's shard of the
    tensor-parallel model (module docstring); its state dict holds the
    shards (train/contrastive.py gathers and splits them)."""

    def __init__(self, cfg: ClipConfig, precision: Precision = Precision(), fp32_master: bool = False,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        if precision.fold_ln and precision.matmul_int8:
            raise ValueError("Precision.fold_ln and matmul_int8 are mutually exclusive (as in the JAX package)")
        tp = mesh if mesh is not None and mesh.model > 1 else None
        if tp is not None and (cfg.is_resnet or precision.fold_ln or precision.matmul_int8):
            raise ValueError("tensor parallelism splits the ViT towers of the fp32 and bf16 modes only")
        self.cfg = cfg
        self.precision = precision
        if cfg.is_resnet:
            from lemon_tpu_torch.models.resnet import ResNetVisionTower

            if precision.matmul_int8 or fp32_master:
                raise ValueError("the int8 modes and fp32 master weights cover the ViT towers only")
            self.visual = ResNetVisionTower(cfg, precision.compute_dtype)
        else:
            self.visual = VisionTower(cfg, precision, fp32_master, tp=tp)
        self.text = TextTower(cfg, precision, fp32_master, tp=tp)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """``nn.Module.load_state_dict``, where a float state dict also loads
        into the fast modes: the copy casts the projections to the compute
        dtype, and in the int8 modes the vision projections are quantised
        first (:func:`quantize_clip_params`; from fp32 weights, bit for bit
        the JAX package's)."""
        if self.precision.matmul_int8 and any(_QUANT_WEIGHT.fullmatch(k) for k in state_dict):
            state_dict = quantize_clip_params(state_dict, static_act=self.precision.int8_static_act)
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual(pixels)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens)

    def features(self, pixels: torch.Tensor, tokens: torch.Tensor):
        """The L2-normalised (image, text) embeddings, fp32."""
        img, txt = self.encode_image(pixels), self.encode_text(tokens)
        return (img / torch.linalg.vector_norm(img, dim=-1, keepdim=True),
                txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True))

    def logits(self, img: torch.Tensor, txt: torch.Tensor):
        """``(logits_per_image, logits_per_text)`` of normalised embeddings."""
        logits_per_image = self.logit_scale.exp() * img @ txt.T
        return logits_per_image, logits_per_image.T

    def forward(self, pixels: torch.Tensor, tokens: torch.Tensor):
        """``(logits_per_image, logits_per_text)``, as the JAX
        ``ClipModel.__call__`` (lemon_tpu/models/clip.py:875-882)."""
        return self.logits(*self.features(pixels, tokens))


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` for a torch (out, in, ...) weight: a normal
    truncated at two standard deviations, rescaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_layers_(model: nn.Module, generator: torch.Generator) -> None:
    """The flax defaults of every projection and normalisation of ``model``:
    ``lecun_normal`` weights and zero biases for linear and convolution
    layers, LayerNorm at one and zero (batch norms are built at identity)."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(module.weight, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()


@torch.no_grad()
def init_vit_(v: "VisionTower", generator: torch.Generator) -> None:
    """A ViT tower's own parameters, after :func:`init_layers_`."""
    w = v.cfg.vision_width
    for param in (v.class_embedding, v.positional_embedding, v.proj):
        if param is not None:
            param.normal_(0.0, w ** -0.5, generator=generator)
    if v.patch_bias is not None:
        v.patch_bias.zero_()


@torch.no_grad()
def init_weights(model: ClipModel, seed: int = 0) -> ClipModel:
    """Random initialisation with the JAX towers' distributions
    (lemon_tpu/models/clip.py and resnet.py initialisers). The numbers
    differ from ``jax.random``'s; tests that need identical weights load a
    JAX tree through :func:`lemon_tpu_torch.models.convert.from_flax_params`.
    Every mode gets the same weights from one seed: a bf16 or int8 model
    loads the state dict of its fp32 twin, as a checkpoint loads (:885-902)."""
    if model.precision.compute_dtype != torch.float32 or model.precision.matmul_int8:
        model.load_state_dict(init_weights(ClipModel(model.cfg), seed).state_dict())
        return model
    g = torch.Generator().manual_seed(seed)
    init_layers_(model, g)
    v, t = model.visual, model.text
    if model.cfg.is_resnet:
        pos = v.attnpool.positional_embedding
        pos.normal_(0.0, pos.shape[1] ** -0.5, generator=g)
    else:
        init_vit_(v, g)
    t.token_embedding.weight.normal_(0.0, 0.02, generator=g)
    t.positional_embedding.normal_(0.0, 0.01, generator=g)
    t.text_projection.normal_(0.0, model.cfg.text_width ** -0.5, generator=g)
    model.logit_scale.fill_(math.log(1 / 0.07))
    return model
