"""Precision policy (port of lemon_tpu/core/precision.py).

fp32 end to end is the parity mode and the default: the reference runs in
fp32 and the AUROC-within-1e-3 acceptance is defined against it. The fast
modes are bf16 compute with fp32 accumulation (``bf16``), plus W8A8
projections in the vision tower (``int8``), plus calibrated static
activation scales (``int8_static``). ``LEMON_TPU_PRECISION`` selects one, as
in the JAX package; neither CLI has a flag for it.
"""

from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """Compute and parameter dtypes of the CLIP towers; the fields and their
    meaning are the JAX package's (lemon_tpu/core/precision.py:19-77)."""

    # dtype the weights are loaded in. The projections are cast to
    # ``compute_dtype`` once, when the model is built (models/clip.py).
    param_dtype: torch.dtype = torch.float32
    # dtype of the residual stream, the projections and the attention core
    compute_dtype: torch.dtype = torch.float32
    # LayerNorm statistics are always fp32; ``ln_dtype`` is the dtype of
    # the normalise/affine tail (CLIP's fp16-safe LayerNorm)
    ln_dtype: torch.dtype = torch.float32
    # dtype of the plain attention's logits and softmax
    softmax_dtype: torch.dtype = torch.float32
    # fold ln_1/ln_2 into the following qkv/fc products (models/clip.py
    # ln_folded_dense); no preset sets it
    fold_ln: bool = False
    # run each tower's last block on its pooled row only (vision CLS;
    # text first EOT when ClipConfig.pool_last_block_text): exact per row,
    # but the changed row set changes summation order, so fp32 keeps it off
    pool_last_block: bool = False
    # W8A8 projections (qkv, attention out, mlp) of the vision tower:
    # per-output-channel int8 weights quantised once when the weights are
    # loaded, per-token activation scales computed on the fly, int32 sums
    matmul_int8: bool = False
    # static per-layer activation scales for the int8 projections,
    # calibrated on the encoder's first image batch (every quantised
    # projection sits behind a LayerNorm or a GELU of LN'd input, so any
    # batch of preprocessed pixels calibrates it)
    int8_static_act: bool = False

    @staticmethod
    def fp32() -> "Precision":
        return Precision()

    @staticmethod
    def bf16() -> "Precision":
        return Precision(
            param_dtype=torch.float32,
            compute_dtype=torch.bfloat16,
            softmax_dtype=torch.bfloat16,
            ln_dtype=torch.float32,
            fold_ln=False,
            pool_last_block=True,
        )

    @staticmethod
    def int8() -> "Precision":
        """bf16 + W8A8 projections in the vision tower (``matmul_int8``)."""
        return dataclasses.replace(Precision.bf16(), matmul_int8=True)

    @staticmethod
    def int8_static() -> "Precision":
        """int8 + calibrated static activation scales (``int8_static_act``)."""
        return dataclasses.replace(Precision.int8(), int8_static_act=True)


def default_precision() -> Precision:
    """The mode ``LEMON_TPU_PRECISION`` names: ``fp32`` (the default),
    ``bf16``/``bfloat16``, ``int8`` or ``int8_static``; anything else is
    fp32, as in the JAX package."""
    mode = os.environ.get("LEMON_TPU_PRECISION", "fp32").lower()
    if mode == "int8":
        return Precision.int8()
    if mode == "int8_static":
        return Precision.int8_static()
    return Precision.bf16() if mode in ("bf16", "bfloat16") else Precision.fp32()
