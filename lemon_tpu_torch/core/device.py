"""Device selection and numeric switches.

fp32 is the default mode, as in the JAX package (lemon_tpu/core/precision.py
``Precision.fp32``). TF32 keeps about three decimal digits, so both PyTorch
switches that would route fp32 matmuls and convolutions through it are set
off explicitly; the embedding and kNN parity bars assume full fp32. The bf16
modes ask for fp32 accumulation, as JAX does, so cuBLAS is also kept from
reducing split-K partial sums of bf16 products in bf16.
"""

from __future__ import annotations

import torch

PLATFORMS = ("cuda", "cpu")


def resolve_device(platform: str = "cuda") -> torch.device:
    """``'cuda'`` (the default) or ``'cpu'``. Asking for CUDA where there is
    none raises: a run never falls back to the CPU without being told."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got {platform!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--platform cuda: no CUDA device is available (pass --platform cpu to run on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
