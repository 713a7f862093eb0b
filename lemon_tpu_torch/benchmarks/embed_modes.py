"""The ViT-B/32 embedding's time in each precision mode (fp32, bf16, int8,
int8_static), chip_smoke phase 13's loop without its checks: 2048
synthetic_caption pairs, random init (seed 0), batch 128, one warm-up batch,
then two timed passes, each between two synchronisations. Prints one line,
``EMBED <tree> CUBLAS_WORKSPACE_CONFIG=<value> {mode: [ms per 1000 pairs,
...]}``.

Run on the card: ``python3 lemon_tpu_torch/benchmarks/embed_modes.py
[TREE]``, where TREE is a checkout whose ``lemon_tpu_torch`` is timed (by
default the one holding this file), so that two commits compare in one
call.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

N_PAIRS = 2048
MODES = ("fp32", "bf16", "int8", "int8_static")


def main(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import lemon_tpu_torch
    from lemon_tpu_torch.core.precision import Precision
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.models.registry import create_encoder

    if not Path(lemon_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"lemon_tpu_torch came from {lemon_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("embed_modes needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)
    train = get_dataset("synthetic_caption", 0, noise_level=0.4, noise_type="random", synthetic_n=2560)[0]
    split = train.subset(np.arange(N_PAIRS))
    texts = list(split.sentence)
    out = {}
    for mode in MODES:
        precision = getattr(Precision, mode)()
        enc = create_encoder("huggingface_clip", device, seed=0, precision=precision)
        enc.embed_split(split.subset(np.arange(128)), texts[:128])
        if mode == "int8_static":  # its lazy calibration timed too, as phase 13 does
            enc = create_encoder("huggingface_clip", device, seed=0, precision=precision)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc.embed_split(split, texts)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / N_PAIRS * 1000)
        out[mode] = times
        del enc
        torch.cuda.empty_cache()
    print(f"EMBED {tree} CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG', 'unset')} {out}",
          flush=True)
    return out


if __name__ == "__main__":
    main(Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[2]).resolve())
