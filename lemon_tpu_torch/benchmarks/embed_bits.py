"""Which earlier work in a process changes the bits of a bf16 embedding.

chip_smoke's phase 10 (the ViT-B/32 detection in bf16) embeds after phases
3-6 (K1, K2, the search, the fp32 detection) have run in the same process,
and its embeddings differed from those of a process that ran phase 10 first.
This program embeds 2048 synthetic_caption pairs with the bf16
``huggingface_clip`` encoder (random init, seed 0, batch 128), then runs
each of those phases in turn (chip_smoke's own functions) and embeds the
same pairs again with the same encoder after each, and finally with a new
encoder. Each line ``BITS <after what> {...}`` counts the image and text
rows whose bits differ from the first embedding.

Run on the card from a checkout's root: ``python3
lemon_tpu_torch/benchmarks/embed_bits.py``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
N_PAIRS = 2048


def main() -> dict:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from lemon_tpu_torch.benchmarks._timing import cuda_ms
    from lemon_tpu_torch.core.precision import Precision
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.knn.index import ExactKnnIndex
    from lemon_tpu_torch.models.registry import create_encoder
    from lemon_tpu_torch.ops import scoremax, topk

    if not torch.cuda.is_available():
        raise RuntimeError("embed_bits needs an NVIDIA GPU")
    chip_smoke.cuda_ms = cuda_ms
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    train = get_dataset("synthetic_caption", 0, noise_level=0.4, noise_type="random", synthetic_n=2560)[0]
    split = train.subset(np.arange(N_PAIRS))
    texts = list(split.sentence)

    def embed(enc):
        img, txt = enc.embed_split(split, texts)
        torch.cuda.synchronize()
        return np.asarray(img), np.asarray(txt)

    enc = create_encoder("huggingface_clip", device, seed=0, precision=Precision.bf16())
    first = embed(enc)
    report = {}

    def compare(label):
        img, txt = embed(enc)
        out = {"image_rows": int((img != first[0]).any(axis=1).sum()), "text_rows": int((txt != first[1]).any(axis=1).sum()),
               "max_abs_diff": float(max(np.abs(img - first[0]).max(), np.abs(txt - first[1]).max()))}
        report[label] = out
        print(f"BITS after {label}: {json.dumps(out)}", flush=True)

    compare("nothing (a repeat)")
    steps = (("phase 3 (K1)", lambda: chip_smoke.phase_k1(torch, scoremax, device)),
             ("phase 4 (K2)", lambda: chip_smoke.phase_k2(torch, topk, device)),
             ("phase 5 (the search)", lambda: chip_smoke.phase_knn(torch, scoremax, topk, ExactKnnIndex, device)),
             ("an fp32 embedding (phase 6's encoder)",
              lambda: embed(create_encoder("huggingface_clip", device, seed=0, precision=Precision.fp32()))))
    for label, run in steps:
        t0 = time.perf_counter()
        run()
        torch.cuda.empty_cache()
        print(f"ran {label} in {time.perf_counter() - t0:.1f} s", flush=True)
        compare(label)
    enc = create_encoder("huggingface_clip", device, seed=0, precision=Precision.bf16())
    compare("all of them, with a new bf16 encoder")
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    return report


if __name__ == "__main__":
    main()
