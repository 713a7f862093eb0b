"""Discrepancy/diversity baseline, "Emphasizing Complementary Samples" (port
of lemon_tpu/baselines/discrepancy.py).

Reference: lib/baselines/discrepancy_baseline.py:164-230. Four scores over
the k nearest *text* neighbours of each example (comparison set = train),
searched by an exact ``ip`` index at precision ``highest`` (K1 and K2 on the
card):

- dis_y / dis_x: mean distance from the query's text / image embedding to
  the second-hop neighbourhood (the text neighbours' own text neighbours,
  each list self-excluded), reference :217-224;
- div_y / div_x: mean pairwise distance among the first-hop neighbours'
  text / image embeddings, normalised by k^2, reference :225-230.

Reference quirks kept: the train split searches k+1 neighbours and does NOT
drop its self match from I_m (only the second-hop cache is self-excluded),
and div_* divides by k^2 even over k+1 neighbours. The gathers and products
run on the device in row chunks whose gathered block stays under
``GATHER_BUDGET`` bytes (at 16000 train rows, k = 30, the whole second hop
would be 29 GB in fp32).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from lemon_tpu_torch.baselines.common import (
    BaselineConfig, cache_kwargs, evaluate_scores, setup, split_frame, to_device,
)
from lemon_tpu_torch.detect import _texts_for_split
from lemon_tpu_torch.knn.index import ExactKnnIndex

METHODS = ("dis_y", "dis_x", "div_y", "div_x")
GATHER_BUDGET = 256 << 20


def self_excluded_cache(c: torch.Tensor, k: int) -> torch.Tensor:
    """Second-hop cache (discrepancy_baseline.py:164-169): each train row's
    neighbour list ``c`` (N, k+1) without the row itself, cut to k. A row
    whose list lacks its self match (duplicate embeddings tie and the lower
    index wins) keeps its first k; a row left with fewer than k is padded
    with its first entries, as the JAX package's loop does."""
    n, width = c.shape
    keep = c != torch.arange(n, device=c.device)[:, None]
    n_keep = keep.sum(1, keepdim=True)
    # stable sort on "is self": the kept entries first, in their order
    kept = c.gather(1, torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices)
    j = torch.arange(k, device=c.device)[None, :]
    pad = c.gather(1, (j - n_keep).clamp(0, width - 1))
    return torch.where(j < n_keep, kept[:, :k], pad)


def _in_range(ids: np.ndarray, n: int) -> None:
    """A padding id (k above the train set) has no row to gather: numpy's
    IndexError in the JAX package, raised here before any device gather."""
    if ids.size and int(ids.max()) >= n:
        raise IndexError(f"index {int(ids.max())} is out of bounds for axis 0 with size {n}")


def _row_chunk(row_bytes: int) -> int:
    return max(1, GATHER_BUDGET // max(row_bytes, 1))


def discrepancy_scores(method: str, q: torch.Tensor, I_m: torch.Tensor, cache: Optional[torch.Tensor],
                       ref: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) scores of the query embeddings ``q`` (B, D) with first-hop text
    neighbours ``I_m`` (B, m) into the train set, whose text or image
    embeddings are ``ref`` (N, D); ``cache`` (N, k) is the second hop."""
    b, m = I_m.shape
    d = ref.shape[1]
    out = []
    if method.startswith("dis"):
        step = _row_chunk(m * k * d * 4)
        for s in range(0, b, step):
            hop2 = cache[I_m[s : s + step]].reshape(-1, m * k)  # (b, m*k)
            v = 1.0 - torch.bmm(ref[hop2], q[s : s + step, :, None])[:, :, 0]
            out.append(v.mean(dim=1))
    else:
        step = _row_chunk(m * d * 4)
        for s in range(0, b, step):
            nb = ref[I_m[s : s + step]]  # (b, m, D)
            u = 1.0 - torch.bmm(nb, nb.transpose(1, 2))
            out.append(u.sum(dim=(1, 2)) / k**2)
    return torch.cat(out)


def run_discrepancy(cfg: BaselineConfig, out_dir: Optional[Path] = None, splits=None, encoder=None) -> Dict:
    assert cfg.method in METHODS, f"discrepancy baseline needs method in dis_y|dis_x|div_y|div_x, got {cfg.method!r}"
    splits, encoder, label_set, device = setup(cfg, splits, encoder)
    k = cfg.knn_k

    train = splits["train"]
    noisy_texts_tr, _, _, _ = _texts_for_split(cfg, train, label_set)
    img_tr, txt_tr = encoder.embed_split(train, noisy_texts_tr, **cache_kwargs(cfg, encoder, train, noisy_texts_tr))
    img_tr, txt_tr = to_device(img_tr, device), to_device(txt_tr, device)

    index_txt = ExactKnnIndex(metric="ip", device=device, tile=cfg.knn_tile or None)
    index_txt.add(txt_tr)

    cache = None
    if cfg.method.startswith("dis"):
        _, c = index_txt.search(txt_tr, k + 1)
        _in_range(c, len(txt_tr))
        cache = self_excluded_cache(torch.from_numpy(c.astype(np.int64)).to(device), k)

    t0 = time.time()
    names = ["val", "test"] if (cfg.debug or cfg.skip_train) else ["train", "val", "test"]
    scores = {}
    text_side = cfg.method.endswith("_y")
    for sname in names:
        split = splits[sname]
        noisy_texts, _, _, _ = _texts_for_split(cfg, split, label_set)
        if sname == "train":
            img, txt = img_tr, txt_tr
        else:
            img, txt = encoder.embed_split(split, noisy_texts, **cache_kwargs(cfg, encoder, split, noisy_texts))
            img, txt = to_device(img, device), to_device(txt, device)
        _, I_m = index_txt.search(txt, k + (sname == "train"))
        _in_range(I_m, len(txt_tr))
        I_m = torch.from_numpy(I_m.astype(np.int64)).to(device)
        ref, q = (txt_tr, txt) if text_side else (img_tr, img)
        scores[sname] = discrepancy_scores(cfg.method, q, I_m, cache, ref, k).cpu().numpy()
    runtime = time.time() - t0

    df = split_frame(cfg, {s: splits[s] for s in names}, scores)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        np.save(out_dir / "runtime.npy", np.array([runtime]))
    return evaluate_scores(df, out_dir)
