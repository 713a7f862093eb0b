"""CapFilt baseline: image-text-matching scores (port of
lemon_tpu/baselines/capfilt.py; reference
lib/baselines/run_capfilt_baseline.py:35-70).

Per (image, caption) pair, the probability that the pair matches under a
BLIP ITM head; the mislabel score is ``1 - P(match)``. The scorer is
pluggable, as in the JAX package:

- ``itm_score_fn(images_u8, captions) -> P(match)``, any scorer;
- :func:`blip_itm_scorer` (:mod:`lemon_tpu_torch.models.blip_itm`): a local
  BLIP-ITM checkpoint directory, scored on the run's device in batches of
  16, where the JAX package calls ``transformers`` on the host;
- :func:`clip_itm_proxy`: ``sigmoid(scale * cosine)`` with the port's CLIP.

No kernel of the port runs here: the ITM tower and the proxy's ViT take
plain attention, as the JAX package scores with host torch and XLA.
"""

from __future__ import annotations

import pickle
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from lemon_tpu_torch.baselines.common import BaselineConfig, evaluate_scores, setup, split_frame
from lemon_tpu_torch.data.datasets import iter_batches, load_images
from lemon_tpu_torch.detect import _texts_for_split
from lemon_tpu_torch.models.blip_itm import blip_itm_scorer
from lemon_tpu_torch.ops.image import pil_resize_crop_u8

__all__ = ["blip_itm_scorer", "clip_itm_proxy", "run_capfilt"]


def clip_itm_proxy(encoder, scale: float = 10.0) -> Callable:
    """P(match) ~ ``sigmoid(scale * cosine)`` with the port's CLIP encoder
    (lemon_tpu/baselines/capfilt.py:52-69); a ragged list of raw sizes is
    unified on the host with the reference's PIL resize and crop."""

    def score(images_u8, captions):
        if isinstance(images_u8, (list, tuple)) and len({np.asarray(a).shape for a in images_u8}) > 1:
            size = encoder.cfg.image_resolution
            images_u8 = [pil_resize_crop_u8(a, size) for a in images_u8]
        img = encoder.encode_images(np.asarray(images_u8))
        txt = encoder.encode_texts(list(captions))
        sim = np.sum(img * txt, axis=1)
        return 1.0 / (1.0 + np.exp(-scale * sim))

    return score


def run_capfilt(cfg: BaselineConfig, out_dir: Optional[Path] = None, splits=None, encoder=None,
                itm_score_fn: Optional[Callable] = None) -> Dict:
    """Score every split; write ``full_loss_dict.pkl`` (P(match) by split),
    ``flip_labels.pkl``, ``runtime.npy`` and the shared evaluation files."""
    splits, encoder, label_set, device = setup(cfg, splits, encoder)
    if itm_score_fn is None:
        ckpt = cfg.itm_checkpoint
        if ckpt:
            if not Path(ckpt).exists():
                # an explicit checkpoint must not silently degrade to a
                # different baseline method (the CLIP proxy head)
                raise SystemExit(f"--itm_checkpoint does not exist: {ckpt}")
            itm_score_fn = blip_itm_scorer(ckpt, device)
        else:
            print("[capfilt] no BLIP-ITM checkpoint; using the CLIP ITM proxy head")
            itm_score_fn = clip_itm_proxy(encoder)

    t0 = time.time()
    scores, loss_dict = {}, {}
    for sname in ("train", "val", "test"):
        split = splits[sname]
        noisy_texts, _, _, _ = _texts_for_split(cfg, split, label_set)
        p_match = np.zeros(len(split))
        for idx, n_valid in iter_batches(split, cfg.batch_size):
            # a list of images at their own sizes: the BLIP processor resizes
            # each, the proxy unifies a ragged list itself
            images = load_images(split, idx, stack=False)
            p = itm_score_fn(images, [noisy_texts[i] for i in idx])
            p_match[idx[:n_valid]] = p[:n_valid]
        scores[sname] = 1.0 - p_match  # high = mismatch = likely mislabel
        loss_dict[sname] = p_match
    runtime = time.time() - t0

    df = split_frame(cfg, splits, scores)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "full_loss_dict.pkl", "wb") as f:
            pickle.dump(loss_dict, f)
        with open(out_dir / "flip_labels.pkl", "wb") as f:
            pickle.dump({s: splits[s].is_mislabel for s in splits}, f)
        np.save(out_dir / "runtime.npy", np.array([runtime]))
    return evaluate_scores(df, out_dir)
