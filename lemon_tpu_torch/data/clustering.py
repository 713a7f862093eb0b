"""Caption clustering for pseudo-class labels (port of
lemon_tpu/data/clustering.py).

Mirrors lib/datasets/clustering.py:44-75: embed the captions with a frozen
CLIP text tower, k-means them, and use the cluster ids as class labels for
the deep-kNN baseline. The embedding runs through the port's
:class:`ClipEncoder`, the k-means (:class:`~lemon_tpu_torch.ops.kmeans.KMeans`)
on the encoder's device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from lemon_tpu_torch.models.encoder import ClipEncoder
from lemon_tpu_torch.ops.kmeans import KMeans


class CaptionKMeans:
    """Text-in k-means: ``predict()`` takes raw caption strings."""

    def __init__(self, encoder: ClipEncoder, km: KMeans):
        self.encoder = encoder
        self.km = km

    def predict(self, texts: List[str]) -> np.ndarray:
        return self.km.predict(self.encoder.encode_texts(texts))


def cluster_caption_text(
    text_list: List[str],
    n_clusters: int = 100,
    clip_model: str = "huggingface_clip",
    encoder: ClipEncoder | None = None,
    seed: int = 0,
) -> Tuple[CaptionKMeans, np.ndarray]:
    """``seed`` seeds both the fallback encoder's init and the k-means
    restarts. The k-means runs on the encoder's device; the fallback encoder
    is built on the CUDA card. The reference's FaissKMeans defaults to seed
    42, but its sampler is faiss's own, so assignments match the reference in
    distribution only; the JAX package draws as this one does."""
    if encoder is None:
        from lemon_tpu_torch.core.device import resolve_device
        from lemon_tpu_torch.models.registry import create_encoder

        encoder = create_encoder(clip_model, resolve_device("cuda"), seed=seed)
    emb = encoder.encode_texts(text_list)
    km = KMeans(n_clusters=n_clusters, seed=seed, device=encoder.device).fit(emb)
    return CaptionKMeans(encoder, km), km.predict(emb)
