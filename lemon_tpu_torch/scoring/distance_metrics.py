"""Distance-based and training-dynamics detection scores (port of
lemon_tpu/scoring/distance_metrics.py).

- :func:`pair_distances` — per-pair modality distance, float64 numpy (O(N*D):
  the diagonal only).
- :func:`aum_score` — area under the margin over training epochs (numpy).
- :func:`datamap_score` — mean/std of the assigned-label probability over
  epochs (numpy).
- :func:`knn_label_distribution` — SimiFeat-style weighted kNN label votes
  through :class:`~lemon_tpu_torch.knn.index.ExactKnnIndex` (K1 ``ip/highest``
  and K2 on the card), the core of the deep-kNN baseline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def pair_distances(a, b, dist: str = "cosine"):
    """Row-wise distance between two aligned embedding matrices (N, D), in
    float64 numpy."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if dist == "cosine":
        num = np.sum(a * b, axis=1)
        denom = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
        return 1.0 - num / np.maximum(denom, 1e-30)
    if dist == "euclidean":
        return np.sqrt(np.sum((a - b) ** 2, axis=1))
    if dist == "manhattan":
        return np.sum(np.abs(a - b), axis=1)
    raise NotImplementedError(dist)


def aum_score(probs_epochs: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Mean over epochs of (P[assigned label] - max P[other observed label]).

    probs_epochs: (E, N, C); y: (N,) assigned (noisy) labels. Low margin ->
    likely mislabelled. 'Other' ranges over the labels observed in y, as in
    the reference (lib/metrics/distance_metrics.py:157-162).
    """
    probs_epochs = np.asarray(probs_epochs)
    y = np.asarray(y)
    # range check only: a split may validly contain no class-0 examples
    assert y.min() >= 0 and y.max() < probs_epochs.shape[2], "labels out of range"
    observed = np.unique(y)
    e, n, c = probs_epochs.shape
    true_p = probs_epochs[:, np.arange(n), y]  # (E, N)
    masked = np.full((e, n, c), -np.inf)
    masked[:, :, observed] = probs_epochs[:, :, observed]
    masked[:, np.arange(n), y] = -np.inf
    other_max = masked.max(axis=2)  # (E, N)
    return (true_p - other_max).mean(axis=0)


def datamap_score(probs_epochs: np.ndarray, y: np.ndarray, threshold: float | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Datamaps: (flag, (mean confidence, variability)) per example.

    flag = (mean < 0.5) & (std < 0.1) by default, or both <= threshold when
    given (lib/metrics/distance_metrics.py:120-133).
    """
    probs_epochs = np.asarray(probs_epochs)
    y = np.asarray(y)
    assert y.min() >= 0 and y.max() < probs_epochs.shape[2], "labels out of range"
    n = len(y)
    true_p = probs_epochs[:, np.arange(n), y]  # (E, N)
    mean = true_p.mean(axis=0)
    std = true_p.std(axis=0)
    if threshold is None:
        flags = (mean < 0.5) & (std < 0.1)
    else:
        flags = (mean <= threshold) & (std <= threshold)
    return flags.astype(np.int64), np.stack([mean, std], axis=1)


def vote_sums(nb_labels: torch.Tensor, weights: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(N, C) float64 sums of the weights (N, k) by the neighbours' labels
    (N, k). One pass per neighbour column: a pass adds at most one vote to
    any (row, class) cell, so the atomics of ``scatter_add_`` meet no
    contention, the votes of a row add in neighbour order as in
    ``np.bincount`` (lemon_tpu/scoring/distance_metrics.py:115), and the
    card gives the same bits on every run."""
    votes = torch.zeros((nb_labels.shape[0], n_classes), dtype=torch.float64, device=weights.device)
    for j in range(nb_labels.shape[1]):
        votes.scatter_add_(1, nb_labels[:, j : j + 1], weights[:, j : j + 1].double())
    return votes


def knn_label_distribution(
    features,
    labels,
    n_classes: int,
    k: int = 10,
    min_similarity: float = 0.0,
    norm: str = "l2",
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Per-example class-probability estimate from weighted kNN votes
    (count_knn_distribution, lib/metrics/utils.py:205-233), as a (N, C)
    float32 numpy array.

    The rows are L2-normalised on the host as in the JAX package, then
    searched against themselves by an exact ``ip`` index at precision
    ``highest`` on ``device`` (``None``: the CUDA card). The k votes of a row
    are summed in float64 in neighbour order, one column at a time: each
    pass adds at most one vote to any (row, class) cell (:func:`vote_sums`)."""
    from lemon_tpu_torch.core.device import resolve_device
    from lemon_tpu_torch.knn.index import ExactKnnIndex

    device = resolve_device("cuda") if device is None else device
    f = np.asarray(features, np.float32)
    if not 3 <= k <= len(f):
        raise ValueError(f"k={k} must be in [3, n_rows={len(f)}] (self-distance extrapolation needs 3 neighbors)")
    if norm not in ("l1", "l2"):
        raise NameError(norm)
    f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-30)
    f_dev = torch.from_numpy(np.ascontiguousarray(f)).to(device)
    index = ExactKnnIndex(metric="ip", device=device)
    index.add(f_dev)
    sims, idx = index.search(f_dev, k)
    sims = torch.from_numpy(sims).to(device)
    vals = 1.0 - sims  # ascending cosine distances; the first hit is self
    # SimiFeat: the self distance (~0) becomes a linear extrapolation from
    # neighbours 1 and 2 (lib/metrics/utils.py:214)
    vals[:, 0] = 2.0 * vals[:, 1] - vals[:, 2]
    weights = (1.0 - min_similarity) - vals  # (N, k) float32
    nb_labels = torch.from_numpy(np.asarray(labels, np.int64)[idx]).to(device)
    votes = vote_sums(nb_labels, weights, n_classes).float()
    if norm == "l2":
        denom = torch.linalg.vector_norm(votes, dim=1, keepdim=True)
    else:
        denom = votes.sum(dim=1, keepdim=True)
    return (votes / denom.clamp(min=1e-30)).cpu().numpy()
