"""k-means by Lloyd's algorithm on the device (port of lemon_tpu/ops/kmeans.py).

The ``faiss.Kmeans`` surface of the reference (lib/datasets/clustering.py:13-41:
``n_init`` restarts, ``max_iter`` Lloyd steps, ``max_points_per_centroid``
subsampling). The subsample and the initial centroids come from the JAX
package's ``np.random.default_rng(seed)`` draws, so both packages start from
the same centroids. Every restart runs exactly ``max_iter`` steps (JAX's
fixed-length ``lax.scan``), all restarts batched as one (R, N, K) assignment.
The assignment is ``|x|^2 - 2 x.c + |c|^2`` with ties to the first centroid;
the update is the one-hot product ``one_hot^T x`` (no atomics, so two fits on
the card give the same bits), and a centroid whose cluster is empty keeps its
place. k-means has no Pallas kernel in the JAX package: it stays plain
PyTorch. The data and centroids are fp32 as in JAX, but every product and
sum over D or N (``x.c``, ``|x|^2``, ``|c|^2``, ``one_hot^T x`` and the mean)
runs in float64 and is rounded once to fp32, and only the elementwise
combination is fp32. Each value is then the correctly rounded one whatever
order a device sums in, so the card and the CPU follow the same Lloyd
trajectory; in fp32 sums a change of summation order alone (the CPU on
permuted features) moves labels at near-ties and the trajectories part.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lemon_tpu_torch.core.device import resolve_device


def _sq_dists(x64: torch.Tensor, x_sq: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(R, N, K) fp32 squared distances of x (N, D, given in float64) to each
    restart's fp32 centroids (R, K, D), in the JAX package's operation order;
    the products and row sums in float64, rounded once to fp32."""
    logits = torch.matmul(x64, centroids.double().transpose(1, 2)).float()
    c_sq = centroids.double().square().sum(2).float()
    return x_sq[None, :, None] - 2.0 * logits + c_sq[:, None, :]


def _lloyd_restarts(x: torch.Tensor, inits: torch.Tensor, n_iter: int):
    """(centroids (R, K, D), inertia (R,)) after ``n_iter`` Lloyd steps from
    each of the R initial centroid sets."""
    n_clusters = inits.shape[1]
    x64 = x.double()
    x_sq = x64.square().sum(1).float()
    ids = torch.arange(n_clusters, device=x.device)
    centroids = inits
    for _ in range(n_iter):
        labels = _sq_dists(x64, x_sq, centroids).argmin(dim=2)  # (R, N), first minimum
        one_hot = (labels[:, :, None] == ids).double()
        counts = one_hot.sum(1)  # (R, K)
        sums = torch.matmul(one_hot.transpose(1, 2), x64)  # (R, K, D)
        means = (sums / counts.clamp(min=1)[:, :, None]).float()
        centroids = torch.where(counts[:, :, None] > 0, means, centroids)
    return centroids, _sq_dists(x64, x_sq, centroids).amin(dim=2).double().sum(1)


@dataclasses.dataclass
class KMeans:
    """``faiss.Kmeans``-compatible surface: ``fit(x)`` then ``predict(x)``, on
    ``device`` (``None``: the CUDA card)."""

    n_clusters: int
    n_init: int = 5
    max_iter: int = 300
    max_points_per_centroid: int = 1024
    seed: int = 0
    centroids: Optional[np.ndarray] = None
    device: Optional[torch.device] = None

    def _device(self) -> torch.device:
        if self.device is None:
            self.device = resolve_device("cuda")
        return self.device

    def fit(self, x) -> "KMeans":
        x = np.ascontiguousarray(x, np.float32)
        rng = np.random.default_rng(self.seed)
        cap = self.n_clusters * self.max_points_per_centroid
        if len(x) > cap:
            x = x[rng.choice(len(x), cap, replace=False)]
        inits = np.stack([x[rng.choice(len(x), self.n_clusters, replace=False)] for _ in range(self.n_init)])
        device = self._device()
        with torch.inference_mode():
            centroids, inertias = _lloyd_restarts(torch.from_numpy(x).to(device), torch.from_numpy(inits).to(device),
                                                  self.max_iter)
            best = int(inertias.argmin())
            self.centroids = centroids[best].cpu().numpy()
        return self

    def predict(self, x) -> np.ndarray:
        assert self.centroids is not None, "fit first"
        device = self._device()
        with torch.inference_mode():
            x64 = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device).double()
            c = torch.from_numpy(self.centroids).to(device)[None]
            return _sq_dists(x64, x64.square().sum(1).float(), c)[0].argmin(dim=1).cpu().numpy()
