"""The LEMoN mislabel score (port of lemon_tpu/scoring/lemon.py).

    s(x, y) = d_1(x, y) + beta * d_n(x, y) + gamma * d_m(x, y)

with, per example and k neighbours from the comparison set,

    d_n = (1/k) * sum_j exp(-tau_1n * D_n[j]) * exp(-tau_2n * dtr_n[j]) * dists_n[j]

and d_m the same over the text neighbours (lib/metrics/utils.py:47-82).
:class:`NeighborLogs`, :func:`calc_scores` and :func:`unpack_hparams` are the
JAX package's numpy code; :func:`calc_scores_grid` evaluates a whole
hyperparameter grid on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

HPARAM_ORDER = ("beta", "gamma", "tau_1_n", "tau_2_n", "tau_1_m", "tau_2_m")
COMPONENTS = ("d_1", "dists_n", "D_n", "dists_tr_n", "dists_m", "D_m", "dists_tr_m")


def unpack_hparams(x: Sequence[float], force_zero=(), force_one=()) -> Dict[str, float]:
    """6-vector -> named hparams with ablation masks (lib/metrics/utils.py:84-102)."""
    out = dict(zip(HPARAM_ORDER, [float(v) for v in x]))
    for name in out:
        if name in force_zero:
            out[name] = 0.0
    for name in out:
        if name in force_one:
            out[name] = 1.0
    return out


@dataclasses.dataclass
class NeighborLogs:
    """Dense per-example neighbour statistics for one or more splits.

    Shapes: d_1 (N,); every neighbour matrix (N, k). ``sset`` tags each
    row's split; ``is_mislabel`` is the binary target."""

    d_1: np.ndarray
    dists_n: np.ndarray
    D_n: np.ndarray
    dists_tr_n: np.ndarray
    dists_m: np.ndarray
    D_m: np.ndarray
    dists_tr_m: np.ndarray
    is_mislabel: np.ndarray
    sset: np.ndarray
    idx: Optional[np.ndarray] = None
    noisy_label: Optional[np.ndarray] = None
    actual_label: Optional[np.ndarray] = None
    noisy_label_text: Optional[np.ndarray] = None
    actual_label_text: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.d_1)

    @property
    def k(self) -> int:
        return self.dists_n.shape[1]

    def select(self, mask: np.ndarray) -> "NeighborLogs":
        return NeighborLogs(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name)[mask]
            for f in dataclasses.fields(self)
        })

    def split(self, name: str) -> "NeighborLogs":
        return self.select(self.sset == name)

    def to_dataframe(self):
        """Reference-compatible frame (res.pkl 'df', run_lemon.py:291-307):
        neighbour rows become object columns."""
        import pandas as pd

        n = len(self)
        data = {
            "sset": self.sset,
            "idx": self.idx if self.idx is not None else np.arange(n),
            "is_mislabel": self.is_mislabel.astype(np.int64),
            "is_correct_label": 1 - self.is_mislabel.astype(np.int64),
            "d_1": self.d_1,
            "dists_n": list(self.dists_n),
            "D_n": list(self.D_n),
            "dists_tr_n": list(self.dists_tr_n),
            "dists_m": list(self.dists_m),
            "D_m": list(self.D_m),
            "dists_tr_m": list(self.dists_tr_m),
        }
        for name in ("noisy_label", "actual_label", "noisy_label_text", "actual_label_text"):
            if getattr(self, name) is not None:
                data[name] = getattr(self, name)
        return pd.DataFrame(data)

    @staticmethod
    def from_dataframe(df) -> "NeighborLogs":
        get = lambda c: df[c].to_numpy() if c in df else None
        return NeighborLogs(
            d_1=df["d_1"].to_numpy(dtype=np.float64),
            **{c: np.stack(df[c].to_list()) for c in COMPONENTS[1:]},
            is_mislabel=df["is_mislabel"].to_numpy(),
            sset=df["sset"].to_numpy(),
            idx=get("idx"),
            noisy_label=get("noisy_label"),
            actual_label=get("actual_label"),
        )


def calc_scores(logs: NeighborLogs, hparams: Dict[str, float], return_components: bool = False):
    """Vectorised numpy score (calc_scores_given_hparams_vectorized,
    lib/metrics/utils.py:47-82)."""
    wn = np.exp(-hparams["tau_1_n"] * logs.D_n) * np.exp(-hparams["tau_2_n"] * logs.dists_tr_n)
    wm = np.exp(-hparams["tau_1_m"] * logs.D_m) * np.exp(-hparams["tau_2_m"] * logs.dists_tr_m)
    d_n = np.sum(wn * logs.dists_n, axis=1) / logs.k
    d_m = np.sum(wm * logs.dists_m, axis=1) / logs.k
    scores = logs.d_1 + hparams["beta"] * d_n + hparams["gamma"] * d_m
    if return_components:
        return scores, d_n, d_m
    return scores


def component_tensors(logs: NeighborLogs, device: torch.device):
    """The seven score components as float32 tensors on ``device``."""
    return tuple(torch.as_tensor(np.asarray(getattr(logs, c), np.float32), device=device) for c in COMPONENTS)


def scores_grid(components, grid: torch.Tensor) -> torch.Tensor:
    """(G, 6) hparams x components -> (G, N) scores, in float32 on the
    components' device (lemon_tpu/scoring/lemon.py:169-178)."""
    d1, dists_n, D_n, dtr_n, dists_m, D_m, dtr_m = components
    beta, gamma, t1n, t2n, t1m, t2m = (grid[:, i, None, None] for i in range(6))
    k = dists_n.shape[1]
    d_n = torch.sum(torch.exp(-t1n * D_n[None] - t2n * dtr_n[None]) * dists_n[None], dim=2) / k
    d_m = torch.sum(torch.exp(-t1m * D_m[None] - t2m * dtr_m[None]) * dists_m[None], dim=2) / k
    return d1[None] + beta[:, :, 0] * d_n + gamma[:, :, 0] * d_m


def calc_scores_grid(logs: NeighborLogs, grid: np.ndarray, device: torch.device, batch: int = 256) -> np.ndarray:
    """Evaluate (G, 6) hparam combinations -> (G, N) scores on ``device``."""
    comps = component_tensors(logs, device)
    g = torch.as_tensor(np.asarray(grid, np.float32), device=device)
    return torch.cat([scores_grid(comps, g[s : s + batch]) for s in range(0, len(g), batch)]).cpu().numpy()


def _clip(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``jnp.clip(x, -bound, bound)``, gradient included: half at a tie
    (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(-bound)), x.new_tensor(bound))


def soft_margin_proxy_loss(x: torch.Tensor, components, y_signed: torch.Tensor, force_zero: torch.Tensor, force_one: torch.Tensor) -> torch.Tensor:
    """Differentiable proxy for F1, one value per row of ``x`` (R, 6):
    SoftMarginLoss(score, y in {-1, 1}) = mean(log(1 + exp(-y * score)))
    (lib/metrics/utils.py:123-127; lemon_tpu/scoring/lemon.py:203-233).

    As in the JAX package, the hparams are clamped to the grid's domain
    |h| <= 100 and the exponent to +-60, so no iterate overflows float32;
    ``force_zero`` / ``force_one`` (6,) bool masks pin ablated hparams
    inside the loss, so their gradient is zero."""
    d1, dists_n, D_n, dtr_n, dists_m, D_m, dtr_m = components
    x = _clip(x, 100.0)
    x = torch.where(force_zero, torch.zeros_like(x), x)
    x = torch.where(force_one, torch.ones_like(x), x)
    beta, gamma, t1n, t2n, t1m, t2m = (x[:, i, None, None] for i in range(6))
    k = dists_n.shape[1]
    wn = torch.exp(_clip(-t1n * D_n - t2n * dtr_n, 60.0))
    wm = torch.exp(_clip(-t1m * D_m - t2m * dtr_m, 60.0))
    d_n = torch.sum(wn * dists_n, dim=2) / k
    d_m = torch.sum(wm * dists_m, dim=2) / k
    score = d1 + beta[:, :, 0] * d_n + gamma[:, :, 0] * d_m
    return torch.logaddexp(torch.zeros_like(score), -y_signed * score).mean(dim=1)
