"""What decides ``correct``: each stage of a detection against the plain
reference, after the window.

A detection's outputs (:class:`Outputs`) are judged stage by stage, each
from the stage before it as the program produced it (a full reference
detection of 20,000-50,000 pairs would take longer than the window):

- ``img_emb_gap``, ``txt_emb_gap``: the largest ``1 - cos`` between the
  program's embedding of a row and the reference's (the configuration's
  architecture module, :mod:`portbench.arch`: its own tokenizer,
  preprocessing and forward in fp32 from the raw pixels and texts), over
  ``check_rows`` rows drawn from the seed;
- ``knn_gap``: every query of every split against an exact float64 search
  of the program's own embeddings: the largest gap between a returned
  score and the true score at its rank, or between the true similarity of a
  returned id and the true score at its rank (ties may return any of the
  tied ids); an id out of range or repeated in a row reads infinity;
- ``comp_gap``: the seven score components of every row, worked out in
  float64 at the program's neighbour ids, against the program's;
- ``fit_gap``: the fit, on the val split in float64 from the program's
  components: how far the val F1 that the chosen hyperparameters and
  threshold reach falls below the best F1 of a plain reference fit (every
  point of run_lemon's grid at its best threshold, :func:`reference_fit`),
  or differs from the F1 the program reports (``selected_val``);
- ``score_gap``: every row's score at the hyperparameters the fit chose,
  from the program's components in float64, against the program's, as a
  share of ``max(1, |score|)``;
- ``auroc_gap``: each split's AUROC, from the program's scores and the
  traffic's own mislabel flags, exactly as a rank statistic (the limit is
  0), against the AUROC the program reported.

The control (:func:`control_outputs`) puts the reference in the program's
place, each stage at the precision below the program's: the towers in TF32
(fp32 configurations) or int8 (bf16 ones), the search with bf16 operands
(below ``high``'s three bf16 products), the components' products in TF32,
the scores in bf16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench import arch
from portbench.reference.operands import round_tf32
from portbench.traffic import SPLITS, Detection, Traffic

NUMBERS = ("img_emb_gap", "txt_emb_gap", "knn_gap", "comp_gap", "fit_gap", "score_gap", "auroc_gap")
COMPONENTS = ("d_1", "dists_n", "D_n", "dists_tr_n", "dists_m", "D_m", "dists_tr_m")
HPARAMS = ("beta", "gamma", "tau_1_n", "tau_2_n", "tau_1_m", "tau_2_m")
_BLOCK = 4096


@dataclasses.dataclass
class Outputs:
    """What one detection produced."""

    emb: Dict[str, Tuple[np.ndarray, np.ndarray]]  # split -> (image, text) embeddings of every row
    knn: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]]  # (split, 'img'|'txt') -> (scores, ids) as searched
    logs: Dict[str, np.ndarray]  # COMPONENTS and 'sset', rows in split order
    hparams: Dict[str, float]
    fit: Dict[str, float]  # the fit's reported 'thres' and 'selected_val' (val F1)
    scores: np.ndarray
    auroc: Dict[str, float]
    sample_emb: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None  # the control's, at the sampled rows


def sample_rows(det: Detection, n_rows: int, seed: int) -> Dict[str, np.ndarray]:
    """Rows whose embeddings the reference recomputes, drawn from the seed,
    in proportion to the splits' sizes (at least 64 from each)."""
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, det.index, 11])
    total = det.pairs
    out = {}
    for name in SPLITS:
        n = len(det.splits[name])
        take = min(n, max(64, round(n_rows * n / total)))
        out[name] = np.sort(rng.choice(n, take, replace=False))
    return out


def reference_embeddings(W, cfg: dict, traffic: Traffic, det: Detection, rows: Dict[str, np.ndarray],
                         device: torch.device, mode: str = "fp32", batch: int = 256):
    """split -> (image, text) embeddings of ``rows`` by the reference."""
    ref = arch.of(cfg)
    out = {}
    for name, idx in rows.items():
        split = det.splits[name]
        texts = traffic.texts(split)
        imgs, txts = [], []
        for lo in range(0, len(idx), batch):
            sel = idx[lo: lo + batch]
            pixels = ref.preprocess(torch.from_numpy(np.ascontiguousarray(split.images[sel])).to(device), cfg)
            imgs.append(ref.encode_image(W, cfg, pixels, mode))
            tokens = torch.from_numpy(ref.tokenize([texts[i] for i in sel], cfg)).to(device)
            txts.append(ref.encode_text(W, cfg, tokens, mode))
        out[name] = (torch.cat(imgs).double().cpu().numpy(), torch.cat(txts).double().cpu().numpy())
    return out


def _gap(x: float) -> float:
    """A reading, with NaN (a non-finite output) read as infinity."""
    return math.inf if math.isnan(x) else float(x)


def _one_minus_cos(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return _gap(np.max(1.0 - np.sum(a * b, axis=1)))


def _knn_gap(q: torch.Tensor, db: torch.Tensor, scores: np.ndarray, ids: np.ndarray) -> float:
    if ids.min() < 0 or ids.max() >= len(db):
        return math.inf
    srt = np.sort(ids, axis=1)
    if np.any(srt[:, 1:] == srt[:, :-1]):
        return math.inf
    kk = ids.shape[1]
    worst = 0.0
    for lo in range(0, len(q), _BLOCK):
        sims = q[lo: lo + _BLOCK] @ db.T
        top = torch.topk(sims, kk, dim=1).values
        at = sims.gather(1, torch.from_numpy(ids[lo: lo + _BLOCK].astype(np.int64)).to(q.device))
        got = torch.from_numpy(scores[lo: lo + _BLOCK].astype(np.float64)).to(q.device)
        worst = max(worst, _gap((got - top).abs().max().item()), _gap((at - top).abs().max().item()))
    return worst


def _components(img, txt, img_tr, txt_tr, i_n, i_m, dot) -> Dict[str, torch.Tensor]:
    """The seven components of rows (img, txt) at neighbour ids (i_n of the
    image index, i_m of the text index); ``dot(a, b)`` sums a * b over the
    last axis."""
    dtr = 1.0 - dot(txt_tr, img_tr)
    return {"d_1": 1.0 - dot(img, txt),
            "dists_n": 1.0 - dot(txt[:, None], txt_tr[i_n]), "D_n": -dot(img[:, None], img_tr[i_n]),
            "dists_tr_n": dtr[i_n],
            "dists_m": 1.0 - dot(img[:, None], img_tr[i_m]), "D_m": -dot(txt[:, None], txt_tr[i_m]),
            "dists_tr_m": dtr[i_m]}


def _dot64(a, b):
    return (a * b).sum(-1)


def _excluded(split: str, ids: np.ndarray) -> np.ndarray:
    """The train split searches k+1 and each of its rows, all in the
    comparison set here, drops its first hit (run_lemon.py:257-263)."""
    return ids[:, 1:] if split == "train" else ids


def scores_from_logs(logs: Dict[str, np.ndarray], hp: Dict[str, float]) -> np.ndarray:
    """s = d_1 + beta * d_n + gamma * d_m (lib/metrics/utils.py:47-82), in float64."""
    c = {k: np.asarray(logs[k], np.float64) for k in COMPONENTS}
    k = c["dists_n"].shape[1]
    with np.errstate(over="ignore", invalid="ignore"):
        wn = np.exp(-hp["tau_1_n"] * c["D_n"]) * np.exp(-hp["tau_2_n"] * c["dists_tr_n"])
        wm = np.exp(-hp["tau_1_m"] * c["D_m"]) * np.exp(-hp["tau_2_m"] * c["dists_tr_m"])
        return c["d_1"] + hp["beta"] * np.sum(wn * c["dists_n"], 1) / k + hp["gamma"] * np.sum(wm * c["dists_m"], 1) / k


# run_lemon's grid (run_lemon.py:332-337): tau_1 and tau_2 shared by the
# image (_n) and text (_m) neighbour terms
GRID_BETA = GRID_GAMMA = np.arange(0, 100.01, 5)
GRID_TAU = (0.0, 1.0, 5.0, 10.0)


def f1_at(y: np.ndarray, score: np.ndarray, thres: float) -> float:
    """F1 of the rows with ``score >= thres`` against the flags ``y``."""
    y, pred = np.asarray(y).astype(bool), np.asarray(score) >= thres
    denom = int(pred.sum()) + int(y.sum())
    return 2.0 * int((y & pred).sum()) / denom if denom else 0.0


def _best_f1_rows(scores: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The best F1 over every threshold, for each row of (G, N) scores: the
    cuts between distinct scores in descending order."""
    s, order = torch.sort(scores, dim=1, descending=True)
    tp = torch.cumsum(y[order], dim=1)
    f1 = 2.0 * tp / (torch.arange(1, s.shape[1] + 1, dtype=s.dtype, device=s.device) + y.sum())
    cut = torch.cat([s[:, :-1] > s[:, 1:], torch.ones_like(s[:, :1], dtype=torch.bool)], dim=1)
    return torch.where(cut, f1, torch.zeros_like(f1)).amax(dim=1)


def reference_fit(logs: Dict[str, np.ndarray], y: np.ndarray, device: torch.device) -> float:
    """The best val F1 of the plain reference fit: every point of run_lemon's
    grid (21 x 21 x 4 x 4), each at its best threshold, in float64."""
    c = {k: torch.from_numpy(np.asarray(logs[k], np.float64)).to(device) for k in COMPONENTS}
    yt = torch.from_numpy(np.asarray(y, np.float64)).to(device)
    k = c["dists_n"].shape[1]
    bg = torch.from_numpy(np.array([(b, g) for b in GRID_BETA for g in GRID_GAMMA], np.float64)).to(device)
    best = 0.0
    for t1 in GRID_TAU:
        for t2 in GRID_TAU:
            d_n = (torch.exp(-t1 * c["D_n"]) * torch.exp(-t2 * c["dists_tr_n"]) * c["dists_n"]).sum(1) / k
            d_m = (torch.exp(-t1 * c["D_m"]) * torch.exp(-t2 * c["dists_tr_m"]) * c["dists_m"]).sum(1) / k
            scores = c["d_1"][None] + bg[:, :1] * d_n[None] + bg[:, 1:] * d_m[None]
            best = max(best, _best_f1_rows(scores, yt).max().item())
    return best


def fit_gap(out: "Outputs", det: Detection, device: torch.device) -> float:
    """How far the fit's choice falls below the reference fit on the val
    split, or its reported F1 from the F1 it reaches (both in float64)."""
    val = out.logs["sset"] == "val"
    logs = {c: np.asarray(out.logs[c])[val] for c in COMPONENTS}
    y = det.splits["val"].is_mislabel
    got = f1_at(y, scores_from_logs(logs, out.hparams), out.fit["thres"])
    return max(0.0, _gap(reference_fit(logs, y, device) - got), _gap(abs(out.fit["selected_val"] - got)))


def auroc(y: np.ndarray, score: np.ndarray) -> float:
    """The Mann-Whitney statistic with mid-ranks, as an exact sum of
    half-integers divided once."""
    y = np.asarray(y).astype(bool)
    order = np.argsort(score, kind="mergesort")
    s = np.asarray(score)[order]
    starts = np.r_[0, np.flatnonzero(s[1:] != s[:-1]) + 1]
    ends = np.r_[starts[1:], len(s)]
    mid = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    ranks = np.empty(len(s))
    ranks[order] = mid
    n_pos = int(y.sum())
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * (len(y) - n_pos)))


def _relative_gap(got: np.ndarray, want: np.ndarray) -> float:
    both = ~np.isfinite(want) & (got == want)
    if np.any(~np.isfinite(got) & ~both) or np.any(~np.isfinite(want) & ~both):
        return math.inf
    ok = np.isfinite(want)
    return _gap(np.max(np.abs(got[ok] - want[ok]) / np.maximum(1.0, np.abs(want[ok])), initial=0.0))


def check(out: Outputs, det: Detection, traffic: Traffic, W, cfg: dict, device: torch.device, seed: int,
          n_rows: int) -> Dict[str, float]:
    """Each number of one detection (NUMBERS)."""
    k = traffic.mix["detection"]["knn_k"]
    res = {}
    rows = sample_rows(det, n_rows, seed)
    ref = reference_embeddings(W, cfg, traffic, det, rows, device)
    got = out.sample_emb or {name: (out.emb[name][0][r], out.emb[name][1][r]) for name, r in rows.items()}
    res["img_emb_gap"] = max(_one_minus_cos(got[n][0], ref[n][0]) for n in SPLITS)
    res["txt_emb_gap"] = max(_one_minus_cos(got[n][1], ref[n][1]) for n in SPLITS)

    dev64 = {(n, m): torch.from_numpy(out.emb[n][j]).to(device, torch.float64)
             for n in SPLITS for j, m in enumerate(("img", "txt"))}
    knn_gap = comp_gap = 0.0
    for name in SPLITS:
        want_k = k + 1 if name == "train" else k
        for m in ("img", "txt"):
            scores, ids = out.knn[(name, m)]
            gap = math.inf if ids.shape != (len(det.splits[name]), want_k) else \
                _knn_gap(dev64[(name, m)], dev64[("train", m)], scores, ids)
            knn_gap = max(knn_gap, gap)
        if not math.isfinite(knn_gap):
            comp_gap = math.inf
            continue
        i_n = _excluded(name, out.knn[(name, "img")][1])
        i_m = _excluded(name, out.knn[(name, "txt")][1])
        mask = out.logs["sset"] == name
        for lo in range(0, len(i_n), _BLOCK):
            sl = slice(lo, lo + _BLOCK)
            ref_c = _components(dev64[(name, "img")][sl], dev64[(name, "txt")][sl], dev64[("train", "img")],
                                dev64[("train", "txt")], torch.from_numpy(i_n[sl]).to(device).long(),
                                torch.from_numpy(i_m[sl]).to(device).long(), _dot64)
            for c in COMPONENTS:
                got_c = np.asarray(out.logs[c][mask][sl], np.float64)
                comp_gap = max(comp_gap, _gap(np.max(np.abs(got_c - ref_c[c].cpu().numpy()), initial=0.0)))
    res["knn_gap"], res["comp_gap"] = knn_gap, comp_gap
    return {**res, **check_fit(out, det, device)}


def check_fit(out: Outputs, det: Detection, device: torch.device) -> Dict[str, float]:
    """The numbers of the stages from the fit on: ``fit_gap``,
    ``score_gap``, ``auroc_gap``."""
    res = {"fit_gap": fit_gap(out, det, device),
           "score_gap": _relative_gap(np.asarray(out.scores, np.float64), scores_from_logs(out.logs, out.hparams))}
    scores = np.asarray(out.scores)
    res["auroc_gap"] = max(_gap(abs(out.auroc[n] - auroc(det.splits[n].is_mislabel, scores[out.logs["sset"] == n])))
                           for n in SPLITS)
    return res


def control_outputs(out: Outputs, det: Detection, traffic: Traffic, W, cfg: dict, device: torch.device, seed: int,
                    n_rows: int, tower_mode: str) -> Outputs:
    """The reference in the program's place, each stage at the precision
    below the program's, from the stage before it as the program produced
    it (the stage that :func:`check` judges from the same inputs)."""
    k = traffic.mix["detection"]["knn_k"]
    rows = sample_rows(det, n_rows, seed)
    sample = reference_embeddings(W, cfg, traffic, det, rows, device, mode=tower_mode)
    emb = {(n, m): torch.from_numpy(out.emb[n][j]).to(device, torch.float32)
           for n in SPLITS for j, m in enumerate(("img", "txt"))}
    bf16 = lambda x: x.bfloat16().float()  # noqa: E731
    knn, logs = {}, {c: [] for c in COMPONENTS}
    for name in SPLITS:
        kk = k + 1 if name == "train" else k
        for m in ("img", "txt"):
            q, db = emb[(name, m)], emb[("train", m)]
            vals, idx = [], []
            for lo in range(0, len(q), _BLOCK):
                v, i = torch.topk(bf16(q[lo: lo + _BLOCK]) @ bf16(db).T, kk, dim=1)
                vals.append(v.cpu().numpy())
                idx.append(i.cpu().numpy())
            knn[(name, m)] = (np.concatenate(vals), np.concatenate(idx))
        parts = _components(emb[(name, "img")], emb[(name, "txt")], emb[("train", "img")], emb[("train", "txt")],
                            torch.from_numpy(_excluded(name, knn[(name, "img")][1])).to(device),
                            torch.from_numpy(_excluded(name, knn[(name, "txt")][1])).to(device),
                            lambda a, b: (round_tf32(a) * round_tf32(b)).sum(-1))
        for c in COMPONENTS:
            logs[c].append(parts[c].cpu().numpy())
    logs = {c: np.concatenate(v) for c, v in logs.items()}
    logs["sset"] = np.concatenate([np.full(len(det.splits[n]), n, object) for n in SPLITS])
    comps = {c: torch.from_numpy(np.asarray(logs[c], np.float32)).bfloat16() for c in COMPONENTS}
    hp = out.hparams
    wn = torch.exp(-hp["tau_1_n"] * comps["D_n"]) * torch.exp(-hp["tau_2_n"] * comps["dists_tr_n"])
    wm = torch.exp(-hp["tau_1_m"] * comps["D_m"]) * torch.exp(-hp["tau_2_m"] * comps["dists_tr_m"])
    scores = (comps["d_1"] + hp["beta"] * (wn * comps["dists_n"]).sum(1) / k
              + hp["gamma"] * (wm * comps["dists_m"]).sum(1) / k).float().numpy().astype(np.float64)
    aurocs = {n: auroc(det.splits[n].is_mislabel, scores[logs["sset"] == n]) for n in SPLITS}
    return Outputs(emb=out.emb, knn=knn, logs=logs, hparams=hp, fit=out.fit, scores=scores, auroc=aurocs,
                   sample_emb=sample)
