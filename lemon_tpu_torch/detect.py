"""End-to-end LEMoN mislabel detection (port of lemon_tpu/detect.py).

The library core behind ``lemon_tpu_torch.cli.run_lemon``:

1. load the dataset on the host;
2. embed every split (:class:`ClipEncoder`: device preprocessing, both
   towers, L2 normalisation);
3. two exact kNN searches per split (:class:`ExactKnnIndex`, kernels K1 and
   K2), then the k+1 self-exclusion on the train split;
4. the score components, gathered on the device in 16384-row chunks;
5. the hyperparameter fit (:func:`maximize_metric`);
6. metrics and the reference's output files (res.pkl, {criteria}_scores.csv).

Semantics notes (as in the JAX package): cosine neighbour scores are negated
into distances (run_lemon.py:270,286), euclidean ones are squared distances;
the train split searches k+1 and drops itself per comparison-set membership
(run_lemon.py:257-263); the 50k comparison subsample is drawn from
``RandomState(seed)`` (run_lemon.py:122-127).

Two in-process caches serve repeated detections (a sweep over k, seed,
ablation or hyperparameters; lemon_tpu/detect.py:199-229, :492-520): the
encoder of the last (model, seed, batch size, checkpoint, precision,
device), and, under ``--embedding_cache``, up to four (image, text) pairs of
embeddings on the device, keyed on their content (``ClipEncoder.cache_key``)
and the device. A warm repeat builds no encoder, uploads no embedding and,
with a procedural dataset, renders no pixel. A hit hands the same tensors to
a later run, so nothing downstream writes them in place.

Under ``mesh_shape`` (``--mesh DATAxMODEL``, lemon_tpu/detect.py:237-269,
:504-530) one process drives each device: every rank embeds its data
rank's rows of each batch and gathers every embedding, searches its data
rank's shard of the comparison set (knn/index.py), and computes the
components, the fit and the metrics, which come out the same on every rank;
the model axis replicates the work, and only global rank 0 writes the
output files.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lemon_tpu_torch.core.device import resolve_device
from lemon_tpu_torch.core.mesh import Mesh, get_mesh
from lemon_tpu_torch.core.precision import default_precision
from lemon_tpu_torch.core.profiling import PhaseTimer
from lemon_tpu_torch.data.datasets import CLF_DATASETS, get_dataset
from lemon_tpu_torch.data.labels import LABEL_SETS
from lemon_tpu_torch.knn.index import ExactKnnIndex, train_split_exclusion
from lemon_tpu_torch.models.encoder import ClipEncoder
from lemon_tpu_torch.models.registry import checkpoint_path, create_encoder
from lemon_tpu_torch.scoring.lemon import COMPONENTS, NeighborLogs, calc_scores, unpack_hparams
from lemon_tpu_torch.scoring.metrics import eval_metrics
from lemon_tpu_torch.scoring.optimize import default_grid, maximize_metric
from lemon_tpu_torch.scoring.thresholds import optimize_f1_efficient

COMPONENT_CHUNK = 16384
FLT_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class DetectionConfig:
    """run_lemon CLI surface (run_lemon.py:34-58), as a typed config."""

    dataset: str = "cifar100"
    noise_type: str = "real"
    noise_level: float = 0.4
    dist_type: str = "cosine"  # 'cosine' | 'euclidean'
    normalize_d1: bool = False
    clip_model: str = "huggingface_clip"
    knn_k: int = 5
    batch_size: int = 128
    seed: int = 0
    data_seed: int = 0
    compr_dataset_size_limit: int = 50000
    ablation: str = "none"
    use_discrete_for_text: bool = False
    real_dataset: bool = False
    custom_cifar_prompt: Optional[str] = None
    subset_val_set: int = -1
    debug: bool = False
    skip_train: bool = False
    skip_hparam_optim: bool = False
    # every grid point under the fminbound objective (lib/metrics/utils.py:173-190)
    strict_hparam_parity: bool = False
    # framework extensions (no reference counterpart)
    synthetic_n: int = 600
    knn_tile: int = 0  # 0 = adaptive tile (knn/index.py:auto_tile)
    # kNN score precision: 'highest' = fp32 products on the CPU and six bf16
    # products on wgmma on the card (the TPU's HIGHEST), 'high' = bf16x3;
    # 'auto' is 'high' unless strict_hparam_parity (see _resolve_knn_precision)
    knn_precision: str = "auto"
    mesh_shape: Optional[Tuple[int, int]] = None  # (data, model); None = one device
    embedding_cache: Optional[str] = None
    checkpoint: Optional[str] = None
    grid: Optional[Dict] = None
    platform: str = "cuda"  # 'cuda' | 'cpu'


def _resolve_knn_precision(cfg: DetectionConfig) -> str:
    """'auto' -> 'high' (bf16x3) for non-strict runs, as the JAX package
    resolves it (lemon_tpu/detect.py:100-110); strict-parity runs always
    take 'highest': fp32 products on the CPU, six bf16 products on the card,
    as the JAX package's HIGHEST is fp32 on XLA:CPU and six bf16 passes on
    the TPU."""
    if cfg.strict_hparam_parity:
        return "highest"
    if cfg.knn_precision == "auto":
        return "high"
    if cfg.knn_precision not in ("highest", "high"):
        raise ValueError(f"knn_precision must be auto/highest/high, got {cfg.knn_precision!r}")
    return cfg.knn_precision


def prompt_fn(cfg: DetectionConfig):
    prefix = "A photo of a " if cfg.custom_cifar_prompt is None else cfg.custom_cifar_prompt
    return lambda label: prefix + label


def _is_clf(cfg: DetectionConfig) -> bool:
    return cfg.dataset in CLF_DATASETS or (cfg.dataset.startswith("synthetic") and "caption" not in cfg.dataset)


def _labels_for(cfg: DetectionConfig):
    if cfg.dataset in LABEL_SETS:
        return LABEL_SETS[cfg.dataset]
    if _is_clf(cfg):
        return LABEL_SETS["cifar10"]  # synthetic classification reuses cifar10 names
    return None


def _texts_for_split(cfg: DetectionConfig, split, label_set):
    """(noisy prompt texts, clean texts, noisy labels, actual labels)."""
    p = prompt_fn(cfg)
    if _is_clf(cfg):
        noisy, clean = split.y_noisy, split.y_clean
        noisy_texts = [p(label_set[int(i) % len(label_set)]) for i in noisy]
        clean_texts = [label_set[int(i) % len(label_set)] for i in clean]
        return noisy_texts, clean_texts, noisy, clean
    return list(split.sentence), list(split.gold_sentence), split.sentence, split.gold_sentence


def _components_cosine(img, txt, txt_tr, img_tr, dists_tr, I_n, I_m):
    """Per-example score components (lemon_tpu/detect.py:146-160): the
    pair's own distance, the distances to the neighbours' captions/images,
    and the neighbours' own pair distances."""
    d1 = 1.0 - torch.sum(img * txt, dim=1)
    dists_n = 1.0 - torch.einsum("bd,bkd->bk", txt, txt_tr[I_n])
    dists_m = 1.0 - torch.einsum("bd,bkd->bk", img, img_tr[I_m])
    return d1, dists_n, dists_m, dists_tr[I_n], dists_tr[I_m]


def _components_euclidean(img, txt, txt_tr, img_tr, dists_tr, I_n, I_m):
    d1 = torch.sum((img - txt) ** 2, dim=1)
    dists_n = torch.sum((txt[:, None, :] - txt_tr[I_n]) ** 2, dim=2)
    dists_m = torch.sum((img[:, None, :] - img_tr[I_m]) ** 2, dim=2)
    return d1, dists_n, dists_m, dists_tr[I_n], dists_tr[I_m]


def _d1_normalized(cfg: DetectionConfig, img: np.ndarray, label_embs: np.ndarray, noisy_labels) -> np.ndarray:
    """--normalize_d1: softmax over per-class distances, the noisy class's
    mass (run_lemon.py:244-248)."""
    from scipy.special import softmax

    if cfg.dist_type == "cosine":
        dists = 1.0 - img @ label_embs.T
    else:
        dists = ((img[:, None, :] - label_embs[None]) ** 2).sum(-1)
    probs = softmax(dists, axis=1)
    return probs[np.arange(len(img)), np.asarray(noisy_labels, np.int64)]


def _cache_kwargs(cfg, encoder: ClipEncoder, split, texts) -> dict:
    if cfg.embedding_cache is None:
        return {}
    return dict(cache_key=encoder.cache_key(split, texts), cache_dir=Path(cfg.embedding_cache))


# (cache_key, device) -> (img, txt) fp32 on the device, least recently used
# first; four entries hold a detection's comparison set, val and test
_DEV_EMB_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_DEV_EMB_CACHE_MAX = 4


def _device_embs(cache_key: Optional[str], img: np.ndarray, txt: np.ndarray, device: torch.device):
    """(img, txt) as fp32 tensors on ``device``, uploaded once per key and
    reused by later detections; without a key, uploaded each call.
    ``_device_embs.hits`` and ``.misses`` count lookups and uploads."""
    key = None if cache_key is None else (cache_key, str(device))
    hit = _DEV_EMB_CACHE.get(key) if key is not None else None
    if hit is not None:
        _DEV_EMB_CACHE.move_to_end(key)
        _device_embs.hits += 1
        return hit
    _device_embs.misses += 1
    hit = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in (img, txt))
    if key is not None:
        _DEV_EMB_CACHE[key] = hit
        while len(_DEV_EMB_CACHE) > _DEV_EMB_CACHE_MAX:
            _DEV_EMB_CACHE.popitem(last=False)
    return hit


_device_embs.hits = 0
_device_embs.misses = 0


def build_neighbor_logs(cfg: DetectionConfig, encoder: ClipEncoder, splits: Dict[str, object], label_set, timer: PhaseTimer,
                        mesh: Optional[Mesh] = None) -> NeighborLogs:
    """Embed everything, build the indexes, extract all score components."""
    device = encoder.device
    k = cfg.knn_k
    train = splits["train"]

    # comparison subset (<= compr_dataset_size_limit; run_lemon.py:122-127)
    n_train = len(train)
    if n_train > cfg.compr_dataset_size_limit:
        compr_ids = np.random.RandomState(cfg.seed).choice(np.arange(n_train), cfg.compr_dataset_size_limit, replace=False)
        compr = train.subset(compr_ids)
    else:
        compr_ids = np.arange(n_train)
        compr = train
    in_compr = np.zeros(n_train, bool)
    in_compr[compr_ids] = True

    compr_texts, _, _, _ = _texts_for_split(cfg, compr, label_set)
    compr_kwargs = _cache_kwargs(cfg, encoder, compr, compr_texts)
    with timer.phase("embed_compr"):
        img_tr, txt_tr = encoder.embed_split(compr, compr_texts, **compr_kwargs)

    metric = "ip" if cfg.dist_type == "cosine" else "l2"
    knn_prec = _resolve_knn_precision(cfg)
    index_img = ExactKnnIndex(metric=metric, device=device, tile=cfg.knn_tile or None, precision=knn_prec, mesh=mesh)
    index_txt = ExactKnnIndex(metric=metric, device=device, tile=cfg.knn_tile or None, precision=knn_prec, mesh=mesh)
    # one upload each (none on a warm repeat), shared by the indexes and the component gathers
    img_tr_dev, txt_tr_dev = _device_embs(compr_kwargs.get("cache_key"), img_tr, txt_tr, device)
    index_img.add(img_tr_dev)
    index_txt.add(txt_tr_dev)
    if cfg.dist_type == "cosine":
        dists_tr = 1.0 - np.sum(txt_tr * img_tr, axis=1)
    else:
        dists_tr = np.sum((txt_tr - img_tr) ** 2, axis=1)
    dists_tr_dev = torch.from_numpy(np.ascontiguousarray(dists_tr, np.float32)).to(device)
    compr_text_arr = np.asarray(compr_texts)

    label_embs = None
    if _is_clf(cfg) and cfg.normalize_d1:  # run_lemon.py:180-190
        p = prompt_fn(cfg)
        label_embs = encoder.encode_texts([p(l) for l in label_set])

    names = ["val", "test"] if cfg.debug or cfg.skip_train else ["train", "val", "test"]
    rows: List[NeighborLogs] = []
    for sname in names:
        split = splits[sname]
        noisy_texts, clean_texts, noisy_labels, actual_labels = _texts_for_split(cfg, split, label_set)
        if sname == "train" and n_train <= cfg.compr_dataset_size_limit:
            img, txt = img_tr, txt_tr  # same transform -> identical embeddings
            img_q, txt_q = img_tr_dev, txt_tr_dev
        else:
            split_kwargs = _cache_kwargs(cfg, encoder, split, noisy_texts)
            with timer.phase(f"embed_{sname}"):
                img, txt = encoder.embed_split(split, noisy_texts, **split_kwargs)
            img_q, txt_q = _device_embs(split_kwargs.get("cache_key"), img, txt, device)

        extra = 1 if sname == "train" else 0
        with timer.phase("knn_search"):
            D_n, I_n = index_img.search(img_q, k + extra)
            D_m, I_m = index_txt.search(txt_q, k + extra)
        if sname == "train":
            D_n, I_n = train_split_exclusion(D_n, I_n, None, in_compr)
            D_m, I_m = train_split_exclusion(D_m, I_m, None, in_compr)
        if cfg.use_discrete_for_text:
            # the JAX package raises under this flag (lemon_tpu/detect.py:361),
            # so padding slots (k above the comparison set) take FAISS's
            # finite padding score, -FLT_MAX ('ip'; FLT_MAX for 'l2'), in
            # place of the search's -inf. D_n stays un-negated below, so every
            # tau_1 > 0 overflows its weight; tau_1 (shared by D_n and D_m) = 0
            # is then the one finite candidate, and there exp(-0 * inf) would
            # be NaN. Without the flag both keep the -inf pad, as in JAX.
            D_n, D_m = (np.where(np.isinf(D), np.copysign(FLT_MAX, D), D).astype(D.dtype) for D in (D_n, D_m))

        with timer.phase("components"):
            fn = _components_cosine if cfg.dist_type == "cosine" else _components_euclidean
            # XLA clamps an out-of-range gather index to the last row; the
            # padding id n_valid (k > comparison rows) must do the same here
            last = len(img_tr) - 1
            parts = []
            for start in range(0, len(img), COMPONENT_CHUNK):
                sl = slice(start, start + COMPONENT_CHUNK)
                i_n = torch.from_numpy(I_n[sl].astype(np.int64)).to(device).clamp_(0, last)
                i_m = torch.from_numpy(I_m[sl].astype(np.int64)).to(device).clamp_(0, last)
                parts.append(fn(img_q[sl], txt_q[sl], txt_tr_dev, img_tr_dev, dists_tr_dev, i_n, i_m))
            d1, dists_n, dists_m, dtr_n, dtr_m = [torch.cat([p[j] for p in parts]).cpu().numpy() for j in range(5)]

        if cfg.use_discrete_for_text:
            # the padding id n_valid reads the last row, as the components
            # do (FAISS's -1, which numpy reads as the last row)
            nb_text = compr_text_arr[np.minimum(I_n, len(compr_text_arr) - 1)]
            dists_n = 1.0 - (nb_text == np.asarray(noisy_texts)[:, None]).astype(np.float64)
        if label_embs is not None:
            d1 = _d1_normalized(cfg, img, label_embs, noisy_labels)

        # QUIRK kept (lemon_tpu/detect.py:365-374): under
        # --use_discrete_for_text the reference never negates D_n
        # (run_lemon.py:266-273), while D_m is negated as usual.
        D_n_signed = -D_n if cfg.dist_type == "cosine" and not cfg.use_discrete_for_text else D_n
        D_m_signed = -D_m if cfg.dist_type == "cosine" else D_m

        clf = _is_clf(cfg)
        is_mis = (
            np.asarray(noisy_labels if clf else noisy_texts) != np.asarray(actual_labels if clf else clean_texts)
        ).astype(np.int64)
        rows.append(NeighborLogs(
            d_1=d1,
            dists_n=dists_n,
            D_n=D_n_signed,
            dists_tr_n=dtr_n,
            dists_m=dists_m,
            D_m=D_m_signed,
            dists_tr_m=dtr_m,
            is_mislabel=is_mis,
            sset=np.full(len(split), sname, object),
            idx=np.arange(len(split)),
            noisy_label=np.asarray(noisy_labels),
            actual_label=np.asarray(actual_labels),
            noisy_label_text=np.asarray(
                [label_set[int(i) % len(label_set)] for i in noisy_labels] if clf else noisy_labels, object
            ),
            actual_label_text=np.asarray(clean_texts, object),
        ))

    return NeighborLogs(**{
        f.name: np.concatenate([getattr(r, f.name) for r in rows]) if getattr(rows[0], f.name) is not None else None
        for f in dataclasses.fields(NeighborLogs)
    })


ABLATION_FORCE = {
    "none": ((), ()),
    "d1": ((), ("beta",)),
    "tau_1": (("tau_1_n", "tau_1_m"), ()),
    "tau_2": (("tau_2_n", "tau_2_m"), ()),
    "tau_1_2": (("tau_1_n", "tau_1_m", "tau_2_n", "tau_2_m"), ()),
    "beta": (("beta",), ()),
    "gamma": (("gamma",), ()),
    "d1_beta": (("beta",), ("gamma",)),
    "d1_gamma": (("gamma",), ("beta",)),
}

FIXED_ABLATIONS = {
    "only_beta": {"beta": 1, "gamma": 0, "tau_1_n": 0, "tau_2_n": 0, "tau_1_m": 0, "tau_2_m": 0},
    "only_gamma": {"beta": 0, "gamma": 1, "tau_1_n": 0, "tau_2_n": 0, "tau_1_m": 0, "tau_2_m": 0},
}


def select_and_evaluate(cfg: DetectionConfig, logs: NeighborLogs, device: torch.device, timer: PhaseTimer):
    """Hyperparameter selection + per-split evaluation (run_lemon.py:319-427).
    Returns (agg_results, dataframe)."""
    df = logs.to_dataframe()
    if "d1" in cfg.ablation:
        logs = dataclasses.replace(logs, d_1=np.zeros_like(logs.d_1))
        df["d_1"] = 0.0
    if cfg.real_dataset or cfg.skip_hparam_optim:
        return {}, df

    logs_val = logs.split("val")
    criteria = "know_val_labels"
    results: Dict[str, Dict] = {}
    if cfg.ablation in FIXED_ABLATIONS:
        results[criteria] = dict(FIXED_ABLATIONS[cfg.ablation])
    elif cfg.ablation == "multimodal_baseline":
        best_f1, best_thres = optimize_f1_efficient(logs_val.is_mislabel, logs_val.d_1, return_thres=True)
        results[criteria] = {
            "beta": 0, "gamma": 0, "tau_1_n": 0, "tau_2_n": 0, "tau_1_m": 0, "tau_2_m": 0,
            "thres": best_thres, "selected_val": best_f1,
        }
    else:
        force_zero, force_one = ABLATION_FORCE[cfg.ablation]
        best_x, best_f1, best_thres = maximize_metric(
            logs_val,
            grid=cfg.grid if cfg.grid is not None else default_grid(),
            obj_func=optimize_f1_efficient,
            force_zero=force_zero,
            force_one=force_one,
            use_device_grid=not cfg.strict_hparam_parity,
            device=device,
            timer=timer,
        )
        hp = unpack_hparams(best_x, force_zero, force_one)
        results[criteria] = {**hp, "thres": best_thres, "selected_val": best_f1}

    hp = {name: results[criteria].get(name, 0) for name in ("beta", "gamma", "tau_1_n", "tau_2_n", "tau_1_m", "tau_2_m")}
    # the reported scores from the components in float64: where the fit picks beta and gamma of opposite signs, the
    # neighbour terms (hundreds at tau near 10) cancel to scores under 1, and float32 arithmetic is off by ~4e-4
    logs64 = dataclasses.replace(logs, **{c: np.asarray(getattr(logs, c), np.float64) for c in COMPONENTS})
    scores, d_n, d_m = calc_scores(logs64, hp, return_components=True)
    df[f"{criteria}_pred_score"] = scores
    df[f"{criteria}_d_n"] = d_n
    df[f"{criteria}_d_m"] = d_m

    val_mask = logs.sset == "val"
    prevalence = logs.is_mislabel[val_mask].sum() / val_mask.sum()
    with timer.phase("eval_metrics"):
        thress = eval_metrics(logs.is_mislabel[val_mask], scores[val_mask], prevalence=prevalence)
        fix = {k: thress[k] for k in ("F1_optimal_thres", "F1_prev_thres", "F1_heuristic_thres")}
        for sname in np.unique(logs.sset):
            mask = logs.sset == sname
            results[criteria][sname] = eval_metrics(logs.is_mislabel[mask], scores[mask], prevalence=prevalence, fix_thress=fix)
    return results, df


# one entry: the encoder of the last detection
_ENCODER_CACHE: Dict[tuple, ClipEncoder] = {}


def _cached_encoder(cfg: DetectionConfig, device: torch.device, mesh: Optional[Mesh] = None) -> ClipEncoder:
    """The encoder for ``cfg`` on ``device``, built once for the key (model,
    seed, batch size, checkpoint as given and as the environment resolves
    it, BiomedCLIP's vocabulary, precision mode, mesh, device). A cached
    ``int8_static`` encoder keeps its calibrated scales, the JAX contract.
    ``_cached_encoder.builds`` counts the builds."""
    precision = default_precision()
    key = (cfg.clip_model, cfg.seed, cfg.batch_size, cfg.checkpoint, str(checkpoint_path(cfg.clip_model)),
           os.environ.get("LEMON_TPU_BIOMED_VOCAB"), precision, mesh, str(device))
    encoder = _ENCODER_CACHE.get(key)
    if encoder is None:
        _ENCODER_CACHE.clear()  # free the previous model before building the next
        encoder = _ENCODER_CACHE[key] = create_encoder(
            cfg.clip_model, device, seed=cfg.seed, batch_size=cfg.batch_size, checkpoint=cfg.checkpoint,
            precision=precision, mesh=mesh,
        )
        _cached_encoder.builds += 1
    else:
        print(f"[lemon_tpu_torch] encoder cache hit ({cfg.clip_model}); precision: {encoder.model.precision}")
    return encoder


_cached_encoder.builds = 0


def run_detection(cfg: DetectionConfig, out_dir: Optional[Path] = None) -> Dict:
    """The full pipeline; writes the reference's output files when
    ``out_dir`` is given (res.pkl, {criteria}_scores.csv; rank 0 only under
    a mesh)."""
    if cfg.real_dataset and cfg.noise_level != 0.0:
        raise ValueError("--real_dataset needs --noise_level 0")
    mesh = get_mesh(*cfg.mesh_shape, platform=cfg.platform) if cfg.mesh_shape is not None else None
    device = mesh.device if mesh is not None else resolve_device(cfg.platform)
    timer = PhaseTimer(device)

    with timer.phase("load_data"):
        splits = dict(zip(("train", "val", "test"), get_dataset(
            cfg.dataset, cfg.data_seed, noise_level=cfg.noise_level, noise_type=cfg.noise_type,
            synthetic_n=cfg.synthetic_n,
        )))
    if cfg.subset_val_set > 0:
        rng = np.random.default_rng(cfg.data_seed)
        pick = rng.choice(np.arange(len(splits["val"])), min(cfg.subset_val_set, len(splits["val"])), replace=False)
        splits["val"] = splits["val"].subset(pick)

    label_set = _labels_for(cfg)
    with timer.phase("load_model"):
        encoder = _cached_encoder(cfg, device, mesh)

    t0 = time.time()
    logs = build_neighbor_logs(cfg, encoder, splits, label_set, timer, mesh)
    agg, df = select_and_evaluate(cfg, logs, device, timer)
    total = time.time() - t0
    n = len(logs)
    timing = timer.as_dict()
    print(f"Finished {n} samples in {total:.2f} seconds; avg of {total / n:.5f}s per sample")
    print(f"Phase timing: {timing}")

    res = {"df": df} if not agg else {"df": df, "agg_results": agg}
    if out_dir is not None and (mesh is None or mesh.lead):
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "res.pkl", "wb") as f:
            pickle.dump(res, f)
        for criteria in agg:
            cols = df[["sset", "idx", "actual_label", "noisy_label", "is_mislabel", f"{criteria}_pred_score"]]
            cols.rename(columns={f"{criteria}_pred_score": "pred_score"}).to_csv(out_dir / f"{criteria}_scores.csv")
        if cfg.skip_hparam_optim:
            (out_dir / "need_hparam_optim").write_text("need_hparam_optim")
    # in-memory extra only: res.pkl keeps the reference's {'df', 'agg_results'}
    return {**res, "phase_timing": timing}
