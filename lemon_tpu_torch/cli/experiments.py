"""Experiment grids for the sweep orchestrator (port of
lemon_tpu/cli/experiments.py: the same grids, run by the port's CLIs).

Mirrors experiments.py of the reference: each experiment is a class with a
``fname`` (the CLI module to run) and ``get_hparams()`` enumerating the
grid. ``combinations`` supports per-sub-experiment dict values: a dict
value splits the grid into one sub-grid per key, with dict-valued settings
resolved per sub-grid (experiments.py:10-34).

The headline grids are ported with the paper's axes (k in {1..50}, three
data seeds, cosine/euclidean, the ablation list); dataset lists include the
'synthetic*' stand-ins so sweeps are runnable without the private corpora.
"""

from __future__ import annotations

from itertools import product
from typing import Dict, List


def combinations(grid: Dict) -> List[Dict]:
    """Cartesian product with dict-valued entries expanded per sub-key."""
    sub_keys = None
    for v in grid.values():
        if isinstance(v, dict):
            sub_keys = list(v.keys())
            break
    if sub_keys is None:
        return [dict(zip(grid.keys(), vals)) for vals in product(*grid.values())]
    out = []
    for sub in sub_keys:
        resolved = {k: (v[sub] if isinstance(v, dict) else v) for k, v in grid.items()}
        out.extend(combinations(resolved))
    return out


DATA_SEEDS = [0, 1, 2]
KNN_KS = [1, 2, 5, 10, 15, 20, 30, 50]
ABLATIONS = ["none", "tau_1", "tau_2", "tau_1_2", "beta", "gamma", "multimodal_baseline", "d1", "only_beta", "only_gamma"]


class Experiment:
    fname = "lemon_tpu_torch.cli.run_lemon"

    @classmethod
    def get_hparams(cls) -> List[Dict]:
        return combinations(cls.grid())

    @classmethod
    def grid(cls) -> Dict:
        raise NotImplementedError

    @classmethod
    def get_script_name(cls) -> str:
        return cls.fname


class lemon_all(Experiment):
    """Main-table grid (experiments.py:49-98): classification + captioning
    datasets, full k/dist sweep, 3 data seeds."""

    @classmethod
    def grid(cls):
        return {
            # dict-valued entries share sub-experiment keys; combinations()
            # resolves each sub-experiment into its own cartesian product
            "dataset": {
                "clf": ["cifar10", "cifar100"],
                "caption": ["mscoco", "flickr30k", "mmimdb"],
            },
            "noise_type": {
                "clf": ["real", "symmetric", "asymmetric"],
                "caption": ["random", "cat"],
            },
            "noise_level": [0.4],
            "knn_k": KNN_KS,
            "dist_type": ["cosine", "euclidean"],
            "data_seed": DATA_SEEDS,
        }


class lemon_caption_real(Experiment):
    @classmethod
    def grid(cls):
        return {
            "dataset": ["mimiccxr_caption", "cc3m"],
            "noise_type": ["random"],
            "noise_level": [0.0],
            "real_dataset": [True],
            "knn_k": KNN_KS,
            "data_seed": DATA_SEEDS,
        }


class lemon_caption_vary_noise(Experiment):
    @classmethod
    def grid(cls):
        return {
            "dataset": ["mscoco"],
            "noise_type": ["cat"],
            "noise_level": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9],
            "knn_k": [5, 10, 20],
            "data_seed": DATA_SEEDS,
        }


class lemon_caption_ablations(Experiment):
    @classmethod
    def grid(cls):
        return {
            "dataset": ["mscoco", "flickr30k"],
            "noise_type": ["cat"],
            "noise_level": [0.4],
            "knn_k": [10],
            "ablation": ABLATIONS,
            "data_seed": DATA_SEEDS,
        }


class lemon_cifar_ablations(Experiment):
    @classmethod
    def grid(cls):
        return {
            "dataset": ["cifar10", "cifar100"],
            "noise_type": ["symmetric"],
            "noise_level": [0.4],
            "knn_k": [10],
            "ablation": ABLATIONS,
            "data_seed": DATA_SEEDS,
        }


class vary_val_set(Experiment):
    """Validation-size sensitivity (experiments.py vary_val_set)."""

    @classmethod
    def grid(cls):
        return {
            "dataset": ["mscoco"],
            "noise_type": ["cat"],
            "noise_level": [0.4],
            "knn_k": [10],
            "subset_val_set": [10, 30, 100, 300, 1000, 3000],
            "data_seed": DATA_SEEDS,
        }


class discrepancy_baseline(Experiment):
    fname = "lemon_tpu_torch.cli.run_baseline"

    @classmethod
    def grid(cls):
        return {
            "baseline": ["discrepancy"],
            "method": ["dis_y", "dis_x", "div_y", "div_x"],
            "dataset": ["mscoco", "flickr30k"],
            "noise_type": ["cat"],
            "noise_level": [0.4],
            "knn_k": [5, 10, 20],
            "data_seed": DATA_SEEDS,
        }


class synthetic_smoke(Experiment):
    """Framework-only: a tiny sweep runnable anywhere (no datasets)."""

    @classmethod
    def grid(cls):
        return {
            "dataset": ["synthetic_caption"],
            "noise_type": ["random"],
            "noise_level": [0.2, 0.4],
            "knn_k": [3, 5],
            "clip_model": ["tiny"],
            "data_seed": [0],
            "synthetic_n": [200],
        }


class cc3m_clip_scratch(Experiment):
    fname = "lemon_tpu_torch.cli.train_clip"

    @classmethod
    def grid(cls):
        return {
            "dataset": ["cc3m"],
            "context_length": [77],
            "batch_size": [256],
            "lr": [5e-4],
            "optimizer": ["adamw"],
            "data_seed": DATA_SEEDS[:1],
        }


class lemon_caption_mimic_clip_scratch(Experiment):
    """MIMIC captions scored with the from-scratch MIMIC CLIP encoders
    (experiments.py lemon_caption_mimic_clip_scratch)."""

    @classmethod
    def grid(cls):
        return {
            "dataset": ["mimiccxr_caption"],
            "noise_type": ["random", "cat"],
            "noise_level": [0.4],
            "clip_model": ["mimic_clip_from_scratch_random", "mimic_clip_from_scratch_cat"],
            "knn_k": [5, 10, 20],
            "data_seed": DATA_SEEDS,
        }


class lemon_cc3m_filter_using_scratch(Experiment):
    """Score CC3M with the from-scratch CC3M CLIP for the data-curation
    loop (experiments.py lemon_cc3m_filter_using_scratch)."""

    @classmethod
    def grid(cls):
        return {
            "dataset": ["cc3m"],
            "noise_type": ["random"],
            "noise_level": [0.0],
            "real_dataset": [True],
            "clip_model": ["cc3m_clip_from_scratch"],
            "knn_k": [10],
            "data_seed": DATA_SEEDS[:1],
        }


class cc3m_clip_scratch_filtered_from_scratch(Experiment):
    """Retrain CC3M CLIP on LEMoN-filtered data (experiments.py
    cc3m_clip_scratch_filtered_from_scratch); point cc3m_filtering at a
    completed lemon_cc3m_filter_using_scratch run."""

    fname = "lemon_tpu_torch.cli.train_clip"

    @classmethod
    def grid(cls):
        return {
            "dataset": ["cc3m"],
            "context_length": [77],
            "batch_size": [256],
            "lr": [5e-4],
            "optimizer": ["adamw"],
            "cc3m_filtering_n": [100000, 500000],
            "data_seed": DATA_SEEDS[:1],
        }


def get_experiment(name: str):
    exp = globals().get(name)
    if exp is None or not (isinstance(exp, type) and issubclass(exp, Experiment)):
        options = [k for k, v in globals().items() if isinstance(v, type) and issubclass(v, Experiment) and v is not Experiment]
        raise KeyError(f"unknown experiment '{name}'; options: {sorted(options)}")
    return exp
