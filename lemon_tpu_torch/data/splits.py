"""Deterministic dataset splits (port of lemon_tpu/data/splits.py).

The JAX package calls sklearn's ``train_test_split`` so that a ``data_seed``
reproduces the reference's index partitions (80/10/10 at
lib/datasets/utils.py:408-417; 80/20 at :389; stratified 50/25/25 at
:325-347). The GPU machine has no scikit-learn, so this module re-states
both of sklearn's shuffle splits in numpy: :func:`train_test_split` the
unstratified one (``ceil(test_size * n)`` test rows taken from the front of
``RandomState(seed).permutation(n)``, the train rows after them), and
:func:`stratified_train_test_split` the ``stratify=`` one
(``StratifiedShuffleSplit``). tests/test_torch_detect.py and
tests/test_torch_data.py hold them to sklearn index for index.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def train_test_split(arr: np.ndarray, test_size: float, random_state: int) -> Tuple[np.ndarray, np.ndarray]:
    n = len(arr)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_test == 0 or n_train == 0:
        raise ValueError(f"test_size={test_size} leaves an empty split of {n} rows")
    perm = np.random.RandomState(random_state).permutation(n)
    return arr[perm[n_test:]], arr[perm[:n_test]]


def split_80_10_10(n: int, data_seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    train_idx, rest = train_test_split(np.arange(n), test_size=0.2, random_state=data_seed)
    val_idx, test_idx = train_test_split(rest, test_size=0.5, random_state=data_seed)
    return train_idx, val_idx, test_idx


def split_80_20(n: int, data_seed: int) -> Tuple[np.ndarray, np.ndarray]:
    return train_test_split(np.arange(n), test_size=0.2, random_state=data_seed)


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """Per-class counts of ``n_draws`` rows, the approximate mode of the
    multivariate hypergeometric (sklearn.utils.extmath._approximate_mode):
    the floors of the proportional shares, then one more row for each class
    in descending order of remainder, ties broken by ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need = int(n_draws - floored.sum())
    if need > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add = min(len(inds), need)
            floored[rng.choice(inds, size=add, replace=False)] += 1
            need -= add
            if need == 0:
                break
    return floored.astype(int)


def stratified_train_test_split(arr: np.ndarray, train_size: float, random_state: int,
                                stratify: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``sklearn.model_selection.train_test_split(arr, train_size=...,
    random_state=..., stratify=...)``: ``floor(train_size * n)`` train rows,
    the rest test, each class split in proportion. The draws from one
    ``RandomState``, in sklearn's order: the train counts, the test counts,
    one permutation per class (classes in ``np.unique`` order), then a
    permutation of each side."""
    n = len(arr)
    if not 0 < train_size < 1:
        raise ValueError(f"train_size must lie in (0, 1), got {train_size}")
    n_train = math.floor(train_size * n)
    n_test = n - n_train
    if n_train == 0 or n_test == 0:
        raise ValueError(f"train_size={train_size} leaves an empty split of {n} rows")
    classes, y_indices, class_counts = np.unique(np.asarray(stratify), return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(f"the least populated classes have only 1 member: {classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"{n_train} train and {n_test} test rows cannot hold each of {len(classes)} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        members = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(members[: n_i[i]])
        test.extend(members[n_i[i] : n_i[i] + t_i[i]])
    return arr[rng.permutation(train)], arr[rng.permutation(test)]


def stratified_50_25_25(strata: np.ndarray, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """50/25/25 stratified on a class column (``is_clean`` for mini-ImageNet
    and Stanford Cars; lib/datasets/utils.py:332-338): 75% train+val against
    25% test, then 0.5 / 0.75 of the first part for train."""
    strata = np.asarray(strata)
    idx = np.arange(len(strata))
    train_val, test = stratified_train_test_split(idx, 0.75, seed, strata)
    train, val = stratified_train_test_split(train_val, 0.5 / 0.75, seed, strata[train_val])
    return train, val, test
