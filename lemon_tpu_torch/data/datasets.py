"""Dataset registry and array-backed splits (port of lemon_tpu/data/datasets.py).

Splits are struct-of-arrays (uint8 images or image paths plus label/caption
arrays); batches are fixed-shape index arrays with the last batch padded.
Roots resolve through ``LEMON_TPU_DATA_ROOT`` (default ``./data``) and
``LEMON_TPU_PATH_<NAME>``, the same variables the JAX package reads, so both
packages find the same files.

Names: the synthetic generators (``synthetic``, ``synthetic_caption``, whose
images render at the first pixel read, and ``synthetic_caption_stream``,
whose images are ``.npy`` shards under ``<data_root>/synthetic_stream``),
CIFAR-10/100 (+ ``_full``) from the standard python pickles, the captioning
datasets read through their ``multimodal_mislabel_split.pkl``, and
``mini_imagenet``/``stanford_cars`` through their
``multimodal_mislabel_split.csv``, and ``cifar10c`` (CIFAR-10's train and
val splits with the corrupted test set of CIFAR-10-C, :func:`load_cifar10c`).
An image source is an array or a store of
:mod:`lemon_tpu_torch.data.streaming`; ``subset`` keeps a store lazy.
Caption clustering is :mod:`lemon_tpu_torch.data.clustering`.
"""

from __future__ import annotations

import os
import pickle
import queue
import tarfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from lemon_tpu_torch.core import profiling
from lemon_tpu_torch.data.labels import num_classes
from lemon_tpu_torch.data.noise import (
    apply_caption_noise,
    caption_noise_by_matching,
    caption_noise_random,
    flip_labels,
)
from lemon_tpu_torch.data.splits import split_80_10_10, split_80_20, stratified_50_25_25
from lemon_tpu_torch.data.streaming import LazyRenderUint8Store, ShardedUint8Store, ShardWriter, subset_images

CLF_DATASETS = ("cifar10", "cifar100", "cifar10_full", "cifar100_full", "mini_imagenet", "stanford_cars")
CAPTION_DATASETS = ("mscoco", "flickr30k", "mimiccxr_caption", "mmimdb", "cc3m")


def data_root() -> Path:
    return Path(os.environ.get("LEMON_TPU_DATA_ROOT", "./data"))


def dataset_path(name: str) -> Path:
    override = os.environ.get(f"LEMON_TPU_PATH_{name.upper()}")
    return Path(override) if override else data_root() / name


@dataclass
class ClassificationSplit:
    """(images, y_clean, y_noisy) — lib/datasets/dataloader.py:16-30."""

    y_clean: np.ndarray
    y_noisy: np.ndarray
    images: Optional[np.ndarray] = None  # (N, H, W, 3) uint8, or a store
    paths: Optional[List[str]] = None

    def __len__(self) -> int:
        return len(self.y_noisy)

    @property
    def is_mislabel(self) -> np.ndarray:
        return (self.y_clean != self.y_noisy).astype(np.int64)

    def subset(self, idx: np.ndarray) -> "ClassificationSplit":
        return ClassificationSplit(
            y_clean=self.y_clean[idx],
            y_noisy=self.y_noisy[idx],
            images=subset_images(self.images, idx),
            paths=None if self.paths is None else [self.paths[i] for i in idx],
        )


@dataclass
class CaptioningSplit:
    """(image, gold_sentence, noisy_sentence) rows — dataloader.py:167-198."""

    sentence: np.ndarray  # noisy captions
    gold_sentence: np.ndarray
    images: Optional[np.ndarray] = None
    paths: Optional[List[str]] = None

    def __len__(self) -> int:
        return len(self.sentence)

    @property
    def is_mislabel(self) -> np.ndarray:
        return (self.sentence != self.gold_sentence).astype(np.int64)

    def subset(self, idx: np.ndarray) -> "CaptioningSplit":
        return CaptioningSplit(
            sentence=self.sentence[idx],
            gold_sentence=self.gold_sentence[idx],
            images=subset_images(self.images, idx),
            paths=None if self.paths is None else [self.paths[i] for i in idx],
        )


Split = ClassificationSplit | CaptioningSplit


def iter_batches(split: Split, batch_size: int) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (index_array, n_valid) per batch; the final batch is padded by
    repeating its last index so every batch has the same shape."""
    n = len(split)
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        n_valid = len(idx)
        if n_valid < batch_size:
            idx = np.concatenate([idx, np.full(batch_size - n_valid, idx[-1])])
        yield idx, n_valid


def load_images(split: Split, idx: np.ndarray, decode_size: Optional[int] = None, stack: bool = True):
    """A batch of uint8 HWC images. Paths are decoded on the host; a batch
    of mixed sizes is unified per image with the reference's PIL
    Resize + CenterCrop to ``decode_size`` (lemon_tpu/data/datasets.py:136-177).
    ``stack=False`` returns a list of the images at their own sizes, for a
    caller that crops or resizes each one itself (the trainer's crops)."""
    if split.images is not None:
        batch = split.images[idx]
        return batch if stack else list(batch)
    from PIL import Image

    out = []
    for i in idx:
        with Image.open(split.paths[i]) as img:
            out.append(np.asarray(img.convert("RGB"), np.uint8))
    if not stack:
        return out
    if len({a.shape for a in out}) > 1:
        if decode_size is None:
            raise ValueError("a batch of mixed image sizes needs decode_size (the model's input resolution)")
        from lemon_tpu_torch.ops.image import pil_resize_crop_u8

        out = [pil_resize_crop_u8(a, decode_size) for a in out]
    return np.stack(out)


class Prefetcher:
    """Run ``fn(item)`` for each item on a background thread, keeping up to
    ``depth`` results ready (lemon_tpu/data/native_loader.py:122-167).
    Exceptions surface on the consuming side at the failing position. The
    thread is named ``prefetch``; its spans hang under the span open where
    the prefetcher was built, and the consumer's waits are
    ``prefetch.wait`` spans."""

    _DONE = object()

    def __init__(self, items: Iterable, fn: Callable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        context = profiling.handoff()

        def work():
            profiling.adopt(context)
            try:
                for it in items:
                    if self._stop.is_set():
                        return
                    self._q.put(fn(it))
            except BaseException as e:  # surfaced on the consumer side
                self._q.put(e)
                return
            self._q.put(self._DONE)

        self._t = threading.Thread(target=work, daemon=True, name="prefetch")
        self._t.start()

    def __iter__(self) -> Iterator:
        while True:
            with profiling.span("prefetch.wait"):
                item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self) -> None:
        self._stop.set()
        try:  # free one slot so a blocked worker sees the stop flag
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=5)


def _load_cifar_pickles(name: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    root = data_root()
    if name.startswith("cifar10_") or name == "cifar10":
        base = root / "cifar-10-batches-py"
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        label_key = b"labels"
        archive = "cifar-10-python.tar.gz"
    else:
        base = root / "cifar-100-python"
        files = ["train"] if train else ["test"]
        label_key = b"fine_labels"
        archive = "cifar-100-python.tar.gz"
    if not base.exists():
        tgz = base.with_suffix(".tar.gz")
        tgz = tgz if tgz.exists() else root / archive
        if tgz.exists():
            with tarfile.open(tgz) as tf:
                tf.extractall(root)
    if not base.exists():
        raise FileNotFoundError(f"CIFAR data not found under {base}; place the standard python pickle archive there")
    xs, ys = [], []
    for fname in files:
        with open(base / fname, "rb") as f:
            blob = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(blob[b"data"], np.uint8))
        ys.append(np.asarray(blob[label_key], np.int64))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # -> NHWC
    return np.ascontiguousarray(x), np.concatenate(ys)


def _flip(name, noise_type, noise_level, y, data_seed, n_classes=None):
    return np.asarray(flip_labels(
        name, noise_type, noise_level, y, data_seed,
        n_classes=n_classes if n_classes is not None else num_classes(name),
        data_root=str(data_root()),
    ))


def load_cifar10c(corruption_name: str, severity: int | None = None) -> ClassificationSplit:
    """CIFAR-10-C corrupted test set (Hendrycks & Dietterich release):
    ``CIFAR-10-C/{corruption}.npy`` stacks 10k test images at severities
    1-5 (50k rows, NHWC uint8) with a shared ``labels.npy``
    (lemon_tpu/data/datasets.py:217-240). Labels are clean
    (y_clean == y_noisy): this is an eval-only split."""
    for base in (data_root() / "CIFAR-10-C", data_root() / "cifar10c"):
        if base.exists():
            break
    else:
        raise FileNotFoundError(
            f"CIFAR-10-C not found under {data_root()}; extract the "
            "https://zenodo.org/record/2535967 archive there."
        )
    images = np.load(base / f"{corruption_name}.npy")
    labels = np.load(base / "labels.npy").astype(np.int64)
    if images.ndim != 4 or len(images) != len(labels):
        raise ValueError(f"{base}: {images.shape[0]} images of shape {images.shape[1:]} for {len(labels)} labels")
    if severity is not None:
        if not 1 <= severity <= 5:
            raise ValueError(f"severity must be 1-5, got {severity}")
        per = len(images) // 5
        sl = slice((severity - 1) * per, severity * per)
        images, labels = images[sl], labels[sl]
    return ClassificationSplit(y_clean=labels, y_noisy=labels.copy(), images=np.ascontiguousarray(images))


def _classification_triplet(images, y, noisy, tr, va, te):
    mk = lambda idx: ClassificationSplit(y_clean=y[idx], y_noisy=noisy[idx], images=images[idx])
    return mk(tr), mk(va), mk(te)


def synthetic_classification(n=600, n_classes=10, image_size=32, data_seed=0, noise_level=0.4, noise_type="symmetric"):
    """Class-conditional template images + transition-matrix noise
    (lemon_tpu/data/datasets.py:255-287)."""
    rng = np.random.default_rng(data_seed)
    y = rng.integers(0, n_classes, n)
    yy, xx = np.mgrid[0:image_size, 0:image_size]
    templates = np.stack([
        np.stack([
            127 + 120 * np.sin(2 * np.pi * ((c + 1) * xx / image_size + (ch + 1) * yy / image_size) / 2)
            for ch in range(3)
        ], axis=-1)
        for c in range(n_classes)
    ])
    images = templates[y] + rng.normal(0, 12, (n, image_size, image_size, 3))
    images = np.clip(images, 0, 255).astype(np.uint8)
    noisy = _flip("synthetic", noise_type, noise_level, y, data_seed, n_classes=n_classes)
    tr, va, te = split_80_10_10(n, data_seed)
    return _classification_triplet(images, y, noisy, tr, va, te)


def synthetic_captioning(n=400, image_size=32, data_seed=0, noise_level=0.4, flip_type="random", backing="ram"):
    """Synthetic image-caption pairs with caption-swap noise; the pixels and
    captions of lemon_tpu/data/datasets.py:290-383.

    ``backing="ram"``: a :class:`LazyRenderUint8Store` with the JAX
    package's token, rendered at the first pixel read (a warm run whose
    embeddings are cached reads none). ``backing="memmap"``: ``.npy`` shards
    of 8192 rows cached under ``<data_root>/synthetic_stream`` (the JAX
    package's directory and format, so either package reads the other's),
    written in chunks on the first call; host memory stays bounded.
    """
    import pandas as pd

    if backing not in ("ram", "memmap"):
        raise ValueError(f"backing must be 'ram' or 'memmap', got {backing!r}")
    rng = np.random.default_rng(data_seed)
    n_concepts = 12
    concept = rng.integers(0, n_concepts, n)
    adjectives = ["small", "large", "red", "blue", "striped", "old"]
    nouns = ["bird", "car", "house", "tree", "dog", "boat", "chair", "flower", "train", "cat", "plane", "horse"]
    sentences = np.array(
        [f"a {adjectives[rng.integers(0, len(adjectives))]} {nouns[c]} in a scene" for c in concept], object
    )
    yy, xx = np.mgrid[0:image_size, 0:image_size]
    templates = np.stack([
        np.stack([127 + 120 * np.cos(2 * np.pi * ((c + 2) * xx + (ch + 1) * yy) / image_size / 3) for ch in range(3)], -1)
        for c in range(n_concepts)
    ])

    def gen_chunk(lo: int, hi: int) -> np.ndarray:
        # per-chunk RNG keyed on the chunk start: the same pixels for any
        # chunking, so the two backings agree bit for bit
        crng = np.random.default_rng((data_seed, lo))
        noise = crng.normal(0, 10, (hi - lo, image_size, image_size, 3))
        return np.clip(templates[concept[lo:hi]] + noise, 0, 255).astype(np.uint8)

    chunk = 8192
    if backing == "memmap":
        cache = data_root() / "synthetic_stream" / f"cap_n{n}_s{image_size}_seed{data_seed}"
        if (cache / "manifest.json").exists():
            images = ShardedUint8Store.open(cache)
        else:
            t0 = time.perf_counter()
            writer = ShardWriter(cache, shard_rows=chunk)
            for lo in range(0, n, chunk):
                writer.append(gen_chunk(lo, min(lo + chunk, n)))
            images = writer.finish()
            print(f"synthetic_caption_stream: wrote {n} rows to {cache} in {time.perf_counter() - t0:.2f} s", flush=True)
        if len(images) != n:
            raise ValueError(f"{cache} holds {len(images)} rows, expected {n}")
    else:
        images = LazyRenderUint8Store(
            lambda: np.concatenate([gen_chunk(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]),
            n,
            (image_size, image_size, 3),
            token=f"synthetic_captioning:v1:n={n}:size={image_size}:seed={data_seed}",
        )
    df = pd.DataFrame({"sentence": sentences, "cat_labels": [[int(c)] for c in concept], "nouns_int": [[int(c)] for c in concept]})
    tr, va, te = split_80_10_10(n, data_seed)
    out = []
    for idx in (tr, va, te):
        sub = df.iloc[idx].reset_index(drop=True)
        if flip_type == "random":
            swaps = caption_noise_random(len(sub), noise_level, data_seed)
        else:
            col = "nouns_int" if flip_type == "noun" else "cat_labels"
            swaps = caption_noise_by_matching(sub[col].values, noise_level, data_seed)
        noised = apply_caption_noise(sub, swaps)
        out.append(CaptioningSplit(
            sentence=noised["sentence"].to_numpy(object),
            gold_sentence=noised["gold_sentence"].to_numpy(object),
            images=subset_images(images, idx),
        ))
    return tuple(out)


def load_captioning_dataset(name: str, data_seed: int, percent_flips: float, flip_type: str):
    """Metadata-driven captioning datasets (lib/datasets/utils.py:275-323):
    one caption per image, noun/category tags, caption-swap noise per split."""
    import pandas as pd

    if not 0 <= percent_flips <= 1:
        raise ValueError(f"noise_level must be in [0, 1], got {percent_flips}")
    root = dataset_path(name)
    df = pd.read_pickle(root / "multimodal_mislabel_split.pkl")
    if "restval" in set(df["split"]):
        df.loc[df.split == "restval", "split"] = "train"
    if name == "mscoco":
        df["path"] = [str(root / fp / fn) for fp, fn in zip(df["filepath"], df["filename"])]
    elif name == "flickr30k":
        df["path"] = [str(root / "flickr30k_images" / fn) for fn in df["filename"]]
    elif name == "mimiccxr_caption":
        df["path"] = [
            str(root / "files" / f"p{str(s)[:2]}" / f"p{s}" / f"s{st}" / f"{d}.jpg")
            for s, st, d in zip(df["subject_id"], df["study_id"], df["dicom_id"])
        ]
        df = df[df.sentence.str.len() > 0]
    elif "path" not in df:
        df["path"] = [str(root / fn) for fn in df["filename"]]

    out = []
    for split in ("train", "val", "test"):
        sub = df.query(f'split == "{split}"')
        if flip_type == "random":
            swaps = caption_noise_random(len(sub), percent_flips, data_seed)
        elif flip_type == "noun":
            swaps = caption_noise_by_matching(sub["nouns_int"].values, percent_flips, data_seed)
        elif flip_type == "cat":
            swaps = caption_noise_by_matching(sub["cat_labels"].values, percent_flips, data_seed)
        else:
            raise NotImplementedError(flip_type)
        noised = apply_caption_noise(sub, swaps)
        out.append(CaptioningSplit(
            sentence=noised["sentence"].to_numpy(object),
            gold_sentence=noised["gold_sentence"].to_numpy(object),
            paths=list(noised["path"].values),
        ))
    return tuple(out)


def load_large_scale_dataset(name: str, seed: int):
    """mini_imagenet / stanford_cars with real web noise
    (lemon_tpu/data/datasets.py:446-467; lib/datasets/utils.py:325-347):
    ``multimodal_mislabel_split.csv`` (filename or path, label, is_clean),
    split 50/25/25 stratified on ``is_clean``; the clean label of a noisy
    row is unknown and encoded as ``label - 1``."""
    import pandas as pd

    root = dataset_path(name)
    df = pd.read_csv(root / "multimodal_mislabel_split.csv")
    if "path" not in df:
        df["path"] = [str(root / fn) for fn in df["filename"]]
    out = []
    for idx in stratified_50_25_25(df["is_clean"].to_numpy(), seed):
        sub = df.iloc[np.sort(idx)]
        noisy = sub["label"].to_numpy(np.int64)
        clean = np.where(sub["is_clean"].to_numpy(bool), noisy, noisy - 1)
        out.append(ClassificationSplit(y_clean=clean, y_noisy=noisy, paths=list(sub["path"].values)))
    return tuple(out)


def get_dataset(name: str, data_seed: int, noise_level: float = 0.4, noise_type: str = "real", synthetic_n: int = 600,
                corruption_name: str | None = None):
    """(train, val, test) splits (lib/datasets/utils.py:350-430).
    ``corruption_name`` names the CIFAR-10-C test set of ``cifar10c``."""
    if name.startswith("synthetic_caption"):
        return synthetic_captioning(
            synthetic_n, data_seed=data_seed, noise_level=noise_level,
            flip_type=noise_type if noise_type in ("random", "noun", "cat") else "random",
            backing="memmap" if name.endswith("_stream") else "ram",
        )
    if name == "synthetic":
        return synthetic_classification(
            synthetic_n, data_seed=data_seed, noise_level=noise_level,
            noise_type=noise_type if noise_type in ("symmetric", "asymmetric") else "symmetric",
        )
    if name == "cifar10c":
        # cifar10 train/val with the requested noise, and the corrupted test
        # set (the robustness evaluation, lemon_tpu/data/datasets.py:494-503)
        if not corruption_name:
            raise ValueError("cifar10c needs corruption_name")
        images, y = _load_cifar_pickles("cifar10", train=True)
        noisy = _flip("cifar10", noise_type, noise_level, y, data_seed)
        tr, va, _ = split_80_10_10(len(y), data_seed)
        train, val, _ = _classification_triplet(images, y, noisy, tr, va, tr[:0])
        return train, val, load_cifar10c(corruption_name)
    if name in ("cifar10", "cifar100"):
        images, y = _load_cifar_pickles(name, train=True)
        noisy = _flip(name, noise_type, noise_level, y, data_seed)
        tr, va, te = split_80_10_10(len(y), data_seed)
        return _classification_triplet(images, y, noisy, tr, va, te)
    if name in ("cifar10_full", "cifar100_full"):
        img_tr, y_tr = _load_cifar_pickles(name, train=True)
        img_te, y_te = _load_cifar_pickles(name, train=False)
        noisy_tr = _flip(name, noise_type, noise_level, y_tr, data_seed)
        noisy_te = _flip(name, noise_type, noise_level, y_te, data_seed)
        tr, va = split_80_20(len(y_tr), data_seed)
        return (
            ClassificationSplit(y_clean=y_tr[tr], y_noisy=noisy_tr[tr], images=img_tr[tr]),
            ClassificationSplit(y_clean=y_tr[va], y_noisy=noisy_tr[va], images=img_tr[va]),
            ClassificationSplit(y_clean=y_te, y_noisy=noisy_te, images=img_te),
        )
    if name in CAPTION_DATASETS:
        return load_captioning_dataset(name, data_seed, noise_level, noise_type)
    if name in ("mini_imagenet", "stanford_cars"):
        if noise_type != "real":
            raise ValueError(f"{name} carries real web noise: --noise_type must be 'real', got {noise_type!r}")
        return load_large_scale_dataset(name, data_seed)
    raise NotImplementedError(f"dataset '{name}' is not ported to lemon_tpu_torch yet")
