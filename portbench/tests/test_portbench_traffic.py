"""The one traffic generator: a detection's dataset is a function of (seed,
detection index), differs between indexes, and keeps its sizes (class
counts, caption lengths, flipped rows) from seed to seed."""

import numpy as np
import pytest
import torch

from portbench.traffic import SPLITS, PoolView, Traffic, load_mix
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
BIG_SEED = 2**31 + 987654321


def _fingerprint(det):
    out = []
    for name in SPLITS:
        s = det.splits[name]
        out += [np.asarray(s.images[np.arange(len(s))]).tobytes(), s.is_mislabel.tobytes()]
        out += [repr(s.texts), repr(s.clean_texts), repr(None if s.y_noisy is None else s.y_noisy.tolist())]
    return out


@pytest.mark.parametrize("kind", ["labels", "captions"])
def test_a_seed_and_index_give_the_same_dataset(kind):
    mix = tiny_cell(kind).mix
    a, b = Traffic(mix, BIG_SEED, CPU).detection(3), Traffic(mix, BIG_SEED, CPU).detection(3)
    assert _fingerprint(a) == _fingerprint(b)


@pytest.mark.parametrize("kind", ["labels", "captions"])
def test_detections_differ_in_content_but_not_in_size(kind):
    mix = tiny_cell(kind).mix
    t = Traffic(mix, BIG_SEED, CPU)
    a, b = t.detection(0), t.detection(1)
    c = Traffic(mix, 12345, CPU).detection(0)
    for name in SPLITS:
        assert len(a.splits[name]) == len(b.splits[name]) == mix["rows"][name]
    for name in SPLITS:
        sa, sb = a.splits[name], b.splits[name]
        assert sa.images[np.arange(len(sa))].tobytes() != sb.images[np.arange(len(sb))].tobytes()
        assert (sa.texts != sb.texts) if kind == "captions" else (sa.y_noisy != sb.y_noisy).any()
    for other in (b, c):
        for name in SPLITS:
            sa, so = a.splits[name], other.splits[name]
            assert sa.is_mislabel.sum() == so.is_mislabel.sum() == round(mix["noise"]["level"] * len(sa))
            if kind == "captions":
                la = sorted(len(x.split()) for x in sa.clean_texts)
                assert la == sorted(len(x.split()) for x in so.clean_texts)
                assert min(la) >= mix["caption_words"][0] and max(la) <= mix["caption_words"][1]


def test_label_mix_keeps_class_counts_over_the_whole_dataset():
    mix = tiny_cell("labels").mix
    for seed in (0, BIG_SEED):
        det = Traffic(mix, seed, CPU).detection(0)
        y = np.concatenate([det.splits[n].y_clean for n in SPLITS])
        counts = np.bincount(y, minlength=100)
        assert counts.max() - counts.min() <= 1


def test_noisy_rows_are_the_flagged_rows():
    det = Traffic(tiny_cell("captions").mix, 5, CPU).detection(2)
    for name in SPLITS:
        s = det.splits[name]
        assert [int(a != b) for a, b in zip(s.texts, s.clean_texts)] == s.is_mislabel.tolist()
    det = Traffic(tiny_cell("labels").mix, 5, CPU).detection(2)
    for name in SPLITS:
        s = det.splits[name]
        assert ((s.y_noisy != s.y_clean).astype(int) == s.is_mislabel).all()


def test_a_gray_pool_is_read_as_three_equal_channels():
    pool = np.arange(4 * 2 * 2, dtype=np.uint8).reshape(4, 2, 2, 1)
    view = PoolView(pool, np.array([3, 1]))
    got = view[np.array([1, 0])]
    assert got.shape == (2, 2, 2, 3) and len(view) == 2
    assert (got == pool[[1, 3]]).all()


def test_the_mixes_in_the_benchmark_load():
    for name in ("cifar100", "mimic-reports", "flickr30k"):
        mix = load_mix(name)
        assert set(mix["rows"]) == set(SPLITS)
        assert mix["detection"]["dist_type"] == "cosine"
