"""The slice end to end: ``lemon_tpu_torch.cli.run_lemon`` against
``lemon_tpu.cli.run_lemon`` on the same data and the same weights.

A JAX ``tiny`` init is saved as a "/"-flattened .npz and handed to both CLIs
with ``--checkpoint``. Bars (strict hyperparameter mode): neighbour ids
exact, score components 1e-5, ``pred_score`` 2e-3, val/test AUROC within
1e-3. A default-mode run holds the neighbour logs to the same bars. Also
here: the port stays free of jax/flax/optax/sklearn, and its numpy splits and
metrics agree with sklearn, which the JAX package calls.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import lemon_tpu.knn.index as jax_index
import lemon_tpu_torch.knn.index as torch_index
from lemon_tpu.models.clip import ClipConfig, init_params

REPO = Path(__file__).resolve().parents[1]
COMPONENTS = ("d_1", "dists_n", "D_n", "dists_tr_n", "dists_m", "D_m", "dists_tr_m")


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    _, params = init_params(ClipConfig.tiny(), seed=3)
    flat = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = np.asarray(val)

    walk(params, "")
    path = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    np.savez(path, **flat)
    return path


def _record_searches(monkeypatch, cls):
    calls = []
    orig = cls.search

    def search(self, xq, k):
        s, i = orig(self, xq, k)
        calls.append(np.asarray(i))
        return s, i

    monkeypatch.setattr(cls, "search", search)
    return calls


def _run_both(tmp_path, monkeypatch, ckpt, extra):
    monkeypatch.setenv("LEMON_TPU_NO_COMPILE_CACHE", "1")
    jax_ids = _record_searches(monkeypatch, jax_index.ExactKnnIndex)
    torch_ids = _record_searches(monkeypatch, torch_index.ExactKnnIndex)
    argv = ["--dataset", "synthetic_caption", "--noise_type", "random", "--noise_level", "0.4",
            "--synthetic_n", "400", "--clip_model", "tiny", "--knn_k", "5", "--batch_size", "64",
            "--checkpoint", str(ckpt), *extra]
    stdout, stderr = sys.stdout, sys.stderr
    try:  # both CLIs tee stdout/stderr into their output directory
        from lemon_tpu.cli.run_lemon import main as jax_main
        from lemon_tpu_torch.cli.run_lemon import main as torch_main

        jax_main(["--output_dir", str(tmp_path / "jax"), "--platform", "cpu", *argv])
        torch_main(["--output_dir", str(tmp_path / "torch"), "--platform", "cpu", *argv])
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    out = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        assert (d / "done").exists() and (d / "know_val_labels_scores.csv").exists()
        with open(d / "res.pkl", "rb") as f:
            out[name] = pickle.load(f)
        out[name]["csv"] = pd.read_csv(d / "know_val_labels_scores.csv")
    return out, jax_ids, torch_ids


def _assert_logs_match(out, jax_ids, torch_ids):
    assert len(jax_ids) == len(torch_ids) == 6  # (train, val, test) x (image, text)
    for a, b in zip(jax_ids, torch_ids):
        np.testing.assert_array_equal(b, a)
    dj, dt = out["jax"]["df"], out["torch"]["df"]
    assert (dj["sset"].values == dt["sset"].values).all()
    np.testing.assert_array_equal(dj["is_mislabel"].values, dt["is_mislabel"].values)
    for col in COMPONENTS:
        a = np.stack(dj[col].to_list()) if col != "d_1" else dj[col].to_numpy()
        b = np.stack(dt[col].to_list()) if col != "d_1" else dt[col].to_numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=col)


def test_strict_run_matches_jax_cli(tmp_path, monkeypatch, tiny_npz):
    out, jax_ids, torch_ids = _run_both(tmp_path, monkeypatch, tiny_npz, ["--strict_hparam_parity"])
    _assert_logs_match(out, jax_ids, torch_ids)
    d = np.abs(out["jax"]["csv"]["pred_score"].values - out["torch"]["csv"]["pred_score"].values).max()
    assert d <= 2e-3, d
    for s in ("val", "test"):
        a = out["jax"]["agg_results"]["know_val_labels"][s]["AUROC"]
        b = out["torch"]["agg_results"]["know_val_labels"][s]["AUROC"]
        assert abs(a - b) <= 1e-3, (s, a, b)
    args = json.loads((tmp_path / "torch" / "args.json").read_text())
    assert args["platform"] == "cpu" and args["strict_hparam_parity"]


def test_default_run_matches_jax_neighbour_logs(tmp_path, monkeypatch, tiny_npz):
    """Default (non-strict) hyperparameter mode. Its kNN precision 'auto'
    means bf16x3, which the JAX package computes only inside its Pallas
    kernel: XLA on the CPU ignores the matmul precision hint and gives fp32.
    So the cross-package comparison pins fp32 ('highest'); the port's own
    'auto' run must then agree on at least 98% of the neighbour ids
    (bf16x3 reorders near-ties only) and give finite AUROCs."""
    out, jax_ids, torch_ids = _run_both(tmp_path, monkeypatch, tiny_npz, ["--knn_precision", "highest"])
    _assert_logs_match(out, jax_ids, torch_ids)

    from lemon_tpu_torch.cli.run_lemon import main as torch_main

    stdout, stderr = sys.stdout, sys.stderr
    try:
        torch_main(["--output_dir", str(tmp_path / "auto"), "--platform", "cpu", "--dataset", "synthetic_caption",
                    "--noise_type", "random", "--synthetic_n", "400", "--clip_model", "tiny", "--knn_k", "5",
                    "--batch_size", "64", "--checkpoint", str(tiny_npz)])
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    auto_ids = torch_ids[6:]
    assert len(auto_ids) == 6
    same = np.mean([(a == b).mean() for a, b in zip(auto_ids, jax_ids)])
    assert same >= 0.98, same
    with open(tmp_path / "auto" / "res.pkl", "rb") as f:
        agg = pickle.load(f)["agg_results"]["know_val_labels"]
    assert np.isfinite(agg["val"]["AUROC"]) and np.isfinite(agg["test"]["AUROC"])


def test_k_above_the_comparison_set_matches_jax_cli(tmp_path, monkeypatch, tiny_npz):
    """``--knn_k 60`` on 60 pairs, without the discrete flag: the padding
    slots of both searches keep the index's -inf score (+inf once negated),
    as in the JAX package, and every component agrees with its run. The
    padding ids differ (a handled divergence: the port pins each to
    n_valid), so JAX's are pinned the same way before the comparison."""
    out, jax_ids, torch_ids = _run_both(tmp_path, monkeypatch, tiny_npz,
                                        ["--knn_precision", "highest", "--synthetic_n", "60", "--knn_k", "60"])
    n_valid = 48  # the train split, the comparison set
    _assert_logs_match(out, [np.minimum(a, n_valid) for a in jax_ids], torch_ids)
    for col in ("D_n", "D_m"):
        d = np.stack(out["torch"]["df"][col].to_list())
        assert np.isposinf(d).any(axis=1).all() and not np.isneginf(d).any(), col

def test_knn_k_above_128_matches_jax_cli(tmp_path, monkeypatch, tiny_npz):
    """``--knn_k 150``: the train split searches 151 neighbours. The JAX
    package takes lax.top_k above k = 128, the port keeps K2. The two
    packages' towers give embeddings that differ in the last bits, which at
    this depth reorders a few neighbours whose scores are within 1e-5 of
    each other; every other id must agree, and the scores everywhere."""
    found = {"jax": [], "torch": []}
    for name, mod in (("jax", jax_index), ("torch", torch_index)):
        orig = mod.ExactKnnIndex.search

        def search(self, xq, k, orig=orig, calls=found[name]):
            s, i = orig(self, xq, k)
            calls.append((np.asarray(s), np.asarray(i)))
            return s, i

        monkeypatch.setattr(mod.ExactKnnIndex, "search", search)
    out, _, _ = _run_both(tmp_path, monkeypatch, tiny_npz, ["--knn_precision", "highest", "--knn_k", "150"])
    assert len(found["jax"]) == len(found["torch"]) == 6
    assert found["torch"][0][1].shape[1] == 151 and out["torch"]["df"]["dists_n"].iloc[0].shape == (150,)
    same = []
    for (js, ji), (ts, ti) in zip(found["jax"], found["torch"]):
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
        for r, j in zip(*np.nonzero(ti != ji)):
            near = np.abs(js[r] - ts[r, j]) <= 1e-5
            assert ti[r, j] in ji[r][near], (r, j)  # a near-tie swap
        same.append((ti == ji).mean())
    assert min(same) >= 0.999, same


def test_port_cli_imports_no_jax(tmp_path):
    """In a fresh interpreter the port's CLI runs without importing jax,
    flax or optax — nor sklearn, which the GPU machine does not have."""
    code = (
        "import sys\n"
        "import lemon_tpu_torch\n"
        "from lemon_tpu_torch.cli.run_lemon import main\n"
        f"main(['--output_dir', {str(tmp_path)!r}, '--platform', 'cpu', '--debug', '--dataset', 'synthetic',"
        " '--noise_type', 'symmetric', '--synthetic_n', '120', '--clip_model', 'tiny', '--knn_k', '3',"
        " '--batch_size', '32'])\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'sklearn') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('IMPORT_GUARD_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORT_GUARD_OK" in proc.stdout
    assert (tmp_path / "done").exists()


def test_no_gpu_and_no_cpu_flag_raises(monkeypatch):
    import torch

    from lemon_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_unported_options_raise(tmp_path):
    """Nothing of these options is left unported. Tensor parallelism
    (``--mesh`` with MODEL > 1) runs (tests/test_torch_tensor_parallel.py):
    in a world of one a ``4x2`` mesh raises only for the eight processes it
    needs, as any mesh larger than the world does. The ``cifar10c``
    robustness set is ported (tests/test_torch_downstream.py): without a
    corruption it raises as the JAX package's does, not as an unported
    name."""
    import torch.distributed as dist

    from lemon_tpu_torch.cli.run_lemon import main

    try:
        with pytest.raises(ValueError, match="mesh 4x2 needs 8 processes; the world has 1"):
            main(["--output_dir", str(tmp_path), "--platform", "cpu", "--mesh", "4x2"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    from lemon_tpu_torch.data.datasets import get_dataset

    with pytest.raises(ValueError, match="cifar10c needs corruption_name"):
        get_dataset("cifar10c", 0)


@pytest.mark.parametrize("n", [10, 120, 400, 600, 1001, 20000])
def test_splits_match_sklearn(n):
    from lemon_tpu.data.splits import split_80_10_10 as sk_split
    from lemon_tpu.data.splits import split_80_20 as sk_split_80_20
    from lemon_tpu_torch.data.splits import split_80_10_10, split_80_20

    for seed in (0, 1, 14):
        for a, b in zip(split_80_10_10(n, seed), sk_split(n, seed)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(split_80_20(n, seed), sk_split_80_20(n, seed)):
            np.testing.assert_array_equal(a, b)


def test_metrics_match_sklearn():
    from lemon_tpu.scoring.metrics import eval_metrics as sk_eval
    from lemon_tpu_torch.scoring.metrics import eval_metrics

    rng = np.random.default_rng(0)
    for n, ties in ((200, False), (333, True)):
        y = (rng.random(n) < 0.3).astype(np.int64)
        score = rng.standard_normal(n) + y
        if ties:
            score = np.round(score, 1)
        ref = sk_eval(y, score, prevalence=y.mean())
        got = eval_metrics(y, score, prevalence=y.mean())
        assert ref.keys() == got.keys()
        for key in ref:
            assert got[key] == pytest.approx(ref[key], rel=1e-12, abs=1e-12), key


def test_device_grid_matches_jax():
    """calc_scores_grid and the exact all-thresholds F1 sweep against the
    JAX device versions (float32 on both sides)."""
    from lemon_tpu.scoring.lemon import NeighborLogs as JaxLogs
    from lemon_tpu.scoring.lemon import calc_scores_grid as jax_grid
    from lemon_tpu.scoring.optimize import default_grid, grid_best_f1_device as jax_best, grid_to_matrix
    from lemon_tpu_torch.scoring.lemon import NeighborLogs, calc_scores_grid
    from lemon_tpu_torch.scoring.optimize import grid_best_f1_device

    rng = np.random.default_rng(1)
    n, k = 300, 5
    arrays = dict(
        d_1=rng.random(n), dists_n=rng.random((n, k)), D_n=-rng.random((n, k)), dists_tr_n=rng.random((n, k)),
        dists_m=rng.random((n, k)), D_m=-rng.random((n, k)), dists_tr_m=rng.random((n, k)),
        is_mislabel=(rng.random(n) < 0.3).astype(np.int64), sset=np.full(n, "val", object),
    )
    gm = grid_to_matrix(default_grid())[::37]
    got = calc_scores_grid(NeighborLogs(**arrays), gm, device="cpu")
    ref = jax_grid(JaxLogs(**arrays), gm)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    f1 = grid_best_f1_device(NeighborLogs(**arrays), arrays["is_mislabel"], gm, device="cpu")
    np.testing.assert_allclose(f1, jax_best(JaxLogs(**arrays), arrays["is_mislabel"], gm), rtol=0, atol=1e-6)


DISCRETE_ARGV = ["--platform", "cpu", "--dataset", "synthetic_caption", "--synthetic_n", "60", "--noise_type",
                 "random", "--clip_model", "tiny", "--knn_k", "60", "--use_discrete_for_text"]


def test_discrete_text_with_k_above_the_comparison_set_completes(tmp_path):
    """k + 1 = 61 neighbours of a 48-row comparison set: the padding slots
    must not stop the run (the JAX CLI raises IndexError here)."""
    from lemon_tpu_torch.cli.run_lemon import main

    main(["--output_dir", str(tmp_path), *DISCRETE_ARGV])
    assert (tmp_path / "done").exists()
    scores = pd.read_csv(tmp_path / "know_val_labels_scores.csv")["pred_score"].to_numpy()
    assert len(scores) == 60 and np.isfinite(scores).all()


def test_discrete_text_padding_slots_read_the_last_row():
    """At a padding slot (id n_valid) the discrete text distance
    is that of the comparison set's last row: FAISS pads with id -1, which
    numpy reads as the last row. This holds the port to that rule; the JAX
    package has no output to compare with."""
    import torch

    from lemon_tpu_torch import detect
    from lemon_tpu_torch.core.profiling import PhaseTimer
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.models.registry import create_encoder

    cfg = detect.DetectionConfig(dataset="synthetic_caption", noise_type="random", clip_model="tiny", knn_k=60,
                                 synthetic_n=60, use_discrete_for_text=True, platform="cpu")
    cpu = torch.device("cpu")
    splits = dict(zip(("train", "val", "test"), get_dataset(
        cfg.dataset, cfg.data_seed, noise_level=cfg.noise_level, noise_type=cfg.noise_type, synthetic_n=60)))
    encoder = create_encoder("tiny", cpu, seed=cfg.seed)
    logs = detect.build_neighbor_logs(cfg, encoder, splits, None, PhaseTimer(cpu))
    last = list(splits["train"].sentence)[-1]  # the comparison set is the whole train split
    noisy = np.concatenate([np.asarray(splits[s].sentence) for s in ("train", "val", "test")])
    # under --use_discrete_for_text D_n keeps the score's sign, and a
    # padding slot carries FAISS's padding score -FLT_MAX (D_m's is negated)
    pad = logs.D_n == np.finfo(np.float32).min
    assert np.isfinite(logs.D_n).all() and np.isfinite(logs.D_m).all()
    np.testing.assert_array_equal(logs.D_m == np.finfo(np.float32).max, pad)
    assert pad.any(axis=1).all()  # every row has padding slots: 60 > 48 rows
    want = 1.0 - (noisy == last).astype(np.float64)
    np.testing.assert_array_equal(logs.dists_n[pad], np.broadcast_to(want[:, None], pad.shape)[pad])


def test_reported_scores_keep_the_neighbour_terms_cancellation(monkeypatch):
    """Hyperparameters a fit chose on a MIMIC-like detection: beta and gamma of
    opposite signs, tau near 10, so the two neighbour terms (hundreds each)
    cancel to scores under 1. The reported scores are the float64 formula of
    the components; float32 arithmetic would be off by about 4e-4 there."""
    import torch

    from lemon_tpu_torch import detect
    from lemon_tpu_torch.core.profiling import PhaseTimer
    from lemon_tpu_torch.scoring.lemon import NeighborLogs

    # one row of a b16mimic-reports-bf16 detection, repeated with d_1 spread
    row = {"dists_n": [0.43020761013031006, 0.30655455589294434, 0.3352661728858948, 0.43001872301101685,
                       0.35546064376831055],
           "D_n": [-0.9936203956604004, -0.9935858845710754, -0.9934577941894531, -0.9933109283447266,
                   -0.9932405352592468],
           "dists_tr_n": [0.9914824366569519, 0.9772607684135437, 0.9370926022529602, 0.9541694521903992,
                          0.9852677583694458],
           "dists_m": [0.04831916093826294, 0.03229445219039917, 0.008557140827178955, 0.01296323537826538,
                       0.011536896228790283],
           "D_m": [-0.8265211582183838, -0.8265211582183838, -0.823229193687439, -0.823229193687439,
                   -0.8217027187347412],
           "dists_tr_m": [1.0084316730499268, 0.9943894743919373, 0.9746130108833313, 0.978224515914917,
                          0.9633580446243286]}
    n, k = 60, 5
    logs = NeighborLogs(d_1=np.linspace(0.95, 1.0, n, dtype=np.float32),
                        **{c: np.tile(np.asarray(v, np.float32), (n, 1)) for c, v in row.items()},
                        is_mislabel=np.arange(n) % 3 == 0,
                        sset=np.repeat(np.array(["train", "val", "test"], object), n // 3), idx=np.arange(n))
    hp = {"beta": -0.23365407478452693, "gamma": 22.21216246791203, "tau_1_n": 9.99806897421857,
          "tau_2_n": 1.0063040059141994, "tau_1_m": 10.055089374563453, "tau_2_m": 1.1110801048777093}
    x = np.array([hp[h] for h in ("beta", "gamma", "tau_1_n", "tau_2_n", "tau_1_m", "tau_2_m")])
    monkeypatch.setattr(detect, "maximize_metric", lambda logs_val, **kw: (x, 0.5, 0.0))
    cfg = detect.DetectionConfig(dataset="mimiccxr_caption", noise_type="random")
    _, df = detect.select_and_evaluate(cfg, logs, torch.device("cpu"), PhaseTimer(torch.device("cpu")))

    def formula(dtype):
        c = {a: np.asarray(getattr(logs, a), dtype) for a in ("d_1", "dists_n", "D_n", "dists_tr_n", "dists_m",
                                                               "D_m", "dists_tr_m")}
        wn = np.exp(-hp["tau_1_n"] * c["D_n"]) * np.exp(-hp["tau_2_n"] * c["dists_tr_n"])
        wm = np.exp(-hp["tau_1_m"] * c["D_m"]) * np.exp(-hp["tau_2_m"] * c["dists_tr_m"])
        return c["d_1"] + hp["beta"] * np.sum(wn * c["dists_n"], 1) / k + hp["gamma"] * np.sum(wm * c["dists_m"], 1) / k

    want = formula(np.float64)
    assert np.abs(want).max() < 1 and np.abs(formula(np.float32) - want).max() > 2e-4  # what float32 loses
    np.testing.assert_allclose(df["know_val_labels_pred_score"].to_numpy(), want, rtol=1e-12, atol=1e-12)
