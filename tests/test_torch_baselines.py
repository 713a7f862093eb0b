"""The port's detection baselines against the JAX package's, on the CPU.

Each runner of ``lemon_tpu_torch.baselines`` and its twin in
``lemon_tpu.baselines`` load the same seeded synthetic splits and embed with
the tiny CLIP of both packages on one set of weights (a JAX init handed to
the port through ``from_flax_params``). Bars: ``pred_score`` within 1e-5;
``sset``, ``idx``, the labels and ``is_mislabel`` exact; the ``.npy`` outputs
within 1e-5 (scores) or exact (labels, splits). The port's kNN runs the plain
versions of K1 and K2 on CPU tensors. Also here: the second-hop cache's self
exclusion against the JAX package's loop, and the CLI's refusals.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread
    each keeps torch's OpenMP pools from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCORE_TOL = 1e-5
CAPTION = dict(dataset="synthetic_caption", noise_type="random")
CLF = dict(dataset="synthetic", noise_type="symmetric")


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    """(JAX encoder, port encoder, .npz checkpoint) on one tiny init."""
    from lemon_tpu.models.clip import ClipConfig, init_params
    from lemon_tpu.models.encoder import ClipEncoder as JaxEncoder
    from lemon_tpu_torch.models.clip import ClipConfig as PortConfig, ClipModel
    from lemon_tpu_torch.models.convert import from_flax_params
    from lemon_tpu_torch.models.encoder import ClipEncoder

    jax_model, params = init_params(ClipConfig.tiny(), seed=3)
    model = ClipModel(PortConfig.tiny())
    model.load_state_dict(from_flax_params(params))
    flat = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = np.asarray(val)

    walk(params, "")
    npz = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    np.savez(npz, **flat)
    return JaxEncoder(jax_model, params, batch_size=64), ClipEncoder(model, CPU, batch_size=64), npz


def _cfgs(**kw):
    from lemon_tpu.baselines.common import BaselineConfig as JaxConfig
    from lemon_tpu_torch.baselines.common import BaselineConfig

    kw = dict(clip_model="tiny", knn_k=5, batch_size=64, synthetic_n=240, **kw)
    return JaxConfig(**kw), BaselineConfig(platform="cpu", **kw)


def _run_both(jax_runner, port_runner, tiny_weights, tmp_path, **kw):
    jax_enc, port_enc, _ = tiny_weights
    jcfg, pcfg = _cfgs(**kw)
    jres = jax_runner(jcfg, tmp_path / "jax", encoder=jax_enc)
    pres = port_runner(pcfg, tmp_path / "port", encoder=port_enc)
    _assert_frames_match(jres["df"], pres["df"])
    for name in ("res.pkl", "scores.csv", "done"):
        assert (tmp_path / "port" / name).exists(), name
    return jres, pres


def _assert_frames_match(dj, dp):
    assert list(dj.columns) == list(dp.columns)
    assert len(dj) == len(dp)
    for col in ("sset", "idx", "actual_label", "noisy_label", "is_mislabel"):
        assert (dj[col].to_numpy() == dp[col].to_numpy()).all(), col
    d = np.abs(dj["pred_score"].to_numpy(np.float64) - dp["pred_score"].to_numpy(np.float64)).max()
    assert d <= SCORE_TOL, f"pred_score differs from the JAX runner's by {d}"


@pytest.mark.parametrize("data", [CAPTION, CLF], ids=["caption", "classification"])
def test_clip_sim_matches_jax(tiny_weights, tmp_path, data):
    from lemon_tpu.baselines.clip_sim import run_clip_sim as jax_run
    from lemon_tpu_torch.baselines import run_clip_sim

    _run_both(jax_run, run_clip_sim, tiny_weights, tmp_path, **data)
    np.testing.assert_allclose(np.load(tmp_path / "port" / "dists.npy"), np.load(tmp_path / "jax" / "dists.npy"),
                               rtol=0, atol=SCORE_TOL)
    for name in ("label_flips.npy", "datasplit.npy"):
        j = np.load(tmp_path / "jax" / name, allow_pickle=True)
        p = np.load(tmp_path / "port" / name, allow_pickle=True)
        assert (j == p).all(), name
    assert np.load(tmp_path / "port" / "runtime.npy").shape == (1,)


@pytest.mark.parametrize("dist_type,temperature", [("cosine", 1.0), ("euclidean", 1.0), ("cosine", 0.05)])
def test_zero_shot_matches_jax(tiny_weights, tmp_path, dist_type, temperature):
    from lemon_tpu.baselines.zero_shot import run_zero_shot_logits as jax_run
    from lemon_tpu_torch.baselines import run_zero_shot_logits

    _, pres = _run_both(jax_run, run_zero_shot_logits, tiny_weights, tmp_path, dist_type=dist_type,
                        temperature=temperature, **CLF)
    got = np.load(tmp_path / "port" / "dists.npy")
    np.testing.assert_allclose(got, np.load(tmp_path / "jax" / "dists.npy"), rtol=0, atol=SCORE_TOL)
    # dists.npy holds the confidences before the frame's negation
    np.testing.assert_array_equal(-got, pres["df"]["pred_score"].to_numpy())


def test_zero_shot_euclidean_row_chunks_match_one_block(monkeypatch):
    from lemon_tpu_torch.baselines import zero_shot

    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.standard_normal((37, 16)).astype(np.float32))
    labels = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    whole = ((img[:, None, :] - labels[None]) ** 2).sum(-1) ** 0.5
    monkeypatch.setattr(zero_shot, "DIFF_BUDGET", 3 * 5 * 16 * 4)  # chunks of 3 rows, the last of 1
    np.testing.assert_array_equal(zero_shot.class_distances(img, labels, "euclidean").numpy(), whole.numpy())
    with pytest.raises(NotImplementedError):
        zero_shot.class_distances(img, labels, "manhattan")


def test_zero_shot_temperature_changes_scores(tiny_weights):
    from lemon_tpu_torch.baselines import run_zero_shot_logits

    _, port_enc, _ = tiny_weights
    a = run_zero_shot_logits(_cfgs(temperature=1.0, **CLF)[1], encoder=port_enc)["df"]["pred_score"]
    b = run_zero_shot_logits(_cfgs(temperature=0.05, **CLF)[1], encoder=port_enc)["df"]["pred_score"]
    assert np.abs(a.to_numpy() - b.to_numpy()).max() > 1e-3


def test_zero_shot_refuses_captioning(tiny_weights):
    from lemon_tpu_torch.baselines import run_zero_shot_logits

    with pytest.raises(AssertionError, match="classification"):
        run_zero_shot_logits(_cfgs(**CAPTION)[1], encoder=tiny_weights[1])


@pytest.mark.parametrize("method,skip_train", [("dis_y", False), ("dis_x", False), ("div_y", False),
                                               ("div_x", False), ("dis_x", True), ("div_y", True)])
def test_discrepancy_matches_jax(tiny_weights, tmp_path, method, skip_train):
    from lemon_tpu.baselines.discrepancy import run_discrepancy as jax_run
    from lemon_tpu_torch.baselines import run_discrepancy

    jres, _ = _run_both(jax_run, run_discrepancy, tiny_weights, tmp_path, method=method, skip_train=skip_train,
                        **CAPTION)
    want = ["val", "test"] if skip_train else ["train", "val", "test"]
    assert list(jres["df"].sset.unique()) == want


def test_discrepancy_train_split_keeps_its_self_match(tiny_weights):
    """The reference quirk: train rows search k+1 text neighbours, keep the
    self match in I_m, and div_* still divides by k^2."""
    from lemon_tpu_torch.baselines import run_discrepancy
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.detect import _texts_for_split
    from lemon_tpu_torch.knn.index import numpy_search

    _, port_enc, _ = tiny_weights
    cfg = _cfgs(method="div_y", **CAPTION)[1]
    res = run_discrepancy(cfg, encoder=port_enc)
    train = get_dataset(cfg.dataset, cfg.data_seed, noise_type=cfg.noise_type, synthetic_n=cfg.synthetic_n)[0]
    texts = _texts_for_split(cfg, train, None)[0]
    _, txt = port_enc.embed_split(train, texts)
    k = cfg.knn_k
    _, ids = numpy_search(txt, txt, k + 1, "ip")
    nb = txt[ids]
    want = (1.0 - np.einsum("bid,bjd->bij", nb, nb)).sum(axis=(1, 2)) / k**2
    got = res["df"].query("sset == 'train'")["pred_score"].to_numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)


def _jax_cache_loop(c, k):
    """lemon_tpu/baselines/discrepancy.py:52-62, the per-row loop."""
    cache = np.empty((len(c), k), np.int64)
    for i in range(len(c)):
        row = c[i][c[i] != i][:k]
        if len(row) < k:
            row = np.concatenate([row, c[i][: k - len(row)]])
        cache[i] = row
    return cache


def test_self_excluded_cache_matches_the_jax_loop():
    from lemon_tpu_torch.baselines.discrepancy import self_excluded_cache
    from lemon_tpu_torch.knn.index import ExactKnnIndex

    k = 4
    # duplicate embeddings: identical rows tie and the lower index wins, so
    # the later copies of a row do not find themselves
    rng = np.random.default_rng(0)
    base = rng.standard_normal((10, 8)).astype(np.float32)
    x = base[rng.integers(0, 10, 60)]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    index = ExactKnnIndex(metric="ip", device=CPU)
    index.add(x)
    _, c = index.search(x, k + 1)
    missing = (c != np.arange(len(c))[:, None]).all(axis=1)
    assert missing.any() and not missing.all()
    got = self_excluded_cache(torch.from_numpy(c.astype(np.int64)), k).numpy()
    np.testing.assert_array_equal(got, _jax_cache_loop(c, k))
    # the loop's padding branch: a row that holds itself twice keeps k-1
    c2 = np.array([[0, 5, 0, 7, 8], [3, 1, 2, 1, 4], [9, 8, 7, 6, 2]])
    got2 = self_excluded_cache(torch.from_numpy(c2), k).numpy()
    np.testing.assert_array_equal(got2, _jax_cache_loop(c2, k))
    np.testing.assert_array_equal(got2[0], [5, 7, 8, 0])


@pytest.mark.parametrize("data", [CLF, CAPTION], ids=["classification", "caption"])
def test_deepknn_matches_jax(tiny_weights, tmp_path, data):
    from lemon_tpu.baselines.deepknn import run_deepknn as jax_run
    from lemon_tpu_torch.baselines import run_deepknn

    _, pres = _run_both(jax_run, run_deepknn, tiny_weights, tmp_path, **data)
    # a second run (clustering included) gives the same bits
    again = run_deepknn(_cfgs(**data)[1], encoder=tiny_weights[1])
    np.testing.assert_array_equal(again["df"]["pred_score"].to_numpy(), pres["df"]["pred_score"].to_numpy())


def _cli(argv):
    from lemon_tpu_torch.cli.run_baseline import main

    stdout, stderr = sys.stdout, sys.stderr
    try:  # the CLI tees stdout/stderr into its output directory
        return main(argv)
    finally:
        sys.stdout, sys.stderr = stdout, stderr


def test_cli_matches_jax_cli(tiny_weights, tmp_path, monkeypatch):
    """Both CLIs, one checkpoint: the same scores.csv and output files."""
    import pandas as pd

    from lemon_tpu.cli.run_baseline import main as jax_main

    monkeypatch.setenv("LEMON_TPU_NO_COMPILE_CACHE", "1")
    argv = ["--baseline", "discrepancy", "--method", "dis_y", "--dataset", "synthetic_caption", "--noise_type",
            "random", "--synthetic_n", "240", "--clip_model", "tiny", "--batch_size", "64", "--checkpoint",
            str(tiny_weights[2])]
    stdout, stderr = sys.stdout, sys.stderr
    try:
        jax_main(["--output_dir", str(tmp_path / "jax"), "--platform", "cpu", *argv])
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    res = _cli(["--output_dir", str(tmp_path / "port"), "--platform", "cpu", *argv])
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())
    _assert_frames_match(pd.read_csv(tmp_path / "jax" / "scores.csv"), pd.read_csv(tmp_path / "port" / "scores.csv"))
    assert set(res) >= {"df", "agg_results"}
    assert "Device: cpu" in (tmp_path / "port" / "out.txt").read_text()


@pytest.mark.parametrize("flag", [["--normalize_d1"], ["--ablation", "d1"], ["--use_discrete_for_text"],
                                  ["--real_dataset"], ["--subset_val_set", "10"], ["--mesh", "2x4"],
                                  ["--skip_hparam_optim"], ["--strict_hparam_parity"]])
def test_cli_refuses_run_lemon_only_flags(tmp_path, flag):
    with pytest.raises(SystemExit, match="is a run_lemon flag with no effect on baselines; remove it"):
        _cli(["--output_dir", str(tmp_path), "--platform", "cpu", "--debug", "--baseline", "clip_sim",
              "--clip_model", "tiny", "--dataset", "synthetic_caption", *flag])


@pytest.mark.parametrize("baseline", ["capfilt", "aum", "datamap"])
def test_cli_unported_baselines_raise(tmp_path, baseline):
    """Once refusals, now ported: capfilt without ``--itm_checkpoint`` runs
    the CLIP proxy head on a tiny caption set, printing the JAX package's
    notice (tests/test_torch_capfilt.py and test_torch_blip_itm.py hold it
    to the golden and to JAX); aum and datamap run
    (tests/test_torch_training_dependent.py holds them to JAX)."""
    argv = ["--output_dir", str(tmp_path / "out"), "--platform", "cpu", "--baseline", baseline]
    if baseline == "capfilt":
        res = _cli([*argv, "--clip_model", "tiny", "--dataset", "synthetic_caption", "--noise_type", "random",
                    "--synthetic_n", "60", "--batch_size", "16"])
        assert (tmp_path / "out" / "done").exists() and np.isfinite(res["df"]["pred_score"]).all()
        assert "[capfilt] no BLIP-ITM checkpoint; using the CLIP ITM proxy head" in (
            tmp_path / "out" / "out.txt").read_text()
        for name in ("full_loss_dict.pkl", "flip_labels.pkl", "runtime.npy"):
            assert (tmp_path / "out" / name).exists(), name
        return
    res = _cli([*argv, "--dataset", "synthetic", "--noise_type", "symmetric", "--synthetic_n", "60", "--epochs", "1",
                "--batch_size", "32", "--img_base_name", "resnet50_tiny"])
    assert (tmp_path / "out" / "done").exists() and np.isfinite(res["df"]["pred_score"]).all()


def test_cli_default_platform_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli(["--output_dir", str(tmp_path), "--baseline", "clip_sim", "--clip_model", "tiny"])
    from lemon_tpu_torch.baselines.common import BaselineConfig, setup

    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup(BaselineConfig(clip_model="tiny"))


@pytest.mark.cuda
def test_the_baselines_search_counts_k1_highest_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    from lemon_tpu_torch.ops import scoremax, topk
    from lemon_tpu_torch.scoring.distance_metrics import knn_label_distribution

    x, _ = np.random.default_rng(0).standard_normal((2, 700, 32)).astype(np.float32)
    labels = np.arange(700) % 4
    before = (scoremax.scores_blockmax.launches, scoremax.scores_blockmax.launches_highest, topk.topk.launches)
    got = knn_label_distribution(x, labels, 4, k=5, device=torch.device("cuda"))
    n, n_highest, n_topk = (a - b for a, b in zip(
        (scoremax.scores_blockmax.launches, scoremax.scores_blockmax.launches_highest, topk.topk.launches), before))
    assert n == n_highest >= 1 and n_topk >= 1
    np.testing.assert_allclose(got, knn_label_distribution(x, labels, 4, k=5, device=CPU), rtol=0, atol=1e-6)


def test_port_baseline_cli_imports_no_jax(tmp_path):
    """In a fresh interpreter the four baselines run without importing jax,
    flax, optax or sklearn (the GPU machine has no sklearn)."""
    import subprocess

    code = (
        "import sys\n"
        "from lemon_tpu_torch.cli.run_baseline import main\n"
        "common = ['--platform', 'cpu', '--debug', '--synthetic_n', '120', '--clip_model', 'tiny', '--knn_k', '3',"
        " '--batch_size', '32']\n"
        "cap = ['--dataset', 'synthetic_caption', '--noise_type', 'random']\n"
        "for i, extra in enumerate([['--baseline', 'clip_sim', *cap], ['--baseline', 'discrepancy', '--method',"
        " 'dis_x', *cap], ['--baseline', 'deepknn', *cap], ['--baseline', 'zero_shot', '--dataset', 'synthetic',"
        " '--noise_type', 'symmetric']]):\n"
        f"    main(['--output_dir', {str(tmp_path)!r} + f'/{{i}}', *common, *extra])\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'sklearn') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('IMPORT_GUARD_OK')\n"
    )
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORT_GUARD_OK" in proc.stdout
    assert all((tmp_path / str(i) / "done").exists() for i in range(4))
