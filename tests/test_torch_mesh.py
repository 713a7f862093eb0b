"""The port's process mesh (core/mesh.py) on torch.distributed with gloo.

Each multi-process test spawns its ranks with ``torch.multiprocessing``
(spawn), which meet through a file store under the test's ``tmp_path``, so
parallel test workers cannot collide on a port. Every rank writes what it
computed to ``tmp_path``; the test holds it to the same code in one process.
Bars:

- a data-parallel step against the single-process step on the global batch:
  the loss and the summed gradients within 1e-4 and SGD's parameters within
  1e-4 (the JAX package's bars, tests/test_train.py:91-113); AdamW's
  parameters in units of the learning rate (see tests/test_torch_train.py);
- the sharded search against the one-process search: ids equal, scores
  within 1e-6;
- ``run_lemon --mesh 2x1`` against the run without a mesh: scores within
  rtol 1e-4, atol 1e-5 and test AUROC within 1e-6
  (tests/test_mesh_pipeline.py:20-32), the output files written once.

This module imports no JAX: the spawned ranks import it.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lemon_tpu_torch.core.mesh import Mesh, get_mesh, parse_mesh, shard_batch
from lemon_tpu_torch.knn.index import ExactKnnIndex, numpy_search, train_split_exclusion
from lemon_tpu_torch.models.clip import ClipConfig
from lemon_tpu_torch.train.contrastive import TrainConfig, create_train_state, make_schedule, make_train_step

CPU = torch.device("cpu")
DP_CFG = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, batch_size=8)
DETECT_ARGV = ["--dataset", "synthetic_caption", "--noise_type", "random", "--clip_model", "tiny", "--knn_k", "3",
               "--batch_size", "64", "--synthetic_n", "160", "--knn_tile", "32", "--platform", "cpu"]


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=world)
    try:
        torch.save(fn(rank, world, Path(tmp), *args), Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp_path, *args):
    """``fn(rank, world, tmp_path, *args)`` (a function of a test module) on
    ``world`` gloo ranks; the list of what each rank returned."""
    mp.spawn(_entry, args=(fn, world, str(tmp_path), args), nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _batch(b=8, seed=3):
    cfg = ClipConfig.tiny()
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((b, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 2, (b, cfg.context_length)).astype(np.int64)
    tokens[:, -1] = cfg.vocab_size - 1
    return torch.from_numpy(pixels), torch.from_numpy(tokens)


def _steps(mesh, optimizer, n=3):
    """Losses, the first step's gradients and the parameters after each step."""
    model, state = create_train_state(ClipConfig.tiny(), TrainConfig(**DP_CFG, optimizer=optimizer),
                                      mesh=mesh, device=CPU)
    step = make_train_step(model, mesh)
    pixels, tokens = _batch()
    if mesh is not None:
        pixels, tokens = shard_batch(pixels, mesh)[0], shard_batch(tokens, mesh)[0]
    out = {"loss": [], "params": []}
    for i in range(n):
        state, loss = step(state, pixels, tokens)
        out["loss"].append(float(loss))
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
        out["params"].append({k: v.clone() for k, v in model.state_dict().items()})
    return out


def _dp_worker(rank, world, tmp, optimizer):
    return _steps(get_mesh(world, 1, platform="cpu"), optimizer)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_dp_step_matches_single_process(tmp_path, optimizer):
    ranks = spawn(_dp_worker, 2, tmp_path, optimizer)
    ref = _steps(None, optimizer)
    for out in ranks:
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=0, atol=1e-4)
        for k, g in ref["grads"].items():
            torch.testing.assert_close(out["grads"][k], g, rtol=0, atol=1e-4)
    # the replicas stay equal, bit for bit
    for k, v in ranks[0]["params"][-1].items():
        assert torch.equal(ranks[1]["params"][-1][k], v)
    lr = make_schedule(TrainConfig(**DP_CFG))
    for i, params in enumerate(ranks[0]["params"]):
        diff = torch.cat([(params[k] - v).abs().reshape(-1) for k, v in ref["params"][i].items()])
        if optimizer == "sgd":
            assert float(diff.max()) < 1e-4
        else:
            assert float(diff.max()) <= 2 * sum(lr(j) for j in range(i + 1))
            assert float((diff > 1e-4).float().mean()) <= 1e-3


def _train_cli_worker(rank, world, tmp, argv):
    from lemon_tpu_torch.cli.train_clip import main

    stdout, stderr = sys.stdout, sys.stderr
    try:
        state = main(argv)
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_train_clip_cli_under_a_mesh(tmp_path):
    """``train_clip --mesh 2x1``: each rank builds its rows of each batch and
    the run trains as one process does (SGD, so the parameters are held at
    1e-4); rank 0 alone writes the run's files."""
    from lemon_tpu_torch.cli.train_clip import main

    argv = ["--dataset", "synthetic_caption", "--model_size", "tiny", "--batch_size", "8", "--total_steps", "3",
            "--save_interval", "2", "--optimizer", "sgd", "--lr", "0.05", "--warmup_steps", "1", "--platform", "cpu"]
    (tmp_path / "dist").mkdir()
    ranks = spawn(_train_cli_worker, 2, tmp_path / "dist", ["--output_dir", str(tmp_path / "mesh"), *argv, "--mesh", "2x1"])
    stdout, stderr = sys.stdout, sys.stderr
    try:
        single = main(["--output_dir", str(tmp_path / "single"), *argv]).model.state_dict()
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    for k, v in single.items():
        torch.testing.assert_close(ranks[0][k], v, rtol=0, atol=1e-4)
        assert torch.equal(ranks[1][k], ranks[0][k])
    out = tmp_path / "mesh"
    assert (out / "done").exists() and sorted(p.name for p in (out / "ckpt").iterdir()) == ["2"]
    assert (out / "out.txt").read_text().count("Environment:") == 1


# --------------------------------------------------------------------------
# the sharded search


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _search_cases():
    """(name, database, queries, k, tile): 999 rows (not a multiple of the
    ranks) searched by their own first rows with k+1, and a database whose
    whole top-k lies at negative similarity in the padded last shard, where
    a zero padding row would score 0 ('ip') and evict them if it competed."""
    rng = np.random.default_rng(7)
    xb = _unit(rng, 999, 16)
    # multiples of 2^-6: every score is exact in fp32, so equal scores fall in
    # several shards and the merge must keep the lower global id
    ties = rng.integers(-2, 3, (999, 8)).astype(np.float32) / 64
    cases = [("999", xb, xb[:300], 6, None), ("999_tiles", xb, xb[:64], 6, 128), ("999_ties", ties, ties[:100], 9, None)]
    n, d = 963, 16  # 4 shards of 241: the last holds 240 rows and one zero row
    pad = np.zeros((n, d), np.float32)
    pad[:, 0] = -1.0 + rng.uniform(0, 1e-3, n)
    pad[:, 1] = rng.uniform(0, 1e-3, n)
    last = slice(3 * 241, n)
    pad[last, 0] = -0.5 + rng.uniform(0, 1e-3, n - 3 * 241)
    pad[last, 2] = 0.75
    pad /= np.linalg.norm(pad, axis=1, keepdims=True)
    q = np.zeros((5, d), np.float32)
    q[:, 0] = 1.0
    q[:, 3] = rng.uniform(0, 1e-3, 5)
    cases.append(("padding", pad, q / np.linalg.norm(q, axis=1, keepdims=True), 8, None))
    return cases


def _search_all(mesh):
    out = {}
    for name, xb, xq, k, tile in _search_cases():
        for metric in ("ip", "l2"):
            index = ExactKnnIndex(metric=metric, device=CPU, tile=tile, mesh=mesh)
            index.add(xb)
            out[name, metric] = index.search(xq, k)
    return out


def _search_worker(rank, world, tmp):
    return _search_all(get_mesh(world, 1, platform="cpu"))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return spawn(_search_worker, 4, tmp_path_factory.mktemp("search"))


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("case", ["999", "999_tiles", "999_ties"])
def test_sharded_search_matches_one_process(sharded, case, metric):
    """999 rows over 4 ranks, with the train split's k+1 self-exclusion;
    on exact ties, FAISS's order (numpy's stable sort) too."""
    ref_s, ref_i = _search_all(None)[case, metric]
    if case == "999_ties":
        _, xb, xq, k, _ = _search_cases()[2]
        np.testing.assert_array_equal(ref_i, numpy_search(xb, xq, k, metric)[1])
    for s, i in (r[case, metric] for r in sharded):
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_allclose(s, ref_s, rtol=0, atol=1e-6)
        member = np.ones(len(i), bool)
        member[::3] = False
        ex_s, ex_i = train_split_exclusion(s, i, None, member)
        ref_ex_s, ref_ex_i = train_split_exclusion(ref_s, ref_i, None, member)
        np.testing.assert_array_equal(ex_i, ref_ex_i)
        if case != "999_ties":  # unit rows: a member's first hit is itself, which the exclusion drops
            assert (ex_i[member] != np.flatnonzero(member)[:, None]).all()


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_sharded_padding_cannot_evict_real_neighbours(sharded, metric):
    """Mirror of tests/test_knn.py:98 for the port's shards."""
    _, xb, xq, k, _ = _search_cases()[-1]
    ref_s, ref_i = numpy_search(xb, xq, k, metric)
    assert (ref_i >= 3 * 241).all()  # the construction worked
    for r in sharded:
        s, i = r["padding", metric]
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_allclose(s, ref_s, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# run_lemon --mesh


def _run_lemon_worker(rank, world, tmp, argv):
    from lemon_tpu_torch.cli.run_lemon import main

    stdout, stderr = sys.stdout, sys.stderr
    try:
        main(argv)
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    return None


def test_run_lemon_mesh_matches_one_device(tmp_path):
    import pandas as pd

    from lemon_tpu_torch.cli.run_lemon import main

    (tmp_path / "dist").mkdir()
    spawn(_run_lemon_worker, 2, tmp_path / "dist", ["--output_dir", str(tmp_path / "mesh"), *DETECT_ARGV,
                                                       "--mesh", "2x1"])
    stdout, stderr = sys.stdout, sys.stderr
    try:
        main(["--output_dir", str(tmp_path / "single"), *DETECT_ARGV])
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    mesh, single = tmp_path / "mesh", tmp_path / "single"
    s1 = pd.read_csv(single / "know_val_labels_scores.csv")["pred_score"].to_numpy()
    s2 = pd.read_csv(mesh / "know_val_labels_scores.csv")["pred_score"].to_numpy()
    np.testing.assert_allclose(s2, s1, rtol=1e-4, atol=1e-5)
    a1, a2 = (pd.read_pickle(d / "res.pkl")["agg_results"]["know_val_labels"]["test"]["AUROC"] for d in (single, mesh))
    assert a2 == pytest.approx(a1, abs=1e-6)
    assert (mesh / "done").exists() and (mesh / "args.json").exists()
    assert (mesh / "out.txt").read_text().count("Environment:") == 1  # rank 1 wrote nothing there


# --------------------------------------------------------------------------
# one process


@pytest.fixture
def world_of_one():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_tensor_parallel_meshes_raise(tmp_path, world_of_one):
    """A tensor-parallel mesh is held to the world's size like any other:
    in a world of one, ``2x2`` raises in ``get_mesh`` and in both CLIs,
    naming the processes it needs (on four ranks it runs:
    tests/test_torch_tensor_parallel.py::test_tensor_parallel_mesh_groups)."""
    from lemon_tpu_torch.cli.run_lemon import main as run_lemon
    from lemon_tpu_torch.cli.train_clip import main as train_clip

    with pytest.raises(ValueError, match="mesh 2x2 needs 4 processes; the world has 1"):
        get_mesh(2, 2, platform="cpu")
    for main in (run_lemon, train_clip):
        with pytest.raises(ValueError, match="mesh 2x2 needs 4 processes"):
            main(["--output_dir", str(tmp_path), "--platform", "cpu", "--mesh", "2x2"])


def test_world_of_one(world_of_one):
    """Without the environment's variables a mesh is a world of one on a
    local store; a mesh the world cannot fill raises."""
    mesh = get_mesh(1, 1, platform="cpu")
    assert mesh == Mesh(data=1, model=1, rank=0, device=CPU) and dist.get_world_size() == 1
    assert get_mesh(-1, 1, platform="cpu").data == 1  # -1: the whole world
    with pytest.raises(ValueError, match="needs 2 processes"):
        get_mesh(2, 1, platform="cpu")
    assert parse_mesh("4X1") == (4, 1)


def _smaller_mesh_rank(rank, world, tmp):
    with pytest.raises(ValueError) as err:
        get_mesh(1, 1, platform="cpu")
    return str(err.value)


def test_a_mesh_smaller_than_the_world_is_refused_with_its_reason(tmp_path):
    """The JAX package takes the first ``data * model`` devices of one
    process; the port runs one process a device, so a rank past the mesh
    would have no work. The message says so and names the mesh that fits."""
    assert spawn(_smaller_mesh_rank, 2, tmp_path) == [
        "mesh 1x1 needs 1 processes; the world has 2. Each process drives one device of the mesh, so the mesh "
        "must span the world: start 1 processes, or pass --mesh 2x1"] * 2


def test_shard_batch_pads_with_zero_rows():
    x = np.arange(10, dtype=np.float32).reshape(5, 2) + 1
    parts = [shard_batch(x, Mesh(data=3, model=1, rank=r, device=CPU)) for r in range(3)]
    assert all(n == 5 and p.shape == (2, 2) for p, n in parts)
    np.testing.assert_array_equal(np.concatenate([p for p, _ in parts])[:5], x)
    assert not parts[2][0][1].any()  # the padding row is zeros
    t, n = shard_batch(torch.from_numpy(x), Mesh(data=2, model=1, rank=1, device=CPU))
    assert n == 5 and t.shape == (3, 2) and not t[-1].any()
