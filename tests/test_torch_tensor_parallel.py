"""Tensor parallelism of the port (``--mesh DATAxMODEL`` with MODEL > 1:
models/clip.py's Megatron split, train/contrastive.py's layout) against the
port in one process and the JAX package's single-device step.

The ranks are spawned gloo processes (tests/test_torch_mesh.spawn) and
import no JAX: the JAX package runs in the test's own process (imported
inside the fixture), and its weights reach the ranks as the port's state
dict (``models/convert.from_flax_params``) in a file. Two configurations:
``ClipConfig.tiny()``, whose one vision head the model axis cannot split
(its attention stays whole while its MLP splits), and the same with two
vision heads (every sublayer splits at ``model = 2``). Bars, those of
tests/test_torch_mesh.py and tests/test_train.py:116-145:

- the loss within 1e-4 of the single-process step on the global batch and
  of the JAX package's; SGD's parameters within 1e-4; AdamW's in units of
  the learning rate (every element within 2 x the rates summed over the
  steps, at most 1e-3 of them beyond 1e-4: tests/test_torch_train.py says
  why);
- the layout exactly: ``qkv`` split by heads of each of q, k and v, the
  gathered shards equal to the full state bit for bit, the replicated
  parameters bit-identical across the ranks after three steps;
- a checkpoint written under ``1x2`` is the single-process file and resumes
  under ``1x1`` (and one written by one process resumes under ``1x2``),
  equal to the uninterrupted run at SGD's bar;
- ``run_lemon --mesh 1x2``: the scores csv equal to the run without a mesh
  byte for byte, the files written once.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_mesh import DETECT_ARGV, spawn

from lemon_tpu_torch.core.mesh import Mesh, get_mesh, shard_batch
from lemon_tpu_torch.models.clip import ClipConfig, ClipModel
from lemon_tpu_torch.train.contrastive import (
    TrainConfig,
    create_train_state,
    make_schedule,
    make_train_step,
    restore_params,
    tp_layout,
)

CPU = torch.device("cpu")
TRAIN = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, batch_size=8)
CONFIGS = {"tiny": {}, "vision_heads_2": {"vision_heads": 2}}
OPTIMIZERS = ("sgd", "adamw")
STEPS = 3


def _cfg(name, cls=ClipConfig):
    return dataclasses.replace(cls.tiny(), **CONFIGS[name])


def _batch():
    cfg = ClipConfig.tiny()
    rng = np.random.default_rng(3)
    pixels = rng.standard_normal((8, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 2, (8, cfg.context_length)).astype(np.int32)
    tokens[:, -1] = cfg.vocab_size - 1
    return pixels, tokens


def _train(mesh, cfg_name, optimizer, state_dict):
    """Three steps from ``state_dict``: the losses, the full parameters
    after each step, the full state before the first (gathered under a
    mesh) and this rank's own tensors at the start and at the end."""
    model, state = create_train_state(_cfg(cfg_name), TrainConfig(**TRAIN, optimizer=optimizer), mesh=mesh,
                                      device=CPU, state_dict=state_dict)
    pixels, tokens = (torch.from_numpy(a) for a in _batch())
    tokens = tokens.long()
    if mesh is not None:
        pixels, tokens = shard_batch(pixels, mesh)[0], shard_batch(tokens, mesh)[0]
    local = lambda: {k: v.detach().clone() for k, v in model.state_dict().items()}  # noqa: E731
    start = state.state_dict()  # the replicated tensors are the live ones: copied
    start = {"model": {k: v.clone() for k, v in start["model"].items()},
             "opt_state": {k: [t.clone() for t in v] if isinstance(v, list) else v
                           for k, v in start["opt_state"].items()}}
    out = {"start": start, "local_start": local(), "loss": [], "params": []}
    step = make_train_step(model, mesh)
    for _ in range(STEPS):
        state, loss = step(state, pixels, tokens)
        out["loss"].append(float(loss))
        out["params"].append({k: v.clone() for k, v in state.state_dict()["model"].items()})
    out["local_end"] = local()
    out["layout"] = tp_layout(model)
    return out


def _tp_worker(rank, world, tmp, data, model):
    torch.set_num_threads(1)  # tiny models; four ranks share the test's cores
    mesh = get_mesh(data, model, platform="cpu")
    sums = {}
    for axis, group in (("data", mesh.data_group), ("model", mesh.model_group)):
        x = torch.tensor([float(rank)])
        dist.all_reduce(x, group=group)
        sums[axis] = (dist.get_process_group_ranks(group), float(x))
    weights = torch.load(tmp.parent / "weights.pt", weights_only=True)
    return {"place": (mesh.rank, mesh.model_rank), "lead": mesh.lead, "sums": sums,
            "reused": get_mesh(data, model, platform="cpu").model_group is mesh.model_group,
            "runs": {(c, o): _train(mesh, c, o, weights[c]) for c in CONFIGS for o in OPTIMIZERS}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's weights and single-device step for each
    configuration and optimizer, and the port's three single-process steps
    from those weights; the weights are written for the ranks."""
    import jax
    import jax.numpy as jnp

    from lemon_tpu.models.clip import ClipConfig as JaxClipConfig
    from lemon_tpu.train import contrastive as jax_train
    from lemon_tpu_torch.models.convert import from_flax_params

    root = tmp_path_factory.mktemp("tp")
    pixels, tokens = _batch()
    weights, jax_step = {}, {}
    for c in CONFIGS:
        jm, js = jax_train.create_train_state(_cfg(c, JaxClipConfig), jax_train.TrainConfig(**TRAIN))
        host = jax.tree_util.tree_map(np.asarray, js.params)
        weights[c] = from_flax_params(host)
        for o in OPTIMIZERS:  # the step donates its state: each optimizer starts from a copy
            tx = jax_train.make_optimizer(jax_train.TrainConfig(**TRAIN, optimizer=o))
            state = jax_train.TrainState.create(apply_fn=jm.apply, params=jax.tree_util.tree_map(jnp.asarray, host), tx=tx)
            state, loss = jax_train.make_train_step(jm)(state, jnp.asarray(pixels), jnp.asarray(tokens))
            jax_step[c, o] = (float(loss), from_flax_params(jax.tree_util.tree_map(np.asarray, state.params)))
    torch.save(weights, root / "weights.pt")
    single = {(c, o): _train(None, c, o, weights[c]) for c in CONFIGS for o in OPTIMIZERS}
    return {"root": root, "weights": weights, "jax": jax_step, "single": single}


@pytest.fixture(scope="module", params=["1x2", "2x2"])
def ranks(request, reference):
    data, model = map(int, request.param.split("x"))
    tmp = reference["root"] / request.param
    tmp.mkdir()
    return request.param, spawn(_tp_worker, data * model, tmp, data, model)


def _hold_params(got, want, optimizer, steps):
    diff = torch.cat([(got[k] - v).abs().reshape(-1) for k, v in want.items()])
    if optimizer == "sgd":
        assert float(diff.max()) < 1e-4
    else:
        lr = make_schedule(TrainConfig(**TRAIN))
        assert float(diff.max()) <= 2 * sum(lr(j) for j in range(steps))
        assert float((diff > 1e-4).float().mean()) <= 1e-3


def test_tensor_parallel_mesh_groups(ranks):
    """``get_mesh(data, model)`` lays the ranks out data-major, as the JAX
    package reshapes its devices: global rank ``d * model + m``, so under
    ``2x2`` the model groups are {0,1} and {2,3} and the data groups {0,2}
    and {1,3}, each summing over its own ranks; global rank 0 alone leads;
    a second mesh of the shape reuses the groups."""
    data, model = map(int, ranks[0].split("x"))
    for g, r in enumerate(ranks[1]):
        d, m = divmod(g, model)
        assert r["place"] == (d, m) and r["lead"] == (g == 0) and r["reused"]
        model_group = [d * model + i for i in range(model)]
        data_group = [i * model + m for i in range(data)]
        assert r["sums"]["model"] == (model_group, float(sum(model_group)))
        assert r["sums"]["data"] == (data_group, float(sum(data_group)))


def test_tp_steps_match_single_process(ranks, reference):
    """Three steps under ``1x2`` and ``2x2`` against one process on the
    global batch, every rank, each configuration and optimizer."""
    for (cfg, optimizer), single in reference["single"].items():
        for r in ranks[1]:
            run = r["runs"][cfg, optimizer]
            np.testing.assert_allclose(run["loss"], single["loss"], rtol=0, atol=1e-4)
            for i in range(STEPS):
                _hold_params(run["params"][i], single["params"][i], optimizer, i + 1)


def test_tp_step_matches_jax_single_device(ranks, reference):
    """The first step under the mesh against the JAX package's step on one
    device from the same weights (the bar of
    tests/test_train.py::test_tp_mesh_step_matches_single_device), each
    configuration and optimizer."""
    for (cfg, optimizer), (loss, params) in reference["jax"].items():
        for r in ranks[1]:
            run = r["runs"][cfg, optimizer]
            assert run["loss"][0] == pytest.approx(loss, abs=1e-4)
            _hold_params(run["params"][0], params, optimizer, 1)


def test_shards_split_by_heads_and_gather_to_the_full_state(ranks, reference):
    """Model rank m holds heads [m H/M, (m+1) H/M) of each of q, k and v
    (rows of ``qkv``) and their input columns of ``attn.out``; a tower whose
    heads the axis cannot split (tiny's one vision head) holds them whole.
    gather(shard(x)) == x for every parameter and every moment: the state
    a rank gathers before the first step is the single process's, bit for
    bit."""
    m_size = int(ranks[0].split("x")[1])
    for r in ranks[1]:
        m = r["place"][1]
        for c in CONFIGS:
            full, local = reference["weights"][c], r["runs"][c, "sgd"]["local_start"]
            for tower, heads in (("visual", _cfg(c).v_heads), ("text", _cfg(c).text_heads)):
                name = f"{tower}.blocks.0.attn"
                w, b = full[f"{name}.qkv.weight"], full[f"{name}.qkv.bias"]
                d = w.shape[1]
                if heads % m_size:
                    assert torch.equal(local[f"{name}.qkv.weight"], w)
                    assert torch.equal(local[f"{name}.out.weight"], full[f"{name}.out.weight"])
                    continue
                part = d // m_size
                rows = torch.cat([torch.arange(i * d + m * part, i * d + (m + 1) * part) for i in range(3)])
                assert torch.equal(local[f"{name}.qkv.weight"], w[rows])
                assert torch.equal(local[f"{name}.qkv.bias"], b[rows])
                assert torch.equal(local[f"{name}.out.weight"], full[f"{name}.out.weight"][:, m * part : (m + 1) * part])
                assert torch.equal(local[f"{name}.out.bias"], full[f"{name}.out.bias"])  # added once, after the sum
        for (c, o), run in r["runs"].items():
            want = reference["single"][c, o]["start"]
            assert run["start"]["model"].keys() == want["model"].keys()
            for k, v in want["model"].items():
                assert torch.equal(run["start"]["model"][k], v), k
            for key, moments in want["opt_state"].items():
                if isinstance(moments, list):
                    assert all(torch.equal(a, b) for a, b in zip(run["start"]["opt_state"][key], moments, strict=True))


def test_replicated_parameters_stay_bit_identical(ranks):
    """After three steps every replicated parameter is the same bits on
    every rank, and every shard the same bits across its data group."""
    ranks_ = ranks[1]
    for key in ranks_[0]["runs"]:
        layout = ranks_[0]["runs"][key]["layout"]
        assert layout  # the blocks are split
        for r in ranks_[1:]:
            a, b = ranks_[0]["runs"][key]["local_end"], r["runs"][key]["local_end"]
            for k in a:
                if k not in layout or r["place"][1] == ranks_[0]["place"][1]:
                    assert torch.equal(a[k], b[k]), (key, k, r["place"])


def test_a_sublayer_the_axis_cannot_split_stays_whole():
    """The divisibility fallback, each configuration at ``model`` 2 and 3:
    attention splits where the model axis divides the heads, the MLP where
    it divides the hidden width; no collective is built for a whole
    sublayer (its ``tp`` is None)."""
    for cfg in CONFIGS:
        for model in (2, 3):
            config = _cfg(cfg)
            shard = ClipModel(config, fp32_master=True, mesh=Mesh(data=1, model=model, rank=0, device=CPU))
            layout = tp_layout(shard)
            for tower, heads, width in (("visual", config.v_heads, config.vision_width),
                                        ("text", config.text_heads, config.text_width)):
                block = shard.get_submodule(f"{tower}.blocks.0")
                attn_split, mlp_split = heads % model == 0, 4 * width % model == 0
                assert (block.attn.tp is not None) == attn_split and (block.mlp_tp is not None) == mlp_split
                assert block.attn.qkv.weight.shape == (3 * width // (model if attn_split else 1), width)
                assert block.mlp_fc.weight.shape == (4 * width // (model if mlp_split else 1), width)
                assert (f"{tower}.blocks.0.attn.qkv.weight" in layout) == attn_split
                assert (f"{tower}.blocks.0.mlp_proj.weight" in layout) == mlp_split
                assert f"{tower}.blocks.0.mlp_proj.bias" not in layout
            if cfg == "tiny" and model == 2:  # the case named in the module docstring
                assert shard.visual.blocks[0].attn.tp is None and shard.visual.blocks[0].mlp_tp is not None


def test_fused_optimizer_is_refused_under_tensor_parallelism():
    mesh = Mesh(data=1, model=2, rank=0, device=CPU)
    with pytest.raises(ValueError, match="fused_optimizer under tensor parallelism"):
        create_train_state(ClipConfig.tiny(), TrainConfig(fused_optimizer=True), mesh=mesh)


# --------------------------------------------------------------------------
# the CLIs

CLI_ARGV = ["--dataset", "synthetic_caption", "--model_size", "tiny", "--batch_size", "8", "--save_interval", "2",
            "--optimizer", "sgd", "--lr", "0.05", "--warmup_steps", "1", "--platform", "cpu"]


def _quiet(main, argv):
    stdout, stderr = sys.stdout, sys.stderr
    try:
        return main(argv)
    finally:
        sys.stdout, sys.stderr = stdout, stderr


def _cli_worker(rank, world, tmp, root):
    """Under ``--mesh 1x2``: ``train_clip`` for 2 steps into ``written``,
    ``train_clip --resume`` of ``resumed`` (a one-process run of 2 steps) to
    4, and ``run_lemon`` into ``lemon``. Returns the resumed run's full
    state dict."""
    from lemon_tpu_torch.cli.run_lemon import main as run_lemon
    from lemon_tpu_torch.cli.train_clip import main as train_clip

    torch.set_num_threads(1)
    _quiet(train_clip, ["--output_dir", f"{root}/written", *CLI_ARGV, "--total_steps", "2", "--mesh", "1x2"])
    state = _quiet(train_clip, ["--output_dir", f"{root}/resumed", *CLI_ARGV, "--total_steps", "4", "--resume",
                                "--mesh", "1x2"])
    _quiet(run_lemon, ["--output_dir", f"{root}/lemon", *DETECT_ARGV, "--mesh", "1x2"])
    return state.state_dict()["model"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The CLIs under ``--mesh 1x2`` on two ranks (:func:`_cli_worker`),
    after the one-process run they resume."""
    from lemon_tpu_torch.cli.train_clip import main

    root = tmp_path_factory.mktemp("cli")
    _quiet(main, ["--output_dir", str(root / "resumed"), *CLI_ARGV, "--total_steps", "2"])
    (root / "dist").mkdir()
    return root, spawn(_cli_worker, 2, root / "dist", str(root))


def test_checkpoints_move_between_meshes(cli_runs):
    """A checkpoint written under ``1x2`` holds the single-process layout,
    loads through ``restore_params`` and resumes under ``1x1``; one written
    by one process resumes under ``1x2``; both end where the uninterrupted
    4-step run ends. The ``1x2`` run's files are written once."""
    import torch.distributed as dist

    from lemon_tpu_torch.cli.train_clip import main

    root, ranks = cli_runs
    written, resumed = root / "written", root / "resumed"
    single = _quiet(main, ["--output_dir", str(root / "whole"), *CLI_ARGV, "--total_steps", "4"]).model.state_dict()

    file_tp = torch.load(written / "ckpt" / "1" / "state.pt", weights_only=True)
    file_one = torch.load(resumed / "ckpt" / "1" / "state.pt", weights_only=True)
    assert {k: v.shape for k, v in file_tp["model"].items()} == {k: v.shape for k, v in file_one["model"].items()}
    assert [t.shape for t in file_tp["opt_state"]["trace"]] == [t.shape for t in file_one["opt_state"]["trace"]]
    ClipModel(ClipConfig.tiny()).load_state_dict(restore_params(written / "ckpt"))
    assert (written / "done").exists() and (written / "out.txt").read_text().count("Environment:") == 1
    try:
        after_tp = _quiet(main, ["--output_dir", str(written), *CLI_ARGV, "--total_steps", "4", "--resume",
                                 "--mesh", "1x1"]).model.state_dict()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for k, v in single.items():
        torch.testing.assert_close(after_tp[k], v, rtol=0, atol=1e-4)
        for r in ranks:
            torch.testing.assert_close(r[k], v, rtol=0, atol=1e-4)


def test_run_lemon_mesh_1x2_matches_no_mesh(cli_runs):
    """``run_lemon --mesh 1x2`` replicates the work over the model axis:
    the scores csv equals the run without a mesh byte for byte, and global
    rank 0 alone writes the files."""
    import pandas as pd

    from lemon_tpu_torch.cli.run_lemon import main

    root, _ = cli_runs
    _quiet(main, ["--output_dir", str(root / "single"), *DETECT_ARGV])
    mesh, single = root / "lemon", root / "single"
    name = "know_val_labels_scores.csv"
    assert (mesh / name).read_bytes() == (single / name).read_bytes()
    df1, df2 = (pd.read_pickle(d / "res.pkl")["df"] for d in (single, mesh))
    pd.testing.assert_frame_equal(df2, df1, check_exact=True)
    log = (mesh / "out.txt").read_text()
    assert log.count("Environment:") == 1 and log.count("kernel launches in this process") == 1
    assert (mesh / "done").exists() and (mesh / "args.json").exists()
