"""The port's contrastive trainer (lemon_tpu_torch.train, cli/train_clip.py)
against the JAX package's.

Both get the same weights (the JAX tree through ``from_flax_params``) and the
same batch, made from a seed with numpy. Bars:

- ``clip_loss`` and the schedule: 1e-6 (the schedule relative to its peak).
- fp32 steps: the losses within 1e-5. SGD's parameters within 1e-6. AdamW's
  first steps divide each gradient by its own root mean square, so an
  element whose gradient is rounding noise moves by up to about the
  learning rate with the sign of that noise, whatever the two programs agree
  on elsewhere (the key bias, whose exact gradient is 0 under the softmax,
  is such an element). So AdamW's parameters are held in units of the
  learning rate: every element within 2 x the rates summed over the steps,
  at most 1e-3 of the elements beyond 1e-6, and the 99.9th percentile of the
  difference under 1e-6.
- bf16 (bf16 products, fp32 master weights): the loss falls, every
  parameter stays fp32, and the loss stays within 5% of JAX bf16's over
  three steps. Two bf16 implementations round the features differently
  (per-row cosine 0.99996 between them on these inputs, as close as either
  is to fp32), and the logit scale (1/0.07) carries that into the loss: 1-3%
  measured after the updates. Those bars would pass an fp32 step too, so
  the step is also shown to compute in bf16: every projection's output is
  bf16, the first loss (the same weights, no update yet) is within 1e-3 of
  JAX bf16's (1.2e-4 measured; the fp32 loss is 1.9e-3 from it), and every
  loss is at least 5e-4 from the port's fp32 run (1.9e-3 to 2.1e-3
  measured; two fp32 runs agree to about 1e-6).
- ``BatchStream``: crop boxes and tokens equal JAX's; pixels within one
  uint8 level (the PIL crops are the same bytes; the device resizes differ in
  fp32 rounding).
- Checkpoints: a full-state resume equals the uninterrupted run at the JAX
  test's bar (rtol 1e-6, atol 1e-7, tests/test_train.py:271-300).
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemon_tpu.models.clip import ClipConfig as JaxClipConfig
from lemon_tpu.train import contrastive as jax_train
from lemon_tpu_torch.models.clip import ClipConfig
from lemon_tpu_torch.models.convert import from_flax_params
from lemon_tpu_torch.train.contrastive import (
    CheckpointWriter,
    TrainConfig,
    clip_loss,
    create_train_state,
    make_schedule,
    make_train_step,
    restore_params,
    save_checkpoint,
    train_loop,
)

CPU = torch.device("cpu")
LR = 1e-3


def make_batch(b, seed=0):
    cfg = JaxClipConfig.tiny()
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((b, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 2, (b, cfg.context_length)).astype(np.int32)
    tokens[:, -1] = cfg.vocab_size - 1
    return pixels, tokens


def _states(**kw):
    """The JAX (model, state) and the port's, from the JAX weights."""
    jm, js = jax_train.create_train_state(JaxClipConfig.tiny(), jax_train.TrainConfig(**kw))
    sd = from_flax_params(jax.tree_util.tree_map(np.asarray, js.params))
    pm, ps = create_train_state(ClipConfig.tiny(), TrainConfig(**kw), device=CPU, state_dict=sd)
    return jm, js, pm, ps


def _jax_state_dict(js):
    return from_flax_params(jax.tree_util.tree_map(np.asarray, js.params))


def _run_both(n_steps, **kw):
    """(jax losses, port losses, jax state dict, port state dict)."""
    jm, js, pm, ps = _states(**kw)
    jstep, pstep = jax_train.make_train_step(jm), make_train_step(pm)
    pixels, tokens = make_batch(8, seed=3)
    jl, pl = [], []
    for _ in range(n_steps):
        js, loss = jstep(js, jnp.asarray(pixels), jnp.asarray(tokens))
        jl.append(float(loss))
        ps, loss = pstep(ps, torch.from_numpy(pixels), torch.from_numpy(tokens).long())
        pl.append(float(loss))
    return np.array(jl), np.array(pl), _jax_state_dict(js), pm.state_dict()


def test_clip_loss_matches_jax():
    rng = np.random.default_rng(0)
    for logits in (rng.standard_normal((6, 6)).astype(np.float32) * 5, np.eye(4, dtype=np.float32) * 10,
                   np.zeros((4, 4), np.float32)):
        want = float(jax_train.clip_loss(jnp.asarray(logits), jnp.asarray(logits.T)))
        got = float(clip_loss(torch.from_numpy(logits), torch.from_numpy(logits.T.copy())))
        assert got == pytest.approx(want, abs=1e-6)
    assert float(clip_loss(torch.zeros(4, 4), torch.zeros(4, 4))) == pytest.approx(np.log(4), abs=1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (1, 10), (5, 3)])
def test_schedule_matches_optax(warmup, total):
    cfg = TrainConfig(learning_rate=5e-4, warmup_steps=warmup, total_steps=total)
    jcfg = jax_train.TrainConfig(learning_rate=5e-4, warmup_steps=warmup, total_steps=total)
    ours, theirs = make_schedule(cfg), jax_train.make_schedule(jcfg)
    decay_end = max(total, warmup + 1)
    counts = sorted({0, 1, warmup, warmup + 1, (warmup + decay_end) // 2, decay_end - 1, decay_end, decay_end + 7})
    for c in counts:
        assert ours(c) == pytest.approx(float(theirs(c)), rel=1e-6, abs=1e-6 * 5e-4), c
    if warmup:
        assert ours(0) == 0.0  # the first step's rate: read before the update


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_steps_match_jax(optimizer, n_steps):
    kw = dict(learning_rate=LR, warmup_steps=0, total_steps=10, batch_size=8, optimizer=optimizer)
    jl, pl, jsd, psd = _run_both(n_steps, **kw)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-5)
    assert set(psd) == set(jsd)
    diff = torch.cat([(psd[k] - jsd[k]).abs().reshape(-1) for k in jsd])
    if optimizer == "sgd":
        assert float(diff.max()) < 1e-6
        return
    schedule = make_schedule(TrainConfig(**kw))
    assert float(diff.max()) <= 2 * sum(schedule(i) for i in range(n_steps))
    assert float((diff > 1e-6).float().mean()) <= 1e-3
    assert float(diff.quantile(0.999)) < 1e-6


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_fused_optimizer_same_trajectory(optimizer):
    """``fused_optimizer`` (one flat vector, optax.flatten in JAX) is a
    layout: the same losses and parameters as the per-parameter update."""
    pixels, tokens = make_batch(8)
    out = {}
    for fused in (False, True):
        cfg = TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10, optimizer=optimizer, fused_optimizer=fused)
        model, state = create_train_state(ClipConfig.tiny(), cfg, device=CPU)
        step = make_train_step(model)
        losses = [float(step(state, torch.from_numpy(pixels), torch.from_numpy(tokens).long())[1]) for _ in range(4)]
        out[fused] = (losses, model.state_dict())
    np.testing.assert_allclose(out[False][0], out[True][0], rtol=0, atol=1e-6)
    for k, v in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], v, rtol=0, atol=1e-6)
    assert out[True][0][-1] < out[True][0][0]


def test_bf16_training_against_jax():
    from lemon_tpu_torch.models.clip import Linear

    kw = dict(learning_rate=LR, warmup_steps=0, total_steps=10, batch_size=8, precision="bf16")
    jl, pl, _, psd = _run_both(3, **kw)
    np.testing.assert_allclose(pl, jl, rtol=0.05)
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-3)
    _, fp32_losses, _, _ = _run_both(3, **{**kw, "precision": "fp32"})
    assert (np.abs(pl - fp32_losses) >= 5e-4 * fp32_losses).all(), (pl, fp32_losses)
    assert all(v.dtype == torch.float32 for v in psd.values())  # master weights stay fp32
    model, state = create_train_state(ClipConfig.tiny(), TrainConfig(**kw), device=CPU)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out_dtypes = []
    linears = [m for m in model.modules() if isinstance(m, Linear)]
    hooks = [m.register_forward_hook(lambda mod, args, out: out_dtypes.append(out.dtype)) for m in linears]
    step = make_train_step(model)
    pixels, tokens = make_batch(8)
    losses = [float(step(state, torch.from_numpy(pixels), torch.from_numpy(tokens).long())[1]) for _ in range(5)]
    for h in hooks:
        h.remove()
    assert linears and len(out_dtypes) == 5 * len(linears) and set(out_dtypes) == {torch.bfloat16}
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# --------------------------------------------------------------------------
# BatchStream


def _splits():
    from lemon_tpu.data.datasets import synthetic_captioning as jax_synth
    from lemon_tpu_torch.data.datasets import synthetic_captioning

    return jax_synth(60, data_seed=0, noise_level=0.0)[0], synthetic_captioning(60, data_seed=0, noise_level=0.0)[0]


def test_batch_stream_skip_matches_consumed():
    from lemon_tpu_torch.cli.train_clip import BatchStream

    _, split = _splits()
    a = BatchStream(split, 16, batch_size=8, image_size=32, seed=3, device=CPU)
    b = BatchStream(split, 16, batch_size=8, image_size=32, seed=3, device=CPU)
    for _ in range(5):
        next(a)
    b.skip(5)
    for _ in range(3):
        ba, bb = next(a), next(b)
        assert a.last_boxes == b.last_boxes
        torch.testing.assert_close(ba["pixels"], bb["pixels"], rtol=0, atol=0)
        np.testing.assert_array_equal(ba["tokens"], bb["tokens"])


def test_batch_stream_matches_jax():
    """The same shuffles, crop boxes and tokens as the JAX ``BatchStream``,
    pixels within one uint8 level (CLIP's normalisation divides by std)."""
    from lemon_tpu.cli import train_clip as jax_cli
    from lemon_tpu_torch.cli.train_clip import BatchStream
    from lemon_tpu_torch.ops.image import CLIP_STD

    jax_split, split = _splits()
    theirs = jax_cli.batch_iterator(jax_split, 16, batch_size=8, image_size=48, seed=5)
    ours = BatchStream(split, 16, batch_size=8, image_size=48, seed=5, device=CPU)
    level = 1.0 / 255.0 / np.asarray(CLIP_STD, np.float32)
    for step in range(8):  # crosses an epoch (6 batches of 8 in 48 rows)
        jb, pb = next(theirs), next(ours)
        np.testing.assert_array_equal(pb["tokens"], jb["tokens"])
        np.testing.assert_array_equal(ours._order, theirs._order)
        raw = split.images[ours._order[(ours._pos - 1) * 8 : ours._pos * 8]]
        boxes = [tuple(int(v) for v in jax_cli._rrc_box(np.random.default_rng(np.random.SeedSequence([5, step, s])),
                                                         img.shape[0], img.shape[1])) for s, img in enumerate(raw)]
        assert ours.last_boxes == boxes
        diff = np.abs(pb["pixels"].numpy() - np.asarray(jb["pixels"]))
        assert (diff <= level * (1 + 1e-4)).all(), diff.max()


def test_batch_stream_rank_rows_equal_the_whole_batch():
    """Under a mesh a rank builds only its rows, with their crops drawn at
    their slots in the whole batch: together the ranks' rows are one
    process's batch, bit for bit."""
    from lemon_tpu_torch.cli.train_clip import BatchStream
    from lemon_tpu_torch.core.mesh import Mesh

    _, split = _splits()
    whole = BatchStream(split, 16, batch_size=8, image_size=32, seed=1, device=CPU)
    ranks = [BatchStream(split, 16, batch_size=8, image_size=32, seed=1, device=CPU,
                         mesh=Mesh(data=4, model=1, rank=r, device=CPU)) for r in range(4)]
    for _ in range(3):
        wb, rbs = next(whole), [next(r) for r in ranks]
        torch.testing.assert_close(torch.cat([b["pixels"] for b in rbs]), wb["pixels"], rtol=0, atol=0)
        np.testing.assert_array_equal(np.concatenate([b["tokens"] for b in rbs]), wb["tokens"])


# --------------------------------------------------------------------------
# checkpoints, resume, preemption, filtering


def _tiny_state(**kw):
    cfg = TrainConfig(**{"warmup_steps": 1, "total_steps": 4, "batch_size": 4, **kw})
    return (*create_train_state(ClipConfig.tiny(), cfg, device=CPU), cfg)


def _batches(n=4, b=4):
    cfg = ClipConfig.tiny()
    rng = np.random.default_rng(0)
    return [{"pixels": rng.standard_normal((b, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32),
             "tokens": rng.integers(1, cfg.vocab_size, (b, cfg.context_length)).astype(np.int32)} for _ in range(n)]


def test_checkpoint_roundtrip_and_retention(tmp_path):
    model, state, _ = _tiny_state()
    save_checkpoint(tmp_path / "ckpt", state, step=1)
    restored = restore_params(tmp_path / "ckpt")
    assert restored.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(restored[k], v)
    fresh = type(model)(model.cfg)
    fresh.load_state_dict(restored)  # the registry's ClipModel takes it
    writer = CheckpointWriter(tmp_path / "ckpt")
    for step in (2, 3, 4, 5):
        writer.save(step, state)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["3", "4", "5"]
    assert writer.latest_step() == 5


def test_checkpoint_resave_replaces_the_step(tmp_path, monkeypatch):
    """A step saved again holds the new state, and a save that fails
    before its rename leaves the step's old checkpoint in place."""
    from lemon_tpu_torch.train import contrastive

    model, state, _ = _tiny_state()
    writer = CheckpointWriter(tmp_path / "ckpt")
    writer.save(2, state)
    first = writer.load(2)["model"]
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    writer.save(2, state)
    second = writer.load(2)["model"]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2"]
    for k, v in model.state_dict().items():
        assert torch.equal(second[k], v.cpu())
    assert not all(torch.equal(first[k], second[k]) for k in first)

    def crash(src, dst):
        raise OSError("crash before the rename")

    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    monkeypatch.setattr(contrastive.os, "replace", crash)
    with pytest.raises(OSError):
        writer.save(2, state)
    monkeypatch.undo()
    assert writer.latest_step() == 2
    kept = writer.load(2)["model"]
    assert all(torch.equal(kept[k], second[k]) for k in second)


def test_full_state_resume_equals_uninterrupted(tmp_path):
    batches = _batches()
    model, state, cfg = _tiny_state(save_interval=2)
    full = train_loop(model, state, iter(batches), cfg, ckpt_dir=tmp_path / "c1")
    # interrupted after the step-2 checkpoint, then resumed to the end
    model2, state2, _ = _tiny_state(save_interval=2)
    train_loop(model2, state2, iter(batches), dataclasses.replace(cfg, total_steps=3), ckpt_dir=tmp_path / "c2")
    model3, state3, _ = _tiny_state(save_interval=2)
    resumed = train_loop(model3, state3, iter(batches), cfg, ckpt_dir=tmp_path / "c2", resume=True)
    assert resumed.step == full.step == 4 and resumed.opt_state["count"] == 4
    for k, v in full.model.state_dict().items():
        np.testing.assert_allclose(resumed.model.state_dict()[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7)


def test_resume_of_a_finished_run_is_a_no_op(tmp_path):
    batches = _batches()
    model, state, cfg = _tiny_state(save_interval=2)
    train_loop(model, state, iter(batches), cfg, ckpt_dir=tmp_path / "c")
    files = {p: p.stat().st_mtime_ns for p in (tmp_path / "c").rglob("*")}
    model2, state2, _ = _tiny_state(save_interval=2)
    out = train_loop(model2, state2, iter(batches), cfg, ckpt_dir=tmp_path / "c", resume=True)
    assert out.step == 4  # restored, no step past total_steps
    assert {p: p.stat().st_mtime_ns for p in (tmp_path / "c").rglob("*")} == files


def test_preemption_roundtrip(tmp_path, monkeypatch):
    from lemon_tpu_torch.train import preemption

    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    monkeypatch.setenv("LEMON_TPU_PREEMPT_DIR", str(tmp_path))
    model, state, _ = _tiny_state()
    assert not preemption.has_checkpoint()
    assert preemption.save_checkpoint(model.state_dict(), step=7, extra={"rng": 123})
    assert preemption.has_checkpoint()
    restored, meta = preemption.load_checkpoint()
    assert meta["step"] == 7 and meta["rng"] == 123
    for k, v in model.state_dict().items():
        assert torch.equal(restored[k], v)
    monkeypatch.delenv("LEMON_TPU_PREEMPT_DIR")
    assert not preemption.save_checkpoint(model.state_dict(), step=8)


def _quiet(main, argv):
    stdout, stderr = sys.stdout, sys.stderr
    try:
        return main(argv)
    finally:
        sys.stdout, sys.stderr = stdout, stderr


def test_filter_indices_from_run_matches_jax(tmp_path):
    from lemon_tpu.train.filtering import filter_indices_from_run as jax_filter
    from lemon_tpu_torch.cli.run_lemon import main
    from lemon_tpu_torch.train.filtering import filter_indices_from_run

    _quiet(main, ["--output_dir", str(tmp_path), "--dataset", "synthetic_caption", "--noise_type", "random",
                  "--clip_model", "tiny", "--platform", "cpu", "--synthetic_n", "200"])
    for keep in (10, 57):
        ours = filter_indices_from_run(tmp_path, keep)
        np.testing.assert_array_equal(ours, jax_filter(tmp_path, keep))
        assert len(ours) == keep
    args = json.loads((tmp_path / "args.json").read_text())
    (tmp_path / "args.json").write_text(json.dumps({**args, "ablation": "multimodal_baseline"}))
    np.testing.assert_array_equal(filter_indices_from_run(tmp_path, 20), jax_filter(tmp_path, 20))


# --------------------------------------------------------------------------
# the CLI

CLI_ARGV = ["--dataset", "synthetic_caption", "--model_size", "tiny", "--batch_size", "8", "--total_steps", "4",
            "--save_interval", "2"]


def test_train_clip_cli_outputs_and_resume(tmp_path):
    from lemon_tpu_torch.cli.train_clip import main

    out = tmp_path / "run"
    state = _quiet(main, ["--output_dir", str(out), *CLI_ARGV, "--platform", "cpu"])
    for name in ("args.json", "out.txt", "done"):
        assert (out / name).exists(), name
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == ["2", "3"]
    assert state.step == 4 and "step 0: loss" in (out / "out.txt").read_text()
    assert json.loads((out / "args.json").read_text())["platform"] == "cpu"
    before = {p: p.stat().st_mtime_ns for p in (out / "ckpt").rglob("*")}
    again = _quiet(main, ["--output_dir", str(out), *CLI_ARGV, "--platform", "cpu", "--resume"])
    assert again.step == 4 and "already trained to step 3" in (out / "out.txt").read_text()
    assert {p: p.stat().st_mtime_ns for p in (out / "ckpt").rglob("*")} == before
    for k, v in state.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v)


def test_train_clip_cli_resume_equals_uninterrupted(tmp_path):
    """2n steps against n steps and ``--resume`` to 2n through the CLI: the
    resumed stream skips the consumed batches (``BatchStream.skip``). The
    rate of the first steps does not depend on ``--total_steps`` while they
    are in the warmup (1000 steps by default)."""
    from lemon_tpu_torch.cli.train_clip import main

    argv = ["--dataset", "synthetic_caption", "--model_size", "tiny", "--batch_size", "8", "--save_interval", "100",
            "--platform", "cpu"]
    full = _quiet(main, ["--output_dir", str(tmp_path / "a"), *argv, "--total_steps", "4"])
    _quiet(main, ["--output_dir", str(tmp_path / "b"), *argv, "--total_steps", "2"])
    resumed = _quiet(main, ["--output_dir", str(tmp_path / "b"), *argv, "--total_steps", "4", "--resume"])
    for k, v in full.model.state_dict().items():
        np.testing.assert_allclose(resumed.model.state_dict()[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7)


def test_train_clip_needs_a_card_unless_told(tmp_path, monkeypatch):
    from lemon_tpu_torch.cli.train_clip import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _quiet(main, ["--output_dir", str(tmp_path), *CLI_ARGV])
    assert not (tmp_path / "done").exists()
