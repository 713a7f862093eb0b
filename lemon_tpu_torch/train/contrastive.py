"""Contrastive CLIP training (port of lemon_tpu/train/contrastive.py).

- Symmetric InfoNCE: the mean of the image->text and text->image
  cross-entropies against the batch diagonal (train_clip_from_scratch.py:161-167).
- **Global-batch semantics under data parallelism** (``--mesh Dx1``): each
  rank embeds its rows of the batch and all-gathers the normalised features
  with their gradient (core/mesh.all_gather_with_grad), so every rank
  computes the single-device (B, B) InfoNCE over the whole batch. Each rank
  back-propagates ``loss / world`` and the gradients are summed over the
  ranks: every rank then holds the single-process gradient and takes the
  single-process step.
- **Tensor parallelism** (``--mesh DxM``, ``M > 1``; JAX:
  ``train_state_shardings``, :91-136): every rank builds the full model
  from the seed (or the state dict) and keeps its shard (models/clip.py's
  Megatron split; :func:`tp_layout`). The features are gathered and the
  gradients summed over the data group only: a shard's gradient is whole
  on its rank, and the replicated parameters' gradients are equal across
  a model group. The optimizer is elementwise, so its moments stay
  sharded beside their parameters.
- AdamW (optax's defaults: b1 0.9, b2 0.999, eps 1e-8, decay ``lr·wd·p`` on
  every parameter) or SGD with momentum (``trace = g + m·trace``), at the
  rate of optax's ``warmup_cosine_decay_schedule`` read at the update count
  before the update, so the first step's rate is 0 when there is a warmup.
- Checkpoints: ``torch.save`` of the model's state dict, the optimizer state
  and the step, one directory per step under ``<output_dir>/ckpt``, written
  synchronously and atomically (temporary directory + ``os.replace``) by
  rank 0, keeping the last 3. Under tensor parallelism the shards are
  gathered first, so the file is the one a single process writes, and a
  restore splits it for any mesh. JAX writes orbax checkpoints asynchronously
  from every host; the port's files are torch's (ROADMAP: handled
  divergences).

The towers train on the plain attention route: the JAX trainer uses its
XLA attention (lemon_tpu/models/clip.py:58), whose Pallas kernel has no
backward. No kernel of the port runs in training.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from lemon_tpu_torch.core.mesh import Mesh, all_gather_with_grad
from lemon_tpu_torch.core.precision import Precision
from lemon_tpu_torch.models.clip import Attention, ClipConfig, ClipModel, init_weights

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 5e-5
    weight_decay: float = 0.05
    optimizer: str = "adamw"  # 'adamw' | 'sgd'
    momentum: float = 0.9
    warmup_steps: int = 1000
    total_steps: int = 100_000
    batch_size: int = 256
    save_interval: int = 5000
    seed: int = 0
    # 'fp32' (reference parity) | 'bf16' (bf16 compute, fp32 master weights and LayerNorm)
    precision: str = "fp32"
    # the optimizer over one flattened vector of every parameter (optax.flatten
    # in JAX): identical math, another layout of the optimizer state, so a
    # resume must use the same setting
    fused_optimizer: bool = False


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, decay_steps)``
    with ``decay_steps = max(total_steps, warmup_steps + 1)``: linear from 0
    over the warmup, then a cosine to 0."""
    return warmup_cosine_decay_schedule(0.0, cfg.learning_rate, cfg.warmup_steps,
                                        max(cfg.total_steps, cfg.warmup_steps + 1))


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule(init_value, decay_steps)``: a cosine
    from ``init_value`` at count 0 to 0 at ``decay_steps``, 0 after."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        return init_value * 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(init, peak, warmup, decay_steps)``
    with ``end_value`` 0: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then :func:`cosine_decay_schedule` over the remaining
    ``decay_steps - warmup_steps`` (which must be positive, as optax asks),
    read at ``count - warmup_steps``."""
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        return cosine(count - warmup_steps)

    return schedule


class Optimizer:
    """AdamW (``kind="adamw"``) or SGD with momentum (``"sgd"``), as optax
    chains them, at the rate ``schedule(count)`` read before the update,
    over a list of parameters updated in place. AdamW decays every
    parameter by ``lr·weight_decay·p``; SGD has no decay, as ``optax.sgd``.
    The state is ``{"count", ...}`` with one moment tensor per parameter, or
    one flat tensor of every parameter when ``fused``."""

    def __init__(self, kind: str, schedule: Callable[[int], float], weight_decay: float = 0.0,
                 momentum: float = 0.9, fused: bool = False):
        if kind not in ("adamw", "sgd"):
            raise ValueError(kind)
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.fused = fused

    def _layout(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.cat([t.reshape(-1) for t in tensors])] if self.fused else list(tensors)

    def init(self, params: List[torch.Tensor]) -> Dict:
        zeros = lambda: [torch.zeros_like(t) for t in self._layout([p.detach() for p in params])]  # noqa: E731
        if self.kind == "adamw":
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        return {"count": 0, "trace": zeros()}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict) -> None:
        lr = self.schedule(state["count"])
        p, g = self._layout([q.detach() for q in params]), self._layout(grads)
        if self.kind == "adamw":
            mu, nu = state["mu"], state["nu"]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
            count = state["count"] + 1
            mu_hat = torch._foreach_div(mu, float(np.float32(1.0 - ADAM_B1 ** count)))
            nu_hat = torch._foreach_div(nu, float(np.float32(1.0 - ADAM_B2 ** count)))
            torch._foreach_sqrt_(nu_hat)
            torch._foreach_add_(nu_hat, ADAM_EPS)
            upd = torch._foreach_div(mu_hat, nu_hat)
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        else:
            trace = state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            upd = trace
        torch._foreach_add_(p, upd, alpha=-lr)
        if self.fused:
            flat = p[0].split([q.numel() for q in params])
            torch._foreach_copy_([q.detach() for q in params], [f.view_as(q) for f, q in zip(flat, params)])
        state["count"] += 1


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg.optimizer, make_schedule(cfg), cfg.weight_decay, cfg.momentum, cfg.fused_optimizer)


def clip_loss(logits_per_image: torch.Tensor, logits_per_text: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE against the diagonal (train_clip_from_scratch.py:161-167),
    each half as optax's ``softmax_cross_entropy_with_integer_labels``
    computes it: ``logsumexp(row) - row[label]``, averaged. (No NLL loss,
    which has no deterministic CUDA implementation.)"""
    li = (torch.logsumexp(logits_per_image, dim=1) - logits_per_image.diagonal()).mean()
    lt = (torch.logsumexp(logits_per_text, dim=1) - logits_per_text.diagonal()).mean()
    return (li + lt) / 2.0


def _tp_spec(name: str) -> Optional[Tuple[int, int]]:
    """How the tensor-parallel layout splits the parameter ``name`` of a
    ``ClipModel`` (JAX's ``_tp_spec``, keyed on the name's suffix):
    ``(dim, groups)``, the dimension of torch's ``(out, in)`` layout and the
    number of blocks it holds, each split alike (3 for the fused ``[q | k |
    v]`` rows, split by heads); None when replicated. A row-parallel bias is
    replicated: it is added once, after the sum."""
    if name.endswith(("attn.qkv.weight", "attn.qkv.bias")):
        return 0, 3
    if name.endswith(("mlp_fc.weight", "mlp_fc.bias")):
        return 0, 1
    if name.endswith(("attn.out.weight", "mlp_proj.weight")):
        return 1, 1
    return None


def tp_layout(model: ClipModel) -> Dict[str, Tuple[int, int]]:
    """``{name: (dim, groups)}`` of every parameter ``model`` holds split
    (JAX's ``train_state_shardings``): the divisibility fallback is the
    model's own, which builds a sublayer whole where the model axis does not
    divide its heads or hidden width. Empty without tensor parallelism."""
    layout = {}
    for name, _ in model.named_parameters():
        spec = _tp_spec(name)
        if spec is not None:
            owner = model.get_submodule(name.rsplit(".", 2)[0])  # the Attention, or the block of an MLP layer
            if (owner.tp if isinstance(owner, Attention) else owner.mlp_tp) is not None:
                layout[name] = spec
    return layout


def _shard(t: torch.Tensor, spec: Tuple[int, int], mesh: Mesh) -> torch.Tensor:
    """This rank's part of the full ``t`` on the mesh's model axis (a copy)."""
    dim, groups = spec
    shape, size = t.shape, mesh.model
    blocks = t.reshape(*shape[:dim], groups, size, shape[dim] // (groups * size), *shape[dim + 1 :])
    return blocks.select(dim + 1, mesh.model_rank).reshape(*shape[:dim], shape[dim] // size, *shape[dim + 1 :]).clone()


def _unshard(parts: List[torch.Tensor], spec: Tuple[int, int]) -> torch.Tensor:
    """The full tensor of every model rank's part, in model-rank order."""
    dim, groups = spec
    shape = parts[0].shape
    blocks = torch.stack([p.reshape(*shape[:dim], groups, shape[dim] // groups, *shape[dim + 1 :]) for p in parts],
                         dim + 1)
    return blocks.reshape(*shape[:dim], shape[dim] * len(parts), *shape[dim + 1 :])


def _gather_shard(t: torch.Tensor, spec: Tuple[int, int], mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return _unshard(parts, spec)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the state's), the optimizer and its
    state, and the number of steps taken. Under a mesh with ``model > 1``
    the model and the moments hold this rank's shards; :meth:`state_dict`
    and :meth:`load_state_dict` speak the full, single-process form."""

    model: ClipModel
    tx: Optimizer
    opt_state: Dict
    step: int = 0
    mesh: Optional[Mesh] = None

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return list(self.model.parameters())

    def _names(self) -> List[str]:
        return [name for name, _ in self.model.named_parameters()]  # the order of the moments' lists

    def state_dict(self) -> Dict:
        """The full state. Under tensor parallelism the shards are gathered
        over the model group: every rank of the group must call it."""
        layout = tp_layout(self.model)
        model, opt_state = self.model.state_dict(), self.opt_state
        if layout:
            model = {k: _gather_shard(v, layout[k], self.mesh) if k in layout else v for k, v in model.items()}
            opt_state = {k: [_gather_shard(t, layout[n], self.mesh) if n in layout else t
                             for n, t in zip(self._names(), v)] if isinstance(v, list) else v
                         for k, v in opt_state.items()}
        return {"model": model, "opt_state": opt_state, "step": self.step}

    def load_state_dict(self, blob: Dict) -> None:
        """Load a full state; under tensor parallelism this rank keeps its
        shards."""
        layout = tp_layout(self.model)
        split = (lambda n, t: _shard(t, layout[n], self.mesh) if n in layout else t)  # noqa: E731
        self.model.load_state_dict({k: split(k, v) for k, v in blob["model"].items()})
        device = self.params[0].device
        self.opt_state = {k: [split(n, t).to(device) for n, t in zip(self._names(), v)] if isinstance(v, list) else v
                          for k, v in blob["opt_state"].items()}
        self.step = int(blob["step"])


def create_train_state(model_cfg: ClipConfig, train_cfg: TrainConfig, mesh: Optional[Mesh] = None,
                       device: Optional[torch.device] = None, state_dict: Optional[Dict] = None):
    """(model, state): fp32 master weights from ``init_weights(seed)``, or
    ``state_dict`` when given (the same on every rank, so the replicas
    start equal), on the mesh's device or ``device``. Under tensor
    parallelism every rank builds the full model so and keeps its shard,
    so a run starts from the single-process run's weights."""
    if device is None:
        if mesh is None:
            raise ValueError("create_train_state needs a mesh or a device")
        device = mesh.device
    tp = mesh is not None and mesh.model > 1
    if tp and train_cfg.fused_optimizer:
        raise ValueError("fused_optimizer under tensor parallelism: its flat state over this rank's shards has no "
                         "checkpoint form")
    precision = Precision.bf16() if train_cfg.precision == "bf16" else Precision()
    model = ClipModel(model_cfg, precision, fp32_master=True)
    if state_dict is None:
        init_weights(model, seed=train_cfg.seed)
    else:
        model.load_state_dict(state_dict)
    if tp:
        full = model.state_dict()
        model = ClipModel(model_cfg, precision, fp32_master=True, mesh=mesh)
        layout = tp_layout(model)
        model.load_state_dict({k: _shard(v, layout[k], mesh) if k in layout else v for k, v in full.items()})
    model.to(device).train()
    tx = make_optimizer(train_cfg)
    return model, TrainState(model=model, tx=tx, opt_state=tx.init(list(model.parameters())), mesh=mesh)


def _all_reduce_grads(grads: List[torch.Tensor], group=None) -> None:
    """Sum the gradients over ``group``'s ranks (None: the default group),
    in one collective."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)])


def make_train_step(model: ClipModel, mesh: Optional[Mesh] = None):
    """``step(state, pixels, tokens) -> (state, loss)``, one update in
    place. Without a mesh ``pixels`` and ``tokens`` are the batch; with one,
    this rank's rows of it (the same on every rank of a model group), and
    the loss is the global batch's. The profiler ranges ``forward``,
    ``backward`` and ``optimizer`` split the step."""
    params = list(model.parameters())

    def step(state: TrainState, pixels: torch.Tensor, tokens: torch.Tensor):
        for p in params:
            p.grad = None
        with record_function("forward"):
            if mesh is None:
                loss = clip_loss(*model(pixels, tokens))
                scaled = loss
            else:
                img, txt = model.features(pixels, tokens)
                group = mesh.data_group
                loss = clip_loss(*model.logits(all_gather_with_grad(img, group), all_gather_with_grad(txt, group)))
                scaled = loss / mesh.data
        with record_function("backward"):
            scaled.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            if mesh is not None:
                _all_reduce_grads(grads, mesh.data_group)
        with record_function("optimizer"):
            state.tx.update(params, grads, state.opt_state)
        state.step += 1
        return state, loss.detach()

    return step


# ---------------------------------------------------------------------------
# checkpoints (torch.save, synchronous, rank 0)


def _step_dirs(ckpt_dir: Path) -> List[int]:
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(p.name) for p in ckpt_dir.iterdir() if p.is_dir() and p.name.isdigit())


class CheckpointWriter:
    """One directory per step, ``<ckpt_dir>/<step>/state.pt``, holding the
    full state (model, optimizer state, step) for an exact resume. Rank 0
    writes each into a temporary directory and renames it into place (the
    file alone when the step is saved again), so a reader never sees a
    partial checkpoint, nor no checkpoint of a step that had one; the last
    ``max_to_keep`` stay. Under tensor parallelism the ranks of rank 0's
    model group gather the full state first (a collective of theirs).
    Under several ranks every rank waits for the write (a barrier)."""

    def __init__(self, ckpt_dir: Path, max_to_keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.max_to_keep = max_to_keep

    def save(self, step: int, state: TrainState) -> None:
        multi = dist.is_initialized() and dist.get_world_size() > 1
        writes = not dist.is_initialized() or dist.get_rank() == 0
        mesh = state.mesh
        if writes or (mesh is not None and mesh.model > 1 and mesh.rank == 0):
            blob = state.state_dict()
        if writes:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
            tmp = self.ckpt_dir / f".tmp-{step}-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            blob = {"model": {k: v.cpu() for k, v in blob["model"].items()},
                    "opt_state": {k: [t.cpu() for t in v] if isinstance(v, list) else v
                                  for k, v in blob["opt_state"].items()},
                    "step": blob["step"]}
            torch.save(blob, tmp / "state.pt")
            final = self.ckpt_dir / str(step)
            if final.is_dir():  # a step saved again: its file is replaced in place
                os.replace(tmp / "state.pt", final / "state.pt")
                tmp.rmdir()
            else:
                os.replace(tmp, final)
            for old in _step_dirs(self.ckpt_dir)[: -self.max_to_keep]:
                shutil.rmtree(self.ckpt_dir / str(old))
        if multi:
            dist.barrier()

    def latest_step(self) -> Optional[int]:
        steps = _step_dirs(self.ckpt_dir)
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None) -> Dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.ckpt_dir}")
        return torch.load(self.ckpt_dir / str(step) / "state.pt", map_location="cpu", weights_only=True)

    def restore(self, template_state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load the checkpoint into ``template_state`` (its model, device
        and mesh: a checkpoint written under any mesh resumes under any
        other) and return it."""
        template_state.load_state_dict(self.load(step))
        return template_state


def save_checkpoint(ckpt_dir: Path, state: TrainState, step: int) -> None:
    CheckpointWriter(ckpt_dir).save(step, state)


def restore_params(ckpt_dir: Path, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The model's state dict of a checkpoint (the latest when ``step`` is
    None), for ``ClipModel.load_state_dict``."""
    return CheckpointWriter(ckpt_dir).load(step)["model"]


def train_loop(
    model: ClipModel,
    state: TrainState,
    batches: Iterator[Dict[str, np.ndarray]],
    train_cfg: TrainConfig,
    mesh: Optional[Mesh] = None,
    ckpt_dir: Optional[Path] = None,
    log_every: int = 100,
    resume: bool = False,
) -> TrainState:
    """Run ``train_cfg.total_steps`` steps over ``batches``, which yield
    ``{'pixels': (B, H, W, 3) float32, 'tokens': (B, L) int}``; under a mesh
    each holds this rank's ``B / data`` rows (``BatchStream(mesh=...)``
    builds only those). With
    ``resume`` and a checkpoint under ``ckpt_dir``, the latest full state is
    restored and training continues after its step; the consumed batches
    are skipped (``batches.skip`` replays only the data order), so the data
    matches an uninterrupted run. A finished run resumes as a no-op. The
    final state is saved whatever ends the loop, labelled with the last
    step that completed."""
    step_fn = make_train_step(model, mesh=mesh)
    rows = train_cfg.batch_size if mesh is None else train_cfg.batch_size // mesh.data
    if mesh is not None and train_cfg.batch_size % mesh.data:
        raise ValueError(f"batch_size {train_cfg.batch_size} is not a multiple of the data axis ({mesh.data})")
    writer = CheckpointWriter(ckpt_dir) if ckpt_dir is not None else None
    device = state.params[0].device
    start_step = 0
    if resume and writer is not None and writer.latest_step() is not None:
        state = writer.restore(state)
        start_step = writer.latest_step() + 1
        print(f"resumed from step {writer.latest_step()}")
    if start_step >= train_cfg.total_steps:
        # without the clamp the loop would train past total_steps and
        # rewrite the checkpoints on every rerun
        print(f"already trained to step {start_step - 1} (total_steps={train_cfg.total_steps})")
        return state
    last_step = start_step - 1
    last_saved = None
    try:
        if start_step > 0 and hasattr(batches, "skip"):
            batches.skip(start_step)
            batches = enumerate(batches, start=start_step)
        else:
            batches = enumerate(batches)
        for step_idx, batch in batches:
            if step_idx < start_step:
                continue
            if len(batch["tokens"]) != rows:
                raise ValueError(f"a batch of {len(batch['tokens'])} rows where this rank takes {rows}")
            pixels = torch.as_tensor(batch["pixels"]).to(device)
            tokens = torch.as_tensor(batch["tokens"]).to(device).long()
            state, loss = step_fn(state, pixels, tokens)
            # only after the step: a failure inside it must not let the
            # final save label the pre-step state with this step
            last_step = step_idx
            if step_idx % log_every == 0:
                print(f"step {step_idx}: loss {float(loss):.4f}", flush=True)
            if writer is not None and step_idx > 0 and step_idx % train_cfg.save_interval == 0:
                writer.save(step_idx, state)
                last_saved = step_idx
            if step_idx + 1 >= train_cfg.total_steps:
                break
    finally:
        # the last completed step is always saved (the interval save misses
        # the tail); on the failure path a failed save must not hide the error
        if writer is not None and last_step >= start_step and last_saved != last_step:
            try:
                writer.save(last_step, state)
            except Exception as e:  # pragma: no cover - abort path
                print(f"[lemon_tpu_torch] WARNING: final checkpoint save failed: {e}")
    return state
