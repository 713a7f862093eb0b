"""Process mesh on ``torch.distributed`` (port of lemon_tpu/core/mesh.py).

One process drives one device: NCCL on ``cuda:LOCAL_RANK``, or gloo on the
CPU (``platform="cpu"``). A mesh is ``data x model`` processes:

- ``data``  : the batch and query axis (pure data parallelism), and the
  database axis of the sharded kNN search (knn/index.py);
- ``model`` : tensor parallelism (Megatron's split of the transformer
  blocks, models/clip.py; train/contrastive.py keeps the layout).

Ranks are laid out data-major, as the JAX package reshapes its devices
(lemon_tpu/core/mesh.py:42): global rank ``d * model + m``, so a model
group is ``model`` neighbouring ranks (neighbouring cards of a node). With
``model > 1`` every rank builds every data group and every model group
(``dist.new_group``, in one order); with ``model == 1`` the data axis is the
default group and no group is built.

:func:`distributed_init` joins the world that the environment describes
(torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
``MASTER_PORT``, or the JAX package's ``LEMON_TPU_COORDINATOR`` with
``SLURM_NTASKS``/``SLURM_PROCID`` or ``LEMON_TPU_NUM_PROCS``/
``LEMON_TPU_PROC_ID``); without them it builds a world of one on a local
store. A process group that the caller initialised already is used as it
is. A mesh of one process runs the same collectives as a larger one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from lemon_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"  # the batch, query and database axis, as the JAX package names it


def _env_int(*names: str, default: Optional[int] = None) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return default


def distributed_init(platform: str = "cuda") -> bool:
    """Join (or build) the default process group for ``platform``'s backend:
    NCCL on the card, gloo on the CPU. Returns True when the environment
    described a world of several processes (or the group was up already),
    False when a world of one was built. On the card the process takes
    ``cuda:LOCAL_RANK`` and the NCCL communicator is created here, so an
    init that fails raises here."""
    device = resolve_device(platform)
    if dist.is_initialized():
        return True
    backend = "nccl" if device.type == "cuda" else "gloo"
    coord = os.environ.get("LEMON_TPU_COORDINATOR")
    if os.environ.get("RANK") and os.environ.get("WORLD_SIZE"):  # torchrun
        rank, world, init = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), {"init_method": "env://"}
    elif coord:
        rank = _env_int("SLURM_PROCID", "LEMON_TPU_PROC_ID", default=0)
        world = _env_int("SLURM_NTASKS", "LEMON_TPU_NUM_PROCS", default=1)
        init = {"init_method": f"tcp://{coord}"}
    else:
        rank, world, init = 0, 1, {"store": dist.HashStore()}
    kwargs = {}
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK", "SLURM_LOCALID", default=rank % torch.cuda.device_count())
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, rank=rank, world_size=world, **init, **kwargs)
    return world > 1


def shutdown() -> None:
    """Destroy the default process group if one is up (a CLI's exit)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data x model`` processes of the default group; ``rank`` is this
    process's place on the data axis, ``model_rank`` its place on the model
    axis, ``device`` the one it drives. ``data_group`` (the ranks of this
    model rank, one per data rank) and ``model_group`` (the ranks of this
    data rank) are None where the default group is meant: the data axis of
    a mesh with ``model == 1``, and no model group there."""

    data: int
    model: int
    rank: int
    device: torch.device
    model_rank: int = 0
    data_group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def lead(self) -> bool:
        """Global rank 0: the one process that writes a run's files."""
        return self.rank == 0 and self.model_rank == 0


def parse_mesh(text: str):
    """``"DATAxMODEL"`` (the CLIs' ``--mesh``) -> ``(data, model)``."""
    d, m = text.lower().split("x")
    return int(d), int(m)


# (data, model) -> (the default group they were built in, data groups, model groups)
_GROUPS: dict = {}


def _subgroups(data: int, model: int):
    """Every data group and every model group of a ``data x model`` mesh,
    built once per default group: ``new_group`` is called by every rank in
    the same order, so a second mesh of the same shape reuses them."""
    world = dist.group.WORLD
    cached = _GROUPS.get((data, model))
    if cached is None or cached[0] is not world:
        data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
        model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
        cached = _GROUPS[data, model] = (world, data_groups, model_groups)
    return cached[1], cached[2]


def get_mesh(data: int = -1, model: int = 1, platform: str = "cuda") -> Mesh:
    """The ``data x model`` mesh over the world's processes (joined or built
    by :func:`distributed_init`), data-major. ``data=-1`` takes the whole
    world. Raises ``ValueError`` when the mesh is not the world's size: each
    process drives one device of the mesh, so a rank past it would have no
    work. (The JAX package, one process over many devices, takes the first
    ``data * model`` of them; ROADMAP: handled divergences.)"""
    distributed_init(platform)
    world = dist.get_world_size()
    data = world // model if data == -1 else data
    if data * model != world:
        fits = f"{world // model}x{model}" if world % model == 0 else f"{world}x1"
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes; the world has {world}. "
                         f"Each process drives one device of the mesh, so the mesh must span the world: "
                         f"start {data * model} processes, or pass --mesh {fits}")
    device = resolve_device(platform)
    if model == 1:
        return Mesh(data=data, model=1, rank=dist.get_rank(), device=device)
    rank, model_rank = divmod(dist.get_rank(), model)
    data_groups, model_groups = _subgroups(data, model)
    return Mesh(data=data, model=model, rank=rank, device=device, model_rank=model_rank,
                data_group=data_groups[model_rank], model_group=model_groups[rank])


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(x, mesh: Mesh):
    """This rank's rows of ``x`` zero-padded on its leading axis to a
    multiple of the data axis. Returns ``(rows, original_length)``; the
    caller drops the padding rows after :func:`all_gather_rows`."""
    n = x.shape[0]
    per = pad_to_multiple(n, mesh.data) // mesh.data
    rows = x[mesh.rank * per : (mesh.rank + 1) * per]
    if rows.shape[0] < per:
        pad = per - rows.shape[0]
        if isinstance(rows, torch.Tensor):
            rows = torch.cat([rows, rows.new_zeros((pad, *rows.shape[1:]))])
        else:
            rows = np.concatenate([rows, np.zeros((pad, *rows.shape[1:]), rows.dtype)])
    return rows, n


def all_gather_rows(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) of ``group`` (None: the
    default group) concatenated in rank order on the leading axis; no
    gradient."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _GatherWithGrad(torch.autograd.Function):
    """:func:`all_gather_rows` whose backward sums the gradient of the
    gathered rows over the group's ranks and returns this rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.group = x.shape[0], group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        start = dist.get_rank(ctx.group) * ctx.rows
        return grad[start : start + ctx.rows], None


def all_gather_with_grad(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """All ranks' rows of ``x`` over ``group`` in rank order, differentiable:
    when every rank computes ``loss / size`` from the gathered rows, each
    rank's gradient of its own rows is that of the whole loss."""
    return _GatherWithGrad.apply(x, group)
