"""Process mesh on ``torch.distributed`` (port of lemon_tpu/core/mesh.py).

One process drives one device: NCCL on ``cuda:LOCAL_RANK``, or gloo on the
CPU (``platform="cpu"``). A mesh is ``data x model`` processes:

- ``data``  : the batch and query axis (pure data parallelism), and the
  database axis of the sharded kNN search (knn/index.py);
- ``model`` : tensor parallelism, which the port does not have yet: a mesh
  with ``model > 1`` raises ``NotImplementedError``.

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
TP_NOT_PORTED = ("tensor parallelism (--mesh DATAxMODEL with MODEL > 1) is not ported to lemon_tpu_torch yet "
                 "(ROADMAP queue 1, item 10)")


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
    process's place on the data axis, ``device`` the one it drives."""

    data: int
    model: int
    rank: int
    device: torch.device


def parse_mesh(text: str):
    """``"DATAxMODEL"`` (the CLIs' ``--mesh``) -> ``(data, model)``."""
    d, m = text.lower().split("x")
    return int(d), int(m)


def get_mesh(data: int = -1, model: int = 1, platform: str = "cuda") -> Mesh:
    """The ``data x model`` mesh over the world's processes (joined or built
    by :func:`distributed_init`). ``data=-1`` takes the whole world. Raises
    ``NotImplementedError`` for ``model > 1`` and ``ValueError`` when the
    mesh is not the world's size: each process drives one device of the
    mesh, so a rank past it would have no work. (The JAX package, one
    process over many devices, takes the first ``data * model`` of them;
    ROADMAP: handled divergences.)"""
    if model != 1:
        raise NotImplementedError(TP_NOT_PORTED)
    distributed_init(platform)
    world = dist.get_world_size()
    data = world if data == -1 else data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes; the world has {world}. "
                         f"Each process drives one device of the mesh, so the mesh must span the world: "
                         f"start {data * model} processes, or pass --mesh {world}x{model}")
    return Mesh(data=data, model=model, rank=dist.get_rank(), device=resolve_device(platform))


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


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated in rank
    order on the leading axis; no gradient."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


class _GatherWithGrad(torch.autograd.Function):
    """:func:`all_gather_rows` whose backward sums the gradient of the
    gathered rows over the ranks and returns this rank's slice."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return all_gather_rows(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad)
        start = dist.get_rank() * ctx.rows
        return grad[start : start + ctx.rows]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """All ranks' rows of ``x`` in rank order, differentiable: when every
    rank computes ``loss / world`` from the gathered rows, each rank's
    gradient of its own rows is that of the whole loss."""
    return _GatherWithGrad.apply(x)
