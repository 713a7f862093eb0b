"""Preemption checkpoints for managed clusters (port of
lemon_tpu/train/preemption.py; reference lib/utils/utils.py:118-147).

Under a scheduler that grants a per-job scratch directory (Slurm's
``/checkpoint/$USER/$SLURM_JOB_ID``, or ``LEMON_TPU_PREEMPT_DIR``), a run
snapshots its state and step so a preempted job resumes where it stopped.
The state is written with ``torch.save`` (JAX: orbax) to
``<dir>/preempt/state/<step>.pt``; the step and any small Python state ride
beside it in ``<dir>/preempt/meta.json``, as in JAX.
"""

from __future__ import annotations

import getpass
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from lemon_tpu_torch.train.contrastive import TrainState


def preemption_dir() -> Optional[Path]:
    job_id = os.environ.get("SLURM_JOB_ID")
    if job_id is None:
        override = os.environ.get("LEMON_TPU_PREEMPT_DIR")
        return Path(override) if override else None
    base = Path(f"/checkpoint/{getpass.getuser()}/{job_id}")
    return base if base.exists() else None


def has_checkpoint(base: Optional[Path] = None) -> bool:
    base = base or preemption_dir()
    return base is not None and (base / "preempt" / "meta.json").exists()


def save_checkpoint(state, step: int, extra: Dict[str, Any] | None = None, base: Optional[Path] = None) -> bool:
    """Snapshot ``state`` (a state dict, or any structure of tensors that
    ``torch.load(weights_only=True)`` reads); returns False when no
    preemption directory is configured. A ``TrainState`` is saved as its
    full state: under a mesh every rank calls this, the shards of a
    tensor-parallel model are gathered over the model group as for a
    checkpoint (``TrainState.state_dict``), and global rank 0 writes. Each
    file is written to a temporary name and renamed into place;
    ``meta.json`` goes last."""
    base = base or preemption_dir()
    if base is None:
        return False
    if isinstance(state, TrainState):
        mesh = state.mesh
        if mesh is not None and mesh.model > 1 and mesh.rank != 0:
            return True  # not in the model group that gathers
        state = state.state_dict()
        if mesh is not None and not mesh.lead:
            return True
    target = (base / "preempt").absolute()
    (target / "state").mkdir(parents=True, exist_ok=True)
    path = target / "state" / f"{step}.pt"
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    meta = target / "meta.json"
    tmp = meta.with_name(f"meta.json.{os.getpid()}.tmp")
    tmp.write_text(json.dumps({"step": step, **(extra or {})}))
    os.replace(tmp, meta)
    return True


def load_checkpoint(base: Optional[Path] = None):
    """``(state, meta)`` of the last snapshot, or None."""
    base = base or preemption_dir()
    if base is None or not has_checkpoint(base):
        return None
    target = (base / "preempt").absolute()
    meta = json.loads((target / "meta.json").read_text())
    state = torch.load(target / "state" / f"{meta['step']}.pt", map_location="cpu", weights_only=True)
    return state, meta
