"""Job launchers: local serial, Slurm with backpressure, dry-run (a copy of
lemon_tpu/cli/launchers.py).

Mirrors launchers.py:9-54 of the reference: the local launcher runs
commands serially; the Slurm launcher submits ``sbatch --wrap`` jobs and
polls ``squeue`` to stay under a concurrency cap, writing each job's id
into its output dir for the sweep state machine.
"""

from __future__ import annotations

import getpass
import subprocess
import time
from typing import List, Tuple


def local_launcher(commands: List[Tuple[str, str]]) -> None:
    for cmd, _out_dir in commands:
        subprocess.run(cmd, shell=True, check=False)


def dry_launcher(commands: List[Tuple[str, str]]) -> None:
    for cmd, _ in commands:
        print(cmd)


def _n_queued(user: str) -> int:
    out = subprocess.run(
        ["squeue", "-u", user, "-h", "-o", "%i"], capture_output=True, text=True
    ).stdout
    return len([l for l in out.splitlines() if l.strip()])


def slurm_launcher(commands: List[Tuple[str, str]], max_slurm_jobs: int = 400, slurm_pre: str = "") -> None:
    user = getpass.getuser()
    for cmd, out_dir in commands:
        while _n_queued(user) >= max_slurm_jobs:
            time.sleep(10)
        wrapped = f'sbatch {slurm_pre} --wrap "{cmd}"'
        result = subprocess.run(wrapped, shell=True, capture_output=True, text=True)
        # sbatch prints 'Submitted batch job <id>'
        job_id = result.stdout.strip().split()[-1] if result.stdout.strip() else ""
        if out_dir and job_id:
            with open(f"{out_dir}/job_id", "w") as f:
                f.write(job_id)
        time.sleep(0.5)


REGISTRY = {
    "local": local_launcher,
    "dry": dry_launcher,
    "slurm": slurm_launcher,
}
