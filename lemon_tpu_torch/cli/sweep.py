"""Sweep orchestrator (port of lemon_tpu/cli/sweep.py; the jobs run the
port's CLIs, whose ``--platform`` defaults to ``cuda``).

Mirrors sweep.py of the reference: every job's output dir is the md5 of its
sorted-args JSON (run identity, sweep.py:27-33; the script's module is
not part of it, so a JAX sweep and a port sweep of one grid name the same
run directories); job state is derived from
the filesystem (``done`` => DONE, ``job_id`` + live squeue => RUNNING,
partial output => INCOMPLETE); ``launch`` starts everything not done,
``delete_incomplete`` clears crashed runs for relaunch.

Beyond the reference (which relaunches crashed jobs only when sweep.py is
re-invoked by hand): ``daemon`` keeps polling and relaunching until every
job is DONE, with a persisted per-job retry budget — a job that crashes
``--retry_budget`` times is marked FAILED and left for inspection instead
of being relaunched forever.

Usage:
    python -m lemon_tpu_torch.cli.sweep launch --experiment synthetic_smoke \
        --output_root out/sweeps --command_launcher local
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shlex
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

from lemon_tpu_torch.cli import experiments, launchers


class JobState:
    NOT_LAUNCHED = "not_launched"
    INCOMPLETE = "incomplete"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"  # incomplete with retry budget exhausted (daemon mode)


class Job:
    def __init__(self, script: str, args: Dict, output_root: Path, extra_args: Dict = None):
        """``args`` define the run's identity (md5 dir, sweep.py:27-33);
        ``extra_args`` are appended to the command but EXCLUDED from the
        identity hash — reserved for flags that change only how a run
        executes, never its results (e.g. a shared --embedding_cache dir,
        whose entries are content-keyed on data+weights+precision inside
        the encoder). A cached and an uncached sweep therefore share run
        dirs and resume each other."""
        self.script = script
        self.args = dict(args)
        self.extra_args = dict(extra_args or {})
        canonical = json.dumps(self.args, sort_keys=True)
        self.run_id = hashlib.md5(canonical.encode("utf-8")).hexdigest()
        self.output_dir = Path(output_root) / self.run_id
        self.args["output_dir"] = str(self.output_dir)

    @property
    def command(self) -> str:
        parts = [sys.executable, "-m", self.script]
        for key, val in sorted({**self.args, **self.extra_args}.items()):
            if isinstance(val, bool):
                if val:
                    parts.append(f"--{key}")
            elif isinstance(val, (list, tuple)):
                parts.append(f"--{key}")
                parts.extend(str(v) for v in val)
            else:
                parts.append(f"--{key}")
                parts.append(str(val))
        return " ".join(shlex.quote(p) for p in parts)

    def state(self, live_job_ids=None, retry_budget=None) -> str:
        if (self.output_dir / "done").exists():
            return JobState.DONE
        job_id_file = self.output_dir / "job_id"
        if job_id_file.exists() and live_job_ids is not None:
            if job_id_file.read_text().strip() in live_job_ids:
                return JobState.RUNNING
        if self.output_dir.exists():
            if retry_budget is not None and self.attempts >= retry_budget:
                return JobState.FAILED
            return JobState.INCOMPLETE
        return JobState.NOT_LAUNCHED

    @property
    def attempts(self) -> int:
        """Launch count, persisted in the run dir (survives re-invocation).

        Capability upgrade over the reference, whose sweep.py relaunches
        crashed jobs unconditionally on every re-invocation (sweep.py:56-72)
        with no memory of how often a job has already failed.
        """
        f = self.output_dir / "attempts"
        try:
            return int(f.read_text().strip())
        except (FileNotFoundError, ValueError):
            return 0

    def record_attempt(self) -> None:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        (self.output_dir / "attempts").write_text(str(self.attempts + 1))

    def delete(self) -> None:
        if self.output_dir.exists():
            shutil.rmtree(self.output_dir)


def _live_slurm_ids():
    try:
        import getpass

        out = subprocess.run(
            ["squeue", "-u", getpass.getuser(), "-h", "-o", "%i"],
            capture_output=True, text=True, timeout=30,
        ).stdout
        return {l.strip() for l in out.splitlines() if l.strip()}
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return set()


# Scripts that accept --embedding_cache (other CLIs refuse or ignore
# unknown flags, so the sweep only injects where it is supported).
_CACHE_SCRIPTS = {"lemon_tpu_torch.cli.run_lemon", "lemon_tpu_torch.cli.run_baseline"}


def build_jobs(experiment: str, output_root: Path, embedding_cache: str = None) -> List[Job]:
    """``embedding_cache``: shared content-keyed embedding-cache dir injected
    into every job that supports it. Grid cells that differ only in
    (knn_k, seed, dist_type, ablation, hparams) embed identical data with
    identical weights — lemon_all re-embeds the same tensors 100s of times
    without this. Excluded from job identity (see :class:`Job`)."""
    exp = experiments.get_experiment(experiment)
    script = exp.get_script_name()
    extra = (
        {"embedding_cache": str(embedding_cache)}
        if embedding_cache and script in _CACHE_SCRIPTS
        else None
    )
    return [Job(script, hp, output_root, extra_args=extra) for hp in exp.get_hparams()]


def summarize(jobs: List[Job], retry_budget=None) -> Dict[str, int]:
    live = _live_slurm_ids()
    counts: Dict[str, int] = {}
    for job in jobs:
        s = job.state(live, retry_budget)
        counts[s] = counts.get(s, 0) + 1
    return counts


def _launch(jobs: List[Job], launcher_name: str, max_slurm_jobs: int, slurm_pre: str) -> None:
    for j in jobs:
        j.record_attempt()
    commands = [(j.command, str(j.output_dir)) for j in jobs]
    launcher = launchers.REGISTRY[launcher_name]
    if launcher_name == "slurm":
        launcher(commands, max_slurm_jobs=max_slurm_jobs, slurm_pre=slurm_pre)
    else:
        launcher(commands)


def run_daemon(
    jobs: List[Job],
    launcher_name: str,
    *,
    retry_budget: int = 3,
    poll_interval: float = 30.0,
    max_rounds: int | None = None,
    max_slurm_jobs: int = 400,
    slurm_pre: str = "",
) -> Dict[str, int]:
    """Auto-relaunch loop (ROADMAP round-2 item): keep the sweep moving
    without manual re-invocation.

    Each round relaunches every NOT_LAUNCHED/INCOMPLETE job that still has
    retry budget; jobs whose budget is exhausted become FAILED and are left
    alone. Exits when every job is DONE or FAILED (or after ``max_rounds``).
    Returns the final state counts.
    """
    import time

    rounds = 0
    while True:
        live = _live_slurm_ids()
        states = [(j, j.state(live, retry_budget)) for j in jobs]
        counts: Dict[str, int] = {}
        for _, s in states:
            counts[s] = counts.get(s, 0) + 1
        print(f"daemon round {rounds}: {counts}", flush=True)
        pending = [
            j for j, s in states
            if s in (JobState.NOT_LAUNCHED, JobState.INCOMPLETE)
        ]
        if not pending and counts.get(JobState.RUNNING, 0) == 0:
            return counts
        if max_rounds is not None and rounds >= max_rounds:
            return counts
        if pending:
            _launch(pending, launcher_name, max_slurm_jobs, slurm_pre)
        rounds += 1
        if poll_interval:
            time.sleep(poll_interval)


def main(argv=None):
    parser = argparse.ArgumentParser(description="lemon_tpu_torch sweep")
    parser.add_argument("command", choices=["launch", "daemon", "status", "delete_incomplete", "delete_all"])
    parser.add_argument("--experiment", required=True)
    parser.add_argument("--output_root", default="out/sweeps")
    parser.add_argument("--command_launcher", default="local", choices=sorted(launchers.REGISTRY))
    parser.add_argument("--max_slurm_jobs", type=int, default=400)
    parser.add_argument("--slurm_pre", default="")
    parser.add_argument("--retry_budget", type=int, default=3,
                        help="daemon: max launches per job before marking it failed")
    parser.add_argument("--poll_interval", type=float, default=30.0,
                        help="daemon: seconds between relaunch rounds")
    parser.add_argument("--max_rounds", type=int, default=None,
                        help="daemon: stop after this many rounds (default: run to completion)")
    parser.add_argument("--yes", action="store_true", help="skip confirmation")
    parser.add_argument(
        "--embedding_cache", default=None,
        help="shared embedding-cache dir for every job that supports it; "
             "'auto' puts it under the experiment's output root. Cache "
             "entries are content-keyed, so cells of a grid that embed the "
             "same data with the same weights compute them once.",
    )
    args = parser.parse_args(argv)

    output_root = Path(args.output_root) / args.experiment
    output_root.mkdir(parents=True, exist_ok=True)
    cache = args.embedding_cache
    if cache == "auto":
        cache = str(output_root / "_embedding_cache")
    jobs = build_jobs(args.experiment, output_root, embedding_cache=cache)
    # Pass the budget so jobs a daemon quarantined report FAILED here
    # instead of INCOMPLETE (which would invite a blind relaunch).
    print(f"{args.experiment}: {len(jobs)} jobs; states: {summarize(jobs, args.retry_budget)}")

    if args.command == "status":
        return

    if args.command in ("delete_incomplete", "delete_all"):
        live = _live_slurm_ids()
        targets = [
            j for j in jobs
            if (args.command == "delete_all" and j.state(live) != JobState.NOT_LAUNCHED)
            or (args.command == "delete_incomplete" and j.state(live) == JobState.INCOMPLETE)
        ]
        if not args.yes:
            reply = input(f"delete {len(targets)} runs under {output_root}? [y/N] ")
            if reply.lower() != "y":
                return
        for j in targets:
            j.delete()
        print(f"deleted {len(targets)}")
        return

    if args.command == "daemon":
        counts = run_daemon(
            jobs,
            args.command_launcher,
            retry_budget=args.retry_budget,
            poll_interval=args.poll_interval,
            max_rounds=args.max_rounds,
            max_slurm_jobs=args.max_slurm_jobs,
            slurm_pre=args.slurm_pre,
        )
        print(f"daemon finished: {counts}")
        return

    live = _live_slurm_ids()
    # Honor the retry budget here too: a job the daemon quarantined as
    # FAILED must not be blindly relaunched by a later plain `launch`
    # (the summary above already displays it as FAILED — keep display and
    # action consistent). `delete_incomplete` (or deleting the run dir's
    # `attempts` file) is the explicit way to re-arm it.
    to_launch = [
        j for j in jobs
        if j.state(live, args.retry_budget) in (JobState.NOT_LAUNCHED, JobState.INCOMPLETE)
    ]
    if not args.yes and len(to_launch) > 20:
        reply = input(f"launch {len(to_launch)} jobs with '{args.command_launcher}'? [y/N] ")
        if reply.lower() != "y":
            return
    _launch(to_launch, args.command_launcher, args.max_slurm_jobs, args.slurm_pre)
    print(f"launched {len(to_launch)} jobs")


if __name__ == "__main__":
    main()
