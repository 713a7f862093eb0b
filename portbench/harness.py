"""One run of one cell: set-up, the measured window, the check.

Set-up builds the encoder as the program's registry builds it, through the
configuration's architecture module (:mod:`portbench.arch`), from weights
made on the device from the seed, makes the mix's host data (label lists,
class templates or the image pool) and warms up the cell's own shapes: one embedding batch of each tower, one search of
each split's size against the comparison set, one fit and evaluation at
the splits' sizes.

The window runs whole LEMoN detections back to back, each on a new
dataset drawn from (seed, detection index): ``detect.build_neighbor_logs``
(embed every split, both exact indexes, the searches, the components),
then ``detect.select_and_evaluate`` (the fit on the val split, scores,
metrics). Each dataset is made just before its detection, and the window's
clock stops while it is made: the window is the time of the detections
alone. A detection starts while that time is under ``seconds`` and runs to
its end, so the window closes at the end of the last one. Each
detection's outputs are read through two taps that keep references to what
the program returns: ``ClipEncoder.embed_split`` (each split's embeddings)
and ``ExactKnnIndex.search`` (each search's scores and ids). After the window the program is freed and :mod:`portbench.check`
judges every detection.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lemon_tpu_torch import detect
from lemon_tpu_torch.core.device import resolve_device
from lemon_tpu_torch.core.precision import Precision
from lemon_tpu_torch.core.profiling import PhaseTimer
from lemon_tpu_torch.data.datasets import CaptioningSplit, ClassificationSplit
from lemon_tpu_torch.data.labels import LABEL_SETS
from lemon_tpu_torch.knn.index import ExactKnnIndex
from lemon_tpu_torch.scoring.lemon import NeighborLogs
from portbench import arch
from portbench import check as chk
from portbench.traffic import SPLITS, Detection, Traffic, load_mix
from portbench.weights import make_weights

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "lemon_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_limits(name: str) -> Dict[str, float]:
    """``limits/<name>.json``: a limit for each number the cell compares.
    Its ``not_compared`` names, each with its reason, the numbers that no
    limit can hold in that cell; every number is in one of the two."""
    limits = load_json(PKG / "limits" / f"{name}.json")
    skipped = limits.pop("not_compared", {})
    if set(limits) & set(skipped) or set(limits) | set(skipped) != set(chk.NUMBERS):
        raise SystemExit(f"limits/{name}.json: each of {chk.NUMBERS} needs a limit or a reason in not_compared")
    return limits


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    limits: dict  # number -> limit, for the numbers the cell compares

    @staticmethod
    def load(bench: dict, name: str) -> "Cell":
        workload = next((w for w in bench["workloads"] if w["name"] == name), None)
        if workload is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        file = next(c for c in bench["configs"] if c["name"] == workload["config"])["file"]
        config = load_json(ROOT / file)
        errors = arch.key_errors(config)
        if errors:
            raise SystemExit(f"{file}: " + "; ".join(errors))
        mix = load_mix(workload["traffic"])
        if "comparison_pairs" in config:  # a configuration's cut of the comparison set (its ``reduced``)
            mix["rows"]["train"] = min(mix["rows"]["train"], config["comparison_pairs"])
        return Cell(workload=workload, config=config, mix=mix, limits=load_limits(name))


class RecordingTimer(PhaseTimer):
    """The program's ``PhaseTimer`` that also keeps each phase's interval in
    ``time.time_ns()``, the clock of the profiler's events."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.spans: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time_ns()
        with super().phase(name):
            yield
        self.spans.append((name, t0, time.time_ns()))


def build_encoder(cfg: dict, W, device: torch.device, batch_size: int, seed: int):
    """The program's encoder for ``cfg`` in its precision, loaded with ``W``,
    as its architecture module builds it."""
    precision = {"fp32": Precision.fp32(), "bf16": Precision.bf16(), "int8": Precision.int8()}[cfg["precision"]]
    return arch.of(cfg).encoder(cfg, precision, W, device, batch_size, f"portbench:{seed}")


def program_splits(det: Detection) -> Dict[str, object]:
    out = {}
    for name, s in det.splits.items():
        if s.texts is None:
            out[name] = ClassificationSplit(y_clean=s.y_clean, y_noisy=s.y_noisy, images=s.images)
        else:
            out[name] = CaptioningSplit(sentence=np.array(s.texts, object),
                                        gold_sentence=np.array(s.clean_texts, object), images=s.images)
    return out


def detection_config(mix: dict):
    d = mix["detection"]
    return detect.DetectionConfig(dataset=d["dataset"], knn_k=d["knn_k"], dist_type=d["dist_type"],
                                  batch_size=d["batch_size"], noise_level=mix["noise"]["level"])


class Taps:
    """References to what ``ClipEncoder.embed_split`` and
    ``ExactKnnIndex.search`` return during one detection."""

    def __init__(self, encoder):
        self.encoder = encoder
        self.embeds: List[tuple] = []
        self.searches: List[tuple] = []

    def __enter__(self):
        embed, search = self.encoder.embed_split, ExactKnnIndex.search
        taps = self

        def embed_split(split, texts, **kw):
            img, txt = embed(split, texts, **kw)
            taps.embeds.append((split, img, txt))
            return img, txt

        def tapped_search(index, q, k):
            scores, ids = search(index, q, k)
            taps.searches.append((q, scores, ids))
            return scores, ids

        self._saved = search
        self.encoder.embed_split = embed_split
        ExactKnnIndex.search = tapped_search
        return self

    def __exit__(self, *exc):
        del self.encoder.embed_split
        ExactKnnIndex.search = self._saved

    def outputs(self, splits: Dict[str, object], logs, agg: dict, df) -> chk.Outputs:
        emb = {}
        for split, img, txt in self.embeds:
            name = next(n for n, s in splits.items() if s is split)
            emb[name] = (img, txt)
        knn = {}
        for q, scores, ids in self.searches:
            head = q[:16].float().cpu().numpy()
            key = next(((n, m) for n in SPLITS for j, m in enumerate(("img", "txt"))
                        if len(emb[n][j]) == len(q) and np.array_equal(emb[n][j][:16], head)), None)
            if key is None or key in knn:
                raise RuntimeError("a search whose queries are no split's embeddings, or one split searched twice")
            knn[key] = (scores, ids)
        crit = agg["know_val_labels"]
        hp = {h: float(crit.get(h, 0.0)) for h in chk.HPARAMS}
        log_arrays = {c: np.asarray(getattr(logs, c)) for c in chk.COMPONENTS}
        log_arrays["sset"] = np.asarray(logs.sset)
        return chk.Outputs(emb=emb, knn=knn, logs=log_arrays, hparams=hp,
                           fit={f: float(crit[f]) for f in ("thres", "selected_val")},
                           scores=df["know_val_labels_pred_score"].to_numpy(np.float64),
                           auroc={n: float(crit[n]["AUROC"]) for n in SPLITS})


def run_detection(encoder, det: Detection, mix: dict, device: torch.device, timer) -> chk.Outputs:
    dcfg = detection_config(mix)
    splits = program_splits(det)
    with Taps(encoder) as taps:
        logs = detect.build_neighbor_logs(dcfg, encoder, splits, LABEL_SETS.get(dcfg.dataset), timer)
        agg, df = detect.select_and_evaluate(dcfg, logs, device, timer)
    return taps.outputs(splits, logs, agg, df)


def warm_up(encoder, traffic: Traffic, mix: dict, device: torch.device, seed: int) -> None:
    """The cell's own shapes, once: an embedding batch of each tower, a
    search of each split's size, a fit and evaluation at the splits' sizes."""
    dcfg = detection_config(mix)
    bs, k = dcfg.batch_size, dcfg.knn_k
    small = traffic.detection(-1, rows=(bs, bs, bs)).splits["val"]
    encoder.embed_split(program_splits(Detection(index=-1, splits={"val": small}))["val"], traffic.texts(small))

    gen = torch.Generator(device=device).manual_seed(seed & 0x7FFFFFFF)
    n_db, dim = traffic.rows[0], encoder.cfg.embed_dim
    db = torch.nn.functional.normalize(torch.randn(n_db, dim, generator=gen, device=device), dim=1)
    index = ExactKnnIndex(metric="ip", device=device, precision="high")
    index.add(db)
    for name, n in zip(SPLITS, traffic.rows):
        index.search(db[:n], k + (name == "train"))

    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 5])
    n = sum(traffic.rows)
    mis = (rng.random(n) < mix["noise"]["level"]).astype(np.int64)
    f = lambda *shape: rng.random(shape).astype(np.float32)  # noqa: E731
    logs = NeighborLogs(d_1=f(n) + 0.3 * mis, dists_n=f(n, k), D_n=-f(n, k), dists_tr_n=f(n, k), dists_m=f(n, k),
                        D_m=-f(n, k), dists_tr_m=f(n, k), is_mislabel=mis,
                        sset=np.repeat(np.array(SPLITS, object), traffic.rows), idx=np.arange(n))
    detect.select_and_evaluate(dcfg, logs, device, PhaseTimer(device))
    _sync(device)


@dataclasses.dataclass
class Record:
    """What a metric reader reads."""

    cell: Cell
    setup_s: float
    window_s: float  # the detections' time: the window less the data making
    window_ns: Tuple[int, int]
    made_ns: List[Tuple[int, int]]  # where the window's clock stopped while a dataset was made
    detections: List[Detection]
    failed: int
    phases: Dict[str, float]
    spans: List[Tuple[str, int, int]]
    peak_bytes: int
    device_events: Optional[List[Tuple[str, int, int]]] = None  # (name, start ns, end ns) of the detections

    @property
    def pairs(self) -> int:
        return sum(d.pairs for d in self.detections)


def device_events(prof) -> List[Tuple[str, int, int]]:
    """Kernels, copies and fills the profiler saw on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def busy_intervals(events) -> List[Tuple[int, int]]:
    """The union of the events' intervals, in order."""
    merged: List[List[int]] = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_seconds(events, window_ns: Tuple[int, int]) -> float:
    """Seconds of the window in which some event ran on the card (a
    record's events leave out those of the data making)."""
    w0, w1 = window_ns
    return sum(max(0, min(b, w1) - max(a, w0)) for a, b in busy_intervals(events)) / 1e9


def breakdown(rec: Record) -> dict:
    """The ten device operations that took most time, and the device's idle
    time in the detections by what the host was doing (the program's phase,
    or the rest of a detection)."""
    per_op: Dict[str, float] = {}
    for name, a, b in rec.device_events:
        per_op[name] = per_op.get(name, 0.0) + (b - a) / 1e9
    busy = busy_intervals([("", a, b) for _, a, b in rec.device_events] + [("", a, b) for a, b in rec.made_ns])
    w0, w1 = rec.window_ns
    gaps, cursor = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > cursor:
            gaps.append((cursor, min(a, w1)))
        cursor = max(cursor, b)
    spans = sorted(rec.spans, key=lambda s: s[1])  # the phases do not overlap
    starts = [s[1] for s in spans]
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = spans[i][0] if i >= 0 and mid < spans[i][2] else "outside the program's phases"
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(per_op), "idle_gaps": top(idle)}


def read_metrics(bench: dict, rec: Record, trace: bool) -> Dict[str, dict]:
    """Every metric of this cell that its reader finds something for."""
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit_w() -> Optional[float]:
    import subprocess

    try:
        text = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                              capture_output=True, text=True, timeout=30).stdout.split("\n")[0]
        return float(text)
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def run(bench: dict, cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        count: int = 1) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    if device.type == "cuda":
        resolve_device("cuda")  # TF32 off, fp32 accumulation of bf16 products, as every program entry sets
        from lemon_tpu_torch.ops._build import library

        t0 = time.perf_counter()
        library()
        print(f"kernel library ready in {time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    cfg, mix = cell.config, cell.mix
    stages = {"start": time.perf_counter() - t_start}
    W = make_weights(cfg, seed, device)
    encoder = build_encoder(cfg, W, device, mix["detection"]["batch_size"], seed)
    del W
    _sync(device)
    stages["weights and encoder"] = time.perf_counter() - t_start
    traffic = Traffic(mix, seed, device)
    stages["traffic"] = time.perf_counter() - t_start
    warm_up(encoder, traffic, mix, device, seed)
    stages["warm-up"] = time.perf_counter() - t_start
    activity = torch.profiler.ProfilerActivity.CUDA if device.type == "cuda" else torch.profiler.ProfilerActivity.CPU
    if trace:  # the profiler's own start-up stays out of the window
        with torch.profiler.profile(activities=[activity]):
            torch.ones(1, device=device).add_(1)
            _sync(device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    print("set-up, seconds since the start at the end of each stage:", json.dumps(stages), file=sys.stderr, flush=True)

    timer = RecordingTimer(device)
    outputs: List[Tuple[Detection, Optional[chk.Outputs]]] = []
    made_ns: List[Tuple[int, int]] = []
    failed, made_s = 0, 0.0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = torch.profiler.profile(activities=[activity]) if trace else None
    with prof if prof is not None else contextlib.nullcontext():
        w_ns0, t0 = time.time_ns(), time.perf_counter()
        while time.perf_counter() - t0 - made_s < seconds:
            t_make, p_make = time.time_ns(), time.perf_counter()
            det = traffic.detection(len(outputs))  # ends in copies to the host: no device work left
            made_s += time.perf_counter() - p_make
            made_ns.append((t_make, time.time_ns()))
            try:
                t_det, before = time.perf_counter(), dict(timer.totals)
                outputs.append((det, run_detection(encoder, det, mix, device, timer)))
                split = {k: round(v - before.get(k, 0.0), 4) for k, v in timer.totals.items()}
                print(f"detection {det.index}: {time.perf_counter() - t_det:.3f} s, phases {json.dumps(split)}",
                      file=sys.stderr, flush=True)
            except Exception:  # a detection that raises is a failed detection; the window goes on
                traceback.print_exc()
                failed += 1
                outputs.append((det, None))
        _sync(device)
        window_s, w_ns1 = time.perf_counter() - t0 - made_s, time.time_ns()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec = Record(cell=cell, setup_s=setup_s, window_s=window_s, window_ns=(w_ns0, w_ns1), made_ns=made_ns,
                 detections=[d for d, _ in outputs], failed=failed, phases=timer.as_dict(), spans=timer.spans,
                 peak_bytes=peak)
    if prof is not None:
        made = lambda e: any(a <= (e[1] + e[2]) // 2 < b for a, b in made_ns)  # noqa: E731
        rec.device_events = [e for e in device_events(prof) if e[2] > w_ns0 and e[1] < w_ns1 and not made(e)]
        del prof

    # the program's state goes before the reference runs
    del encoder, timer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    W = make_weights(cfg, seed, device)
    numbers = {n: 0.0 for n in chk.NUMBERS}
    for det, out in outputs:
        if out is None:
            continue
        got = chk.check(out, det, traffic, W, cfg, device, seed, mix["check_rows"])
        numbers = {n: max(numbers[n], got[n]) for n in chk.NUMBERS}
    # a reading with no finite value (a non-finite output, an id out of range) prints as 1e300
    checks = {n: {"value": min(numbers[n], 1e300), "limit": cell.limits[n]} for n in chk.NUMBERS if n in cell.limits}
    correct = failed == 0 and bool(outputs) and all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": len(outputs), "failed": failed,
              "metrics": read_metrics(bench, rec, trace), "device": device_info(device, count, peak)}
    if trace and rec.device_events is not None:
        traced_s = (w_ns1 - w_ns0 - sum(b - a for a, b in made_ns)) / 1e9
        result["device"].update(busy_s=busy_seconds(rec.device_events, rec.window_ns), window_s=traced_s)
        result["breakdown"] = breakdown(rec)
    result["checks"] = checks
    return result


def device_info(device: torch.device, count: int, peak: int) -> dict:
    import os

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": peak, "power_limit_w": power_limit_w(), "torch": torch.__version__,
            "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))
