#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lemon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and ``nvcc`` and
imports nothing of JAX. Phases, each printed on its own lines:

1. the card's name and power limit (``nvidia-smi``);
2. the build of the CUDA kernels from ``lemon_tpu_torch/ops/csrc/*.cu``;
3. K1 (``scores_blockmax``) against its plain PyTorch version on the card:
   q 8192x512 against db 16000x512 with n_valid < T, ip/l2 x highest/high,
   max absolute error at most 1e-5, strip maxima exact, and the times of
   both; the split pass of ``high`` bit for bit against its plain version;
   ``torch.matmul(q, db.T)`` alone (cuBLAS SGEMM, TF32 off) as a reference;
4. K2 (``topk``) against its plain version at the main path's (8192, 125)
   and (8192, 768) k=6, and at (8192, 640) k=5, (8192, 6528) k=51 and
   (8192, 1024) k=200, with ties and -inf rows: values and indices exact,
   for the variant the kernel picks and for each variant forced, with the
   time of each and of ``torch.sort(stable=True)``; then both variants
   where they cross over, and k=51 on rows of distinct values;
5. ``ExactKnnIndex.search`` at k=5 and k=51 over 131072 rows against a plain
   whole-row search on the card, on inputs whose scores are exact in fp32
   (so every tie is real and ids must follow the tie rule exactly);
6. ``python -m lemon_tpu_torch.cli.run_lemon`` in-process on 20000 synthetic
   caption pairs with ViT-B/32 at full width (random weights): output files,
   finite scores, test AUROC above 0.5, and K1 and K2 launched by that run;
7. K3 (``flash_attention``) against its plain version at the towers' shapes,
   B=128: (197, 12, 64) and (50, 12, 64) unmasked, (256, 8, 64) and
   (77, 8, 64) causal; max absolute error at most 2e-5, both times, and the
   time of ``scaled_dot_product_attention`` in fp32 (TF32 off) with the
   backend it ran;
8. K4 (``fused_gather_topk``) against its plain version at q 8192 over 1024
   blocks of 128 columns, k=5 and k=51, with ties and -inf columns: values
   and ids exact; its time, the plain time and the time of the search's own
   select tail (gather + K2). Then its path once: K1 over a 131072-row tile,
   the block top-k, K4, held to the search's select tail;
9. the from-scratch ViT-B/16 path (``mimic_clip_from_scratch_random``: 224 px
   in 16 px patches, text context 256, embed 768; random weights): 512 pairs
   embedded with one state dict under ``attention_impl="plain"`` and
   ``"flash"`` agree within 1e-4, then a detection of 8000 synthetic caption
   pairs under ``"flash"`` (``detect.build_neighbor_logs`` and
   ``detect.select_and_evaluate``): finite scores, test AUROC above 0.5, and
   K1, K2 and K3 launched by that run.

Every kernel line prints its bound: the larger of the bytes it must move
(each input read once, each output written once) over 3.35 TB/s and its
operations over the peak rate of their type (989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s fp32), and the share of the bound that the kernel reaches.
The second-to-last line is a JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
"""

from __future__ import annotations

import ast
import json
import pickle
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
K1_TOL = 1e-5
K3_TOL = 2e-5  # tests/test_attention.py:26: fp32 with another summation order
EMBED_TOL = 1e-4  # tests/test_attention.py:56-57: the towers, plain vs flash
# (L, heads, head dim, causal) of the towers' attention: ViT-B/16 vision,
# ctx-256 text, ViT-B/32 vision, ctx-77 text
K3_SHAPES = ((197, 12, 64, False), (256, 8, 64, True), (50, 12, 64, False), (77, 8, 64, True))
# (W, k) of K2: the main path's block maxima (T/128 of a 16000-row tile) and
# candidates ((k+1)*128) at --knn_k 5, then k=5, k=51 and k=200 candidates
K2_SHAPES = ((125, 6), (768, 6), (640, 5), (6528, 51), (1024, 200))
# (W, k, rows) where the two K2 variants are compared: their crossover on
# tie-heavy rows, and k=51 on rows of distinct (Gaussian) values
K2_CROSSOVER = ((1024, 16, "ties"), (1024, 32, "ties"), (640, 51, "ties"), (6528, 51, "gaussian"))
# H100 SXM peaks (NVIDIA data sheet, dense): memory bytes/s, bf16 tensor-core and fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(torch, kernel, plain, iters: int):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain, iters)
    k1 = cuda_ms(torch, kernel, iters)
    k2 = cuda_ms(torch, kernel, iters)
    p2 = cuda_ms(torch, plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(n_bytes: float, n_ops: float, peak: str):
    """(ms, what sets it): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_text(b, ms: float) -> str:
    return f"bound {b[0]:.4f} ms ({b[1]}), {b[0] / ms:.1%} of it"


def unit_rows(torch, g, n, d, device):
    x = torch.randn(n, d, generator=g)
    return (x / x.norm(dim=1, keepdim=True)).to(device)


def phase_k1(torch, scoremax, device):
    b, t, d = 8192, 16000, 512
    g = torch.Generator().manual_seed(0)
    q = unit_rows(torch, g, b, d, device)
    db = unit_rows(torch, g, t, d, device)
    dbsq = (db * db).sum(1)
    n_valid = 15900
    worst = 0.0
    times = {}
    for x, name in ((q, "q"), (db, "db")):
        (hi, lo), (hi0, lo0) = scoremax.split_bf16(x), scoremax.split_bf16_plain(x)
        torch.cuda.synchronize()
        check(all(bool(torch.equal(a.view(torch.int16), a0.view(torch.int16))) for a, a0 in ((hi, hi0), (lo, lo0))),
              f"K1 split pass of {name}: differs from the plain split")
    print("K1 split pass (bf16 hi/lo of q and db, D padded to 64): bit-equal to the plain split", flush=True)
    for metric in ("ip", "l2"):
        for precision in ("highest", "high"):
            args = (q, db, metric, dbsq if metric == "l2" else None, 0, n_valid, precision)
            s, bm = scoremax.scores_blockmax(*args)
            s0, bm0 = scoremax.scores_blockmax_plain(*args)
            torch.cuda.synchronize()
            fin = torch.isfinite(s0)
            check(bool((torch.isfinite(s) == fin).all()), f"K1 {metric}/{precision}: mask differs")
            check(bool(torch.isneginf(s[:, n_valid:]).all()), f"K1 {metric}/{precision}: columns >= n_valid not -inf")
            err = (s - s0)[fin].abs().max().item()
            berr = (bm - bm0).abs().max().item()
            check(bool(torch.equal(bm, s.view(8192, -1, 128).amax(2))), f"K1 {metric}/{precision}: bmax != strip max")
            ms, plain_ms = paired_ms(torch, lambda: scoremax.scores_blockmax(*args), lambda: scoremax.scores_blockmax_plain(*args), 10)
            high = precision == "high"
            bnd = bound(4 * (b * d + t * d + (t if metric == "l2" else 0) + b * t + b * t // 128),
                        (3 if high else 1) * 2 * b * t * d, "bf16" if high else "fp32")
            times[(metric, precision)] = (ms, plain_ms, bnd)
            print(f"K1 scores_blockmax {metric}/{precision} (8192x512 . 16000x512): max_abs_err {err:.3e} "
                  f"(bmax {berr:.3e}, tol {K1_TOL}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
                  f"{bound_text(bnd, ms)}", flush=True)
            check(err <= K1_TOL and berr <= K1_TOL, f"K1 {metric}/{precision}: error {err} > {K1_TOL}")
            worst = max(worst, err, berr)
    mm_ms = cuda_ms(torch, lambda: torch.matmul(q, db.T), 10)
    print(f"K1 reference: torch.matmul(q, db.T) alone (cuBLAS SGEMM, TF32 off) {mm_ms:.3f} ms", flush=True)
    return worst, times


def topk_inputs(torch, g, b, w, device):
    x = torch.randint(0, 40, (b, w), generator=g).float() / 4  # many exact ties
    x[0] = -torch.inf
    x[1, 3:] = -torch.inf
    x[2, : w // 2] = -torch.inf
    return x.to(device)


def phase_k2(torch, topk, device):
    g = torch.Generator().manual_seed(1)
    times = {}
    worst = 0.0
    b = 8192
    for w, k in K2_SHAPES:
        x = topk_inputs(torch, g, b, w, device)
        v0, i0 = topk.topk_plain(x, k)
        variants = ["auto"] + [m for m in ("warp", "radix") if m != "warp" or w <= topk.WARP_MAX_W]
        for variant in variants:
            v, i = topk.topk(x, k, variant)
            torch.cuda.synchronize()
            check(bool(torch.equal(v, v0)) and bool(torch.equal(i, i0)),
                  f"K2 ({w}, k={k}) {variant}: differs from the plain version")
        fin = torch.isfinite(v0)
        worst = max(worst, (v - v0)[fin].abs().max().item())
        ms, plain_ms = paired_ms(torch, lambda: topk.topk(x, k), lambda: topk.topk_plain(x, k), 20)
        sort_ms = cuda_ms(torch, lambda: torch.sort(x, dim=1, descending=True, stable=True), 20)
        by_variant = {m: cuda_ms(torch, lambda: topk.topk(x, k, m), 20) for m in variants[1:]}
        bnd = bound(4 * b * w + 12 * b * k, b * w, "fp32")
        times[(w, k)] = (ms, plain_ms, sort_ms, bnd)
        print(f"K2 topk (8192, {w}) k={k}: values and indices exact ({', '.join(variants)}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, torch.sort(stable=True) {sort_ms:.4f} ms; by variant "
              + ", ".join(f"{m} {t:.4f} ms" for m, t in by_variant.items()) + f"; {bound_text(bnd, ms)}", flush=True)
    for w, k, rows in K2_CROSSOVER:
        x = topk_inputs(torch, g, b, w, device) if rows == "ties" else torch.randn(b, w, generator=g).to(device)
        v0, i0 = topk.topk_plain(x, k)
        by_variant = {}
        for variant in [m for m in ("warp", "radix") if m != "warp" or w <= topk.WARP_MAX_W]:
            v, i = topk.topk(x, k, variant)
            torch.cuda.synchronize()
            check(bool(torch.equal(v, v0)) and bool(torch.equal(i, i0)),
                  f"K2 ({w}, k={k}, {rows}) {variant}: differs from the plain version")
            by_variant[variant] = cuda_ms(torch, lambda: topk.topk(x, k, variant), 20)
        print(f"K2 variants (8192, {w}) k={k}, {rows} rows: exact; "
              + ", ".join(f"{m} {t:.4f} ms" for m, t in by_variant.items()), flush=True)
    return worst, times


def sdpa_backend(torch, q, k, v, causal: bool) -> str:
    """The backend that ``scaled_dot_product_attention`` picks for these inputs."""
    try:
        from torch.nn.attention import SDPBackend

        names = {b.value: name for name, b in SDPBackend.__members__.items()}
        return names.get(int(torch._fused_sdp_choice(q, k, v, None, 0.0, causal)), "unknown")
    except (AttributeError, ImportError, RuntimeError, TypeError) as e:
        return f"unknown ({type(e).__name__})"


def phase_k3(torch, attention, device):
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(3)
    worst = 0.0
    times = {}
    for l, h, d, causal in K3_SHAPES:
        b = 128
        x = torch.randn(b, l, 3 * h * d, device=device, generator=g)
        q, k, v = (t.reshape(b, l, h, d) for t in x.split(h * d, dim=-1))  # the towers' strided views
        out = attention.flash_attention(q, k, v, causal)
        ref = attention.flash_attention_plain(q, k, v, causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's (B, H, L, D)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)  # noqa: E731
        sdpa_err = (sdpa().transpose(1, 2) - ref).abs().max().item()
        torch.cuda.synchronize()
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()), f"K3 {(l, h, d, causal)}: bad output")
        err = (out - ref).abs().max().item()
        ms, plain_ms = paired_ms(torch, lambda: attention.flash_attention(q, k, v, causal),
                                 lambda: attention.flash_attention_plain(q, k, v, causal), 20)
        sdpa_ms = cuda_ms(torch, sdpa, 20)
        pairs = l * (l + 1) // 2 if causal else l * l  # the query-key pairs the mask keeps
        bnd = bound(4 * 4 * b * l * h * d, 4 * b * h * d * pairs, "fp32")
        times[(l, h, d, causal)] = (ms, plain_ms, sdpa_ms, bnd)
        print(f"K3 flash_attention (128, {l}, {h}, {d}) {'causal' if causal else 'unmasked'}: max_abs_err {err:.3e} "
              f"(tol {K3_TOL}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, scaled_dot_product_attention "
              f"{sdpa_ms:.3f} ms ({sdpa_backend(torch, qt, kt, vt, causal)}, fp32, max_abs_err {sdpa_err:.3e}); "
              f"{bound_text(bnd, ms)}", flush=True)
        check(err <= K3_TOL, f"K3 {(l, h, d, causal)}: error {err} > {K3_TOL}")
        worst = max(worst, err)
    return worst, times


def phase_k4(torch, scoremax, select, topk, blockmax_select, device):
    """K4 against its plain version, then its path: K1, the block top-k and
    K4 at the geometry of benchmarks/probe_knn_select_fused.py."""
    b, nb = 8192, 1024
    g = torch.Generator(device=device).manual_seed(4)
    s = torch.randint(0, 4096, (b, nb * 128), device=device, generator=g, dtype=torch.int32).float() / 16  # ties
    s[:, -200:] = -torch.inf
    s[0] = -torch.inf
    s[1] = -torch.inf
    s[1, 130:133] = 2.0  # fewer finite entries than k
    sb = s.view(b, nb, 128)
    bmax = sb.amax(2)
    times = {}
    for k in (5, 51):
        ids = topk.topk(bmax, k)[1].sort(dim=1).values
        v, i = select.fused_gather_topk(sb, ids, k)
        v0, i0 = select.fused_gather_topk_plain(sb, ids, k)
        torch.cuda.synchronize()
        check(bool(torch.equal(v, v0)) and bool(torch.equal(i, i0)), f"K4 k={k}: differs from the plain version")
        ms, plain_ms = paired_ms(torch, lambda: select.fused_gather_topk(sb, ids, k),
                                 lambda: select.fused_gather_topk_plain(sb, ids, k), 20)
        tail_ms = cuda_ms(torch, lambda: select.gather_then_topk(sb, ids, k, topk.topk), 20)
        bnd = bound(4 * b * k * 128 + 8 * b * k + 12 * b * k, b * k * 128, "fp32")
        times[k] = (ms, plain_ms, tail_ms, bnd)
        print(f"K4 fused_gather_topk (8192, 1024 blocks) k={k}: values and ids exact; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, the search's select tail (gather + K2) {tail_ms:.3f} ms; "
              f"{bound_text(bnd, ms)}", flush=True)
    del s, sb, bmax

    gen = torch.Generator().manual_seed(5)
    xq = unit_rows(torch, gen, b, 512, device)
    xb = unit_rows(torch, gen, nb * 128, 512, device)
    k = 51
    select.fused_gather_topk.launches = 0
    s, bmax = scoremax.scores_blockmax(xq, xb, "ip", None, 0, nb * 128, "high")
    blocks = topk.topk(bmax, k)[1].sort(dim=1).values
    v, i = select.fused_gather_topk(s.view(b, nb, 128), blocks, k)
    torch.cuda.synchronize()
    launches = select.fused_gather_topk.launches
    v0, i0 = blockmax_select(s, bmax, k)
    check(bool(torch.equal(v, v0)) and bool(torch.equal(i, i0)), "K4 path: differs from the search's select tail")
    print(f"K4 path (K1 ip/high 8192x512 . 131072x512, block top-k, K4 k={k}): equal to the search's select tail; "
          f"K4 launches {launches}", flush=True)
    check(launches > 0, "K4 path: K4 was not launched")
    return times, launches


def plain_search(torch, scoremax, topk, xb, xq, k, precision):
    out_v, out_i = [], []
    for s in range(0, len(xq), 2048):
        sc, _ = scoremax.scores_blockmax_plain(xq[s : s + 2048], xb, "ip", None, 0, len(xb), precision)
        v, i = topk.topk_plain(sc, k)
        out_v.append(v)
        out_i.append(i)
    return torch.cat(out_v), torch.cat(out_i)


def phase_knn(torch, scoremax, topk, ExactKnnIndex, device):
    g = torch.Generator().manual_seed(2)
    # multiples of 2^-6 with |x| <= 4/64: every product and sum is exact in fp32
    xb = (torch.randint(-4, 5, (131072, 512), generator=g).float() / 64).to(device)
    xq = (torch.randint(-4, 5, (8192, 512), generator=g).float() / 64).to(device)
    for k in (5, 51):
        index = ExactKnnIndex(metric="ip", device=device, precision="high")
        index.add(xb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, i = index.search(xq, k)
        t_search = time.perf_counter() - t0
        t0 = time.perf_counter()
        v0, i0 = plain_search(torch, scoremax, topk, xb, xq, k, "high")
        v0, i0 = v0.cpu().numpy(), i0.cpu().numpy()
        t_plain = time.perf_counter() - t0
        check((s == v0).all() and (i == i0).all(), f"ExactKnnIndex k={k}: differs from the plain search")
        print(f"ExactKnnIndex.search 8192 queries x 131072 rows k={k}: scores and ids exact "
              f"({t_search:.3f} s; plain whole-row sort {t_plain:.3f} s, host clock incl. copy-out)", flush=True)


def phase_run_lemon(torch, scoremax, topk):
    from lemon_tpu_torch.cli.run_lemon import main as run_lemon

    out = ROOT / "build" / "chip_smoke" / "run_lemon"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--output_dir", str(out), "--dataset", "synthetic_caption", "--synthetic_n", "20000",
            "--knn_k", "5", "--clip_model", "huggingface_clip", "--noise_type", "random"]
    stdout, stderr = sys.stdout, sys.stderr
    scoremax.scores_blockmax.launches = 0
    topk.topk.launches = 0
    t0 = time.perf_counter()
    try:
        run_lemon(argv)
    finally:
        tees = (sys.stdout, sys.stderr)
        sys.stdout, sys.stderr = stdout, stderr
        for tee in tees:
            if tee not in (stdout, stderr):
                tee.close()
    wall = time.perf_counter() - t0
    launches = {"scores_blockmax": scoremax.scores_blockmax.launches, "topk": topk.topk.launches}

    for name in ("res.pkl", "know_val_labels_scores.csv", "done"):
        check((out / name).exists(), f"run_lemon: {name} missing")
    import numpy as np
    import pandas as pd

    scores = pd.read_csv(out / "know_val_labels_scores.csv")["pred_score"].to_numpy()
    with open(out / "res.pkl", "rb") as f:
        res = pickle.load(f)
    df = res["df"]
    check(len(scores) == 20000 and np.isfinite(scores).all(), "run_lemon: non-finite or missing pred_score")
    for col in ("d_1", "dists_n", "D_n", "dists_tr_n", "dists_m", "D_m", "dists_tr_m"):
        vals = np.stack(df[col].to_list()) if col != "d_1" else df[col].to_numpy()
        check(bool(np.isfinite(vals).all()), f"run_lemon: non-finite {col}")
    agg = res["agg_results"]["know_val_labels"]
    auroc = {s: float(agg[s]["AUROC"]) for s in ("train", "val", "test")}
    timing = {}
    for line in (out / "out.txt").read_text().splitlines():
        if line.startswith("Phase timing: "):
            timing = ast.literal_eval(line.removeprefix("Phase timing: "))
    print(f"run_lemon synthetic_caption n=20000 k=5 huggingface_clip (ViT-B/32, random init): wall {wall:.2f} s; "
          f"AUROC {auroc}", flush=True)
    print("run_lemon phase timing (s): " + json.dumps({k: round(v, 4) for k, v in timing.items()}), flush=True)
    print(f"run_lemon kernel launches: {launches}", flush=True)
    check(auroc["test"] > 0.5, f"run_lemon: test AUROC {auroc['test']} <= 0.5")
    check(all(n > 0 for n in launches.values()), f"run_lemon: a kernel was not launched: {launches}")
    return launches


def phase_vit_b16_flash(torch, scoremax, topk, attention, device):
    """The from-scratch ViT-B/16 model through K3: plain and flash towers
    on one state dict, then a whole detection under flash."""
    import dataclasses

    import numpy as np

    from lemon_tpu_torch import detect
    from lemon_tpu_torch.core.profiling import PhaseTimer
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.models.clip import ClipModel
    from lemon_tpu_torch.models.encoder import ClipEncoder
    from lemon_tpu_torch.models.registry import MODEL_CONFIGS, create_encoder

    name, n, n_check = "mimic_clip_from_scratch_random", 8000, 512
    cfg = detect.DetectionConfig(dataset="synthetic_caption", noise_type="random", clip_model=name, knn_k=5,
                                 synthetic_n=n)
    timer = PhaseTimer(device)
    t0 = time.perf_counter()
    with timer.phase("load_data"):
        splits = dict(zip(("train", "val", "test"), get_dataset(
            cfg.dataset, cfg.data_seed, noise_level=cfg.noise_level, noise_type=cfg.noise_type, synthetic_n=n)))
    with timer.phase("load_model"):
        plain = create_encoder(name, device, seed=cfg.seed, batch_size=cfg.batch_size)
        model = ClipModel(dataclasses.replace(MODEL_CONFIGS[name], attention_impl="flash"))
        model.load_state_dict(plain.model.state_dict())
        flash = ClipEncoder(model, device, batch_size=cfg.batch_size, weights_fingerprint=plain.weights_fingerprint)

    head = splits["train"].subset(np.arange(n_check))
    texts = list(head.sentence)
    with timer.phase("embed_check_plain"):
        p_img, p_txt = plain.embed_split(head, texts)
    with timer.phase("embed_check_flash"):
        f_img, f_txt = flash.embed_split(head, texts)
    del plain
    err = max(float(np.abs(p_img - f_img).max()), float(np.abs(p_txt - f_txt).max()))
    print(f"ViT-B/16 ctx-256 towers, {n_check} pairs: flash vs plain embeddings max_abs_err {err:.3e} "
          f"(tol {EMBED_TOL})", flush=True)
    dim = MODEL_CONFIGS[name].embed_dim
    check(p_img.shape == (n_check, dim) and p_txt.shape == (n_check, dim), "ViT-B/16: wrong embedding shape")
    check(err <= EMBED_TOL, f"ViT-B/16: flash embeddings differ from plain by {err} > {EMBED_TOL}")

    scoremax.scores_blockmax.launches = 0
    topk.topk.launches = 0
    attention.flash_attention.launches = 0
    t1 = time.perf_counter()
    logs = detect.build_neighbor_logs(cfg, flash, splits, None, timer)  # captions: no label set
    agg, df = detect.select_and_evaluate(cfg, logs, device, timer)
    wall = time.perf_counter() - t1
    launches = {"scores_blockmax": scoremax.scores_blockmax.launches, "topk": topk.topk.launches,
                "flash_attention": attention.flash_attention.launches}

    scores = df["know_val_labels_pred_score"].to_numpy()
    check(len(scores) == n and np.isfinite(scores).all(), "ViT-B/16 detection: non-finite or missing scores")
    for col in ("d_1", "dists_n", "D_n", "dists_tr_n", "dists_m", "D_m", "dists_tr_m"):
        vals = np.stack(df[col].to_list()) if col != "d_1" else df[col].to_numpy()
        check(bool(np.isfinite(vals).all()), f"ViT-B/16 detection: non-finite {col}")
    auroc = {s: float(agg["know_val_labels"][s]["AUROC"]) for s in ("train", "val", "test")}
    print(f"detection synthetic_caption n={n} k=5 {name} (ViT-B/16 @224, text ctx 256, embed 768, random init, "
          f"attention_impl=flash): wall {wall:.2f} s (with load and the check {time.perf_counter() - t0:.2f} s); "
          f"AUROC {auroc}", flush=True)
    print("ViT-B/16 phase timing (s): " + json.dumps({k: round(v, 4) for k, v in timer.as_dict().items()}), flush=True)
    print(f"ViT-B/16 detection kernel launches: {launches}", flush=True)
    check(auroc["test"] > 0.5, f"ViT-B/16 detection: test AUROC {auroc['test']} <= 0.5")
    check(all(c > 0 for c in launches.values()), f"ViT-B/16 detection: a kernel was not launched: {launches}")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        from lemon_tpu_torch.knn.index import ExactKnnIndex, _blockmax_select
        from lemon_tpu_torch.ops import _build, attention, scoremax, select, topk
    except ImportError as e:
        fail(f"cannot import lemon_tpu_torch from {ROOT}: {e}")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}; {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({_build.library_path()})", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line and "0 bytes spill" not in line:
            print(f"  ptxas: {line.strip()}")

    k1_err, k1_times = phase_k1(torch, scoremax, device)
    k2_err, k2_times = phase_k2(torch, topk, device)
    phase_knn(torch, scoremax, topk, ExactKnnIndex, device)
    b32 = phase_run_lemon(torch, scoremax, topk)
    k3_err, k3_times = phase_k3(torch, attention, device)
    k4_times, k4_launches = phase_k4(torch, scoremax, select, topk, _blockmax_select, device)
    b16 = phase_vit_b16_flash(torch, scoremax, topk, attention, device)

    def launches(name):
        paths = {"run_lemon_vit_b32": b32.get(name, 0), "detect_vit_b16_flash": b16.get(name, 0)}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    k1_ms, k1_plain, k1_bound = k1_times[("ip", "high")]  # the main path's mode (--knn_precision auto)
    k2_ms, k2_plain, k2_sort, k2_bound = k2_times[(768, 6)]  # the main path's candidates at --knn_k 5
    k3_ms, k3_plain, k3_sdpa, k3_bound = k3_times[K3_SHAPES[0]]  # the ViT-B/16 vision tower, the path's largest attention
    k4_ms, k4_plain, _, k4_bound = k4_times[51]  # the probe's k

    def numbers(err, ms, plain_ms, bnd, library_ms):
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    print(json.dumps({"kernels": [
        {"name": "scores_blockmax", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/scoremax.cu",
         "replaces": "lemon_tpu/ops/scoremax.py:119", **launches("scores_blockmax"),
         **numbers(k1_err, k1_ms, k1_plain, k1_bound, None)},
        {"name": "topk", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/topk.cu",
         "replaces": "lemon_tpu/ops/topk.py:80", **launches("topk"),
         **numbers(k2_err, k2_ms, k2_plain, k2_bound, k2_sort)},
        {"name": "flash_attention", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/attention.cu",
         "replaces": "lemon_tpu/ops/attention.py:101", **launches("flash_attention"),
         **numbers(k3_err, k3_ms, k3_plain, k3_bound, k3_sdpa)},
        {"name": "fused_gather_topk", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/select.cu",
         "replaces": "lemon_tpu/ops/select.py:138", "launches": k4_launches,
         "launches_by_path": {"knn_select_fused_probe": k4_launches},
         **numbers(0.0, k4_ms, k4_plain, k4_bound, None)},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
