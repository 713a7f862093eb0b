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
   both; ``highest`` (the TPU's six bf16 products) also within 1e-6 of
   ``scores_blockmax_bf16x6_plain`` and no further from a float64 product
   than the fp32 plain version plus 1e-6 (the three float64 errors printed
   with ``high``'s); ``high``'s s and maxima, ip and l2, bit for bit those
   of the cp.async kernel that one template's two-piece instance replaced
   (SHA-256 of the raw bits against ``K1_HIGH_SHA256``); both split passes
   bit for bit against their plain versions, and at each precision the
   split of q, the split of db and the main kernel timed apart;
   ``torch.matmul(q, db.T)`` alone (cuBLAS SGEMM, TF32 off) as
   ``highest``'s library yardstick;
4. K2 (``topk``) against its plain version at the main path's (8192, 125)
   and (8192, 768) k=6, and at (8192, 640) k=5, (8192, 6528) k=51 and
   (8192, 1024) k=200, then the radix variant's rows of the paper's
   ``--knn_k`` grid over a 16000-row tile, (8192, 1408) k=11, (8192, 125)
   and (8192, 3968) k=31 and (8192, 16000) k=51 (with their launches in a
   B/32 detection), with ties, -inf rows and a +-0 row: values bit for bit
   and indices exact, for the variant the kernel picks and for each variant
   forced, with the load path of the radix variant's rows, the time of each
   (also device only: one replay of a CUDA graph of 20 calls, no host work
   between them) and of ``torch.sort(stable=True)``; then both variants
   where they cross over, and k=51 on rows of distinct values;
5. ``ExactKnnIndex.search`` at k=5 and k=51 over 131072 rows against a plain
   whole-row search on the card, on inputs whose scores are exact in fp32
   (so every tie is real and ids must follow the tie rule exactly), its
   time beside that of the threshold select that the row select replaced
   (``PARENT_SEARCH_S``);
6. ``python -m lemon_tpu_torch.cli.run_lemon`` in-process on 20000 synthetic
   caption pairs with ViT-B/32 at full width (random weights): output files,
   finite scores, test AUROC above 0.5, and K1 and K2 launched by that run;
7. K3 (``flash_attention``, 3xTF32 on the tensor cores) against its plain
   version and against ``flash_attention_3xtf32_plain`` (the kernel's
   precision scheme in plain fp32) at the towers' shapes, B=128:
   (197, 12, 64) and (50, 12, 64) unmasked, (256, 8, 64) and (77, 8, 64)
   causal, then the other head dims, (197, 24, 32) unmasked and
   (256, 4, 128) causal; max absolute error at most 2e-5 against both, both
   times, and the time of ``scaled_dot_product_attention`` in fp32 (TF32
   off) with the backend it ran; then (300, 197, 12, 64), more items than
   the persistent grid has blocks, untimed; at every shape the same inputs
   made contiguous give the strided call's output bit for bit. The kernel
   (``flash_attention_tf32_kernel``) loads q, k and v by TMA into an
   mbarrier ring and splits them in shared memory;
8. K4 (``fused_gather_topk``) against its plain version at q 8192 over 1024
   blocks of 128 columns, k=5 and k=51, with ties and -inf columns: values
   and ids exact; its time (also device only, as in phase 4), the plain time
   and the time of the search's own select tail (gather + K2); then over a 16000-row tile's 125 blocks at
   k=11, 31 and 51 with +-0, on a 16-byte-aligned tensor (bulk copies) and
   one 4 bytes past it (plain loads), bit for bit. Then its path once: K1
   over a 131072-row tile, the block top-k, K4, held to the search's select
   tail;
9. the from-scratch ViT-B/16 path (``mimic_clip_from_scratch_random``: 224 px
   in 16 px patches, text context 256, embed 768; random weights): 512 pairs
   embedded with one state dict under ``attention_impl="plain"`` and
   ``"flash"`` agree within 1e-4, then a detection of 8000 synthetic caption
   pairs under ``"flash"`` (``detect.build_neighbor_logs`` and
   ``detect.select_and_evaluate``): finite scores, test AUROC above 0.5, and
   K1, K2 and K3 launched by that run;
10. phase 6 again with ``LEMON_TPU_PRECISION=bf16`` (the variable is set for
    the call and restored after it) and ``--embedding_cache`` in an emptied
    directory, its phase times beside the fp32 run's;
11. K3 on bf16 inputs (the bf16 kernel: TMA into a two-stage mbarrier ring,
    one self-fed warpgroup a block, persistent) at the shapes of phase 7, as
    bf16 views of a fused QKV tensor: every element within one bf16 ulp of
    ``flash_attention_plain`` and of ``flash_attention_bf16_plain`` (the
    kernel's split scheme), its time, the plain version's and bf16
    ``scaled_dot_product_attention``'s with its backend;
12. phase 9 in the bf16 mode: 512 pairs of bf16 flash against bf16 plain
    embeddings (per-row cosine at least 0.999), the same bf16 plain
    embeddings with cuBLAS's reduced-precision bf16 reductions allowed and
    against the fp32 ones, then a detection of 8000 pairs under flash in
    bf16, whose K3 launches are all the bf16 kernel's;
13. the int8 modes at ViT-B/32 (``huggingface_clip``, random weights): 2048
    synthetic caption pairs embedded in fp32, bf16, int8 and int8_static with
    one seed's weights, each mode's embed time per 1000 pairs and per-row
    cosine to fp32 (at least 0.9, a sanity floor; the numbers are the
    record), and the first 64 pairs of each fast mode embedded again by the
    same port code on the CPU from the card's weights and calibrated scales:
    per-row cosine at least 0.999 to the card's. In the int8 modes the first
    W8A8 projection of the card's forward is held on its own input to the
    same layer on the CPU (quantised activations, int32 products and output
    bit for bit), and every W8A8 layer must have run its int8 product;
14. the probe kernels P1-P4 against their plain versions on the card at the
    probes' shapes, each timed beside its plain version and its library
    call where one exists: P4 (``tiled_matmul``: a producer warpgroup feeding
    two consumer warpgroups through a TMA ring, persistent) at 4096^3, int8
    exact (``torch._int_mm``) and bf16 within one bf16 ulp (bf16
    ``torch.matmul``);
    P3 (``block_maxima``) at q 8192 against 131072 rows and P2
    (``scores_blockmax_t``) at 4096 against 65536 with n_valid < T, at both
    precisions, within 1e-5 of the plain version and bit-equal to K1's
    block maxima (and P2's scores to K1's), at ``high`` bit-equal to the
    replaced kernel's (``P3_P2_HIGH_SHA256``), ``highest`` beside the fp32
    ``torch.matmul(q, db.T)`` alone; P1 (``topk_colids``) at
    (8192, 6528) k=51, then (8192, 1408) k=11 and (8192, 16000) k=51, with
    ties, -inf rows and a +-0 row, values bit for bit and ids exact
    (``torch.topk``). Then each probe program's ``main()`` once in-process
    (``lemon_tpu_torch.benchmarks``, ``select_limits`` among them: the
    select's split into staging, first histogram and the rest, and its
    passes a row held to ``select_rounds_plain``), every kernel count set to
    0 just before it and read just after; each P kernel, and K2, P1 and K4
    in ``select_limits``, must have run in its probe;
15. the warm repeat: phase 10's argv again in the same process. It must
    build no encoder, upload no embedding and render no pixel
    (``detect._cached_encoder.builds``, ``detect._device_embs.misses``,
    ``LazyRenderUint8Store.renders``), and its scores csv and every res.pkl
    column must be bit-identical to phase 10's; cold and warm phase times
    side by side. Then the same argv under ``LEMON_TPU_PRECISION=fp32`` must
    miss both caches;
16. ``synthetic_caption_stream`` at 62500 pairs in bf16 from an emptied
    ``LEMON_TPU_DATA_ROOT``: the run writes the ``.npy`` shards, its train
    split is the 50000-row comparison-set limit, the native shard gather
    runs (``NativeShardGather.gathers``), 2048 train rows read through the
    store equal the ram backing's bit for bit, scores are finite and K1 and
    K2 launch; the shard write time, the phase times and the host memory
    (VmRSS sampled every 50 ms through the run, ``resource.getrusage``);
17. the new encoders at full width, random init, 2000 synthetic caption
    pairs each: ``rn50`` (ModifiedResNet, embed 1024) in fp32 and bf16 and
    ``biomed_clip`` (timm ViT-B/16 + PubMedBERT at context 256) in fp32,
    through the CLI: finite scores, test AUROC above 0.5, K1 and K2
    launched, and the first 64 pairs embedded on the card against the same
    port code on the CPU from the card's weights (per-row cosine at least
    0.9999 in fp32, 0.999 in bf16);
18. the detection baselines through ``python -m
    lemon_tpu_torch.cli.run_baseline`` in bf16 at ViT-B/32 width, random
    init: clip_sim, discrepancy (dis_x, div_y) and deepknn on phase 10's
    20000 caption pairs, read from its ``.npz`` cache (3 hits each), and
    zero_shot cold on 20000 synthetic classification pairs. Output files,
    finite scores, AUROC and wall; discrepancy and deepknn must launch K1
    at precision ``highest`` (and never ``high``) and K2. Then each run's
    scoring again on the CPU from the same embeddings (deepknn with the
    card's cluster labels): pred_score within 1e-5, except deepknn rows
    whose image neighbour sets differ by an fp32 near-tie (float64
    similarity gap under 1e-5); k-means of 4000 image embeddings (distinct
    rows) into 100 clusters, twice on the card (bit-identical) and once on
    the CPU (the same labels, centroids within 1e-4);
19. contrastive training at full width (``mimic_clip_from_scratch``:
    ViT-B/16, text context 256, embed 768; random init): the step on one
    repeated batch of 128 ``BatchStream`` pairs in fp32 and bf16 (fp32 master
    weights), the loss finite and falling at every step, ms per step, pairs per second,
    ``torch.cuda.max_memory_allocated`` and one profiled step's forward /
    backward / optimizer split; then ``python -m
    lemon_tpu_torch.cli.train_clip`` in-process, each step timed between two
    synchronisations: 4 steps against 2 steps and
    ``--resume`` to 4, and ``--mesh 1x1`` (NCCL, a world of one) against no
    mesh, in fp32 under ``torch.use_deterministic_algorithms(True)`` (with
    ``CUBLAS_WORKSPACE_CONFIG`` set for this phase alone), held
    at rtol 1e-6, atol 1e-7 (bit-identical expected); 4 steps in bf16; the
    last checkpoint's state dict loaded into a ``ClipModel`` that embeds 512
    pairs. No kernel of the port runs in training: every count stays 0;
20. phase 10's argv with ``--mesh 1x1``: the sharded search of a world of
    one (K1, K2 and the K2 merge of the gathered candidates), its scores csv
    and res.pkl columns bit-identical to phase 10's, K1 and K2 launched;
21. the host C++ kNN (``ExactKnnIndex(backend="cpp")``, built with g++)
    against the card's search at precision ``highest`` on phase 10's
    embeddings (16000 x 512 comparison set, all 2000 val queries, k=6),
    images and texts: scores within 1e-5, ids equal but at near-ties (the
    two neighbours of a differing slot within NEAR_TIE in float64
    similarity); both searches also held so against the exact float64
    order;
22. downstream classification at ViT-B/32 width (random init): a detector's
    scores for 3000 synthetic classification rows (``run_baseline --baseline
    clip_sim``: dists.npy + datasplit.npy), then ``python -m
    lemon_tpu_torch.cli.run_downstream --task classification --model_size
    vit_b32 --scores dists.npy --epochs 2`` in-process at batch 64: its
    files, the kept count at the 60th percentile, finite losses, ms per step,
    images/s and ``max_memory_allocated``; the ``--epochs 0`` CIFAR-10-C
    robustness mode on a fixture of that layout written by the phase, with
    the run's ``ckpt.pt`` twice (the same predictions); one AdamW step of the
    classifier on the card against the CPU from one init and batch, TF32 off:
    loss, logits and updated parameters within ``LOSS_RTOL``, ``LOGIT_TOL``
    and AdamW's bar (in units of the rate);
23. ``run_baseline --baseline aum --img_base_name resnet50`` (the
    torchvision-layout ResNet-50 at 224 px) and ``--baseline datamap
    --img_base_name vit-base-patch16-224`` (the google ViT-B/16) on 1000
    synthetic classification rows, 2 epochs at batch 64: the files with the
    per-epoch pkls, finite scores, the ResNet's BatchNorm statistics moved by
    every step, ms per step, images/s and peak memory; one SGD step of each
    backbone on the card against the CPU, each held to a float64 step on the
    CPU (logits, parameters, BatchNorm's running statistics: the card within
    ``F64_RATIO`` times the CPU's fp32 distance). Phases 22 and 23 launch no kernel of the port (every count stays
    0): the classifiers run plain attention and PyTorch's convolutions, as
    the JAX package runs them in XLA;
24. ``run_baseline --baseline capfilt --itm_checkpoint DIR`` on 800
    synthetic caption pairs, DIR a random-init BLIP ITM at
    ``Salesforce/blip-itm-base-coco``'s widths (ViT-B/16 at 384 px, BERT-base
    with cross-attention in every layer, vocab 30524; about 224M
    parameters) written by the port's own safetensors writer with a
    generated vocab.txt and preprocessor_config.json: the files, every
    P(match) finite in [0, 1], the first 32 train pairs' P(match) within
    1e-4 of the same port code on the CPU from the card's weights, wall,
    pairs/s and peak memory; then the CLIP proxy (no checkpoint) at ViT-B/32
    width in bf16;
25. ``run_downstream --task captioning --model_size vit_b32`` on 2000
    synthetic caption pairs with phase 17's rn50 fp32 scores of the same
    pairs, 1 epoch at batch 32: GIT (ViT-B/32 and a 6-layer 512-wide
    decoder, context 40), GIT ``--lora`` and ``--captioner_arch blip2
    --lora`` (the Q-Former base: 12 layers, 768 wide, 32 queries): the files,
    the kept count and step count, ms per step, images/s, peak memory,
    generation seconds, the loss-detection AUROC; the trained model's
    per-sample losses on the first test batch within 1e-5 relative of the
    CPU's; the Q-Former run's frozen vision tower bit-stable;
26. the HF-exact BLIP-2 at ``Salesforce/blip2-opt-2.7b``'s widths (ViT-g,
    the Q-Former, OPT-2.7B; about 3.8B parameters), random init in fp32 on
    the card, one batch of 4: per-sample loss, two LoRA steps (only the
    LoRA factors change, every other parameter bit-stable), greedy
    ``generate`` to 40 tokens and ``generate_judged`` on 2 left-padded
    prompts, with their times and peak memory. Phases 24-26 launch no
    kernel of the port: the JAX package's capfilt scorer is host torch and
    its captioners plain einsums;
27. the generative judge at full width: ``save_blip2`` writes a random-init
    BLIP-2 at ``Salesforce/blip2-opt-2.7b``'s widths (all 32 OPT layers,
    seed 0) as a sharded directory in a temporary folder (removed after;
    the phase raises if the disk lacks room), then ``run_judges --judge
    llava --backend flax`` judges the 32 val and test pairs of 160
    synthetic caption pairs in batches of 8 with 16 new tokens: the files,
    every score finite in [0, 1], the first batch again with identical
    tokens, peak memory; the first batch on a 2-layer OPT at full width,
    card against CPU: equal tokens, log-probabilities within
    ``JUDGE_LOGP_TOL``; ``VdcPipeline`` on 4 examples, the VLM stage served
    by the full-width model and the LLM by a scripted host function; the
    write, load, per-batch and per-pair times. No kernel runs (the JAX
    judge's BLIP-2 is plain einsums);
28. ``python -m lemon_tpu_torch.cli.sweep launch --experiment
    synthetic_smoke --command_launcher local --yes --embedding_cache auto``:
    its four ``run_lemon`` jobs run on the card, each in a process of its
    own, and each job's log counts its K1 and K2 launches (both above 0);
    ``status`` reports 4 done; ``aggregate --root`` and ``aggregate
    --hparam_drop`` print tables over the 4 runs; the wall of each step;
29. tensor parallelism, run right after phase 20 while the card's memory is
    free: ``train_clip`` at ``mimic_clip_from_scratch`` width (every
    sublayer splits in two: 12 vision and 8 text heads), fp32, batch 32, 4
    AdamW steps, and ``run_lemon`` in bf16 on 2000 pairs, first in this
    process without a mesh, then in two spawned ranks on the one card
    with ``--mesh 1x2`` over a gloo group of CUDA tensors (NCCL refuses two
    ranks on one device): the losses within 1e-4, the final checkpoint's
    parameters in units of the rate, the checkpoint in the single-process
    layout and loading into a ``ClipModel`` that embeds 512 pairs, the
    replicated parameters bit-identical across the ranks, the detection's
    scores csv and res.pkl columns bit-identical, each run's files written
    once; each rank's ms per step, peak memory and the bytes all-reduced
    over the model group (gloo stages them through host memory: no measure
    of tensor parallelism's speed). The training launches no kernel, the
    detections K1 and K2.

The switches: TF32 off for fp32 products and convolutions, and cuBLAS's
reduced-precision reductions of bf16 products off, as the CLI sets them
(``core/device.resolve_device``); phase 12 measures the latter on.

Every kernel line prints its bound: the larger of the bytes it must move
(each input read once, each output written once) over 3.35 TB/s and its
operations over the peak rate of their type (989 TFLOP/s bf16, 1979 TOP/s
int8 and 495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s fp32), and the
share of the bound that the kernel reaches. K3's lines and K1 ``highest``'s
also print the fp32 bound of their products on the CUDA cores, the bound of
the kernel each replaced.
K1's launches are counted by precision: its entry ``scores_blockmax`` is
``high``'s, ``scores_blockmax_highest`` the bf16x6 mode's.
The second-to-last line is a JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
K1_TOL = 1e-5
K1_BF16X6_TOL = 1e-6  # K1 'highest' vs its bf16x6 plain version: the same exact products, fp32 sums in another order
K1_F64_MARGIN = 1e-6  # K1 'highest' against float64: at most the fp32 plain version's own error plus this
K3_TOL = 2e-5  # tests/test_attention.py:26: fp32 with another summation order
EMBED_TOL = 1e-4  # tests/test_attention.py:56-57: the towers, plain vs flash
BF16_FLASH_COS = 0.999  # per row, bf16 flash vs bf16 plain: the plain route's logits and softmax are bf16
CARD_CPU_COS = 0.999  # per row, a fast mode on the card vs the same code on the CPU (int32 sums exact on both)
BASELINE_TOL = 1e-5  # a baseline's pred_score, card vs CPU on the same embeddings
# float64 similarity gap of two image neighbours that the card's K1 and the
# CPU's matmul may rank in either order: about 14 times the largest gap read
# on an H100 (7e-7, 13 of 20000 deepknn rows)
NEAR_TIE = 1e-5
KMEANS_TOL, KMEANS_ROWS = 1e-4, 4000  # k-means centroids card vs CPU, on this many image embeddings
FP32_FLOOR_COS = 0.9  # per row, a fast mode vs fp32 at full width: a sanity floor, the measured value is the record
# (L, heads, head dim, causal) of the towers' attention: ViT-B/16 vision,
# ctx-256 text, ViT-B/32 vision, ctx-77 text; then the other two head dims
K3_SHAPES = ((197, 12, 64, False), (256, 8, 64, True), (50, 12, 64, False), (77, 8, 64, True),
             (197, 24, 32, False), (256, 4, 128, True))
# (B, L, heads, head dim, causal) K3 checks without timing: more items than
# the persistent grid has blocks
K3_CHECK_SHAPES = ((300, 197, 12, 64, False),)
# (W, k) of K2: the main path's block maxima (T/128 of a 16000-row tile) and
# candidates ((k+1)*128) at --knn_k 5, then k=5, k=51 and k=200 candidates,
# then the radix variant's rows at the paper's --knn_k grid over a 16000-row
# tile (20000 B/32 pairs): the candidates at knn_k 10, the block maxima and
# candidates at knn_k 30 (W = 125 is staged by plain loads), and the whole
# tile at knn_k 50, where the prefilter does not pay
K2_SHAPES = ((125, 6), (768, 6), (640, 5), (6528, 51), (1024, 200), (1408, 11), (125, 31), (3968, 31), (16000, 51))
# K2 in one B/32 detection of 20000 pairs (lemon_tpu_torch.knn.index, six
# searches; counted in a CPU run at each --knn_k): (W, k) of the grid ->
# (launches at this shape, its --knn_k, the radix launches of that detection
# in all; the val and test searches, 2000 queries, run k = knn_k)
K2_DETECTION_LAUNCHES = {(1408, 11): (4, 10, 8), (125, 31): (4, 30, 16), (3968, 31): (4, 30, 16),
                         (16000, 51): (4, 50, 8)}
# (W, k, rows) where the two K2 variants are compared: their crossover on
# tie-heavy rows, and k=51 on rows of distinct (Gaussian) values
K2_CROSSOVER = ((1024, 16, "ties"), (1024, 32, "ties"), (640, 51, "ties"), (6528, 51, "gaussian"))
# H100 SXM peaks (NVIDIA data sheet, dense): memory bytes/s, bf16, TF32 and int8 tensor-core and fp32 (FL)OP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12}
PROBES = ("probe_pallas_int8", "probe_knn_decomp", "probe_scoremax2", "probe_knn_select3", "select_limits")
# the probes' shapes: P4's M = K = N; P3's and P2's (queries, columns, n_valid); P1's (rows, width, k), the
# probe's first, then the candidates at --knn_k 10 and the whole 16000-row tile at --knn_k 50
P4_SIZE = 4096
P3_P2_SHAPES = (("P3", 8192, 131072, None), ("P2", 4096, 65536, 65000))
P1_SHAPES = ((8192, 6528, 51), (8192, 1408, 11), (8192, 16000, 51))
# K4's (n_blocks, k) beyond phase 8's 1024 blocks: the 16000-row tile's 125 blocks at --knn_k 10, 30, 50
K4_TILE_SHAPES = ((125, 11), (125, 31), (125, 51))
# host seconds of phase 5's search (8192 queries x 131072 rows) with the
# threshold select that the row select replaced, in a run of this script on an
# NVIDIA H100 80GB HBM3 at 700 W
PARENT_SEARCH_S = {5: 0.062, 51: 0.010}
# SHA-256 of the raw bits of (s, bmax) that K1's cp.async kernel at 'high'
# (its main-loop kernel until the two-piece instance of one template took
# its place) wrote on an H100 at phase 3's inputs and n_valid, and (s or
# None, bmax) of P3 and P2 at phase 14's: the template's 'high' must write
# them bit for bit
K1_HIGH_SHA256 = {
    "ip": ("480ed7f1b15dafbbe2d7dbe186c19a340a7771dae7898a2b52c585df6d3f52dd",
           "8fb6fa8054b9c867b2bf598983efc3cda0c9e47d32e3d4884befc8248523d815"),
    "l2": ("a679ea91a491b5ab7d7d7fef602bc505b57897908cd37b2252a26be3f8963e6f",
           "b0ca6fcda7a63b5f998d00b7c6b8f76476b36f2781e09fbd46bf223326bbefb1")}
P3_P2_HIGH_SHA256 = {
    "P3": (None, "adbadbb1b5eb24f3d49ef9279f47196c8a1f7ea311c15e82981c1be1dc251bbb"),
    "P2": ("8ebdeb17240b0ee55e2e4c0001c7f22a551a33cec6bd0b81ee24052f7d00e840",
           "ceb6580daec6af52ce81789c34e14873b4f82e7e5155e76e02e464b6de9e0eb0")}
# K1's main-loop kernel at both precisions (csrc/scoremax.cu), by its piece count
K1_KERNEL = ("scores_split_kernel<{}>: a TMA producer warpgroup, a 4-stage ring of 32-deep stages, two m64n128 "
             "consumers, persistent, s staged and stored by TMA")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def paired_ms(torch, kernel, plain, iters: int):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(torch, fn) -> float:
    """Device-only ms per call (``graph_ms``: one replay of a CUDA graph of
    20 calls); NaN, with the reason printed, if the capture fails."""
    try:
        return graph_ms(fn, 20)
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"  device-only time not measured: the CUDA graph capture failed ({e})", flush=True)
        return float("nan")


def bound(n_bytes: float, n_ops: float, peak: str):
    """(ms, what sets it): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_text(b, ms: float) -> str:
    return f"bound {b[0]:.4f} ms ({b[1]}), {b[0] / ms:.1%} of it"


def one_bf16_ulp_err(torch, out, ref):
    """(worst |out - ref| in units of one bf16 ulp of ref, max abs error):
    the ulp of each element taken at no less than 2^-8 of ref's largest
    magnitude (closer to zero the fp32 sums' own rounding is more than one
    ulp of the element; tests/test_torch_attention.py states the same)."""
    out, ref = out.float(), ref.float()
    mag = torch.maximum(ref.abs(), ref.abs().max() * 2.0**-8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (out - ref).abs()
    return (diff / ulp).max().item(), diff.max().item()


def row_cos(torch, a, b):
    """Per-row cosine of two (N, D) numpy arrays: (min, mean)."""
    a, b = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    c = torch.nn.functional.cosine_similarity(a, b, dim=1)
    return c.min().item(), c.mean().item()


def sha256(t) -> str:
    """SHA-256 of a tensor's raw bits."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def unit_rows(torch, g, n, d, device):
    x = torch.randn(n, d, generator=g)
    return (x / x.norm(dim=1, keepdim=True)).to(device)


def phase_k1(torch, scoremax, device):
    """K1 at both precisions against its plain versions, ``highest``
    against float64 and ``high`` against the replaced kernel's bits. Returns
    (worst error, {(metric, precision): (ms, plain ms, bound, max_abs_err)},
    ``torch.matmul`` ms, {precision: ip's split passes and main kernel
    timed apart})."""
    b, t, d = 8192, 16000, 512
    g = torch.Generator().manual_seed(0)
    q = unit_rows(torch, g, b, d, device)
    db = unit_rows(torch, g, t, d, device)
    dbsq = (db * db).sum(1)
    n_valid = 15900
    worst = 0.0
    times = {}
    for x, name in ((q, "q"), (db, "db")):
        for split, plain in ((scoremax.split_bf16, scoremax.split_bf16_plain),
                             (scoremax.split_bf16x3, scoremax.split_bf16x3_plain)):
            pieces, pieces0 = split(x), plain(x)
            torch.cuda.synchronize()
            check(all(bool(torch.equal(a.view(torch.int16), a0.view(torch.int16))) for a, a0 in zip(pieces, pieces0)),
                  f"K1 split pass of {name} ({split.__name__}): differs from the plain split")
    print("K1 split passes (bf16 hi/lo and hi/mid/lo of q and db, D padded to 64): bit-equal to the plain splits",
          flush=True)
    for metric in ("ip", "l2"):
        s64 = q.double() @ db.double().T
        if metric == "l2":
            s64 = -(((q.double() ** 2).sum(1, keepdim=True) - 2 * s64) + dbsq.double()[None, :])
        f64_err = {}
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
            f64_err[precision] = (s.double() - s64)[fin].abs().max().item()
            extra = ""
            if precision == "high":
                check((sha256(s), sha256(bm)) == K1_HIGH_SHA256[metric],
                      f"K1 {metric}/high: s or bmax differ from the replaced kernel's bits")
                extra = "; s and bmax bit-equal to the replaced kernel's (SHA-256)"
            if precision == "highest":
                s6, bm6 = scoremax.scores_blockmax_bf16x6_plain(*args[:-1])
                err6 = max((s - s6)[fin].abs().max().item(), (bm - bm6).abs().max().item())
                f64_err["fp32 plain"] = (s0.double() - s64)[fin].abs().max().item()
                del s6, bm6
                extra = f"; against the bf16x6 plain {err6:.3e} (tol {K1_BF16X6_TOL})"
                check(err6 <= K1_BF16X6_TOL, f"K1 {metric}/highest: {err6} from the bf16x6 plain > {K1_BF16X6_TOL}")
            del s, bm, s0, bm0
            ms, plain_ms = paired_ms(torch, lambda: scoremax.scores_blockmax(*args), lambda: scoremax.scores_blockmax_plain(*args), 10)
            n_bytes = 4 * (b * d + t * d + (t if metric == "l2" else 0) + b * t + b * t // 128)
            # 'high': 3 bf16 products; 'highest': 6, beside the bound of fp32 products on the CUDA cores
            bnd = bound(n_bytes, (3 if precision == "high" else 6) * 2 * b * t * d, "bf16")
            timing = f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; {bound_text(bnd, ms)}"
            if precision == "highest":
                plain6_ms = cuda_ms(lambda: scoremax.scores_blockmax_bf16x6_plain(*args[:-1]), 3)
                timing += (f"; fp32 products' {bound_text(bound(n_bytes, 2 * b * t * d, 'fp32'), ms)}; "
                           f"bf16x6 plain {plain6_ms:.3f} ms")
            times[(metric, precision)] = (ms, plain_ms, bnd, max(err, berr))
            print(f"K1 scores_blockmax {metric}/{precision} (8192x512 . 16000x512): max_abs_err {err:.3e} "
                  f"(bmax {berr:.3e}, tol {K1_TOL}){extra}; {timing}", flush=True)
            check(err <= K1_TOL and berr <= K1_TOL, f"K1 {metric}/{precision}: error {err} > {K1_TOL}")
            worst = max(worst, err, berr)
        del s64
        print(f"K1 {metric} against float64: 'highest' kernel {f64_err['highest']:.3e}, fp32 plain "
              f"{f64_err['fp32 plain']:.3e}, 'high' kernel {f64_err['high']:.3e}", flush=True)
        check(f64_err["highest"] <= f64_err["fp32 plain"] + K1_F64_MARGIN,
              f"K1 {metric}/highest: {f64_err['highest']} from float64, more than the fp32 plain's "
              f"{f64_err['fp32 plain']} + {K1_F64_MARGIN}")
    parts = {}
    for precision, split in (("high", scoremax.split_bf16), ("highest", scoremax.split_bf16x3)):
        pq, pdb = split(q), split(db)
        parts[precision] = {"split_q_ms": cuda_ms(lambda: split(q), 10), "split_db_ms": cuda_ms(lambda: split(db), 10),
                            "main_ms": cuda_ms(lambda: scoremax.launch_split(pq, pdb, n_valid=n_valid), 10)}
        del pq, pdb
        print(f"K1 ip/{precision} apart: split of q {parts[precision]['split_q_ms']:.4f} ms, split of db "
              f"{parts[precision]['split_db_ms']:.4f} ms, main kernel {parts[precision]['main_ms']:.4f} ms "
              f"(the call {times[('ip', precision)][0]:.4f} ms)", flush=True)
    mm_ms = cuda_ms(lambda: torch.matmul(q, db.T), 10)
    print(f"K1 library yardstick: torch.matmul(q, db.T) alone (cuBLAS SGEMM, TF32 off) {mm_ms:.3f} ms; K1 ip/highest "
          f"{times[('ip', 'highest')][0]:.3f} ms", flush=True)
    return worst, times, mm_ms, parts


def topk_inputs(torch, g, b, w, device):
    x = torch.randint(0, 40, (b, w), generator=g).float() / 4  # many exact ties
    x[0] = -torch.inf
    x[1, 3:] = -torch.inf
    x[2, : w // 2] = -torch.inf
    x[3] = torch.tensor([-0.0, 0.0, -0.5])[torch.arange(w) % 3]  # +-0 tie, and their sign bits are kept
    return x.to(device)


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (torch.equal takes -0.0 for +0.0)."""
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


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
            check(same_bits(torch, v, v0) and bool(torch.equal(i, i0)),
                  f"K2 ({w}, k={k}) {variant}: differs from the plain version")
        fin = torch.isfinite(v0)
        worst = max(worst, (v - v0)[fin].abs().max().item())
        ms, plain_ms = paired_ms(torch, lambda: topk.topk(x, k), lambda: topk.topk_plain(x, k), 20)
        sort_ms = cuda_ms(lambda: torch.sort(x, dim=1, descending=True, stable=True), 20)
        by_variant = {m: cuda_ms(lambda: topk.topk(x, k, m), 20) for m in variants[1:]}
        dev_ms = device_ms(torch, lambda: topk.topk(x, k))
        bnd = bound(4 * b * w + 12 * b * k, b * w, "fp32")
        times[(w, k)] = (ms, plain_ms, sort_ms, bnd, dev_ms)
        print(f"K2 topk (8192, {w}) k={k}: values (bits) and indices exact ({', '.join(variants)}; radix rows "
              f"staged by {topk.radix_load(x, k)}); kernel {ms:.4f} ms (device only, a CUDA graph of 20 calls: "
              f"{dev_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, torch.sort(stable=True) {sort_ms:.4f} ms; by variant "
              + ", ".join(f"{m} {t:.4f} ms" for m, t in by_variant.items()) + f"; {bound_text(bnd, ms)}"
              + ("; launches in a B/32 detection of 20000 pairs at --knn_k {1}: {0} at this shape, {2} radix in all"
                 .format(*K2_DETECTION_LAUNCHES[(w, k)]) if (w, k) in K2_DETECTION_LAUNCHES else ""), flush=True)
    for w, k, rows in K2_CROSSOVER:
        x = topk_inputs(torch, g, b, w, device) if rows == "ties" else torch.randn(b, w, generator=g).to(device)
        v0, i0 = topk.topk_plain(x, k)
        by_variant = {}
        for variant in [m for m in ("warp", "radix") if m != "warp" or w <= topk.WARP_MAX_W]:
            v, i = topk.topk(x, k, variant)
            torch.cuda.synchronize()
            check(same_bits(torch, v, v0) and bool(torch.equal(i, i0)),
                  f"K2 ({w}, k={k}, {rows}) {variant}: differs from the plain version")
            by_variant[variant] = cuda_ms(lambda: topk.topk(x, k, variant), 20)
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
        emu = attention.flash_attention_3xtf32_plain(q, k, v, causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's (B, H, L, D)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)  # noqa: E731
        sdpa_err = (sdpa().transpose(1, 2) - ref).abs().max().item()
        torch.cuda.synchronize()
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()), f"K3 {(l, h, d, causal)}: bad output")
        err = (out - ref).abs().max().item()
        emu_err = (out - emu).abs().max().item()
        ms, plain_ms = paired_ms(torch, lambda: attention.flash_attention(q, k, v, causal),
                                 lambda: attention.flash_attention_plain(q, k, v, causal), 20)
        sdpa_ms = cuda_ms(sdpa, 20)
        pairs = l * (l + 1) // 2 if causal else l * l  # the query-key pairs the mask keeps
        n_bytes, n_ops = 4 * 4 * b * l * h * d, 4 * b * h * d * pairs
        bnd = bound(n_bytes, 3 * n_ops, "tf32")  # three TF32 products
        fp32_bnd = bound(n_bytes, n_ops, "fp32")  # the bound of the CUDA-core kernel it replaced
        times[(l, h, d, causal)] = (ms, plain_ms, sdpa_ms, bnd)
        print(f"K3 flash_attention (128, {l}, {h}, {d}) {'causal' if causal else 'unmasked'}: max_abs_err {err:.3e} "
              f"(3xTF32 plain {emu_err:.3e}; tol {K3_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {sdpa_ms:.4f} ms ({sdpa_backend(torch, qt, kt, vt, causal)}, fp32, "
              f"max_abs_err {sdpa_err:.3e}); {bound_text(bnd, ms)}; fp32 bound {fp32_bnd[0]:.4f} ms ({fp32_bnd[1]})",
              flush=True)
        check(err <= K3_TOL and emu_err <= K3_TOL, f"K3 {(l, h, d, causal)}: error {err}, {emu_err} > {K3_TOL}")
        same = attention.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal)
        check(bool(torch.equal(same, out)), f"K3 {(l, h, d, causal)}: contiguous inputs give another output")
        worst = max(worst, err)
    for b, l, h, d, causal in K3_CHECK_SHAPES:  # not timed: more items than the grid has blocks
        x = torch.randn(b, l, 3 * h * d, device=device, generator=g)
        q, k, v = (t.reshape(b, l, h, d) for t in x.split(h * d, dim=-1))
        out = attention.flash_attention(q, k, v, causal)
        err = (out - attention.flash_attention_plain(q, k, v, causal)).abs().max().item()
        emu_err = (out - attention.flash_attention_3xtf32_plain(q, k, v, causal)).abs().max().item()
        same = attention.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal)
        print(f"K3 flash_attention ({b}, {l}, {h}, {d}) {'causal' if causal else 'unmasked'}: max_abs_err {err:.3e} "
              f"(3xTF32 plain {emu_err:.3e}; tol {K3_TOL}); contiguous inputs bit-equal: "
              f"{bool(torch.equal(same, out))}", flush=True)
        check(err <= K3_TOL and emu_err <= K3_TOL, f"K3 {(b, l, h, d, causal)}: error {err}, {emu_err} > {K3_TOL}")
        check(bool(torch.equal(same, out)), f"K3 {(b, l, h, d, causal)}: contiguous inputs give another output")
        worst = max(worst, err)
    return worst, times


def phase_k3_bf16(torch, attention, device):
    """K3's bf16 kernel at the shapes of phase 7: within one bf16 ulp of both
    plain versions, timed beside the plain version and bf16 SDPA."""
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(13)
    worst = 0.0
    times = {}
    for l, h, d, causal in K3_SHAPES:
        b = 128
        x = torch.randn(b, l, 3 * h * d, device=device, generator=g).bfloat16()
        q, k, v = (t.reshape(b, l, h, d) for t in x.split(h * d, dim=-1))  # the towers' strided bf16 views
        out = attention.flash_attention(q, k, v, causal)
        ref = attention.flash_attention_plain(q, k, v, causal)
        emu = attention.flash_attention_bf16_plain(q, k, v, causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)  # noqa: E731
        sdpa_ulps, _ = one_bf16_ulp_err(torch, sdpa().transpose(1, 2), ref)
        torch.cuda.synchronize()
        check(out.dtype == torch.bfloat16 and out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"K3 bf16 {(l, h, d, causal)}: bad output")
        ulps, err = one_bf16_ulp_err(torch, out, ref)
        emu_ulps, _ = one_bf16_ulp_err(torch, out, emu)
        ms, plain_ms = paired_ms(torch, lambda: attention.flash_attention(q, k, v, causal),
                                 lambda: attention.flash_attention_plain(q, k, v, causal), 20)
        sdpa_ms = cuda_ms(sdpa, 20)
        pairs = l * (l + 1) // 2 if causal else l * l
        # q, k, v, o in bf16; the kernel's three bf16 products (S, p_hi.V, p_lo.V), 2*b*h*d*pairs operations each
        bnd = bound(2 * 4 * b * l * h * d, 3 * 2 * b * h * d * pairs, "bf16")
        times[(l, h, d, causal)] = (ms, plain_ms, sdpa_ms, bnd)
        print(f"K3 bf16 flash_attention (128, {l}, {h}, {d}) {'causal' if causal else 'unmasked'}: "
              f"{ulps:.3f} bf16 ulp of the plain version (max_abs_err {err:.3e}), {emu_ulps:.3f} of the split "
              f"plain version (tol 1); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
              f"{sdpa_ms:.4f} ms ({sdpa_backend(torch, qt, kt, vt, causal)}, bf16, {sdpa_ulps:.2f} ulp); "
              f"{bound_text(bnd, ms)}", flush=True)
        check(ulps <= 1 and emu_ulps <= 1, f"K3 bf16 {(l, h, d, causal)}: {ulps}, {emu_ulps} bf16 ulp > 1")
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
        check(same_bits(torch, v, v0) and bool(torch.equal(i, i0)), f"K4 k={k}: differs from the plain version")
        ms, plain_ms = paired_ms(torch, lambda: select.fused_gather_topk(sb, ids, k),
                                 lambda: select.fused_gather_topk_plain(sb, ids, k), 20)
        tail_ms = cuda_ms(lambda: select.gather_then_topk(sb, ids, k, topk.topk), 20)
        dev_ms = device_ms(torch, lambda: select.fused_gather_topk(sb, ids, k))
        bnd = bound(4 * b * k * 128 + 8 * b * k + 12 * b * k, b * k * 128, "fp32")
        times[k] = (ms, plain_ms, tail_ms, bnd, dev_ms)
        print(f"K4 fused_gather_topk (8192, 1024 blocks) k={k}: values and ids exact (rows staged by "
              f"{select.gather_load(sb, k)}); kernel {ms:.3f} ms (device only, a CUDA graph of 20 calls: "
              f"{dev_ms:.4f} ms), "
              f"plain {plain_ms:.3f} ms, the search's select tail (gather + K2) {tail_ms:.3f} ms; "
              f"{bound_text(bnd, ms)}", flush=True)
    del s, sb, bmax
    for nb, k in K4_TILE_SHAPES:  # the 16000-row tile, tie-heavy with +-0, aligned and not
        s = torch.randint(0, 40, (b, nb * 128), device=device, generator=g, dtype=torch.int32).float() / 4
        s[0] = -torch.inf
        s[1, 300:] = -torch.inf
        s[2, ::3] = -0.0
        s[2, 1::3] = 0.0
        buf = torch.empty(s.numel() + 1, device=device)
        for sb in (s.view(b, nb, 128), buf[1:].view(b, nb, 128).copy_(s.view(b, nb, 128))):
            ids = topk.topk(sb.amax(2), k)[1].sort(dim=1).values
            v, i = select.fused_gather_topk(sb, ids, k)
            v0, i0 = select.fused_gather_topk_plain(sb, ids, k)
            torch.cuda.synchronize()
            check(same_bits(torch, v, v0) and bool(torch.equal(i, i0)),
                  f"K4 ({nb} blocks) k={k}: differs from the plain version")
            ms = cuda_ms(lambda: select.fused_gather_topk(sb, ids, k), 20)
            print(f"K4 fused_gather_topk (8192, {nb} blocks) k={k}: values and ids exact (rows staged by "
                  f"{select.gather_load(sb, k)}); kernel {ms:.4f} ms", flush=True)
        del s, buf, sb

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
              f"({t_search:.3f} s; the threshold select {PARENT_SEARCH_S[k]:.3f} s; plain whole-row "
              f"sort {t_plain:.3f} s, host clock incl. copy-out)", flush=True)


RUNS = ROOT / "build" / "chip_smoke"
B32_ARGV = ["--dataset", "synthetic_caption", "--synthetic_n", "20000", "--knn_k", "5", "--clip_model",
            "huggingface_clip", "--noise_type", "random"]
COMPONENTS = ("d_1", "dists_n", "D_n", "dists_tr_n", "dists_m", "D_m", "dists_tr_m")
K1_K2 = ("scores_blockmax", "topk")  # a detection's kNN kernels (K1 in its 'high' mode)


def run_cli(scoremax, topk, argv, env):
    """``run_lemon(argv)`` in-process (:func:`run_entry`). Returns (kernel
    launches, wall seconds, what the call wrote to out.txt)."""
    from lemon_tpu_torch.cli.run_lemon import main as run_lemon

    return run_entry(run_lemon, scoremax, topk, argv, env)[:3]


def restore_streams(stdout, stderr) -> None:
    """Put the caller's ``stdout`` and ``stderr`` back after a CLI call,
    closing the tees its lead rank opened into its out.txt."""
    tees = (sys.stdout, sys.stderr)
    sys.stdout, sys.stderr = stdout, stderr
    for tee in tees:
        if tee not in (stdout, stderr):
            tee.close()


def run_entry(entry, scoremax, topk, argv, env):
    """``entry(argv)``, a CLI's ``main``, in-process with the environment
    ``env`` set for the call and restored after it, K1's and K2's counts set
    to 0 just before it. Returns (kernel launches, wall seconds, what the
    call wrote to out.txt, what ``entry`` returned); K1's launches are
    split by precision, ``scores_blockmax`` (``high``) and
    ``scores_blockmax_highest``."""
    log_file = Path(argv[argv.index("--output_dir") + 1]) / "out.txt"
    offset = log_file.stat().st_size if log_file.exists() else 0
    stdout, stderr = sys.stdout, sys.stderr
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    scoremax.scores_blockmax.launches = 0
    scoremax.scores_blockmax.launches_highest = 0
    topk.topk.launches = 0
    t0 = time.perf_counter()
    try:
        result = entry(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        restore_streams(stdout, stderr)
    wall = time.perf_counter() - t0
    return k1_k2_launches(scoremax, topk), wall, log_file.read_bytes()[offset:].decode(), result


def k1_k2_launches(scoremax, topk) -> dict:
    highest = scoremax.scores_blockmax.launches_highest
    return {"scores_blockmax": scoremax.scores_blockmax.launches - highest, "scores_blockmax_highest": highest,
            "topk": topk.topk.launches}


def check_launched(launches: dict, kernels, label: str) -> None:
    check(all(launches[k] > 0 for k in kernels), f"{label}: a kernel was not launched: {launches}")


def read_run(out, n: int, label: str, log: str):
    """A run_lemon output directory held to the output contract: the files,
    ``n`` finite scores, finite components, test AUROC above 0.5. Returns
    (res.pkl, the scores csv's bytes, AUROC by split, phase timing)."""
    import numpy as np
    import pandas as pd

    for name in ("res.pkl", "know_val_labels_scores.csv", "done"):
        check((out / name).exists(), f"{label}: {name} missing")
    csv = (out / "know_val_labels_scores.csv").read_bytes()
    scores = pd.read_csv(out / "know_val_labels_scores.csv")["pred_score"].to_numpy()
    with open(out / "res.pkl", "rb") as f:
        res = pickle.load(f)
    df = res["df"]
    check(len(scores) == n and np.isfinite(scores).all(), f"{label}: non-finite or missing pred_score")
    for col in COMPONENTS:
        vals = np.stack(df[col].to_list()) if col != "d_1" else df[col].to_numpy()
        check(bool(np.isfinite(vals).all()), f"{label}: non-finite {col}")
    agg = res["agg_results"]["know_val_labels"]
    auroc = {s: float(agg[s]["AUROC"]) for s in ("train", "val", "test")}
    timing = {}
    for line in log.splitlines():
        if line.startswith("Phase timing: "):
            timing = ast.literal_eval(line.removeprefix("Phase timing: "))
    check(bool(timing), f"{label}: no phase timing in its log")
    check(auroc["test"] > 0.5, f"{label}: test AUROC {auroc['test']} <= 0.5")
    return res, csv, auroc, timing


def phase_run_lemon(torch, scoremax, topk, precision: str = "fp32", embedding_cache=None):
    """``run_lemon`` in-process with ``LEMON_TPU_PRECISION=precision`` set
    for the call (and ``--embedding_cache`` when given); (kernel launches,
    phase timing, the run: argv, res.pkl, scores csv bytes)."""
    out = RUNS / f"run_lemon_{precision}"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--output_dir", str(out), *B32_ARGV]
    if embedding_cache is not None:
        argv += ["--embedding_cache", str(embedding_cache)]
    launches, wall, log = run_cli(scoremax, topk, argv, {"LEMON_TPU_PRECISION": precision})
    res, csv, auroc, timing = read_run(out, 20000, f"run_lemon {precision}", log)
    check("precision: Precision(" in log and (precision == "fp32") == ("compute_dtype=torch.float32" in log),
          f"run_lemon {precision}: the run did not take the mode")
    print(f"run_lemon {precision} synthetic_caption n=20000 k=5 huggingface_clip (ViT-B/32, random init): "
          f"wall {wall:.2f} s; AUROC {auroc}", flush=True)
    print(f"run_lemon {precision} phase timing (s): " + json.dumps({k: round(v, 4) for k, v in timing.items()}),
          flush=True)
    print(f"run_lemon {precision} kernel launches: {launches}", flush=True)
    check_launched(launches, K1_K2, f"run_lemon {precision}")
    return launches, timing, {"argv": argv, "res": res, "csv": csv, "wall": wall}


def cache_counts():
    from lemon_tpu_torch import detect
    from lemon_tpu_torch.data.streaming import LazyRenderUint8Store

    return {"encoder_builds": detect._cached_encoder.builds, "embedding_uploads": detect._device_embs.misses,
            "embedding_hits": detect._device_embs.hits, "renders": LazyRenderUint8Store.renders}


def phase_warm_repeat(torch, scoremax, topk, cold, cold_timing):
    """Phase 15: phase 10's argv (bf16, ``--embedding_cache``) again in the
    same process. The warm call builds no encoder, uploads no embedding and
    renders no pixel, and its scores and every res.pkl column are
    bit-identical to the cold call's; then the same argv in fp32 misses both
    caches. Returns {path: kernel launches}."""
    before = cache_counts()
    launches, wall, log = run_cli(scoremax, topk, cold["argv"], {"LEMON_TPU_PRECISION": "bf16"})
    after = cache_counts()
    delta = {k: after[k] - before[k] for k in after}
    res, csv, auroc, timing = read_run(Path(cold["argv"][1]), 20000, "warm repeat", log)
    print(f"warm repeat (bf16, --embedding_cache, same argv, same process): wall {wall:.2f} s against the cold "
          f"{cold['wall']:.2f} s; caches {delta}; AUROC {auroc}", flush=True)
    print_side_by_side("run_lemon ViT-B/32 bf16", cold_timing, timing, ("cold", "warm"))
    print(f"warm repeat kernel launches: {launches}", flush=True)
    check(delta["encoder_builds"] == 0 and delta["embedding_uploads"] == 0 and delta["renders"] == 0,
          f"warm repeat: a cache missed: {delta}")
    check("encoder cache hit" in log and "precision: Precision(" in log, "warm repeat: no encoder cache hit logged")
    check(csv == cold["csv"], "warm repeat: the scores csv differs from the cold call's")
    df0, df1 = cold["res"]["df"], res["df"]
    check(list(df0.columns) == list(df1.columns), "warm repeat: res.pkl columns differ")
    for col in df0.columns:
        a, b = df0[col].to_list(), df1[col].to_list()
        same = len(a) == len(b) and all(
            (x.tobytes() == y.tobytes()) if hasattr(x, "tobytes") else (x == y or (x != x and y != y))
            for x, y in zip(a, b))
        check(same, f"warm repeat: res.pkl column {col} differs from the cold call's")
    check(res["agg_results"] == cold["res"]["agg_results"], "warm repeat: agg_results differ")
    check_launched(launches, K1_K2, "warm repeat")
    print(f"warm repeat: pred_score and all {len(df0.columns)} res.pkl columns bit-identical to the cold call's",
          flush=True)

    before = cache_counts()
    fp32_launches, wall, log = run_cli(scoremax, topk, cold["argv"], {"LEMON_TPU_PRECISION": "fp32"})
    after = cache_counts()
    delta = {k: after[k] - before[k] for k in after}
    read_run(Path(cold["argv"][1]), 20000, "repeat in fp32", log)
    print(f"the same argv under LEMON_TPU_PRECISION=fp32: wall {wall:.2f} s; caches {delta}", flush=True)
    check(delta["encoder_builds"] == 1 and delta["embedding_uploads"] == 3 and delta["embedding_hits"] == 0,
          f"repeat in fp32: a cache did not miss: {delta}")
    check("compute_dtype=torch.float32" in log and "encoder cache hit" not in log, "repeat in fp32: wrong mode")
    return {"run_lemon_vit_b32_bf16_warm": launches, "run_lemon_vit_b32_fp32_after_bf16_cache": fp32_launches}


def rss_mib() -> float:
    """This process's resident set (VmRSS of /proc/self/status), MiB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
    fail("no VmRSS in /proc/self/status")


class RssPeak:
    """The largest VmRSS sampled every 50 ms between ``__enter__`` and
    ``__exit__`` (the kernel's high-water mark cannot be reset on every
    host, so a phase's own peak is sampled)."""

    def __enter__(self):
        import threading

        self.start = self.peak = rss_mib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, rss_mib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.end = rss_mib()
        self.peak = max(self.peak, self.end)


def phase_stream(torch, scoremax, topk, n: int = 62500):
    """Phase 16: ``synthetic_caption_stream`` at 62500 pairs in bf16 from an
    emptied data root, so the train split is the 50000-row comparison-set
    limit and the shards are written by the run. The native gather ran; 2048
    train rows read through the store equal the ram backing's bit for bit.
    Returns the run's kernel launches."""
    import numpy as np

    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.data.native_loader import NativeShardGather

    root, out = RUNS / "data_root", RUNS / "stream"
    for d in (root, out):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["--output_dir", str(out), "--dataset", "synthetic_caption_stream", "--synthetic_n", str(n), "--knn_k",
            "5", "--clip_model", "huggingface_clip", "--noise_type", "random"]
    import resource

    gathers = NativeShardGather.gathers
    with RssPeak() as mem:
        launches, wall, log = run_cli(scoremax, topk, argv, {"LEMON_TPU_PRECISION": "bf16",
                                                             "LEMON_TPU_DATA_ROOT": str(root)})
    gathers = NativeShardGather.gathers - gathers
    _, _, auroc, timing = read_run(out, n, "stream", log)
    write = [line for line in log.splitlines() if line.startswith("synthetic_caption_stream: wrote")]
    check(len(write) == 1, "stream: the run did not write its shards")
    print(f"stream bf16 synthetic_caption_stream n={n} (train = comparison set = {n * 4 // 5}) huggingface_clip: wall "
          f"{wall:.2f} s; {write[0]}; AUROC {auroc}; native gathers {gathers}", flush=True)
    print(f"stream bf16 phase timing (s): " + json.dumps({k: round(v, 4) for k, v in timing.items()}), flush=True)
    print(f"stream host RSS (MiB): {mem.start:.0f} before the run, {mem.end:.0f} after it, {mem.peak:.0f} at its "
          f"peak (sampled every 50 ms; {mem.peak - mem.start:.0f} above the start); ru_maxrss of the process "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.0f}", flush=True)
    print(f"stream kernel launches: {launches}", flush=True)
    check(gathers > 0, "stream: the native shard gather did not run")
    check_launched(launches, K1_K2, "stream")
    os.environ["LEMON_TPU_DATA_ROOT"] = str(root)
    try:
        stream = get_dataset("synthetic_caption_stream", 0, noise_type="random", synthetic_n=n)[0]
        ram = get_dataset("synthetic_caption", 0, noise_type="random", synthetic_n=n)[0]
    finally:
        del os.environ["LEMON_TPU_DATA_ROOT"]
    check(len(stream) == n * 4 // 5, f"stream: train split of {len(stream)} rows, not {n * 4 // 5}")
    ids = np.arange(min(2048, len(stream)))
    check(bool(np.array_equal(stream.images[ids], ram.images[ids])), "stream: store rows differ from the ram backing")
    print(f"stream: {len(ids)} train rows read through the shard store bit-equal to the ram backing's", flush=True)
    return launches


def phase_new_encoders(torch, scoremax, topk, n: int = 2000):
    """Phase 17: random-init detections at full width, 2000 synthetic
    caption pairs each: rn50 in fp32 and bf16, biomed_clip in fp32. The
    first 64 pairs embedded on the card agree with the same port code on the
    CPU from the card's weights. Returns {path: kernel launches}."""
    import numpy as np

    from lemon_tpu_torch import detect
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.models.biomed import BiomedClipModel
    from lemon_tpu_torch.models.clip import ClipModel
    from lemon_tpu_torch.models.encoder import ClipEncoder

    n_cpu = 64
    head = get_dataset("synthetic_caption", 0, noise_type="random", synthetic_n=n)[0].subset(np.arange(n_cpu))
    texts = list(head.sentence)
    cpu = torch.device("cpu")
    paths = {}
    for name, precision in (("rn50", "fp32"), ("rn50", "bf16"), ("biomed_clip", "fp32")):
        out = RUNS / f"{name}_{precision}"
        shutil.rmtree(out, ignore_errors=True)
        argv = ["--output_dir", str(out), "--dataset", "synthetic_caption", "--synthetic_n", str(n), "--knn_k", "5",
                "--clip_model", name, "--noise_type", "random"]
        launches, wall, log = run_cli(scoremax, topk, argv, {"LEMON_TPU_PRECISION": precision})
        _, _, auroc, timing = read_run(out, n, f"{name} {precision}", log)
        (enc,) = detect._ENCODER_CACHE.values()
        model = enc.model
        twin = BiomedClipModel(model.cfg) if isinstance(model, BiomedClipModel) else ClipModel(model.cfg, model.precision)
        twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        cpu_enc = ClipEncoder(twin, cpu, batch_size=n_cpu, tokenize_fn=enc._tokenize_fn)
        with torch.inference_mode():
            g_img, g_txt = enc.embed_split(head, texts)
            c_img, c_txt = cpu_enc.embed_split(head, texts)
        cos = min(row_cos(torch, g_img, c_img), row_cos(torch, g_txt, c_txt))
        bar = 0.9999 if precision == "fp32" else CARD_CPU_COS
        print(f"{name} {precision} synthetic_caption n={n} k=5 (random init, full width): wall {wall:.2f} s; "
              f"AUROC {auroc}; first {n_cpu} pairs card vs CPU per-row cosine (min, mean) {cos} (bar {bar})",
              flush=True)
        print(f"{name} {precision} phase timing (s): " + json.dumps({k: round(v, 4) for k, v in timing.items()}),
              flush=True)
        print(f"{name} {precision} kernel launches: {launches}", flush=True)
        check(cos[0] >= bar, f"{name} {precision}: card vs CPU cosine {cos} < {bar}")
        check_launched(launches, K1_K2, f"{name} {precision}")
        paths[f"detect_{name}_{precision}"] = launches
        del enc, model, twin, cpu_enc
        detect._ENCODER_CACHE.clear()
    return paths


class RecordSearches:
    """Records the ids of every ``ExactKnnIndex.search`` between
    ``__enter__`` and ``__exit__``, in call order (``.ids``)."""

    def __enter__(self):
        from lemon_tpu_torch.knn.index import ExactKnnIndex

        self.ids, self._cls, self._search = [], ExactKnnIndex, ExactKnnIndex.search

        def search(index, xq, k):
            scores, ids = self._search(index, xq, k)
            self.ids.append(ids)
            return scores, ids

        ExactKnnIndex.search = search
        return self

    def __exit__(self, *exc):
        self._cls.search = self._search


def phase_baselines(torch, scoremax, topk, embedding_cache, device, n: int = 20000, model: str = "huggingface_clip"):
    """Phase 18: the detection baselines through ``run_baseline`` in bf16 at
    ViT-B/32 width. clip_sim, discrepancy (dis_x, div_y) and deepknn read
    phase 10's 20000 caption pairs from the ``.npz`` cache; zero_shot embeds
    20000 synthetic classification pairs cold. Then the same scoring on the
    CPU from the same embeddings, and k-means on the card against the CPU.
    Returns {path: kernel launches}."""
    import numpy as np

    from lemon_tpu_torch.baselines import run_clip_sim, run_deepknn, run_discrepancy, run_zero_shot_logits
    from lemon_tpu_torch.baselines.common import BaselineConfig, cache_kwargs, split_frame
    from lemon_tpu_torch.cli.run_baseline import main as run_baseline
    from lemon_tpu_torch.core.precision import Precision
    from lemon_tpu_torch.data.clustering import cluster_caption_text
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.models.encoder import ClipEncoder
    from lemon_tpu_torch.models.registry import create_encoder
    from lemon_tpu_torch.ops.kmeans import KMeans
    from lemon_tpu_torch.scoring.distance_metrics import knn_label_distribution

    t_phase = time.perf_counter()
    data = {"caption": ["--dataset", "synthetic_caption", "--noise_type", "random"],
            "classification": ["--dataset", "synthetic", "--noise_type", "symmetric"]}
    runs = (("clip_sim", [], "caption", run_clip_sim), ("discrepancy", ["--method", "dis_x"], "caption", run_discrepancy),
            ("discrepancy", ["--method", "div_y"], "caption", run_discrepancy),
            ("deepknn", [], "caption", run_deepknn), ("zero_shot", [], "classification", run_zero_shot_logits))
    files = {"clip_sim": ("dists.npy", "label_flips.npy", "datasplit.npy"), "zero_shot": ("dists.npy",)}
    paths, card = {}, {}
    for baseline, extra, kind, runner in runs:
        name = "_".join([baseline, *extra[1:]])
        out = RUNS / f"baseline_{name}"
        shutil.rmtree(out, ignore_errors=True)
        argv = ["--output_dir", str(out), "--baseline", baseline, *extra, *data[kind], "--synthetic_n", str(n),
                "--knn_k", "5", "--clip_model", model, "--embedding_cache", str(embedding_cache),
                "--platform", device.type]
        hits = ClipEncoder.npz_hits
        with RecordSearches() as searched:
            launches, wall, log, res = run_entry(run_baseline, scoremax, topk, argv, {"LEMON_TPU_PRECISION": "bf16"})
        hits = ClipEncoder.npz_hits - hits
        for f in ("args.json", "out.txt", "res.pkl", "scores.csv", "runtime.npy", "done", *files.get(baseline, ())):
            check((out / f).exists(), f"baseline {name}: {f} missing")
        scores = res["df"]["pred_score"].to_numpy()
        check(len(scores) == n and bool(np.isfinite(scores).all()), f"baseline {name}: non-finite or missing pred_score")
        check("compute_dtype=torch.bfloat16" in log, f"baseline {name}: the run did not take the bf16 mode")
        auroc = {s: round(float(res["agg_results"][s]["AUROC"]), 4) for s in ("val", "test")}
        print(f"baseline {name} ({kind}, n={n}, k=5, {model} bf16, random init): wall {wall:.2f} s, "
              f"runtime.npy {float(np.load(out / 'runtime.npy')[0]):.3f} s; .npz cache hits {hits}; AUROC {auroc}; "
              f"kernel launches {launches}", flush=True)
        if baseline in ("discrepancy", "deepknn"):  # exact kNN at precision 'highest'
            check_launched(launches, ("scores_blockmax_highest", "topk"), f"baseline {name}")
            check(launches["scores_blockmax"] == 0, f"baseline {name}: K1 ran in 'high': {launches}")
        if kind == "caption":
            check(hits == 3, f"baseline {name}: {hits} of 3 splits read from phase 10's cache")
        paths[f"baseline_{name}"] = launches
        card[name] = (runner, extra, kind, res, searched.ids)

    # the same scoring on the CPU, from the card's embeddings: one card
    # encoder of the CLI's weights and mode serves the cache reads and
    # zero_shot's class prompts; deepknn scores with the card's clusters
    enc = create_encoder(model, device, seed=0, precision=Precision.bf16())
    splits = dict(zip(("train", "val", "test"), get_dataset("synthetic_caption", 0, noise_type="random", synthetic_n=n)))
    for name, (runner, extra, kind, res, card_ids) in card.items():
        cfg = BaselineConfig(dataset=data[kind][1], noise_type=data[kind][3], synthetic_n=n, knn_k=5,
                             clip_model=model, embedding_cache=str(embedding_cache), platform="cpu",
                             method=extra[1] if extra else "")
        if runner is run_deepknn:  # the card's clusters, as the card's run drew them
            km, train_clusters = cluster_caption_text(list(splits["train"].sentence),
                                                      n_clusters=min(100, len(splits["train"]) // 2), encoder=enc)
            labels = {"train": train_clusters, **{s: km.predict(list(splits[s].sentence)) for s in ("val", "test")}}
            n_classes = km.km.n_clusters
        t0 = time.perf_counter()
        with RecordSearches() as searched:
            if runner is run_deepknn:
                cpu_scores = {}
                for sname, split in splits.items():
                    texts = list(split.sentence)
                    img, _ = enc.embed_split(split, texts, **cache_kwargs(cfg, enc, split, texts))
                    y = labels[sname] % n_classes
                    probs = knn_label_distribution(img, y, n_classes, k=5, norm="l1", device=torch.device("cpu"))
                    cpu_scores[sname] = 1.0 - probs[np.arange(len(split)), y]
                b = split_frame(cfg, splits, cpu_scores)
            else:
                b = runner(cfg, RUNS / f"baseline_{name}_cpu", encoder=enc)["df"]
        a = res["df"]
        check(bool((a["sset"] == b["sset"]).all() and (a["idx"] == b["idx"]).all()), f"{name}: CPU rows differ")
        diff = np.abs(a["pred_score"].to_numpy(np.float64) - b["pred_score"].to_numpy(np.float64))
        above = diff > BASELINE_TOL
        below = float(diff[~above].max()) if (~above).any() else 0.0
        print(f"baseline {name} card vs CPU scoring ({time.perf_counter() - t0:.2f} s on the CPU): pred_score max abs "
              f"diff {diff.max():.3e} (tol {BASELINE_TOL}), {int(above.sum())} rows above it, the rest within "
              f"{below:.3e}", flush=True)
        if runner is run_deepknn and above.any():
            # an fp32 near-tie among the image neighbours may resolve one way
            # on the card's K1 and the other in the CPU's matmul: each such
            # row must have a neighbour set that differs, by neighbours
            # whose float64 similarities to the row lie within NEAR_TIE
            gaps = []
            for s, (ids_card, ids_cpu) in enumerate(zip(card_ids, searched.ids)):
                sname = ("train", "val", "test")[s]
                rows = np.flatnonzero(above[(a["sset"] == sname).to_numpy()])
                if len(rows) == 0:
                    continue
                split = splits[sname]
                img, _ = enc.embed_split(split, list(split.sentence), **cache_kwargs(cfg, enc, split, list(split.sentence)))
                f = img.astype(np.float64) / np.linalg.norm(img.astype(np.float64), axis=1, keepdims=True)
                for r in rows:
                    moved = np.array(sorted(set(ids_card[r]) ^ set(ids_cpu[r])), np.int64)
                    check(len(moved) > 0, f"baseline {name}: {sname} row {r} differs with the same neighbours")
                    sims = f[moved] @ f[r]
                    gaps.append(float(sims.max() - sims.min()))
            gap = max(gaps, default=0.0)
            print(f"baseline {name}: the {int(above.sum())} rows above {BASELINE_TOL} swap near-tied image neighbours "
                  f"(float64 similarity gap at most {gap:.3e}, bar {NEAR_TIE})", flush=True)
            check(gap <= NEAR_TIE, f"baseline {name}: a swapped neighbour is {gap} from its twin")
        else:
            check(diff.max() <= BASELINE_TOL, f"baseline {name}: card vs CPU pred_score differs by {diff.max()}")

    # k-means on distinct rows (the train images' embeddings; the synthetic
    # captions repeat): two fits on the card give the same bits, the CPU the
    # same labels and centroids within KMEANS_TOL
    cfg = BaselineConfig(dataset="synthetic_caption", noise_type="random", synthetic_n=n, clip_model=model,
                         embedding_cache=str(embedding_cache))
    texts = list(splits["train"].sentence)
    emb = enc.embed_split(splits["train"], texts, **cache_kwargs(cfg, enc, splits["train"], texts))[0][:KMEANS_ROWS]
    check(len(np.unique(emb, axis=0)) == len(emb), "k-means: the image embeddings repeat")
    fits = {}
    for label, km_device in (("card", device), ("card again", device), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        km = KMeans(n_clusters=100, seed=0, device=km_device).fit(emb)
        fits[label] = (km.centroids, km.predict(emb), time.perf_counter() - t0)
    (c0, l0, t_card), (c1, l1, _), (c2, l2, t_cpu) = fits.values()
    err = float(np.abs(c0 - c2).max())
    print(f"k-means {len(emb)} image embeddings x 100 clusters (5 restarts x 300 Lloyd steps): card {t_card:.2f} s, "
          f"CPU {t_cpu:.2f} s; card repeat bit-identical {np.array_equal(c0, c1) and np.array_equal(l0, l1)}; card vs "
          f"CPU centroids max abs diff {err:.3e} (tol {KMEANS_TOL}), labels that differ {int((l0 != l2).sum())}",
          flush=True)
    check(np.array_equal(c0, c1) and np.array_equal(l0, l1), "k-means: two fits on the card differ")
    check(err <= KMEANS_TOL and np.array_equal(l0, l2), f"k-means: card vs CPU centroids differ by {err}, "
          f"{int((l0 != l2).sum())} labels differ")
    del enc
    print(f"baselines phase: {time.perf_counter() - t_phase:.2f} s", flush=True)
    return paths


def phase_vit_b16_flash(torch, scoremax, topk, attention, device, precision: str = "fp32", fp32_check=None):
    """The from-scratch ViT-B/16 model through K3 in one precision mode:
    plain and flash towers on one state dict, then a whole detection under
    flash. Returns (launches, phase timing, the plain embeddings of the
    check)."""
    import dataclasses

    import numpy as np

    from lemon_tpu_torch import detect
    from lemon_tpu_torch.core.precision import Precision
    from lemon_tpu_torch.core.profiling import PhaseTimer
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.models.clip import ClipModel
    from lemon_tpu_torch.models.encoder import ClipEncoder
    from lemon_tpu_torch.models.registry import MODEL_CONFIGS, create_encoder

    name, n, n_check = "mimic_clip_from_scratch_random", 8000, 512
    prec = getattr(Precision, precision)()
    cfg = detect.DetectionConfig(dataset="synthetic_caption", noise_type="random", clip_model=name, knn_k=5,
                                 synthetic_n=n)
    timer = PhaseTimer(device)
    t0 = time.perf_counter()
    with timer.phase("load_data"):
        splits = dict(zip(("train", "val", "test"), get_dataset(
            cfg.dataset, cfg.data_seed, noise_level=cfg.noise_level, noise_type=cfg.noise_type, synthetic_n=n)))
    with timer.phase("load_model"):
        plain = create_encoder(name, device, seed=cfg.seed, batch_size=cfg.batch_size, precision=prec)
        model = ClipModel(dataclasses.replace(MODEL_CONFIGS[name], attention_impl="flash"), prec)
        model.load_state_dict(plain.model.state_dict())
        flash = ClipEncoder(model, device, batch_size=cfg.batch_size, weights_fingerprint=plain.weights_fingerprint)

    head = splits["train"].subset(np.arange(n_check))
    texts = list(head.sentence)
    with timer.phase("embed_check_plain"):
        p_img, p_txt = plain.embed_split(head, texts)
    with timer.phase("embed_check_flash"):
        f_img, f_txt = flash.embed_split(head, texts)
    dim = MODEL_CONFIGS[name].embed_dim
    check(p_img.shape == (n_check, dim) and p_txt.shape == (n_check, dim), "ViT-B/16: wrong embedding shape")
    if precision == "fp32":
        err = max(float(np.abs(p_img - f_img).max()), float(np.abs(p_txt - f_txt).max()))
        print(f"ViT-B/16 ctx-256 towers, {n_check} pairs: flash vs plain embeddings max_abs_err {err:.3e} "
              f"(tol {EMBED_TOL})", flush=True)
        check(err <= EMBED_TOL, f"ViT-B/16: flash embeddings differ from plain by {err} > {EMBED_TOL}")
    else:
        cos = {"img": row_cos(torch, f_img, p_img), "txt": row_cos(torch, f_txt, p_txt)}
        print(f"ViT-B/16 ctx-256 towers {precision}, {n_check} pairs: flash vs plain per-row cosine (min, mean) "
              f"{cos} (bar {BF16_FLASH_COS})", flush=True)
        check(min(c[0] for c in cos.values()) >= BF16_FLASH_COS, f"ViT-B/16 {precision}: flash vs plain {cos}")
        # cuBLAS may reduce split-K partial sums of bf16 products in bf16; the CLI and this script keep it off
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        try:
            r_img, r_txt = plain.embed_split(head, texts)
        finally:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        print(f"ViT-B/16 {precision} plain embeddings with reduced-precision bf16 reductions allowed vs off, "
              f"per-row cosine (min, mean): img {row_cos(torch, r_img, p_img)}, txt {row_cos(torch, r_txt, p_txt)}",
              flush=True)
        if fp32_check is not None:
            print(f"ViT-B/16 {precision} vs fp32 plain embeddings, same weights, per-row cosine (min, mean): "
                  f"img {row_cos(torch, p_img, fp32_check[0])}, txt {row_cos(torch, p_txt, fp32_check[1])}", flush=True)
    del plain

    scoremax.scores_blockmax.launches = 0
    scoremax.scores_blockmax.launches_highest = 0
    topk.topk.launches = 0
    attention.flash_attention.launches = 0
    attention.flash_attention.launches_bf16 = 0
    t1 = time.perf_counter()
    logs = detect.build_neighbor_logs(cfg, flash, splits, None, timer)  # captions: no label set
    agg, df = detect.select_and_evaluate(cfg, logs, device, timer)
    wall = time.perf_counter() - t1
    n_bf16 = attention.flash_attention.launches_bf16
    launches = {**k1_k2_launches(scoremax, topk), "flash_attention": attention.flash_attention.launches - n_bf16,
                "flash_attention_bf16": n_bf16}

    scores = df["know_val_labels_pred_score"].to_numpy()
    check(len(scores) == n and np.isfinite(scores).all(), "ViT-B/16 detection: non-finite or missing scores")
    for col in ("d_1", "dists_n", "D_n", "dists_tr_n", "dists_m", "D_m", "dists_tr_m"):
        vals = np.stack(df[col].to_list()) if col != "d_1" else df[col].to_numpy()
        check(bool(np.isfinite(vals).all()), f"ViT-B/16 detection: non-finite {col}")
    auroc = {s: float(agg["know_val_labels"][s]["AUROC"]) for s in ("train", "val", "test")}
    print(f"detection {precision} synthetic_caption n={n} k=5 {name} (ViT-B/16 @224, text ctx 256, embed 768, "
          f"random init, attention_impl=flash): wall {wall:.2f} s (with load and the check "
          f"{time.perf_counter() - t0:.2f} s); AUROC {auroc}", flush=True)
    timing = timer.as_dict()
    print(f"ViT-B/16 {precision} phase timing (s): " + json.dumps({k: round(v, 4) for k, v in timing.items()}),
          flush=True)
    print(f"ViT-B/16 {precision} detection kernel launches: {launches}", flush=True)
    check(auroc["test"] > 0.5, f"ViT-B/16 detection: test AUROC {auroc['test']} <= 0.5")
    k3 = "flash_attention" if precision == "fp32" else "flash_attention_bf16"
    used = ("scores_blockmax", "topk", k3)
    check(all(launches[c] > 0 for c in used), f"ViT-B/16 detection: a kernel was not launched: {launches}")
    check(launches[k3] == attention.flash_attention.launches, f"ViT-B/16 {precision}: K3 ran another variant: {launches}")
    return launches, timing, (p_img, p_txt)


def phase_int8(torch, device):
    """The int8 modes at ViT-B/32 against fp32 and against the same code on
    the CPU. Returns {mode: (embed ms per 1000 pairs, img cosine to fp32)}."""
    import numpy as np

    from lemon_tpu_torch.core.precision import Precision
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.models.clip import ClipModel
    from lemon_tpu_torch.models.registry import MODEL_CONFIGS, create_encoder
    from lemon_tpu_torch.ops.image import preprocess_device

    name, n, n_cpu = "huggingface_clip", 2048, 64
    train = get_dataset("synthetic_caption", 0, noise_level=0.4, noise_type="random", synthetic_n=2560)[0]
    split = train.subset(np.arange(n))
    texts = list(split.sentence)
    cpu = torch.device("cpu")
    out, ref = {}, None
    for mode in ("fp32", "bf16", "int8", "int8_static"):
        prec = getattr(Precision, mode)()
        enc = create_encoder(name, device, seed=0, precision=prec)
        enc.embed_split(split.subset(np.arange(128)), texts[:128])  # warm up (and calibrate int8_static)
        if mode == "int8_static":  # time the lazy calibration too: a fresh encoder, its own first batch
            enc = create_encoder(name, device, seed=0, precision=prec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, txt = enc.embed_split(split, texts)
        ms = (time.perf_counter() - t0) * 1e3 / n * 1000
        check(img.shape == txt.shape == (n, MODEL_CONFIGS[name].embed_dim) and np.isfinite(img).all()
              and np.isfinite(txt).all(), f"{mode}: bad embeddings")
        if ref is None:
            ref = (img, txt)
            out[mode] = (ms, None)
            print(f"ViT-B/32 fp32: embed {ms:.1f} ms per 1000 pairs ({n} pairs)", flush=True)
            continue
        cos = row_cos(torch, img, ref[0]), row_cos(torch, txt, ref[1])
        # the same code on the CPU from the card's weights (and calibrated scales)
        cpu_model = ClipModel(MODEL_CONFIGS[name], prec)
        cpu_model.load_state_dict({k: v.cpu() for k, v in enc.model.state_dict().items()})
        res = MODEL_CONFIGS[name].image_resolution
        if prec.matmul_int8:
            n_int8 = int8_layer_check(torch, enc.model.eval(), cpu_model.eval(),
                                      preprocess_device(split.images[:n_cpu], res, device, **enc._pp_kwargs))
            print(f"ViT-B/32 {mode}: visual.blocks.0.attn.qkv on the card's input, {n_cpu} images: quantised "
                  f"activations, int32 products and output bit-equal to the CPU's; {n_int8} int8 products in the "
                  f"card's forward (one per W8A8 layer)", flush=True)
        with torch.inference_mode():
            pixels = preprocess_device(split.images[:n_cpu], res, cpu, **enc._pp_kwargs)
            c_img = cpu_model.eval().encode_image(pixels).numpy()
            c_txt = cpu_model.encode_text(torch.from_numpy(enc._tokenize(texts[:n_cpu])).long()).numpy()
        card_cpu = min(row_cos(torch, img[:n_cpu], c_img), row_cos(torch, txt[:n_cpu], c_txt))
        out[mode] = (ms, cos[0])
        print(f"ViT-B/32 {mode}: embed {ms:.1f} ms per 1000 pairs ({n} pairs); per-row cosine to fp32 (min, mean) "
              f"img {cos[0]}, txt {cos[1]} (floor {FP32_FLOOR_COS}); card vs CPU, first {n_cpu} images, "
              f"{card_cpu} (bar {CARD_CPU_COS})", flush=True)
        check(cos[0][0] >= FP32_FLOOR_COS and cos[1][0] >= FP32_FLOOR_COS, f"{mode}: cosine to fp32 {cos}")
        check(card_cpu[0] >= CARD_CPU_COS, f"{mode}: card vs CPU cosine {card_cpu} < {CARD_CPU_COS}")
        del enc, cpu_model
    return out


def int8_layer_check(torch, card_model, cpu_model, pixels) -> int:
    """The first W8A8 projection of the card's vision forward
    (``visual.blocks.0.attn.qkv``), held on its own input against the same
    layer on the CPU: its quantised activations, its int32 products
    (``torch._int_mm``) and its output bit for bit; and every W8A8 layer of
    the forward ran its int8 product on the card. Returns that count."""
    from lemon_tpu_torch.models import clip

    real, calls, seen, captured = clip.int8_matmul, [], {}, {}

    def recording(a, w):
        out = real(a, w)
        calls.append(a.device.type)
        seen.setdefault(a.device.type, (a, out))
        return out

    def hook(module, args, output):
        captured.setdefault("x", args[0])
        captured.setdefault("y", output)

    card_layer, cpu_layer = card_model.visual.blocks[0].attn.qkv, cpu_model.visual.blocks[0].attn.qkv
    handle = card_layer.register_forward_hook(hook)
    clip.int8_matmul = recording
    try:
        with torch.inference_mode():
            card_model.encode_image(pixels)
            n_card = calls.count("cuda")
            y_cpu = cpu_layer(captured["x"].cpu())
            (a_card, p_card), (a_cpu, p_cpu) = seen["cuda"], seen["cpu"]
            p_card_a = real(a_card.cpu(), cpu_layer.weight_q)  # the card's activations, multiplied on the CPU
    finally:
        clip.int8_matmul = real
        handle.remove()
    w8a8 = sum(isinstance(m, clip.QuantLinear) and not m.weight_only for m in card_model.visual.modules())
    check(n_card == w8a8, f"int8 layer check: {n_card} int8 products on the card, {w8a8} W8A8 layers")
    a_card, p_card, y_card = a_card.cpu(), p_card.cpu(), captured["y"].cpu()
    check(bool(torch.equal(p_card, p_card_a)), f"int8 layer check: card int32 products differ from the CPU's on the "
          f"same activations in {int((p_card != p_card_a).sum())} of {p_card.numel()}")
    check(bool(torch.equal(a_card, a_cpu)), f"int8 layer check: quantised activations differ in "
          f"{int((a_card != a_cpu).sum())} of {a_card.numel()}")
    check(bool(torch.equal(p_card, p_cpu)) and bool(torch.equal(y_card, y_cpu)),
          f"int8 layer check: outputs differ, max {(y_card.float() - y_cpu.float()).abs().max().item():.3e}")
    return n_card


def phase_probe_kernels(torch, scoremax, select, topk, matmul, device):
    """P1-P4 against their plain versions at the probes' shapes. Returns
    {kernel: (max_abs_err, ms, plain ms, bound, library ms)}."""
    out = {}
    g = torch.Generator(device=device).manual_seed(14)
    m = k = n = P4_SIZE
    for name, dtype in (("tiled_matmul_int8", torch.int8), ("tiled_matmul_bf16", torch.bfloat16)):
        if dtype == torch.int8:
            a = torch.randint(-64, 64, (m, k), generator=g, device=device, dtype=torch.int8)
            w = torch.randint(-64, 64, (n, k), generator=g, device=device, dtype=torch.int8)
            lib = lambda: torch._int_mm(a, w.t())  # noqa: E731
        else:
            a = torch.randn(m, k, generator=g, device=device).bfloat16()
            w = (torch.randn(n, k, generator=g, device=device) * k**-0.5).bfloat16()
            lib = lambda: torch.matmul(a, w.t())  # noqa: E731
        c, c0 = matmul.tiled_matmul(a, w), matmul.tiled_matmul_plain(a, w)
        torch.cuda.synchronize()
        if dtype == torch.int8:
            check(bool(torch.equal(c, c0)), f"P4 int8 {m}^3: differs from the plain version")
            check(bool(torch.equal(lib(), c0)), f"P4 int8 {m}^3: torch._int_mm differs from the plain version")
            err, what = 0.0, "int32 output exact"
        else:
            ulps, err = one_bf16_ulp_err(torch, c, c0)
            check(ulps <= 1, f"P4 bf16 {m}^3: {ulps} bf16 ulp > 1")
            what = f"{ulps:.3f} bf16 ulp of the plain version (max_abs_err {err:.3e}, tol 1 ulp)"
        ms, plain_ms = paired_ms(torch, lambda: matmul.tiled_matmul(a, w), lambda: matmul.tiled_matmul_plain(a, w), 10)
        lib_ms = cuda_ms(lib, 10)
        size = a.element_size()
        bnd = bound(size * (m * k + n * k) + (4 if dtype == torch.int8 else 2) * m * n, 2 * m * n * k,
                    "int8" if dtype == torch.int8 else "bf16")
        out[name] = (err, ms, plain_ms, bnd, lib_ms)
        print(f"P4 {name} {m}^3: {what}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"({'torch._int_mm' if dtype == torch.int8 else 'torch.matmul bf16'}) {lib_ms:.4f} ms; "
              f"{bound_text(bnd, ms)}", flush=True)
        del a, w, c, c0

    for label, b, t, n_valid in P3_P2_SHAPES:
        gen = torch.Generator().manual_seed(15)
        q, db = unit_rows(torch, gen, b, 512, device), unit_rows(torch, gen, t, 512, device)
        for precision in ("high", "highest"):
            high = precision == "high"
            s1, bm1 = scoremax.scores_blockmax(q, db, "ip", None, 0, n_valid, precision)
            if label == "P3":
                name = "block_maxima"
                bm = scoremax.block_maxima(q, db, precision)
                bm0 = scoremax.block_maxima_plain(q, db, precision)
                kernel = lambda: scoremax.block_maxima(q, db, precision)  # noqa: E731
                plain = lambda: scoremax.block_maxima_plain(q, db, precision)  # noqa: E731
                torch.cuda.synchronize()
                check(bool(torch.equal(bm, bm1)), f"P3 {precision}: block maxima differ from K1's")
                check(not high or (None, sha256(bm)) == P3_P2_HIGH_SHA256["P3"],
                      "P3 high: block maxima differ from the replaced kernel's bits")
                err = (bm - bm0).abs().max().item()
                n_bytes = 4 * (b * 512 + t * 512 + b * t // 128)
            else:
                name = "scores_blockmax_t"
                s2, bt = scoremax.scores_blockmax_t(q, db, 0, n_valid, precision)
                s0, bt0 = scoremax.scores_blockmax_t_plain(q, db, 0, n_valid, precision)
                kernel = lambda: scoremax.scores_blockmax_t(q, db, 0, n_valid, precision)  # noqa: E731
                plain = lambda: scoremax.scores_blockmax_t_plain(q, db, 0, n_valid, precision)  # noqa: E731
                torch.cuda.synchronize()
                check(bool(torch.equal(s2, s1)) and bool(torch.equal(bt.T, bm1)),
                      f"P2 {precision}: scores or block maxima differ from K1's")
                check(not high or (sha256(s2), sha256(bt)) == P3_P2_HIGH_SHA256["P2"],
                      "P2 high: scores or block maxima differ from the replaced kernel's bits")
                check(bool(torch.isneginf(s2[:, n_valid:]).all()), f"P2 {precision}: columns >= n_valid not -inf")
                fin = torch.isfinite(s0)
                err = max((s2 - s0)[fin].abs().max().item(), (bt - bt0).abs().max().item())
                n_bytes = 4 * (b * 512 + t * 512 + b * t + b * t // 128)
                del s2, bt, s0, bt0
            check(bool(torch.equal(bm1, s1.view(b, -1, 128).amax(2))), f"{label} {precision}: K1's bmax != strip max")
            del s1, bm1
            check(err <= K1_TOL, f"{label} {precision}: error {err} > {K1_TOL}")
            ms, plain_ms = paired_ms(torch, kernel, plain, 3)
            k1_ms = cuda_ms(lambda: scoremax.scores_blockmax(q, db, "ip", None, 0, n_valid, precision), 3)
            bnd = bound(n_bytes, (3 if high else 6) * 2 * b * t * 512, "bf16")  # bf16x3 or bf16x6
            lib_ms, extra = None, ""
            if not high:  # the fp32 bound of the kernel it replaced, and the fp32 product alone as its yardstick
                lib_ms = cuda_ms(lambda: torch.matmul(q, db.T), 3)
                extra = (f"; fp32 products' {bound_text(bound(n_bytes, 2 * b * t * 512, 'fp32'), ms)}; "
                         f"torch.matmul(q, db.T) alone (TF32 off) {lib_ms:.3f} ms")
            out[(name, precision)] = (err, ms, plain_ms, bnd, lib_ms)
            print(f"{label} {name} {precision} ({b}x512 . {t}x512): max_abs_err {err:.3e} (tol {K1_TOL}), "
                  f"{'maxima' if label == 'P3' else 'scores and maxima'} bit-equal to K1's"
                  f"{' and to the replaced kernel' if high else ''}; kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, K1 at this shape {k1_ms:.3f} ms; {bound_text(bnd, ms)}{extra}",
                  flush=True)
        del q, db

    gen = torch.Generator().manual_seed(16)
    for b, w, kk in P1_SHAPES:
        x = topk_inputs(torch, gen, b, w, device)
        blocks = torch.rand(b, 1024, generator=g, device=device).argsort(dim=1)[:, : w // 128].sort(dim=1).values
        cid = (blocks.to(torch.int32)[:, :, None] * 128 + torch.arange(128, device=device, dtype=torch.int32)).view(b, w)
        v, i = select.topk_colids(x, cid, kk)
        v0, i0 = select.topk_colids_plain(x, cid, kk)
        torch.cuda.synchronize()
        check(same_bits(torch, v, v0) and bool(torch.equal(i, i0)),
              f"P1 ({b}, {w}) k={kk}: differs from the plain version")
        ms, plain_ms = paired_ms(torch, lambda: select.topk_colids(x, cid, kk),
                                 lambda: select.topk_colids_plain(x, cid, kk), 20)
        lib_ms = cuda_ms(lambda: torch.topk(x, kk), 20)
        # x read once, one 32-byte sector of cid for each chosen id, the values and ids written
        bnd = bound(4 * b * w + 32 * b * kk + 8 * b * kk, b * w, "fp32")
        if (b, w, kk) == P1_SHAPES[0]:
            out["topk_colids"] = (0.0, ms, plain_ms, bnd, lib_ms)
        print(f"P1 topk_colids ({b}, {w}) k={kk}: values (bits) and ids exact (rows staged by "
              f"{topk.radix_load(x, kk)}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.topk {lib_ms:.4f} ms; {bound_text(bnd, ms)}", flush=True)
        del x, cid, blocks
    return out


def phase_probes(torch, counters):
    """Each probe program's ``main()`` once, with every kernel count set to
    0 just before it and read just after: {probe: {kernel: launches}}."""
    import importlib

    paths = {}
    for name in PROBES:
        mod = importlib.import_module(f"lemon_tpu_torch.benchmarks.{name}")
        reset_counts(counters)
        t0 = time.perf_counter()
        mod.main()
        torch.cuda.synchronize()
        paths[name] = kernel_counts(counters)
        print(f"{name}: main() in {time.perf_counter() - t0:.2f} s; kernel launches "
              f"{ {k: v for k, v in paths[name].items() if v} }", flush=True)
    return paths


TRAIN_BATCH = 128  # the global batch of the training phase
TRAIN_N = 800  # synthetic pairs: a 640-row train split, five batches of 128 an epoch
TRAIN_ARGV = ["--dataset", "synthetic_caption", "--model_size", "vit_b16", "--context_length", "256",
              "--batch_size", str(TRAIN_BATCH), "--synthetic_n", str(TRAIN_N), "--save_interval", "100"]
TRAIN_STEPS = 6  # API steps on one repeated batch: the first warms up, the rest are timed
RESUME_STEPS = 2  # n: a CLI run of 2n steps against n steps and --resume to 2n


def kernel_counts(counters) -> dict:
    return {kernel: getattr(fn, attr) for kernel, (fn, attr) in counters.items()}


def split_counts(counts: dict) -> dict:
    """Counts read from ``counters`` in place as the kernels line names
    them: K1 ``high`` apart from ``highest``, K3 fp32 apart from bf16, P4
    bf16 apart from int8."""
    counts["scores_blockmax"] -= counts["scores_blockmax_highest"]
    counts["flash_attention"] -= counts["flash_attention_bf16"]
    counts["tiled_matmul_bf16"] = counts.pop("tiled_matmul") - counts["tiled_matmul_int8"]
    return counts


def reset_counts(counters) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def train_steps(torch, precision: str, device):
    """The training step at full width (the ``mimic_clip_from_scratch``
    configuration: ViT-B/16, text context 256, embed 768) on one repeated
    batch of ``TRAIN_BATCH`` pairs from ``BatchStream``: the losses (finite,
    falling), ms per step and pairs per second of the steps after the first
    (host clock, synchronised each step), the peak device memory, and one
    profiled step's forward / backward / optimizer split."""
    import numpy as np

    from lemon_tpu_torch.cli.train_clip import BatchStream
    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.models.clip import ClipConfig
    from lemon_tpu_torch.train.contrastive import TrainConfig, create_train_state, make_train_step

    cfg = ClipConfig.from_scratch_mimic()
    train = get_dataset("synthetic_caption", 0, noise_level=0.0, synthetic_n=TRAIN_N)[0]
    batch = next(BatchStream(train, cfg.context_length, TRAIN_BATCH, cfg.image_resolution, seed=0, device=device))
    pixels, tokens = batch["pixels"], torch.from_numpy(batch["tokens"]).to(device).long()
    # 1e-5 without warmup: the loss falls at every step on one batch (the
    # CLI's 5e-4 moves every weight by about 5e-4 at the first AdamW step and
    # sends this random init to chance, ln 128, in a few steps)
    tcfg = TrainConfig(learning_rate=1e-5, warmup_steps=0, total_steps=1000, batch_size=TRAIN_BATCH,
                       precision=precision)
    model, state = create_train_state(cfg, tcfg, device=device)
    step = make_train_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, pixels, tokens)
        losses.append(float(loss))  # synchronises
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times[1:])) * 1e3
    check(bool(np.isfinite(losses).all()) and all(b < a for a, b in zip(losses, losses[1:])),
          f"train {precision}: the loss is not finite and falling at every step on a repeated batch: {losses}")
    check(all(p.dtype == torch.float32 for p in model.parameters()), f"train {precision}: a parameter left fp32")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, loss = step(state, pixels, tokens)
        torch.cuda.synchronize()
    split = step_split(prof)
    print(f"train {precision} ViT-B/16 ctx-256 embed 768, batch {TRAIN_BATCH}, AdamW lr {tcfg.learning_rate}: losses "
          f"{[round(x, 4) for x in losses]}; {ms:.1f} ms per step (median of {TRAIN_STEPS - 1}, host clock, "
          f"synchronised), {TRAIN_BATCH / ms * 1e3:.1f} pairs/s; max_memory_allocated {peak / 2**30:.2f} GiB",
          flush=True)
    print(f"train {precision} profiled step, device ms by part (torch.profiler): "
          + (json.dumps(split) if split else "not measured (no annotated device ranges in the trace)"), flush=True)
    del model, state, step
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "pairs_per_s": TRAIN_BATCH / ms * 1e3, "max_memory_allocated": peak,
            "losses": losses, "profile_ms": split}


def step_split(prof):
    """Device time of one profiled training step by part: the kernels (and
    copies) that start inside the device span of the ``forward`` and
    ``optimizer`` ranges, and those between the two, the backward (autograd
    launches its kernels from its own thread, outside the ``backward``
    range); with the step's device total and its span. None when the trace
    holds no annotated device ranges."""
    from torch.autograd import DeviceType

    parts = ("forward", "backward", "optimizer")
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {e.name: e.time_range for e in dev if e.name in parts}
    work = [e.time_range for e in dev if e.name not in parts]
    if "forward" not in spans or "optimizer" not in spans or not work:
        return None
    fwd, opt = spans["forward"], spans["optimizer"]

    def busy(lo, hi):
        return round(sum(t.elapsed_us() for t in work if lo <= t.start < hi) / 1e3, 3)

    return {"forward": busy(fwd.start, fwd.end), "backward": busy(fwd.end, opt.start),
            "optimizer": busy(opt.start, opt.end + 1), "total": round(sum(t.elapsed_us() for t in work) / 1e3, 3),
            "span": round((max(t.end for t in work) - min(t.start for t in work)) / 1e3, 3)}


def train_cli(torch, counters, out, extra, deterministic=False):
    """``train_clip`` in-process (every kernel count set to 0 before it),
    each step timed on the host clock between two synchronisations (the
    run's step function wrapped for the call); (final model state dict on
    the host, wall seconds, kernel launches)."""
    from lemon_tpu_torch.cli.train_clip import main as train_clip
    from lemon_tpu_torch.train import contrastive

    reset_counts(counters)
    stdout, stderr = sys.stdout, sys.stderr
    torch.cuda.reset_peak_memory_stats()
    # the cuBLAS setting torch's deterministic mode asks for, for these runs
    # alone: set for the whole script, it made phase 13's bf16 embedding
    # 1.7-2.4x slower (PERF.md)
    workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(deterministic)
    t0 = time.perf_counter()
    try:
        with TimedSteps(torch, contrastive, "make_train_step") as steps:
            state = train_clip(["--output_dir", str(out), *TRAIN_ARGV, *extra])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        if workspace is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = workspace
        restore_streams(stdout, stderr)
    wall = time.perf_counter() - t0
    ms = steps.ms()
    print(f"train_clip {' '.join(extra)}: wall {wall:.2f} s; {len(steps.seconds)} steps, {ms:.1f} ms per step (median "
          f"after the first), {TRAIN_BATCH / ms * 1e3:.1f} pairs/s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    params = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    del state, steps  # the steps' results hold the state too
    torch.cuda.empty_cache()
    return params, wall, kernel_counts(counters)


def max_param_diff(torch, a: dict, b: dict):
    """(max abs difference, whether every tensor is equal bit for bit)."""
    return (max(float((a[k] - b[k]).abs().max()) for k in a), all(torch.equal(a[k], b[k]) for k in a))


def embed_checkpoint(torch, ckpt, device, label: str) -> None:
    """The checkpoint's state dict (``restore_params``) loaded into a
    ``ClipModel`` as the registry builds it, which embeds 512 pairs: finite
    unit rows."""
    import numpy as np

    from lemon_tpu_torch.data.datasets import get_dataset
    from lemon_tpu_torch.models.clip import ClipConfig, ClipModel
    from lemon_tpu_torch.models.encoder import ClipEncoder
    from lemon_tpu_torch.train.contrastive import restore_params

    cfg = ClipConfig.from_scratch_mimic()
    model = ClipModel(cfg)
    model.load_state_dict(restore_params(ckpt))
    pairs = get_dataset("synthetic_caption", 0, noise_level=0.0, synthetic_n=640)[0]
    t0 = time.perf_counter()
    img, txt = ClipEncoder(model, device).embed_split(pairs, list(pairs.sentence))
    torch.cuda.synchronize()
    norms = np.linalg.norm(np.concatenate([img, txt]), axis=1)
    check(img.shape == (512, cfg.embed_dim) and txt.shape == (512, cfg.embed_dim)
          and bool(np.isfinite(norms).all()) and bool(np.abs(norms - 1).max() < 1e-4),
          f"{label}: the ClipModel's embeddings are not finite unit rows of 512 pairs")
    print(f"{label} -> ClipModel (fp32): 512 pairs embedded in {time.perf_counter() - t0:.2f} s, finite unit rows",
          flush=True)
    del model
    torch.cuda.empty_cache()


def phase_training(torch, counters, device):
    """Phase 19: contrastive training at full width. The step in fp32 and
    bf16 (:func:`train_steps`), then ``python -m lemon_tpu_torch.cli.train_clip``
    in-process: 2n steps against n steps and ``--resume`` to 2n, and
    ``--mesh 1x1`` (NCCL, a world of one) against no mesh, all in fp32 under
    ``torch.use_deterministic_algorithms(True)`` (so the card adds every
    gradient in one order: bit-identical expected, held at the JAX test's
    rtol 1e-6, atol 1e-7); then 2n steps in bf16. The checkpoint's state dict
    loads into a ``ClipModel`` that embeds 512 pairs. No kernel of the port
    runs on the training path. Returns ({path: launches}, numbers)."""
    import numpy as np

    t_phase = time.perf_counter()
    numbers = {p: train_steps(torch, p, device) for p in ("fp32", "bf16")}
    n2 = str(2 * RESUME_STEPS)
    root = RUNS / "train_clip"
    shutil.rmtree(root, ignore_errors=True)
    full, wall_full, launches_fp32 = train_cli(torch, counters, root / "fp32", ["--total_steps", n2], True)
    _, wall_half, _ = train_cli(torch, counters, root / "resumed", ["--total_steps", str(RESUME_STEPS)], True)
    resumed, wall_resume, _ = train_cli(torch, counters, root / "resumed", ["--total_steps", n2, "--resume"], True)
    diff, same = max_param_diff(torch, full, resumed)
    print(f"train_clip fp32 {n2} steps {wall_full:.2f} s; {RESUME_STEPS} steps {wall_half:.2f} s, then --resume to "
          f"{n2} {wall_resume:.2f} s (deterministic algorithms): parameters max abs diff {diff:.3e}, "
          f"bit-identical {same}", flush=True)
    for k in full:
        check(bool(np.allclose(resumed[k].numpy(), full[k].numpy(), rtol=1e-6, atol=1e-7)),
              f"train_clip: the resumed run's {k} differs from the uninterrupted run's")
    meshed, wall_mesh, launches_mesh = train_cli(torch, counters, root / "mesh", ["--total_steps", n2, "--mesh", "1x1"],
                                                 True)
    diff_m, same_m = max_param_diff(torch, full, meshed)
    print(f"train_clip fp32 --mesh 1x1 (NCCL, a world of one) {n2} steps {wall_mesh:.2f} s: against no mesh "
          f"max abs diff {diff_m:.3e}, bit-identical {same_m}", flush=True)
    for k in full:
        check(bool(np.allclose(meshed[k].numpy(), full[k].numpy(), rtol=1e-6, atol=1e-7)),
              f"train_clip --mesh 1x1: {k} differs from the run without a mesh")
    _, wall_bf16, launches_bf16 = train_cli(torch, counters, root / "bf16", ["--total_steps", n2, "--precision", "bf16"])
    print(f"train_clip bf16 {n2} steps {wall_bf16:.2f} s", flush=True)
    for name in ("args.json", "out.txt", "done"):
        check((root / "fp32" / name).exists(), f"train_clip: {name} missing")
    check(sorted(p.name for p in (root / "fp32" / "ckpt").iterdir()) == [str(2 * RESUME_STEPS - 1)],
          "train_clip: the final checkpoint is not the last step's")

    embed_checkpoint(torch, root / "bf16" / "ckpt", device, "restored bf16 checkpoint")
    paths = {"train_clip_vit_b16_fp32": launches_fp32, "train_clip_vit_b16_fp32_mesh_1x1": launches_mesh,
             "train_clip_vit_b16_bf16": launches_bf16}
    for path, counts in paths.items():
        check(not any(counts.values()), f"{path}: a kernel of the port ran in training: {counts}")
    print(f"training phase: {time.perf_counter() - t_phase:.2f} s; kernel launches on the training paths: 0 "
          f"(plain attention, as the JAX trainer's XLA route)", flush=True)
    numbers["cli_wall_s"] = {"fp32": wall_full, "bf16": wall_bf16, "fp32_mesh_1x1": wall_mesh,
                             "fp32_half": wall_half, "fp32_resume": wall_resume}
    return paths, numbers


def phase_mesh_detection(torch, scoremax, topk, run):
    """Phase 20: phase 10's argv (bf16, its ``--embedding_cache``) with
    ``--mesh 1x1``: the sharded search of a world of one (K1, K2 and the K2
    merge of the gathered candidates) against phase 10's run, bit-identical
    scores csv and res.pkl columns. Returns (kernel launches, timing)."""
    argv = list(run["argv"])
    out = RUNS / "run_lemon_bf16_mesh"
    shutil.rmtree(out, ignore_errors=True)
    argv[argv.index("--output_dir") + 1] = str(out)
    launches, wall, log = run_cli(scoremax, topk, [*argv, "--mesh", "1x1"], {"LEMON_TPU_PRECISION": "bf16"})
    res, csv, auroc, timing = read_run(out, 20000, "run_lemon --mesh 1x1", log)
    print(f"run_lemon bf16 --mesh 1x1: wall {wall:.2f} s against phase 10's {run['wall']:.2f} s; AUROC {auroc}; "
          f"kernel launches {launches}", flush=True)
    check_launched(launches, K1_K2, "run_lemon --mesh 1x1")
    check(csv == run["csv"], "run_lemon --mesh 1x1: the scores csv differs from the run without a mesh")
    columns = check_same_columns(run["res"]["df"], res["df"], "run_lemon --mesh 1x1")
    print(f"run_lemon --mesh 1x1: scores csv and all {columns} res.pkl columns bit-identical to phase 10's", flush=True)
    return launches, timing


def check_same_columns(df0, df1, label: str) -> int:
    """Every column of two res.pkl frames equal bit for bit (NaN to NaN);
    the number of columns."""
    for col in df0.columns:
        a, b = df0[col].to_list(), df1[col].to_list()
        same = len(a) == len(b) and all(
            (x.tobytes() == y.tobytes()) if hasattr(x, "tobytes") else (x == y or (x != x and y != y))
            for x, y in zip(a, b))
        check(same, f"{label}: res.pkl column {col} differs from the run without a mesh")
    return len(df0.columns)


# phase 29: mimic_clip_from_scratch at full width, 4 AdamW steps at batch 32
# (a 320-row train split, 10 batches an epoch) at a rate that moves every
# weight, so a wrong gradient shows in the losses after the first
TP_ARGV = ["--dataset", "synthetic_caption", "--model_size", "vit_b16", "--context_length", "256", "--batch_size",
           "32", "--synthetic_n", "400", "--save_interval", "100", "--total_steps", "4", "--lr", "1e-4",
           "--warmup_steps", "0"]
TP_LEMON_ARGV = ["--dataset", "synthetic_caption", "--synthetic_n", "2000", "--knn_k", "5", "--clip_model",
                 "mimic_clip_from_scratch_random", "--noise_type", "random"]


def tp_rank(rank: int, root: str) -> None:
    """One of phase 29's two ranks, both on the one card: a gloo group over
    CUDA tensors (NCCL refuses two ranks on one device), then ``train_clip
    --mesh 1x2`` and, in bf16, ``run_lemon --mesh 1x2`` in-process. What it
    measured goes to ``<root>/rank<rank>.pt``: the losses, the step times,
    the peak memory, the bytes all-reduced over the model group, a digest
    of each replicated parameter, the kernel launches of each run."""
    import hashlib

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank, world_size=2)
    try:
        from lemon_tpu_torch.cli.run_lemon import kernel_launches
        from lemon_tpu_torch.cli.run_lemon import main as run_lemon
        from lemon_tpu_torch.cli.train_clip import main as train_clip
        from lemon_tpu_torch.models import clip
        from lemon_tpu_torch.train import contrastive

        stdout, stderr = sys.stdout, sys.stderr
        torch.cuda.reset_peak_memory_stats()
        try:
            with TimedSteps(torch, contrastive, "make_train_step") as steps:
                state = train_clip(["--output_dir", f"{root}/train_tp", *TP_ARGV, "--mesh", "1x2"])
        finally:
            restore_streams(stdout, stderr)
        layout = contrastive.tp_layout(state.model)
        out = {"losses": [float(loss) for _, loss in steps.results], "ms": steps.ms(), "steps": len(steps.seconds),
               "peak": torch.cuda.max_memory_allocated(), "all_reduce_bytes": clip.model_sum.bytes,
               "split": len(layout), "train_launches": kernel_launches(),
               "replicated": {k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
                              for k, v in state.model.state_dict().items() if k not in layout}}
        del state, steps  # the steps' results hold the state too
        torch.cuda.empty_cache()
        os.environ["LEMON_TPU_PRECISION"] = "bf16"
        t0 = time.perf_counter()
        try:
            run_lemon(["--output_dir", f"{root}/lemon_tp", *TP_LEMON_ARGV, "--mesh", "1x2"])
        finally:
            restore_streams(stdout, stderr)
        out["lemon_wall"] = time.perf_counter() - t0
        out["lemon_launches"] = kernel_launches()
        torch.save(out, f"{root}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_tensor_parallel(torch, counters, scoremax, topk, device):
    """Phase 29: tensor parallelism at the full width of
    ``mimic_clip_from_scratch`` (every sublayer splits at ``model = 2``: 12
    vision and 8 text heads). ``train_clip`` (fp32, TF32 off) and, in bf16,
    ``run_lemon`` on 2000 pairs run in this process without a mesh, then
    in two spawned ranks on the card with ``--mesh 1x2``
    (:func:`tp_rank`). Held: the losses within 1e-4 and the final
    checkpoint's parameters in units of the rate (AdamW's bar of
    tests/test_torch_tensor_parallel.py), the checkpoint in the
    single-process layout and loading into a ``ClipModel`` that embeds 512
    pairs, the replicated parameters bit-identical across the ranks, the
    detection's scores csv and res.pkl columns bit-identical, each run's
    files written once. Gloo stages every collective through host memory,
    so the step times say nothing of tensor parallelism's speed. Returns
    ({path: launches}, numbers)."""
    import numpy as np
    import torch.multiprocessing as mp

    from lemon_tpu_torch.cli.train_clip import main as train_clip
    from lemon_tpu_torch.train import contrastive
    from lemon_tpu_torch.train.contrastive import TrainConfig, make_schedule

    t_phase = time.perf_counter()
    root = RUNS / "tensor_parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    reset_counts(counters)
    stdout, stderr = sys.stdout, sys.stderr
    torch.cuda.reset_peak_memory_stats()
    try:
        with TimedSteps(torch, contrastive, "make_train_step") as steps:
            train_clip(["--output_dir", str(root / "train_one"), *TP_ARGV])
    finally:
        restore_streams(stdout, stderr)
    one = {"losses": [float(loss) for _, loss in steps.results], "ms": steps.ms(),
           "peak": torch.cuda.max_memory_allocated()}
    train_one_counts = split_counts(kernel_counts(counters))
    del steps
    lemon_one, wall_one, log = run_cli(scoremax, topk, ["--output_dir", str(root / "lemon_one"), *TP_LEMON_ARGV],
                                       {"LEMON_TPU_PRECISION": "bf16"})
    res_one, csv_one, auroc, _ = read_run(root / "lemon_one", 2000, "run_lemon bf16 mimic (phase 29)", log)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mp.spawn(tp_rank, args=(str(root),), nprocs=2, join=True)
    wall_ranks = time.perf_counter() - t0
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]

    for r, out in enumerate(ranks):
        gap = float(np.abs(np.subtract(out["losses"], one["losses"])).max())
        check(len(out["losses"]) == 4 and gap <= 1e-4,
              f"train_clip --mesh 1x2 rank {r}: losses {out['losses']} against {one['losses']} without a mesh")
        check(not any(out["train_launches"].values()), f"train_clip --mesh 1x2: a kernel of the port ran: {out}")
        check_launched(out["lemon_launches"], K1_K2, f"run_lemon --mesh 1x2 rank {r}")
        print(f"train_clip --mesh 1x2 rank {r} (gloo on one card): {out['steps']} steps, {out['ms']:.1f} ms per step "
              f"(median after the first, host clock, synchronised); max_memory_allocated {out['peak'] / 2**30:.2f} "
              f"GiB; all-reduced over the model group {out['all_reduce_bytes'] / 2**30:.3f} GiB "
              f"({out['all_reduce_bytes'] / out['steps'] / 2**30:.3f} GiB a step); {out['split']} parameters split, "
              f"{len(out['replicated'])} replicated; losses {[round(x, 6) for x in out['losses']]}", flush=True)
    print(f"train_clip without a mesh (this process): {one['ms']:.1f} ms per step, max_memory_allocated "
          f"{one['peak'] / 2**30:.2f} GiB; losses {[round(x, 6) for x in one['losses']]}; the two ranks' wall (start, "
          f"train, detect) {wall_ranks:.2f} s", flush=True)
    check(ranks[0]["replicated"] == ranks[1]["replicated"],
          "train_clip --mesh 1x2: a replicated parameter differs between the ranks")

    tp_dir, one_dir = root / "train_tp", root / "train_one"
    check(sorted(p.name for p in (tp_dir / "ckpt").iterdir()) == ["3"], "train_clip --mesh 1x2: not one checkpoint, 3")
    tp_ckpt = torch.load(tp_dir / "ckpt" / "3" / "state.pt", weights_only=True)
    one_ckpt = torch.load(one_dir / "ckpt" / "3" / "state.pt", weights_only=True)
    check({k: v.shape for k, v in tp_ckpt["model"].items()} == {k: v.shape for k, v in one_ckpt["model"].items()}
          and [t.shape for t in tp_ckpt["opt_state"]["mu"]] == [t.shape for t in one_ckpt["opt_state"]["mu"]],
          "train_clip --mesh 1x2: the checkpoint is not in the single-process layout")
    diff = torch.cat([(tp_ckpt["model"][k] - v).abs().reshape(-1) for k, v in one_ckpt["model"].items()])
    lr = make_schedule(TrainConfig(learning_rate=1e-4, warmup_steps=0, total_steps=4))
    bar = 2 * sum(lr(j) for j in range(4))
    beyond = float((diff > 1e-4).float().mean())
    print(f"train_clip --mesh 1x2 checkpoint against no mesh: parameters max abs diff {float(diff.max()):.3e} (bar "
          f"{bar:.3e}), share beyond 1e-4 {beyond:.2e} (bar 1e-3)", flush=True)
    check(float(diff.max()) <= bar and beyond <= 1e-3,
          "train_clip --mesh 1x2: the checkpoint's parameters differ from the run without a mesh")
    del tp_ckpt, one_ckpt, diff
    for label, d in (("train_clip --mesh 1x2", tp_dir), ("run_lemon --mesh 1x2", root / "lemon_tp")):
        text = (d / "out.txt").read_text()
        check((d / "done").exists() and text.count("Environment:") == 1, f"{label}: its files not written once")
    embed_checkpoint(torch, tp_dir / "ckpt", device, "train_clip --mesh 1x2 checkpoint")

    res_tp, csv_tp, auroc_tp, _ = read_run(root / "lemon_tp", 2000, "run_lemon --mesh 1x2",
                                           (root / "lemon_tp" / "out.txt").read_text())
    check(csv_tp == csv_one, "run_lemon --mesh 1x2: the scores csv differs from the run without a mesh")
    columns = check_same_columns(res_one["df"], res_tp["df"], "run_lemon --mesh 1x2")
    lemon_tp = {k: ranks[0]["lemon_launches"][k] + ranks[1]["lemon_launches"][k] for k in ranks[0]["lemon_launches"]}
    print(f"run_lemon bf16 mimic_clip_from_scratch_random n=2000 --mesh 1x2: walls {ranks[0]['lemon_wall']:.2f} / "
          f"{ranks[1]['lemon_wall']:.2f} s against {wall_one:.2f} s without a mesh; AUROC {auroc_tp}; scores csv and "
          f"all {columns} res.pkl columns bit-identical; kernel launches (both ranks) {lemon_tp}", flush=True)
    train_tp = {k: ranks[0]["train_launches"][k] + ranks[1]["train_launches"][k] for k in ranks[0]["train_launches"]}
    check(not any(train_one_counts.values()), f"train_clip (phase 29): a kernel of the port ran: {train_one_counts}")
    print(f"tensor-parallel phase: {time.perf_counter() - t_phase:.2f} s", flush=True)
    paths = {"train_clip_vit_b16_fp32_tp_1x2": train_tp, "run_lemon_mimic_bf16": lemon_one,
             "run_lemon_mimic_bf16_mesh_1x2": lemon_tp}
    numbers = {"one": one, "ranks": [{k: v for k, v in out.items() if k != "replicated"} for out in ranks],
               "wall_ranks_s": wall_ranks, "lemon_wall_one_s": wall_one}
    return paths, numbers


def phase_cpp_oracle(torch, embedding_cache, device):
    """Phase 21: the host C++ kNN (``ExactKnnIndex(backend="cpp")``) against
    the card's search at precision ``highest`` on phase 10's ViT-B/32
    embeddings (the 16000-row comparison set, all 2000 val queries, k=6),
    for the image and the text embeddings: ids equal except near-ties (at
    each slot where the two differ, the float64 similarities of the two
    neighbours to the query within NEAR_TIE); scores within 1e-5. Each
    search is held the same way against the exact order, a stable sort of
    the float64 similarities computed on the card."""
    import numpy as np

    from lemon_tpu_torch.knn.index import ExactKnnIndex

    blobs = {}
    for path in sorted(Path(embedding_cache).glob("emb_*.npz")):
        with np.load(path) as blob:
            blobs[len(blob["img"])] = (blob["img"], blob["txt"])
    check(16000 in blobs and 2000 in blobs, f"C++ oracle: phase 10's cache lacks the B/32 splits: {sorted(blobs)}")
    for m, name in enumerate(("img", "txt")):
        xb, xq = blobs[16000][m], blobs[2000][m]
        t0 = time.perf_counter()
        card = ExactKnnIndex(metric="ip", device=device, precision="highest")
        card.add(xb)
        s_card, i_card = card.search(xq, 6)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpp = ExactKnnIndex(metric="ip", backend="cpp")
        cpp.add(xb)
        s_cpp, i_cpp = cpp.search(xq, 6)
        t_cpp = time.perf_counter() - t0
        sims = (torch.from_numpy(xq).to(device).double() @ torch.from_numpy(xb).to(device).double().T)
        i_f64 = torch.sort(sims, dim=1, descending=True, stable=True)[1][:, :6].cpu().numpy()
        sims = sims.cpu().numpy()
        err = float(np.abs(s_card - s_cpp).max())
        print(f"C++ oracle, {name} embeddings ({xb.shape[0]} x {xb.shape[1]}, {len(xq)} queries, k=6): card 'highest' "
              f"{t_card:.3f} s, C++ {t_cpp:.3f} s (host clock); score max abs diff {err:.3e}", flush=True)
        check(err <= 1e-5, f"C++ oracle {name}: scores differ by {err}")
        for label, a, b in (("card vs C++", i_card, i_cpp), ("card vs float64", i_card, i_f64),
                            ("C++ vs float64", i_cpp, i_f64)):
            # a slot where the ids differ holds two neighbours whose float64
            # similarities to the query must be a near-tie
            rows, slots = np.nonzero(a != b)
            gaps = np.abs(sims[rows, a[rows, slots]] - sims[rows, b[rows, slots]])
            worst = int(np.argmax(gaps)) if len(gaps) else None
            gap = float(gaps[worst]) if len(gaps) else 0.0
            at = f" (query {rows[worst]}, slot {slots[worst]})" if len(gaps) else ""
            print(f"C++ oracle, {name}, {label}: {len(np.unique(rows))} rows with other ids, float64 similarity gap "
                  f"at most {gap:.3e}{at} (bar {NEAR_TIE})", flush=True)
            check(gap <= NEAR_TIE, f"C++ oracle {name}, {label}: a differing neighbour is {gap} from its twin")
        del sims
        torch.cuda.empty_cache()


DOWNSTREAM_N = 3000  # synthetic classification rows of phase 22: a 2400-row train split
DOWNSTREAM_BATCH = 64  # the CLIs' --batch_size in phases 22 and 23 (run_downstream's default)
TD_N = 1000  # synthetic classification rows of phase 23: 800 / 100 / 100
CARD_CPU_ROWS = 16  # the batch of the one-step card-to-CPU check
# one step card vs CPU, fp32 with TF32 off: the loss within LOSS_RTOL and
# the logits within LOGIT_TOL[backbone] of the CPU's (the ResNet's 50
# layers of BatchNorm on 16 rows amplify rounding, as
# tests/test_torch_classifier.py's 2e-4 bar at 5 layers shows). AdamW's
# parameters in units of the rate: its first step moves a parameter whose
# gradient is rounding noise by about lr with the noise's sign, so every
# element within 2 lr (1 + wd |p|), at most 1e-3 of them beyond 1e-6 (as
# tests/test_torch_train.py holds the JAX trainer). SGD's step is held to a
# float64 step on the CPU from the same init: the card's logits, updated
# parameters and BatchNorm statistics no further from it than F64_RATIO
# times the CPU's fp32 step is (a ResNet's gradients through BatchNorm on 16
# rows are conditioned so that two fp32 programs part by 1e-3 of a gradient)
LOSS_RTOL = 1e-4
LOGIT_TOL = {"vit_b32": 1e-4, "resnet50": 1e-3, "vit_b16": 1e-4}
F64_RATIO = 10.0


class TimedSteps:
    """Within the block, each step that ``module.<factory>`` builds is timed
    on the host clock between two synchronisations (``seconds``, one entry
    a step; ``results``, what each step returned)."""

    def __init__(self, torch, module, factory: str = "make_classifier_step"):
        self.torch, self.module, self.factory, self.seconds, self.results = torch, module, factory, [], []

    def __enter__(self):
        self.make = make = getattr(self.module, self.factory)
        torch, seconds, results = self.torch, self.seconds, self.results

        def timed_make(*args, **kwargs):
            step = make(*args, **kwargs)

            def timed(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*a)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                results.append(out)
                return out

            return timed

        setattr(self.module, self.factory, timed_make)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.factory, self.make)

    def ms(self) -> float:
        """The median step after the first (which pays for the first use of
        each cuDNN / cuBLAS algorithm)."""
        steady = sorted(self.seconds[1:] or self.seconds)
        return steady[len(steady) // 2] * 1e3


def card_cpu_step(torch, model_cfg, make_tx, label: str, device, logit_tol: float, adamw=None):
    """One ``make_classifier_step`` of one init on the card and on the CPU,
    the same batch (``CARD_CPU_ROWS`` synthetic rows preprocessed on the
    CPU): the loss, the logits and the updated parameters held to the bars
    above; ``adamw`` is ``(lr, weight_decay)`` for AdamW's bar, None for an
    SGD step, which is also taken in float64 on the CPU. Returns the
    differences."""
    import copy

    import numpy as np

    from lemon_tpu_torch.data.datasets import get_dataset, load_images
    from lemon_tpu_torch.models.classifier import init_classifier
    from lemon_tpu_torch.ops.image import preprocess_device
    from lemon_tpu_torch.train.downstream import make_classifier_step

    cpu = torch.device("cpu")
    split = get_dataset("synthetic", 0, noise_level=0.4, synthetic_n=TD_N)[0]
    idx = np.arange(CARD_CPU_ROWS)
    pixels = preprocess_device(load_images(split, idx), size=model_cfg.image_resolution, device=cpu)
    labels = torch.from_numpy(split.y_noisy[idx] % 10)
    mask = torch.ones(CARD_CPU_ROWS, dtype=torch.bool)
    cpu_model = init_classifier(model_cfg, 10, seed=0)
    variants = [("card", copy.deepcopy(cpu_model).to(device), device, torch.float32),
                ("cpu", cpu_model, cpu, torch.float32)]
    if adamw is None:
        variants.append(("f64", copy.deepcopy(cpu_model).double(), cpu, torch.float64))
    runs = {}
    for name, model, dev, dtype in variants:
        tx = make_tx()
        step = make_classifier_step(model, tx, tx.init(list(model.parameters())))
        t0 = time.perf_counter()
        loss, logits = step(pixels.to(dev, dtype), labels.to(dev), mask.to(dev))
        loss = float(loss)
        runs[name] = {"loss": loss, "logits": logits.cpu().double(), "seconds": time.perf_counter() - t0,
                      "state": {k: v.detach().cpu().double() for k, v in model.state_dict().items()
                                if v.is_floating_point()}}
        del model, step, tx
    torch.cuda.empty_cache()
    card, host = runs["card"], runs["cpu"]
    params = {k for k, _ in cpu_model.named_parameters()}
    diff = torch.cat([(card["state"][k] - host["state"][k]).abs().reshape(-1) for k in params])
    out = {"loss_card": card["loss"], "loss_cpu": host["loss"],
           "logits_max_abs_diff": float((card["logits"] - host["logits"]).abs().max()),
           "params_max_abs_diff": float(diff.max()), "params_share_above_1e-6": float((diff > 1e-6).float().mean()),
           "card_step_s": card["seconds"], "cpu_step_s": host["seconds"]}
    if adamw is None:  # each fp32 step's distance from the float64 step: [card, CPU]
        ref = runs["f64"]
        buffers = [k for k in ref["state"] if k not in params]

        def err(run, keys):
            return max((float((run["state"][k] - ref["state"][k]).abs().max()) for k in keys), default=0.0)

        out.update({"loss_f64": ref["loss"],
                    "logits_err_vs_f64": [float((r["logits"] - ref["logits"]).abs().max()) for r in (card, host)],
                    "params_err_vs_f64": [err(card, params), err(host, params)],
                    "buffers_err_vs_f64": [err(card, buffers), err(host, buffers)], "f64_step_s": ref["seconds"]})
    print(f"{label}: one step card vs CPU ({CARD_CPU_ROWS} rows, fp32, TF32 off): " + json.dumps(out), flush=True)
    check(bool(np.isfinite(card["loss"])) and abs(card["loss"] - host["loss"]) <= LOSS_RTOL * max(1.0, abs(host["loss"])),
          f"{label}: card loss {card['loss']} against the CPU's {host['loss']}")
    check(out["logits_max_abs_diff"] <= logit_tol, f"{label}: logits differ by {out['logits_max_abs_diff']}")
    if adamw is None:
        for what in ("logits", "params", "buffers"):
            e_card, e_cpu = out[f"{what}_err_vs_f64"]
            check(e_card <= F64_RATIO * max(e_cpu, 1e-7),
                  f"{label}: the card's {what} are {e_card} from the float64 step, the CPU's fp32 {e_cpu}")
    else:
        lr, wd = adamw
        bound = 2 * lr * (1 + wd * max(float(host["state"][k].abs().max()) for k in params))
        check(out["params_max_abs_diff"] <= bound and out["params_share_above_1e-6"] <= 1e-3,
              f"{label}: AdamW's parameters differ by {float(diff.max())} (bound {bound}), "
              f"{out['params_share_above_1e-6']} of them beyond 1e-6")
    return out


def training_counts(counters, label: str) -> dict:
    """The kernel counts since the last reset, each 0: the classifiers, the
    BLIP ITM tower and the captioners run plain attention and PyTorch's
    convolutions, as the JAX package runs them in XLA (or host torch),
    outside any Pallas kernel."""
    counts = split_counts(kernel_counts(counters))
    check(not any(counts.values()), f"{label}: a kernel of the port ran: {counts}")
    return counts


def phase_downstream(torch, counters, scoremax, topk, device):
    """Phase 22: downstream classification at ViT-B/32 width. A detector's
    scores for ``DOWNSTREAM_N`` synthetic classification rows
    (``run_baseline --baseline clip_sim``: dists.npy + datasplit.npy), then
    ``run_downstream --task classification --model_size vit_b32 --scores
    dists.npy --epochs 2``: its files, the kept count at the 60th
    percentile, finite losses, ms per step, images/s and peak memory; the
    CIFAR-10-C robustness mode on a fixture of that layout (5 severities of
    200 seeded uint8 images) with the run's ckpt.pt twice; one AdamW step of
    the ViT-B/32 classifier on the card against the CPU. Returns
    ({path: kernel launches}, numbers)."""
    import numpy as np

    from lemon_tpu_torch.cli.run_baseline import main as run_baseline
    from lemon_tpu_torch.cli.run_downstream import main as run_downstream
    from lemon_tpu_torch.models.clip import ClipConfig
    from lemon_tpu_torch.train import downstream
    from lemon_tpu_torch.train.contrastive import Optimizer, cosine_decay_schedule

    t_phase = time.perf_counter()
    root = RUNS / "downstream"
    shutil.rmtree(root, ignore_errors=True)
    data = ["--dataset", "synthetic", "--noise_type", "symmetric", "--synthetic_n", str(DOWNSTREAM_N)]
    reset_counts(counters)
    det = root / "clip_sim"
    _, det_wall, _, _ = run_entry(run_baseline, scoremax, topk, ["--output_dir", str(det), "--baseline", "clip_sim",
                                                                 *data, "--clip_model", "huggingface_clip"], {})
    train_scores = np.load(det / "dists.npy")[np.load(det / "datasplit.npy", allow_pickle=True).ravel() == "train"]
    kept = int((train_scores <= np.percentile(train_scores, 60.0)).sum())

    out = root / "vit_b32"
    argv = ["--output_dir", str(out), "--task", "classification", "--model_size", "vit_b32", *data,
            "--scores", str(det / "dists.npy"), "--epochs", "2", "--batch_size", str(DOWNSTREAM_BATCH)]
    torch.cuda.reset_peak_memory_stats()
    with TimedSteps(torch, downstream) as steps:
        _, wall, log, res = run_entry(run_downstream, scoremax, topk, argv, {})
    peak = torch.cuda.max_memory_allocated()
    for name in ("args.json", "out.txt", "results.json", "val_pred_y.npy", "test_pred_y.npy", "val_probs.npy",
                 "test_probs.npy", "ckpt.pt", "done"):
        check((out / name).exists(), f"run_downstream: {name} missing")
    check(f"filter: kept {kept}/{len(train_scores)} train examples" in log,
          f"run_downstream: the filter did not keep {kept} of {len(train_scores)} rows at the 60th percentile")
    losses = [float(line.split()[3]) for line in log.splitlines() if line.startswith("epoch ")]
    n_steps = 2 * -(-kept // DOWNSTREAM_BATCH)
    check(len(losses) == 2 and bool(np.isfinite(losses).all()) and len(steps.seconds) == n_steps,
          f"run_downstream: epoch losses {losses}, {len(steps.seconds)} steps (expected {n_steps})")
    probs = np.load(out / "test_probs.npy")
    check(probs.shape == (DOWNSTREAM_N // 10, 10) and bool(np.isfinite(probs).all()), "run_downstream: test probabilities")
    ms = steps.ms()
    numbers = {"vit_b32": {"ms_per_step": ms, "images_per_s": DOWNSTREAM_BATCH / ms * 1e3,
                           "max_memory_allocated": peak, "wall_s": wall, "epoch_losses": losses,
                           "test_accuracy": res["test"]["accuracy"], "kept": kept}}
    print(f"run_downstream vit_b32 (detector clip_sim {det_wall:.2f} s; kept {kept}/{len(train_scores)}): wall "
          f"{wall:.2f} s; {len(steps.seconds)} steps at batch {DOWNSTREAM_BATCH}, {ms:.2f} ms per step (median after "
          f"the first, host clock, synchronised), {DOWNSTREAM_BATCH / ms * 1e3:.1f} images/s; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; epoch losses {losses}; test accuracy {res['test']['accuracy']:.4f}", flush=True)

    # the robustness mode on a CIFAR-10-C-layout fixture
    rng = np.random.default_rng(0)
    c10c = root / "data" / "CIFAR-10-C"
    c10c.mkdir(parents=True)
    np.save(c10c / "gaussian_noise.npy", rng.integers(0, 256, (1000, 32, 32, 3), np.uint8))
    np.save(c10c / "labels.npy", np.tile(rng.integers(0, 10, 200), 5))
    rob = root / "robustness"
    ckpt = str(out / "ckpt.pt")
    _, rob_wall, _, rob_res = run_entry(
        run_downstream, scoremax, topk,
        ["--output_dir", str(rob), "--task", "classification", "--epochs", "0", "--model_size", "vit_b32",
         "--cifar10_corruption_name", "gaussian_noise", "--eval_checkpoints", ckpt, ckpt],
        {"LEMON_TPU_DATA_ROOT": str(root / "data")})
    for mc in (0, 1):
        for name in (f"test_pred_y_gaussian_noise_{mc}.npy", f"test_true_y_gaussian_noise_{mc}.npy",
                     f"results_gaussian_noise_{mc}.pkl"):
            check((rob / name).exists(), f"robustness mode: {name} missing")
    preds = [np.load(rob / f"test_pred_y_gaussian_noise_{mc}.npy") for mc in (0, 1)]
    check(preds[0].shape == (1000,) and np.array_equal(*preds) and (rob / "done").exists(),
          "robustness mode: one checkpoint twice gave two predictions")
    print(f"robustness mode (CIFAR-10-C layout, 5 x 200 images, the checkpoint twice): wall {rob_wall:.2f} s; "
          f"average accuracy {rob_res[0]['average_accuracy']:.4f}, worst group {rob_res[0]['worst_accuracy']:.4f}",
          flush=True)
    paths = {"run_downstream_vit_b32": training_counts(counters, "phase 22")}
    numbers["vit_b32"]["card_vs_cpu"] = card_cpu_step(
        torch, ClipConfig.vit_b32(), lambda: Optimizer("adamw", cosine_decay_schedule(1e-4, 100), weight_decay=1e-4),
        "classifier vit_b32 (AdamW)", device, LOGIT_TOL["vit_b32"], adamw=(1e-4, 1e-4))
    print(f"downstream phase: {time.perf_counter() - t_phase:.2f} s; kernel launches on the downstream path: 0 "
          f"(plain attention, as the JAX classifier's XLA route)", flush=True)
    return paths, numbers


def phase_training_dependent(torch, counters, scoremax, topk, device):
    """Phase 23: ``run_baseline --baseline aum --img_base_name resnet50``
    (the torchvision-layout ResNet-50 at 224 px) and ``--baseline datamap
    --img_base_name vit-base-patch16-224`` (the google ViT-B/16) on
    ``TD_N`` synthetic classification rows, 2 epochs at batch 64: the files
    (the per-epoch pkls included), finite scores, the ResNet's BatchNorm
    statistics moved by every step, ms per step, images/s and peak memory;
    then one SGD step of each backbone on the card against the CPU.
    Returns ({path: kernel launches}, numbers)."""
    import numpy as np

    from lemon_tpu_torch.baselines import training_dependent
    from lemon_tpu_torch.cli.run_baseline import classifier_config
    from lemon_tpu_torch.cli.run_baseline import main as run_baseline
    from lemon_tpu_torch.train.contrastive import Optimizer

    t_phase = time.perf_counter()
    paths, numbers = {}, {}
    for method, base, key in (("aum", "resnet50", "resnet50"), ("datamap", "vit-base-patch16-224", "vit_b16")):
        out = RUNS / f"baseline_{method}_{key}"
        shutil.rmtree(out, ignore_errors=True)
        models, init = [], training_dependent.init_classifier
        training_dependent.init_classifier = lambda *a, **k: models.append(init(*a, **k)) or models[-1]
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        try:
            with TimedSteps(torch, training_dependent) as steps:
                _, wall, _, res = run_entry(run_baseline, scoremax, topk, [
                    "--output_dir", str(out), "--baseline", method, "--img_base_name", base, "--dataset", "synthetic",
                    "--noise_type", "symmetric", "--synthetic_n", str(TD_N), "--epochs", "2",
                    "--batch_size", str(DOWNSTREAM_BATCH)], {})
        finally:
            training_dependent.init_classifier = init
        peak = torch.cuda.max_memory_allocated()
        for name in ("args.json", "out.txt", "res.pkl", "scores.csv", "runtime.npy", "done",
                     *(f"{s}_epoch_{e}.pkl" for s in ("val", "test") for e in (0, 1))):
            check((out / name).exists(), f"baseline {method} {key}: {name} missing")
        scores = res["df"]["pred_score"].to_numpy()
        n_steps = 2 * sum(-(-n // DOWNSTREAM_BATCH) for n in (800, 100, 100))
        check(len(scores) == TD_N and bool(np.isfinite(scores).all()) and len(steps.seconds) == n_steps,
              f"baseline {method} {key}: {len(scores)} scores, {len(steps.seconds)} steps (expected {n_steps})")
        if key == "resnet50":
            bn = models[0].backbone.bn1
            check(int(bn.num_batches_tracked) == n_steps
                  and not torch.equal(bn.running_var, torch.ones_like(bn.running_var)),
                  "aum resnet50: BatchNorm's running statistics did not move with each step")
        ms = steps.ms()
        auroc = {s: round(float(res["agg_results"][s]["AUROC"]), 4) for s in ("val", "test")}
        numbers[key] = {"ms_per_step": ms, "images_per_s": DOWNSTREAM_BATCH / ms * 1e3, "max_memory_allocated": peak,
                        "wall_s": wall, "runtime_s": float(np.load(out / "runtime.npy")[0]), "auroc": auroc}
        print(f"baseline {method} --img_base_name {base} (n={TD_N}, 2 epochs, SGD lr 1e-3): wall {wall:.2f} s, "
              f"runtime.npy {numbers[key]['runtime_s']:.2f} s; {len(steps.seconds)} steps at batch {DOWNSTREAM_BATCH}, "
              f"{ms:.2f} ms per step (median after the first, host clock, synchronised), "
              f"{DOWNSTREAM_BATCH / ms * 1e3:.1f} images/s; max_memory_allocated {peak / 2**30:.2f} GiB; AUROC {auroc}",
              flush=True)
        paths[f"baseline_{method}_{key}"] = training_counts(counters, f"phase 23 {method}")
        del models
        numbers[key]["card_vs_cpu"] = card_cpu_step(
            torch, classifier_config(base), lambda: Optimizer("sgd", lambda count: 1e-3, momentum=0.9),
            f"classifier {key} (SGD)", device, LOGIT_TOL[key])
    print(f"aum/datamap phase: {time.perf_counter() - t_phase:.2f} s; kernel launches on the aum and datamap paths: 0 "
          f"(PyTorch's convolutions and plain attention, as the JAX package's XLA route)", flush=True)
    return paths, numbers


# the BLIP ITM, captioning and BLIP-2 phases (24-26): no kernel of the port runs on their paths
CAPFILT_N = 800  # synthetic caption pairs of phase 24: 640 / 80 / 80 (cut from 2000 to pay for phase 29)
PMATCH_TOL = 1e-4  # P(match), card vs CPU from the card's weights, fp32 with TF32 off
CAPTION_N = 2000  # synthetic caption pairs of phase 25 (phase 17's detections score the same data)
CAPTION_BATCH = 32
CAPTION_RTOL = 1e-5  # per-sample LM loss, card vs CPU on one batch
BLIP2_BATCH = 4
CAPTION_DATA = ["--dataset", "synthetic_caption", "--noise_type", "random", "--noise_level", "0.4"]
JUDGE_N = 160  # synthetic caption pairs of phase 27: 16 val and 16 test pairs judged (cut from 320 for phase 29)
JUDGE_ARGV = ["--judge", "llava", "--backend", "flax", "--dataset", "synthetic_caption", "--synthetic_n", str(JUDGE_N),
              "--generate_batch_size", "8", "--max_new_tokens", "16"]
JUDGE_LOGP_TOL = 1e-4  # generate_judged's log-probabilities, card vs CPU, fp32 with TF32 off
VDC_EXAMPLES = 4


def itm_vocab(captions, size: int) -> list:
    """A WordPiece vocabulary of ``size`` entries: BERT's specials, every
    lowercase word of ``captions``, then unused fillers."""
    import re

    words = sorted({w for c in captions for w in re.findall(r"[a-z]+", str(c).lower())})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words]
    return vocab + [f"[unused{i}]" for i in range(size - len(vocab))]


def itm_split(torch, itm, images, captions, reps: int = 5):
    """(ms for the inputs of one batch: the host processor, the tokens and
    the upload; ms for the model on them, CUDA events), each a mean of
    ``reps`` after a warm-up: where the scorer's time goes."""
    itm.inputs(images, captions)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        inputs = itm.inputs(images, captions)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        itm.model(*inputs)
        start.record()
        for _ in range(reps):
            itm.model(*inputs)
        end.record()
    torch.cuda.synchronize()
    return host_ms, start.elapsed_time(end) / reps


def phase_capfilt(torch, counters, scoremax, topk, device):
    """Phase 24: ``run_baseline --baseline capfilt --itm_checkpoint DIR`` on
    ``CAPFILT_N`` synthetic caption pairs, DIR a random-init BLIP ITM at
    ``Salesforce/blip-itm-base-coco``'s widths that the port's writer puts on
    disk; every P(match) finite in [0, 1], the first 32 train pairs' P(match)
    held to the same port code on the CPU from the card's weights; then the
    CLIP proxy (no checkpoint) at ViT-B/32 width in bf16. Returns
    ({path: kernel launches}, numbers)."""
    import numpy as np

    from lemon_tpu_torch.cli.run_baseline import main as run_baseline
    from lemon_tpu_torch.data.datasets import get_dataset, load_images
    from lemon_tpu_torch.models.blip_itm import BlipItmConfig, BlipItmModel, init_blip_itm, load_blip_itm, save_blip_itm

    t_phase = time.perf_counter()
    root = RUNS / "capfilt"
    shutil.rmtree(root, ignore_errors=True)
    train = get_dataset("synthetic_caption", 0, noise_level=0.4, noise_type="random", synthetic_n=CAPFILT_N)[0]
    cfg = BlipItmConfig.base()
    with torch.device(device):
        model = BlipItmModel(cfg)
    init_blip_itm(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    ckpt = save_blip_itm(model, root / "blip_itm_base", itm_vocab(train.sentence, cfg.text.vocab_size))
    write_s = time.perf_counter() - t0
    del model
    data = [*CAPTION_DATA, "--synthetic_n", str(CAPFILT_N)]
    paths, numbers = {}, {}
    for key, extra, env in (("capfilt_blip_itm_base", ["--itm_checkpoint", str(ckpt)], {}),
                            ("capfilt_clip_proxy_bf16", ["--clip_model", "huggingface_clip"],
                             {"LEMON_TPU_PRECISION": "bf16"})):
        out = root / key
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        _, wall, log, res = run_entry(run_baseline, scoremax, topk,
                                      ["--output_dir", str(out), "--baseline", "capfilt", *data, *extra], env)
        peak = torch.cuda.max_memory_allocated()
        paths[key] = training_counts(counters, f"phase 24 {key}")
        for name in ("args.json", "out.txt", "res.pkl", "scores.csv", "full_loss_dict.pkl", "flip_labels.pkl",
                     "runtime.npy", "done"):
            check((out / name).exists(), f"{key}: {name} missing")
        with open(out / "full_loss_dict.pkl", "rb") as f:
            p_match = pickle.load(f)
        every = np.concatenate([p_match[s] for s in ("train", "val", "test")])
        check(len(every) == CAPFILT_N and bool(np.isfinite(every).all()) and every.min() >= 0 and every.max() <= 1,
              f"{key}: P(match) not {CAPFILT_N} values in [0, 1]")
        check(("no BLIP-ITM checkpoint" in log) == (key == "capfilt_clip_proxy_bf16"), f"{key}: the wrong scorer ran")
        runtime = float(np.load(out / "runtime.npy")[0])
        auroc = {s: round(float(res["agg_results"][s]["AUROC"]), 4) for s in ("val", "test")}
        numbers[key] = {"wall_s": wall, "runtime_s": runtime, "pairs_per_s": CAPFILT_N / runtime,
                        "max_memory_allocated": peak, "auroc": auroc}
        line = (f"{key} (n={CAPFILT_N}): wall {wall:.2f} s, runtime.npy {runtime:.2f} s, {CAPFILT_N / runtime:.1f} "
                f"pairs/s; max_memory_allocated {peak / 2**30:.2f} GiB; AUROC {auroc}")
        if key == "capfilt_blip_itm_base":
            itm = load_blip_itm(ckpt, torch.device("cpu"))
            idx = np.arange(32)
            cpu_p = itm.p_match(load_images(train, idx, stack=False), list(train.sentence[idx]))
            err = float(np.abs(cpu_p - p_match["train"][:32]).max())
            numbers[key].update(params=n_params, checkpoint_write_s=write_s, card_vs_cpu=err)
            line += (f"; {n_params / 1e6:.1f}M parameters, checkpoint written in {write_s:.2f} s; first 32 P(match) "
                     f"card vs CPU max abs diff {err:.3g} (bar {PMATCH_TOL})")
            check(err <= PMATCH_TOL, f"{key}: P(match) card vs CPU {err} > {PMATCH_TOL}")
            host_ms, model_ms = itm_split(torch, load_blip_itm(ckpt, device),
                                          load_images(train, idx[:16], stack=False), list(train.sentence[:16]))
            batches = -(-CAPFILT_N // 16)
            numbers[key].update(inputs_ms_per_16=host_ms, model_ms_per_16=model_ms)
            line += (f"; a batch of 16: inputs {host_ms:.2f} ms (host processor and tokens, upload), model "
                     f"{model_ms:.2f} ms (CUDA events), x{batches} batches: {host_ms * batches / 1e3:.2f} s + "
                     f"{model_ms * batches / 1e3:.2f} s")
            del itm
        print(line, flush=True)
    print(f"capfilt phase: {time.perf_counter() - t_phase:.2f} s; kernel launches on the capfilt paths: 0 (plain "
          f"attention, as the JAX package scores with host torch and XLA)", flush=True)
    return paths, numbers


def phase_captioning(torch, counters, scoremax, topk, device, scores_csv: Path):
    """Phase 25: ``run_downstream --task captioning --model_size vit_b32`` on
    ``CAPTION_N`` synthetic caption pairs with phase 17's rn50 fp32 scores
    (the same 2000 pairs), 1 epoch at batch ``CAPTION_BATCH``: GIT, GIT
    ``--lora`` and the Q-Former base ``--captioner_arch blip2 --lora``. Each
    run's files, kept count and step count, ms per step, images/s, peak
    memory, generation seconds and loss-detection AUROC; the trained model's
    per-sample losses on the card against the CPU on the first test batch;
    the Q-Former run's frozen vision tower bit-stable. Returns ({path: kernel
    launches}, numbers)."""
    import numpy as np
    import pandas as pd

    from lemon_tpu_torch.cli.run_downstream import main as run_downstream
    from lemon_tpu_torch.data.datasets import get_dataset, load_images
    from lemon_tpu_torch.models.captioner import CaptioningModel
    from lemon_tpu_torch.ops.image import preprocess_device
    from lemon_tpu_torch.train import captioning

    t_phase = time.perf_counter()
    splits = get_dataset("synthetic_caption", 0, noise_level=0.4, noise_type="random", synthetic_n=CAPTION_N)
    n_train, test = len(splits[0]), splits[2]
    train_scores = pd.read_csv(scores_csv).query("sset == 'train'")["pred_score"].to_numpy()
    kept = int((train_scores <= np.percentile(train_scores, 60.0)).sum())
    n_steps = -(-kept // CAPTION_BATCH)
    cpu = torch.device("cpu")
    paths, numbers = {}, {}
    for key, extra in (("captioning_git_vit_b32", []), ("captioning_git_vit_b32_lora", ["--lora"]),
                       ("captioning_qformer_base_lora", ["--captioner_arch", "blip2", "--lora"])):
        out = RUNS / key
        shutil.rmtree(out, ignore_errors=True)
        built, init, generate, gen_s = [], captioning.init_captioner, CaptioningModel.generate, []

        def capture(*a, **k):
            m = init(*a, **k)
            built.append((m, {n: p.detach().clone() for n, p in m.named_parameters() if n.startswith("visual.")}))
            return m

        def timed_generate(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = generate(self, *a, **k)
            torch.cuda.synchronize()
            gen_s.append(time.perf_counter() - t0)
            return toks

        captioning.init_captioner, CaptioningModel.generate = capture, timed_generate
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        try:
            with TimedSteps(torch, captioning, "make_caption_step") as steps:
                _, wall, log, res = run_entry(run_downstream, scoremax, topk, [
                    "--output_dir", str(out), "--task", "captioning", "--model_size", "vit_b32", *CAPTION_DATA,
                    "--synthetic_n", str(CAPTION_N), "--scores", str(scores_csv), "--epochs", "1",
                    "--batch_size", str(CAPTION_BATCH), *extra], {})
        finally:
            captioning.init_captioner, CaptioningModel.generate = init, generate
        peak = torch.cuda.max_memory_allocated()
        paths[key] = training_counts(counters, f"phase 25 {key}")
        for name in ("args.json", "out.txt", "captions.pkl", "flip_labels.pkl", "detection_scores.npy", "results.json",
                     "done"):
            check((out / name).exists(), f"{key}: {name} missing")
        check(f"filter: kept {kept}/{n_train} captions" in log, f"{key}: the filter did not keep {kept} of {n_train}")
        det = np.load(out / "detection_scores.npy")
        check(len(steps.seconds) == n_steps and np.isfinite(res["val_loss_best"]) and det.shape == (len(test),)
              and bool(np.isfinite(det).all()), f"{key}: {len(steps.seconds)} steps (expected {n_steps}), val loss "
              f"{res['val_loss_best']}, detection scores {det.shape}")
        model, visual0 = built[0]
        if "qformer" in key:
            moved = [n for n, p in model.named_parameters() if n in visual0 and not torch.equal(p, visual0[n])]
            check(not moved, f"{key}: the frozen vision tower moved: {moved[:3]}")
        twin = type(model)(model.cfg)
        twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        idx = np.arange(CAPTION_BATCH)
        size = model.cfg.vision.image_resolution
        pixels = preprocess_device(load_images(test, idx, decode_size=size), size=size, device=cpu)
        tokens = torch.from_numpy(captioning._tokenize_captions(test.sentence[idx], model.cfg))
        with torch.no_grad():
            card = model.per_sample_loss(pixels.to(device), tokens.to(device)).cpu()
            host = twin.eval().per_sample_loss(pixels, tokens)
        rel = float(((card - host).abs() / host.abs()).max())
        check(rel <= CAPTION_RTOL, f"{key}: per-sample loss card vs CPU {rel} > {CAPTION_RTOL} relative")
        ms = steps.ms()
        auroc = res.get("test_loss_detection_AUROC")
        numbers[key] = {"ms_per_step": ms, "images_per_s": CAPTION_BATCH / ms * 1e3, "max_memory_allocated": peak,
                        "wall_s": wall, "generation_s": sum(gen_s), "test_loss_detection_AUROC": auroc,
                        "val_loss_best": res["val_loss_best"], "card_vs_cpu_rel": rel,
                        "trainable": sum(p.numel() for p in model.parameters() if p.requires_grad)}
        print(f"{key} (n={CAPTION_N}, kept {kept}/{n_train}, 1 epoch): wall {wall:.2f} s; {len(steps.seconds)} steps at "
              f"batch {CAPTION_BATCH}, {ms:.2f} ms per step (median after the first, host clock, synchronised), "
              f"{CAPTION_BATCH / ms * 1e3:.1f} images/s; max_memory_allocated {peak / 2**30:.2f} GiB; generation "
              f"{sum(gen_s):.2f} s ({len(gen_s)} calls); test loss-detection AUROC {auroc}; val loss "
              f"{res['val_loss_best']:.4f}; first test batch per-sample loss card vs CPU {rel:.3g} relative (bar "
              f"{CAPTION_RTOL}); trainable parameters {numbers[key]['trainable']}", flush=True)
        del built, model, twin, res
    print(f"captioning phase: {time.perf_counter() - t_phase:.2f} s; kernel launches on the captioning paths: 0 (plain "
          f"attention, as the JAX captioners' einsums)", flush=True)
    return paths, numbers


def phase_blip2_opt(torch, counters, device):
    """Phase 26: the HF-exact BLIP-2 at ``Salesforce/blip2-opt-2.7b``'s
    widths (``Blip2Config.opt_2_7b``), random init in fp32 on the card, one
    batch of ``BLIP2_BATCH`` synthetic caption pairs: per-sample loss, two
    LoRA steps (only the LoRA factors change), greedy ``generate`` to 40
    tokens and ``generate_judged`` on 2 left-padded prompts. Returns
    ({path: kernel launches}, numbers)."""
    import numpy as np

    from lemon_tpu_torch.data.datasets import get_dataset, load_images
    from lemon_tpu_torch.models.blip2 import Blip2Config
    from lemon_tpu_torch.models.captioner import init_captioner, lora_trainable_mask
    from lemon_tpu_torch.ops.image import preprocess_device
    from lemon_tpu_torch.train.captioning import _tokenize_captions, make_caption_step
    from lemon_tpu_torch.train.contrastive import Optimizer

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t_phase = time.perf_counter()
    cfg = Blip2Config.opt_2_7b()
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    model, init_s = timed(lambda: init_captioner(cfg, seed=0, device=device))
    n_params = sum(p.numel() for p in model.parameters())
    split = get_dataset("synthetic_caption", 0, noise_level=0.4, noise_type="random", synthetic_n=CAPTION_N)[2]
    idx = np.arange(BLIP2_BATCH)
    size = cfg.vision.image_resolution
    pixels = preprocess_device(load_images(split, idx, decode_size=size), size=size, device=device)
    tokens = torch.from_numpy(_tokenize_captions(split.sentence[idx], cfg)).to(device)
    with torch.no_grad():
        per, loss_s = timed(lambda: model.eval().per_sample_loss(pixels, tokens))
    check(per.shape == (BLIP2_BATCH,) and bool(torch.isfinite(per).all()), f"blip2 opt-2.7b: per-sample loss {per}")

    names = [n for n, _ in model.named_parameters() if lora_trainable_mask(n)]
    check(names and all(n.endswith(("lora_a", "lora_b")) for n in names), "blip2: the LoRA set is not the factors")
    params = [p for n, p in model.named_parameters() if n in names]
    for n, p in model.named_parameters():
        p.requires_grad_(n in names)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n not in names}
    lora_b0 = {n: p.detach().clone() for n, p in model.named_parameters() if n.endswith("lora_b")}
    tx = Optimizer("adamw", lambda count: 1e-4, weight_decay=0.05)
    step = make_caption_step(model, tx, tx.init(params), params)
    mask = torch.ones(BLIP2_BATCH, dtype=torch.bool, device=device)
    step_losses, step_s = [], []
    for _ in range(2):
        loss, s = timed(lambda: step(pixels, tokens, mask))
        step_losses.append(float(loss))
        step_s.append(s)
    moved = [n for n, p in model.named_parameters() if n in frozen and not torch.equal(p, frozen[n])]
    check(not moved, f"blip2 opt-2.7b: a frozen parameter moved under LoRA: {moved[:3]}")
    check(all(not torch.equal(p, lora_b0[n]) for n, p in model.named_parameters() if n in lora_b0)
          and bool(np.isfinite(step_losses).all()), f"blip2 opt-2.7b: LoRA B did not move, or losses {step_losses}")
    del frozen, lora_b0
    model.eval()
    gen, gen_s = timed(lambda: model.generate(pixels, cfg.bos_token_id, cfg.eos_token_id, max_len=40))
    check(gen.shape == (BLIP2_BATCH, 40) and bool((gen[:, 0] == cfg.bos_token_id).all()), "blip2: generate shape")
    prompts = torch.tensor(_tokenize_captions(["a photo of", "the image shows a big red"], cfg)[:, :6], device=device)
    prompt_mask = (prompts != cfg.pad_token_id).long()
    order = torch.argsort(prompt_mask, dim=1, stable=True)  # left-pad: the padding first
    prompts, prompt_mask = prompts.gather(1, order), prompt_mask.gather(1, order)
    check(bool((prompt_mask[:, 0] == 0).any()) and bool(prompt_mask[:, -1].all()),
          "blip2: the prompts are not left-padded")
    (judged, logp), judged_s = timed(lambda: model.generate_judged(pixels[:2], prompts, prompt_mask, max_new_tokens=16))
    check(judged.shape == (2, 16) and bool(torch.isfinite(logp).all()) and bool((logp <= 0).all()),
          "blip2: generate_judged tokens or log-probabilities")
    peak = torch.cuda.max_memory_allocated()
    paths = {"blip2_opt_2.7b": training_counts(counters, "phase 26")}
    numbers = {"params": n_params, "decoder_layers": cfg.decoder_layers, "init_s": init_s, "loss_s": loss_s,
               "lora_step_s": step_s, "lora_step_losses": step_losses, "generate_40_s": gen_s,
               "generate_judged_16_s": judged_s, "max_memory_allocated": peak}
    print(f"blip2 opt-2.7b widths ({n_params / 1e9:.3f}B parameters, fp32, {cfg.decoder_layers} OPT layers, random "
          f"init in {init_s:.2f} s), batch {BLIP2_BATCH}: per-sample loss {loss_s * 1e3:.1f} ms; LoRA steps "
          f"{[round(s * 1e3, 1) for s in step_s]} ms (losses {step_losses}); greedy generate to 40 tokens "
          f"{gen_s:.2f} s; generate_judged 2 x 16 tokens {judged_s:.2f} s; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; phase {time.perf_counter() - t_phase:.2f} s; kernel launches 0", flush=True)
    del model, params, step, tx
    torch.cuda.empty_cache()
    return paths, numbers


def scripted_llm(prompt: str) -> str:
    """VDC's LLM stages on the host: two fixed questions for VQG, a yes or no
    from the prompt's crc32 for the answer check (stable across processes)."""
    import zlib

    if "generate some visual questions" in prompt:
        return "Is there a photo in the image?\nDoes the image match the caption?"
    return "yes" if zlib.crc32(prompt.encode()) % 2 == 0 else "no"


def phase_judges(torch, counters, scoremax, topk, device):
    """Phase 27: ``run_judges --backend flax`` on a sharded BLIP-2 at
    ``Salesforce/blip2-opt-2.7b``'s widths that ``save_blip2`` writes, the
    card-vs-CPU check of the first batch at 2 OPT layers, and ``VdcPipeline``
    on the full-width model. Returns ({path: kernel launches}, numbers)."""
    import copy
    import dataclasses
    import tempfile

    import numpy as np

    from lemon_tpu_torch.baselines.judges import LLAVA_QUERY, VdcPipeline
    from lemon_tpu_torch.cli.run_judges import Blip2Judge, main as run_judges
    from lemon_tpu_torch.data.datasets import get_dataset, load_images
    from lemon_tpu_torch.models.blip2 import Blip2Config, save_blip2
    from lemon_tpu_torch.models.captioner import init_captioner

    t_phase = time.perf_counter()
    root = RUNS / "judges"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = Blip2Config.opt_2_7b()
    model = init_captioner(cfg, seed=0, device=device)
    n_bytes = sum(t.numel() * t.element_size() for n, t in model.state_dict().items() if "lora" not in n)
    free = shutil.disk_usage(root).free
    check(free > 1.1 * n_bytes, f"phase 27: {free / 1e9:.1f} GB free under {root}, the checkpoint needs "
                                f"{n_bytes / 1e9:.1f} GB")
    ckpt = Path(tempfile.mkdtemp(prefix="blip2_opt_2.7b_", dir=root))
    numbers = {"checkpoint_bytes": n_bytes}
    try:
        t0 = time.perf_counter()
        files = save_blip2(model, ckpt)
        numbers["write_s"] = time.perf_counter() - t0
        shards = [f for f in files if f.name.startswith("model-")]
        check(len(shards) > 1 and (ckpt / "model.safetensors.index.json").exists(),
              f"phase 27: save_blip2 wrote {[f.name for f in files]}, not shards and an index")
        del model
        torch.cuda.empty_cache()
        out = root / "llava_flax"
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        _, wall, log, result = run_entry(run_judges, scoremax, topk,
                                         ["--output_dir", str(out), "--vlm_checkpoint", str(ckpt), *JUDGE_ARGV], {})
        peak = torch.cuda.max_memory_allocated()
        paths = {"run_judges_llava_blip2_opt_2.7b": training_counts(counters, "phase 27")}
        for name in ("args.json", "out.txt", "res.pkl", "scores.csv", "done"):
            check((out / name).exists(), f"phase 27: {name} missing")
        vlm, df = result["vlm"], result["res"]["df"]
        auroc = {split: float(result["res"]["agg_results"][split]["AUROC"]) for split in ("val", "test")}
        scores = df["pred_score"].to_numpy()
        n_pairs = len(df)
        check(n_pairs == JUDGE_N // 5 and bool(np.isfinite(scores).all()) and scores.min() >= 0 and scores.max() <= 1,
              f"phase 27: {n_pairs} scores, not {JUDGE_N // 5} in [0, 1]")
        batch_s = [b["s"] for b in vlm.batches]
        check(len(batch_s) == n_pairs // 8, f"phase 27: {len(batch_s)} generate calls for {n_pairs} pairs")
        val = get_dataset("synthetic_caption", 0, noise_level=0.4, noise_type="random", synthetic_n=JUDGE_N)[1]
        idx = np.arange(8)
        images, prompts = load_images(val, idx, stack=False), [LLAVA_QUERY % c for c in val.sentence[idx]]
        first = vlm.batches[0]
        vlm.run_batch(images, prompts)
        again = vlm.batches[-1]
        check(np.array_equal(again["tokens"], first["tokens"]), "phase 27: the first batch again gave other tokens")
        replies = {str(r) for r in first["tokens"].tolist()}
        t0 = time.perf_counter()
        pipe = VdcPipeline(llm_generate=scripted_llm, vlm_answer=vlm.backends()[1],
                           vlm_answer_batch=vlm.backends()[4], batch_size=8)
        n_calls = len(vlm.batches)
        vdc = [pipe.score_example(images[i], val.sentence[i], label=val.sentence[i]) for i in range(VDC_EXAMPLES)]
        vdc_s = time.perf_counter() - t0
        vdc_scores = [v["score"] for v in vdc]
        check(all(0 <= v <= 1 for v in vdc_scores) and len(vlm.batches) - n_calls == VDC_EXAMPLES
              and all(len(v["questions"]) == 4 for v in vdc),
              f"phase 27: VdcPipeline scores {vdc_scores}, {len(vlm.batches) - n_calls} VLM calls")
        load_s = vlm.load_s
        del vlm, result, pipe
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    # card against CPU: the first batch through a 2-layer OPT at full width
    card_model = init_captioner(dataclasses.replace(cfg, decoder_layers=2), seed=0, device=device)
    card = Blip2Judge(card_model, device, 16)
    host = Blip2Judge(copy.deepcopy(card_model).cpu(), torch.device("cpu"), 16)
    card.run_batch(images, prompts)
    t0 = time.perf_counter()
    host.run_batch(images, prompts)
    cpu_s = time.perf_counter() - t0
    a, b = card.batches[0], host.batches[0]
    logp_err = float(np.abs(a["logprobs"] - b["logprobs"]).max())
    check(np.array_equal(a["tokens"], b["tokens"]), f"phase 27: 2-layer tokens card vs CPU differ at "
                                                     f"{np.argwhere(a['tokens'] != b['tokens'])[:4].tolist()}")
    check(logp_err <= JUDGE_LOGP_TOL, f"phase 27: 2-layer log-probabilities card vs CPU {logp_err} > {JUDGE_LOGP_TOL}")
    del card, host, card_model
    torch.cuda.empty_cache()
    steady = batch_s[1:]
    numbers.update(load_s=load_s, wall_s=wall, batch_s=batch_s, first_batch_again_s=again["s"],
                   s_per_batch_steady=float(np.median(steady)), s_per_pair=sum(batch_s) / n_pairs,
                   pairs_per_s=n_pairs / sum(batch_s), max_memory_allocated=peak, shards=len(shards),
                   distinct_replies_first_batch=len(replies), vdc_s=vdc_s, vdc_scores=vdc_scores,
                   card_vs_cpu_logp=logp_err, cpu_batch_s=cpu_s, auroc=auroc)
    print(f"run_judges llava flax, BLIP-2 at opt-2.7b widths ({n_bytes / 1e9:.2f} GB fp32 in {len(shards)} shards, "
          f"written in {numbers['write_s']:.2f} s, loaded in {load_s:.2f} s): wall {wall:.2f} s; {n_pairs} pairs "
          f"in {len(batch_s)} batches of 8 x 16 new tokens, batch s {[round(x, 3) for x in batch_s]} (steady "
          f"median {numbers['s_per_batch_steady']:.3f} s), {numbers['s_per_pair']:.4f} s a pair, "
          f"{numbers['pairs_per_s']:.2f} pairs/s; max_memory_allocated {peak / 2**30:.2f} GiB; the first batch "
          f"again: identical tokens in {again['s']:.3f} s ({len(replies)} distinct replies); AUROC "
          f"{numbers['auroc']}", flush=True)
    print(f"VdcPipeline on {VDC_EXAMPLES} examples (4 questions each, the VLM at full width, a scripted LLM): "
          f"{vdc_s:.2f} s, scores {vdc_scores}; 2-layer OPT at full width, the first batch card vs CPU: tokens "
          f"equal, log-probabilities max abs diff {logp_err:.3g} (bar {JUDGE_LOGP_TOL}), CPU batch {cpu_s:.2f} s; "
          f"judge phase {time.perf_counter() - t_phase:.2f} s; kernel launches 0 (plain attention, as the JAX "
          f"judge's BLIP-2 einsums)", flush=True)
    return paths, numbers


def phase_sweep():
    """Phase 28: ``sweep launch --experiment synthetic_smoke`` through the
    port's CLI in a process of its own, its four ``run_lemon`` jobs on the
    card; ``status``; the two ``aggregate`` tables. Returns ({path: kernel
    launches summed over the jobs' processes}, numbers)."""
    import contextlib
    import io

    import numpy as np

    from lemon_tpu_torch.cli import aggregate, sweep

    t_phase = time.perf_counter()
    root = RUNS / "sweeps"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    launch = subprocess.run([sys.executable, "-m", "lemon_tpu_torch.cli.sweep", "launch", "--experiment",
                             "synthetic_smoke", "--output_root", str(root), "--command_launcher", "local", "--yes",
                             "--embedding_cache", "auto"], cwd=ROOT, env=env, capture_output=True, text=True,
                            timeout=900)
    launch_s = time.perf_counter() - t0
    (root / "launch.log").write_text(launch.stdout + launch.stderr)
    check(launch.returncode == 0 and "launched 4 jobs" in launch.stdout,
          f"phase 28: sweep launch rc {launch.returncode}: {(launch.stdout + launch.stderr)[-2000:]}")

    def captured(fn, argv):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        return buf.getvalue(), time.perf_counter() - t

    status, status_s = captured(sweep.main, ["status", "--experiment", "synthetic_smoke", "--output_root", str(root)])
    check("{'done': 4}" in status, f"phase 28: sweep status: {status}")
    exp_root = root / "synthetic_smoke"
    table, table_s = captured(aggregate.main, ["--root", str(exp_root)])
    configs = aggregate.paper_table(aggregate.collect_runs(exp_root))
    check("collected 4 completed runs" in table and len(configs) == 2,
          f"phase 28: aggregate, not 4 runs in 2 configurations (noise 0.2, 0.4): {table}")
    drop, drop_s = captured(aggregate.main, ["--root", str(exp_root), "--hparam_drop"])
    drop_rows = aggregate.hparam_drop_table(exp_root)
    check(len(drop_rows) == 4 and bool(np.isfinite(drop_rows[["AUROC", "AUPRC", "F1_prev"]].to_numpy(float)).all()),
          f"phase 28: aggregate --hparam_drop: {drop}")
    launches, job_walls = {}, []
    for job in sweep.build_jobs("synthetic_smoke", exp_root):
        log = (job.output_dir / "out.txt").read_text()
        counts = [json.loads(line.split(": ", 1)[1]) for line in log.splitlines()
                  if line.startswith("kernel launches in this process: ")]
        check(len(counts) == 1 and counts[0]["scores_blockmax"] > 0 and counts[0]["topk"] > 0,
              f"phase 28: job {job.run_id} did not report K1 and K2 launches: {counts}")
        for k, v in counts[0].items():
            launches[k] = launches.get(k, 0) + v
        timing = [ast.literal_eval(line.removeprefix("Phase timing: ")) for line in log.splitlines()
                  if line.startswith("Phase timing: ")]
        job_walls.append(round(sum(timing[0].values()), 3) if timing else None)
    numbers = {"launch_s": launch_s, "status_s": status_s, "aggregate_s": table_s, "hparam_drop_s": drop_s,
               "job_phase_sums_s": job_walls}
    print(f"sweep synthetic_smoke: launch of 4 run_lemon jobs {launch_s:.2f} s (a process each; their phase sums "
          f"{job_walls} s); status {status_s:.3f} s: {status.strip()}; aggregate {table_s:.3f} s, --hparam_drop "
          f"{drop_s:.3f} s; K1/K2 launches over the jobs {launches}; sweep phase "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    print("aggregate --root:\n" + table.rstrip() + "\naggregate --hparam_drop:\n" + drop.rstrip(), flush=True)
    return {"sweep_synthetic_smoke_jobs": launches}, numbers


def print_side_by_side(what: str, a: dict, b: dict, names=("fp32", "bf16")) -> None:
    print(f"{what} phase timing (s), {names[0]} | {names[1]}: "
          + json.dumps({k: [round(a.get(k, 0.0), 4), round(b.get(k, 0.0), 4)] for k in {**a, **b}}), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    global cuda_ms, graph_ms  # the probes' timers: the phases call them once the port is on the path
    sys.path.insert(0, str(ROOT))
    try:
        from lemon_tpu_torch.benchmarks._timing import cuda_ms, graph_ms
        from lemon_tpu_torch.knn.index import ExactKnnIndex, _blockmax_select
        from lemon_tpu_torch.ops import _build, attention, matmul, scoremax, select, topk
    except ImportError as e:
        fail(f"cannot import lemon_tpu_torch from {ROOT}: {e}")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

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

    k1_err, k1_times, k1_mm_ms, k1_parts = phase_k1(torch, scoremax, device)
    k2_err, k2_times = phase_k2(torch, topk, device)
    phase_knn(torch, scoremax, topk, ExactKnnIndex, device)
    b32, b32_timing, _ = phase_run_lemon(torch, scoremax, topk)
    embedding_cache = RUNS / "embedding_cache"
    shutil.rmtree(embedding_cache, ignore_errors=True)
    b32_bf16, b32_bf16_timing, b32_bf16_run = phase_run_lemon(torch, scoremax, topk, "bf16", embedding_cache)
    print_side_by_side("run_lemon ViT-B/32", b32_timing, b32_bf16_timing)
    k3_err, k3_times = phase_k3(torch, attention, device)
    k3b_err, k3b_times = phase_k3_bf16(torch, attention, device)
    k4_times, k4_launches = phase_k4(torch, scoremax, select, topk, _blockmax_select, device)
    b16, b16_timing, b16_embeddings = phase_vit_b16_flash(torch, scoremax, topk, attention, device)
    b16_bf16, b16_bf16_timing, _ = phase_vit_b16_flash(torch, scoremax, topk, attention, device, "bf16", b16_embeddings)
    print_side_by_side("ViT-B/16 flash detection", b16_timing, b16_bf16_timing)
    phase_int8(torch, device)
    p_times = phase_probe_kernels(torch, scoremax, select, topk, matmul, device)
    # (function, attribute) of every kernel's count; the split ones are
    # reassembled below
    counters = {"scores_blockmax": (scoremax.scores_blockmax, "launches"),
                "scores_blockmax_highest": (scoremax.scores_blockmax, "launches_highest"),
                "topk": (topk.topk, "launches"),
                "flash_attention": (attention.flash_attention, "launches"),
                "flash_attention_bf16": (attention.flash_attention, "launches_bf16"),
                "fused_gather_topk": (select.fused_gather_topk, "launches"),
                "tiled_matmul": (matmul.tiled_matmul, "launches"),
                "tiled_matmul_int8": (matmul.tiled_matmul, "launches_int8"),
                "block_maxima": (scoremax.block_maxima, "launches"),
                "scores_blockmax_t": (scoremax.scores_blockmax_t, "launches"),
                "topk_colids": (select.topk_colids, "launches")}
    probes = phase_probes(torch, counters)
    for counts in probes.values():
        split_counts(counts)
    for kernel, probe in (("tiled_matmul_int8", "probe_pallas_int8"), ("tiled_matmul_bf16", "probe_pallas_int8"),
                          ("block_maxima", "probe_knn_decomp"), ("scores_blockmax_t", "probe_scoremax2"),
                          ("topk_colids", "probe_knn_select3"), ("topk", "select_limits"),
                          ("topk_colids", "select_limits"), ("fused_gather_topk", "select_limits")):
        check(probes[probe][kernel] > 0, f"{probe}: {kernel} was not launched: {probes[probe]}")
    warm = phase_warm_repeat(torch, scoremax, topk, b32_bf16_run, b32_bf16_timing)
    stream = phase_stream(torch, scoremax, topk)
    encoders = phase_new_encoders(torch, scoremax, topk)
    baselines = phase_baselines(torch, scoremax, topk, embedding_cache, device)
    training, train_numbers = phase_training(torch, counters, device)
    mesh_launches, _ = phase_mesh_detection(torch, scoremax, topk, b32_bf16_run)
    tensor_parallel, tp_numbers = phase_tensor_parallel(torch, counters, scoremax, topk, device)
    phase_cpp_oracle(torch, embedding_cache, device)
    print("training numbers: " + json.dumps({**train_numbers, "tensor_parallel": tp_numbers}), flush=True)
    downstream, downstream_numbers = phase_downstream(torch, counters, scoremax, topk, device)
    aum_datamap, aum_datamap_numbers = phase_training_dependent(torch, counters, scoremax, topk, device)
    print("classifier numbers: " + json.dumps({**downstream_numbers, **aum_datamap_numbers}), flush=True)
    capfilt, capfilt_numbers = phase_capfilt(torch, counters, scoremax, topk, device)
    captioning, captioning_numbers = phase_captioning(torch, counters, scoremax, topk, device,
                                                      RUNS / "rn50_fp32" / "know_val_labels_scores.csv")
    blip2, blip2_numbers = phase_blip2_opt(torch, counters, device)
    print("capfilt and captioning numbers: " + json.dumps({**capfilt_numbers, **captioning_numbers,
                                                           "blip2_opt_2.7b": blip2_numbers}), flush=True)
    judges, judge_numbers = phase_judges(torch, counters, scoremax, topk, device)
    sweep_launches, sweep_numbers = phase_sweep()
    print("judge and sweep numbers: " + json.dumps({"judges": judge_numbers, "sweep": sweep_numbers}), flush=True)

    main_paths = {"run_lemon_vit_b32": b32, "run_lemon_vit_b32_bf16": b32_bf16, "detect_vit_b16_flash": b16,
                  "detect_vit_b16_flash_bf16": b16_bf16, "knn_select_fused_probe": {"fused_gather_topk": k4_launches},
                  **probes, **warm, "run_lemon_stream_62500_bf16": stream, **encoders, **baselines,
                  **{path: split_counts(counts) for path, counts in training.items()},
                  "run_lemon_vit_b32_bf16_mesh_1x1": mesh_launches, **tensor_parallel, **downstream, **aum_datamap, **capfilt,
                  **captioning, **blip2, **judges, **sweep_launches}

    def launches(name):
        paths = {path: counts.get(name, 0) for path, counts in main_paths.items()}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    k1_ms, k1_plain, k1_bound, _ = k1_times[("ip", "high")]  # the main path's mode (--knn_precision auto)
    k1h_ms, k1h_plain, k1h_bound, k1h_err = k1_times[("ip", "highest")]  # the baselines' mode
    k2_ms, k2_plain, k2_sort, k2_bound, k2_dev = k2_times[(768, 6)]  # the main path's candidates at --knn_k 5
    k3_ms, k3_plain, k3_sdpa, k3_bound = k3_times[K3_SHAPES[0]]  # the ViT-B/16 vision tower, the path's largest attention
    k3b_ms, k3b_plain, k3b_sdpa, k3b_bound = k3b_times[K3_SHAPES[0]]
    k4_ms, k4_plain, _, k4_bound, k4_dev = k4_times[51]  # the probe's k

    def numbers(err, ms, plain_ms, bnd, library_ms):
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    print(json.dumps({"kernels": [
        {"name": "scores_blockmax", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/scoremax.cu",
         "kernel": f"K1 at precision 'high': the TPU's three bf16 products on wgmma (split pass into hi/lo, then "
                   f"{K1_KERNEL.format(2)}), ip 8192x512 . 16000x512",
         "replaces": "lemon_tpu/ops/scoremax.py:119", **launches("scores_blockmax"),
         **numbers(k1_err, k1_ms, k1_plain, k1_bound, None), **k1_parts["high"]},
        {"name": "scores_blockmax_highest", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/scoremax.cu",
         "kernel": f"K1 at precision 'highest': the TPU's six bf16 products on wgmma (split pass into hi/mid/lo, "
                   f"then {K1_KERNEL.format(3)}), ip 8192x512 . 16000x512",
         "replaces": "lemon_tpu/ops/scoremax.py:119", **launches("scores_blockmax_highest"),
         **numbers(k1h_err, k1h_ms, k1h_plain, k1h_bound, k1_mm_ms),  # library: torch.matmul(q, db.T) alone
         **k1_parts["highest"]},
        {"name": "topk", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/topk.cu",
         "replaces": "lemon_tpu/ops/topk.py:80", **launches("topk"),
         **numbers(k2_err, k2_ms, k2_plain, k2_bound, k2_sort), "device_ms": k2_dev},
        {"name": "flash_attention", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/attention.cu",
         "kernel": "flash_attention_tf32_kernel<D, TAIL, SPLIT> (3xTF32; TMA into mbarrier rings, q, k and v split "
                   "in shared memory, persistent; at this shape SPLIT: a splitter warpgroup feeding two consumer "
                   "warpgroups of 64 rows)",
         "replaces": "lemon_tpu/ops/attention.py:101", **launches("flash_attention"),
         **numbers(k3_err, k3_ms, k3_plain, k3_bound, k3_sdpa)},
        {"name": "flash_attention_bf16", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/attention.cu",
         "kernel": "flash_attention_bf16_kernel<D, TAIL> (TMA ring, one self-fed warpgroup a block, persistent)",
         "replaces": "lemon_tpu/ops/attention.py:101", **launches("flash_attention_bf16"),
         **numbers(k3b_err, k3b_ms, k3b_plain, k3b_bound, k3b_sdpa)},
        {"name": "fused_gather_topk", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/select.cu",
         "replaces": "lemon_tpu/ops/select.py:138", **launches("fused_gather_topk"),
         **numbers(0.0, k4_ms, k4_plain, k4_bound, None), "device_ms": k4_dev},
        *({"name": name, "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/matmul.cu",
           "kernel": f"matmul_kernel<{mma}> (producer warpgroup, TMA ring, two m64n256 consumers, persistent)",
           "replaces": "benchmarks/probe_pallas_int8.py:53", **launches(name), **numbers(*p_times[name])}
          for name, mma in (("tiled_matmul_int8", "Int8Mma"), ("tiled_matmul_bf16", "Bf16Mma"))),
        {"name": "block_maxima", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/scoremax.cu",
         "kernel": f"K1's {K1_KERNEL.format(2)}; at 'high' without the store of s (Out::kMaxOnly), "
                   "ip 8192x512 . 131072x512",
         "replaces": "benchmarks/probe_knn_decomp.py:95", **launches("block_maxima"),
         **numbers(*p_times[("block_maxima", "high")])},  # the search's precision, as K1
        {"name": "scores_blockmax_t", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/scoremax.cu",
         "kernel": f"K1's {K1_KERNEL.format(2)}; at 'high' with the block maxima transposed (Out::kTransposed), "
                   "ip 4096x512 . 65536x512",
         "replaces": "benchmarks/probe_scoremax2.py:61", **launches("scores_blockmax_t"),
         **numbers(*p_times[("scores_blockmax_t", "high")])},
        {"name": "topk_colids", "route": "cuda", "source": "lemon_tpu_torch/ops/csrc/topk.cu",
         "replaces": "benchmarks/probe_knn_select3.py:89", "also_replaces": "benchmarks/probe_knn_select3.py:163",
         **launches("topk_colids"), **numbers(*p_times["topk_colids"])},
    ]}), flush=True)
    from lemon_tpu_torch.core.mesh import shutdown

    shutdown()  # the world of one of phases 19 and 20
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
