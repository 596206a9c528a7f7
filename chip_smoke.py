"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100 (or any CUDA card).

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) rather than being skipped:

1. the card: name, count and ``nvidia-smi`` name and power limit;
2. the build of both kernels from ``csrc/`` with nvcc (one process each,
   started together), its time and ptxas report (no stack frame and no
   spills in any kernel);
3. every kernel against its plain PyTorch version on the card: the
   evidential head at the test and serving shapes and at every dataset's
   validation shapes (HandWritten at B=400, CUB, PIE, Scene; H=256),
   against float64 too, strided and contiguous x bitwise equal
   (rtol 1e-4 / atol 1e-5),
   the probe epoch at the test shapes (ragged tail, ties at +10 and in
   |p_i - p_j|, odd D/H/C), at HandWritten's V = 7 and 6, over one epoch,
   five chained epochs and against float64, and at C = 68 (V = 4, 8) and
   C = 15 (V = 8) with ragged tails and ties (losses rtol 2e-5 / atol 2e-6;
   p, m, v rtol 5e-3 / atol 5e-5); and both kernels at the synthetic
   sweep's shapes (C = 3: the head at V = 3 and 2, B = 2000, D = 16 and 32,
   and at 5 seeds x V; the epoch at V = 3, B = 128, 62 steps with no tail,
   D = 16 and 32, fused = 0); the epoch also at the CUB cells' shapes
   (S = 5 with a tail of 80, V = 3 and 2, C = 10) and the head at phase
   21's two Scene seeds in one launch (S x V = 6 and 8, B = 897, C = 15)
   and at LUMA's C = 42 (V = 3 and 4 at B = 840 and 160, phase 22's cut
   corpus, and at B = 4200 and 800, the full corpus's test and OOD rows),
   also at five seeds' heads in one launch (S x V = 15 and 20 at the same
   four B, phase 23's vmap rule); and the head kernel's bf16 build
   (``BF16_SHAPES``: HandWritten's (7|6, 400) at D = 200 and 240 and
   (7, 256), LUMA's (3|4, 840|160) and the stacked (15|20, 840) and (20,
   4200)) against its plain version and
   against float64 of the bf16-rounded operands, at the bf16 rule of
   tests/test_torch_bf16.py (``assert_bf16_evidence_close``), from a
   float32, a bf16 and a strided x (equal bits);
4. kernel, plain and library times (CUDA events, profiler device time)
   beside the least time the card could take for the same work, the head
   kernel's device time at every main-path shape (serving buckets,
   validation, the synthetic sweep, the Scene seeds, LUMA and its five
   stacked seeds; plain and library times too at the synthetic, CUB and
   Scene shapes, at LUMA's (4, 4200) and (3, 840) and at every stacked LUMA
   shape), and the bf16 build's at ``BF16_SHAPES`` beside a bf16
   ``baddbmm`` chain and its bound at the bf16 tensor-core peak; the
   profiler window of the probe epoch must
   hold exactly its four kernels, S launches each per epoch (S = 16 on
   HandWritten, 62 on the synthetic sweep, 5 on CUB with its tail of 80),
   and nothing else but the wrapper's PyTorch operations;
5. the serving path, ``runners/serve.py`` main with ``--random-init`` on
   HandWritten at full width for dmvae_cml, dmvae_dis and cml_fusion at
   buckets 1, 8, 64, 256, with the kernels' launch counts read around it;
   then the same models on the card against the plain path on the CPU, and
   one dmvae_cml request under the profiler (device busy share, kernels);
6. the micro-batching daemon under concurrent clients, every answer held
   against a direct engine call;
7. the HTTP front on 127.0.0.1, each answer held against a direct call;
8. the training path, ``runners/run.py`` main on HandWritten Normal, seed 0,
   ``--probe-engine megakernel``: all six models with each fused accuracy at
   least 0.95, the probe-epoch kernel launched once per epoch of the three
   probe fits and the head kernel at least once per epoch of every fit;
9. one probe fit of 3 epochs at full width through the epoch kernel and
   through the step loop from one generator state: the same losses (rtol
   2e-5 / atol 2e-6), val_acc equal, parameters at rtol 5e-3 / atol 5e-5;
10. the head kernel under ``torch.func.vmap``: five seeds of the
    HandWritten heads in one launch at 5 x V heads, equal to the five
    per-seed launches (rtol 1e-4 / atol 1e-5); the stacked shapes are also
    checked against the plain version and float64 in phase 3 and timed in
    phase 4;
11. the seed-batched path, ``runners/run.py --vmap-seeds`` on HandWritten
    Normal, seeds 0-4, at half depth (50 DMVAE and 100 head epochs, so the
    later phases fit the script's time): every fused accuracy of every seed
    at least 0.95, the head kernel launched once per validation epoch and once
    per evaluation of each seed-batched fit, all at the stacked shapes;
    each fit's wall time, and the cell's wall time per seed beside the
    sequential seed-0 cell of phase 8;
12. ``--vmap-seeds`` and ``--one-program-cells`` (seeds 0 1, ``--quick``)
    give equal rows (rtol 1e-6), and ``train_many`` equals ``train`` seed by
    seed over a short fit (losses rtol 2e-5 / atol 2e-6, parameters rtol
    5e-3 / atol 5e-5: batched and single cuBLAS products may sum in another
    order, and Adam's division by sqrt(v) + eps grows that on entries whose
    gradient is near zero);
13. restore: seed 0's ``dmvae_cml`` and ``cml_fusion`` served from phase
    11's checkpoints through ``runners/serve.py``'s default paths, equal to
    the in-memory models' answers, and ``runners/evaluate.py`` reporting
    phase 11's fused accuracy of seed 0's ``dmvae_cml``;
14. the synthetic path, ``runners/run_synthetic.py`` main, seed 0, dep 50,
    med preset, ``--probe-engine megakernel``, DMVAE backbone, at full width
    and depth (8000 train and 2000 validation rows, views 32/32, hidden 512,
    embed 16, 100/50/50 epochs): dmvae_cml, cml and avg each at fused
    accuracy >= 0.70 (the med preset's documented band is 70-90 %), the
    epoch kernel launched once per probe epoch (50), the head kernel once
    per validation epoch and evaluation at (3, 2000, 16) and (2, 2000, 32)
    (the cuts of phases 11 and 15 keep the script well inside its time:
    ``SEED_BATCHED_CUT``, ``DSSL_CUT``);
    each fit's wall time and ms/epoch;
15. the same cell with ``--backbone dssl`` in its own artifact root (the
    probes' checkpoint names are the same), the DSSL backbone at a quarter
    of its depth (25 epochs) and late fusion, a repeat of phase 14's on the
    same views, at 10 epochs: the same checks,
    the head at (3, 2000, 32), and the DSSL fit's ms/epoch and vMF sampler
    host syncs per epoch;
16. ``run_synthetic.py --vmap-seeds --seeds 0 1 2 3 4 --deps 50 --quick``:
    the head kernel once per validation and evaluation at S x V heads; then
    each seed's ``train_many`` fit against its ``train`` fit on the card
    from the same generators: the probe and cml late fusion at phase 12's
    tolerances; the DMVAE backbone's losses at those and its embeddings
    within 5 % in norm (batched and single cuBLAS products round apart, and
    Adam turns that into steps of up to ~lr on entries whose gradient is
    near zero, so its parameters are reported, not held to the probes'
    tolerance);
17. ``runners/evaluate.py --dataset synthetic --model dmvae_cml --seed 0
    --dep 50`` on phase 14's checkpoints gives phase 14's fused accuracy;
18. the fusion library on the card against float64 on the CPU: every
    registry fusion, and IntermediateFusion over it, at CUB's widths (1024,
    300), B = 100, and mi3 at Scene's (20, 59, 40): the forward, and the
    gradients with respect to the inputs and every parameter under one
    random cotangent, each within 1e-4 (forward) or 1e-3 (gradients) of the
    reference's largest magnitude (PERF.md section 2); mi3's forward under
    ``no_grad`` at B = 100 allocates under 16 MB above what was allocated
    before it (the per-sample weight tensor would take 60 MB);
19. the intermediate-fusion path, ``runners/run.py --datasets CUB
    --conditions Normal --seeds 0 --probe-engine megakernel
    --include-intermediate --intermediate-fusion concat_linear mi_matrix
    mi_vector tensor lrtf lft mi3 --rows-file ...`` at full width and depth:
    13 fitted rows and mi3's skip row; the six base models at fused accuracy
    >= 0.85, intermediate concat, concat_linear, mi_vector and lrtf at >=
    0.80, mi_matrix, tensor and lft with finite metrics and their accuracy
    printed (beside the JAX package's 0.1250 for the first two); the epoch
    kernel launched once per probe epoch (600), the head kernel once per
    validation epoch and evaluation of the six stacked-head fits; each fit's
    wall time and ms/epoch. The same command again resumes from the rows
    file: it announces 1 completed cell, trains nothing, launches no kernel
    and returns the same rows;
20. the same cell with ``--no-fused-dmvae`` (the six base models): each at
    fused accuracy >= 0.85, the same launch counts, and the unfused DMVAE
    fit's ms/epoch beside phase 19's fused one;
21. ``runners/run.py --vmap-seeds --seeds 0 1 --datasets Scene --conditions
    Normal --quick --intermediate-fusion mi3 tensor lrtf --profile``: both
    seeds' nine rows with finite metrics, the head kernel once per
    validation epoch and evaluation of the six stacked-head fits, and a
    trace file that names the head kernel;
22. LUMA: ``make_fake_luma`` writes a corpus of 42 + 8 OOD classes with
    100 train and 20 test rows each (seed 0; the real corpus's classes and
    widths, cut in rows), and ``runners/run_luma.py --seeds 0 --ood-eval
    --include-intermediate --rows-file ...`` runs on it at the config's
    full width and depth (3 DMVAE and 2 head epochs, batch 64): seven
    fitted rows with finite metrics, dbf, cml and avg late fusion at fused
    accuracy >= 0.07 (three times chance), an OOD AUROC row per model in
    [0, 1], the head kernel launched exactly 30 times (per stacked-head fit
    once per validation epoch, once for its evaluation, once for the ID
    and once for the OOD evidences: 16 at (3, 840), 8 at (4, 840), 4 at
    (3, 160), 2 at (4, 160), D = 200, H = 128, C = 42) and the epoch kernel
    never; each fit's wall and ms/epoch and the featurization time; the
    same command again resumes, trains nothing and launches nothing;
    ``runners/evaluate.py --dataset LUMA`` gives the run's fused accuracy
    for dmvae_cml and cml_fusion from the checkpoints (the BatchNorm
    statistics restored); and one cml_fusion epoch on 640 rows held step
    by step on the card against the CPU, each step from the CPU's state
    with its draws: loss, validation, gradients and running statistics
    (``phase_luma_card_vs_cpu``, ``check_luma_step``);
23. seed-batched LUMA on phase 22's corpus and feature cache:
    ``runners/run_luma.py --vmap-seeds --seeds 0 1 2 3 4 --ood-eval
    --include-intermediate --segment-epochs 2 --rows-file ...`` at the
    config's full width and depth: seven finite rows per seed, dbf, cml and
    avg late fusion at fused accuracy >= 0.07 for every seed, the head
    kernel launched exactly 102 times (per stacked-head fit once per
    validation epoch at 5 x V heads: 8 at (15, 840), 4 at (20, 840); then
    per seed once for its evaluation, once for the ID and once for the OOD
    evidences: 40 at (3, 840), 20 at (4, 840), 20 at (3, 160), 10 at (4,
    160)) and the epoch kernel never; each fit's wall and ms/epoch beside
    phase 22's one-seed fits; the same command again skips the block,
    trains nothing and launches nothing; ``runners/evaluate.py`` gives seeds
    0 and 4 their rows' fused accuracy for dmvae_cml and cml_fusion; and one
    seed-batched cml_fusion epoch on 640 rows (five seeds) held step by
    step against each seed's ``train`` on the card, at phase 22's step
    tolerances (``phase_luma_many_vs_train``);
24. LUMA in bf16 on phase 22's corpus and cache, at full width and depth:
    ``runners/run_luma.py --dtype bfloat16 --ood-eval
    --include-intermediate`` on seed 0, then with ``--vmap-seeds --seeds 0
    1 2 3 4 --segment-epochs 2``: every row finite, late fusion >= 0.07 for
    every seed, the head kernel's bf16 build launched at exactly phase 22's
    and 23's shapes and counts (30 and 102), its f32 build and the epoch
    kernel never; ``runners/evaluate.py`` (which restores and runs in
    float32, as in the JAX package) on seed 0's bf16 checkpoints within
    0.01 of the run's fused accuracy for dmvae_cml and cml_fusion
    (``LUMA_BF16_EVAL_GAP``); and one
    bf16 cml_fusion epoch step by step on the card against the CPU at phase
    22's step limits (``phase_luma_bf16``);
25. HandWritten Normal seed 0 in bf16 (``runners/run.py --dtype bfloat16
    --probe-engine megakernel``) at half depth (``BF16_HANDWRITTEN_CUT``):
    each fused accuracy >= 0.93 and within 0.05 of phase 8's, the epoch
    kernel never (a bf16 probe trains through the step loop), the bf16 head
    kernel 6 x (head epochs + 1) times, its f32 build never;
26. export, run right after phase 13 on its checkpoints:
    ``runners/serve.py --export-dir`` for dmvae_cml and cml_fusion at
    buckets 1, 8, 64 and 256 writes one ``.pt2`` per bucket under the JAX
    package's names, each graph with exactly one ``dmf.evidential_heads``
    call; one fresh subprocess per model (the two run at once), with only
    torch, the exported ``dmf_head_op.py`` and ``evidential_head.so``,
    replays the four
    artifacts under the profiler: outputs equal to the direct call on the
    card (rtol 1e-5 / atol 1e-6, ``pred`` equal), the head kernel once per
    call, no module of the package loaded (``phase_export``).

Each phase logs its time.

The serving and training phases also count the head kernel's calls by
shape. ``python3 chip_smoke.py --head-times`` only builds the head kernel
of the package first on the path and prints its times at the main-path
shapes as one JSON line: copied into an unpacked checkout of another
commit, it times that commit's kernel in the same call. ``python3
chip_smoke.py --engine-times`` only times ``--vmap-seeds`` against
``--one-program-cells`` on two full-depth HandWritten cells (about 35
minutes) and checks that their reports agree. ``python3 chip_smoke.py
--luma-state-trials N`` only repeats phase 22's, 23's and 24's state
comparisons N times from other weights and draws and prints their
readings (``luma_state_trials``).

It prints a JSON line ``{"kernels": [...]}`` (the head kernel, its bf16
build and the probe epoch) and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

SERVED_MODELS = ("dmvae_cml", "dmvae_dis", "cml_fusion")
BUCKETS = (1, 8, 64, 256)
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, bf16
# dense on the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
RTOL, ATOL = 1e-4, 1e-5
SEEDS = (0, 1, 2, 3, 4)


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def head_inputs(v, b, d, h, c, seed):
    """Inputs at the init scale of the heads (xavier-sized weights), so the
    logits stay mostly inside the evidence clip."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(v, b, d, generator=g)
    w1 = torch.randn(v, d, h, generator=g) * (2.0 / (d + h)) ** 0.5
    b1 = torch.randn(v, h, generator=g) * 0.05
    w2 = torch.randn(v, h, c, generator=g) * (2.0 / (h + c)) ** 0.5
    b2 = torch.randn(v, c, generator=g) * 0.05
    return [t.cuda() for t in (x, w1, b1, w2, b2)]


def head_bound(v, b, d, h, c):
    """(ms, 'operations' | 'bytes'): the larger of the f32 FMA work over the
    f32 peak and the bytes (each input read once, the output written once)
    over the memory rate."""
    flops = 2.0 * v * b * (d * h + h * c)
    nbytes = 4.0 * (v * b * d + v * d * h + v * h + v * h * c + v * c + b * v * c)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def event_ms(fn, args, iters=200, warmup=20):
    """Device time per call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def assert_close(got, ref, label, rtol=RTOL, atol=ATOL):
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{label}: {int(bad.sum())} elements beyond rtol {rtol} / atol {atol}, "
            f"max abs err {float(err.max()):.3e}"
        )
    rel = (err / ref.abs().clamp_min(1e-30)).max()
    return float(err.max()), float(rel)


def assert_outputs_match(got, ref, label):
    """Served outputs against the reference. ``pred`` must be equal except
    where the reference's top classes tie within the tolerance."""
    for k in ("evidence", "fused_evidence", "probs"):
        assert_close(torch.as_tensor(got[k]), torch.as_tensor(ref[k]), f"{label} {k}")
    for k in ("epistemic", "aleatoric"):
        assert_close(torch.as_tensor(got[k]), torch.as_tensor(ref[k]), f"{label} {k}",
                     atol=1e-6)
    gp, rp = torch.as_tensor(got["pred"]), torch.as_tensor(ref["pred"])
    fused = torch.as_tensor(ref["fused_evidence"])
    for row in torch.nonzero(gp != rp).flatten().tolist():
        a, b = fused[row, gp[row]], fused[row, rp[row]]
        if abs(float(a - b)) > ATOL + RTOL * abs(float(b)):
            raise AssertionError(f"{label}: pred differs at row {row} without a tie")


# (V, B, D, H, C) of the head kernel on the main path: the serving buckets
# of dmvae_cml (V=7), dmvae_dis (V=6) and cml_fusion (V=6, D=240), then the
# validation and evaluation forwards on each dataset's test split (B=400 on
# HandWritten carries most launches): late fusion at the widest view and
# the probes at the embedding width 200
SERVING_SHAPES = [(v, b, d, 128, 10) for v, d in ((7, 200), (6, 200), (6, 240)) for b in BUCKETS]
VALIDATION_SHAPES = [
    (7, 400, 200, 128, 10), (6, 400, 200, 128, 10), (6, 400, 240, 128, 10),  # HandWritten
    (2, 120, 1024, 128, 10), (3, 120, 200, 128, 10),  # CUB late fusion, probe
    (2, 120, 200, 128, 10),  # CUB dmvae_dis
    (3, 136, 484, 128, 68), (4, 136, 200, 128, 68),  # PIE
    (3, 897, 59, 128, 15), (4, 897, 200, 128, 15),  # Scene
]
# the seed-batched fits' validation and evaluation: five seeds of the
# HandWritten heads in one launch
STACKED_SHAPES = [(len(SEEDS) * v, b, d, h, c) for v, b, d, h, c in VALIDATION_SHAPES[:3]]
# the synthetic sweep (runners/run_synthetic.py, 2000 validation rows, C=3):
# dmvae_cml over DMVAE (D=16) and over DSSL (D=32), late fusion on the two
# 32-wide views; then --vmap-seeds over five seeds at full size and at the
# --quick size the seed-batched synthetic phase runs (200 validation rows)
SYNTHETIC_SHAPES = [(3, 2000, 16, 128, 3), (3, 2000, 32, 128, 3), (2, 2000, 32, 128, 3)]
SYNTHETIC_STACKED_SHAPES = [(len(SEEDS) * v, 2000, d, 128, 3) for v, d in ((3, 16), (2, 32))]
SYNTHETIC_QUICK_SHAPES = [(len(SEEDS) * v, 200, d, 128, 3) for v, d in ((3, 16), (2, 32))]
# the CUB cells of phases 19-20 (dmvae_dis, the shared + private probes,
# late fusion at the widest view), and phase 21's two Scene seeds in one
# launch (S x V = 6 and 8 heads, late fusion at Scene's widest view, 59)
CUB_SHAPES = [(2, 120, 200, 128, 10), (3, 120, 200, 128, 10), (2, 120, 1024, 128, 10)]
SCENE_STACKED_SHAPES = [(2 * v, 897, d, 128, 15) for v, d in ((3, 200), (4, 200), (3, 59))]
# LUMA at C = 42 (phase 22): the stacked-head fits' validation, evaluation and
# OOD evidences, V = 3 (dmvae_dis, the late fusions on the encoders' 200-wide
# outputs) and V = 4 (the shared + private probes), on phase 22's cut corpus
# (840 test and 160 OOD rows) and on the full corpus (4200 and 800)
LUMA_SHAPES = [(v, b, 200, 128, 42) for b in (840, 160) for v in (3, 4)]
LUMA_FULL_SHAPES = [(v, b, 200, 128, 42) for b in (4200, 800) for v in (3, 4)]
# seed-batched LUMA (phase 23): the validation of five seeds' stacked heads in
# one launch, S x V = 15 and 20 heads, on the cut and the full corpus's test
# rows (and the OOD rows' sizes, which a seed-batched evaluation would take)
LUMA_STACKED_SHAPES = [(len(SEEDS) * v, b, 200, 128, 42) for b in (840, 160, 4200, 800)
                       for v in (3, 4)]
MAIN_PATH_SHAPES = (SERVING_SHAPES + VALIDATION_SHAPES + STACKED_SHAPES + SYNTHETIC_SHAPES
                    + SYNTHETIC_STACKED_SHAPES + SCENE_STACKED_SHAPES + LUMA_SHAPES
                    + LUMA_FULL_SHAPES + LUMA_STACKED_SHAPES)
# times at these besides the device time: plain and library
TIMED_SHAPES = (SYNTHETIC_SHAPES + SYNTHETIC_STACKED_SHAPES + CUB_SHAPES + SCENE_STACKED_SHAPES
                + [(4, 4200, 200, 128, 42), (3, 840, 200, 128, 42)] + LUMA_STACKED_SHAPES)
# (S, V, B, D, H, C) of the probe epoch: dmvae_cml on HandWritten (16 steps
# of 100 rows), then on the synthetic sweep (62 steps of 128 rows, the tail
# dropped; D=16 over DMVAE, 32 over DSSL)
EPOCH_SHAPES = [(16, 7, 100, 200, 128, 10), (62, 3, 128, 16, 128, 3), (62, 3, 128, 32, 128, 3)]
# (S, V, B, D, H, C, tail) of the CUB cells' probe epochs (phases 19-20):
# 480 rows in four steps of 100 and a tail of 80, V = 3 (dmvae_cml,
# dmvae_joint) and 2 (dmvae_dis), C = 10
CUB_EPOCH_SHAPES = [(5, 3, 100, 200, 128, 10, 80), (5, 2, 100, 200, 128, 10, 80)]


def shape_key(v, b, d, h, c):
    return f"V={v},B={b},D={d},H={h},C={c}"


def phase_kernel_checks(ck):
    """Kernel against plain version; returns the largest abs error at the
    serving shapes."""
    shapes = [(1, 100, 200, 128, 10), (1, 13, 47, 33, 68), (3, 32, 16, 24, 5), (1, 600, 40, 32, 10)]
    shapes += [(v, b, d, 128, 10) for v, d in ((7, 200), (6, 200), (6, 240))
               for b in (1, 8, 64, 256, 1000)]
    # the validation shapes, a wider head (two H tiles per block of a cluster)
    shapes += VALIDATION_SHAPES + STACKED_SHAPES + [(7, 256, 200, 256, 10), (3, 97, 59, 256, 15)]
    shapes += SYNTHETIC_SHAPES + SYNTHETIC_STACKED_SHAPES + SYNTHETIC_QUICK_SHAPES
    shapes += SCENE_STACKED_SHAPES + LUMA_SHAPES + LUMA_FULL_SHAPES + LUMA_STACKED_SHAPES
    worst = 0.0
    for i, (v, b, d, h, c) in enumerate(shapes):
        args = head_inputs(v, b, d, h, c, seed=i)
        out = ck.evidential_heads_stacked(*args)
        # the probe's (B, V, D) stack, handed over as a strided (V, B, D) view
        strided = args[0].transpose(0, 1).contiguous().transpose(0, 1)
        out_strided = ck.evidential_heads_stacked(strided, *args[1:])
        torch.cuda.synchronize()
        ref = ck.evidential_heads_stacked_plain(*args)
        abs_err, rel_err = assert_close(out, ref, f"evidential_head {(v, b, d, h, c)}")
        # cuBLAS may sum in the kernel's order, so also hold both to float64
        ref64 = ck.evidential_heads_stacked_plain(*(t.double() for t in args))
        abs64, _ = assert_close(out.double(), ref64, f"evidential_head {(v, b, d, h, c)} f64")
        if not torch.equal(out, out_strided):
            raise AssertionError(f"strided input changed the result at {(v, b, d, h, c)}")
        if (v, h, c) in ((7, 128, 10), (6, 128, 10)):
            worst = max(worst, abs_err)
        log(f"check evidential_head V={v} B={b} D={d} H={h} C={c}: "
            f"max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
            f"(vs float64: max abs err {abs64:.3e})")
    return worst


def library_heads(x, w1, b1, w2, b2):
    """The heads through PyTorch's library calls: baddbmm -> relu -> baddbmm
    -> evidence."""
    from disentagled_multimodal_fusion_tpu_torch.ops.evidence import evidence_activation

    h = torch.relu(torch.baddbmm(b1[:, None, :], x, w1))
    return evidence_activation(torch.baddbmm(b2[:, None, :], h, w2)).transpose(0, 1)


def phase_kernel_times(ck, card):
    """Times at the serving shapes; returns the row of the probe at B=256."""
    main_row = None
    for v, d in ((7, 200), (6, 200), (6, 240)):
        for b in BUCKETS:
            args = head_inputs(v, b, d, 128, 10, seed=b)
            ms = event_ms(ck.evidential_heads_stacked, args)
            plain_ms = event_ms(ck.evidential_heads_stacked_plain, args)
            library_ms = event_ms(library_heads, args)
            bound_ms, bound_by = head_bound(v, b, d, 128, 10)
            log(f"time evidential_head V={v} B={b} D={d} H=128 C=10: kernel {ms:.5f} ms, "
                f"plain {plain_ms:.5f} ms, library {library_ms:.5f} ms, bound {bound_ms:.6f} ms "
                f"({bound_by}) [{card}]")
            if (v, b, d) == (7, 256, 200):
                main_row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bound_ms, bound_by=bound_by)
    return main_row


@contextlib.contextmanager
def head_shape_tally():
    """Counts the head kernel's launches by (V, B, D, H, C) while the main
    path runs, at the operator's launch function (``ops/head_op.py``; so a
    vmapped call counts at the S x V heads it launches), the bf16 build's
    under keys ending in ",bf16"; the launch counts themselves stay the
    wrappers'."""
    from disentagled_multimodal_fusion_tpu_torch.ops import head_op

    real = head_op.launch
    tally = collections.Counter()

    def counted(x, w1, b1, w2, b2, bf16):
        key = shape_key(*x.shape, w1.shape[-1], w2.shape[-1]) + (",bf16" if bf16 else "")
        tally[key] += 1
        return real(x, w1, b1, w2, b2, bf16)

    head_op.launch = counted
    try:
        yield tally
    finally:
        head_op.launch = real


def head_device_ms(ck, shape, n=100, fn=None, kernel="evidential_heads_kernel"):
    """Device-only time of the head kernel (``fn``, by default the f32
    wrapper) at one shape from the profiler, or None when the profiler
    reports no device time for ``kernel``."""
    from torch.profiler import ProfilerActivity, profile

    fn = fn or ck.evidential_heads_stacked
    args = head_inputs(*shape, seed=0)
    for _ in range(10):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us = getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
            if total_us > 0 and ev.count:
                return total_us / ev.count / 1e3
    return None


# the bf16 build's shapes (phases 3 and 4): HandWritten's probe heads, LUMA's
# (3|4, 840|160) of phases 22 and 24, and the stacked (15|20, 840) and
# (20, 4200) of the seed-batched engine (the last a full corpus's)
BF16_SHAPES = (VALIDATION_SHAPES[:3] + [(7, 256, 200, 128, 10)] + LUMA_SHAPES
               + [(15, 840, 200, 128, 42), (20, 840, 200, 128, 42), (20, 4200, 200, 128, 42)])
# the most launched bf16 shape of the run (phase 25's late fusion at the
# widest view, 303 launches); main() holds the run's tally to it
BF16_MAIN = (6, 400, 240, 128, 10)


def bf16_reference64(x, w1, b1, w2, b2):
    """The bf16 mode in float64: the operands rounded to bf16, each
    product summed exactly and rounded to bf16, the bias added and rounded
    where the kernel rounds, the evidence in float64."""
    from disentagled_multimodal_fusion_tpu_torch.ops.evidence import evidence_activation

    def r(t):
        return t.to(torch.bfloat16).double()

    h = torch.relu(r(r(torch.einsum("vbd,vdh->vbh", r(x), r(w1))) + r(b1)[:, None, :]))
    z = r(r(torch.einsum("vbh,vhc->vbc", h, r(w2))) + r(b2)[:, None, :])
    return evidence_activation(z).transpose(0, 1)


def assert_bf16_evidence_close(got, ref, label):
    """bf16 evidence through its log, the logit it came from: within 2 bf16
    ulps (2^-7 |ref| + 1e-3) but for at most 1 in 1000 entries, none beyond
    4 ulps of its own size or of the tensor's rms (tests/test_torch_bf16.py
    sets the rule from the CPU's readings). Returns (entries beyond 2
    ulps, the largest gap over the outlier bound, the max abs error of the
    evidence)."""
    g, r = got.double().log(), ref.double().log()
    err = (g - r).abs()
    beyond = int((err > 2.0 ** -7 * r.abs() + 1e-3).sum())
    worst = 2.0 ** -6 * (r.abs() + r.pow(2).mean().sqrt())
    ratio = float((err / worst).max())
    if not bool(torch.isfinite(got).all()) or beyond > got.numel() // 1000 or ratio > 1.0:
        raise AssertionError(f"{label}: {beyond} of {got.numel()} entries beyond 2 bf16 ulps, "
                             f"largest gap {ratio:.3f} of the 4-ulp bound")
    return beyond, ratio, float((got.double() - ref.double()).abs().max())


def library_heads_bf16(x, w1, b1, w2, b2):
    """The bf16 heads through PyTorch's library calls: baddbmm -> relu ->
    baddbmm in bf16 -> evidence in float32."""
    from disentagled_multimodal_fusion_tpu_torch.ops.evidence import evidence_activation

    bf = torch.bfloat16
    h = torch.relu(torch.baddbmm(b1.to(bf)[:, None, :], x.to(bf), w1.to(bf)))
    z = torch.baddbmm(b2.to(bf)[:, None, :], h, w2.to(bf))
    return evidence_activation(z.float()).transpose(0, 1)


def bf16_bound(x, w1, b1, w2, b2):
    """(ms, 'operations' | 'bytes') of the bf16 heads: the products at the
    bf16 tensor-core peak, against the bytes of these inputs (x in its own
    type, the float32 parameters) and the float32 output."""
    v, b, d = x.shape
    h, c = w1.shape[-1], w2.shape[-1]
    flops = 2.0 * v * b * (d * h + h * c)
    nbytes = (x.element_size() * x.numel()
              + 4.0 * (w1.numel() + b1.numel() + w2.numel() + b2.numel() + b * v * c))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_bf16_kernel_checks(ck):
    """The head kernel's bf16 build against its plain version on the card
    and against float64 of the bf16-rounded operands, at ``BF16_SHAPES``,
    from a float32 x (as the main path gives it), from a bf16 x (equal
    bits) and from a strided x (equal bits); the f32 build refuses a bf16
    x. Returns the largest max abs error against the plain version."""
    worst = 0.0
    for i, shape in enumerate(BF16_SHAPES):
        args = head_inputs(*shape, seed=500 + i)
        before = ck.evidential_heads_stacked_bf16.launches
        out = ck.evidential_heads_stacked_bf16(*args)
        out_bf16_x = ck.evidential_heads_stacked_bf16(args[0].to(torch.bfloat16), *args[1:])
        strided = args[0].transpose(0, 1).contiguous().transpose(0, 1)
        out_strided = ck.evidential_heads_stacked_bf16(strided, *args[1:])
        torch.cuda.synchronize()
        if ck.evidential_heads_stacked_bf16.launches != before + 3:
            raise AssertionError(f"evidential_head bf16 {shape}: not one launch per call")
        if not (torch.equal(out, out_bf16_x) and torch.equal(out, out_strided)):
            raise AssertionError(f"evidential_head bf16 {shape}: a bf16 or strided x changed "
                                 f"the result")
        plain = ck.evidential_heads_stacked_bf16_plain(*args)
        beyond, ratio, abs_err = assert_bf16_evidence_close(out, plain, f"bf16 {shape}")
        beyond64, ratio64, abs64 = assert_bf16_evidence_close(
            out, bf16_reference64(*args), f"bf16 {shape} f64")
        worst = max(worst, abs_err)
        log(f"check evidential_head bf16 {shape_key(*shape)}: against the plain version "
            f"{beyond} entries beyond 2 ulps, largest gap {ratio:.3f} of the 4-ulp bound, max "
            f"abs err {abs_err:.3e}; against float64 {beyond64}, {ratio64:.3f}, {abs64:.3e}")
    args = head_inputs(*BF16_SHAPES[0], seed=0)
    try:
        ck.evidential_heads_stacked(args[0].to(torch.bfloat16), *args[1:])
    except TypeError:
        pass
    else:
        raise AssertionError("the f32 evidential_head kernel took a bf16 x")
    return worst


def phase_bf16_kernel_times(ck, card):
    """The bf16 build at ``BF16_SHAPES``: profiler device time, CUDA events
    per call, the plain version's and the bf16 ``baddbmm`` chain's events,
    and the bound. Returns the row at ``BF16_MAIN`` and {shape key: times}."""
    timed, main_row = {}, None
    for shape in BF16_SHAPES:
        args = head_inputs(*shape, seed=1)
        device_ms = head_device_ms(ck, shape, fn=ck.evidential_heads_stacked_bf16,
                                   kernel="evidential_heads_bf16_kernel")
        ms = event_ms(ck.evidential_heads_stacked_bf16, args)
        plain_ms = event_ms(ck.evidential_heads_stacked_bf16_plain, args)
        library_ms = event_ms(library_heads_bf16, args)
        bound_ms, bound_by = bf16_bound(*args)
        row = dict(device_ms=device_ms, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        timed[shape_key(*shape)] = row
        if shape == BF16_MAIN:
            main_row = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")}
        log(f"time evidential_head bf16 {shape_key(*shape)}: device "
            + (f"{device_ms:.5f} ms" if device_ms is not None else "not measured")
            + f", events {ms:.5f} ms, plain {plain_ms:.5f} ms, library (bf16 baddbmm) "
              f"{library_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
    return main_row, timed


def phase_device_time(ck, card):
    """The head kernel at every main-path shape: profiler device time, CUDA
    events per call (the wrapper's host work included, so events minus
    device time is the wrapper's cost when the host is the limit) and the
    bound; at ``TIMED_SHAPES`` also the plain and library times. Returns
    {shape key: device ms} and {timed shape key: times}."""
    device, timed = {}, {}
    for shape in MAIN_PATH_SHAPES:
        ms = head_device_ms(ck, shape)
        args = head_inputs(*shape, seed=1)
        events = event_ms(ck.evidential_heads_stacked, args)
        bound_ms, bound_by = head_bound(*shape)
        device[shape_key(*shape)] = ms
        extra = ""
        if shape in TIMED_SHAPES:
            plain_ms = event_ms(ck.evidential_heads_stacked_plain, args)
            library_ms = event_ms(library_heads, args)
            timed[shape_key(*shape)] = dict(device_ms=ms, ms=events, plain_ms=plain_ms,
                                            library_ms=library_ms, bound_ms=bound_ms,
                                            bound_by=bound_by)
            extra = f", plain {plain_ms:.5f} ms, library {library_ms:.5f} ms"
        log(f"device time evidential_head {shape_key(*shape)}: "
            + (f"{ms:.5f} ms" if ms is not None else "not measured")
            + f", events {events:.5f} ms per call{extra}, bound {bound_ms:.6f} ms ({bound_by}) "
              f"[{card}]")
    return device, timed


def epoch_inputs(s, v, b, d, h, c, seed, keep=0.9, tail=None, ties=False, fused=1.0):
    """Inputs of one probe epoch at the heads' init scale, on the card. The
    last step keeps ``tail`` rows (the ragged tail, row-masked). With
    ``ties``, views 0 and 1 get w2[:, 0] = 0 and b2[0] = +10, so class 0's
    logit sits exactly at +10 (the clip's tie) in the first step, and row 0
    of those views has x = 0 and b1 < 0, so its logits are b2 exactly and
    the two views' alphas are equal (the tie of |p_0 - p_1|). Every row is
    then labelled 0: a saturated wrong class (alpha ~ 2.2e4) would make the
    KL's lgamma terms cancel from ~2e5 in float32, where any two summation
    orders differ by ~1e-3."""
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(s, v, b, d, generator=g)
    drops = (torch.rand(s, v, b, h, generator=g) < keep).float()
    y = torch.randint(0, c, (s, b), generator=g)
    if ties:
        y.zero_()
    yohs = torch.nn.functional.one_hot(y, c).float()
    rmasks = torch.ones(s, b, 1)
    if tail is not None:
        rmasks[-1, tail:] = 0.0
        xs[-1, :, tail:] = 0.0
        yohs[-1, tail:] = 0.0
    counts = torch.arange(1, s + 1, dtype=torch.float32)
    bc1s = (1.0 - torch.pow(torch.tensor(0.9), counts))[:, None]
    bc2s = (1.0 - torch.pow(torch.tensor(0.999), counts))[:, None]
    w1 = (torch.rand(v, d, h, generator=g) * 2 - 1) * (6.0 / (d + h)) ** 0.5
    b1 = (torch.rand(v, h, generator=g) * 2 - 1) / d ** 0.5
    w2 = (torch.rand(v, h, c, generator=g) * 2 - 1) * (6.0 / (h + c)) ** 0.5
    b2 = (torch.rand(v, c, generator=g) * 2 - 1) / h ** 0.5
    if ties:
        xs[0, :2, 0] = 0.0
        b1[:2] = -b1[:2].abs() - 0.01
        b2[1] = b2[0]
        w2[:2, :, 0] = 0.0
        b2[:2, 0] = 10.0
    params = (w1, b1, w2, b2)
    mus = tuple(torch.randn(p.shape, generator=g) * 1e-3 for p in params)
    nus = tuple(torch.rand(p.shape, generator=g) * 1e-6 for p in params)
    cuda = lambda t: t.to("cuda")  # noqa: E731
    return dict(
        tensors=[cuda(t) for t in (xs, drops, yohs, rmasks, bc1s, bc2s)],
        scalars=(3e-3, 0.4, 0.68),
        state=[tuple(cuda(t) for t in group) for group in (params, mus, nus)],
        kw=dict(keep=keep, fused=fused, num_classes=c, weight_decay=1e-2),
    )


def run_epoch(fn, inp, state=None):
    params, mus, nus = state or inp["state"]
    clone = lambda ts: tuple(t.clone() for t in ts)  # noqa: E731
    return fn(*inp["tensors"], *inp["scalars"], clone(params), clone(mus), clone(nus), **inp["kw"])


def assert_epoch_close(got, ref, label):
    """Losses at rtol 2e-5 / atol 2e-6; p, m, v at rtol 5e-3 / atol 5e-5 (the
    JAX package's tolerances: Adam divides by sqrt(v) + eps, so op-level
    differences grow on entries whose gradient is near zero)."""
    abs_err, _ = assert_close(got[3], ref[3], f"{label} losses", rtol=2e-5, atol=2e-6)
    for group, name in zip(range(3), ("params", "m", "v")):
        for i, (a, b) in enumerate(zip(got[group], ref[group])):
            e, _ = assert_close(a, b, f"{label} {name}[{i}]", rtol=5e-3, atol=5e-5)
            abs_err = max(abs_err, e)
    return abs_err


def to_double(inp):
    return dict(inp, tensors=[t.double() for t in inp["tensors"]],
                state=[tuple(t.double() for t in g) for g in inp["state"]])


def epoch_to_double(out):
    return tuple(tuple(t.double() for t in g) for g in out[:3]) + (out[3].double(),)


def phase_probe_epoch_checks(pm):
    """run_epoch_kernel against run_epoch_plain on the card; returns the
    largest abs error at the HandWritten and synthetic shapes."""
    worst = 0.0
    for v, ties in ((2, False), (3, False), (2, True), (3, True)):
        inp = epoch_inputs(3, v, 16, 12, 8, 5, seed=v, keep=0.7, tail=6, ties=ties)
        before = pm.run_epoch_kernel.launches
        got = run_epoch(pm.run_epoch_kernel, inp)
        torch.cuda.synchronize()
        if pm.run_epoch_kernel.launches != before + 1:
            raise AssertionError("probe_epoch did not count its launch")
        label = f"probe_epoch S=3 V={v} B=16 (tail 6{', ties' if ties else ''}) D=12 H=8 C=5"
        err = assert_epoch_close(got, run_epoch(pm.run_epoch_plain, inp), label)
        log(f"check {label}: max abs err {err:.3e}")
    for v in (7, 6):
        inp = epoch_inputs(16, v, 100, 200, 128, 10, seed=10 + v)
        got = run_epoch(pm.run_epoch_kernel, inp)
        err = assert_epoch_close(got, run_epoch(pm.run_epoch_plain, inp),
                                 f"probe_epoch V={v} full")
        worst = max(worst, err)
        err64 = assert_epoch_close(epoch_to_double(got),
                                   run_epoch(pm.run_epoch_plain, to_double(inp)),
                                   f"probe_epoch V={v} float64")
        state_k, state_p = inp["state"], inp["state"]
        for _ in range(5):
            k = run_epoch(pm.run_epoch_kernel, inp, state_k)
            p = run_epoch(pm.run_epoch_plain, inp, state_p)
            state_k, state_p = k[:3], p[:3]
        err5 = assert_epoch_close(k, p, f"probe_epoch V={v} 5 epochs")
        log(f"check probe_epoch S=16 V={v} B=100 D=200 H=128 C=10: max abs err {err:.3e} "
            f"(vs float64 plain {err64:.3e}; after 5 chained epochs {err5:.3e})")
    # C = 68 (PIE) and C = 15 (Scene): more classes than lanes, up to 8 views;
    # then odd D and H, which take the forward kernel's 4-byte copies
    for s, v, b, d, h, c, tail in ((16, 4, 100, 200, 128, 68, 37), (16, 8, 100, 200, 128, 15, 37),
                                   (3, 8, 50, 37, 30, 68, 17)):
        inp = epoch_inputs(s, v, b, d, h, c, seed=20 + v + c, tail=tail, ties=True)
        label = f"probe_epoch S={s} V={v} B={b} (tail {tail}, ties) D={d} H={h} C={c}"
        got = run_epoch(pm.run_epoch_kernel, inp)
        err = assert_epoch_close(got, run_epoch(pm.run_epoch_plain, inp), label)
        err64 = assert_epoch_close(epoch_to_double(got),
                                   run_epoch(pm.run_epoch_plain, to_double(inp)),
                                   f"{label} float64")
        log(f"check {label}: max abs err {err:.3e} (vs float64 plain {err64:.3e})")
    # the CUB cells' probes: 480 rows in four steps of 100 and a tail of 80,
    # V = 3 (dmvae_cml, dmvae_joint) and 2 (dmvae_dis), C = 10
    for v in (3, 2):
        inp = epoch_inputs(5, v, 100, 200, 128, 10, seed=40 + v, tail=80)
        label = f"probe_epoch S=5 V={v} B=100 (tail 80) D=200 H=128 C=10"
        got = run_epoch(pm.run_epoch_kernel, inp)
        err = assert_epoch_close(got, run_epoch(pm.run_epoch_plain, inp), label)
        err64 = assert_epoch_close(epoch_to_double(got),
                                   run_epoch(pm.run_epoch_plain, to_double(inp)),
                                   f"{label} float64")
        worst = max(worst, err)
        log(f"check {label}: max abs err {err:.3e} (vs float64 plain {err64:.3e})")
    # the synthetic sweep's probe: C = 3, V = 3, 62 full steps (the tail
    # dropped), fused = 0 (no DC term). One epoch only: five chained epochs
    # (310 steps at lr 3e-3) leave a few w1 entries whose gradient is near
    # zero beyond the tolerance (Adam turns a summation-order difference
    # into a step of ~lr either way; PERF.md section 6)
    for s, v, b, d, h, c in EPOCH_SHAPES[1:]:
        inp = epoch_inputs(s, v, b, d, h, c, seed=30 + d, fused=0.0)
        label = f"probe_epoch S={s} V={v} B={b} (no tail) D={d} H={h} C={c} fused=0"
        got = run_epoch(pm.run_epoch_kernel, inp)
        err = assert_epoch_close(got, run_epoch(pm.run_epoch_plain, inp), label)
        err64 = assert_epoch_close(epoch_to_double(got),
                                   run_epoch(pm.run_epoch_plain, to_double(inp)),
                                   f"{label} float64")
        worst = max(worst, err)
        log(f"check {label}: max abs err {err:.3e} (vs float64 plain {err64:.3e})")
    return worst


def probe_epoch_bound(s, v, b, d, h, c, keep, tail=None):
    """(ms, 'operations' | 'bytes') of one epoch: the f32 products of each
    step (forward, dh, dW1, dW2) and ~12 operations per state element of
    AdamW, against the bytes of the inputs read once and the state (p, m, v)
    read once and written once. With a ragged ``tail`` the last step's
    products count only its rows."""
    rows = s * b if tail is None else (s - 1) * b + tail
    state = v * (d * h + h + h * c + c)
    flops = 2.0 * v * rows * (2 * d * h + 3 * h * c) + s * 12.0 * state
    per_row = v * d + (v * h if keep < 1.0 else 0) + c + 1
    nbytes = 4.0 * (rows * per_row + 2 * 3 * state + s * 2 + 3 + s)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_probe_epoch_times(pm, card):
    """Kernel and plain time per epoch at every shape of ``EPOCH_SHAPES``
    (dmvae_cml's probe on HandWritten, V=7, first), the device time per
    epoch and per step kernel from the profiler, the bound. Returns the
    first shape's row and {shape key: row} of all."""
    rows = {}
    for i, (s, v, b, d, h, c) in enumerate(EPOCH_SHAPES):
        fused = 1.0 if i == 0 else 0.0
        row = probe_epoch_times_at(pm, card, s, v, b, d, h, c, fused)
        rows[f"S={s},V={v},B={b},D={d},H={h},C={c}"] = row
    for s, v, b, d, h, c, tail in CUB_EPOCH_SHAPES:
        row = probe_epoch_times_at(pm, card, s, v, b, d, h, c, 1.0, tail)
        rows[f"S={s},V={v},B={b},tail={tail},D={d},H={h},C={c}"] = row
    return rows[next(iter(rows))], rows


def probe_epoch_times_at(pm, card, s, v, b, d, h, c, fused, tail=None):
    from torch.profiler import ProfilerActivity, profile

    inp = epoch_inputs(s, v, b, d, h, c, seed=3, fused=fused, tail=tail)
    state = [tuple(t.clone() for t in g) for g in inp["state"]]
    args = (*inp["tensors"], *inp["scalars"], *state)
    ms = event_ms(lambda *a: pm.run_epoch_kernel(*a, **inp["kw"]), args, iters=50, warmup=5)
    plain_ms = event_ms(lambda *a: pm.run_epoch_plain(*a, **inp["kw"]), args, iters=5, warmup=1)
    bound_ms, bound_by = probe_epoch_bound(s, v, b, d, h, c, 0.9, tail)
    n, steps = 20, s
    names = ("forward_kernel", "loss_kernel", "dh_kernel", "grad_adam_kernel")
    # The profiler has been seen to drop the first epochs' records of a
    # window (each kernel at 12.55 of its 16 launches per epoch): a window
    # short of launches is measured again, up to three windows; one with
    # more launches, or any other kernel, fails at once.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                pm.run_epoch_kernel(*args, **inp["kw"])
            torch.cuda.synchronize()
        found, wrapper_ms, wrapper_ops = epoch_window(prof, names, n)
        launches = {k: count / n for k, (_, count) in found.items()}
        short = set(found) == set(names) and all(x < steps for x in launches.values())
        if not short:
            break
        log(f"probe_epoch profiler window {attempt + 1} held {launches} launches per epoch of "
            f"{steps}: measured again")
    kernels = {k: (us / 1e3 / count, count / n) for k, (us, count) in found.items()}
    if set(kernels) != set(names) or any(x != steps for x in launches.values()) \
            or sum(launches.values()) != 4 * steps:
        raise AssertionError(f"probe_epoch launched {launches} per epoch, expected each of "
                             f"{names} {steps} times ({4 * steps} in all)")
    device_ms = sum(t * k for t, k in kernels.values())
    label = (f"V={v} B={b}{'' if tail is None else f' (tail {tail})'} D={d} H={h} C={c} S={s} "
             f"fused={fused:g}")
    log(f"time probe_epoch {label}: kernel {ms:.5f} ms/epoch, "
        f"plain {plain_ms:.5f} ms/epoch, bound {bound_ms:.6f} ms ({bound_by}); no single "
        f"PyTorch call computes an epoch, so there is no library time [{card}]")
    log(f"profiler device time probe_epoch {label} per epoch: {device_ms:.5f} ms [{card}]")
    for name, (t, per_epoch) in sorted(kernels.items()):
        log(f"  {name}: {t:.5f} ms per launch, {per_epoch:.0f} launches per epoch")
    log(f"  the wrapper's PyTorch operations: {wrapper_ops / n:.0f} per epoch, "
        f"{wrapper_ms:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, device_ms=device_ms)


def epoch_window(prof, names, n):
    """({kernel: (device us, launches)}, wrapper ms per epoch, wrapper
    operations) of a profiler window of ``n`` epochs. Every device
    operation of the window is one of the source's four kernels or one of
    the PyTorch operations the wrapper runs (the scalars' fill and stack);
    anything else (a renamed or added kernel) fails."""
    from torch.autograd import DeviceType

    ours = re.compile(r"\b(" + "|".join(names) + r")\b")
    found, wrapper_ms, wrapper_ops = {}, 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)
        match = ours.search(e.key)
        if match:
            total_us, count = found.get(match.group(1), (0.0, 0))
            found[match.group(1)] = (total_us + us, count + e.count)
        elif "at::" in e.key or e.key.startswith(("Memcpy", "Memset")):
            wrapper_ms += us / 1e3 / n
            wrapper_ops += e.count
        else:
            raise AssertionError(f"unmatched device operation in the probe_epoch window: "
                                 f"{e.key[:160]}")
    return found, wrapper_ms, wrapper_ops


@contextlib.contextmanager
def artifact_root(prefix):
    """A scratch artifact root under chip_scratch/ for the runners'
    checkpoints, logs and reports, removed on exit."""
    import os
    import shutil
    import tempfile

    root = Path(__file__).resolve().parent / "chip_scratch"
    root.mkdir(exist_ok=True)
    scratch = tempfile.mkdtemp(prefix=prefix, dir=root)
    old = os.environ.get("DMF_ARTIFACT_ROOT")
    os.environ["DMF_ARTIFACT_ROOT"] = scratch
    try:
        yield scratch
    finally:
        if old is None:
            os.environ.pop("DMF_ARTIFACT_ROOT")
        else:
            os.environ["DMF_ARTIFACT_ROOT"] = old
        shutil.rmtree(scratch, ignore_errors=True)


def phase_training(ck, pm, card):
    """The training path: runners/run.py main on HandWritten Normal, seed 0,
    with the probe fits through the epoch kernel. Returns both kernels'
    launch counts over it, the head kernel's by shape, the cell's wall time
    and each model's fused accuracy."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config())
    probe_epochs = C("probes.model_epochs")
    with artifact_root("train_"), head_shape_tally() as shapes:
        pm.run_epoch_kernel.launches = 0
        ck.evidential_heads_stacked.launches = 0
        t0 = time.perf_counter()
        rows = runner.main(["--seeds", "0", "--datasets", "HandWritten", "--conditions",
                            "Normal", "--probe-engine", "megakernel"])
        wall = time.perf_counter() - t0
        epoch_launches = pm.run_epoch_kernel.launches
        head_launches = ck.evidential_heads_stacked.launches
    models = rows[0]["Normal"]["HandWritten"]
    for name, info in models.items():
        acc = info["fused"]["accuracy"]
        log(f"train HandWritten {name}: fused accuracy {acc:.4f}, fit {info['fit_seconds']:.2f} s, "
            f"{1e3 * info['fit_seconds'] / probe_epochs:.3f} ms/epoch [{card}]")
        if not acc >= 0.95:
            raise AssertionError(f"{name} fused accuracy {acc:.4f} < 0.95")
    if len(models) != 6:
        raise AssertionError(f"{len(models)} models trained, expected 6")
    if epoch_launches != 3 * probe_epochs:
        raise AssertionError(f"probe_epoch launched {epoch_launches} times, "
                             f"expected {3 * probe_epochs}")
    if head_launches < 6 * probe_epochs:
        raise AssertionError(f"evidential_head launched {head_launches} times, expected at "
                             f"least one per epoch of the six fits ({6 * probe_epochs})")
    if sum(shapes.values()) != head_launches:
        raise AssertionError(f"head calls by shape {dict(shapes)} do not add up to "
                             f"{head_launches} launches")
    log(f"train: HandWritten Normal seed 0 in {wall:.1f} s; probe_epoch launched "
        f"{epoch_launches} times, evidential_head {head_launches} times "
        f"(by shape {dict(shapes)}) [{card}]")
    accs = {name: info["fused"]["accuracy"] for name, info in models.items()}
    return epoch_launches, head_launches, dict(shapes), wall, accs


# phase 25 at half the depth of phase 8 (PERF.md section 4): its probes train
# through the step loop (a bf16 probe has no epoch-kernel descriptor), which
# costs more per epoch than phase 8's epoch kernel
BF16_HANDWRITTEN_CUT = {"dmvae.num_epochs": 50, "probes.model_epochs": 100}
BF16_HANDWRITTEN_FLOOR = 0.93


def phase_training_bf16(ck, pm, card, f32_accs):
    """The training path in bf16: runners/run.py --dtype bfloat16 on
    HandWritten Normal, seed 0, --probe-engine megakernel, at
    ``BF16_HANDWRITTEN_CUT``: each fused accuracy >= 0.93 and within 0.05
    of phase 8's float32 one; the probes through the step loop (the epoch
    kernel launched 0 times), the head kernel's bf16 build once per
    validation epoch and evaluation of the six fits, its f32 build never.
    Returns the bf16 launches and their shapes."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    with artifact_root("train_bf16_"), cut_config(BF16_HANDWRITTEN_CUT), \
            head_shape_tally() as shapes:
        probe_epochs = make_getter(load_config())("probes.model_epochs")
        pm.run_epoch_kernel.launches = 0
        ck.evidential_heads_stacked.launches = 0
        ck.evidential_heads_stacked_bf16.launches = 0
        t0 = time.perf_counter()
        rows = runner.main(["--seeds", "0", "--datasets", "HandWritten", "--conditions",
                            "Normal", "--probe-engine", "megakernel", "--dtype", "bfloat16"])
        wall = time.perf_counter() - t0
        epochs, f32_heads = pm.run_epoch_kernel.launches, ck.evidential_heads_stacked.launches
        heads = ck.evidential_heads_stacked_bf16.launches
    models = rows[0]["Normal"]["HandWritten"]
    if len(models) != 6:
        raise AssertionError(f"bf16 HandWritten: {len(models)} models trained, expected 6")
    for name, info in models.items():
        acc = info["fused"]["accuracy"]
        log(f"train bf16 HandWritten {name}: fused accuracy {acc:.4f} (phase 8, float32, full "
            f"depth: {f32_accs[name]:.4f}), fit {info['fit_seconds']:.2f} s, "
            f"{1e3 * info['fit_seconds'] / probe_epochs:.3f} ms/epoch [{card}]")
        if not (acc >= BF16_HANDWRITTEN_FLOOR and abs(acc - f32_accs[name]) <= 0.05):
            raise AssertionError(f"bf16 {name} fused accuracy {acc:.4f}: below "
                                 f"{BF16_HANDWRITTEN_FLOOR} or more than 0.05 from "
                                 f"{f32_accs[name]:.4f}")
    expected = 6 * (probe_epochs + 1)
    if epochs or f32_heads or heads != expected or sum(shapes.values()) != heads \
            or not all(key.endswith(",bf16") for key in shapes):
        raise AssertionError(f"bf16 HandWritten: probe_epoch launched {epochs} times, the f32 "
                             f"head {f32_heads}, the bf16 head {heads} (expected {expected}; "
                             f"by shape {dict(shapes)})")
    log(f"train bf16: HandWritten Normal seed 0 at {BF16_HANDWRITTEN_CUT} in {wall:.1f} s; "
        f"probe_epoch launched 0 times, evidential_head f32 0 times, bf16 {heads} times (by "
        f"shape {dict(shapes)}) [{card}]")
    return heads, dict(shapes)


def phase_engines(card):
    """One dmvae_cml probe fit of 3 epochs at full width, through the epoch
    kernel and through the step loop from the same generator state."""
    from disentagled_multimodal_fusion_tpu_torch.core import tasks
    from disentagled_multimodal_fusion_tpu_torch.core.train import Randomness, train
    from disentagled_multimodal_fusion_tpu_torch.data.multiview import DATASET_REGISTRY

    views, labels = DATASET_REGISTRY["HandWritten"]().arrays()
    dims = [v.shape[1] for v in views]
    backbone = tasks.build_dmvae_task(output_dim=dims, hidden_dim=512, embed_dim=200,
                                      fused_modalities=True, device="cuda")
    xs = tuple(torch.from_numpy(v).cuda() for v in views)
    y = torch.from_numpy(labels).cuda()
    zc, zp = tasks.embed_dataset(backbone, xs)
    data = {"zc": zc[:1600], "zp": zp[:1600], "y": y[:1600]}
    val = {"zc": zc[1600:], "zp": zp[1600:], "y": y[1600:]}
    results = {}
    for engine in ("megakernel", "step"):
        task = tasks.build_probe_task(num_modalities=6, num_classes=10, input_dim=200, seed=1,
                                      lr=3e-3, dropout=0.1, annealing_start=50, num_epochs=3,
                                      device="cuda")
        res = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=1600,
                    optimizer=task.optimizer, epochs=3, batch_size=100,
                    randomness=Randomness(7, "cuda"), val_fn=task.val_fn, val_data=val,
                    megakernel=task.megakernel if engine == "megakernel" else None)
        results[engine] = (res, [p.detach().clone() for p in task.model.parameters()])
    (rk, pk), (rs, ps) = results["megakernel"], results["step"]
    t = torch.from_numpy
    assert_close(t(rk.train_loss), t(rs.train_loss), "engines train_loss", rtol=2e-5, atol=2e-6)
    assert_close(t(rk.val_loss), t(rs.val_loss), "engines val_loss", rtol=2e-5, atol=2e-6)
    if not np.array_equal(rk.val_acc, rs.val_acc):
        raise AssertionError(f"engines val_acc differ: {rk.val_acc} vs {rs.val_acc}")
    err = max(assert_close(a, b, "engines params", rtol=5e-3, atol=5e-5)[0]
              for a, b in zip(pk, ps))
    log(f"engines: dmvae_cml 3 epochs at full width, epoch kernel vs step loop: train loss "
        f"{rk.train_loss.tolist()} vs {rs.train_loss.tolist()}, val_acc equal, params max abs "
        f"err {err:.3e} [{card}]")


def phase_vmapped_heads(ck, card):
    """Five seeds of each HandWritten head set through ``torch.func.vmap``:
    one launch at 5 x V heads, equal to the five per-seed launches and to
    the vmapped plain version."""
    s_count = len(SEEDS)
    for v, b, d, h, c in VALIDATION_SHAPES[:3]:
        per_seed = [head_inputs(v, b, d, h, c, seed=100 + s) for s in range(s_count)]
        stacked = [torch.stack(parts) for parts in zip(*per_seed)]
        label = f"vmapped evidential_head {s_count} x {shape_key(v, b, d, h, c)}"
        with torch.no_grad():
            before = ck.evidential_heads_stacked.launches
            got = torch.func.vmap(ck.evidential_heads_stacked)(*stacked)
            torch.cuda.synchronize()
            launches = ck.evidential_heads_stacked.launches - before
            refs = [ck.evidential_heads_stacked(*args) for args in per_seed]
            plain = torch.func.vmap(ck.evidential_heads_stacked_plain)(*stacked)
        if launches != 1 or tuple(got.shape) != (s_count, b, v, c):
            raise AssertionError(f"{label}: {launches} launches, shape {tuple(got.shape)}")
        worst = max(assert_close(got[i], ref, f"{label} seed {i}")[0] for i, ref in enumerate(refs))
        assert_close(got, plain, f"{label} against the vmapped plain version")
        bitwise = all(torch.equal(got[i], ref) for i, ref in enumerate(refs))
        log(f"check {label}: one launch at V={s_count * v}, max abs err {worst:.3e} against "
            f"the per-seed launches ({'bitwise equal' if bitwise else 'not bitwise'})")


@contextlib.contextmanager
def kept_checkpoints():
    """Keeps a reference to every module the runners checkpoint, by
    checkpoint name, while they run."""
    from disentagled_multimodal_fusion_tpu_torch.core import checkpoint

    real = checkpoint.save_checkpoint
    kept = {}

    def keep(path, module, hparams=None):
        kept[path] = module
        return real(path, module, hparams)

    checkpoint.save_checkpoint = keep
    try:
        yield kept
    finally:
        checkpoint.save_checkpoint = real


@contextlib.contextmanager
def cut_config(changes, name="config.yaml"):
    """The port's copy of config ``name`` with ``changes`` ({"section.key":
    value}) while the block runs, for a path whose depth is cut."""
    import copy

    from disentagled_multimodal_fusion_tpu_torch.runners.common import CONFIGS

    cfg = CONFIGS[name]
    saved = copy.deepcopy(cfg)
    for path, value in changes.items():
        section, key = path.split(".")
        cfg[section][key] = value
    try:
        yield
    finally:
        cfg.clear()
        cfg.update(saved)


# depth cut from earlier paths so that the script, phases 18-21 included,
# stays well inside its time on a slow host (PERF.md section 4): the
# seed-batched HandWritten path at half its depth (a quarter leaves a probe
# below 0.95), and the DSSL phase's backbone at a quarter and its late
# fusion, a repeat of phase 14's on the same views, at a fifth
# (synthetic_config.yaml)
SEED_BATCHED_CUT = {"dmvae.num_epochs": 50, "probes.model_epochs": 100}
DSSL_CUT = {"dmvae.num_epochs": 25, "latefusion.num_epochs": 10}


def phase_seed_batched(ck, card, seq_wall):
    """The seed-batched path: runners/run.py --vmap-seeds on HandWritten
    Normal, seeds 0-4, at the depth of the config in force
    (``SEED_BATCHED_CUT`` in the full run). Returns the head kernel's
    launches over it, by shape, the rows and the cell's wall time."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config())
    probe_epochs, dmvae_epochs = C("probes.model_epochs"), C("dmvae.num_epochs")
    with head_shape_tally() as shapes:
        ck.evidential_heads_stacked.launches = 0
        t0 = time.perf_counter()
        rows = runner.main(["--vmap-seeds", "--seeds", *map(str, SEEDS), "--datasets",
                            "HandWritten", "--conditions", "Normal"])
        wall = time.perf_counter() - t0
        launches = ck.evidential_heads_stacked.launches
    models = {s: rows[s]["Normal"]["HandWritten"] for s in SEEDS}
    first = models[SEEDS[0]]
    bb_s = first["dmvae_cml"]["backbone_fit_seconds"]
    log(f"seed-batched dmvae fit x{len(SEEDS)}: {bb_s:.2f} s, "
        f"{1e3 * bb_s / dmvae_epochs:.3f} ms/epoch [{card}]")
    for name, info in first.items():
        log(f"seed-batched {name} fit x{len(SEEDS)}: {info['fit_seconds']:.2f} s, "
            f"{1e3 * info['fit_seconds'] / probe_epochs:.3f} ms/epoch (evaluation and fetch "
            f"included) [{card}]")
    for s in SEEDS:
        accs = {name: round(info["fused"]["accuracy"], 4) for name, info in models[s].items()}
        log(f"seed-batched HandWritten seed {s}: fused accuracies {accs}")
        if len(accs) != 6 or not all(a >= 0.95 for a in accs.values()):
            raise AssertionError(f"seed {s}: a fused accuracy below 0.95 or a model missing: "
                                 f"{accs}")
    # per fit one launch per validation epoch and one for its evaluation:
    # dmvae_cml and dmvae_joint at 5 x 7 heads, dmvae_dis at 5 x 6, the
    # three late fusions at 5 x 6 of width 240
    per_fit = probe_epochs + 1
    expected = {shape_key(*STACKED_SHAPES[0]): 2 * per_fit,
                shape_key(*STACKED_SHAPES[1]): per_fit,
                shape_key(*STACKED_SHAPES[2]): 3 * per_fit}
    if dict(shapes) != expected or launches != sum(expected.values()):
        raise AssertionError(f"evidential_head launched {launches} times, by shape "
                             f"{dict(shapes)}, expected {expected}")
    log(f"seed-batched: HandWritten Normal seeds {list(SEEDS)} at {dmvae_epochs} DMVAE and "
        f"{probe_epochs} head epochs in {wall:.1f} s, {wall / len(SEEDS):.1f} s per seed; the "
        f"sequential seed-0 cell of the training phase (full depth, probe fits through the "
        f"epoch kernel) took {seq_wall:.1f} s; evidential_head "
        f"launched {launches} times (by shape {dict(shapes)}) [{card}]")
    return launches, dict(shapes), rows, wall


def phase_seed_batched_engines(card):
    """--vmap-seeds against --one-program-cells on a quick two-seed cell,
    then train_many against train seed by seed over 3 epochs at full width."""
    from disentagled_multimodal_fusion_tpu_torch.core import tasks
    from disentagled_multimodal_fusion_tpu_torch.core.train import (
        Randomness,
        stack_params,
        train,
        train_many,
    )
    from disentagled_multimodal_fusion_tpu_torch.data.multiview import DATASET_REGISTRY
    from disentagled_multimodal_fusion_tpu_torch.eval.analysis import build_metrics_rows_datasets
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    flat = {}
    with artifact_root("engines_"):
        for flag in ("--vmap-seeds", "--one-program-cells"):
            rows = runner.main([flag, "--seeds", "0", "1", "--quick", "--datasets",
                                "HandWritten", "--conditions", "Normal", "--skip-report"])
            flat[flag] = build_metrics_rows_datasets(rows)[1]
    worst, bitwise = 0.0, True
    for a, b in zip(flat["--vmap-seeds"], flat["--one-program-cells"]):
        if a.keys() != b.keys():
            raise AssertionError("the engines' rows have different columns")
        for k, va in a.items():
            if isinstance(va, float):
                err = abs(va - b[k])
                if err > 1e-6 * abs(b[k]):
                    raise AssertionError(f"engines differ at {a['model']} {k}: {va} vs {b[k]}")
                worst, bitwise = max(worst, err), bitwise and va == b[k]
    log(f"engines: --vmap-seeds and --one-program-cells rows equal at rtol 1e-6 over "
        f"{len(flat['--vmap-seeds'])} rows (max abs difference {worst:.3e}"
        f"{', bitwise' if bitwise else ''}) [{card}]")

    views, labels = DATASET_REGISTRY["HandWritten"]().arrays()
    dims = [v.shape[1] for v in views]
    backbone = tasks.build_dmvae_task(output_dim=dims, hidden_dim=512, embed_dim=200,
                                      fused_modalities=True, device="cuda")
    zc, zp = tasks.embed_dataset(backbone, tuple(torch.from_numpy(v).cuda() for v in views))
    y = torch.from_numpy(labels).cuda()
    data = {"zc": zc[:1600], "zp": zp[:1600], "y": y[:1600]}
    val = {"zc": zc[1600:], "zp": zp[1600:], "y": y[1600:]}
    probe = dict(num_modalities=6, num_classes=10, input_dim=200, lr=3e-3, dropout=0.1,
                 annealing_start=50, num_epochs=3, device="cuda")
    for name, build in (("dmvae_cml", tasks.build_probe_task),
                        ("dmvae_dis", tasks.build_disentangled_probe_task)):
        fits = [build(seed=s, **probe) for s in (1, 2)]
        fit = dict(data=data, n_train=1600, optimizer=fits[0].optimizer, epochs=3,
                   batch_size=100, val_fn=fits[0].val_fn, val_data=val)
        many = train_many(model=fits[0].model, params=stack_params([t.model for t in fits]),
                          loss_fn=fits[0].loss_fn, randomness=[Randomness(7 + i, "cuda")
                                                               for i in range(2)],
                          data_broadcast=True, **fit)
        err = 0.0
        for i, task in enumerate(fits):
            res = train(model=task.model, loss_fn=task.loss_fn,
                        randomness=Randomness(7 + i, "cuda"), **dict(fit, val_fn=task.val_fn))
            t = torch.from_numpy
            assert_close(many.train_loss[i].cpu(), t(res.train_loss), f"{name} train_many[{i}] "
                         "train_loss", rtol=2e-5, atol=2e-6)
            assert_close(many.val_loss[i].cpu(), t(res.val_loss), f"{name} train_many[{i}] "
                         "val_loss", rtol=2e-5, atol=2e-6)
            for k, p in task.model.named_parameters():
                err = max(err, assert_close(many.params[k][i], p.detach(),
                                            f"{name} train_many[{i}] {k}", rtol=5e-3,
                                            atol=5e-5)[0])
        log(f"engines: {name} 3 epochs at full width, train_many over 2 seeds vs train per "
            f"seed: losses within rtol 2e-5 / atol 2e-6, params max abs err {err:.3e} [{card}]")


def phase_restore(card, kept, rows):
    """Seed 0's dmvae_cml and cml_fusion served from the seed-batched
    phase's checkpoints at runners/serve.py's default paths, against the
    in-memory models; then runners/evaluate.py on seed 0's dmvae_cml."""
    import io

    from disentagled_multimodal_fusion_tpu_torch.runners import evaluate, serve
    from disentagled_multimodal_fusion_tpu_torch.runners.common import (
        backbone_checkpoint,
        head_name,
        load_config,
        make_getter,
    )

    C = make_getter(load_config())
    for name in ("dmvae_cml", "cml_fusion"):
        args = serve.parse_args(["--model", name, "--dataset", "HandWritten", "--seed", "0",
                                 "--buckets", "256"])
        infer, xs = serve.load(args, C, torch.device("cuda"))
        served = infer(xs)
        head = kept[f"checkpoints/{head_name(name, 'HandWritten', 0, 'normal')}"]
        with torch.no_grad():
            if name.startswith("dmvae_"):
                zc, zp = kept[backbone_checkpoint("HandWritten", 0, "normal")].get_embedding(xs)
                ev = head(zc, zp)
            else:
                ev = head(xs)
        if not torch.equal(served["evidence"], ev):
            diff = float((served["evidence"] - ev).abs().max())
            raise AssertionError(f"restored {name} serves other evidence than the in-memory "
                                 f"model: max abs diff {diff}")
        log(f"restore: {name} seed 0 served from its checkpoints equals the in-memory model "
            f"bit for bit on {xs[0].shape[0]} rows")
    with contextlib.redirect_stdout(io.StringIO()):
        info = evaluate.main(["--model", "dmvae_cml", "--dataset", "HandWritten", "--seed", "0",
                              "--condition", "normal"])
    got = info["fused"]["accuracy"]
    want = rows[0]["Normal"]["HandWritten"]["dmvae_cml"]["fused"]["accuracy"]
    if got != want:
        raise AssertionError(f"evaluate.py reports fused accuracy {got}, the sweep {want}")
    log(f"restore: evaluate.py dmvae_cml HandWritten seed 0: fused accuracy {got:.4f}, as the "
        f"seed-batched sweep reported [{card}]")


EXPORTED_MODELS = ("dmvae_cml", "cml_fusion")

# the replay of one model's artifacts in a fresh interpreter that imports
# torch and the operator's file only (its working directory is the export
# directory; no package is on its path)
REPLAY_SCRIPT = """
import importlib.util, json, sys
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
name, buckets, views = sys.argv[1], [int(b) for b in sys.argv[2].split(",")], int(sys.argv[3])
spec = importlib.util.spec_from_file_location("dmf_head_op", "dmf_head_op.py")
op = importlib.util.module_from_spec(spec)
spec.loader.exec_module(op)
op.load("evidential_head.so")
report = {}
for b in buckets:
    io = np.load(f"io_b{b}.npz")
    xs = tuple(torch.from_numpy(io[f"arr_{i}"]).cuda() for i in range(views))
    program = torch.export.load(f"{name}_HandWritten_seed0_b{b}.pt2").module()
    with torch.no_grad():
        program(xs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = program(xs)
            torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and "evidential_heads_kernel" in e.key)
    assert kernels == 1, (b, kernels)
    np.testing.assert_array_equal(out["pred"].cpu().numpy(), io["pred"])
    gaps = {}
    for k in ("probs", "evidence", "fused_evidence", "epistemic", "aleatoric"):
        got = out[k].cpu().numpy()
        np.testing.assert_allclose(got, io[k], rtol=1e-5, atol=1e-6, err_msg=f"{b} {k}")
        gaps[k] = float(np.abs(got - io[k]).max())
    report[b] = {"head_kernel_launches": kernels, "max_abs_diff": gaps}
bad = [m for m in sys.modules if "disentagled" in m]
assert not bad, bad
print(json.dumps(report))
"""


def phase_export(ck, card):
    """Export: runners/serve.py --export-dir for dmvae_cml and cml_fusion at
    ``BUCKETS`` from phase 13's checkpoints (the seed-batched phase's, at
    serve.py's default paths): one ``.pt2`` per bucket under the JAX
    package's names, each graph holding exactly one ``dmf.evidential_heads``
    call; then one fresh subprocess per model replays its four artifacts
    under torch.profiler with ``dmf_head_op.py`` and ``evidential_head.so``
    from the export directory: outputs equal to the direct call on the card
    (rtol 1e-5 / atol 1e-6, ``pred`` equal), the head kernel once per call,
    no module of the package loaded; the two subprocesses run at once.
    Returns the head kernel's launches of the serve.py runs (their bucket
    benches; the replays launch in their own processes)."""
    from disentagled_multimodal_fusion_tpu_torch.core.serve import head_op_calls, to_host
    from disentagled_multimodal_fusion_tpu_torch.runners import serve
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config())
    launches, replays = 0, {}
    for name in EXPORTED_MODELS:
        out = Path(os.environ["DMF_ARTIFACT_ROOT"]) / "exported" / name
        flags = ["--model", name, "--dataset", "HandWritten", "--seed", "0", "--buckets",
                 *map(str, BUCKETS)]
        ck.evidential_heads_stacked.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            report = serve.main(flags + ["--reps", "3", "--export-dir", str(out)])
        export_s = time.perf_counter() - t0
        launches += ck.evidential_heads_stacked.launches
        names = [f"{name}_HandWritten_seed0_b{b}.pt2" for b in BUCKETS]
        if [Path(p).name for p in report["exported"]] != \
                names + ["dmf_head_op.py", "evidential_head.so"]:
            raise AssertionError(f"export {name}: wrote {report['exported']}")
        infer, xs = serve.load(serve.parse_args(flags), C, torch.device("cuda"))
        for b, artifact in zip(BUCKETS, names):
            calls = head_op_calls(torch.export.load(str(out / artifact)))
            if calls != 1:
                raise AssertionError(f"export {artifact}: {calls} dmf.evidential_heads calls")
            direct = to_host(infer(tuple(x[:b] for x in xs)))
            np.savez(out / f"io_b{b}.npz", *[x[:b].cpu().numpy() for x in xs], **direct)
        log(f"export {name}: {len(names)} artifacts, one dmf.evidential_heads call each, in "
            f"{export_s:.1f} s (serve.py with its bucket bench) [{card}]")
        replays[name] = (out, len(xs))
    # both replays at once: each is mostly its interpreter's start-up
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = {name: subprocess.Popen([sys.executable, "-c", REPLAY_SCRIPT, name,
                                     ",".join(map(str, BUCKETS)), str(views)],
                                    cwd=out, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, env=env)
             for name, (out, views) in replays.items()}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode:
                raise AssertionError(f"export {name}: the replay failed: {stderr[-3000:]}")
            replay = json.loads(stdout.strip().splitlines()[-1])
            log(f"export {name}: replayed without the package in "
                f"{time.perf_counter() - t0:.1f} s: {replay} [{card}]")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return launches


def phase_synthetic(ck, pm, card, backbone):
    """The synthetic path: runners/run_synthetic.py main, seed 0, dep 50, med
    preset, --probe-engine megakernel, at full width and depth over
    ``backbone``. Returns the rows, both kernels' launch counts over it, the
    head kernel's by shape, and the sweep's wall time."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run_synthetic
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config("synthetic_config.yaml"))
    bb_epochs, probe_epochs = C("dmvae.num_epochs"), C("dmvae_fusion.num_epochs")
    late_epochs = C("latefusion.num_epochs", 50)  # no such key in the YAML: the code default
    with head_shape_tally() as shapes:
        pm.run_epoch_kernel.launches = 0
        ck.evidential_heads_stacked.launches = 0
        t0 = time.perf_counter()
        rows = run_synthetic.main(["--seeds", "0", "--deps", "50", "--preset", "med",
                                   "--probe-engine", "megakernel", "--backbone", backbone])
        wall = time.perf_counter() - t0
        epoch_launches = pm.run_epoch_kernel.launches
        head_launches = ck.evidential_heads_stacked.launches
    models = rows[0][50]
    first = models["dmvae_cml"]
    bb_s = first["backbone_fit_seconds"]
    syncs = (f", {first['vmf_syncs_per_epoch']:.2f} vMF sampler host syncs per epoch"
             if backbone == "dssl" else "")
    log(f"synthetic {backbone} backbone fit: {bb_s:.2f} s, {1e3 * bb_s / bb_epochs:.3f} "
        f"ms/epoch{syncs} [{card}]")
    if sorted(models) != ["avg", "cml", "dmvae_cml"]:
        raise AssertionError(f"synthetic {backbone}: models {sorted(models)}")
    for name, info in models.items():
        acc = info["fused"]["accuracy"]
        epochs = probe_epochs if name == "dmvae_cml" else late_epochs
        log(f"synthetic {backbone} {name}: fused accuracy {acc:.4f}, fit {info['fit_seconds']:.2f}"
            f" s, {1e3 * info['fit_seconds'] / epochs:.3f} ms/epoch [{card}]")
        if not acc >= 0.70:
            raise AssertionError(f"synthetic {backbone} {name} fused accuracy {acc:.4f} < 0.70")
    if epoch_launches != probe_epochs:
        raise AssertionError(f"probe_epoch launched {epoch_launches} times, expected "
                             f"{probe_epochs}")
    # per fit one launch per validation epoch and one for its evaluation
    d = 16 if backbone == "dmvae" else 32
    expected = {shape_key(3, 2000, d, 128, 3): probe_epochs + 1,
                shape_key(2, 2000, 32, 128, 3): 2 * (late_epochs + 1)}
    if dict(shapes) != expected or head_launches != sum(expected.values()):
        raise AssertionError(f"evidential_head launched {head_launches} times, by shape "
                             f"{dict(shapes)}, expected {expected}")
    log(f"synthetic {backbone}: seed 0 dep 50 in {wall:.1f} s; probe_epoch launched "
        f"{epoch_launches} times, evidential_head {head_launches} times (by shape "
        f"{dict(shapes)}) [{card}]")
    return rows, epoch_launches, head_launches, dict(shapes)


def phase_synthetic_seed_batched(ck, card):
    """runners/run_synthetic.py --vmap-seeds over seeds 0-4 (--quick): the
    head kernel once per validation epoch and evaluation of each fit, at
    S x V heads; then each seed's train_many fit against its train fit on
    the card (the backbone, the probe and cml late fusion, from one set of
    generators). Returns the head kernel's launches and their shapes."""
    from disentagled_multimodal_fusion_tpu_torch.core import tasks
    from disentagled_multimodal_fusion_tpu_torch.core.train import (
        Randomness,
        stack_params,
        train,
        train_many,
    )
    from disentagled_multimodal_fusion_tpu_torch.runners import run_synthetic as rs
    from disentagled_multimodal_fusion_tpu_torch.runners.common import (
        fold_seed,
        load_config,
        make_getter,
    )
    from disentagled_multimodal_fusion_tpu_torch.runners.run import build_backbone

    with head_shape_tally() as shapes:
        ck.evidential_heads_stacked.launches = 0
        rows = rs.main(["--vmap-seeds", "--seeds", *map(str, SEEDS), "--deps", "50", "--quick"])
        launches = ck.evidential_heads_stacked.launches
    per_fit = 3 + 1  # --quick: 3 validation epochs and the evaluation
    expected = {shape_key(*SYNTHETIC_QUICK_SHAPES[0]): per_fit,
                shape_key(*SYNTHETIC_QUICK_SHAPES[1]): 2 * per_fit}
    if dict(shapes) != expected or launches != sum(expected.values()):
        raise AssertionError(f"evidential_head launched {launches} times, by shape "
                             f"{dict(shapes)}, expected {expected}")
    for s in SEEDS:
        accs = {name: round(info["fused"]["accuracy"], 4) for name, info in rows[s][50].items()}
        log(f"synthetic --vmap-seeds --quick seed {s}: fused accuracies {accs}")
    log(f"synthetic --vmap-seeds: evidential_head launched {launches} times, one per validation "
        f"and evaluation at S x V heads (by shape {dict(shapes)}) [{card}]")

    C = make_getter(load_config("synthetic_config.yaml"))
    st = rs.cell_settings(C, quick=True)
    cells = [rs.make_cell(s, 50, rs.preset_data_kwargs(C, "med", quick=True)) for s in SEEDS]
    xs = tuple(torch.from_numpy(np.stack([c[0][0][v] for c in cells])).cuda() for v in range(2))
    y = torch.from_numpy(np.stack([c[0][1] for c in cells])).cuda()
    n, dims = xs[0].shape[1], [int(x.shape[2]) for x in xs]
    fit = dict(n_train=n, batch_size=rs.BATCH_SIZE, drop_last=True)

    def compare_losses(label, many, one, i):
        t = torch.from_numpy
        assert_close(many.train_loss[i].cpu(), t(one.train_loss), f"{label}[{i}] train_loss",
                     rtol=2e-5, atol=2e-6)
        assert_close(many.val_loss[i].cpu(), t(one.val_loss), f"{label}[{i}] val_loss",
                     rtol=2e-5, atol=2e-6)

    backbones = [build_backbone(st, dims, fold_seed(s, 0), "cuda") for s in SEEDS]
    # each backbone's own objective: its loss closure runs that module
    objectives = [tasks.dmvae_objective(b, lr=st.dmvae_lr, num_epochs=st.dmvae_epochs)
                  for b in backbones]
    opt = objectives[0][1]
    many = train_many(model=backbones[0], params=stack_params(backbones),
                      loss_fn=objectives[0][0], data={"xs": xs}, optimizer=opt,
                      epochs=st.dmvae_epochs,
                      randomness=[Randomness(fold_seed(s, 1), "cuda") for s in SEEDS], **fit)
    # The backbone's batched and single cuBLAS products round apart, and Adam
    # turns that into steps of up to ~lr on entries whose gradient is near
    # zero, so its parameters are not held to the probes' tolerance (0.13 %
    # of the entries left it, and the embeddings moved by 0.87 % in norm, in
    # PERF.md's runs): its losses are, and so is what it computes, the
    # embeddings of the train rows, within 5 % in norm (a fit from other
    # weights or draws is off by ~100 %).
    err, beyond, total, emb_err = 0.0, 0, 0, 0.0
    zc, zp = tasks.embed_many(backbones[0], many.params, xs)
    for i, (s, backbone) in enumerate(zip(SEEDS, backbones)):
        one = train(model=backbone, loss_fn=objectives[i][0],
                    data={"xs": tuple(x[i] for x in xs)}, optimizer=opt,
                    epochs=st.dmvae_epochs, randomness=Randomness(fold_seed(s, 1), "cuda"),
                    **fit)
        compare_losses("dmvae train_many", many, one, i)
        for got, ref in zip((zc[i], zp[i]), tasks.embed_dataset(backbone, tuple(x[i] for x in xs))):
            emb_err = max(emb_err, float(torch.linalg.vector_norm(got - ref)
                                         / torch.linalg.vector_norm(ref)))
        for k, p in backbone.named_parameters():
            diff = (many.params[k][i] - p.detach()).abs()
            beyond += int((diff > 5e-5 + 5e-3 * p.detach().abs()).sum())
            total += diff.numel()
            err = max(err, float(diff.max()))
    if emb_err > 5e-2:
        raise AssertionError(f"dmvae train_many vs train: embeddings differ by {emb_err:.3e} in "
                             f"norm")
    log(f"synthetic engines: dmvae train_many over {len(SEEDS)} seeds vs train per seed "
        f"({st.dmvae_epochs} epochs, drop_last): losses within rtol 2e-5 / atol 2e-6, "
        f"embeddings within {emb_err:.3e} in norm; {beyond} of {total} parameter entries "
        f"beyond rtol 5e-3 / atol 5e-5, max abs err {err:.3e} [{card}]")
    specs = rs.head_specs(C, st, dims, st.embed_dim, "cuda", quick=True)
    data = {"probe": {"zc": zc, "zp": zp, "y": y}, "raw": {"xs": xs, "y": y}}
    for j, (label, builder, kind, _, epochs) in enumerate(specs[:2]):
        heads = [builder(fold_seed(s, 10 + j)) for s in SEEDS]
        head_fit = dict(fit, optimizer=heads[0].optimizer, epochs=epochs)
        many = train_many(model=heads[0].model, params=stack_params([h.model for h in heads]),
                          loss_fn=heads[0].loss_fn, data=data[kind], val_fn=heads[0].val_fn,
                          val_data=data[kind],
                          randomness=[Randomness(fold_seed(s, 100 + j), "cuda") for s in SEEDS],
                          **head_fit)
        err = 0.0
        for i, (s, head) in enumerate(zip(SEEDS, heads)):
            own = {k: (tuple(x[i] for x in v) if isinstance(v, tuple) else v[i])
                   for k, v in data[kind].items()}
            one = train(model=head.model, loss_fn=head.loss_fn, data=own, val_fn=head.val_fn,
                        val_data=own, randomness=Randomness(fold_seed(s, 100 + j), "cuda"),
                        **head_fit)
            compare_losses(f"{label} train_many", many, one, i)
            err = max(err, max(assert_close(many.params[k][i], p.detach(),
                                            f"{label} train_many[{i}] {k}", rtol=5e-3,
                                            atol=5e-5)[0]
                               for k, p in head.model.named_parameters()))
        log(f"synthetic engines: {label} train_many over {len(SEEDS)} seeds vs train per seed: "
            f"losses within rtol 2e-5 / atol 2e-6, params max abs err {err:.3e} [{card}]")
    return launches, dict(shapes)


def phase_synthetic_restore(card, rows):
    """runners/evaluate.py --dataset synthetic on the synthetic path's
    checkpoints reports its fused accuracy of dmvae_cml."""
    import io

    from disentagled_multimodal_fusion_tpu_torch.runners import evaluate

    with contextlib.redirect_stdout(io.StringIO()):
        info = evaluate.main(["--model", "dmvae_cml", "--dataset", "synthetic", "--seed", "0",
                              "--dep", "50"])
    got, want = info["fused"]["accuracy"], rows[0][50]["dmvae_cml"]["fused"]["accuracy"]
    if got != want:
        raise AssertionError(f"evaluate.py reports fused accuracy {got}, the synthetic sweep "
                             f"{want}")
    log(f"restore: evaluate.py --dataset synthetic dmvae_cml seed 0 dep 50: fused accuracy "
        f"{got:.4f}, as the sweep reported [{card}]")


def phase_request_profile(card):
    """Where one dmvae_cml request at bucket 256 spends its time: wall time,
    device busy time and kernel launches per request over 20 requests under
    the profiler, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from disentagled_multimodal_fusion_tpu_torch.runners import serve as runner
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    args = runner.parse_args(serve_args("dmvae_cml", "cuda"))
    infer, xs = runner.load(args, make_getter(load_config()), torch.device("cuda"))
    xsb = tuple(x[:256] for x in xs)
    for _ in range(5):
        infer(xsb)
    torch.cuda.synchronize()
    n = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            infer(xsb)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = {e.key: (getattr(e, "self_device_time_total", 0.0)
                    or getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / n for e in on_device}
    busy_ms = sum(busy.values())
    launches = sum(e.count for e in on_device) / n
    log(f"request dmvae_cml bucket 256 under the profiler: {wall_ms:.4f} ms wall, "
        f"{busy_ms:.4f} ms device busy ({100 * busy_ms / wall_ms:.1f} %), "
        f"{launches:.0f} device operations per request [{card}]")
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {ms:.5f} ms/request  {key[:100]}")


def serve_args(name, device):
    return ["--model", name, "--dataset", "HandWritten", "--random-init", "--device", device,
            "--buckets", *map(str, BUCKETS)]


def phase_serving(ck, card):
    """The main path: returns the kernel's launch count over it."""
    from disentagled_multimodal_fusion_tpu_torch.runners import serve as runner

    reps = 30
    with head_shape_tally() as shapes:
        ck.evidential_heads_stacked.launches = 0
        reports = [runner.main(serve_args(name, "cuda") + ["--reps", str(reps)])
                   for name in SERVED_MODELS]
        launches = ck.evidential_heads_stacked.launches
    expected = len(SERVED_MODELS) * len(BUCKETS) * (reps + 1)
    if launches != expected or sum(shapes.values()) != launches:
        raise AssertionError(f"evidential_head launched {launches} times, expected {expected} "
                             f"(by shape {dict(shapes)})")
    log(f"serve: evidential_head launches by shape {dict(shapes)}")
    for rep in reports:
        for row in rep["buckets"]:
            log(f"serve {rep['model']} bucket {row['bucket']}: {row['latency_ms']:.4f} ms, "
                f"{row['rows_per_s']:.1f} rows/s [{card}]")

    from disentagled_multimodal_fusion_tpu_torch.core.serve import to_host
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config())
    for name in SERVED_MODELS:
        args = runner.parse_args(serve_args(name, "cuda"))
        infer_gpu, xs = runner.load(args, C, torch.device("cuda"))
        infer_cpu, _ = runner.load(args, C, torch.device("cpu"))
        for b in BUCKETS:
            before = ck.evidential_heads_stacked.launches
            got = to_host(infer_gpu(tuple(x[:b] for x in xs)))
            if ck.evidential_heads_stacked.launches != before + 1:
                raise AssertionError(f"{name} bucket {b} did not launch the kernel once")
            ref = to_host(infer_cpu(tuple(x[:b].cpu() for x in xs)))
            assert_outputs_match(got, ref, f"{name} bucket {b} card vs CPU")
        log(f"serve {name}: card outputs match the CPU plain path at buckets {list(BUCKETS)}")
    return launches, dict(shapes)


def phase_daemon_and_http(card):
    from disentagled_multimodal_fusion_tpu_torch.core.daemon import ServingDaemon
    from disentagled_multimodal_fusion_tpu_torch.core.http_front import start_http_server
    from disentagled_multimodal_fusion_tpu_torch.runners import serve as runner
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    args = runner.parse_args(serve_args("dmvae_cml", "cuda"))
    infer, xs = runner.load(args, make_getter(load_config()), torch.device("cuda"))
    engine = runner.make_engine(infer, xs, BUCKETS)
    corpus = tuple(x.cpu().numpy() for x in xs)
    answers, clients, seconds = [], 4, 3.0

    def client(cid):
        rng = np.random.RandomState(cid)
        stop = time.perf_counter() + seconds
        while time.perf_counter() < stop:
            n, off = int(rng.randint(1, 65)), int(rng.randint(0, 192))
            req = tuple(x[off:off + n] for x in corpus)
            answers.append((req, daemon.infer(req)))

    with ServingDaemon(engine, max_delay_ms=2.0) as daemon:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        elapsed = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("daemon clients did not finish")
        st = daemon.stats()
        rows = sum(r[0][0].shape[0] for r in answers)
        log(f"daemon: {clients} clients, {st['requests']} requests in {elapsed:.2f} s, "
            f"{rows / elapsed:.1f} rows/s, mean batch {st['mean_batch_rows']} rows, "
            f"p50 {st['latency_ms']['p50']} ms, p99 {st['latency_ms']['p99']} ms [{card}]")

        server, port = start_http_server(daemon)
        try:
            for i, n in enumerate((1, 3, 17, 64, 200)):
                req = tuple(x[i:i + n] for x in corpus)
                body = json.dumps({"views": [x.tolist() for x in req]}).encode()
                http_req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/infer", data=body,
                    headers={"Content-Type": "application/json"}, method="POST",
                )
                with urllib.request.urlopen(http_req, timeout=60) as r:
                    resp = json.loads(r.read())
                if resp["rows"] != n:
                    raise AssertionError(f"HTTP answered {resp['rows']} rows for {n}")
                got = {k: np.asarray(v, dtype=np.float32 if k != "pred" else np.int64)
                       for k, v in resp["outputs"].items()}
                assert_outputs_match(got, engine(req), f"HTTP request of {n} rows")
            log("http: 5 POST /v1/infer answers match direct engine calls")
        finally:
            server.shutdown()
            server.server_close()

    for req, got in answers:
        assert_outputs_match(got, engine(req), "daemon answer")
    log(f"daemon: all {len(answers)} answers match direct engine calls")


# phase 18's limits (PERF.md section 2): float32 against float64, normwise
# over each tensor, for sums of up to 307 200 terms (tensor fusion's head)
FUSION_FWD_TOL, FUSION_GRAD_TOL = 1e-4, 1e-3
CUB_DIMS, SCENE_DIMS = (1024, 300), (20, 59, 40)
MI3_PEAK_BYTES = 16 * 2**20


def _fusion_grads(module, views, cot, chunk):
    """(output, input gradients, parameter gradients) of sum(module(views) *
    cot), row chunk by row chunk (every fusion treats rows apart), the
    parameter gradients summed over the chunks."""
    params = list(module.parameters())
    outs, x_grads, p_grads = [], [[] for _ in views], [torch.zeros_like(p) for p in params]
    for s0 in range(0, views[0].shape[0], chunk):
        xs = [v[s0:s0 + chunk].detach().clone().requires_grad_() for v in views]
        out = module(xs)
        grads = torch.autograd.grad(torch.sum(out * cot[s0:s0 + chunk]), xs + params,
                                    allow_unused=True)
        outs.append(out.detach())
        for i, g in enumerate(grads[:len(xs)]):
            x_grads[i].append(g)
        for acc, g in zip(p_grads, grads[len(xs):]):
            if g is not None:
                acc += g
    return torch.cat(outs), [torch.cat(g) for g in x_grads], p_grads


def _normwise(got, ref, tol, label, scale=None):
    """max |got - ref| / max |ref|, which must be at most ``tol``; ``scale``
    replaces max |ref| for a tensor that is zero in exact arithmetic."""
    err = float((got.double().cpu() - ref).abs().max())
    scale = float(ref.abs().max()) if scale is None else scale
    if not err <= tol * max(scale, 1e-30):
        raise AssertionError(f"{label}: max abs err {err:.3e} > {tol} x max |ref| {scale:.3e}")
    return err / max(scale, 1e-30)


def _check_on_card(module, views, label, card):
    """module in float32 on the card against its float64 copy on the CPU;
    returns (worst forward, worst gradient relative error, card ms of one
    forward and backward)."""
    import copy

    cot = torch.randn(views[0].shape[0], *module([v[:1] for v in views]).shape[1:],
                      generator=torch.Generator().manual_seed(1))
    chunk = 10 if "lft" in label else views[0].shape[0]  # lft's attention in f64
    ref = _fusion_grads(copy.deepcopy(module).double(), [v.double() for v in views],
                        cot.double(), chunk)
    card_mod = module.cuda()
    cviews, ccot = [v.cuda() for v in views], cot.cuda()
    got = _fusion_grads(card_mod, cviews, ccot, views[0].shape[0])
    fwd = _normwise(got[0], ref[0], FUSION_FWD_TOL, f"{label} forward")
    grad = 0.0
    names = [f"input {i}" for i in range(len(views))] + [n for n, _ in module.named_parameters()]
    refs = dict(zip(names, ref[1] + ref[2]))
    for name, g, r in zip(names, got[1] + got[2], ref[1] + ref[2]):
        # softmax is shift-invariant: the key bias's gradient is zero but for
        # rounding, so its error is held against the key weight's gradient
        scale = (float(refs[name[:-len("bias")] + "weight"].abs().max())
                 if name.endswith("attn.key.bias") else None)
        grad = max(grad, _normwise(g, r, FUSION_GRAD_TOL, f"{label} gradient of {name}", scale))
    ms = event_ms(lambda: _fusion_grads(card_mod, cviews, ccot, views[0].shape[0]), (),
                  iters=5, warmup=1)
    log(f"fusion {label}: forward rel err {fwd:.2e}, gradient rel err {grad:.2e}, "
        f"forward + backward {ms:.3f} ms at B={views[0].shape[0]} [{card}]")
    return fwd, grad, ms


def phase_fusions(card):
    """Every registry fusion and IntermediateFusion over it at CUB's widths
    (mi3 at Scene's), B = 100, on the card against float64; mi3's peak
    memory under no_grad."""
    from disentagled_multimodal_fusion_tpu_torch.models.baselines import IntermediateFusion
    from disentagled_multimodal_fusion_tpu_torch.models.fusions import (
        INTERMEDIATE_FUSIONS,
        build_fusion,
    )

    out = {}
    for name in INTERMEDIATE_FUSIONS:
        dims = SCENE_DIMS if name == "mi3" else CUB_DIMS
        g = torch.Generator().manual_seed(0)
        views = [torch.randn(100, d, generator=g) for d in dims]
        fusion, _ = build_fusion(name, dims, generator=torch.Generator().manual_seed(1))
        model = IntermediateFusion(dims, 10, torch.Generator().manual_seed(2), fusion=name).eval()
        out[name] = {"fusion": _check_on_card(fusion, views, name, card),
                     "intermediate": _check_on_card(model, views, f"intermediate {name}", card)}
    mi3, _ = build_fusion("mi3", SCENE_DIMS, generator=torch.Generator().manual_seed(1))
    mi3 = mi3.cuda()
    xs = [torch.randn(100, d).cuda() for d in SCENE_DIMS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with torch.no_grad():
        mi3(xs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    per_sample = 4 * 100 * SCENE_DIMS[1] * SCENE_DIMS[2] * 64
    log(f"fusion mi3 at Scene's widths, B=100: peak {peak / 2**20:.2f} MiB above the inputs "
        f"and parameters (the per-sample weight tensor would take {per_sample / 2**20:.1f} "
        f"MiB) [{card}]")
    if not peak < MI3_PEAK_BYTES:
        raise AssertionError(f"mi3 forward allocated {peak} bytes >= {MI3_PEAK_BYTES}")
    return out, peak


# phase 19: the fusions of the CUB intermediate cell, the JAX package's CPU
# accuracies on it (ISSUE context: JAX runners/run.py, seed 0, full depth)
CUB_FUSIONS = ("concat_linear", "mi_matrix", "mi_vector", "tensor", "lrtf", "lft", "mi3")
JAX_CUB_ACCURACY = {"intermediate_mi_matrix": 0.1250, "intermediate_tensor": 0.1250}
FLOORS = {**{m: 0.85 for m in ("dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion",
                               "cml_fusion", "avg_fusion")},
          **{m: 0.80 for m in ("intermediate_fusion", "intermediate_concat_linear",
                               "intermediate_mi_vector", "intermediate_lrtf")}}


def _finite_row(name, info):
    fused = info["fused"]
    values = [fused[k] for k in ("accuracy", "ece", "evidence_mean", "epistemic_mean",
                                 "aleatoric_mean")]
    if not all(np.isfinite(values)):
        raise AssertionError(f"{name}: non-finite fused metrics {values}")


def _cub_head_shapes(epochs):
    from disentagled_multimodal_fusion_tpu_torch.data.multiview import DATASET_REGISTRY

    c = DATASET_REGISTRY["CUB"]().num_classes
    per_fit = epochs + 1  # each validation epoch and the evaluation
    return {shape_key(2, 120, 200, 128, c): per_fit,           # dmvae_dis
            shape_key(3, 120, 200, 128, c): 2 * per_fit,       # dmvae_cml, dmvae_joint
            shape_key(2, 120, max(CUB_DIMS), 128, c): 3 * per_fit}  # the late fusions


def _run_cub_cell(ck, pm, card, argv, label):
    """runners/run.py main on the CUB Normal cell of seed 0 with ``argv``:
    (rows, epoch launches, head launches, head launches by shape, wall, the
    backbone fits' seconds)."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    fits, real = [], runner.fit_backbone

    def fit_backbone(**kw):  # the backbone's fit time, which the rows do not carry
        out = real(**kw)
        fits.append(out[2]["backbone_fit_seconds"])
        return out

    runner.fit_backbone = fit_backbone
    try:
        with head_shape_tally() as shapes:
            pm.run_epoch_kernel.launches = 0
            ck.evidential_heads_stacked.launches = 0
            t0 = time.perf_counter()
            rows = runner.main(["--seeds", "0", "--datasets", "CUB", "--conditions", "Normal",
                                "--probe-engine", "megakernel", *argv])
            wall = time.perf_counter() - t0
            epochs, heads = pm.run_epoch_kernel.launches, ck.evidential_heads_stacked.launches
    finally:
        runner.fit_backbone = real
    log(f"{label}: CUB Normal seed 0 in {wall:.1f} s; probe_epoch launched {epochs} times, "
        f"evidential_head {heads} times (by shape {dict(shapes)}) [{card}]")
    return rows, epochs, heads, dict(shapes), wall, fits


def _check_cub_cell(rows, epochs, heads, shapes, probe_epochs, label, card):
    models = rows[0]["Normal"]["CUB"]
    for name, info in models.items():
        if "skipped" in info:
            log(f"{label} {name}: skipped ({info['skipped']})")
            continue
        _finite_row(name, info)
        acc = info["fused"]["accuracy"]
        jax_acc = (f" (the JAX package on the CPU: {JAX_CUB_ACCURACY[name]:.4f})"
                   if name in JAX_CUB_ACCURACY else "")
        log(f"{label} {name}: fused accuracy {acc:.4f}{jax_acc}, fit {info['fit_seconds']:.2f} "
            f"s, {1e3 * info['fit_seconds'] / probe_epochs:.3f} ms/epoch [{card}]")
        if name in FLOORS and not acc >= FLOORS[name]:
            raise AssertionError(f"{label} {name} fused accuracy {acc:.4f} < {FLOORS[name]}")
    if epochs != 3 * probe_epochs:
        raise AssertionError(f"{label}: probe_epoch launched {epochs} times, expected "
                             f"{3 * probe_epochs}")
    expected = _cub_head_shapes(probe_epochs)
    if shapes != expected or heads != sum(expected.values()):
        raise AssertionError(f"{label}: evidential_head launched {heads} times, by shape "
                             f"{shapes}, expected {expected}")
    return models


def phase_intermediate(ck, pm, card):
    """The CUB intermediate-fusion cell at full width and depth, then its
    resume from the rows file. Returns (rows, epoch launches, head launches,
    head launches by shape, the DMVAE fit's ms/epoch)."""
    import io

    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config())
    probe_epochs, bb_epochs = C("probes.model_epochs"), C("dmvae.num_epochs")
    with artifact_root("intermediate_") as root:
        argv = ["--include-intermediate", "--intermediate-fusion", *CUB_FUSIONS, "--rows-file",
                str(Path(root) / "rows.json")]
        rows, epochs, heads, shapes, wall, fits = _run_cub_cell(ck, pm, card, argv,
                                                                "intermediate")
        models = _check_cub_cell(rows, epochs, heads, shapes, probe_epochs, "intermediate", card)
        fitted = [m for m, info in models.items() if "skipped" not in info]
        # the six heads, concat and every fusion but mi3, which CUB's two views skip
        if len(fitted) != 6 + len(CUB_FUSIONS) or models.get("intermediate_mi3", {}).get(
                "skipped") != (
                "mi3 fuses exactly 3 views, got 2"):
            raise AssertionError(f"intermediate: rows {sorted(models)}")
        bb_ms = 1e3 * fits[0] / bb_epochs
        # the same command again: everything is in the rows file
        calls = []
        real = runner.run_condition
        runner.run_condition = lambda **kw: calls.append(kw) or real(**kw)
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                again = _run_cub_cell(ck, pm, card, argv, "intermediate resume")
        finally:
            runner.run_condition = real
        text = out.getvalue()
        log(text.rstrip())
        if "--rows-file: resuming; 1 completed cell(s) found" not in text:
            raise AssertionError("intermediate resume: no resume line")
        if calls or again[5] or again[1] or again[2] or again[4] > 60.0:
            raise AssertionError(f"intermediate resume trained: {len(calls)} cells, "
                                 f"{again[1]} + {again[2]} launches, {again[4]:.1f} s")
        if json.dumps(again[0], sort_keys=True) != json.dumps(rows, sort_keys=True):
            raise AssertionError("intermediate resume: the rows differ")
    log(f"intermediate: {len(fitted)} fits and a skip row in {wall:.1f} s; fused DMVAE {bb_ms:.3f} "
        f"ms/epoch; resumed in {again[4]:.1f} s with nothing trained [{card}]")
    return rows, epochs, heads, shapes, bb_ms


def phase_unfused_dmvae(ck, pm, card, fused_bb_ms):
    """The CUB cell's six base models over the per-modality DMVAE."""
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config())
    probe_epochs, bb_epochs = C("probes.model_epochs"), C("dmvae.num_epochs")
    with artifact_root("unfused_"):
        rows, epochs, heads, shapes, _, fits = _run_cub_cell(ck, pm, card,
                                                             ["--no-fused-dmvae"], "unfused")
    models = _check_cub_cell(rows, epochs, heads, shapes, probe_epochs, "unfused", card)
    if len(models) != 6:
        raise AssertionError(f"unfused: {len(models)} models")
    bb_ms = 1e3 * fits[0] / bb_epochs
    log(f"unfused DMVAE fit {bb_ms:.3f} ms/epoch, fused {fused_bb_ms:.3f} ms/epoch "
        f"(CUB, batch 100) [{card}]")
    return epochs, heads, shapes, bb_ms


def _file_mentions(path, needle):
    """Whether the text file at ``path`` holds ``needle``, read in chunks."""
    tail = ""
    with open(path, encoding="utf-8", errors="replace") as f:
        while True:
            block = f.read(1 << 24)
            if not block:
                return False
            if needle in tail + block:
                return True
            tail = block[-len(needle):]


def phase_seed_batched_profile(ck, card):
    """Scene's quick Normal cell, seeds 0 and 1, --vmap-seeds with mi3,
    tensor and lrtf, under --profile."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    with artifact_root("profile_") as root, head_shape_tally() as shapes:
        ck.evidential_heads_stacked.launches = 0
        t0 = time.perf_counter()
        rows = runner.main(["--vmap-seeds", "--seeds", "0", "1", "--datasets", "Scene",
                            "--conditions", "Normal", "--quick", "--intermediate-fusion", "mi3",
                            "tensor", "lrtf", "--profile"])
        wall = time.perf_counter() - t0
        heads = ck.evidential_heads_stacked.launches
        trace = Path(root) / "logs" / "traces" / "uq_sweep" / "trace.json"
        size = trace.stat().st_size
        if not _file_mentions(trace, "evidential_heads_kernel"):
            raise AssertionError(f"{trace} does not name the head kernel")
    for seed in (0, 1):
        models = rows[seed]["Normal"]["Scene"]
        if len(models) != 9:
            raise AssertionError(f"profile: seed {seed} rows {sorted(models)}")
        for name, info in models.items():
            _finite_row(name, info)
            log(f"profile seed {seed} {name}: fused accuracy {info['fused']['accuracy']:.4f}, "
                f"fit {info['fit_seconds']:.2f} s [{card}]")
    if heads != 6 * 3 or sum(shapes.values()) != heads:
        raise AssertionError(f"profile: evidential_head launched {heads} times "
                             f"({dict(shapes)}), expected 18")
    log(f"profile: Scene --vmap-seeds --quick in {wall:.1f} s; trace {size / 2**20:.1f} MiB "
        f"names evidential_heads_kernel; evidential_head {heads} times (by shape "
        f"{dict(shapes)}) [{card}]")
    return heads, dict(shapes)


# phase 22: the LUMA corpus, cut in rows (not width, not classes) to fit the
# script's time: 42 + 8 OOD classes of 100 train and 20 test rows
LUMA_CORPUS = dict(n_classes=42, train_per_class=100, test_per_class=20, ood_classes=8, seed=0)
LUMA_LATE_FLOOR = 0.07  # three times chance (1/42)
# the JAX package's fused accuracies on this corpus on the CPU, hash seed 0
# (PERF.md section 6, PR 10); the card's text features hash with another seed
JAX_LUMA_ACCURACY = {"dmvae_dis": 0.0238, "dmvae_cml": 0.0238, "dmvae_joint": 0.0238,
                     "dbf_fusion": 0.2190, "cml_fusion": 0.1893, "avg_fusion": 0.2143,
                     "intermediate_fusion": 0.0476}


class _Tee:
    """Writes to the real standard output and keeps a copy."""

    def __init__(self):
        self.out, self.parts = sys.stdout, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def _luma_head_shapes(epochs, test_rows, ood_rows):
    """The head kernel's launches of the LUMA protocol with --ood-eval: per
    stacked-head fit one per validation epoch, one for its evaluation and
    one for the ID evidences on the test rows, and one for the OOD rows."""
    per_fit = epochs + 2
    return {shape_key(3, test_rows, 200, 128, 42): 4 * per_fit,  # dmvae_dis, the late fusions
            shape_key(4, test_rows, 200, 128, 42): 2 * per_fit,  # dmvae_cml, dmvae_joint
            shape_key(3, ood_rows, 200, 128, 42): 4,
            shape_key(4, ood_rows, 200, 128, 42): 2}


class _Recorder:
    """A fit's randomness on the CPU whose draws are kept for a replay."""

    def __init__(self, randomness):
        self.randomness, self.draws = randomness, []

    def __getattr__(self, name):
        def draw(*args):
            out = getattr(self.randomness, name)(*args)
            self.draws.append(out)
            return out
        return draw


class _Replay:
    """The recorded draws, in order, on ``device``."""

    def __init__(self, draws, device):
        self.draws, self.device = list(draws), device

    def __getattr__(self, name):
        return lambda *args: self.draws.pop(0).to(self.device)


# each gradient's gap in Frobenius norm over its norm: three times the largest
# of 2400 readings on the card (1.55e-2, PERF.md section 2); a sample within
# rounding of a kink (a ReLU, the evidence's clip at 10) moves its whole
# contribution to the step's gradient
LUMA_GRAD_TOL = 5e-2


def luma_step_gaps(got, ref):
    """Two readings of one LUMA step from the same state (``_step_reading``):
    the step's loss and the validation loss after it, and each running
    statistic's largest entry, as gaps over rtol 1e-4 / atol 1e-5; each
    gradient's gap in Frobenius norm over its norm ("grad") and its largest
    entry's gap over its largest abs value ("grad_max", not held: a sample
    on the other side of a ReLU after a BatchNorm moves single entries).
    The convolutions' biases are left out: their true gradient is 0 under
    the BatchNorm after them, and what is left is rounding."""
    out = {key: abs(got[key] - ref[key]) / (ATOL + RTOL * abs(ref[key]))
           for key in ("loss", "val_loss")}
    for key, g in ref["grads"].items():
        if not (".conv." in key and key.endswith(".bias")):
            diff = got["grads"][key] - g
            out[f"grad {key}"] = float(diff.norm() / g.norm().clamp_min(1e-30))
            out[f"grad_max {key}"] = float(diff.abs().max() / g.abs().max().clamp_min(1e-30))
    for key, st in ref["stats"].items():
        out[f"stat {key}"] = float(((got["stats"][key] - st).abs()
                                    / (ATOL + RTOL * st.abs())).max())
    return out


# phase 24's bf16 step (the heads in bf16, the encoders float32) is held to
# the same limits: its first 40 readings on the card came to 0.285 of the
# loss's, 0.150 of the validation's, 6.6e-4 of the statistics' and 2.65e-3
# in gradient norm (PERF.md section 2)
LUMA_STEP_LIMITS = {"loss": 1.0, "val_loss": 1.0, "stat": 1.0, "grad": LUMA_GRAD_TOL}


def luma_step_faults(gaps):
    """The gaps of ``luma_step_gaps`` beyond ``LUMA_STEP_LIMITS``."""
    return {key: round(v, 6) for key, v in gaps.items()
            if key.split()[0] in LUMA_STEP_LIMITS
            and not v <= LUMA_STEP_LIMITS[key.split()[0]]}


def check_luma_step(got, ref, label):
    """``luma_step_gaps`` held to ``LUMA_STEP_LIMITS``; returns the largest
    gap of each kind."""
    gaps = luma_step_gaps(got, ref)
    bad = luma_step_faults(gaps)
    if bad:
        raise AssertionError(f"{label}: beyond the limits {bad}")
    worst = {}
    for key, v in gaps.items():
        kind = key.split()[0]
        worst[kind] = max(worst.get(kind, 0.0), v)
    return worst


def _step_reading(loss, val_loss, names, moments, stats):
    """One step's loss, validation loss, gradients (a fresh Adam's first
    moment after one step is (1 - beta1) g) and running statistics."""
    from disentagled_multimodal_fusion_tpu_torch.ops.adam import B1

    return {"loss": float(loss), "val_loss": float(val_loss),
            "grads": {n: m.detach().cpu() / (1.0 - B1) for n, (m, _) in zip(names, moments)},
            "stats": {k: v.detach().cpu().clone() for k, v in stats.items()}}


def _luma_step_setup(corpus):
    """The config, encoder specs, classes, first 640 train rows, first 200
    test rows and batch size of the LUMA step checks."""
    from disentagled_multimodal_fusion_tpu_torch.data.luma import get_luma_arrays
    from disentagled_multimodal_fusion_tpu_torch.runners import run_luma
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config("luma_config.yaml"))
    audio, text, image = run_luma.feature_configs(C)
    specs = run_luma.encoder_specs(audio, text)
    xs_tr, y_tr, xs_te, y_te, classes, _, _ = get_luma_arrays(corpus, audio, text, image)
    n, n_val = min(640, len(y_tr)), min(200, len(y_te))
    return (C, specs, classes, ([x[:n] for x in xs_tr], y_tr[:n]),
            ([x[:n_val] for x in xs_te], y_te[:n_val]), C("dataloader.batch_size"))


def _luma_rows(split, device, rows=slice(None)):
    from disentagled_multimodal_fusion_tpu_torch.runners import run_luma

    xs, y = split
    return {"xs": run_luma.to_device([x[rows] for x in xs], device),
            "y": torch.from_numpy(y[rows]).to(device)}


def _luma_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _trainable(model):
    return [n for n, p in model.named_parameters() if p.requires_grad]


def _stats(model):
    from disentagled_multimodal_fusion_tpu_torch.core.train import model_state_names

    state = model.state_dict()
    return {k: state[k] for k in model_state_names(model)}


def phase_luma_card_vs_cpu(card, corpus, device="cuda", trial=0, check=True, dtype=None):
    """One cml_fusion epoch over the LUMA encoders on the cut corpus's first
    640 train rows, held step by step on the card against the CPU. At each
    step of 64 rows both sides take a one-step fit at lr 0 from the CPU's
    state with the CPU's draws (``check_luma_step``: the loss, the
    validation on 200 rows, the gradients and the running statistics);
    then the CPU takes the step at the config's lr. The parameters after a
    step are not compared: Adam turns gradients at rounding level into
    steps of lr of either sign, and over an epoch the two trajectories part
    by up to 8 lr (PERF.md section 2). ``trial`` k draws the weights and
    draws from other generators; without ``check`` nothing is held, and it
    returns each step's ``luma_step_gaps``. With ``dtype="bfloat16"`` both
    sides build the heads in bf16 (phase 24)."""
    import dataclasses

    from disentagled_multimodal_fusion_tpu_torch.core.train import Randomness, train
    from disentagled_multimodal_fusion_tpu_torch.runners import run_luma

    C, specs, classes, tr, te, batch = _luma_step_setup(corpus)
    steps = len(tr[1]) // batch
    recorder = _Recorder(Randomness(16 * trial + 8, "cpu"))
    sides = {"cpu": "cpu", "card": device}
    tasks = {side: run_luma.head_builders(C, classes, 1, specs, dev, dtype)["cml_fusion"](
        16 * trial + 6) for side, dev in sides.items()}
    label = "luma card vs CPU" + ("" if dtype is None else f" ({dtype})")
    val = {side: _luma_rows(te, dev) for side, dev in sides.items()}
    frozen = dataclasses.replace(tasks["cpu"].optimizer, lr=0.0)
    readings, worst, secs = [], {}, {"cpu": 0.0, "card": 0.0}
    for k in range(steps):
        before, first, got = _luma_state(tasks["cpu"].model), len(recorder.draws), {}
        for side, dev in sides.items():
            task = tasks[side]
            if side == "card":
                task.model.load_state_dict(before)
            t0 = time.perf_counter()
            res = train(model=task.model, loss_fn=task.loss_fn, n_train=batch,
                        data=_luma_rows(tr, dev, slice(k * batch, (k + 1) * batch)),
                        optimizer=frozen, epochs=1, batch_size=batch,
                        randomness=(recorder if side == "cpu"
                                    else _Replay(recorder.draws[first:], dev)),
                        val_fn=task.val_fn, val_data=val[side])
            secs[side] += time.perf_counter() - t0
            got[side] = _step_reading(res.train_loss[0], res.val_loss[0],
                                      _trainable(task.model), res.state.moments,
                                      _stats(task.model))
        if not check:
            readings.append(luma_step_gaps(got["card"], got["cpu"]))
        else:
            for kind, gap in check_luma_step(got["card"], got["cpu"],
                                             f"{label} step {k}").items():
                worst[kind] = max(worst.get(kind, 0.0), gap)
        task = tasks["cpu"]
        train(model=task.model, loss_fn=task.loss_fn, n_train=batch,
              data=_luma_rows(tr, "cpu", slice(k * batch, (k + 1) * batch)),
              optimizer=task.optimizer, epochs=1, batch_size=batch, randomness=recorder)
    if not check:
        return readings
    log(f"{label}: cml_fusion, {steps} steps of {batch} rows, each from the CPU's "
        f"state: last step's loss {got['card']['loss']:.6f} (CPU {got['cpu']['loss']:.6f}), "
        f"val loss {got['card']['val_loss']:.6f} (CPU {got['cpu']['val_loss']:.6f}); largest "
        f"gaps {worst}; steps {secs['card']:.2f} s on the card, "
        f"{secs['cpu']:.2f} s on the CPU [{card}]")


def luma_corpus(root):
    """Phase 22's corpus (``LUMA_CORPUS``) under ``root``; phase 23 reads it
    and its feature cache too."""
    from disentagled_multimodal_fusion_tpu_torch.data.luma import make_fake_luma

    t0 = time.perf_counter()
    corpus = make_fake_luma(str(Path(root) / "corpus"), **LUMA_CORPUS)
    log(f"luma: corpus of {LUMA_CORPUS} written in {time.perf_counter() - t0:.1f} s")
    return corpus


def phase_luma(ck, pm, card, root, corpus):
    """The LUMA protocol, runners/run_luma.py main, seed 0, --ood-eval
    --include-intermediate --rows-file, at the config's full width and depth
    on a corpus cut in rows; its resume; runners/evaluate.py on its
    checkpoints; and the card against the CPU. Returns the head kernel's
    launches, its launches by shape, and the DMVAE's and each model's fit
    seconds."""
    from disentagled_multimodal_fusion_tpu_torch.runners import evaluate, run_luma
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config("luma_config.yaml"))
    probe_epochs, dmvae_epochs = C("probes.model_epochs"), C("dmvae.num_epochs")
    test_rows = LUMA_CORPUS["n_classes"] * LUMA_CORPUS["test_per_class"]
    ood_rows = LUMA_CORPUS["ood_classes"] * LUMA_CORPUS["test_per_class"]
    t_phase = time.perf_counter()
    argv = ["--data-path", corpus, "--seeds", "0", "--ood-eval", "--include-intermediate",
            "--rows-file", str(Path(root) / "rows.json")]
    tee = _Tee()
    with head_shape_tally() as shapes, contextlib.redirect_stdout(tee):
        pm.run_epoch_kernel.launches = 0
        ck.evidential_heads_stacked.launches = 0
        t0 = time.perf_counter()
        rows = run_luma.main(argv)
        wall = time.perf_counter() - t0
        epochs, heads = pm.run_epoch_kernel.launches, ck.evidential_heads_stacked.launches
    text = tee.text()
    feat_s = float(re.search(r"featurized in ([0-9.]+) s", text).group(1))
    dmvae_s = float(re.search(r"DMVAE trained: ([0-9.]+) s", text).group(1))
    models = rows[0]["Normal"]["LUMA"]
    want = ["dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion",
            "avg_fusion", "intermediate_fusion"]
    if sorted(models) != sorted(want):
        raise AssertionError(f"luma: rows {sorted(models)}")
    log(f"luma: featurization {feat_s:.2f} s, DMVAE fit {dmvae_s:.2f} s "
        f"({1e3 * dmvae_s / dmvae_epochs:.3f} ms/epoch) [{card}]")
    for name in want:
        info = models[name]
        _finite_row(name, info)
        ood = info["ood"]
        if sorted(ood) != ["auroc_aleatoric", "auroc_epistemic", "auroc_neg_evidence"] or \
                not all(0.0 <= v <= 1.0 for v in ood.values()):
            raise AssertionError(f"luma {name}: OOD AUROCs {ood}")
        acc = info["fused"]["accuracy"]
        jax_acc = (f" (the JAX package on the CPU: {JAX_LUMA_ACCURACY[name]:.4f})"
                   if name in JAX_LUMA_ACCURACY else "")
        log(f"luma {name}: fused accuracy {acc:.4f}{jax_acc}, fit {info['fit_seconds']:.2f} s,"
            f" {1e3 * info['fit_seconds'] / probe_epochs:.3f} ms/epoch, OOD AUROC "
            + ", ".join(f"{k[6:]} {v:.4f}" for k, v in ood.items()) + f" [{card}]")
        if name.endswith("_fusion") and name != "intermediate_fusion" \
                and not acc >= LUMA_LATE_FLOOR:
            raise AssertionError(f"luma {name} fused accuracy {acc:.4f} < {LUMA_LATE_FLOOR}")
    if epochs:
        raise AssertionError(f"luma: probe_epoch launched {epochs} times, expected 0")
    expected = _luma_head_shapes(probe_epochs, test_rows, ood_rows)
    if dict(shapes) != expected or heads != sum(expected.values()):
        raise AssertionError(f"luma: evidential_head launched {heads} times, by shape "
                             f"{dict(shapes)}, expected {expected}")
    log(f"luma: protocol in {wall:.1f} s; probe_epoch launched 0 times, evidential_head "
        f"{heads} times (by shape {dict(shapes)}) [{card}]")

    # the same command again: every seed is in the rows file
    calls, real = [], run_luma.run_seed
    run_luma.run_seed = lambda **kw: calls.append(kw) or real(**kw)
    tee = _Tee()
    try:
        with contextlib.redirect_stdout(tee):
            pm.run_epoch_kernel.launches = 0
            ck.evidential_heads_stacked.launches = 0
            t0 = time.perf_counter()
            again = run_luma.main(argv)
            resume_s = time.perf_counter() - t0
            launched = pm.run_epoch_kernel.launches + ck.evidential_heads_stacked.launches
    finally:
        run_luma.run_seed = real
    if "--rows-file: resuming; 1 completed seed(s) found [0]" not in tee.text():
        raise AssertionError("luma resume: no resume line")
    if calls or launched:
        raise AssertionError(f"luma resume trained: {len(calls)} seeds, {launched} launches")
    if json.dumps(again[0], sort_keys=True) != json.dumps(rows[0], sort_keys=True):
        raise AssertionError("luma resume: the rows differ")
    log(f"luma: resumed in {resume_s:.1f} s with nothing trained")

    for name in ("dmvae_cml", "cml_fusion"):
        with contextlib.redirect_stdout(io.StringIO()):
            info = evaluate.main(["--model", name, "--dataset", "LUMA", "--seed", "0",
                                  "--data-path", corpus])
        got, want_acc = info["fused"]["accuracy"], models[name]["fused"]["accuracy"]
        if got != want_acc:
            raise AssertionError(f"luma evaluate.py {name}: fused accuracy {got}, the run "
                                 f"{want_acc}")
        log(f"luma: evaluate.py {name} from its checkpoints: fused accuracy {got:.4f}, as "
            f"the run reported [{card}]")
    phase_luma_card_vs_cpu(card, corpus)
    log(f"luma: phase 22 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    fits = {"dmvae": dmvae_s, **{name: models[name]["fit_seconds"] for name in want}}
    return heads, dict(shapes), fits


def _luma_stacked_head_shapes(epochs, seeds, test_rows, ood_rows):
    """The head kernel's launches of ``run_luma.py --vmap-seeds --ood-eval``:
    per stacked-head fit one launch at S x V heads per validation epoch,
    then per seed one for its evaluation, one for the ID and one for the OOD
    evidences at V heads; intermediate concat's one head is plain."""
    s = len(seeds)
    return {shape_key(3 * s, test_rows, 200, 128, 42): 4 * epochs,  # dmvae_dis, late fusions
            shape_key(4 * s, test_rows, 200, 128, 42): 2 * epochs,  # dmvae_cml, dmvae_joint
            shape_key(3, test_rows, 200, 128, 42): 4 * s * 2,
            shape_key(4, test_rows, 200, 128, 42): 2 * s * 2,
            shape_key(3, ood_rows, 200, 128, 42): 4 * s,
            shape_key(4, ood_rows, 200, 128, 42): 2 * s}


def phase_luma_many_vs_train(card, corpus, n_seeds=len(SEEDS), trial=0, check=True,
                             device="cuda"):
    """One cml_fusion epoch on the cut corpus's first 640 train rows, held
    step by step seed-batched against per seed on the card. At each step of
    64 rows one ``train_many`` with each seed's BatchNorm statistics and
    each seed's ``train`` take a one-step fit at lr 0 from the seeds' states
    and generators (``check_luma_step``, phase 22's: batched and single
    cuDNN convolutions sum in another order); then each seed takes the step
    at the config's lr. ``trial`` k takes the seeds k n_seeds onwards;
    without ``check`` nothing is held, and it returns each step and seed's
    ``luma_step_gaps``."""
    import dataclasses

    from disentagled_multimodal_fusion_tpu_torch.core.train import (
        Randomness,
        stack_model_state,
        stack_params,
        train,
        train_many,
    )
    from disentagled_multimodal_fusion_tpu_torch.runners import run_luma

    C, specs, classes, tr, te, batch = _luma_step_setup(corpus)
    steps = len(tr[1]) // batch
    seeds = [n_seeds * trial + s for s in range(n_seeds)]
    build = run_luma.head_builders(C, classes, 1, specs, device)["cml_fusion"]
    tasks = [build(16 * u + 6) for u in seeds]
    rands = [Randomness(16 * u + 10, device) for u in seeds]
    models = [t.model for t in tasks]
    frozen = dataclasses.replace(tasks[0].optimizer, lr=0.0)
    fit = dict(n_train=batch, epochs=1, batch_size=batch, val_data=_luma_rows(te, device))
    readings, worst, many_s, seq_s = [], {}, 0.0, 0.0
    for k in range(steps):
        part = _luma_rows(tr, device, slice(k * batch, (k + 1) * batch))
        starts = []
        for r in rands:
            starts.append(Randomness(0, device))
            starts[-1].restore(r.state())
        sync(device)
        t0 = time.perf_counter()
        many = train_many(model=models[0], params=stack_params(models), loss_fn=tasks[0].loss_fn,
                          model_state=stack_model_state(models), data=part, randomness=starts,
                          optimizer=frozen, val_fn=tasks[0].val_fn, data_broadcast=True, **fit)
        sync(device)
        many_s += time.perf_counter() - t0
        for s, task in enumerate(tasks):
            t0 = time.perf_counter()
            one = train(model=task.model, loss_fn=task.loss_fn, randomness=rands[s], data=part,
                        optimizer=frozen, val_fn=task.val_fn, **fit)
            seq_s += time.perf_counter() - t0
            want = _step_reading(one.train_loss[0], one.val_loss[0], _trainable(task.model),
                                 one.state.moments, _stats(task.model))
            got = _step_reading(many.train_loss[s, 0], many.val_loss[s, 0], list(many.params),
                                [(m[s], v[s]) for m, v in many.state.moments],
                                {key: v[s] for key, v in many.state.model_state.items()})
            if not check:
                readings.append(luma_step_gaps(got, want))
                continue
            for kind, gap in check_luma_step(
                    got, want, f"luma train_many vs train step {k} seed {s}").items():
                worst[kind] = max(worst.get(kind, 0.0), gap)
        for task, r in zip(tasks, rands):
            train(model=task.model, loss_fn=task.loss_fn, randomness=r, data=part,
                  optimizer=task.optimizer, **{**fit, "val_data": None})
    if not check:
        return readings
    log(f"luma train_many vs train: {n_seeds} seeds of cml_fusion, {steps} steps of {batch} "
        f"rows, each from the seeds' states: largest gaps {worst}; train_many "
        f"{many_s:.2f} s, the train steps {seq_s:.2f} s [{card}]")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# evaluate.py re-runs seed 0's bf16 checkpoints in float32: its fused
# accuracy may differ from the bf16 run's by the rows whose argmax the
# rounding flips, 0-3 of 840 in five runs on the card (0.0035 at most);
# 0.01 is 8 rows, while a restore that lost the BatchNorm statistics or a
# head would fall to chance (1/42 = 0.024) from cml_fusion's 0.23-0.29
LUMA_BF16_EVAL_GAP = 0.01


def phase_luma_bf16(ck, pm, card, corpus, seq_fits):
    """The LUMA protocol in bf16 on phase 22's corpus and feature cache, at
    the config's full width and depth: runners/run_luma.py --dtype bfloat16
    --ood-eval --include-intermediate, sequentially on seed 0 and with
    --vmap-seeds --segment-epochs 2 on seeds 0-4. Late fusion >= 0.07 for
    every seed, every row finite; the head kernel's bf16 build at exactly
    phase 22's and 23's shapes and counts, its f32 build and the epoch
    kernel never; runners/evaluate.py (float32) on seed 0's bf16
    checkpoints within ``LUMA_BF16_EVAL_GAP`` of the run's fused accuracy;
    and one bf16 cml_fusion epoch step by
    step on the card against the CPU (``check_luma_step``). Returns
    the bf16 launches {engine: count} and their shapes."""
    from disentagled_multimodal_fusion_tpu_torch.runners import evaluate, run_luma
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config("luma_config.yaml"))
    probe_epochs = C("probes.model_epochs")
    test_rows = LUMA_CORPUS["n_classes"] * LUMA_CORPUS["test_per_class"]
    ood_rows = LUMA_CORPUS["ood_classes"] * LUMA_CORPUS["test_per_class"]
    want = ["dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion",
            "intermediate_fusion"]
    engines = {
        "sequential": (["--seeds", "0"], [0],
                       _luma_head_shapes(probe_epochs, test_rows, ood_rows)),
        "seed-batched": (["--vmap-seeds", "--seeds", *map(str, SEEDS), "--segment-epochs", "2"],
                         list(SEEDS),
                         _luma_stacked_head_shapes(probe_epochs, SEEDS, test_rows, ood_rows)),
    }
    launches, all_shapes = {}, {}
    for engine, (flags, seeds, expected) in engines.items():
        expected = {f"{key},bf16": n for key, n in expected.items()}
        with artifact_root(f"luma_bf16_{engine}_"):
            with head_shape_tally() as shapes, contextlib.redirect_stdout(_Tee()) as tee:
                pm.run_epoch_kernel.launches = 0
                ck.evidential_heads_stacked.launches = 0
                ck.evidential_heads_stacked_bf16.launches = 0
                t0 = time.perf_counter()
                rows = run_luma.main(["--data-path", corpus, *flags, "--ood-eval",
                                      "--include-intermediate", "--dtype", "bfloat16"])
                wall = time.perf_counter() - t0
                epochs, f32_heads = (pm.run_epoch_kernel.launches,
                                     ck.evidential_heads_stacked.launches)
                heads = ck.evidential_heads_stacked_bf16.launches
            dmvae_s = float(re.search(r"DMVAE (?:x\d+ seeds )?trained: ([0-9.]+) s",
                                      tee.text()).group(1))
            for s in seeds:
                models = rows[s]["Normal"]["LUMA"]
                if sorted(models) != sorted(want):
                    raise AssertionError(f"luma bf16 {engine} seed {s}: rows {sorted(models)}")
                for name in want:
                    _finite_row(f"bf16 {engine} seed {s} {name}", models[name])
                    if not all(0.0 <= v <= 1.0 for v in models[name]["ood"].values()):
                        raise AssertionError(f"luma bf16 seed {s} {name}: OOD "
                                             f"{models[name]['ood']}")
                    acc = models[name]["fused"]["accuracy"]
                    if name in ("dbf_fusion", "cml_fusion", "avg_fusion") \
                            and not acc >= LUMA_LATE_FLOOR:
                        raise AssertionError(f"luma bf16 {engine} seed {s} {name} fused "
                                             f"accuracy {acc:.4f} < {LUMA_LATE_FLOOR}")
                log(f"luma bf16 {engine} seed {s}: fused accuracies "
                    + str({n: round(models[n]["fused"]["accuracy"], 4) for n in want}))
            if engine == "sequential":
                for name in ("dmvae_cml", "cml_fusion"):
                    with contextlib.redirect_stdout(io.StringIO()):
                        info = evaluate.main(["--model", name, "--dataset", "LUMA", "--seed",
                                              "0", "--data-path", corpus])
                    got = info["fused"]["accuracy"]
                    run_acc = rows[0]["Normal"]["LUMA"][name]["fused"]["accuracy"]
                    if not abs(got - run_acc) <= LUMA_BF16_EVAL_GAP:
                        raise AssertionError(f"luma bf16 evaluate.py {name}: fused accuracy "
                                             f"{got} (float32), the bf16 run {run_acc}")
                    log(f"luma bf16: evaluate.py {name} (float32) from the bf16 checkpoints: "
                        f"fused accuracy {got:.4f}, the bf16 run {run_acc:.4f} [{card}]")
        first = rows[seeds[0]]["Normal"]["LUMA"]
        log(f"luma bf16 {engine}: DMVAE fit {dmvae_s:.2f} s (phase 22's float32 one seed "
            f"{seq_fits['dmvae']:.2f} s); fits "
            + str({n: round(first[n]["fit_seconds"], 2) for n in want})
            + f" (phase 22's float32 one seed: "
            + str({n: round(seq_fits[n], 2) for n in want}) + f") [{card}]")
        if epochs or f32_heads or dict(shapes) != expected or heads != sum(expected.values()):
            raise AssertionError(f"luma bf16 {engine}: probe_epoch launched {epochs} times, the "
                                 f"f32 head {f32_heads}, the bf16 head {heads} by shape "
                                 f"{dict(shapes)}, expected {expected}")
        log(f"luma bf16 {engine}: seeds {seeds} in {wall:.1f} s; probe_epoch launched 0 times, "
            f"evidential_head f32 0 times, bf16 {heads} times (by shape {dict(shapes)}) [{card}]")
        launches[engine], all_shapes[engine] = heads, dict(shapes)
    phase_luma_card_vs_cpu(card, corpus, dtype="bfloat16")
    return launches, all_shapes


def phase_luma_seed_batched(ck, pm, card, corpus, seq_fits):
    """The seed-batched LUMA protocol, runners/run_luma.py --vmap-seeds
    --seeds 0-4 --ood-eval --include-intermediate --segment-epochs 2
    --rows-file, at the config's full width and depth on phase 22's corpus
    (its feature cache read back); its resume; runners/evaluate.py for seeds
    0 and 4; and train_many against train on the card. Returns the head
    kernel's launches and launches by shape."""
    from disentagled_multimodal_fusion_tpu_torch.runners import evaluate, run_luma
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config("luma_config.yaml"))
    probe_epochs, dmvae_epochs = C("probes.model_epochs"), C("dmvae.num_epochs")
    test_rows = LUMA_CORPUS["n_classes"] * LUMA_CORPUS["test_per_class"]
    ood_rows = LUMA_CORPUS["ood_classes"] * LUMA_CORPUS["test_per_class"]
    t_phase = time.perf_counter()
    root = os.environ["DMF_ARTIFACT_ROOT"]
    argv = ["--data-path", corpus, "--vmap-seeds", "--seeds", *map(str, SEEDS), "--ood-eval",
            "--include-intermediate", "--segment-epochs", "2", "--rows-file",
            str(Path(root) / "rows.json")]
    tee = _Tee()
    with head_shape_tally() as shapes, contextlib.redirect_stdout(tee):
        pm.run_epoch_kernel.launches = 0
        ck.evidential_heads_stacked.launches = 0
        t0 = time.perf_counter()
        rows = run_luma.main(argv)
        wall = time.perf_counter() - t0
        epochs, heads = pm.run_epoch_kernel.launches, ck.evidential_heads_stacked.launches
    text = tee.text()
    if re.search(r"featurized in ([0-9.]+) s", text) is None:
        raise AssertionError("luma seed-batched: no featurization line")
    feat_s = float(re.search(r"featurized in ([0-9.]+) s", text).group(1))
    dmvae_s = float(re.search(rf"DMVAE x{len(SEEDS)} seeds trained: ([0-9.]+) s", text).group(1))
    want = ["dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion",
            "intermediate_fusion"]
    log(f"luma seed-batched: featurization {feat_s:.2f} s (the cache of phase 22); DMVAE x"
        f"{len(SEEDS)} fit {dmvae_s:.2f} s ({1e3 * dmvae_s / dmvae_epochs:.3f} ms/epoch; phase "
        f"22's one seed {seq_fits['dmvae']:.2f} s, {1e3 * seq_fits['dmvae'] / dmvae_epochs:.3f} "
        f"ms/epoch) [{card}]")
    for s in SEEDS:
        models = rows[s]["Normal"]["LUMA"]
        if sorted(models) != sorted(want):
            raise AssertionError(f"luma seed-batched seed {s}: rows {sorted(models)}")
        for name in want:
            info = models[name]
            _finite_row(f"seed {s} {name}", info)
            if not all(0.0 <= v <= 1.0 for v in info["ood"].values()):
                raise AssertionError(f"luma seed-batched seed {s} {name}: OOD {info['ood']}")
            acc = info["fused"]["accuracy"]
            if name in ("dbf_fusion", "cml_fusion", "avg_fusion") and not acc >= LUMA_LATE_FLOOR:
                raise AssertionError(f"luma seed-batched seed {s} {name} fused accuracy "
                                     f"{acc:.4f} < {LUMA_LATE_FLOOR}")
        log(f"luma seed-batched seed {s}: fused accuracies "
            + str({n: round(models[n]["fused"]["accuracy"], 4) for n in want})
            + ", epistemic AUROCs "
            + str({n: round(models[n]["ood"]["auroc_epistemic"], 4) for n in want}))
    for name in want:
        fit_s = rows[SEEDS[0]]["Normal"]["LUMA"][name]["fit_seconds"]
        log(f"luma seed-batched {name} fit x{len(SEEDS)}: {fit_s:.2f} s, "
            f"{1e3 * fit_s / probe_epochs:.3f} ms/epoch (phase 22's one seed: "
            f"{seq_fits[name]:.2f} s, {1e3 * seq_fits[name] / probe_epochs:.3f} ms/epoch) "
            f"[{card}]")
    if epochs:
        raise AssertionError(f"luma seed-batched: probe_epoch launched {epochs} times, expected 0")
    expected = _luma_stacked_head_shapes(probe_epochs, SEEDS, test_rows, ood_rows)
    if dict(shapes) != expected or heads != sum(expected.values()):
        raise AssertionError(f"luma seed-batched: evidential_head launched {heads} times, by "
                             f"shape {dict(shapes)}, expected {expected}")
    log(f"luma seed-batched: seeds {list(SEEDS)} in {wall:.1f} s ({wall / len(SEEDS):.1f} s per "
        f"seed); probe_epoch launched 0 times, evidential_head {heads} times (by shape "
        f"{dict(shapes)}) [{card}]")

    # the same command again: every seed is in the rows file
    calls, real = [], run_luma.run_seeds_batched
    run_luma.run_seeds_batched = lambda **kw: calls.append(kw) or real(**kw)
    tee = _Tee()
    try:
        with contextlib.redirect_stdout(tee):
            pm.run_epoch_kernel.launches = 0
            ck.evidential_heads_stacked.launches = 0
            t0 = time.perf_counter()
            again = run_luma.main(argv)
            resume_s = time.perf_counter() - t0
            launched = pm.run_epoch_kernel.launches + ck.evidential_heads_stacked.launches
    finally:
        run_luma.run_seeds_batched = real
    if "--rows-file: every seed complete, skipping training" not in tee.text():
        raise AssertionError("luma seed-batched resume: no resume line")
    if calls or launched:
        raise AssertionError(f"luma seed-batched resume trained: {len(calls)} calls, "
                             f"{launched} launches")
    if json.dumps(again, sort_keys=True) != json.dumps(rows, sort_keys=True):
        raise AssertionError("luma seed-batched resume: the rows differ")
    log(f"luma seed-batched: resumed in {resume_s:.1f} s with nothing trained")

    for s in (SEEDS[0], SEEDS[-1]):
        for name in ("dmvae_cml", "cml_fusion"):
            with contextlib.redirect_stdout(io.StringIO()):
                info = evaluate.main(["--model", name, "--dataset", "LUMA", "--seed", str(s),
                                      "--data-path", corpus])
            got, ref = info["fused"]["accuracy"], rows[s]["Normal"]["LUMA"][name]["fused"][
                "accuracy"]
            if got != ref:
                raise AssertionError(f"luma seed-batched evaluate.py seed {s} {name}: fused "
                                     f"accuracy {got}, the run {ref}")
            log(f"luma seed-batched: evaluate.py seed {s} {name} from its checkpoints: fused "
                f"accuracy {got:.4f}, as the run reported [{card}]")
    phase_luma_many_vs_train(card, corpus)
    log(f"luma seed-batched: phase 23 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return heads, dict(shapes)


def head_times_only(card):
    """``--head-times``: build the head kernel of whichever package is first
    on the path and print its device and event times at every main-path
    shape as one JSON line. Run from a copy of this script placed in an
    unpacked checkout of another commit, it times that commit's kernel in
    the same call (parent, change, change, parent)."""
    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_build
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck

    configure()
    cuda_build.build([ck.KERNEL_SOURCE])
    rows = {}
    for shape in MAIN_PATH_SHAPES + [(7, 256, 200, 256, 10)]:
        args = head_inputs(*shape, seed=0)
        assert_close(ck.evidential_heads_stacked(*args), ck.evidential_heads_stacked_plain(*args),
                     f"evidential_head {shape_key(*shape)}")
        bound_ms, bound_by = head_bound(*shape)
        rows[shape_key(*shape)] = dict(device_ms=head_device_ms(ck, shape),
                                       events_ms=event_ms(ck.evidential_heads_stacked, args),
                                       bound_ms=bound_ms, bound_by=bound_by)
    print(json.dumps({"package": str(Path(ck.__file__).resolve().parents[1]), "card": card,
                      "head_times": rows}), flush=True)
    return 0


def engine_times_only(card):
    """``--engine-times``: ``runners/run.py --vmap-seeds`` and
    ``--one-program-cells`` on HandWritten Normal and Conflict, seeds 0-4, at
    full depth, each run as a user runs the module (``python -m``), in the
    order one-program, vmap, vmap, one-program. Their reports must agree
    (rtol 1e-6). Prints each run's sweep time and per-cell times as one JSON
    line."""
    import csv
    import os
    import shutil
    import tempfile

    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_build
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck

    configure()
    cuda_build.build([ck.KERNEL_SOURCE])  # the runs find it built
    repo = Path(__file__).resolve().parent
    (repo / "chip_scratch").mkdir(exist_ok=True)
    runs, reports = [], {}
    for i, flag in enumerate(("--one-program-cells", "--vmap-seeds", "--vmap-seeds",
                              "--one-program-cells")):
        root = tempfile.mkdtemp(prefix="engine_times_", dir=repo / "chip_scratch")
        try:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "disentagled_multimodal_fusion_tpu_torch.runners.run",
                 flag, "--seeds", *map(str, SEEDS), "--datasets", "HandWritten",
                 "--conditions", "Normal", "Conflict"],
                cwd=repo, env=dict(os.environ, DMF_ARTIFACT_ROOT=root), capture_output=True,
                text=True, timeout=1500)
            wall = time.perf_counter() - t0
            if proc.returncode:
                raise AssertionError(f"{flag} exited {proc.returncode}: {proc.stderr[-3000:]}")
            lines = proc.stdout.splitlines()
            for line in lines:
                if "done in" in line or "issued in" in line or "dmvae fit" in line:
                    log(f"engine-times run {i} {flag}: {line.strip()} [{card}]")
            sweep = [float(m) for line in lines
                     for m in re.findall(r"^sweep done in ([0-9.]+)s", line)]
            cells = [float(m) for line in lines
                     for m in re.findall(r"\) (?:one-program cell )?done in ([0-9.]+)s", line)]
            if len(sweep) != 1 or len(cells) != 2:
                raise AssertionError(f"{flag}: no sweep or cell times in {lines[-5:]}")
            report = Path(root) / "logs" / "dataset_analysis_all_results.csv"
            with open(report, newline="") as f:
                reports.setdefault(flag, list(csv.DictReader(f)))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        runs.append({"engine": flag, "process_s": wall, "sweep_s": sweep[0], "cells_s": cells})
    a, b = reports["--vmap-seeds"], reports["--one-program-cells"]
    if len(a) != len(b) or len(a) != 2 * 6 * len(SEEDS):
        raise AssertionError(f"report rows: {len(a)} and {len(b)}")
    worst = 0.0
    for ra, rb in zip(a, b):
        if ra.keys() != rb.keys():
            raise AssertionError("the engines' reports have different columns")
        for k, va in ra.items():
            try:
                x, y = float(va), float(rb[k])
            except ValueError:
                if va != rb[k]:
                    raise AssertionError(f"engines differ at {k}: {va} vs {rb[k]}") from None
                continue
            if abs(x - y) > 1e-6 * abs(y):
                raise AssertionError(f"engines differ at {ra.get('model')} {k}: {x} vs {y}")
            worst = max(worst, abs(x - y))
    log(f"engine-times: the two engines' reports agree over {len(a)} rows "
        f"(max abs difference {worst:.3e})")
    print(json.dumps({"card": card, "engine_times": runs}), flush=True)
    return 0


def luma_state_trials(card, trials):
    """``--luma-state-trials N``: phase 22's card-vs-CPU steps, phase 23's
    ``train_many``-vs-``train`` steps (five seeds) and phase 24's bf16
    card-vs-CPU steps N times, each time
    from other weights and draws, on phase 22's corpus. Holds nothing:
    prints, per comparison, how many trials and readings (one per step, and
    seed) ``check_luma_step`` would refuse, and the largest gap of each
    loss, gradient and statistic (``luma_step_gaps``), as one JSON line."""
    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_build
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck

    configure()
    cuda_build.build([ck.KERNEL_SOURCE])
    runs = {"card_vs_cpu": [], "many_vs_train": [], "card_vs_cpu_bf16": []}
    with artifact_root("luma_trials_") as root:
        corpus = luma_corpus(root)
        for t in range(trials):
            runs["card_vs_cpu"].append(
                phase_luma_card_vs_cpu(card, corpus, trial=t, check=False))
            runs["many_vs_train"].append(
                phase_luma_many_vs_train(card, corpus, trial=t, check=False))
            runs["card_vs_cpu_bf16"].append(
                phase_luma_card_vs_cpu(card, corpus, trial=t, check=False, dtype="bfloat16"))
    summary = {}
    for name, by_trial in runs.items():
        flat = [gaps for trial in by_trial for gaps in trial]
        largest = {}
        for gaps in flat:
            for key, v in gaps.items():
                largest[key] = max(largest.get(key, 0.0), v)
        kinds = {}
        for key, v in largest.items():
            kinds[key.split()[0]] = max(kinds.get(key.split()[0], 0.0), v)
        summary[name] = {
            "trials": len(by_trial), "readings": len(flat),
            "refused_trials": sum(any(luma_step_faults(g) for g in trial) for trial in by_trial),
            "refused_readings": sum(bool(luma_step_faults(g)) for g in flat),
            "largest_by_kind": kinds,
            "largest": dict(sorted(largest.items(), key=lambda kv: -kv[1]))}
        log(f"luma state trials {name}: {summary[name]} [{card}]")
    print(json.dumps({"card": card, "limits": LUMA_STEP_LIMITS, "luma_state_trials": summary}),
          flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--head-times"]:
        return head_times_only(card_line())
    if sys.argv[1:] == ["--engine-times"]:
        return engine_times_only(card_line())
    if sys.argv[1:2] == ["--luma-state-trials"]:
        return luma_state_trials(card_line(), int(sys.argv[2]))
    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_build
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck
    from disentagled_multimodal_fusion_tpu_torch.ops import probe_megakernel as pm

    configure()
    t_start = time.perf_counter()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    log(f"device: {kind}, count {count}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    infos = cuda_build.build([ck.KERNEL_SOURCE, pm.KERNEL_SOURCE])
    for name, info in infos.items():
        log(f"build {name}: {info.seconds:.2f} s")
        for line in info.log.splitlines():
            if line.strip():
                log(f"  ptxas: {line.strip()}")
        frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", info.log)
        if not frames or any(int(x) for frame in frames for x in frame):
            raise AssertionError(f"{name}: ptxas reports a stack frame or spills: {frames}")

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"{label} in {time.perf_counter() - t0:.1f} s [{card}]")
        return out

    max_abs_err = timed("phase 3 evidential_head checks", phase_kernel_checks, ck)
    bf16_abs_err = timed("phase 3 evidential_head bf16 checks", phase_bf16_kernel_checks, ck)
    epoch_abs_err = timed("phase 3 probe_epoch checks", phase_probe_epoch_checks, pm)
    timing = timed("phase 4 evidential_head times", phase_kernel_times, ck, card)
    device_by_shape, head_times_by_shape = timed("phase 4 evidential_head device times",
                                                 phase_device_time, ck, card)
    bf16_timing, bf16_times_by_shape = timed("phase 4 evidential_head bf16 times",
                                             phase_bf16_kernel_times, ck, card)
    epoch_timing, epoch_times_by_shape = timed("phase 4 probe_epoch times",
                                               phase_probe_epoch_times, pm, card)
    epoch_timing = {k: epoch_timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")}
    serve_launches, serve_shapes = timed("phase 5 serving", phase_serving, ck, card)
    timed("phase 5 request profile", phase_request_profile, card)
    timed("phases 6-7 daemon and HTTP", phase_daemon_and_http, card)
    epoch_launches, train_head_launches, train_shapes, seq_wall, f32_accs = timed(
        "phase 8 training", phase_training, ck, pm, card)
    timed("phase 9 engines", phase_engines, card)
    timed("phase 10 vmapped heads", phase_vmapped_heads, ck, card)
    with artifact_root("seed_batched_"), cut_config(SEED_BATCHED_CUT):
        with kept_checkpoints() as kept:
            sb_launches, sb_shapes, sb_rows, _ = timed("phase 11 seed-batched",
                                                       phase_seed_batched, ck, card, seq_wall)
        timed("phase 12 seed-batched engines", phase_seed_batched_engines, card)
        timed("phase 13 restore", phase_restore, card, kept, sb_rows)
        # on phase 13's checkpoints, before its artifact root goes
        export_launches = timed("phase 26 export", phase_export, ck, card)
    with artifact_root("synthetic_dmvae_"):
        syn = timed("phase 14 synthetic", phase_synthetic, ck, pm, card, "dmvae")
        # the probes' checkpoints share their names, so DSSL has its own root
        with artifact_root("synthetic_dssl_"), cut_config(DSSL_CUT, "synthetic_config.yaml"):
            dssl = timed("phase 15 synthetic DSSL", phase_synthetic, ck, pm, card, "dssl")
        with artifact_root("synthetic_vmap_"):
            syn_sb_launches, syn_sb_shapes = timed("phase 16 synthetic seed-batched",
                                                   phase_synthetic_seed_batched, ck, card)
        timed("phase 17 synthetic restore", phase_synthetic_restore, card, syn[0])
    syn_head_launches = syn[2] + dssl[2] + syn_sb_launches
    syn_epoch_launches = syn[1] + dssl[1]
    syn_shapes = dict(collections.Counter(syn[3]) + collections.Counter(dssl[3])
                      + collections.Counter(syn_sb_shapes))
    timed("phase 18 fusions", phase_fusions, card)
    _, im_epochs, im_heads, im_shapes, fused_bb_ms = timed(
        "phase 19 intermediate", phase_intermediate, ck, pm, card)
    uf_epochs, uf_heads, uf_shapes, _ = timed("phase 20 unfused DMVAE", phase_unfused_dmvae,
                                              ck, pm, card, fused_bb_ms)
    prof_heads, prof_shapes = timed("phase 21 profile", phase_seed_batched_profile, ck, card)
    cub_shapes = dict(collections.Counter(im_shapes) + collections.Counter(uf_shapes))
    with artifact_root("luma_") as root:
        corpus = luma_corpus(root)
        luma_heads, luma_shapes, luma_fits = timed("phase 22 LUMA", phase_luma, ck, pm, card,
                                                   root, corpus)
        with artifact_root("luma_vmap_"):
            luma_sb_heads, luma_sb_shapes = timed("phase 23 LUMA seed-batched",
                                                  phase_luma_seed_batched, ck, pm, card,
                                                  corpus, luma_fits)
        luma_bf16_heads, luma_bf16_shapes = timed("phase 24 LUMA bf16", phase_luma_bf16, ck,
                                                  pm, card, corpus, luma_fits)
    hw_bf16_heads, hw_bf16_shapes = timed("phase 25 HandWritten bf16", phase_training_bf16, ck,
                                          pm, card, f32_accs)

    bf16_tally = collections.Counter(hw_bf16_shapes)
    for shapes in luma_bf16_shapes.values():
        bf16_tally.update(shapes)
    if bf16_tally.most_common(1)[0][0] != shape_key(*BF16_MAIN) + ",bf16":
        raise AssertionError(f"the kernels line times the bf16 build at {BF16_MAIN}, but the "
                             f"run launched it most at {bf16_tally.most_common(1)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "evidential_head",
        "route": "cuda",
        "source": "disentagled_multimodal_fusion_tpu_torch/csrc/evidential_head.cu",
        "replaces": "disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53",
        "launches": (serve_launches + train_head_launches + sb_launches + syn_head_launches
                     + im_heads + uf_heads + prof_heads + luma_heads + luma_sb_heads
                     + export_launches),
        "launches_by_path": {"serving": serve_launches, "training": train_head_launches,
                             "seed_batched": sb_launches, "synthetic": syn_head_launches,
                             "cub_intermediate": im_heads, "cub_unfused": uf_heads,
                             "scene_profile": prof_heads, "luma": luma_heads,
                             "luma_seed_batched": luma_sb_heads, "export": export_launches,
                             "luma_bf16": 0, "handwritten_bf16": 0},
        "max_abs_err": max_abs_err,
        **timing,
        "device_ms_by_shape": device_by_shape,
        "times_by_shape": head_times_by_shape,
        "launches_by_shape": {"serving": serve_shapes, "training": train_shapes,
                              "seed_batched": sb_shapes, "synthetic": syn_shapes,
                              "cub": cub_shapes, "scene_profile": prof_shapes,
                              "luma": luma_shapes, "luma_seed_batched": luma_sb_shapes},
    }, {
        "name": "evidential_head_bf16",
        "route": "cuda",
        "source": "disentagled_multimodal_fusion_tpu_torch/csrc/evidential_head.cu",
        "replaces": "disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53",
        "launches": sum(luma_bf16_heads.values()) + hw_bf16_heads,
        "launches_by_path": {"luma_bf16": luma_bf16_heads["sequential"],
                             "luma_seed_batched_bf16": luma_bf16_heads["seed-batched"],
                             "handwritten_bf16": hw_bf16_heads},
        "max_abs_err": bf16_abs_err,
        **bf16_timing,
        "times_by_shape": bf16_times_by_shape,
        "launches_by_shape": {"luma_bf16": luma_bf16_shapes["sequential"],
                              "luma_seed_batched_bf16": luma_bf16_shapes["seed-batched"],
                              "handwritten_bf16": hw_bf16_shapes},
    }, {
        "name": "probe_epoch",
        "route": "cuda",
        "source": "disentagled_multimodal_fusion_tpu_torch/csrc/probe_epoch.cu",
        "replaces": "disentagled_multimodal_fusion_tpu/ops/probe_megakernel.py:246",
        "launches": epoch_launches + syn_epoch_launches + im_epochs + uf_epochs,
        "launches_by_path": {"training": epoch_launches, "synthetic": syn_epoch_launches,
                             "cub_intermediate": im_epochs, "cub_unfused": uf_epochs,
                             "luma": 0, "luma_seed_batched": 0, "luma_bf16": 0,
                             "handwritten_bf16": 0},
        "max_abs_err": epoch_abs_err,
        **epoch_timing,
        "times_by_shape": epoch_times_by_shape,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
