"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100 (or any CUDA card).

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) rather than being skipped:

1. the card: name, count and ``nvidia-smi`` name and power limit;
2. the build of both kernels from ``csrc/`` with nvcc (one process each,
   started together), its time and ptxas report (no stack frame and no
   spills in any kernel), and one summary line per kernel (registers,
   static shared memory, stack frame, spills);
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
   4200), CUB's (2, 120, 1024), PIE's (3, 136, 484) at C = 68, Scene's
   (3, 897, 59) at C = 15, the synthetic (3, 2000, 16) at C = 3, and
   ``--vmap-seeds``'s five seeds of HandWritten, the synthetic sweep and
   Scene: the head shapes ``--dtype bfloat16`` reaches) against its plain
   version and
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
   ``baddbmm`` chain and its bound at the bf16 tensor-core peak (each
   library chain by CUDA events, which time the host's launches too, and
   by its profiler device time summed over its kernels: the bf16 chain at
   every shape, the f32 one at (7, 256) and ``CHAIN_SHAPES``); the profiler
   window of the probe epoch must
   hold exactly its three kernels (``EPOCH_KERNELS``: forward, loss with
   dh, gradient + AdamW), S launches each per epoch (S = 16 on
   HandWritten, 62 on the synthetic sweep, 5 on CUB with its tail of 80),
   and nothing else but the wrapper's PyTorch operations; the epoch's
   backward half (the gradient + AdamW pass) per step beside its bound and
   a library chain (``torch.bmm``, bias sums, ``torch._fused_adamw_``) by
   profiler device time;
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
    call, no module of the package loaded (``phase_export``);
27. the mesh on the one card (``phase_mesh``): (a) legs A-C at
    HandWritten's full width (FusedDMVAE 512/200, heads 200 -> 128 -> 10)
    as subprocess ranks of this script (``--mesh-rank``), at world size 1
    over NCCL and 2 over gloo with both ranks on cuda:0: a two-epoch DMVAE
    fit and a three-epoch dmvae_cml probe fit through the step loop with
    validation and evaluation (``train(mesh=)``), ``train_many`` over four
    probe seeds split over the ranks, and ``ServingEngine(divisor=n_dp)`` at
    bucket 256; every rank's results equal bit for bit, each held against
    the same legs without a mesh in this process (losses rtol 2e-5 / atol
    2e-6, the DMVAE's and train_many's parameters rtol 5e-3 / atol 5e-5, the
    probe's within 1e-2 of their norm and its validation loss at rtol 5e-4,
    accuracies to 1e-6, served outputs at phase 5's tolerances), and the
    head kernel launched on each rank exactly at its rows' shapes ((7, 400 /
    n_dp) four times, (4 / n_dp x 7, 400) twice, (7, 256 / n_dp) once); (b)
    ``runners/run.py --data-parallel 2 --device cuda:0`` (the runner picks
    gloo, since both ranks name the one card) on HandWritten Normal seed 0
    ``--quick`` against the same command in one process: every row finite,
    the DMVAE backbone's last train loss within 1e-4 as printed and its
    checkpoint within 1e-3 of each tensor's norm, the three late fusions'
    fused accuracies within one of the 400 test rows
    (``RUN_DP_LATE_GAP``) and, beside those, the three probes' within 0.03
    (``RUN_DP_ACC_GAP``), both runs' host time per epoch logged; (c)
    ``runners/sweep_parallel.py --procs 2 --worker-env
    CUDA_VISIBLE_DEVICES=0`` over HandWritten and CUB ``--quick``: its
    merged rows equal one process's at rtol 1e-6 and each worker's log
    names the card. (c)'s workers run beside (a)'s ranks; (b), whose host
    times are read, runs alone;
28. the mesh's model axis on the one card: (a) phase 27's legs A-C with
    each single fit cutting its hidden width (``train(tp_hidden_dim=)``:
    the FusedDMVAE's 512, the probe's 128), plus the first step of each
    (``step_gradients``), as subprocess ranks of this script
    (``--model-rank``) in two gloo clusters on cuda:0, world size 2 (mesh
    1 x 2) and 4 (2 x 2), against the same legs without a mesh: every rank
    of a model group equal bit for bit; the first steps' losses and every
    gathered gradient at rtol 1e-4 / atol 1e-5; the fits' train losses at
    rtol 2e-5 / atol 2e-6, the probe's validation loss at rtol 5e-4
    (phase 27's), its accuracies within one of the 400 rows; the DMVAE's
    weights within 1e-3 and the probe's within 1e-2 of each tensor's norm;
    train_many's parameters (its seeds split over ``data`` alone) at rtol
    5e-3 / atol 5e-5; served outputs at phase 5's tolerances; the head
    kernel launched on each rank on the gathered weights exactly at its
    data index's rows ((7, 400 / n_dp) four times, (4 / n_dp x 7, 400)
    twice, (7, 256 / n_dp) once, n_dp = world / 2), the epoch kernel never
    (``MODEL_CUT``); and in bf16 compute mode the first steps of the same
    DMVAE and probe and a three-epoch probe fit with validation and
    evaluation: the losses at tests/test_torch_bf16.py's bound
    (``assert_bf16_close``), each first-step gradient and each of the
    probe's weights no farther from the float32 leg's than 1.25 times one
    bf16 process's (norm-wise, ``MODEL_BF16_RATIO``), the accuracies within
    four of the 400 rows, the bf16 build of the head kernel launched four
    times a rank at (7, 400 / n_dp) on the gathered weights; and what the
    float32 DMVAE and probe fits hold, read at their last step from inside
    them on every rank and in the leg without a mesh: the bytes of the
    distinct storages of the model's parameters, the fit's and their Adam
    moments (``core.train.resident_bytes``), held exactly to three times
    the plan's blocks (the whole parameters without a mesh; the FusedDMVAE
    at 512: 99 902 592 bytes without a mesh, 49 988 736 a rank), beside
    ``torch.cuda.memory_allocated()`` then and the peak over the fit,
    printed and not held (``memory_watch``); (b) ``runners/run.py
    --model-parallel 2 --device cuda:0`` as two gloo ranks on HandWritten
    Normal seed 0 ``--quick`` against phase 27 (b)'s one-process run, at
    phase 27 (b)'s limits, both runs' host time per epoch logged. (a) runs
    as a fifth group beside the others; (b) runs alone, after phase 27;
29. the unfused heads (``fused_heads=False``: one module a head, plain
    PyTorch) on the card: dmvae_cml (``EvidentialProbe``, AdamW cosine)
    and dmvae_dis (``DisentangledEvidentialProbe``, AdamW plateau) on
    random embeddings of the backbone's shapes (Zc and Zp of 200, 6 views)
    and cml_fusion (``LateFusion``, Adam plateau) on HandWritten's raw
    views, 1600 train and 400 validation rows, batch 100, five epochs
    through the step loop; each held against its stacked twin on the same
    weights (``convert.stack_heads``) and ``Randomness``, through the step
    loop and, for the probes, the epoch kernel (5 launches a probe): the
    losses at rtol 2e-5 / atol 2e-6, validation accuracy within one of the
    400 rows, each parameter tensor within rtol 5e-3 / atol 5e-5 by norm,
    each bound widened by twice how far the unfused fit with float64
    weights lies from the float32 one (``UNFUSED_SPREAD``: these fits turn
    chaotic); the head kernel once per validation epoch of each stacked
    fit, the unfused fits no kernel; ms per epoch of each fit.

Each phase logs its time. Phases 3-7 run first, alone; then phases 11-13
and 26, 14-17 and 21, 18-20, 22-24, 28 (a), and 29 run as six groups,
each in a child process of this script (``--group``), beside phases 8-10
and 25 in this one; phases 27 and 28 (b) run last, alone. Each child
counts its own launches, each count set to 0 before a path and read after
it, and sends them back.

The serving and training phases also count the head kernel's calls by
shape. ``python3 chip_smoke.py --head-times`` only builds the head kernel
of the package first on the path and prints its times at the main-path
shapes as one JSON line: copied into an unpacked checkout of another
commit, it times that commit's kernel in the same call; ``python3
chip_smoke.py --epoch-times`` does the same for the epoch kernel (phase
4's epoch times, the profiler window held to the kernels its source
defines). ``python3 chip_smoke.py --engine-times`` only times
``--vmap-seeds`` against ``--one-program-cells`` on two full-depth
HandWritten cells (about 35 minutes) and checks that their reports
agree. ``python3 chip_smoke.py
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
# and the library chain's device time at these (with the kernels line's
# (7, 256) the f32 rows of PERF.md's kernel table)
CHAIN_SHAPES = [(3, 840, 200, 128, 42), (15, 840, 200, 128, 42), (20, 4200, 200, 128, 42)]
# (S, V, B, D, H, C) of the probe epoch: dmvae_cml on HandWritten (16 steps
# of 100 rows), then on the synthetic sweep (62 steps of 128 rows, the tail
# dropped; D=16 over DMVAE, 32 over DSSL)
EPOCH_SHAPES = [(16, 7, 100, 200, 128, 10), (62, 3, 128, 16, 128, 3), (62, 3, 128, 32, 128, 3)]
# (S, V, B, D, H, C, tail) of the CUB cells' probe epochs (phases 19-20):
# 480 rows in four steps of 100 and a tail of 80, V = 3 (dmvae_cml,
# dmvae_joint) and 2 (dmvae_dis), C = 10
CUB_EPOCH_SHAPES = [(5, 3, 100, 200, 128, 10, 80), (5, 2, 100, 200, 128, 10, 80)]
# the epoch kernel's launches, each once per step: the forward, the loss with
# dh, the gradient + AdamW pass (its backward half)
EPOCH_KERNELS = ("forward_kernel", "loss_dh_kernel", "grad_adamw_kernel")
BACKWARD_KERNEL = "grad_adamw_kernel"
# The epoch kernel before its backward half was tiled into grad_adamw_kernel
# (dh had its own launch): ms of profiler device time per launch of
# loss_kernel, dh_kernel and grad_adam_kernel, from ``--epoch-times`` on that
# tree (NVIDIA H100 80GB HBM3, 700.00 W), by the keys of
# phase_probe_epoch_times. Printed beside the new pass: another call's
# reading, a guide and not a held comparison.
OLD_BACKWARD_MS = {
    "S=16,V=7,B=100,D=200,H=128,C=10": (0.0071133, 0.0071337, 0.0135892),
    "S=62,V=3,B=128,D=16,H=128,C=3": (0.0064728, 0.0057848, 0.0145810),
    "S=62,V=3,B=128,D=32,H=128,C=3": (0.0064543, 0.0064650, 0.0145842),
    "S=5,V=3,B=100,tail=80,D=200,H=128,C=10": (0.0060395, 0.0064274, 0.0124735),
    "S=5,V=2,B=100,tail=80,D=200,H=128,C=10": (0.0059222, 0.0066524, 0.0122538),
}


def ptxas_summary(text):
    """One line per kernel of a ptxas -v report: its name (demangled where
    c++filt is there), registers, shared memory, stack frame and spills."""
    lines, name, frame = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            frame = (f"{m.group(1)} bytes stack frame, {m.group(2)} + {m.group(3)} bytes spill "
                     f"stores + loads")
        m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            lines.append(f"ptxas summary {demangle(name)}: {m.group(1)} registers, "
                         f"{smem.group(1) if smem else 0} bytes static shared memory, {frame}")
            name, frame = None, ""
    return lines


def demangle(name):
    """A kernel's name and template arguments, without its parameters."""
    try:
        out = subprocess.run(["c++filt", name], capture_output=True, text=True, timeout=30)
        name = out.stdout.strip() or name
    except (OSError, subprocess.SubprocessError):
        pass
    if name.endswith(")"):
        name = name[:name.rfind("(")]
    return name.removeprefix("void ")


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
                library_device_ms = device_ms(library_heads, args, n=30)
                log(f"  library at V={v} B={b} D={d}: {fmt_ms(library_device_ms)} of device time "
                    f"[{card}]")
                main_row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                library_device_ms=library_device_ms, bound_ms=bound_ms,
                                bound_by=bound_by)
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


def device_ms(fn, args, kernel=None, n=100):
    """Device time per call of ``fn`` from the profiler: of the CUDA kernels
    whose name holds ``kernel``, or summed over every kernel it launches
    where ``kernel`` is None (the library chains, whose CUDA events also
    time the host's launches of four to six kernels); None when the
    profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   or getattr(e, "self_cuda_time_total", 0.0)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.key))
    return total_us / n / 1e3 if total_us > 0 else None


def fmt_ms(ms):
    return f"{ms:.5f} ms" if ms is not None else "not measured"


# the bf16 build's shapes (phases 3 and 4): HandWritten's probe heads, LUMA's
# (3|4, 840|160) of phases 22 and 24, and the stacked (15|20, 840) and
# (20, 4200) of the seed-batched engine (the last a full corpus's); then the
# other runners' widest heads under --dtype bfloat16: CUB's late fusion (D =
# 1024), PIE's (D = 484, C = 68), Scene's (D = 59, C = 15) and the synthetic
# sweep's (D = 16, C = 3); and --vmap-seeds's five seeds of HandWritten, the
# synthetic sweep and Scene (several row tiles a block, one chunk a tile)
BF16_SHAPES = (VALIDATION_SHAPES[:3] + [(7, 256, 200, 128, 10)] + LUMA_SHAPES
               + [(15, 840, 200, 128, 42), (20, 840, 200, 128, 42), (20, 4200, 200, 128, 42)]
               + [VALIDATION_SHAPES[i] for i in (3, 6, 8)] + SYNTHETIC_SHAPES[:1]
               + STACKED_SHAPES + SYNTHETIC_STACKED_SHAPES
               + [(len(SEEDS) * v, b, d, h, c) for v, b, d, h, c in VALIDATION_SHAPES[8:]])
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


def assert_bf16_close(got, ref, label):
    """Within 2 bf16 ulps (2^-7 |ref| + 1e-3) but for at most 1 in 1000
    entries, none beyond 4 ulps of its own size or of the tensor's rms
    (tests/test_torch_bf16.py sets the rule from the CPU's readings).
    Returns (entries beyond 2 ulps, the largest gap over the outlier
    bound)."""
    g, r = got.double(), ref.double()
    err = (g - r).abs()
    beyond = int((err > 2.0 ** -7 * r.abs() + 1e-3).sum())
    worst = (2.0 ** -6 * (r.abs() + r.pow(2).mean().sqrt())).clamp_min(1e-30)
    ratio = float((err / worst).max())
    if not bool(torch.isfinite(got).all()) or beyond > got.numel() // 1000 or ratio > 1.0:
        raise AssertionError(f"{label}: {beyond} of {got.numel()} entries beyond 2 bf16 ulps, "
                             f"largest gap {ratio:.3f} of the 4-ulp bound")
    return beyond, ratio


def assert_bf16_evidence_close(got, ref, label):
    """bf16 evidence through its log, the logit it came from, at
    :func:`assert_bf16_close`'s bound. Returns (entries beyond 2 ulps, the
    largest gap over the outlier bound, the max abs error of the
    evidence)."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: evidence not finite")
    beyond, ratio = assert_bf16_close(got.double().log(), ref.double().log(), label)
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
    the chain's device time summed over its kernels, and the bound. Returns
    the row at ``BF16_MAIN`` and {shape key: times}."""
    timed, main_row = {}, None
    for shape in BF16_SHAPES:
        args = head_inputs(*shape, seed=1)
        kernel_ms = device_ms(ck.evidential_heads_stacked_bf16, args,
                              "evidential_heads_bf16_kernel")
        ms = event_ms(ck.evidential_heads_stacked_bf16, args)
        plain_ms = event_ms(ck.evidential_heads_stacked_bf16_plain, args)
        library_ms = event_ms(library_heads_bf16, args)
        library_device_ms = device_ms(library_heads_bf16, args, n=30)
        bound_ms, bound_by = bf16_bound(*args)
        row = dict(device_ms=kernel_ms, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   library_device_ms=library_device_ms, bound_ms=bound_ms, bound_by=bound_by)
        timed[shape_key(*shape)] = row
        if shape == BF16_MAIN:
            main_row = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "device_ms", "library_device_ms")}
        log(f"time evidential_head bf16 {shape_key(*shape)}: device {fmt_ms(kernel_ms)}, "
            f"events {ms:.5f} ms, plain {plain_ms:.5f} ms, library (bf16 baddbmm chain) "
            f"{library_ms:.5f} ms by events, {fmt_ms(library_device_ms)} of device time, "
            f"bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
    return main_row, timed


def phase_device_time(ck, card):
    """The head kernel at every main-path shape: profiler device time, CUDA
    events per call (the wrapper's host work included, so events minus
    device time is the wrapper's cost when the host is the limit) and the
    bound; at ``TIMED_SHAPES`` also the plain and library times (the
    library chain by events, at ``CHAIN_SHAPES`` also by device time summed
    over its kernels). Returns {shape key: device ms} and {timed shape key:
    times}."""
    device, timed = {}, {}
    for shape in MAIN_PATH_SHAPES:
        args = head_inputs(*shape, seed=1)
        ms = device_ms(ck.evidential_heads_stacked, args, "evidential_heads_kernel")
        events = event_ms(ck.evidential_heads_stacked, args)
        bound_ms, bound_by = head_bound(*shape)
        device[shape_key(*shape)] = ms
        extra = ""
        if shape in TIMED_SHAPES:
            plain_ms = event_ms(ck.evidential_heads_stacked_plain, args)
            library_ms = event_ms(library_heads, args)
            library_device_ms = (device_ms(library_heads, args, n=30) if shape in CHAIN_SHAPES
                                 else None)
            timed[shape_key(*shape)] = dict(device_ms=ms, ms=events, plain_ms=plain_ms,
                                            library_ms=library_ms,
                                            library_device_ms=library_device_ms,
                                            bound_ms=bound_ms, bound_by=bound_by)
            extra = f", plain {plain_ms:.5f} ms, library {library_ms:.5f} ms by events"
            if library_device_ms is not None:
                extra += f", {fmt_ms(library_device_ms)} of device time"
        log(f"device time evidential_head {shape_key(*shape)}: {fmt_ms(ms)}, events "
            f"{events:.5f} ms per call{extra}, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
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


def backward_bound(s, v, b, d, h, c, tail=None):
    """(ms per step, 'operations' | 'bytes') of the epoch's backward half,
    averaged over its S steps: the products dh = dz W2^T, dW1 = x^T dh and
    dW2 = hd^T dz, the bias sums and ~12 operations per state element of
    AdamW, against x, hd and dz read once and p, m, v read and written once
    each step (dh is made and used inside the half, so it counts no bytes;
    W2 is read as part of p). A ragged ``tail`` counts only its rows."""
    rows = s * b if tail is None else (s - 1) * b + tail
    state = v * (d * h + h + h * c + c)
    flops = 2.0 * v * rows * (d * h + 2 * h * c) + v * rows * (h + c) + s * 12.0 * state
    nbytes = 4.0 * (v * rows * (d + h + c) + s * 2 * 3 * state)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3 / s, ("operations" if t_ops >= t_bytes else "bytes")


def backward_library_ms(v, b, d, h, c, keep=0.9, seed=5):
    """Profiler device time of one step's backward half through PyTorch's
    own kernels, summed over them: ``torch.bmm`` for dh (masked by hd > 0,
    scaled by 1 / keep), dW1 and dW2, the bias sums, then
    ``torch._fused_adamw_`` on p, m, v; f32 with TF32 off. A yardstick
    only: the port never calls it."""
    g = torch.Generator().manual_seed(seed)
    x, hd, dz = (torch.randn(v, b, n, generator=g).cuda() for n in (d, h, c))
    hd = hd.clamp_min(0.0)
    params = [t.cuda() for t in (torch.randn(v, d, h, generator=g) * 0.1,
                                 torch.randn(v, h, generator=g) * 0.1,
                                 torch.randn(v, h, c, generator=g) * 0.1,
                                 torch.randn(v, c, generator=g) * 0.1)]
    mus = [torch.zeros_like(p) for p in params]
    nus = [torch.zeros_like(p) for p in params]
    steps = [torch.ones((), device="cuda") for _ in params]

    def chain(x, hd, dz):
        w2 = params[2]
        dh = torch.bmm(dz, w2.transpose(1, 2)).masked_fill_(hd <= 0.0, 0.0).mul_(1.0 / keep)
        grads = [torch.bmm(x.transpose(1, 2), dh), dh.sum(1), torch.bmm(hd.transpose(1, 2), dz),
                 dz.sum(1)]
        torch._fused_adamw_(params, grads, mus, nus, [], steps, lr=3e-3, beta1=0.9,
                            beta2=0.999, weight_decay=1e-2, eps=1e-8, amsgrad=False,
                            maximize=False)

    return device_ms(chain, (x, hd, dz))


def epoch_source_kernels(pm):
    """The __global__ functions that the checkout's epoch source defines, in
    source order."""
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_build

    text = (cuda_build.CSRC_DIR / f"{pm.KERNEL_SOURCE}.cu").read_text()
    return tuple(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                            text))


def phase_probe_epoch_times(pm, card, names=EPOCH_KERNELS):
    """Kernel and plain time per epoch at every shape of ``EPOCH_SHAPES``
    (dmvae_cml's probe on HandWritten, V=7, first) and ``CUB_EPOCH_SHAPES``,
    the device time per epoch and per launch of each of ``names`` from the
    profiler, the bound; the backward half's device time per step beside
    its bound and the library chain's. Returns the first shape's row and
    {shape key: row} of all."""
    rows = {}
    for i, (s, v, b, d, h, c) in enumerate(EPOCH_SHAPES):
        key = f"S={s},V={v},B={b},D={d},H={h},C={c}"
        rows[key] = probe_epoch_times_at(pm, card, names, key, s, v, b, d, h, c,
                                         1.0 if i == 0 else 0.0)
    for s, v, b, d, h, c, tail in CUB_EPOCH_SHAPES:
        key = f"S={s},V={v},B={b},tail={tail},D={d},H={h},C={c}"
        rows[key] = probe_epoch_times_at(pm, card, names, key, s, v, b, d, h, c, 1.0, tail)
    return rows[next(iter(rows))], rows


def probe_epoch_times_at(pm, card, names, key, s, v, b, d, h, c, fused, tail=None):
    from torch.profiler import ProfilerActivity, profile

    inp = epoch_inputs(s, v, b, d, h, c, seed=3, fused=fused, tail=tail)
    state = [tuple(t.clone() for t in g) for g in inp["state"]]
    args = (*inp["tensors"], *inp["scalars"], *state)
    ms = event_ms(lambda *a: pm.run_epoch_kernel(*a, **inp["kw"]), args, iters=50, warmup=5)
    plain_ms = event_ms(lambda *a: pm.run_epoch_plain(*a, **inp["kw"]), args, iters=5, warmup=1)
    bound_ms, bound_by = probe_epoch_bound(s, v, b, d, h, c, 0.9, tail)
    n, steps = 20, s
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
            or sum(launches.values()) != len(names) * steps:
        raise AssertionError(f"probe_epoch launched {launches} per epoch, expected each of "
                             f"{names} {steps} times ({len(names) * steps} in all)")
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
    back_bound, back_by = backward_bound(s, v, b, d, h, c, tail)
    back_lib = backward_library_ms(v, b, d, h, c)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               device_ms=device_ms,
               per_launch_ms={k: t for k, (t, _) in sorted(kernels.items())},
               backward_bound_ms=back_bound, backward_bound_by=back_by,
               backward_library_ms=back_lib)
    if BACKWARD_KERNEL in kernels:
        back = kernels[BACKWARD_KERNEL][0]
        log(f"  backward half per step: {back:.5f} ms ({BACKWARD_KERNEL}; dh is made inside "
            f"loss_dh_kernel), bound {back_bound:.6f} ms ({back_by}), library chain "
            f"{fmt_ms(back_lib)} of device time [{card}]")
        if key in OLD_BACKWARD_MS and "loss_dh_kernel" in kernels:
            old_loss, old_dh, old_grad = OLD_BACKWARD_MS[key]
            grown = kernels["loss_dh_kernel"][0] - old_loss
            log(f"  before the redesign (another call): dh_kernel + grad_adam_kernel "
                f"{old_dh + old_grad:.5f} ms per step; now {back:.5f} ms, and "
                f"{back + grown:.5f} ms with loss_dh_kernel's growth over loss_kernel "
                f"({(back + grown) / (old_dh + old_grad):.2f} of before)")
        row["backward_ms"] = back
    else:
        log(f"  backward half per step: bound {back_bound:.6f} ms ({back_by}), library chain "
            f"{fmt_ms(back_lib)} of device time [{card}]")
    return row


def epoch_window(prof, names, n):
    """({kernel: (device us, launches)}, wrapper ms per epoch, wrapper
    operations) of a profiler window of ``n`` epochs. Every device
    operation of the window is one of ``names`` or one of the PyTorch
    operations the wrapper runs (the scalars' fill and stack); anything
    else (a renamed or added kernel) fails."""
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


def epoch_times_only(card):
    """``--epoch-times``: build the epoch kernel of whichever package is
    first on the path, hold it against its plain version at HandWritten's
    shape, and print phase 4's epoch times as one JSON line, the profiler
    window held to the kernels its source defines. Run from a copy of this
    script placed in an unpacked checkout of another commit, it times that
    commit's kernel in the same call (parent, change, change, parent)."""
    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_build
    from disentagled_multimodal_fusion_tpu_torch.ops import probe_megakernel as pm

    configure()
    cuda_build.build([pm.KERNEL_SOURCE])
    names = epoch_source_kernels(pm)
    inp = epoch_inputs(*EPOCH_SHAPES[0], seed=17)
    err = assert_epoch_close(run_epoch(pm.run_epoch_kernel, inp), run_epoch(pm.run_epoch_plain, inp),
                             "probe_epoch HandWritten")
    _, rows = phase_probe_epoch_times(pm, card, names)
    print(json.dumps({"package": str(Path(pm.__file__).resolve().parents[1]), "card": card,
                      "kernels": names, "max_abs_err": err, "epoch_times": rows}), flush=True)
    return 0


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


def phase_seed_batched(ck, card):
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
        f"{probe_epochs} head epochs in {wall:.1f} s, {wall / len(SEEDS):.1f} s per seed; "
        f"evidential_head launched {launches} times (by shape {dict(shapes)}) [{card}]")
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
    shape, and its bf16 build's at ``BF16_SHAPES``, as one JSON line. Run
    from a copy of this script placed in an unpacked checkout of another
    commit, it times that commit's kernel in the same call (parent, change,
    change, parent)."""
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
        rows[shape_key(*shape)] = dict(device_ms=device_ms(ck.evidential_heads_stacked, args,
                                                           "evidential_heads_kernel"),
                                       events_ms=event_ms(ck.evidential_heads_stacked, args),
                                       bound_ms=bound_ms, bound_by=bound_by)
    bf16_rows = {}
    for shape in BF16_SHAPES:
        args = head_inputs(*shape, seed=0)
        assert_bf16_evidence_close(ck.evidential_heads_stacked_bf16(*args),
                                   ck.evidential_heads_stacked_bf16_plain(*args),
                                   f"bf16 {shape_key(*shape)}")
        bound_ms, bound_by = bf16_bound(*args)
        bf16_rows[shape_key(*shape)] = dict(
            device_ms=device_ms(ck.evidential_heads_stacked_bf16, args,
                                "evidential_heads_bf16_kernel"),
            events_ms=event_ms(ck.evidential_heads_stacked_bf16, args),
            bound_ms=bound_ms, bound_by=bound_by)
    print(json.dumps({"package": str(Path(ck.__file__).resolve().parents[1]), "card": card,
                      "head_times": rows, "bf16_head_times": bf16_rows}), flush=True)
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


# ------------------------------------------------------------------ phase 27: the mesh
MESH_TIMEOUT_S = 600
MESH_SEEDS = 4  # leg B: train_many over four seeds, two a rank at world size 2
MESH_LOSS_TOL = dict(rtol=2e-5, atol=2e-6)  # phase 12's
MESH_PARAM_TOL = dict(rtol=5e-3, atol=5e-5)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(argv, world, env=None, cwd=None):
    """``world`` processes of ``argv`` with torch's launcher environment
    (one rendezvous port), each rank's output piped."""
    port = free_port()
    base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), **(env or {}))
    return [subprocess.Popen(argv, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                             cwd=cwd or str(Path(__file__).resolve().parent),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_all(procs, label, timeout=MESH_TIMEOUT_S):
    """Each process's output once all exited 0; kills them all on a failure
    or the timeout."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{label}: process {r} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def mesh_data(device):
    """HandWritten at full width: the views (2000 rows), the labels, and the
    fixed split of 1600 train and 400 test rows the legs use."""
    from disentagled_multimodal_fusion_tpu_torch.data.multiview import DATASET_REGISTRY

    views, labels = DATASET_REGISTRY["HandWritten"]().arrays()
    xs = tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device) for v in views)
    return xs, torch.from_numpy(labels).to(device)


def memory_watch(model, loss_fn, mesh, tp, steps, reading):
    """``loss_fn`` (an Objective) whose loss, at the fit's last step (its
    ``steps``-th call), records in ``reading`` what the fit holds:
    ``resident``, the bytes of the distinct storages of the model's
    parameters, the fit's and their Adam moments
    (``core.train.resident_bytes``), beside ``planned``, three times this
    rank's blocks of the parameters under the cut of ``tp`` on ``mesh``'s
    model axis (every parameter whole without one) in their type,
    ``allocated``, ``torch.cuda.memory_allocated()``, and ``peak_steps``,
    the peak allocation up to then since the caller's
    ``reset_peak_memory_stats()`` before the fit (the caller adds ``peak``,
    over the whole fit: the gathers that make the model whole at its end
    too)."""
    from disentagled_multimodal_fusion_tpu_torch.core.train import Objective, resident_bytes
    from disentagled_multimodal_fusion_tpu_torch.parallel.mesh import ShardPlan

    own = {k: p for k, p in model.named_parameters() if p.requires_grad}
    cuts = {} if mesh is None or tp is None else ShardPlan(model, list(own), mesh, tp).cuts
    size = 1 if mesh is None else mesh.shape["model"]
    planned = 3 * sum(p.numel() // (size if k in cuts else 1) * p.element_size()
                      for k, p in own.items())
    calls = [0]

    def loss(*args):
        calls[0] += 1
        if calls[0] == steps:
            reading.update(resident=resident_bytes(), planned=planned,
                           allocated=torch.cuda.memory_allocated(),
                           peak_steps=torch.cuda.max_memory_allocated())
        return loss_fn.loss(*args)

    return Objective(None, loss, draw_epoch=loss_fn.draw_epoch, with_step=loss_fn.with_step,
                     rows=loss_fn.rows)


def mesh_legs(mesh, device="cuda", cut=False, memory=None):
    """Legs A-C of phase 27 on ``mesh`` (None: one process without a mesh),
    at HandWritten's full width (FusedDMVAE 512/200, heads 200 -> 128 -> 10):
    A, a two-epoch DMVAE fit, and a three-epoch dmvae_cml probe fit through
    the step loop with validation and its evaluation; B, train_many over
    four probe seeds; C, ServingEngine at bucket 256. The probes and the
    served model take the embeddings of the backbone as drawn, so that no
    leg's inputs depend on another leg's fit. With ``cut`` (phase 28) the
    two single fits cut their hidden widths on the mesh's model axis, and
    the first step of each is taken apart first (its loss and gathered
    gradients); and in bf16 compute mode (``bf16.`` keys) the first steps of
    the same DMVAE and probe and a three-epoch probe fit with validation
    and evaluation (the bf16 head kernel on the gathered weights). With
    ``memory`` (a dict) the DMVAE's and the probe's fits read what they
    hold at their last step into ``memory["dmvae"]`` and
    ``memory["probe"]`` (:func:`memory_watch`, plus ``peak``, the device's
    peak allocation over the fit). Returns numpy arrays by name."""
    from disentagled_multimodal_fusion_tpu_torch.core import tasks
    from disentagled_multimodal_fusion_tpu_torch.core.serve import ServingEngine, build_inference_fn
    from disentagled_multimodal_fusion_tpu_torch.core.train import (
        Randomness,
        stack_params,
        step_gradients,
        train,
        train_many,
    )
    from disentagled_multimodal_fusion_tpu_torch.eval.analysis import (
        evaluate_subjective_model_with_shared,
    )

    out = {}
    xs, y = mesh_data(device)
    dims = [x.shape[1] for x in xs]
    dmvae_tp, probe_tp = (MODEL_CUT["dmvae"], MODEL_CUT["probe"]) if cut else (None, None)

    def backbone():
        return tasks.build_dmvae_task(output_dim=dims, hidden_dim=512, embed_dim=200,
                                      fused_modalities=True, seed=0, device=device)

    def first_step(name, model, loss_fn, data, seed, tp):
        loss, grads = step_gradients(model=model, loss_fn=loss_fn, data=data, n_train=1600,
                                     batch_size=100, randomness=Randomness(seed, device),
                                     mesh=mesh, tp_hidden_dim=tp)
        out[f"{name}.step_loss"] = loss.cpu().numpy()
        out.update({f"{name}.grad.{k}": g.cpu().numpy() for k, g in grads.items()})

    def watched(name, model, loss_fn, tp, epochs):
        if memory is None:
            return loss_fn
        memory[name] = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return memory_watch(model, loss_fn, mesh, tp, epochs * 16, memory[name])

    def peak(name):
        if memory is not None:
            memory[name]["peak"] = torch.cuda.max_memory_allocated()

    fitted = backbone()
    loss_fn, opt = tasks.dmvae_objective(fitted, lr=1e-4, num_epochs=2)
    bb_data = {"xs": tuple(x[:1600] for x in xs)}
    if cut:
        first_step("dmvae", fitted, loss_fn, bb_data, 1, dmvae_tp)
    res = train(model=fitted, loss_fn=watched("dmvae", fitted, loss_fn, dmvae_tp, 2),
                data=bb_data, n_train=1600, optimizer=opt, epochs=2, batch_size=100,
                randomness=Randomness(1, device), mesh=mesh, tp_hidden_dim=dmvae_tp)
    peak("dmvae")
    out["dmvae.train_loss"] = res.train_loss
    out.update({f"dmvae.{k}": v.detach().cpu().numpy() for k, v in fitted.named_parameters()})
    del fitted

    drawn = backbone()
    zc, zp = tasks.embed_dataset(drawn, xs)
    data = {"zc": zc[:1600], "zp": zp[:1600], "y": y[:1600]}
    val = {"zc": zc[1600:], "zp": zp[1600:], "y": y[1600:]}
    probe = dict(num_modalities=6, num_classes=10, input_dim=200, hidden_dim=(128,), lr=3e-3,
                 dropout=0.1, annealing_start=50, num_epochs=3, device=device)
    task = tasks.build_probe_task(seed=2, **probe)
    if cut:
        first_step("probe", task.model, task.loss_fn, data, 3, probe_tp)
    res = train(model=task.model, loss_fn=watched("probe", task.model, task.loss_fn, probe_tp, 3),
                data=data, n_train=1600, optimizer=task.optimizer, epochs=3, batch_size=100,
                randomness=Randomness(3, device), val_fn=task.val_fn, val_data=val, mesh=mesh,
                tp_hidden_dim=probe_tp)
    peak("probe")
    info = evaluate_subjective_model_with_shared(task, val, mesh)
    out.update({"probe.train_loss": res.train_loss, "probe.val_loss": res.val_loss,
                "probe.val_acc": res.val_acc,
                "probe.fused_acc": np.array([info["fused"]["accuracy"]])})
    out.update({f"probe.{k}": v.detach().cpu().numpy() for k, v in task.model.named_parameters()})
    if cut:  # --dtype bfloat16 under the cut: the first steps and the probe fit
        bb16 = tasks.build_dmvae_task(output_dim=dims, hidden_dim=512, embed_dim=200,
                                      fused_modalities=True, seed=0, device=device,
                                      dtype="bfloat16")
        first_step("bf16.dmvae", bb16, tasks.dmvae_objective(bb16, lr=1e-4, num_epochs=2)[0],
                   bb_data, 1, dmvae_tp)
        del bb16
        task = tasks.build_probe_task(seed=2, dtype="bfloat16", **probe)
        first_step("bf16.probe", task.model, task.loss_fn, data, 3, probe_tp)
        res = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=1600,
                    optimizer=task.optimizer, epochs=3, batch_size=100,
                    randomness=Randomness(3, device), val_fn=task.val_fn, val_data=val,
                    mesh=mesh, tp_hidden_dim=probe_tp)
        info = evaluate_subjective_model_with_shared(task, val, mesh)
        out.update({"bf16.probe.train_loss": res.train_loss, "bf16.probe.val_loss": res.val_loss,
                    "bf16.probe.val_acc": res.val_acc,
                    "bf16.probe.fused_acc": np.array([info["fused"]["accuracy"]])})
        out.update({f"bf16.probe.{k}": v.detach().cpu().numpy()
                    for k, v in task.model.named_parameters()})

    fits = [tasks.build_probe_task(seed=10 + s, **probe) for s in range(MESH_SEEDS)]
    many = train_many(model=fits[0].model, params=stack_params([t.model for t in fits]),
                      loss_fn=fits[0].loss_fn, data=data, n_train=1600,
                      optimizer=fits[0].optimizer, epochs=2, batch_size=100,
                      randomness=[Randomness(20 + s, device) for s in range(MESH_SEEDS)],
                      val_fn=fits[0].val_fn, val_data=val, data_broadcast=True, mesh=mesh)
    out.update({"many.train_loss": many.train_loss.cpu().numpy(),
                "many.val_loss": many.val_loss.cpu().numpy(),
                "many.val_acc": many.val_acc.cpu().numpy()})
    out.update({f"many.{k}": v.cpu().numpy() for k, v in many.params.items()})

    n_dp = 1 if mesh is None else mesh.shape["data"]
    served = tasks.build_probe_task(seed=4, **probe)
    engine = ServingEngine(build_inference_fn(served, backbone=drawn, mesh=mesh), (256,),
                           divisor=n_dp)
    result = engine(tuple(x[1600:1850].cpu().numpy() for x in xs))
    out.update({f"serve.{k}": v for k, v in result.items()})
    return out


def mesh_rank(out_dir, backend, device="cuda:0"):
    """One rank of phase 27 (``chip_smoke.py --mesh-rank OUT_DIR BACKEND
    [DEVICE]``, with the launcher's environment): legs A-C on the mesh over
    every rank, on cuda:0, the head kernel's launches counted by shape;
    writes ``rank{r}.npz`` and ``rank{r}.json`` to OUT_DIR."""
    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck
    from disentagled_multimodal_fusion_tpu_torch.parallel import distributed as pdist
    from disentagled_multimodal_fusion_tpu_torch.parallel.mesh import make_mesh

    configure()
    pdist.initialize(backend=backend, device=device, timeout=MESH_TIMEOUT_S)
    mesh = make_mesh()
    with head_shape_tally() as shapes:
        ck.evidential_heads_stacked.launches = 0
        out = mesh_legs(mesh, device)
        launches = ck.evidential_heads_stacked.launches
    out_dir = Path(out_dir)
    np.savez(out_dir / f"rank{mesh.rank}.npz", **out)
    (out_dir / f"rank{mesh.rank}.json").write_text(json.dumps(
        {"launches": launches, "shapes": dict(shapes), "backend": backend,
         "world": pdist.world_size()}))
    return 0


def mesh_expected_shapes(n_dp):
    """Leg A's validation (3 epochs) and evaluation at (7, 400 / n_dp), leg
    B's vmapped validation (2 epochs) at (4 / n_dp x 7, 400), leg C's one
    request at (7, 256 / n_dp)."""
    return {shape_key(7, 400 // n_dp, 200, 128, 10): 4,
            shape_key(MESH_SEEDS // n_dp * 7, 400, 200, 128, 10): 2,
            shape_key(7, 256 // n_dp, 200, 128, 10): 1}


# leg A's probe parameters, norm-wise: a step's gradient summed over two ranks
# rounds apart from one rank's, and Adam's normalisation turns that into steps
# of the learning rate where a gradient is near zero (in float64 the two-rank
# probe fit equals the one-process fit to 2e-15, the CPU; PERF.md section 2)
MESH_PROBE_NORM_TOL = 1e-2
# leg A's probe validation loss, computed from those parameters (PERF.md
# section 2: 5.1e-5 apart at world size 2)
MESH_PROBE_VAL_RTOL = 5e-4
# (b): the run's late fusions, fitted on the raw views, within one of
# HandWritten's 400 test rows of one process (readings 0.0000 in three
# calls); the DMVAE backbone's last train loss as printed (four decimals,
# about 1.12) within 1e-4, and each of its weight tensors within 1e-3 of its
# norm (Adam turns the split sums' rounding into lr-sized steps on inputs
# whose gradient is near zero: 30 entries of encoder.w1 up to 2.5e-4 apart
# on the card, PERF.md section 2, so not elementwise); and the three probes' fused
# accuracies within 0.03, held beside those:
# the probes train two epochs on embeddings of that backbone, whose last
# float32 digits the split sums set apart, and their accuracies of 0.78-0.85
# after two epochs turn that into a few rows (readings -0.0125, -0.0025,
# +0.0225, the same in three calls; one process equals itself bit for bit;
# PERF.md section 2)
RUN_DP_LATE_GAP = 1 / 400
RUN_DP_LOSS_GAP = 1e-4
RUN_DP_BACKBONE_NORM_TOL = 1e-3
RUN_DP_ACC_GAP = 0.03
LATE_FUSIONS = ("dbf_fusion", "cml_fusion", "avg_fusion")


def compare_mesh_legs(got, ref, label):
    """A rank's legs against the run without a mesh: losses rtol 2e-5 /
    atol 2e-6 and the DMVAE's and train_many's parameters rtol 5e-3 / atol
    5e-5 (phase 12's); the probe's parameters within 1e-2 of each tensor's
    Frobenius norm (``MESH_PROBE_NORM_TOL``); validation and fused
    accuracies to 1e-6 (a sum of the ranks' weighted means); served outputs
    at phase 5's tolerances with ``pred`` equal but for ties. Returns the
    largest elementwise gap and the largest norm-wise one."""
    worst, worst_norm = 0.0, 0.0
    t = torch.from_numpy
    for key, want in ref.items():
        if key.startswith("serve."):
            continue
        have = got[key]
        if key.endswith(("val_acc", "fused_acc")):
            assert_close(t(np.asarray(have)), t(np.asarray(want)), f"{label} {key}", rtol=0,
                         atol=1e-6)
        elif key == "probe.val_loss":
            assert_close(t(np.asarray(have)), t(np.asarray(want)), f"{label} {key}",
                         rtol=MESH_PROBE_VAL_RTOL, atol=0)
        elif key.endswith(("train_loss", "val_loss")):
            assert_close(t(np.asarray(have)), t(np.asarray(want)), f"{label} {key}",
                         **MESH_LOSS_TOL)
        elif key.startswith("probe."):
            gap = float(np.linalg.norm(have - want) / np.linalg.norm(want))
            if not gap <= MESH_PROBE_NORM_TOL:
                raise AssertionError(f"{label} {key}: {gap:.3e} of its norm apart")
            worst_norm = max(worst_norm, gap)
        else:
            worst = max(worst, assert_close(t(have), t(want), f"{label} {key}",
                                            **MESH_PARAM_TOL)[0])
    assert_outputs_match({k[6:]: got[k] for k in got if k.startswith("serve.")},
                         {k[6:]: ref[k] for k in ref if k.startswith("serve.")}, f"{label} serve")
    return worst, worst_norm


def last_train_loss(text):
    """The backbone's last train loss a runner printed."""
    found = re.search(r"dmvae fit[^\n]*last train loss ([0-9.]+)", text)
    if found is None:
        raise AssertionError("no last train loss of the dmvae fit in the runner's output")
    return float(found.group(1))


def ms_per_epoch(text, what):
    """The ms/epoch a runner printed for ``what`` ('dmvae fit' or a head)."""
    found = re.search(rf"{re.escape(what)}[^\n]*?([0-9.]+) ms/epoch", text)
    if found is None:
        raise AssertionError(f"no ms/epoch for {what!r} in the runner's output")
    return float(found.group(1))


def start_mesh_legs(scratch):
    """Phase 27 (a)'s ranks: legs A-C as subprocesses at world size 1 over
    NCCL and 2 over gloo (both ranks on cuda:0), started at once."""
    here = Path(__file__).resolve()
    runs = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        out_dir = scratch / f"legs{world}"
        out_dir.mkdir()
        runs[world] = (out_dir, backend, spawn_ranks(
            [sys.executable, str(here), "--mesh-rank", str(out_dir), backend], world))
    return runs


def check_mesh_legs(card, runs, ref):
    """Phase 27 (a): every rank of ``runs`` equal bit for bit, each held
    against ``ref``, the legs without a mesh. Returns the head kernel's
    launches over the ranks and its shapes a rank, by world size."""
    launches, shapes = {}, {}
    for world, (out_dir, backend, procs) in runs.items():
        wait_all(procs, f"mesh legs at world size {world}")
        ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]
        for r, rank in enumerate(ranks[1:], 1):
            for key, value in ranks[0].items():
                if not np.array_equal(rank[key], value):
                    raise AssertionError(f"mesh world {world}: rank {r} differs from rank 0 at "
                                         f"{key}")
        worst, worst_norm = compare_mesh_legs(ranks[0], ref, f"mesh world {world} ({backend})")
        tallies = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
        want = mesh_expected_shapes(world)
        for r, tally in enumerate(tallies):
            if tally["shapes"] != want or tally["launches"] != sum(want.values()):
                raise AssertionError(f"mesh world {world} rank {r}: head kernel launched "
                                     f"{tally['launches']} times at {tally['shapes']}, "
                                     f"expected {want}")
        launches[world] = sum(t["launches"] for t in tallies)
        shapes[world] = want
        log(f"mesh: legs A-C at world size {world} over {backend}: every rank equal bit for "
            f"bit, held to the run without a mesh (losses rtol 2e-5 / atol 2e-6; DMVAE and "
            f"train_many params max abs err {worst:.3e}; probe params {worst_norm:.3e} of "
            f"their norm; served outputs at phase 5's tolerances); head kernel "
            f"{tallies[0]['launches']} launches a rank at {want} [{card}]")
    return launches, shapes


def backbone_weights(root):
    """The HandWritten Normal seed-0 DMVAE checkpoint a run wrote under
    ``root``."""
    from disentagled_multimodal_fusion_tpu_torch.core.checkpoint import checkpoint_file
    from disentagled_multimodal_fusion_tpu_torch.runners.common import backbone_checkpoint

    path = checkpoint_file(str(Path(root) / backbone_checkpoint("HandWritten", 0, "normal")))
    return torch.load(path, map_location="cpu", weights_only=True)


def mesh_runner_phase(card, scratch):
    """Phase 27 (b): runners/run.py on HandWritten Normal seed 0 --quick,
    in this process without a mesh, then as two gloo ranks on cuda:0 with
    --data-parallel 2, held to it by :func:`ranks_against_one_process`.
    Nothing else runs meanwhile. Returns the one-process run
    (``OneProcess``: its rows, output and backbone weights)."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    one_out = io.StringIO()
    with artifact_root("mesh_one_") as one_root, contextlib.redirect_stdout(one_out):
        one_rows = runner.main(RUNNER_CELL + ["--skip-report"])
        one_bb = backbone_weights(one_root)
    one = OneProcess(one_rows, one_out.getvalue(), one_bb)
    dp_root = scratch / "dp"
    dp_root.mkdir()
    ranks_against_one_process(card, "mesh", ["--data-parallel", "2"], {"data": 2, "model": 1},
                              dp_root, one)
    return one


RUNNER_CELL = ["--seeds", "0", "--datasets", "HandWritten", "--conditions", "Normal", "--quick"]


def ranks_against_one_process(card, label, flags, shape, root, one):
    """``runners/run.py RUNNER_CELL flags`` as two gloo ranks on cuda:0
    under ``root``, against ``one`` (the same cell in one process): the
    mesh ``shape`` over gloo, every row finite, the DMVAE backbone's last
    train loss within ``RUN_DP_LOSS_GAP`` and its checkpoint (the
    one-process names and shapes) within ``RUN_DP_BACKBONE_NORM_TOL`` of
    each tensor's norm, each late fusion's fused accuracy within one test
    row (``RUN_DP_LATE_GAP``) and each probe's within ``RUN_DP_ACC_GAP``,
    and both runs' host time per epoch logged."""
    what = "run.py " + " ".join(flags)
    procs = spawn_ranks(
        [sys.executable, "-m", "disentagled_multimodal_fusion_tpu_torch.runners.run",
         *RUNNER_CELL, *flags, "--device", "cuda:0", "--rows-file", str(root / "rows.json")],
        2, env={"DMF_ARTIFACT_ROOT": str(root)})
    t0 = time.perf_counter()
    outs = wait_all(procs, what)
    wall = time.perf_counter() - t0
    if f"mesh: {shape} over 2 rank(s) (gloo)" not in outs[0]:
        raise AssertionError(f"{what} with both ranks on cuda:0 did not build a {shape} mesh "
                             f"over gloo")
    rows = json.loads((root / "rows.json").read_text())["0"]["Normal"]["HandWritten"]
    one_rows = one.rows[0]["Normal"]["HandWritten"]
    gaps = {name: rows[name]["fused"]["accuracy"] - info["fused"]["accuracy"]
            for name, info in one_rows.items()}
    log(f"{label}: {what} (gloo, both ranks on cuda:0), HandWritten Normal seed 0 --quick: "
        "fused accuracies " + ", ".join(
            f"{n} {rows[n]['fused']['accuracy']:.4f} ({gaps[n]:+.4f})" for n in one_rows)
        + f" against one process; {wall:.1f} s for both ranks [{card}]")
    bb = backbone_weights(root)
    if set(bb) != set(one.backbone):
        raise AssertionError(f"{what}: the DMVAE checkpoint's keys differ")
    worst, worst_norm = 0.0, 0.0
    for k, want in one.backbone.items():
        if bb[k].shape != want.shape:
            raise AssertionError(f"{what}: DMVAE {k} has shape {tuple(bb[k].shape)}, one "
                                 f"process's {tuple(want.shape)}")
        diff = bb[k].double() - want.double()
        gap = float(diff.norm() / want.double().norm().clamp_min(1e-30))
        if not gap <= RUN_DP_BACKBONE_NORM_TOL:
            raise AssertionError(f"{what}: DMVAE {k} {gap:.3e} of its norm from one process's")
        worst, worst_norm = max(worst, float(diff.abs().max())), max(worst_norm, gap)
    losses = (last_train_loss(one.text), last_train_loss(outs[0]))
    log(f"{label}: {what}: DMVAE backbone last train loss {losses[1]:.4f} against one "
        f"process's {losses[0]:.4f}; its weights {worst_norm:.3e} of their norm from one "
        f"process's (max abs err {worst:.3e}) [{card}]")
    if abs(losses[1] - losses[0]) > RUN_DP_LOSS_GAP + 1e-9:
        raise AssertionError(f"{what}: the DMVAE's last train loss differs")
    for fit in ("dmvae fit", "dmvae_cml", "cml_fusion"):
        log(f"{label}: host time per epoch of {fit}: one process "
            f"{ms_per_epoch(one.text, fit):.3f} ms, {' '.join(flags)} rank 0 "
            f"{ms_per_epoch(outs[0], fit):.3f} ms (16 steps an epoch) [{card}]")
    for name in one_rows:
        if not all(np.isfinite(v) for v in _numbers(rows[name])):
            raise AssertionError(f"{what}: {name} has a value not finite")
        limit = RUN_DP_LATE_GAP if name in LATE_FUSIONS else RUN_DP_ACC_GAP
        if abs(gaps[name]) > limit + 1e-9:
            raise AssertionError(f"{what}: {name} fused accuracy {gaps[name]:+.4f} from one "
                                 f"process's (limit {limit:.4f})")


class OneProcess(collections.namedtuple("OneProcess", "rows text backbone")):
    """Phase 27 (b)'s one-process run.py: its rows, its output and its
    DMVAE backbone's checkpoint."""


def start_mesh_sweep(scratch):
    """Phase 27 (c)'s sweep: runners/sweep_parallel.py --procs 2 with both
    workers on the card over HandWritten and CUB --quick."""
    return subprocess.Popen(
        [sys.executable, "-m", "disentagled_multimodal_fusion_tpu_torch.runners.sweep_parallel",
         "--procs", "2", "--worker-env", "CUDA_VISIBLE_DEVICES=0", "--datasets", "HandWritten",
         "CUB", "--seeds", "0", "--conditions", "Normal", "--quick"],
        env=dict(os.environ, DMF_ARTIFACT_ROOT=str(scratch / "sweep")),
        cwd=str(Path(__file__).resolve().parent),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def check_mesh_sweep(card, scratch, out, want):
    """Phase 27 (c): the sweep's merged rows equal one process's (``want``,
    by dataset) at rtol 1e-6, and each worker's log names the card."""
    from disentagled_multimodal_fusion_tpu_torch.runners.sweep_parallel import merge_rows

    sweep_root = scratch / "sweep"
    merged = merge_rows([sweep_root / "logs" / f"sweep_rows_w{r}.json" for r in range(2)])
    worst = 0.0
    for ds, models in want.items():
        for name, info in models.items():
            a = np.asarray(_numbers(merged[0]["Normal"][ds][name]), np.float64)
            b = np.asarray(_numbers(info), np.float64)
            if a.shape != b.shape or not np.isclose(a, b, rtol=1e-6, atol=0,
                                                    equal_nan=True).all():
                raise AssertionError(f"sweep_parallel: {ds} {name} differs from one process")
            worst = max(worst, float(np.max(np.abs(a - b)[np.isfinite(b)], initial=0.0)))
    for r in range(2):
        if torch.cuda.get_device_name(0) not in (
                sweep_root / "logs" / f"sweep_worker_{r}.log").read_text():
            raise AssertionError(f"sweep worker {r}'s log does not name the card")
    if "parallel sweep (2 workers, 2 datasets) done" not in out:
        raise AssertionError("sweep_parallel did not report its sweep done")
    log(f"mesh: sweep_parallel --procs 2 --worker-env CUDA_VISIBLE_DEVICES=0 (HandWritten, CUB "
        f"--quick): merged rows equal one process's at rtol 1e-6 (max abs diff {worst:.3e}), "
        f"each worker's log names the card [{card}]")


def phase_mesh(card):
    """Phase 27, the mesh on the one card: (a) legs A-C, (b) run.py
    --data-parallel 2, (c) sweep_parallel.py --procs 2. (a)'s ranks and
    (c)'s workers run at once, while this process runs (a)'s legs and (c)'s
    CUB cell without a mesh; (b), whose host times are read, runs alone
    after them, and its one-process HandWritten rows are (c)'s too. Returns
    the head kernel's launches over the ranks' legs and their shapes a rank,
    by world size, and (b)'s one-process run."""
    import shutil
    import tempfile

    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    scratch = Path(tempfile.mkdtemp(prefix="mesh_",
                                    dir=Path(__file__).resolve().parent / "chip_scratch"))
    procs = []
    try:
        t0 = time.perf_counter()
        runs = start_mesh_legs(scratch)
        procs = [p for _, _, ranks in runs.values() for p in ranks]
        sweep = start_mesh_sweep(scratch)
        procs.append(sweep)
        ref = mesh_legs(None)
        log(f"mesh: legs A-C without a mesh in {time.perf_counter() - t0:.1f} s [{card}]")
        with artifact_root("mesh_cub_"), contextlib.redirect_stdout(io.StringIO()):
            cub = runner.main(["--seeds", "0", "--datasets", "CUB", "--conditions", "Normal",
                               "--quick", "--skip-report"])
        launches, shapes = check_mesh_legs(card, runs, ref)
        sweep_out = wait_all([sweep], "sweep_parallel --procs 2")[0]
        log(f"mesh: (a) and (c)'s sweep done in {time.perf_counter() - t0:.1f} s [{card}]")
        one = mesh_runner_phase(card, scratch)
        check_mesh_sweep(card, scratch, sweep_out, {
            "HandWritten": one.rows[0]["Normal"]["HandWritten"], "CUB": cub[0]["Normal"]["CUB"]})
        return launches, shapes, one
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(scratch, ignore_errors=True)


# ------------------------------------------------------------------ phase 28: the model axis
# the hidden widths phase 28's single fits cut (the JAX runner's
# tp_hidden_dim at HandWritten: dmvae.hidden_dim, probes.model_hidden_dim)
MODEL_CUT = {"dmvae": 512, "probe": 128}
MODEL_WORLDS = (2, 4)  # gloo clusters on cuda:0: meshes 1 x 2 and 2 x 2
MODEL_STEP_TOL = dict(rtol=1e-4, atol=1e-5)  # the first step's loss and gradients
MODEL_DMVAE_NORM_TOL = 1e-3  # the DMVAE's weights, of each tensor's norm
MODEL_ACC_GAP = 1 / 400      # validation and fused accuracies: one of 400 rows
# the bf16 leg: the losses at tests/test_torch_bf16.py's bound
# (assert_bf16_close); each first-step gradient and each of the probe's
# trained weights as close to the float32 leg's (the same weights and draws)
# as one bf16 process's, within 25 %, norm-wise. The bf16 rule's outlier
# bound is an activation's: a gradient sums many rounded terms that cancel,
# and under the data split each rank's weight gradient is rounded before the
# sum, so the mesh's bf16 step sits up to 1.0 times one process's distance
# from the float32 step away from one process's step (8.4 times the rule's
# outlier bound) while no farther from the float32 step (0.89-1.05 times;
# the probe's weights 1.00-1.06 times, 1.0e-2 of their norm from one
# process's; the CPU at full width, PERF.md section 6); a wrong collective
# moves a gradient by about its own size, 21-420 times that distance. The
# probe's accuracies within four of the 400 rows (a bf16 logit's one-ulp
# rounding can flip a near tie)
MODEL_BF16_RATIO = 1.25
MODEL_BF16_ACC_GAP = 4 / 400
# the bf16 head kernel's launches a rank in the bf16 probe fit: three
# validations and one evaluation at its data index's rows
MODEL_BF16_LAUNCHES = 4


def model_rank(out_dir):
    """One rank of phase 28 (a) (``chip_smoke.py --model-rank OUT_DIR``,
    with the launcher's environment): legs A-C with the cut on
    ``make_mesh(model_parallel=2)`` over gloo, on cuda:0, the head kernel's
    and the epoch kernel's launches counted (the head's by shape); writes
    ``rank{r}.npz`` and ``rank{r}.json`` to OUT_DIR."""
    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck
    from disentagled_multimodal_fusion_tpu_torch.ops import probe_megakernel as pm
    from disentagled_multimodal_fusion_tpu_torch.parallel import distributed as pdist
    from disentagled_multimodal_fusion_tpu_torch.parallel.mesh import make_mesh

    configure()
    torch.set_num_threads(1)
    pdist.initialize(backend="gloo", device="cuda:0", timeout=MESH_TIMEOUT_S)
    mesh = make_mesh(model_parallel=2)
    with head_shape_tally() as shapes:
        ck.evidential_heads_stacked.launches = 0
        ck.evidential_heads_stacked_bf16.launches = 0
        pm.run_epoch_kernel.launches = 0
        memory = {}
        out = mesh_legs(mesh, "cuda:0", cut=True, memory=memory)
        launches, epochs = ck.evidential_heads_stacked.launches, pm.run_epoch_kernel.launches
        bf16_launches = ck.evidential_heads_stacked_bf16.launches
    out_dir = Path(out_dir)
    np.savez(out_dir / f"rank{mesh.rank}.npz", **out)
    (out_dir / f"rank{mesh.rank}.json").write_text(json.dumps(
        {"launches": launches, "bf16_launches": bf16_launches, "epoch_launches": epochs,
         "shapes": dict(shapes), "mesh": [mesh.data_index, mesh.model_index],
         "memory": memory}))
    return 0


def log_memory(label, memory, card):
    """Prints phase 28 (a)'s memory readings of one process
    (:func:`memory_watch`) and holds each fit's resident bytes to the count
    its plan gives, exactly."""
    for name, m in memory.items():
        log(f"{label}: {name} fit at its last step holds {m['resident']} bytes "
            f"({m['resident'] / 1e6:.2f} MB) of parameters and Adam moments (planned "
            f"{m['planned']}); torch.cuda.memory_allocated {m['allocated'] / 1e6:.2f} MB, peak "
            f"through its steps {m['peak_steps'] / 1e6:.2f} MB, over the whole fit (its end's "
            f"gathers too) {m['peak'] / 1e6:.2f} MB [{card}]")
        if m["resident"] != m["planned"]:
            raise AssertionError(f"{label}: the {name} fit holds {m['resident']} bytes of "
                                 f"parameters and moments, its plan {m['planned']}")


def compare_model_legs(got, ref, label):
    """A rank's legs with the cut against the legs without a mesh (the
    limits of the module docstring's phase 28 (a)). Returns the largest
    elementwise gap of the float32 first steps and the largest norm-wise
    gap of the DMVAE's and the probe's weights, and the largest ratio of
    the bf16 leg's distance from the float32 leg to one process's."""
    t = torch.from_numpy
    worst_step, worst_norm = 0.0, {"dmvae": 0.0, "probe": 0.0, "bf16": 0.0}
    assert set(got) == set(ref), set(got) ^ set(ref)
    for key, want in ref.items():
        have = np.asarray(got[key])
        want = np.asarray(want)
        kind = key.split(".")[0]
        if key.startswith("serve."):
            continue
        if kind == "bf16" and not key.endswith(("_loss", "_acc")):
            # gradients and weights: both bf16 runs' distance from the
            # float32 leg's on the same weights and draws, norm-wise
            f32 = ref[key[5:]].astype(np.float64)
            own = np.linalg.norm(want.astype(np.float64) - f32)
            ratio = float(np.linalg.norm(have.astype(np.float64) - f32) / max(own, 1e-30))
            if not ratio <= MODEL_BF16_RATIO:
                raise AssertionError(f"{label} {key}: {ratio:.3f} times one process's bf16 "
                                     f"distance from the float32 leg")
            worst_norm["bf16"] = max(worst_norm["bf16"], ratio)
        elif kind == "bf16" and key.endswith(("step_loss", "_loss")):
            assert_bf16_close(t(have).reshape(-1), t(want).reshape(-1), f"{label} {key}")
        elif kind == "bf16" and key.endswith(("val_acc", "fused_acc")):
            gap = float(np.max(np.abs(have - want)))
            if gap > MODEL_BF16_ACC_GAP + 1e-9:
                raise AssertionError(f"{label} {key}: {gap:.4f} apart")
        elif ".grad." in key or key.endswith("step_loss"):
            worst_step = max(worst_step, assert_close(t(have), t(want), f"{label} {key}",
                                                      **MODEL_STEP_TOL)[0])
        elif key.endswith(("val_acc", "fused_acc")):
            gap = float(np.max(np.abs(have - want)))
            if gap > MODEL_ACC_GAP + 1e-9:
                raise AssertionError(f"{label} {key}: {gap:.4f} apart")
        elif key == "probe.val_loss":
            assert_close(t(have), t(want), f"{label} {key}", rtol=MESH_PROBE_VAL_RTOL, atol=0)
        elif key.endswith(("train_loss", "val_loss")):
            assert_close(t(have), t(want), f"{label} {key}", **MESH_LOSS_TOL)
        elif kind in worst_norm:
            gap = float(np.linalg.norm(have - want) / max(np.linalg.norm(want), 1e-30))
            limit = MODEL_DMVAE_NORM_TOL if kind == "dmvae" else MESH_PROBE_NORM_TOL
            if not gap <= limit:
                raise AssertionError(f"{label} {key}: {gap:.3e} of its norm apart")
            worst_norm[kind] = max(worst_norm[kind], gap)
        else:
            assert_close(t(have), t(want), f"{label} {key}", **MESH_PARAM_TOL)
    assert_outputs_match({k[6:]: got[k] for k in got if k.startswith("serve.")},
                         {k[6:]: ref[k] for k in ref if k.startswith("serve.")}, f"{label} serve")
    return worst_step, worst_norm


def phase_model_axis_legs(card):
    """Phase 28 (a): the model-axis clusters at world sizes 2 and 4, started
    together, against the legs without a mesh run here meanwhile. Returns
    the head kernel's launches over each cluster's ranks and its shapes a
    rank, by world size, of its f32 build and of its bf16 build."""
    import shutil
    import tempfile

    here = Path(__file__).resolve()
    scratch = Path(tempfile.mkdtemp(prefix="model_", dir=here.parent / "chip_scratch"))
    runs, procs = {}, []
    try:
        for world in MODEL_WORLDS:
            out_dir = scratch / f"world{world}"
            out_dir.mkdir()
            runs[world] = spawn_ranks([sys.executable, str(here), "--model-rank", str(out_dir)],
                                      world)
            procs += runs[world]
        ref_memory = {}
        ref = mesh_legs(None, "cuda:0", cut=True, memory=ref_memory)
        log_memory("model axis: no mesh", ref_memory, card)
        launches, shapes, bf16_launches, bf16_shapes = {}, {}, {}, {}
        for world in MODEL_WORLDS:
            wait_all(runs[world], f"model axis at world size {world}")
            out_dir = scratch / f"world{world}"
            ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]
            tallies = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
            for r in range(world):
                first = r - r % 2  # the model group's first rank
                for key, value in ranks[first].items():
                    if not np.array_equal(ranks[r][key], value):
                        raise AssertionError(f"model axis world {world}: rank {r} differs from "
                                             f"rank {first} of its model group at {key}")
            worst_step, worst_norm = 0.0, {}
            for r in range(0, world, 2):
                step, norm = compare_model_legs(ranks[r], ref, f"model axis world {world} "
                                                               f"rank {r}")
                worst_step = max(worst_step, step)
                worst_norm = {k: max(worst_norm.get(k, 0.0), v) for k, v in norm.items()}
            want = mesh_expected_shapes(world // 2)
            want_bf16 = {shape_key(7, 400 // (world // 2), 200, 128, 10) + ",bf16":
                         MODEL_BF16_LAUNCHES}
            for r, tally in enumerate(tallies):
                log_memory(f"model axis: world {world} rank {r} (mesh {world // 2} x 2)",
                           tally["memory"], card)
                if (tally["shapes"] != {**want, **want_bf16}
                        or tally["launches"] != sum(want.values())
                        or tally["bf16_launches"] != MODEL_BF16_LAUNCHES
                        or tally["epoch_launches"] != 0):
                    raise AssertionError(
                        f"model axis world {world} rank {r}: head kernel launched "
                        f"{tally['launches']} + {tally['bf16_launches']} (bf16) times at "
                        f"{tally['shapes']} (expected {want} and {want_bf16}), epoch kernel "
                        f"{tally['epoch_launches']} times (expected 0)")
            launches[world] = sum(t["launches"] for t in tallies)
            bf16_launches[world] = sum(t["bf16_launches"] for t in tallies)
            shapes[world], bf16_shapes[world] = want, want_bf16
            log(f"model axis: legs A-C with the cut (DMVAE 512, probe 128) at world size "
                f"{world} (mesh {world // 2} x 2, gloo, every rank on cuda:0): the ranks of "
                f"each model group equal bit for bit; held to the legs without a mesh: first "
                f"steps' losses and gradients max abs err {worst_step:.3e} (rtol 1e-4 / atol "
                f"1e-5), weights {worst_norm['dmvae']:.3e} (DMVAE) and "
                f"{worst_norm['probe']:.3e} (probe) of their norm; bf16: the first steps' "
                f"gradients and the probe's weights at most {worst_norm['bf16']:.3f} times "
                f"one process's distance from the f32 leg, losses within the bf16 bound; head kernel {tallies[0]['launches']} launches a rank on the "
                f"gathered weights at {want}, its bf16 build {MODEL_BF16_LAUNCHES} at "
                f"{want_bf16}, epoch kernel 0 [{card}]")
        return launches, shapes, bf16_launches, bf16_shapes
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(scratch, ignore_errors=True)


def phase_model_runner(card, one):
    """Phase 28 (b): runners/run.py --model-parallel 2 as two gloo ranks on
    cuda:0, HandWritten Normal seed 0 --quick, against ``one`` (phase 27
    (b)'s one-process run) at phase 27 (b)'s limits
    (:func:`ranks_against_one_process`). Runs alone."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="model_run_",
                                 dir=Path(__file__).resolve().parent / "chip_scratch"))
    try:
        ranks_against_one_process(card, "model axis", ["--model-parallel", "2"],
                                  {"data": 1, "model": 2}, root, one)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ phase 29: unfused heads
# the first epochs of HandWritten's head fits (the sweep's 200-epoch schedules,
# lr 3e-3, dropout 0.1, annealing from epoch 50) on random embeddings of the
# backbone's shapes, Zc and Zp of 200 for 6 views, and on the raw views
UNFUSED_EPOCHS = 5
UNFUSED_ACC_GAP = 1 / 400  # validation accuracy: one of the 400 rows
UNFUSED_LOSS_TOL = dict(rtol=2e-5, atol=2e-6)  # phase 12's, and the epoch kernel's
UNFUSED_PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
# On random embeddings these fits turn chaotic from about the third epoch
# (a CPU rehearsal at full width: the stacked probe through the step loop
# and through the epoch kernel's plain version, from the same weights and
# draws, part by up to the learning rate in 5790 of 179 200 entries of w1
# after five epochs, while every gradient is ~3e-5 and Adam steps each entry
# by about the learning rate). So, as tests/test_torch_intermediate.py
# holds its chaotic lft fit, the unfused fit with its weights in float64
# (the evidence and the loss stay float32) on the same weights and draws
# measures how far float32 rounding alone moves each result: a
# stacked fit must lie within twice that distance of the unfused float32
# fit, plus the tolerances above (losses and accuracies elementwise, each
# parameter tensor by its norm). A fit that is not chaotic meets the
# tolerances alone.
UNFUSED_SPREAD = 2.0


def unfused_fits(device):
    """(name, builder, keyword arguments, train data, validation data) of
    phase 29's three models on ``device``."""
    from disentagled_multimodal_fusion_tpu_torch.core import tasks
    from disentagled_multimodal_fusion_tpu_torch.data.multiview import DATASET_REGISTRY

    views, labels = DATASET_REGISTRY["HandWritten"]().arrays()
    xs = tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device) for v in views)
    y = torch.from_numpy(labels).to(device)
    g = torch.Generator().manual_seed(29)
    zc = torch.randn(len(y), 200, generator=g).to(device)
    zp = torch.randn(len(y), len(xs), 200, generator=g).to(device)
    emb = {"zc": zc, "zp": zp, "y": y}
    raw = {"xs": xs, "y": y}

    def split(data):
        def rows(sl):
            return {k: (tuple(x[sl] for x in v) if isinstance(v, tuple) else v[sl])
                    for k, v in data.items()}
        return rows(slice(0, 1600)), rows(slice(1600, None))

    head = dict(num_classes=10, hidden_dim=(128,), lr=3e-3, dropout=0.1, annealing_start=50,
                device=device)
    probe = dict(head, num_modalities=len(xs), input_dim=200, num_epochs=200)
    return [("dmvae_cml", tasks.build_probe_task, dict(probe, aggregation="cml"), *split(emb)),
            ("dmvae_dis", tasks.build_disentangled_probe_task, probe, *split(emb)),
            ("cml_fusion", tasks.build_late_fusion_task,
             dict(head, output_dims=[x.shape[1] for x in xs], aggregation="cml"), *split(raw))]


def _as(data, dtype):
    """``data`` with its floating tensors in ``dtype``."""
    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t
    return {k: (tuple(cast(x) for x in v) if isinstance(v, tuple) else cast(v))
            for k, v in data.items()}


def hold_to_unfused(label, res, state, ref, ref_state, exact, exact_state):
    """A stacked fit (``res``, its state dict) against the unfused float32
    fit (``ref``, its state stacked), with the unfused float64 fit
    (``exact``, ``exact_state``) measuring how far float32 rounding moves
    each result (``UNFUSED_SPREAD``). Returns (the largest loss gap, the
    largest accuracy gap, the largest parameter gap as a share of its
    bound, and the parameter entries beyond ``UNFUSED_PARAM_TOL`` alone)."""
    worst_loss = 0.0
    for k in ("train_loss", "val_loss"):
        have, want = getattr(res, k), getattr(ref, k)
        spread = np.abs(want - getattr(exact, k))
        bound = (UNFUSED_SPREAD * spread + UNFUSED_LOSS_TOL["atol"]
                 + UNFUSED_LOSS_TOL["rtol"] * np.abs(want))
        gap = np.abs(have - want)
        if not np.all(gap <= bound):
            raise AssertionError(f"{label} {k}: {have} against {want} (float64 "
                                 f"{getattr(exact, k)})")
        worst_loss = max(worst_loss, float(gap.max()))
    acc = np.abs(res.val_acc - ref.val_acc)
    acc_bound = UNFUSED_SPREAD * np.abs(ref.val_acc - exact.val_acc) + UNFUSED_ACC_GAP + 1e-9
    if not np.all(acc <= acc_bound):
        raise AssertionError(f"{label} val_acc: {res.val_acc} against {ref.val_acc} (float64 "
                             f"{exact.val_acc})")
    if set(state) != set(ref_state):
        raise AssertionError(f"{label}: {set(state) ^ set(ref_state)}")
    share, beyond = 0.0, 0
    for k, want in ref_state.items():
        have, want, x = (t.double().cpu() for t in (state[k], want, exact_state[k]))
        tol = (UNFUSED_PARAM_TOL["atol"] + UNFUSED_PARAM_TOL["rtol"] * want.abs())
        bound = UNFUSED_SPREAD * float((want - x).norm()) + float(tol.norm())
        gap = float((have - want).norm())
        if not gap <= bound:
            raise AssertionError(f"{label} {k}: {gap:.3e} from the unfused fit, beyond {bound:.3e}")
        share = max(share, gap / bound)
        beyond += int(((have - want).abs() > tol).sum())
    return worst_loss, float(acc.max()), share, beyond


def phase_unfused_heads(ck, pm, card, device="cuda"):
    """Phase 29: each of dmvae_cml, dmvae_dis and cml_fusion fitted for
    ``UNFUSED_EPOCHS`` with one module per head (``fused_heads=False``,
    the step loop, plain PyTorch), in float32 and in float64, and with its
    heads stacked from the same weights (``convert.stack_heads``) and the
    same ``Randomness``: through the step loop and, for the probes, the
    epoch kernel, each held to the unfused fit (:func:`hold_to_unfused`).
    The unfused fits launch no kernel; a stacked fit the head kernel once
    per validation epoch, and through the epoch kernel that kernel once per
    epoch. Returns (the epoch kernel's launches, the head kernel's, its
    launches by shape, ms per epoch by fit); on the CPU (a rehearsal) the
    readings by fit and the ms per epoch."""
    from disentagled_multimodal_fusion_tpu_torch.convert import stack_heads
    from disentagled_multimodal_fusion_tpu_torch.core.train import Randomness, train

    epoch_total, head_total, ms, readings = 0, 0, {}, {}
    with head_shape_tally() as shapes:
        for name, build, kw, data, val in unfused_fits(device):
            unfused = build(fused_heads=False, seed=1, **kw)
            init = {k: v.clone() for k, v in unfused.model.state_dict().items()}
            engines = ["unfused", "exact", "step"] + (["megakernel"] if name != "cml_fusion"
                                                       else [])
            results = {}
            for engine in engines:
                one_a_head = engine in ("unfused", "exact")
                task = build(seed=2, fused_heads=not one_a_head, **kw)
                task.model.load_state_dict(init if one_a_head else stack_heads(init))
                if (task.megakernel is not None) != (engine in ("step", "megakernel")
                                                     and name != "cml_fusion"):
                    raise AssertionError(f"unfused {name} {engine}: epoch-kernel descriptor "
                                         f"{task.megakernel}")
                dtype = torch.float64 if engine == "exact" else torch.float32
                task.model.to(dtype)
                pm.run_epoch_kernel.launches = 0
                ck.evidential_heads_stacked.launches = 0
                sync(device)
                t0 = time.perf_counter()
                res = train(model=task.model, loss_fn=task.loss_fn, data=_as(data, dtype),
                            n_train=1600, optimizer=task.optimizer, epochs=UNFUSED_EPOCHS,
                            batch_size=100, randomness=Randomness(29, device),
                            val_fn=task.val_fn, val_data=_as(val, dtype),
                            megakernel=task.megakernel if engine == "megakernel" else None)
                sync(device)
                ms[f"{name}.{engine}"] = 1e3 * (time.perf_counter() - t0) / UNFUSED_EPOCHS
                epochs, heads = pm.run_epoch_kernel.launches, ck.evidential_heads_stacked.launches
                want = ((0, 0) if one_a_head or device == "cpu" else
                        (UNFUSED_EPOCHS if engine == "megakernel" else 0, UNFUSED_EPOCHS))
                if (epochs, heads) != want:
                    raise AssertionError(f"unfused {name} {engine}: the epoch kernel launched "
                                         f"{epochs} times and the head kernel {heads} (expected "
                                         f"{want})")
                epoch_total, head_total = epoch_total + epochs, head_total + heads
                state = task.model.state_dict()
                results[engine] = (res, stack_heads(state) if one_a_head else state)
            (ref, ref_state), (exact, exact_state) = results["unfused"], results["exact"]
            for engine in engines[2:]:
                res, state = results[engine]
                route = "epoch kernel" if engine == "megakernel" else "step loop"
                reading = hold_to_unfused(f"unfused {name} against the {route}", res, state,
                                          ref, ref_state, exact, exact_state)
                readings[f"{name}.{engine}"] = reading
                log(f"unfused heads: {name}, {UNFUSED_EPOCHS} epochs, one module a head against "
                    f"the stacked heads through the {route} from the same weights and draws: "
                    f"losses max abs err {reading[0]:.3e}, val_acc {reading[1]:.4f} apart, "
                    f"parameters at {reading[2]:.3f} of their bound ({reading[3]} entries beyond "
                    f"rtol 5e-3 / atol 5e-5 alone); ms/epoch {ms[f'{name}.unfused']:.2f} "
                    f"unfused, {ms[f'{name}.{engine}']:.2f} stacked [{card}]")
    if device == "cpu":
        return readings, ms
    log(f"unfused heads: epoch kernel {epoch_total} launches, head kernel {head_total} (by shape "
        f"{dict(shapes)}) [{card}]")
    return epoch_total, head_total, dict(shapes), ms


def _numbers(row):
    """A row's numbers in key order, without its wall times and path."""
    out = []
    for k, v in sorted(row.items()):
        if k in ("fit_seconds", "backbone_fit_seconds", "vmf_syncs_per_epoch", "path"):
            continue
        if isinstance(v, dict):
            out += _numbers(v)
        elif isinstance(v, list):
            for x in v:
                out += _numbers(x) if isinstance(x, dict) else list(np.ravel(x))
        else:
            out.append(float("nan") if v is None else float(v))
    return out


# ------------------------------------------------------------------ groups
# phases 11-24, 26, 28 (a) and 29 run in six child processes of this script
# (``--group NAME OUT``), beside phases 8-10 and 25 in this one: each path
# issues its steps from one host thread and leaves the card mostly idle, so
# the paths overlap on the host's cores. Phases 3-7 (kernel times, serving
# latency) run before them and phases 27 and 28 (b) (host times read) after
# them, alone. Each child counts its own kernel launches, set to 0 before
# each path and read after it, as in one process, and sends them back.
GROUPS = {"seed_batched": "11, 12, 13, 26", "synthetic": "14-17, 21", "cub": "18-20",
          "luma": "22-24", "model_axis": "28 (a)", "unfused": "29"}
GROUP_THREADS = 2  # torch's CPU threads a child: six children and this process share 8 cores
GROUP_TIMEOUT_S = 900


def run_group(name, ck, pm, card, timed):
    """The phases of group ``name`` in this process; returns what the
    kernels line needs of them."""
    if name == "seed_batched":
        with artifact_root("seed_batched_"), cut_config(SEED_BATCHED_CUT):
            with kept_checkpoints() as kept:
                launches, shapes, rows, wall = timed("phase 11 seed-batched",
                                                     phase_seed_batched, ck, card)
            timed("phase 12 seed-batched engines", phase_seed_batched_engines, card)
            timed("phase 13 restore", phase_restore, card, kept, rows)
            # on phase 13's checkpoints, before its artifact root goes
            export_launches = timed("phase 26 export", phase_export, ck, card)
        return {"launches": launches, "shapes": shapes, "wall": wall,
                "export_launches": export_launches}
    if name == "synthetic":
        with artifact_root("synthetic_dmvae_"):
            syn = timed("phase 14 synthetic", phase_synthetic, ck, pm, card, "dmvae")
            # the probes' checkpoints share their names, so DSSL has its own root
            with artifact_root("synthetic_dssl_"), cut_config(DSSL_CUT, "synthetic_config.yaml"):
                dssl = timed("phase 15 synthetic DSSL", phase_synthetic, ck, pm, card, "dssl")
            with artifact_root("synthetic_vmap_"):
                sb_launches, sb_shapes = timed("phase 16 synthetic seed-batched",
                                               phase_synthetic_seed_batched, ck, card)
            timed("phase 17 synthetic restore", phase_synthetic_restore, card, syn[0])
        prof_heads, prof_shapes = timed("phase 21 profile", phase_seed_batched_profile, ck, card)
        return {"head_launches": syn[2] + dssl[2] + sb_launches,
                "epoch_launches": syn[1] + dssl[1],
                "shapes": dict(collections.Counter(syn[3]) + collections.Counter(dssl[3])
                               + collections.Counter(sb_shapes)),
                "prof_heads": prof_heads, "prof_shapes": prof_shapes}
    if name == "cub":
        timed("phase 18 fusions", phase_fusions, card)
        _, im_epochs, im_heads, im_shapes, fused_bb_ms = timed(
            "phase 19 intermediate", phase_intermediate, ck, pm, card)
        uf_epochs, uf_heads, uf_shapes, _ = timed("phase 20 unfused DMVAE",
                                                  phase_unfused_dmvae, ck, pm, card, fused_bb_ms)
        return {"im_epochs": im_epochs, "im_heads": im_heads, "uf_epochs": uf_epochs,
                "uf_heads": uf_heads,
                "shapes": dict(collections.Counter(im_shapes) + collections.Counter(uf_shapes))}
    if name == "luma":
        with artifact_root("luma_") as root:
            corpus = luma_corpus(root)
            heads, shapes, fits = timed("phase 22 LUMA", phase_luma, ck, pm, card, root, corpus)
            with artifact_root("luma_vmap_"):
                sb_heads, sb_shapes = timed("phase 23 LUMA seed-batched",
                                            phase_luma_seed_batched, ck, pm, card, corpus, fits)
            bf16_heads, bf16_shapes = timed("phase 24 LUMA bf16", phase_luma_bf16, ck, pm, card,
                                            corpus, fits)
        return {"heads": heads, "shapes": shapes, "sb_heads": sb_heads, "sb_shapes": sb_shapes,
                "bf16_heads": bf16_heads, "bf16_shapes": bf16_shapes}
    if name == "model_axis":
        launches, shapes, bf16_launches, bf16_shapes = timed(
            "phase 28 (a) model axis legs", phase_model_axis_legs, card)
        return {"launches": launches, "shapes": shapes, "bf16_launches": bf16_launches,
                "bf16_shapes": bf16_shapes}
    if name == "unfused":
        epochs, heads, shapes, ms = timed("phase 29 unfused heads", phase_unfused_heads, ck, pm,
                                          card)
        return {"epoch_launches": epochs, "head_launches": heads, "shapes": shapes, "ms": ms}
    raise ValueError(f"no group {name!r}")


def group_child(name, out):
    """``chip_smoke.py --group NAME OUT``: group ``name``'s phases, their
    results pickled to OUT."""
    import pickle

    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck
    from disentagled_multimodal_fusion_tpu_torch.ops import probe_megakernel as pm

    configure()
    torch.set_num_threads(GROUP_THREADS)
    card = card_line()

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"{label} in {time.perf_counter() - t0:.1f} s [{card}]")
        return result

    results = run_group(name, ck, pm, card, timed)
    with open(out, "wb") as f:
        pickle.dump(results, f)
    return 0


def start_groups():
    """Start every group's child, each writing its output to a log in a
    scratch directory: {name: (process, scratch)}."""
    import tempfile

    here = Path(__file__).resolve()
    (here.parent / "chip_scratch").mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="groups_", dir=here.parent / "chip_scratch"))
    procs = {}
    for name in GROUPS:
        with open(scratch / f"{name}.log", "w") as out:
            procs[name] = (subprocess.Popen(
                [sys.executable, str(here), "--group", name, str(scratch / f"{name}.pkl")],
                cwd=str(here.parent), stdout=out, stderr=subprocess.STDOUT), scratch)
    return procs


def join_groups(procs):
    """Each group's results once its child exited 0, its output printed
    here; raises on a failed child or one past ``GROUP_TIMEOUT_S``."""
    import pickle

    deadline = time.monotonic() + GROUP_TIMEOUT_S
    results = {}
    for name, (proc, scratch) in procs.items():
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            log(f"---- group {name} (phases {GROUPS[name]}), its own process:")
            print((scratch / f"{name}.log").read_text(), end="", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"group {name} (phases {GROUPS[name]}) exited "
                                 f"{proc.returncode}")
        with open(scratch / f"{name}.pkl", "rb") as f:
            results[name] = pickle.load(f)
    return results


def stop_groups(procs):
    """Kill every child still running and remove the groups' scratch."""
    import shutil

    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for _, scratch in procs.values():
        shutil.rmtree(scratch, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--head-times"]:
        return head_times_only(card_line())
    if sys.argv[1:] == ["--epoch-times"]:
        return epoch_times_only(card_line())
    if sys.argv[1:] == ["--engine-times"]:
        return engine_times_only(card_line())
    if sys.argv[1:2] == ["--luma-state-trials"]:
        return luma_state_trials(card_line(), int(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(*sys.argv[2:5])
    if sys.argv[1:2] == ["--model-rank"]:
        return model_rank(sys.argv[2])
    if sys.argv[1:2] == ["--group"]:
        return group_child(*sys.argv[2:4])
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
        summary = ptxas_summary(info.log)
        for line in summary:
            log(f"  {line}")
        if name == pm.KERNEL_SOURCE:
            # every kernel of the epoch's launch plan went through the check above
            if epoch_source_kernels(pm) != EPOCH_KERNELS:
                raise AssertionError(f"{name}: the source defines {epoch_source_kernels(pm)}, "
                                     f"the launch plan is {EPOCH_KERNELS}")
            for kernel in EPOCH_KERNELS:
                if not any(re.search(rf"\b{kernel}\b", line) for line in summary):
                    raise AssertionError(f"{name}: ptxas reports nothing of {kernel}")

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
                                                 "library_ms", "backward_ms", "backward_bound_ms",
                                                 "backward_bound_by", "backward_library_ms")}
    serve_launches, serve_shapes = timed("phase 5 serving", phase_serving, ck, card)
    timed("phase 5 request profile", phase_request_profile, card)
    timed("phases 6-7 daemon and HTTP", phase_daemon_and_http, card)
    groups = start_groups()
    try:
        epoch_launches, train_head_launches, train_shapes, seq_wall, f32_accs = timed(
            "phase 8 training", phase_training, ck, pm, card)
        timed("phase 9 engines", phase_engines, card)
        timed("phase 10 vmapped heads", phase_vmapped_heads, ck, card)
        hw_bf16_heads, hw_bf16_shapes = timed("phase 25 HandWritten bf16", phase_training_bf16,
                                              ck, pm, card, f32_accs)
        t_join = time.perf_counter()
        g = join_groups(groups)
        log(f"groups (phases 11-24, 26, 28 (a), 29) joined {time.perf_counter() - t_join:.1f} s "
            f"after phase 25 [{card}]")
    finally:
        stop_groups(groups)
    sb_launches, sb_shapes, export_launches = (g["seed_batched"][k] for k in (
        "launches", "shapes", "export_launches"))
    log(f"seed-batched: {g['seed_batched']['wall'] / len(SEEDS):.1f} s per seed (phase 11); "
        f"the sequential seed-0 cell of phase 8 (full depth, probe fits through the epoch "
        f"kernel) took {seq_wall:.1f} s, each beside the other phases [{card}]")
    syn_head_launches, syn_epoch_launches, syn_shapes, prof_heads, prof_shapes = (
        g["synthetic"][k] for k in ("head_launches", "epoch_launches", "shapes", "prof_heads",
                                    "prof_shapes"))
    im_epochs, im_heads, uf_epochs, uf_heads, cub_shapes = (g["cub"][k] for k in (
        "im_epochs", "im_heads", "uf_epochs", "uf_heads", "shapes"))
    luma_heads, luma_shapes, luma_sb_heads, luma_sb_shapes, luma_bf16_heads, luma_bf16_shapes = (
        g["luma"][k] for k in ("heads", "shapes", "sb_heads", "sb_shapes", "bf16_heads",
                               "bf16_shapes"))
    mesh_launches, mesh_shapes, one = timed("phase 27 mesh", phase_mesh, card)
    timed("phase 28 (b) run.py --model-parallel 2", phase_model_runner, card, one)
    model_launches, model_shapes, model_bf16_launches, model_bf16_shapes = (
        g["model_axis"][k] for k in ("launches", "shapes", "bf16_launches", "bf16_shapes"))
    ph29_epochs, ph29_heads, ph29_shapes = (
        g["unfused"][k] for k in ("epoch_launches", "head_launches", "shapes"))

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
                     + export_launches + sum(mesh_launches.values())
                     + sum(model_launches.values()) + ph29_heads),
        "launches_by_path": {"serving": serve_launches, "training": train_head_launches,
                             "seed_batched": sb_launches, "synthetic": syn_head_launches,
                             "cub_intermediate": im_heads, "cub_unfused": uf_heads,
                             "scene_profile": prof_heads, "luma": luma_heads,
                             "luma_seed_batched": luma_sb_heads, "export": export_launches,
                             "mesh_world1": mesh_launches[1], "mesh_world2": mesh_launches[2],
                             "model_axis_world2": model_launches[2],
                             "model_axis_world4": model_launches[4],
                             "unfused_heads": ph29_heads,
                             "luma_bf16": 0, "handwritten_bf16": 0},
        "max_abs_err": max_abs_err,
        **timing,
        "device_ms_by_shape": device_by_shape,
        "times_by_shape": head_times_by_shape,
        "launches_by_shape": {"serving": serve_shapes, "training": train_shapes,
                              "seed_batched": sb_shapes, "synthetic": syn_shapes,
                              "cub": cub_shapes, "scene_profile": prof_shapes,
                              "luma": luma_shapes, "luma_seed_batched": luma_sb_shapes,
                              "mesh_per_rank_world1": mesh_shapes[1],
                              "mesh_per_rank_world2": mesh_shapes[2],
                              "model_axis_per_rank_world2": model_shapes[2],
                              "model_axis_per_rank_world4": model_shapes[4],
                              "unfused_heads": ph29_shapes},
    }, {
        "name": "evidential_head_bf16",
        "route": "cuda",
        "source": "disentagled_multimodal_fusion_tpu_torch/csrc/evidential_head.cu",
        "replaces": "disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53",
        "launches": (sum(luma_bf16_heads.values()) + hw_bf16_heads
                     + sum(model_bf16_launches.values())),
        "launches_by_path": {"luma_bf16": luma_bf16_heads["sequential"],
                             "luma_seed_batched_bf16": luma_bf16_heads["seed-batched"],
                             "handwritten_bf16": hw_bf16_heads, "mesh": 0,
                             "model_axis_world2": model_bf16_launches[2],
                             "model_axis_world4": model_bf16_launches[4]},
        "max_abs_err": bf16_abs_err,
        **bf16_timing,
        "times_by_shape": bf16_times_by_shape,
        "launches_by_shape": {"luma_bf16": luma_bf16_shapes["sequential"],
                              "luma_seed_batched_bf16": luma_bf16_shapes["seed-batched"],
                              "handwritten_bf16": hw_bf16_shapes,
                              "model_axis_per_rank_world2": model_bf16_shapes[2],
                              "model_axis_per_rank_world4": model_bf16_shapes[4]},
    }, {
        "name": "probe_epoch",
        "route": "cuda",
        "source": "disentagled_multimodal_fusion_tpu_torch/csrc/probe_epoch.cu",
        "replaces": "disentagled_multimodal_fusion_tpu/ops/probe_megakernel.py:246",
        "launches": (epoch_launches + syn_epoch_launches + im_epochs + uf_epochs
                     + ph29_epochs),
        "launches_by_path": {"training": epoch_launches, "synthetic": syn_epoch_launches,
                             "cub_intermediate": im_epochs, "cub_unfused": uf_epochs,
                             "unfused_heads": ph29_epochs,
                             "luma": 0, "luma_seed_batched": 0, "luma_bf16": 0,
                             "handwritten_bf16": 0, "mesh": 0, "model_axis": 0},
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
