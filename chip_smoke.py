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
   D = 16 and 32, fused = 0);
4. kernel, plain and library times (CUDA events, profiler device time)
   beside the least time the card could take for the same work, the head
   kernel's device time at every main-path shape (serving buckets,
   validation, the synthetic sweep); the profiler window of the probe epoch
   must hold exactly its four kernels, S launches each per epoch (S = 16 on
   HandWritten, 62 on the synthetic sweep), and nothing else but the
   wrapper's PyTorch operations;
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
    synthetic phases fit the script's time): every fused accuracy of every seed at
    least 0.95, the head kernel launched once per validation epoch and once
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
    per validation epoch and evaluation at (3, 2000, 16) and (2, 2000, 32);
    each fit's wall time and ms/epoch;
15. the same cell with ``--backbone dssl`` in its own artifact root (the
    probes' checkpoint names are the same): the same checks, the head at
    (3, 2000, 32), and the DSSL fit's ms/epoch and vMF sampler host syncs
    per epoch;
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
    --dep 50`` on phase 14's checkpoints gives phase 14's fused accuracy.

The serving and training phases also count the head kernel's calls by
shape. ``python3 chip_smoke.py --head-times`` only builds the head kernel
of the package first on the path and prints its times at the main-path
shapes as one JSON line: copied into an unpacked checkout of another
commit, it times that commit's kernel in the same call. ``python3
chip_smoke.py --engine-times`` only times ``--vmap-seeds`` against
``--one-program-cells`` on two full-depth HandWritten cells (about 35
minutes) and checks that their reports agree.

It prints a JSON line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import json
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
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
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
MAIN_PATH_SHAPES = (SERVING_SHAPES + VALIDATION_SHAPES + STACKED_SHAPES + SYNTHETIC_SHAPES
                    + SYNTHETIC_STACKED_SHAPES)
# (S, V, B, D, H, C) of the probe epoch: dmvae_cml on HandWritten (16 steps
# of 100 rows), then on the synthetic sweep (62 steps of 128 rows, the tail
# dropped; D=16 over DMVAE, 32 over DSSL)
EPOCH_SHAPES = [(16, 7, 100, 200, 128, 10), (62, 3, 128, 16, 128, 3), (62, 3, 128, 32, 128, 3)]


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
    path runs, at the wrapper's launch function (so a vmapped call counts
    at the S x V heads it launches); the launch count itself stays the
    wrapper's."""
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck

    real = ck._launch
    tally = collections.Counter()

    def counted(x, w1, b1, w2, b2):
        tally[shape_key(*x.shape, w1.shape[-1], w2.shape[-1])] += 1
        return real(x, w1, b1, w2, b2)

    ck._launch = counted
    try:
        yield tally
    finally:
        ck._launch = real


def head_device_ms(ck, shape, n=100):
    """Device-only time of the head kernel at one shape from the profiler,
    or None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    args = head_inputs(*shape, seed=0)
    for _ in range(10):
        ck.evidential_heads_stacked(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ck.evidential_heads_stacked(*args)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "evidential_heads_kernel" in ev.key:
            total_us = getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
            if total_us > 0 and ev.count:
                return total_us / ev.count / 1e3
    return None


def phase_device_time(ck, card):
    """The head kernel at every main-path shape: profiler device time, CUDA
    events per call (the wrapper's host work included, so events minus
    device time is the wrapper's cost when the host is the limit) and the
    bound; at the synthetic shapes also the plain and library times.
    Returns {shape key: device ms} and {synthetic shape key: times}."""
    device, synthetic = {}, {}
    for shape in MAIN_PATH_SHAPES:
        ms = head_device_ms(ck, shape)
        args = head_inputs(*shape, seed=1)
        events = event_ms(ck.evidential_heads_stacked, args)
        bound_ms, bound_by = head_bound(*shape)
        device[shape_key(*shape)] = ms
        extra = ""
        if shape in SYNTHETIC_SHAPES + SYNTHETIC_STACKED_SHAPES:
            plain_ms = event_ms(ck.evidential_heads_stacked_plain, args)
            library_ms = event_ms(library_heads, args)
            synthetic[shape_key(*shape)] = dict(device_ms=ms, ms=events, plain_ms=plain_ms,
                                                library_ms=library_ms, bound_ms=bound_ms,
                                                bound_by=bound_by)
            extra = f", plain {plain_ms:.5f} ms, library {library_ms:.5f} ms"
        log(f"device time evidential_head {shape_key(*shape)}: "
            + (f"{ms:.5f} ms" if ms is not None else "not measured")
            + f", events {events:.5f} ms per call{extra}, bound {bound_ms:.6f} ms ({bound_by}) "
              f"[{card}]")
    return device, synthetic


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


def probe_epoch_bound(s, v, b, d, h, c, keep):
    """(ms, 'operations' | 'bytes') of one epoch: the f32 products of each
    step (forward, dh, dW1, dW2) and ~12 operations per state element of
    AdamW, against the bytes of the inputs read once and the state (p, m, v)
    read once and written once."""
    state = v * (d * h + h + h * c + c)
    flops = s * (2.0 * v * b * (2 * d * h + 3 * h * c) + 12.0 * state)
    per_step = v * b * d + (v * b * h if keep < 1.0 else 0) + b * c + b
    nbytes = 4.0 * (s * per_step + 2 * 3 * state + s * 2 + 3 + s)
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
    return rows[next(iter(rows))], rows


def probe_epoch_times_at(pm, card, s, v, b, d, h, c, fused):
    from torch.profiler import ProfilerActivity, profile

    inp = epoch_inputs(s, v, b, d, h, c, seed=3, fused=fused)
    state = [tuple(t.clone() for t in g) for g in inp["state"]]
    args = (*inp["tensors"], *inp["scalars"], *state)
    ms = event_ms(lambda *a: pm.run_epoch_kernel(*a, **inp["kw"]), args, iters=50, warmup=5)
    plain_ms = event_ms(lambda *a: pm.run_epoch_plain(*a, **inp["kw"]), args, iters=5, warmup=1)
    bound_ms, bound_by = probe_epoch_bound(s, v, b, d, h, c, 0.9)
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
    label = f"V={v} B={b} D={d} H={h} C={c} S={s} fused={fused:g}"
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
    launch counts over it and the cell's wall time."""
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
    return epoch_launches, head_launches, dict(shapes), wall


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
def cut_config(changes):
    """The port's copy of config.yaml with ``changes`` ({"section.key":
    value}) while the block runs, for a path whose depth is cut."""
    import copy

    from disentagled_multimodal_fusion_tpu_torch.runners.common import CONFIGS

    cfg = CONFIGS["config.yaml"]
    saved = copy.deepcopy(cfg)
    for path, value in changes.items():
        section, key = path.split(".")
        cfg[section][key] = value
    try:
        yield
    finally:
        cfg.clear()
        cfg.update(saved)


# the seed-batched HandWritten path runs at half depth, so the synthetic
# phases fit in the script's time (PERF.md section 4)
SEED_BATCHED_CUT = {"dmvae.num_epochs": 50, "probes.model_epochs": 100}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--head-times"]:
        return head_times_only(card_line())
    if sys.argv[1:] == ["--engine-times"]:
        return engine_times_only(card_line())
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

    max_abs_err = phase_kernel_checks(ck)
    epoch_abs_err = phase_probe_epoch_checks(pm)
    timing = phase_kernel_times(ck, card)
    device_by_shape, head_synthetic_times = phase_device_time(ck, card)
    epoch_timing, epoch_times_by_shape = phase_probe_epoch_times(pm, card)
    epoch_timing = {k: epoch_timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")}
    serve_launches, serve_shapes = phase_serving(ck, card)
    phase_request_profile(card)
    phase_daemon_and_http(card)
    epoch_launches, train_head_launches, train_shapes, seq_wall = phase_training(ck, pm, card)
    phase_engines(card)
    phase_vmapped_heads(ck, card)
    with artifact_root("seed_batched_"), cut_config(SEED_BATCHED_CUT):
        with kept_checkpoints() as kept:
            sb_launches, sb_shapes, sb_rows, _ = phase_seed_batched(ck, card, seq_wall)
        phase_seed_batched_engines(card)
        phase_restore(card, kept, sb_rows)
    with artifact_root("synthetic_dmvae_"):
        syn = phase_synthetic(ck, pm, card, "dmvae")
        with artifact_root("synthetic_dssl_"):  # the probes' checkpoints share their names
            dssl = phase_synthetic(ck, pm, card, "dssl")
        with artifact_root("synthetic_vmap_"):
            syn_sb_launches, syn_sb_shapes = phase_synthetic_seed_batched(ck, card)
        phase_synthetic_restore(card, syn[0])
    syn_head_launches = syn[2] + dssl[2] + syn_sb_launches
    syn_epoch_launches = syn[1] + dssl[1]
    syn_shapes = dict(collections.Counter(syn[3]) + collections.Counter(dssl[3])
                      + collections.Counter(syn_sb_shapes))

    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "evidential_head",
        "route": "cuda",
        "source": "disentagled_multimodal_fusion_tpu_torch/csrc/evidential_head.cu",
        "replaces": "disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53",
        "launches": serve_launches + train_head_launches + sb_launches + syn_head_launches,
        "launches_by_path": {"serving": serve_launches, "training": train_head_launches,
                             "seed_batched": sb_launches, "synthetic": syn_head_launches},
        "max_abs_err": max_abs_err,
        **timing,
        "device_ms_by_shape": device_by_shape,
        "synthetic_times_by_shape": head_synthetic_times,
        "launches_by_shape": {"serving": serve_shapes, "training": train_shapes,
                              "seed_batched": sb_shapes, "synthetic": syn_shapes},
    }, {
        "name": "probe_epoch",
        "route": "cuda",
        "source": "disentagled_multimodal_fusion_tpu_torch/csrc/probe_epoch.cu",
        "replaces": "disentagled_multimodal_fusion_tpu/ops/probe_megakernel.py:246",
        "launches": epoch_launches + syn_epoch_launches,
        "launches_by_path": {"training": epoch_launches, "synthetic": syn_epoch_launches},
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
