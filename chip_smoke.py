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
   p, m, v rtol 5e-3 / atol 5e-5);
4. kernel, plain and library times (CUDA events, profiler device time)
   beside the least time the card could take for the same work, the head
   kernel's device time at every main-path shape (serving buckets and
   validation); the
   profiler window of the probe epoch must hold exactly its four kernels,
   16 launches each per epoch, and nothing else but the wrapper's PyTorch
   operations;
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
   2e-5 / atol 2e-6), val_acc equal, parameters at rtol 5e-3 / atol 5e-5.

The serving and training phases also count the head kernel's calls by
shape. ``python3 chip_smoke.py --head-times`` only builds the head kernel
of the package first on the path and prints its times at the main-path
shapes as one JSON line: copied into an unpacked checkout of another
commit, it times that commit's kernel in the same call.

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
MAIN_PATH_SHAPES = SERVING_SHAPES + VALIDATION_SHAPES


def shape_key(v, b, d, h, c):
    return f"V={v},B={b},D={d},H={h},C={c}"


def phase_kernel_checks(ck):
    """Kernel against plain version; returns the largest abs error at the
    serving shapes."""
    shapes = [(1, 100, 200, 128, 10), (1, 13, 47, 33, 68), (3, 32, 16, 24, 5), (1, 600, 40, 32, 10)]
    shapes += [(v, b, d, 128, 10) for v, d in ((7, 200), (6, 200), (6, 240))
               for b in (1, 8, 64, 256, 1000)]
    # the validation shapes, a wider head (two H tiles per block of a cluster)
    shapes += VALIDATION_SHAPES + [(7, 256, 200, 256, 10), (3, 97, 59, 256, 15)]
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


def phase_kernel_times(ck, card):
    """Times at the serving shapes; returns the row of the probe at B=256."""
    from disentagled_multimodal_fusion_tpu_torch.ops.evidence import evidence_activation

    def library(x, w1, b1, w2, b2):
        h = torch.relu(torch.baddbmm(b1[:, None, :], x, w1))
        return evidence_activation(torch.baddbmm(b2[:, None, :], h, w2)).transpose(0, 1)

    main_row = None
    for v, d in ((7, 200), (6, 200), (6, 240)):
        for b in BUCKETS:
            args = head_inputs(v, b, d, 128, 10, seed=b)
            ms = event_ms(ck.evidential_heads_stacked, args)
            plain_ms = event_ms(ck.evidential_heads_stacked_plain, args)
            library_ms = event_ms(library, args)
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
    """Counts the head kernel's calls on the card by (V, B, D, H, C) while
    the main path runs, through the name the probes and late-fusion heads
    call it by; the launch count itself stays the wrapper's."""
    from disentagled_multimodal_fusion_tpu_torch.models import probes

    real = probes.evidential_heads_stacked
    tally = collections.Counter()

    def counted(x, w1, b1, w2, b2):
        if x.device.type == "cuda":
            tally[shape_key(*x.shape, w1.shape[-1], w2.shape[-1])] += 1
        return real(x, w1, b1, w2, b2)

    probes.evidential_heads_stacked = counted
    try:
        yield tally
    finally:
        probes.evidential_heads_stacked = real


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
    bound. Returns {shape key: device ms}."""
    device = {}
    for shape in MAIN_PATH_SHAPES:
        ms = head_device_ms(ck, shape)
        events = event_ms(ck.evidential_heads_stacked, head_inputs(*shape, seed=1))
        bound_ms, bound_by = head_bound(*shape)
        device[shape_key(*shape)] = ms
        log(f"device time evidential_head {shape_key(*shape)}: "
            + (f"{ms:.5f} ms" if ms is not None else "not measured")
            + f", events {events:.5f} ms per call, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
    return device


def epoch_inputs(s, v, b, d, h, c, seed, keep=0.9, tail=None, ties=False):
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
        kw=dict(keep=keep, fused=1.0, num_classes=c, weight_decay=1e-2),
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


def phase_probe_epoch_checks(pm):
    """run_epoch_kernel against run_epoch_plain on the card; returns the
    largest abs error at the HandWritten shapes."""
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
        inp64 = dict(inp, tensors=[t.double() for t in inp["tensors"]],
                     state=[tuple(t.double() for t in g) for g in inp["state"]])
        ref64 = run_epoch(pm.run_epoch_plain, inp64)
        err64 = assert_epoch_close(tuple(tuple(t.double() for t in g) for g in got[:3])
                                   + (got[3].double(),), ref64, f"probe_epoch V={v} float64")
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
        inp64 = dict(inp, tensors=[t.double() for t in inp["tensors"]],
                     state=[tuple(t.double() for t in g) for g in inp["state"]])
        err64 = assert_epoch_close(tuple(tuple(t.double() for t in g) for g in got[:3])
                                   + (got[3].double(),), run_epoch(pm.run_epoch_plain, inp64),
                                   f"{label} float64")
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
    """Kernel and plain time per epoch at V=7 (dmvae_cml's probe), the
    device time per epoch and per step kernel from the profiler, the bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inp = epoch_inputs(16, 7, 100, 200, 128, 10, seed=3)
    state = [tuple(t.clone() for t in g) for g in inp["state"]]
    args = (*inp["tensors"], *inp["scalars"], *state)
    ms = event_ms(lambda *a: pm.run_epoch_kernel(*a, **inp["kw"]), args, iters=50, warmup=5)
    plain_ms = event_ms(lambda *a: pm.run_epoch_plain(*a, **inp["kw"]), args, iters=5, warmup=1)
    bound_ms, bound_by = probe_epoch_bound(16, 7, 100, 200, 128, 10, 0.9)
    n, steps = 20, 16
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            pm.run_epoch_kernel(*args, **inp["kw"])
        torch.cuda.synchronize()
    # every device operation of the window is one of the source's four
    # kernels or one of the PyTorch operations the wrapper runs (the scalars'
    # fill and stack); anything else (a renamed or added kernel) fails
    names = ("forward_kernel", "loss_kernel", "dh_kernel", "grad_adam_kernel")
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
    kernels = {k: (us / 1e3 / count, count / n) for k, (us, count) in found.items()}
    launches = {k: per_epoch for k, (_, per_epoch) in kernels.items()}
    if set(kernels) != set(names) or any(x != steps for x in launches.values()) \
            or sum(launches.values()) != 4 * steps:
        raise AssertionError(f"probe_epoch launched {launches} per epoch, expected each of "
                             f"{names} {steps} times ({4 * steps} in all)")
    device_ms = sum(t * k for t, k in kernels.values())
    log(f"time probe_epoch V=7 B=100 D=200 H=128 C=10 S=16: kernel {ms:.5f} ms/epoch, "
        f"plain {plain_ms:.5f} ms/epoch, bound {bound_ms:.6f} ms ({bound_by}); no single "
        f"PyTorch call computes an epoch, so there is no library time [{card}]")
    log(f"profiler device time probe_epoch per epoch: {device_ms:.5f} ms [{card}]")
    for name, (t, per_epoch) in sorted(kernels.items()):
        log(f"  {name}: {t:.5f} ms per launch, {per_epoch:.0f} launches per epoch")
    log(f"  the wrapper's PyTorch operations: {wrapper_ops / n:.0f} per epoch, "
        f"{wrapper_ms:.5f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None), device_ms


def phase_training(ck, pm, card):
    """The training path: runners/run.py main on HandWritten Normal, seed 0,
    with the probe fits through the epoch kernel, in a scratch artifact root
    under chip_scratch/. Returns both kernels' launch counts over it."""
    import os
    import shutil
    import tempfile

    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    C = make_getter(load_config())
    probe_epochs = C("probes.model_epochs")
    root = Path(__file__).resolve().parent / "chip_scratch"
    root.mkdir(exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="train_", dir=root)
    old = os.environ.get("DMF_ARTIFACT_ROOT")
    os.environ["DMF_ARTIFACT_ROOT"] = scratch
    try:
        with head_shape_tally() as shapes:
            pm.run_epoch_kernel.launches = 0
            ck.evidential_heads_stacked.launches = 0
            t0 = time.perf_counter()
            rows = runner.main(["--seeds", "0", "--datasets", "HandWritten", "--conditions",
                                "Normal", "--probe-engine", "megakernel"])
            wall = time.perf_counter() - t0
            epoch_launches = pm.run_epoch_kernel.launches
            head_launches = ck.evidential_heads_stacked.launches
    finally:
        if old is None:
            os.environ.pop("DMF_ARTIFACT_ROOT")
        else:
            os.environ["DMF_ARTIFACT_ROOT"] = old
        shutil.rmtree(scratch, ignore_errors=True)
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
    return epoch_launches, head_launches, dict(shapes)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--head-times"]:
        return head_times_only(card_line())
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
    device_by_shape = phase_device_time(ck, card)
    epoch_timing, _ = phase_probe_epoch_times(pm, card)
    serve_launches, serve_shapes = phase_serving(ck, card)
    phase_request_profile(card)
    phase_daemon_and_http(card)
    epoch_launches, train_head_launches, train_shapes = phase_training(ck, pm, card)
    phase_engines(card)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "evidential_head",
        "route": "cuda",
        "source": "disentagled_multimodal_fusion_tpu_torch/csrc/evidential_head.cu",
        "replaces": "disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53",
        "launches": serve_launches + train_head_launches,
        "launches_by_path": {"serving": serve_launches, "training": train_head_launches},
        "max_abs_err": max_abs_err,
        **timing,
        "device_ms_by_shape": device_by_shape,
        "launches_by_shape": {"serving": serve_shapes, "training": train_shapes},
    }, {
        "name": "probe_epoch",
        "route": "cuda",
        "source": "disentagled_multimodal_fusion_tpu_torch/csrc/probe_epoch.cu",
        "replaces": "disentagled_multimodal_fusion_tpu/ops/probe_megakernel.py:246",
        "launches": epoch_launches,
        "launches_by_path": {"training": epoch_launches},
        "max_abs_err": epoch_abs_err,
        **epoch_timing,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
