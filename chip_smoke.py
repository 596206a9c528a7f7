"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100 (or any CUDA card).

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) rather than being skipped:

1. the card: name, count and ``nvidia-smi`` name and power limit;
2. the kernel build from ``csrc/`` with nvcc, its time and ptxas report;
3. every kernel against its plain PyTorch version on the card, at the test
   shapes and at the serving shapes (fails above rtol 1e-4 / atol 1e-5);
4. kernel, plain and library times at the serving shapes (CUDA events) beside
   the least time the card could take for the same work;
5. the serving path, ``runners/serve.py`` main with ``--random-init`` on
   HandWritten at full width for dmvae_cml, dmvae_dis and cml_fusion at
   buckets 1, 8, 64, 256, with the kernels' launch counts read around it;
   then the same models on the card against the plain path on the CPU, and
   one dmvae_cml request under the profiler (device busy share, kernels);
6. the micro-batching daemon under concurrent clients, every answer held
   against a direct engine call;
7. the HTTP front on 127.0.0.1, each answer held against a direct call.

It prints a JSON line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

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


def phase_kernel_checks(ck):
    """Kernel against plain version; returns the largest abs error at the
    serving shapes."""
    shapes = [(1, 100, 200, 128, 10), (1, 13, 47, 33, 68), (3, 32, 16, 24, 5), (1, 600, 40, 32, 10)]
    shapes += [(v, b, d, 128, 10) for v, d in ((7, 200), (6, 200), (6, 240))
               for b in (1, 8, 64, 256, 1000)]
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


def phase_device_time(ck):
    """Device-only time of the kernel at the probe's B=256 shape from the
    profiler, or None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    args = head_inputs(7, 256, 200, 128, 10, seed=0)
    for _ in range(10):
        ck.evidential_heads_stacked(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            ck.evidential_heads_stacked(*args)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "evidential_heads_kernel" in ev.key:
            total_us = getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
            if total_us > 0 and ev.count:
                return total_us / ev.count / 1e3
    return None


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
    ck.evidential_heads_stacked.launches = 0
    reports = [runner.main(serve_args(name, "cuda") + ["--reps", str(reps)])
               for name in SERVED_MODELS]
    launches = ck.evidential_heads_stacked.launches
    expected = len(SERVED_MODELS) * len(BUCKETS) * (reps + 1)
    if launches != expected:
        raise AssertionError(f"evidential_head launched {launches} times, expected {expected}")
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
    return launches


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_build
    from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck

    configure()
    t_start = time.perf_counter()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    log(f"device: {kind}, count {count}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    info = cuda_build.build([ck.KERNEL_SOURCE])[ck.KERNEL_SOURCE]
    log(f"build {ck.KERNEL_SOURCE}: {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    max_abs_err = phase_kernel_checks(ck)
    timing = phase_kernel_times(ck, card)
    device_ms = phase_device_time(ck)
    log("profiler device time evidential_head V=7 B=256 D=200: "
        + (f"{device_ms:.5f} ms [{card}]" if device_ms is not None else "not measured"))
    launches = phase_serving(ck, card)
    phase_request_profile(card)
    phase_daemon_and_http(card)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "evidential_head",
        "route": "cuda",
        "source": "disentagled_multimodal_fusion_tpu_torch/csrc/evidential_head.cu",
        "replaces": "disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **timing,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
