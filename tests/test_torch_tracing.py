"""The port's spans and counters (``core/logging.py``) on the CPU, and their
clock against the card's device trace (``gpu``).

* Spans nest per thread: parents, request ids (``serve.to_host`` takes the
  last request's), self time; the scoring path's spans around a real
  inference function; nothing recorded, and no span made, while off.
* The clock: a ``torch.profiler.record_function`` event inside a span lies
  inside it once both are on the Unix-epoch clock, in the profiler's result
  and in the Chrome trace that ``logging.trace`` writes with the spans.
* ``export_inference`` with recording on still holds one head operator call.
* The bounded buffer counts what it dropped; the launch counters count
  through the operator's ``on_launch`` hook and the epoch kernel's wrapper.

The ``gpu`` test runs on a CUDA machine without JAX:

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_tracing.py
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu_torch.core import logging as tlog
from disentagled_multimodal_fusion_tpu_torch.core import serve as tserve
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck
from disentagled_multimodal_fusion_tpu_torch.ops import head_op

DIMS = (12, 10, 7)
SERVE_SPANS = ("serve.infer", "serve.backbone", "serve.heads", "serve.uncertainty")


def _views(rows, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.random((rows, d), dtype=np.float32) for d in DIMS)


def _infer():
    backbone = ttasks.build_dmvae_task(output_dim=DIMS, hidden_dim=32, embed_dim=8,
                                       fused_modalities=True, device="cpu")
    task = ttasks.build_probe_task(num_modalities=len(DIMS), num_classes=4, input_dim=8,
                                   hidden_dim=(16,), aggregation="cml", seed=1, device="cpu")
    return tserve.build_inference_fn(task, backbone=backbone)


def _by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_parents_requests_and_self_time():
    with tlog.recording() as rec:
        with tlog.span("outer", new_request=True) as outer:
            time.sleep(0.002)
            with tlog.span("inner") as inner:
                time.sleep(0.003)
                with tlog.span("leaf"):
                    pass
            with tlog.span("inner"):
                time.sleep(0.001)
        with tlog.span("after") as after:
            pass
        with tlog.span("next", new_request=True) as nxt:
            pass
    assert [s.name for s in rec.spans] == ["leaf", "inner", "inner", "outer", "after", "next"]
    leaf, inner1, inner2 = rec.spans[:3]
    assert outer.parent is None and inner.parent == outer.id and leaf.parent == inner1.id
    assert inner2.parent == outer.id and after.parent is None
    # children take the request of their parent; a root the last one opened
    assert leaf.request == inner1.request == inner2.request == outer.request == after.request
    assert nxt.request != outer.request
    table = tlog.span_table(rec.spans)
    assert table["outer"] == {"count": 1, "total_ns": outer.duration_ns,
                              "self_ns": outer.duration_ns - inner1.duration_ns
                              - inner2.duration_ns}
    assert table["outer"]["self_ns"] >= 2_000_000
    assert table["inner"]["count"] == 2
    assert table["inner"]["total_ns"] == inner1.duration_ns + inner2.duration_ns
    assert table["inner"]["self_ns"] == (inner1.duration_ns - leaf.duration_ns
                                         + inner2.duration_ns)
    assert all(s.start_ns <= s.end_ns for s in rec.spans)


def test_each_thread_keeps_its_own_stack_and_requests():
    seen = {}

    def worker(name):
        with tlog.span(name, new_request=True) as root:
            time.sleep(0.002)
            with tlog.span(f"{name}.child") as child:
                time.sleep(0.002)
        seen[name] = (root, child)

    with tlog.recording() as rec:
        threads = [threading.Thread(target=worker, args=(f"t{i}",)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.spans) == 8
    for root, child in seen.values():
        assert root.parent is None and child.parent == root.id
        assert child.request == root.request and child.tid == root.tid
    assert len({root.request for root, _ in seen.values()}) == 4


def test_scoring_path_spans_and_to_host_takes_the_last_request():
    infer = _infer()
    xs = _views(8)
    tserve.to_host(infer(xs))  # the first call's one-time costs stay out
    with tlog.recording() as rec:
        for _ in range(2):
            out = infer(xs)
            host = tserve.to_host(out)
    spans = _by_name(rec)
    assert {name: len(v) for name, v in spans.items()} == {
        **{name: 2 for name in SERVE_SPANS}, "serve.to_host": 2}
    for k in range(2):
        root = spans["serve.infer"][k]
        assert root.parent is None
        for name in SERVE_SPANS[1:]:
            child = spans[name][k]
            assert child.parent == root.id and child.request == root.request
            assert root.start_ns <= child.start_ns <= child.end_ns <= root.end_ns
        to_host = spans["serve.to_host"][k]
        assert to_host.parent is None and to_host.request == root.request
        assert to_host.start_ns >= root.end_ns
        assert to_host.attrs == {"copies": 6, "bytes": sum(a.nbytes for a in host.values())}
    assert spans["serve.infer"][0].request != spans["serve.infer"][1].request


def test_a_disabled_recorder_records_nothing_and_makes_no_span(monkeypatch):
    infer = _infer()
    xs = _views(4)
    tserve.to_host(infer(xs))
    assert not tlog.RECORDER.on

    def refuse(*args):
        raise AssertionError("a span was made or the clock read while nothing records")

    # the scoring path, off: no span object, no clock read
    monkeypatch.setattr(tlog, "Span", refuse)
    monkeypatch.setattr(tlog, "time", type("Clockless", (), {"perf_counter_ns": refuse,
                                                             "time_ns": refuse}))
    tserve.to_host(infer(xs))
    with tlog.span("serve.infer", new_request=True) as s:
        assert s is None
    assert tlog.span("x", a=1) is tlog.span("y")
    monkeypatch.undo()
    with tlog.recording() as rec:
        pass
    assert rec.spans == [] and rec.dropped == 0


def test_the_bounded_buffer_counts_dropped_spans():
    with tlog.recording(capacity=3) as rec:
        for i in range(5):
            with tlog.span(f"s{i}"):
                pass
    assert [s.name for s in rec.spans] == ["s0", "s1", "s2"] and rec.dropped == 2


def test_nested_recordings_each_keep_what_closed_inside_them():
    with tlog.recording() as outer:
        with tlog.span("a"):
            pass
        with tlog.recording() as inner:
            with tlog.span("b"):
                pass
        assert tlog.RECORDER.on
    assert not tlog.RECORDER.on
    assert [s.name for s in outer.spans] == ["a", "b"] and [s.name for s in inner.spans] == ["b"]


def test_launch_counters_count_through_on_launch_and_not_the_plain_path():
    assert head_op.on_launch is not None
    with tlog.recording() as rec:
        start = tlog.counters()
        head_op.on_launch(False)
        head_op.on_launch(False)
        head_op.on_launch(True)
        # the operator's CPU path runs the plain version: no launch
        args = [torch.randn(s) for s in ((2, 3, 4), (2, 4, 5), (2, 5), (2, 5, 3), (2, 3))]
        with torch.no_grad():
            ck.evidential_heads_stacked(*args)
            ck.evidential_heads_stacked_bf16(*args)
        grown = tlog.counters(start)
    assert grown["kernels.evidential_heads"] == 2
    assert grown["kernels.evidential_heads_bf16"] == 1
    assert grown["kernels.probe_epoch"] == 0
    assert rec.counters["kernels.evidential_heads"] == 2
    assert rec.counters["kernels.evidential_heads_bf16"] == 1
    tlog.count("tests.plain", 3)
    assert tlog.counters()["tests.plain"] >= 3


def _profiled_span():
    """A ``record_function`` range inside a span, under a CPU-activity
    profiler: (the recording, the span, the profiler)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with tlog.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        with tlog.span("outer", new_request=True) as outer:
            time.sleep(0.001)
            with record_function("inside"):
                torch.randn(64, 64) @ torch.randn(64, 64)
            time.sleep(0.001)
    return rec, outer, prof


def test_a_profiler_event_inside_a_span_lies_inside_it_on_the_shared_clock():
    rec, outer, prof = _profiled_span()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    inside = [e for e in prof.events() if e.name == "inside"]
    assert len(inside) == 1
    e0 = start_ns + 1000 * inside[0].time_range.start
    e1 = start_ns + 1000 * inside[0].time_range.end
    assert rec.unix_ns(outer.start_ns) < e0 <= e1 < rec.unix_ns(outer.end_ns)


def test_operator_trace_writes_the_spans_on_their_own_row(tmp_path):
    from torch.profiler import record_function

    with tlog.trace("spans", log_dir=str(tmp_path)) as path:
        with tlog.span("outer", new_request=True, note="x"):
            time.sleep(0.001)
            with record_function("inside"):
                torch.randn(64, 64) @ torch.randn(64, 64)
            time.sleep(0.001)
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("pid") == tlog.SPAN_ROW and e["ph"] == "X"]
    assert [(s["name"], s["args"]["note"]) for s in spans] == [("outer", "x")]
    assert any(e.get("ph") == "M" and e.get("pid") == tlog.SPAN_ROW for e in events)
    inside = [e for e in events if e.get("name") == "inside" and e.get("ph") == "X"]
    assert len(inside) == 1
    outer = spans[0]
    assert outer["ts"] < inside[0]["ts"]
    assert inside[0]["ts"] + inside[0]["dur"] < outer["ts"] + outer["dur"]


@pytest.mark.parametrize("layout", [
    '{\n  "traceEvents": [\n  {"ph": "X", "name": "k", "ts": 1, "dur": 1}\n  ],'
    '"traceName": "t.json" }',
    '{"baseTimeNanoseconds": 1000, "traceEvents": [ ]}',
    '{"traceEvents": [{"ph": "X", "name": "k", "ts": 1, "dur": 1}], "other": 2}',
])
def test_spans_are_added_to_a_chrome_trace_of_any_layout(tmp_path, layout):
    path = tmp_path / "trace.json"
    path.write_text(layout)
    with tlog.recording() as rec:
        with tlog.span("s"):
            pass
    tlog.add_spans_to_chrome_trace(path, rec)
    data = json.loads(path.read_text())
    names = [e["name"] for e in data["traceEvents"]]
    assert names.count("s") == 1 and names[-2:] == ["process_name", "s"]
    assert names[:-2] == [e["name"] for e in json.loads(layout)["traceEvents"]]
    base = json.loads(layout).get("baseTimeNanoseconds", 0)
    span = data["traceEvents"][-1]
    assert span["ts"] == pytest.approx((rec.unix_ns(rec.spans[0].start_ns) - base) / 1e3)


def test_export_with_recording_on_holds_one_head_operator_call(tmp_path):
    infer = _infer()
    with tlog.recording() as rec:
        exported = tserve.export_inference(infer, _views(8), tmp_path / "b8.pt2")
    assert tserve.head_op_calls(exported) == 1
    assert {"serve.backbone", "serve.heads", "serve.uncertainty"} <= set(_by_name(rec))


@pytest.mark.gpu
def test_a_span_encloses_a_kernel_on_the_device_clock():
    """A span opened before a kernel's launch and closed after
    ``torch.cuda.synchronize()`` encloses the kernel's device interval on
    the shared clock, and ends less than 100 us after the kernel does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(4096, 4096, device="cuda")
    (a @ a).sum().item()  # cuBLAS's handle and the kernel's first call stay out
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, tlog.recording() as rec:
        torch.cuda.synchronize()
        with tlog.span("matmul") as s:
            a @ a
            torch.cuda.synchronize()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) >= 1, "the profiler saw no device operation"
    k0 = start_ns + 1000 * min(e.time_range.start for e in kernels)
    k1 = start_ns + 1000 * max(e.time_range.end for e in kernels)
    s0, s1 = rec.unix_ns(s.start_ns), rec.unix_ns(s.end_ns)
    print(f"span {s0} .. {s1}; kernel {k0} .. {k1}: launch {(k0 - s0) / 1e3:.1f} us after the "
          f"span opened, the span closed {(s1 - k1) / 1e3:.1f} us after the kernel ended "
          f"(torch {torch.__version__}, {torch.cuda.get_device_name(0)})")
    assert s0 < k0 <= k1 < s1
    assert s1 - k1 < 100_000
