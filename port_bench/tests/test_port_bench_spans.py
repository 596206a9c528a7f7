"""The reductions of ``spans.py`` against sums made by hand, and a measurement
on the CPU with its device operations stood in for."""

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from port_bench import spans, trace
from port_bench_scratch import scratch_checkout


def _span(id, name, start, end, parent=None, request=1):
    return SimpleNamespace(id=id, name=name, start_ns=start, end_ns=end, parent=parent,
                           request=request)


# one request, on one thread, in ns:
#   serve.infer 100-600 holds backbone 120-250, heads 250-400, uncertainty
#   400-560; serve.to_host 620-900; the harness alone 0-100, 600-620, 900-1000
REQUEST = [
    _span(2, "serve.backbone", 120, 250, parent=1),
    _span(3, "serve.heads", 250, 400, parent=1),
    _span(4, "serve.uncertainty", 400, 560, parent=1),
    _span(1, "serve.infer", 100, 600),
    _span(5, "serve.to_host", 620, 900),
]
# the card runs 0-50, 200-300 (under backbone and heads), 450-700
OPS = [(0, 50, "a"), (200, 300, "gemm"), (450, 700, "b"), (460, 480, "c")]


def test_idle_intervals_are_the_window_less_the_union_of_operations():
    assert spans.idle_intervals(OPS, 0, 1000) == [(50, 200), (300, 450), (700, 1000)]
    assert spans.idle_intervals(OPS, 25, 460) == [(50, 200), (300, 450)]
    assert spans.idle_intervals([], 10, 20) == [(10, 20)]


def test_self_intervals_leave_out_the_children():
    got = [(s, e, n) for s, e, n in spans.self_intervals(REQUEST) if n == "serve.infer"]
    assert got == [(100, 120, "serve.infer"), (560, 600, "serve.infer")]
    assert spans.self_intervals(REQUEST[:1], offset_ns=7) == [(127, 257, "serve.backbone")]


def test_idle_time_goes_to_the_innermost_open_span_and_sums_to_the_idle_time():
    idle = spans.idle_by_span(REQUEST, OPS, 0, 1000)
    # the gap 50-200 lies under the harness (50-100), serve.infer (100-120)
    # and serve.backbone (120-200); the gap 300-450 under heads (300-400)
    # and uncertainty (400-450); the gap 700-1000 under to_host (700-900)
    # and the harness (900-1000)
    assert idle == {"serve.backbone": 80, "serve.heads": 100, "serve.uncertainty": 50,
                    "serve.infer": 20, "serve.to_host": 200, spans.HARNESS: 150}
    assert sum(idle.values()) == 150 + 150 + 300
    assert spans.idle_in_port_ns(REQUEST, OPS, 0, 1000) == 450


def test_a_clock_offset_moves_the_spans_onto_the_device_clock():
    shifted = [(s + 10_000, e + 10_000, n) for s, e, n in OPS]
    assert (spans.idle_by_span(REQUEST, shifted, 10_000, 11_000, offset_ns=10_000)
            == spans.idle_by_span(REQUEST, OPS, 0, 1000))


def test_readings_are_the_tables_means_a_request():
    setup = [_span(10, "kernels.build", 10, 40_000_010, parent=11, request=7),
             _span(11, "serve.infer", 0, 60_000_000, request=7),
             _span(12, "serve.to_host", 60_000_100, 61_000_100, request=7),
             _span(13, "serve.infer", 70_000_000, 71_000_000, request=8)]
    r = spans.readings(REQUEST, 2, OPS, 0, 1000, 0, setup)
    assert r["backbone_host_ms"] == pytest.approx(130 / 1e6 / 2)
    assert r["heads_host_ms"] == pytest.approx(150 / 1e6 / 2)
    assert r["uncertainty_host_ms"] == pytest.approx(160 / 1e6 / 2)
    assert r["to_host_ms"] == pytest.approx(280 / 1e6 / 2)
    assert r["idle_in_port_pct"] == pytest.approx(45.0)
    assert r["first_request_s"] == pytest.approx(0.061)
    assert spans.first_request(setup)[1] == {"kernels.build": pytest.approx(0.04),
                                             "serve.infer": pytest.approx(0.02),
                                             "serve.to_host": pytest.approx(0.001)}
    table = spans.span_table(REQUEST)
    assert table["serve.infer"] == {"count": 1, "total_ns": 500, "self_ns": 60}


class _FakeProfile:
    """The profiler's CUDA activity needs a card: its start is kept, and the
    operations are stood in for relative to it."""

    def __init__(self, activities=None):
        self.t0 = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def start(self):
        self.t0 = time.time_ns()

    def stop(self):
        pass


def test_a_measurement_on_the_cpu_has_its_line(tmp_path, monkeypatch):
    root = scratch_checkout(tmp_path)
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(trace, "device_ops", lambda prof: [(1000.0, 2000.0, "k")])
    monkeypatch.setattr(spans, "device_ops_ns",
                        lambda prof: [(prof.t0 + 1_000_000, prof.t0 + 2_000_000, "k")])
    result = spans.measure("handwritten.score", 2**31 + 77, 0.4, pairs=2, device="cpu",
                           here=root / "port_bench", root=root)
    json.dumps(result)
    assert len(result["host_issue_ms"]["off"]) == len(result["host_issue_ms"]["on"]) == 2
    r = result["readings"]
    assert set(r) == {"backbone_host_ms", "heads_host_ms", "uncertainty_host_ms", "to_host_ms",
                      "idle_in_port_pct", "first_request_s"}
    assert all(math.isfinite(v) and v > 0 for v in r.values())
    traced = result["spans"]["traced"]
    assert traced["serve.infer"]["count"] == result["spans"]["traced_requests"]
    assert traced["serve.to_host"]["count"] == result["spans"]["traced_requests"]
    assert 0.5 < result["coverage"] <= 1.0
    idle = result["idle_s"]
    assert idle["attributed"] == pytest.approx(idle["bounds"] - 1e-3)
    assert idle["attributed"] == pytest.approx(idle["device"], rel=0.01)
    assert result["dropped"] == {"setup": 0, "untraced": 0, "traced": 0}
