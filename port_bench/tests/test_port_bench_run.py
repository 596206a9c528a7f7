"""A run on the CPU at a small traffic: its result line, the check that decides
``correct`` against faults planted under the timed path, the refusal
without a card, and the control on the card."""

import json

import pytest
import torch

from disentagled_multimodal_fusion_tpu_torch.core import serve
from port_bench import compare, registry, run, trace
from port_bench_scratch import scratch_checkout

# the cells, and the mix kept for later
CELLS = ("handwritten.score", "luma.score", "handwritten.score_late")


@pytest.fixture
def checkout(tmp_path):
    return scratch_checkout(tmp_path, kept=True)


def _run(checkout, cell, seed=5, traced=False):
    return run.run_cell(cell, seed, 0.3, traced, device="cpu", here=checkout / "port_bench",
                        root=checkout)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_agrees_with_the_reference_and_its_line_has_the_keys(checkout, cell):
    result = _run(checkout, cell, seed=2**31 + 12345)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    bench = registry.benchmark(checkout)
    assert set(result["metrics"]) == {m["name"] for m in registry.reported(bench, cell,
                                                                           "end_to_end")}
    assert sorted(m.partition(".")[0] for m in result["metrics"]) == [
        "score_p95_ms", "score_rows_per_s", "setup_s"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == set(compare.NAMES)
    json.dumps(result, allow_nan=False)


class _FakeProfile:
    def __init__(self, activities=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    start = stop = lambda self: None


def test_traced_line_has_the_per_layer_metrics_and_breakdown(checkout, monkeypatch):
    # the profiler's CUDA activity needs a card: its operations are stood in for
    ops = [(0.0, 100.0, "void (anonymous namespace)::evidential_heads_kernel<2>(int)"),
           (150.0, 400.0, "sm80_xmma_gemm_f32f32"),
           (900.0, 950.0, "Memcpy DtoH (Device -> Pageable)")]
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(trace, "device_ops", lambda prof: ops)
    result = _run(checkout, "handwritten.score", traced=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    bench = registry.benchmark(checkout)
    assert set(result["metrics"]) == {m["name"] for m in registry.reported(
        bench, "handwritten.score", "per_layer")}
    assert len(result["metrics"]) == 5
    assert result["device"]["busy_s"] == pytest.approx(400e-6)
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["device_ops"]) == 3


def test_trace_summary_unions_intervals_and_names_gaps():
    s = trace.summarize([(0, 10, "a<1>(x)"), (5, 20, "b"), (30, 40, "Memcpy DtoH (x)"),
                         (45, 50, "a<1>(x)")], requests=2, window_s=1e-4)
    assert s.busy_s == pytest.approx(35e-6)
    assert s.kernel_s("a<1>") == pytest.approx(15e-6)
    assert s.gaps_s == {"b -> Memcpy DtoH (x)": pytest.approx(10e-6),
                        "Memcpy DtoH (x) -> a": pytest.approx(5e-6)}
    gaps = dict((k, v) for k, v in trace.breakdown(s)["idle_gaps"])
    assert gaps["before the first and after the last device operation"] == pytest.approx(50e-6)


def _altered_answer(forward):
    def broken(self, xs):
        out = forward(self, xs)
        out["pred"] = out["pred"].clone()
        out["pred"][0] = (out["pred"][0] + 1) % out["probs"].shape[-1]
        return out
    return broken


def _half_batch(forward):
    def broken(self, xs):
        half = xs[0].shape[0] // 2
        out = forward(self, tuple(x[:half] for x in xs))
        return {k: torch.cat([v, v[:xs[0].shape[0] - half]]) for k, v in out.items()}
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered_answer, _half_batch])
def test_a_fault_under_the_timed_path_is_not_correct(checkout, monkeypatch, cell, fault):
    monkeypatch.setattr(serve.InferenceModule, "forward",
                        fault(serve.InferenceModule.forward))
    result = _run(checkout, cell)
    assert result["correct"] is False
    assert any(c["value"] == "inf" or c["value"] > c["limit"] for c in result["checks"].values())


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "handwritten.score", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "disentagled_multimodal_fusion_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert run.forbidden_modules() == ["flax"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_tf32_is_not_correct_on_the_card(tmp_path, cell):
    """The control (the reference in TF32, in the port's place) fails the
    cell's limits at its own request size (corpus cut to two requests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = scratch_checkout(tmp_path, small=False, kept=True)
    path = root / "port_bench" / "workloads" / f"{cell}.json"
    workload = json.loads(path.read_text())
    workload.update(corpus_rows=2 * workload["rows_per_request"], compare_requests=2)
    path.write_text(json.dumps(workload))
    for seed in (11, 12, 13):
        result = run.run_cell(cell, seed, 0.5, False, system="control",
                              here=root / "port_bench", root=root)
        assert result["correct"] is False, result["checks"]
