"""The harness finds cells, configurations and metrics by name, and a new one
needs new files and entries only."""

import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

from port_bench import registry
from port_bench_scratch import REPO, scratch_checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_loads_by_name():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        entry, workload, cfg = registry.cell(bench, w["name"])
        assert callable(registry.module("loops", workload["loop"]).set_up)
        models = registry.module("models", entry["config"])
        reference = registry.module("reference", entry["config"])
        assert callable(models.build) and callable(reference.forward)
        assert set(workload["limits"]) == {"evidence_log_gap", "fused_log_gap", "probs_gap",
                                           "uncertainty_gap"}
        per_layer = registry.reported(bench, w["name"], "per_layer")
        e2e = registry.reported(bench, w["name"], "end_to_end")
        assert sorted(m["name"].partition(".")[0] for m in e2e) == [
            "score_p95_ms", "score_rows_per_s", "setup_s"]
        assert len(per_layer) == 5
        for m in per_layer:
            assert m["moves"] in {e["name"] for e in e2e}
        for m in e2e + per_layer:
            assert callable(registry.reader(m["name"]).read)
        assert cfg["reduced"] == [c for c in bench["configs"]
                                  if c["name"] == entry["config"]][0]["reduced"]


def test_a_metric_is_read_by_its_quantity(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x_ms.py").write_text("def read(r):\n    return 1.0\n")
    for name in ("x_ms", "x_ms.a", "x_ms.b.c"):
        assert registry.reader(name, tmp_path).read(None) == 1.0


def test_benchmark_file_keeps_the_contract():
    bench = registry.benchmark()
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and (REPO / c["file"]).is_file()
        assert c["file"].startswith("port_bench/") and len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    assert os.path.getsize(REPO / "BENCHMARK.json") < 64 * 1024


TINY_CONFIG = {
    "source": "https://github.com/Hassan-Sarwat/disentagled_multimodal_fusion",
    "dtype": "float32", "views": [12, 5, 7], "num_classes": 3,
    "dmvae": {"hidden_dim": 16, "embed_dim": 8, "poe_temperature": 1.5},
    "probes": {"hidden_dim": 8},
    "corpus": {"kind": "features", "views": [{"width": 12, "law": "normal"},
                                            {"width": 5, "law": "normal"},
                                            {"width": 7, "law": "normal"}]},
    "reduced": [], "assumed": [],
}
TINY_MODELS = '''
from port_bench import port
from port_bench.bounds import dense_flops

params, build = port.params, port.build


def head_views(cfg, model):
    return [cfg["dmvae"]["embed_dim"]] * (len(cfg["views"]) + 1)


def flops_per_row(cfg, model):
    return sum(dense_flops([d, 16, 16, 32]) for d in cfg["views"]) + 4 * dense_flops([8, 8, 3])
'''
TINY_REFERENCE = '''
from port_bench.reference import plain


def forward(cfg, model, w, xs, tf32=False):
    with plain.precision(tf32):
        z_c, z_p = plain.dmvae_embedding(w, "backbone.encoder.", xs, 8, 1.5)
        return plain.outputs(plain.heads(w, "heads.stack.", [z_c, *z_p]), 3)
'''
TINY_METRIC = '''
def read(r):
    return float(r.requests) if r.requests else None
'''


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_configuration_and_metric_added_as_files_run(tmp_path):
    root = scratch_checkout(tmp_path)
    here = root / "port_bench"
    before = _digest(here)
    (here / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (here / "models" / "tiny.py").write_text(TINY_MODELS)
    (here / "reference" / "tiny.py").write_text(TINY_REFERENCE)
    (here / "metrics" / "requests_seen.py").write_text(TINY_METRIC)
    (here / "workloads" / "tiny.score.json").write_text(json.dumps({
        "config": "tiny", "traffic": "score", "model": "dmvae_cml", "corpus_rows": 128,
        "rows_per_request": 32, "loop": "closed", "compare_requests": 2,
        "limits": {"evidence_log_gap": 1e-5, "fused_log_gap": 1e-5, "probs_gap": 1e-6,
                   "uncertainty_gap": 1e-5}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": TINY_CONFIG["source"],
                             "file": "port_bench/configs/tiny.json", "reduced": [],
                             "why": "a scratch configuration"})
    bench["workloads"].append({"name": "tiny.score", "config": "tiny", "traffic": "score",
                               "chips": 1, "why": "a scratch cell"})
    for m in bench["end_to_end"]:
        if m["name"] in ("score_rows_per_s", "score_p95_ms"):
            m["workloads"].append("tiny.score")
    bench["per_layer"].append({"name": "requests_seen.tiny", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "scoring loop", "moves": "score_rows_per_s",
                               "workloads": ["tiny.score"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    added = set(_digest(here)) - set(before)
    assert {k: v for k, v in _digest(here).items() if k in before} == before
    assert len(added) == 5

    # the new cell runs from the scratch checkout, its harness unedited
    code = ("import json; from port_bench import run; "
            "print(json.dumps(run.run_cell('tiny.score', 7, 0.3, False, device='cpu')))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "score_rows_per_s", "score_p95_ms"}

    # and its per-layer metric is found and read by name
    per_layer = registry.reported(bench, "tiny.score", "per_layer")
    assert [m["name"] for m in per_layer] == ["requests_seen.tiny"]
    reader = registry.reader("requests_seen.tiny", here)
    assert reader.read(SimpleNamespace(requests=3)) == 3.0


TINY_LOOP = '''
"""A scratch loop: products of a random matrix with itself on the device,
checked against float64."""

import time

import torch


class Products:
    def __init__(self, cell):
        self.cell, self.n = cell, cell.workload["size"]
        generator = torch.Generator(device=cell.device)
        generator.manual_seed(cell.seed)
        self.a = torch.rand(self.n, self.n, generator=generator, device=cell.device)
        self.last, self.constants = None, {}

    def warm(self):
        self.last = self.a @ self.a

    def window(self, seconds):
        t0, done = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds or done == 0:
            self.last = self.a @ self.a
            done += 1
        return dict(attempted=done, failed=0, requests=done, products=done,
                    window_s=time.perf_counter() - t0)

    def check(self):
        ref = self.a.double() @ self.a.double()
        return {"product_gap": float((self.last.double() - ref).abs().max() / ref.abs().max())}


def set_up(cell):
    return Products(cell)
'''
TINY_E2E = '''
def read(r):
    return r.products / r.window_s
'''


def test_a_loop_and_its_end_to_end_metric_added_as_files_run(tmp_path):
    root = scratch_checkout(tmp_path)
    here = root / "port_bench"
    before = _digest(here)
    (here / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (here / "loops" / "products.py").write_text(TINY_LOOP)
    (here / "metrics" / "products_per_s.py").write_text(TINY_E2E)
    (here / "workloads" / "tiny.products.json").write_text(json.dumps({
        "config": "tiny", "traffic": "products", "loop": "products", "size": 48,
        "limits": {"product_gap": 1e-5}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": TINY_CONFIG["source"],
                             "file": "port_bench/configs/tiny.json", "reduced": [],
                             "why": "a scratch configuration"})
    bench["workloads"].append({"name": "tiny.products", "config": "tiny", "traffic": "products",
                               "chips": 1, "why": "a scratch cell with a loop of its own"})
    bench["end_to_end"].append({"name": "products_per_s.tiny", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny.products"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {k: v for k, v in _digest(here).items() if k in before} == before

    code = ("import json; from port_bench import run; "
            "print(json.dumps(run.run_cell('tiny.products', 7, 0.2, False, device='cpu')))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "products_per_s.tiny"}
    assert result["metrics"]["products_per_s.tiny"]["value"] > 0
    assert list(result["checks"]) == ["product_gap"]
