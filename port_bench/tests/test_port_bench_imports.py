"""Nothing the benchmark runs loads JAX or the JAX package; the reference loads
nothing of the port; nothing reads the JAX package's benchmark files."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench_scratch import REPO, scratch_checkout

HERE = REPO / "port_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "disentagled_multimodal_fusion_tpu"}
PORT = "disentagled_multimodal_fusion_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.partition(".")[0]


@pytest.mark.parametrize("cell", ["handwritten.score", "luma.score", "handwritten.score_late"])
def test_a_dry_run_loads_no_jax(tmp_path, cell):
    root = scratch_checkout(tmp_path, kept=True)
    code = ("import json, sys; from port_bench import run; "
            f"r = run.run_cell({cell!r}, 3, 0.2, False, device='cpu'); "
            "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert PORT in loaded and "port_bench" in loaded
    assert not loaded & FORBIDDEN


def test_no_source_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        names = set(_imports(path))
        assert PORT not in names and names <= {"torch", "math", "contextlib", "__future__",
                                               "port_bench"}, (path, names)
    # and what it takes from the benchmark is the reference's own building blocks
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "port_bench.reference":
                assert [a.name for a in node.names] == ["plain"]


def test_nothing_reads_the_jax_benchmark_files():
    for path in HERE.rglob("*"):
        if (path.is_file() and path.suffix in (".py", ".json")
                and not {"__pycache__", "tests"} & set(path.relative_to(HERE).parts)):
            text = path.read_text()
            for name in ("bench.py", "BENCH_r", "MULTICHIP_r"):
                assert name not in text, (path, name)
