"""The yardstick's arithmetic against counts made by hand."""

import math

import pytest

from port_bench import bounds, registry


def test_head_bound_matches_the_kernel_table():
    # PERF.md's kernel table: 0.001438 ms (operations) at (7, 256, 200, 128, 10)
    seconds, kind = bounds.head_bound_s([200] * 7, 256, 128, 10)
    assert kind == "operations"
    assert round(seconds * 1e3, 6) == 0.001438


def test_head_work_counts_unpadded_views():
    views = [240, 76, 216, 47, 64, 6]
    flops, nbytes = bounds.head_work(views, 16384, 128, 10)
    assert flops == 2 * 16384 * (649 * 128 + 6 * 128 * 10)
    assert nbytes == 4 * (16384 * 649 + 649 * 128 + 6 * 128 + 6 * 128 * 10 + 6 * 10
                          + 16384 * 6 * 10)
    assert bounds.head_bound_s(views, 16384, 128, 10)[1] == "operations"


@pytest.mark.parametrize("cell, per_row", [
    # DMVAE encoder 2 (649 * 512 + 6 * 512 * 512 + 6 * 512 * 800), 7 heads 2 (200 * 128 + 128 * 10)
    ("handwritten.score", 2 * (649 * 512 + 6 * 512 * 512 + 6 * 512 * 800)
     + 7 * 2 * (200 * 128 + 128 * 10)),
    # six heads on the raw views (a mix kept for later)
    ("handwritten.score_late", 2 * (649 * 128 + 6 * 128 * 10)),
    # audio 40-128-256-200, text 128-256-256-200; image convs at 32, 16, 8 and
    # 2048-512-200; the DMVAE encoder over three 200-wide encodings; 4 heads of 42
    ("luma.score", 2 * (40 * 128 + 128 * 256 + 256 * 200)
     + 2 * (128 * 256 + 256 * 256 + 256 * 200)
     + 2 * 9 * (3 * 32 * 32 * 32 + 32 * 64 * 16 * 16 + 64 * 128 * 8 * 8)
     + 2 * (2048 * 512 + 512 * 200)
     + 3 * 2 * (200 * 512 + 512 * 512 + 512 * 800)
     + 4 * 2 * (200 * 128 + 128 * 42)),
])
def test_flops_per_row(cell, per_row):
    # a cell's workload file, or a mix kept for later, which has no entry
    workload = registry.load_json(registry.HERE / "workloads" / f"{cell}.json")
    cfg = registry.load_json(registry.HERE / "configs" / f"{workload['config']}.json")
    models = registry.module("models", workload["config"])
    assert models.flops_per_row(cfg, workload["model"]) == per_row


def test_request_flops_match_a_reckoning_by_hand():
    # 3.64 GFLOP a HandWritten split of 400 rows, 116 a LUMA request of 4096
    for cell, gflop in (("handwritten.score", 3.641), ("luma.score", 116.1)):
        entry, workload, cfg = registry.cell(registry.benchmark(), cell)
        models = registry.module("models", entry["config"])
        total = models.flops_per_row(cfg, workload["model"]) * workload["rows_per_request"]
        assert math.isclose(total / 1e9, gflop, rel_tol=5e-3)
