"""The DeepSeek-V2-Lite cell: its configuration against the published one, the
arithmetic of its expert bound and of ``mfu_bf16`` against counts made by hand,
and its loop at a toy size on the CPU through the harness."""

import json
import math
from types import SimpleNamespace

import pytest
import torch

from port_bench import registry, run, trace
from port_bench_scratch import scratch_checkout

CELL = "luma_dsv2lite.score"
# the catalog's row for DeepSeek-V2-Lite: its config.json, as published
PUBLISHED = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy",
    "v_head_dim": 128, "vocab_size": 102400,
}


def _cfg():
    return registry.load_json(registry.HERE / "configs" / "luma_dsv2lite.json")


def _models():
    return registry.module("models", "luma_dsv2lite")


def test_configuration_holds_the_published_config_uncut():
    cfg = _cfg()
    assert {k: cfg[k] for k in PUBLISHED} == PUBLISHED
    assert cfg["reduced"] == [] and cfg["torch_dtype"] == "bfloat16"
    bench = registry.benchmark()
    entry = [c for c in bench["configs"] if c["name"] == "luma_dsv2lite"][0]
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    # LUMA's other views and models as the luma configuration has them
    luma = registry.load_json(registry.HERE / "configs" / "luma.json")
    for key in ("views", "num_classes", "dmvae", "probes"):
        assert cfg[key] == luma[key], key
    assert cfg["encoders"][0] == luma["encoders"][0] and cfg["encoders"][2] == luma["encoders"][2]
    assert cfg["encoders"][1]["widths"] == [2048, 256, 256, 200]
    # the tower's parameters (the LM head is not an encoder's)
    assert sum(math.prod(s) for _, s in _models().tower_shapes(cfg)) == 15_496_769_024


def test_flops_per_row_matches_a_count_by_hand():
    cfg = _cfg()
    # a token: the projections 2 (2048 x 3072 + 2048 x 576 + 512 x 4096 + 2048 x 2048),
    # attention over 128 positions 2 x 16 x 128 x (192 + 128), the dense layer
    # 2 x 3 x 2048 x 10944 once, each of 26 MoE layers its gate 2 x 2048 x 64
    # and 6 routed + 2 shared experts' 2 x 3 x 2048 x 1408
    proj = 2 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
    attn = 2 * 16 * 128 * (192 + 128)
    token = 27 * (proj + attn) + 2 * 3 * 2048 * 10944 + 26 * (
        2 * 2048 * 64 + 8 * 2 * 3 * 2048 * 1408)
    assert token == 4_518_576_128
    rest = (2 * (40 * 128 + 128 * 256 + 256 * 200) + 2 * (2048 * 256 + 256 * 256 + 256 * 200)
            + 2 * 9 * (3 * 32 * 32 * 32 + 32 * 64 * 16 * 16 + 64 * 128 * 8 * 8)
            + 2 * (2048 * 512 + 512 * 200) + 3 * 2 * (200 * 512 + 512 * 512 + 512 * 800)
            + 4 * 2 * (200 * 128 + 128 * 42))
    per_row = _models().flops_per_row(cfg, "dmvae_cml")
    assert per_row == 128 * token + rest
    assert math.isclose(per_row / 1e9, 578.4, rel_tol=1e-3)
    # 74.0 TFLOP a request of 128 rows
    assert math.isclose(per_row * 128 / 1e12, 74.03, rel_tol=1e-3)


def test_expert_bound_matches_a_count_by_hand():
    cfg = _models()
    c = _cfg()
    t, m = 128 * 128, 128 * 128 * 6
    flops, nbytes = cfg.expert_work(c, 128)
    assert flops == 26 * 2.0 * m * 3 * 2048 * 1408
    assert nbytes == 26 * (2.0 * 3 * 64 * 2048 * 1408 + 2.0 * t * 2048 + 2.0 * m * 1408
                           + 4.0 * m + 4.0 * m * 2048)
    seconds, kind = cfg.expert_bound_s(c, 128)
    assert kind == "operations" and seconds == flops / 989e12
    assert round(seconds * 1e3, 2) == 44.71


def test_mfu_bf16_and_the_expert_readers():
    mfu = registry.reader("mfu_bf16.luma_dsv2lite")
    r = SimpleNamespace(rows=256, window_s=2.0, flops_per_row=578e9)
    assert mfu.read(r) == pytest.approx(100 * 578e9 * 256 / 2.0 / 989e12)
    assert mfu.read(SimpleNamespace(rows=0, window_s=1.0, flops_per_row=1.0)) is None
    summary = trace.summarize([(0, 30_000, "moe_experts_kernel"), (30_000, 40_000, "gemm"),
                               (40_000, 70_000, "moe_experts_kernel")], requests=2,
                              window_s=0.1)
    r = SimpleNamespace(trace=summary, expert_bound_s=0.015)
    assert registry.reader("moe_experts_device_ms.x").read(r) == pytest.approx(30.0)
    assert registry.reader("moe_experts_roofline_pct.x").read(r) == pytest.approx(50.0)
    # a program without the kernel: nothing read, nothing raised
    bare = SimpleNamespace(trace=trace.summarize([(0, 10, "gemm")], 1, 0.1), expert_bound_s=0.01)
    assert registry.reader("moe_experts_device_ms.x").read(bare) is None
    assert registry.reader("moe_experts_roofline_pct.x").read(bare) is None


# a toy tower in float32: every mechanism at a size the CPU serves in a moment
TOY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32, n_routed_experts=8,
           num_experts_per_tok=3, n_shared_experts=1, moe_intermediate_size=32,
           intermediate_size=96, num_hidden_layers=3, vocab_size=257, torch_dtype="float32")


@pytest.fixture
def toy(tmp_path):
    root = scratch_checkout(tmp_path)
    path = root / "port_bench" / "configs" / "luma_dsv2lite.json"
    cfg = json.loads(path.read_text())
    cfg.update(TOY, views=[40, 16, 3072])
    cfg["rope_scaling"] = dict(cfg["rope_scaling"], original_max_position_embeddings=32)
    cfg["encoders"][1]["widths"] = [64, 256, 256, 200]
    cfg["corpus"]["views"][1].update(width=16, vocab=257)
    path.write_text(json.dumps(cfg))
    return root


def _run(root, traced=False, seed=2**31 + 77):
    return run.run_cell(CELL, seed, 0.3, traced, device="cpu", here=root / "port_bench",
                        root=root)


def test_the_loop_at_a_toy_size_is_correct(toy):
    result = _run(toy)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "score_rows_per_s", "score_p95_ms"}
    assert all(c["value"] < 1e-4 for c in result["checks"].values()), result["checks"]


class _FakeProfile:
    def __init__(self, activities=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    start = stop = lambda self: None


def test_the_traced_line_reads_the_five_per_layer_metrics(toy, monkeypatch):
    ops = [(0.0, 100.0, "moe_experts_kernel"), (150.0, 400.0, "sm90_xmma_gemm_bf16"),
           (900.0, 950.0, "Memcpy DtoH (Device -> Pageable)")]
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(trace, "device_ops", lambda prof: ops)
    result = _run(toy, traced=True)
    assert set(result["metrics"]) == {
        "mfu_bf16.luma_dsv2lite", "moe_experts_roofline_pct.luma_dsv2lite",
        "moe_experts_device_ms.luma_dsv2lite", "library_device_ms.luma_dsv2lite",
        "device_idle_pct.luma_dsv2lite"}


def test_the_control_reads_not_correct_at_a_toy_size(toy):
    # the reference with the tower's weights read in e4m3 in the port's place
    result = run.run_cell(CELL, 2**31 + 78, 0.3, False, device="cpu", system="control",
                          here=toy / "port_bench", root=toy)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values()), result["checks"]


def test_the_e4m3_read_rounds_each_tower_product_weight_and_no_other():
    loop = registry.module("loops", "closed_tower")
    w = {"t.layers.0.q.weight": torch.tensor([0.3, -0.01, 1e-3]),
         "t.layers.0.input_layernorm.weight": torch.tensor([1.01]),
         "other.weight": torch.tensor([0.3])}
    rounded = loop.E4M3Tower(w, "t.")
    # largest 0.3 -> scale 2^-10 (0.3 / 2^-10 = 307 <= 448); e4m3 keeps 3 mantissa
    # bits: 307.2 -> 320, -10.24 -> -10, 1.024 -> 1
    got = rounded["t.layers.0.q.weight"]
    assert got.tolist() == pytest.approx([0.3125, -0.009765625, 0.0009765625])
    items = dict(rounded.items())
    assert torch.equal(items["t.layers.0.q.weight"].float(), got)
    assert items["t.layers.0.input_layernorm.weight"] is w["t.layers.0.input_layernorm.weight"]
    assert rounded["other.weight"] is w["other.weight"]


def test_a_port_without_the_tower_fails_at_once(toy, monkeypatch):
    from disentagled_multimodal_fusion_tpu_torch.models import layers

    monkeypatch.delitem(layers.ENCODER_REGISTRY, "TowerTextEncoder")
    with pytest.raises(RuntimeError, match="no TowerTextEncoder"):
        _run(toy)
