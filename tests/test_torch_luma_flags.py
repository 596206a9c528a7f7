"""``runners/run_luma.py``'s data and model flags end to end on the CPU, on
the LUMA fixture corpus of tests/test_torch_luma.py (one epoch each,
network refused, one torch thread): ``--no-fused-dmvae``, ``--use-2d``,
``--use-ood``, ``--replicate-image-bug`` and ``--intermediate-fusion lrtf
concat_linear`` each give finite rows for every model; for the first,
second and fourth, ``runners/evaluate.py --dataset LUMA`` with the same
flag gives back the run's rows of ``dmvae_cml`` and ``cml_fusion`` from
the checkpoints.
"""

import io
import math
from contextlib import redirect_stdout

import pytest
import torch
from test_torch_luma import corpus, offline_and_one_thread  # noqa: F401 (fixtures)

from disentagled_multimodal_fusion_tpu_torch.runners import evaluate, run_luma

BASE = ["dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion"]
CASES = {
    "no_fused_dmvae": (["--no-fused-dmvae"], BASE, True),
    "use_2d": (["--use-2d"], BASE, True),
    "use_ood": (["--use-ood"], BASE, False),
    "replicate_image_bug": (["--replicate-image-bug"], BASE, True),
    "intermediate_lrtf_concat_linear": (
        ["--intermediate-fusion", "lrtf", "concat_linear"],
        BASE + ["intermediate_lrtf", "intermediate_concat_linear"], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_luma_flag_end_to_end(corpus, tmp_path, monkeypatch, case):  # noqa: F811
    flags, models, evaluated = CASES[case]
    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path))
    out = io.StringIO()
    with redirect_stdout(out):
        rows = run_luma.main(["--data-path", corpus, "--seeds", "0", "--dmvae-epochs", "1",
                              "--probe-epochs", "1", "--device", "cpu", *flags])
    got = rows[0]["Normal"]["LUMA"]
    assert sorted(got) == sorted(models)
    for name, info in got.items():
        for view, metrics in info.items():
            if isinstance(metrics, dict) and "accuracy" in metrics:
                assert math.isfinite(metrics["accuracy"]), (name, view)
                assert math.isfinite(metrics["ece"]), (name, view)
    # --use-ood trains on the held-out class too
    classes = "16 train / 8 test, 4" if case == "use_ood" else "12 train / 6 test, 3"
    assert f"LUMA: {classes} classes" in out.getvalue()
    if not evaluated:
        return
    for name in ("dmvae_cml", "cml_fusion"):
        args = evaluate.parse_args(["--model", name, "--dataset", "LUMA", "--seed", "0",
                                    "--data-path", corpus, "--device", "cpu", *flags])
        with redirect_stdout(io.StringIO()):
            info = evaluate.eval_luma(args, torch.device("cpu"))
        want = {k: v for k, v in got[name].items() if k not in ("path", "fit_seconds")}
        assert info == want, name
