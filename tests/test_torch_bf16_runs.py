"""The bf16 compute mode (``--dtype bfloat16``) in the port's training and
its runners, on the CPU.

* ``tests/test_bf16.py`` mirrored: late fusion's accuracy in bf16 within
  0.05 of float32's on a separable problem, the parameters float32; the
  FusedDMVAE trains in bf16 with finite, falling losses and float32
  parameters, and bf16 is engaged: its embedding differs from the float32
  one by more than float32 roundoff and by less than 0.1.
* A bf16 probe gets no epoch-kernel descriptor, so
  ``supports_probe_megakernel`` declines it and ``--probe-engine
  megakernel --dtype bfloat16`` trains the probes through the step loop
  (the epoch kernel's program is never built), as the JAX package does.
* The three runners with ``--dtype bfloat16 --device cpu`` finish and write
  their rows: ``run.py --quick`` on CUB, ``run_synthetic.py --quick``
  (cut to 400 rows) over DSSL (its backbone stays float32, its probe and
  late fusion are bf16), ``run_luma.py`` with
  ``--include-intermediate`` on a fixture corpus, sequentially and with
  ``--vmap-seeds --segment-epochs 1``. Every stacked-head evaluation goes
  through the head operator in its bf16 mode and never its float32 one;
  the checkpoints are float32, and ``evaluate.py`` restores them.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.megakernel import supports_probe_megakernel
from disentagled_multimodal_fusion_tpu_torch.core.train import Randomness, train
from disentagled_multimodal_fusion_tpu_torch.data.luma import make_fake_luma
from disentagled_multimodal_fusion_tpu_torch.ops import head_op

MODELS = ("dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs this file beside other test
    processes, as tests/test_torch_luma.py does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy_classification(n=240, d=10, c=3, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    means = rng.standard_normal((c, d)) * 2.0
    x1 = (means[y] + rng.standard_normal((n, d))).astype(np.float32)
    x2 = (means[y][:, ::-1] + rng.standard_normal((n, d))).astype(np.float32)
    return (torch.from_numpy(x1), torch.from_numpy(x2)), torch.from_numpy(y)


def _fit_lf(dtype):
    xs, y = _toy_classification()
    task = ttasks.build_late_fusion_task(output_dims=[10, 10], num_classes=3, hidden_dim=(32,),
                                         dropout=0.0, lr=3e-3, annealing_start=10,
                                         aggregation="cml", fused=1.0, dtype=dtype,
                                         device="cpu")
    data = {"xs": xs, "y": y}
    res = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=240,
                optimizer=task.optimizer, epochs=30, batch_size=48,
                randomness=Randomness(1, "cpu"), val_fn=task.val_fn, val_data=data)
    return task, res


def test_bf16_late_fusion_accuracy_parity():
    _, res32 = _fit_lf(None)
    task16, res16 = _fit_lf("bfloat16")
    acc32, acc16 = float(res32.val_acc[-1]), float(res16.val_acc[-1])
    assert acc32 > 0.9
    assert abs(acc32 - acc16) < 0.05, (acc32, acc16)
    assert task16.model.stack.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in task16.model.parameters())


def test_bf16_dmvae_trains_and_params_stay_f32():
    xs, _ = _toy_classification()
    kw = dict(output_dim=[10, 10], a=1e-5, hidden_dim=32, embed_dim=4, fused_modalities=True,
              device="cpu")
    model = ttasks.build_dmvae_task(**kw, dtype="bfloat16")
    loss_fn, opt = ttasks.dmvae_objective(model, lr=1e-3, num_epochs=5)
    res = train(model=model, loss_fn=loss_fn, data={"xs": xs}, n_train=240, optimizer=opt,
                epochs=5, batch_size=48, randomness=Randomness(1, "cpu"))
    losses = np.asarray(res.train_loss)
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # bf16 engaged: the same weights give another embedding in float32,
    # further apart than float32 roundoff but close
    model32 = ttasks.build_dmvae_task(**kw)
    model32.load_state_dict(model.state_dict())
    with torch.no_grad():
        zc16, _ = model.get_embedding(xs)
        zc32, _ = model32.get_embedding(xs)
    assert zc16.dtype == zc32.dtype == torch.float32
    diff = float(torch.max(torch.abs(zc16 - zc32)))
    assert 1e-5 < diff < 0.1, diff


def test_bf16_probe_has_no_epoch_kernel_descriptor():
    kw = dict(num_modalities=3, num_classes=4, input_dim=8, hidden_dim=(16,), device="cpu")
    f32 = ttasks.build_probe_task(**kw)
    bf16 = ttasks.build_probe_task(**kw, dtype="bfloat16")
    assert supports_probe_megakernel(f32.megakernel, f32.optimizer)
    assert bf16.megakernel is None
    assert not supports_probe_megakernel(bf16.megakernel, bf16.optimizer)
    dis = ttasks.build_disentangled_probe_task(**kw, dtype="bfloat16")
    assert dis.megakernel is None and not supports_probe_megakernel(dis.megakernel,
                                                                    dis.optimizer)


@pytest.fixture
def head_modes(monkeypatch):
    """Counts the head operator's calls on the CPU by mode: its plain
    versions, which the operator's CPU implementation looks up here."""
    calls = {"float32": 0, "bfloat16": 0}
    plain32, plain16 = (head_op.evidential_heads_stacked_plain,
                        head_op.evidential_heads_stacked_bf16_plain)

    def count(mode, fn):
        def counted(*args):
            calls[mode] += 1
            return fn(*args)
        return counted

    monkeypatch.setattr(head_op, "evidential_heads_stacked_plain", count("float32", plain32))
    monkeypatch.setattr(head_op, "evidential_heads_stacked_bf16_plain",
                        count("bfloat16", plain16))
    return calls


def _checkpoints_are_f32(root):
    paths = sorted((root / "checkpoints").glob("*.pt"))
    assert paths
    for path in paths:
        state = torch.load(path, map_location="cpu", weights_only=True)
        tensors = [v for v in state.values() if torch.is_tensor(v) and v.is_floating_point()]
        assert tensors and all(v.dtype == torch.float32 for v in tensors), path


def test_run_trains_a_bf16_cub_cell_through_the_step_loop(tmp_path, monkeypatch, head_modes):
    from disentagled_multimodal_fusion_tpu_torch.core import megakernel
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    def no_program(*args, **kwargs):
        raise AssertionError("a bf16 probe reached the epoch kernel's program")

    monkeypatch.setattr(megakernel, "make_probe_megakernel_program", no_program)
    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path))
    rows = runner.main(["--quick", "--seeds", "0", "--datasets", "CUB", "--conditions",
                        "Normal", "--device", "cpu", "--dtype", "bfloat16", "--probe-engine",
                        "megakernel", "--skip-report"])
    cell = rows[0]["Normal"]["CUB"]
    assert sorted(cell) == sorted(MODELS)
    for name, info in cell.items():
        assert np.isfinite(info["fused"]["accuracy"]), name
    assert head_modes["bfloat16"] > 0 and head_modes["float32"] == 0, head_modes
    _checkpoints_are_f32(tmp_path)


def test_run_synthetic_bf16_keeps_the_dssl_backbone_f32(tmp_path, monkeypatch, head_modes):
    """The probe and late fusion in bf16; the DSSL backbone float32."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run_synthetic

    real_kwargs = run_synthetic.preset_data_kwargs
    monkeypatch.setattr(run_synthetic, "preset_data_kwargs",
                        lambda *a: {**real_kwargs(*a), "n_samples": 400})
    dtypes = {}
    for name in ("build_dmvae_task", "build_probe_task", "build_late_fusion_task",
                 "build_disentangledssl_task"):
        def spy(*args, _name=name, _real=getattr(ttasks, name), **kw):
            dtypes.setdefault(_name, set()).add(kw.get("dtype"))
            return _real(*args, **kw)
        monkeypatch.setattr(ttasks, name, spy)
    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path))
    with redirect_stdout(io.StringIO()):
        rows = run_synthetic.main(["--quick", "--seeds", "0", "--deps", "50", "--device", "cpu",
                                   "--dtype", "bfloat16", "--backbone", "dssl"])
    assert sorted(rows[0][50]) == ["avg", "cml", "dmvae_cml"]
    for name, info in rows[0][50].items():
        assert np.isfinite(info["fused"]["accuracy"]), name
    assert dtypes["build_probe_task"] == dtypes["build_late_fusion_task"] == {"bfloat16"}
    assert dtypes["build_disentangledssl_task"] == {None} and "build_dmvae_task" not in dtypes
    assert head_modes["bfloat16"] > 0 and head_modes["float32"] == 0, head_modes
    _checkpoints_are_f32(tmp_path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One fixture corpus, so its feature cache serves both engines."""
    return make_fake_luma(str(tmp_path_factory.mktemp("luma") / "corpus"), n_classes=3,
                          train_per_class=4, test_per_class=2, ood_classes=1)


@pytest.mark.parametrize("engine", [[], ["--vmap-seeds", "--segment-epochs", "1"]],
                         ids=["sequential", "vmap_seeds"])
def test_run_luma_bf16(engine, corpus, tmp_path, monkeypatch, head_modes):
    from disentagled_multimodal_fusion_tpu_torch.runners import evaluate, run_luma

    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path))
    seeds = ["0", "1"] if engine else ["0"]
    with redirect_stdout(io.StringIO()):
        rows = run_luma.main(["--data-path", corpus, "--seeds", *seeds, "--ood-eval",
                              "--include-intermediate", "--dmvae-epochs", "1", "--probe-epochs",
                              "1", "--device", "cpu", "--dtype", "bfloat16", *engine])
    for s in seeds:
        models = rows[int(s)]["Normal"]["LUMA"]
        assert sorted(models) == sorted([*MODELS, "intermediate_fusion"])
        for name, info in models.items():
            assert np.isfinite(info["fused"]["accuracy"]), (s, name)
    assert head_modes["bfloat16"] > 0 and head_modes["float32"] == 0, head_modes
    _checkpoints_are_f32(tmp_path)
    args = evaluate.parse_args(["--model", "cml_fusion", "--dataset", "LUMA", "--seed", "0",
                                "--data-path", corpus, "--device", "cpu"])
    assert np.isfinite(evaluate.eval_luma(args, torch.device("cpu"))["fused"]["accuracy"])
