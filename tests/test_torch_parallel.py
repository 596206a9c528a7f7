"""The port's mesh (``parallel/``) in one process, against the JAX package.

* ``process_rows`` and ``host_local_block`` equal the JAX package's over a
  grid of (rows, processes, process id);
* ``sweep_parallel``'s ``partition``, ``_expand_env`` and ``merge_rows``
  equal the JAX runner's on the same inputs;
* ``initialize()`` is a no-op without a launcher's environment, and stays
  one when called again;
* the errors of the JAX package: ``train_many(mesh=)`` (and the seed-split
  cell and job) when the seed count does not divide by the ``data`` axis,
  and ``place_global``'s guard; a mesh with a ``model`` axis knows its
  position, and needs the process groups ``make_mesh`` makes;
* the runners' refusals: ``--model-parallel 2`` without a process group of
  its ranks (the launch message, which names both axes),
  ``--probe-engine megakernel`` with ``--data-parallel 2`` or
  ``--model-parallel 2`` (as in the JAX runner), and ``--data-parallel 2``
  without a process group (the launch message);
* every objective of the trainers is a mean over the rows its draws are
  cut to: a batch's loss is the rows-weighted sum of its parts' losses,
  each part with its rows of the draws (``Objective.rows``), which is what
  ``train(mesh=)`` sums over the ranks (the unfused heads' too);
* a fit over a mesh keeps no earlier step's summed gradients alive (its
  losses are no views of them);
* ``ServingEngine(divisor=)`` rounds the buckets as the JAX engine does,
  and a mesh-built inference function of one rank serves and exports the
  single-device program.

The multi-process runs are ``tests/test_torch_multiprocess.py``.
"""

import json

import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu.parallel import distributed as jdist
from disentagled_multimodal_fusion_tpu.runners import sweep_parallel as jsweep
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.megakernel import supports_probe_megakernel
from disentagled_multimodal_fusion_tpu_torch.core.serve import (
    ServingEngine,
    build_inference_fn,
    export_inference,
    head_op_calls,
)
from disentagled_multimodal_fusion_tpu_torch.core.sweep_cell import CellJob, fit_job
from disentagled_multimodal_fusion_tpu_torch.core.train import Randomness, stack_params, train_many
from disentagled_multimodal_fusion_tpu_torch.models.fusions import INTERMEDIATE_FUSIONS
from disentagled_multimodal_fusion_tpu_torch.parallel import distributed as tdist
from disentagled_multimodal_fusion_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    rows_of,
    split_rows,
)
from disentagled_multimodal_fusion_tpu_torch.runners import sweep_parallel as tsweep

GRID = [(n, pc, pid) for n in (0, 5, 103) for pc in (1, 2, 3, 8) for pid in range(pc)]


@pytest.mark.parametrize("n,processes,pid", GRID)
def test_host_feeding_matches_jax(n, processes, pid):
    assert tdist.process_rows(n, pid, processes) == jdist.process_rows(n, pid, processes)
    arr = np.arange(max(n, 1) * 3).reshape(max(n, 1), 3)[:n]
    for spec, jspec in ((("data",), jdist.P("data")), ((), jdist.P()),
                        ((None, "model"), jdist.P(None, "model"))):
        np.testing.assert_array_equal(
            tdist.host_local_block(arr, spec, pid, processes),
            jdist.host_local_block(arr, jspec, pid, processes))


def test_sweep_helpers_match_jax(tmp_path):
    items = ["CUB", "HandWritten", "PIE", "Scene"]
    for n in (1, 2, 3, 8):
        assert tsweep.partition(items, n) == jsweep.partition(items, n)
    pairs = ["CUDA_VISIBLE_DEVICES={rank}", "NRANKS={nranks}", "PLAIN=x"]
    assert tsweep._expand_env(pairs, 2, 4) == jsweep._expand_env(pairs, 2, 4)
    with pytest.raises(SystemExit, match="KEY=VAL"):
        tsweep._expand_env(["NOEQUALS"], 0, 1)
    w0 = {"0": {"Normal": {"CUB": {"m1": {"a": 1}}}, "Conflict": {"CUB": {"m1": {"a": 2}}}}}
    w1 = {"0": {"Normal": {"PIE": {"m1": {"a": 3}}}}, "1": {"Normal": {"PIE": {"m": {}}}}}
    paths = [tmp_path / "w0.json", tmp_path / "w1.json", tmp_path / "missing.json"]
    paths[0].write_text(json.dumps(w0))
    paths[1].write_text(json.dumps(w1))
    assert tsweep.merge_rows(paths) == jsweep.merge_rows(paths)
    assert tsweep.RUN_MODULE == "disentagled_multimodal_fusion_tpu_torch.runners.run"


def test_initialize_is_a_no_op_without_a_launcher(monkeypatch):
    for var in tdist.CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize() is False
    assert tdist.initialize(backend="gloo", device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (tdist.world_size(), tdist.rank(), tdist.is_writer()) == (1, 0, True)
    mesh = make_mesh()
    assert (mesh.shape, mesh.axis_names, mesh.data_index) == ({"data": 1, "model": 1},
                                                              ("data", "model"), 0)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(2)


@pytest.mark.parametrize("device,named,local,cards,want", [
    ("cpu", True, "2", 0, "gloo"),
    ("cuda:0", False, "1", 1, "nccl"),      # one rank on the one card
    ("cuda:1", False, "4", 4, "nccl"),      # torchrun over four cards
    ("cuda:1", False, "2", 1, "gloo"),      # more ranks here than cards
    ("cuda:0", True, "2", 4, "gloo"),       # every rank named cuda:0
    ("cuda:0", True, "1", 1, "nccl"),
])
def test_the_backend_follows_what_the_ranks_share(device, named, local, cards, want,
                                                  monkeypatch):
    """NCCL where each rank has a card of its own; gloo on the CPU and where
    ranks share a card (NCCL refuses that)."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tdist.default_backend(torch.device(device), named) == want
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.setenv("WORLD_SIZE", local)  # torch's launchers without LOCAL_WORLD_SIZE
    assert tdist.default_backend(torch.device(device), named) == want


def test_from_rank0_without_a_group_runs_the_function():
    assert tdist.from_rank0(lambda: (1, "a")) == (1, "a")


def test_row_splits_cover_the_batch():
    for n in (0, 1, 2, 7, 100):
        for parts in (1, 2, 3):
            bounds = split_rows(n, parts)
            assert bounds[0][0] == 0 and bounds[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
            assert max(hi - lo for lo, hi in bounds) - min(hi - lo for lo, hi in bounds) <= 1
    assert rows_of(7, Mesh(3, rank=2)) == slice(5, 7)


def test_the_jax_errors():
    mesh = Mesh(2)
    tasks = [ttasks.build_probe_task(num_modalities=2, num_classes=3, input_dim=4,
                                     hidden_dim=(8,), seed=s, device="cpu") for s in range(3)]
    rng = np.random.default_rng(0)
    data = {"zc": torch.from_numpy(rng.standard_normal((3, 10, 4)).astype(np.float32)),
            "zp": torch.from_numpy(rng.standard_normal((3, 10, 2, 4)).astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, 3, (3, 10)))}
    with pytest.raises(ValueError, match=r"train_many\(mesh=...\): instance count 3 must divide "
                                         r"by the mesh 'data' axis \(2\)"):
        train_many(model=tasks[0].model, params=stack_params([t.model for t in tasks]),
                   loss_fn=tasks[0].loss_fn, data=data, n_train=10,
                   optimizer=tasks[0].optimizer, epochs=1, batch_size=4,
                   randomness=[Randomness(s, "cpu") for s in range(3)], mesh=mesh)
    job = CellJob("dmvae_cml", tasks, [Randomness(s, "cpu") for s in range(3)], "probe", 1, True)
    with pytest.raises(ValueError, match="seed count 3 must divide"):
        fit_job(job, (data, data), 10, 4, mesh=mesh)
    mesh12 = Mesh(1, 2, rank=1)
    assert (mesh12.data_index, mesh12.model_index) == (0, 1)
    with pytest.raises(RuntimeError, match="no process groups"):
        mesh12.data_group
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(2, model_parallel=2)
    desc = tasks[0].megakernel
    assert supports_probe_megakernel(desc, tasks[0].optimizer)
    assert not supports_probe_megakernel(desc, tasks[0].optimizer, mesh=mesh)


def test_place_global_guard(monkeypatch):
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    np.testing.assert_array_equal(tdist.place_global(x, ("data",)).numpy(), x)
    monkeypatch.setattr(tdist, "world_size", lambda: 2)
    monkeypatch.setattr(tdist, "rank", lambda: 1)
    with pytest.raises(ValueError, match="must divide evenly over 2 processes"):
        tdist.place_global(x, ("data",))
    np.testing.assert_array_equal(tdist.place_global(x, ()).numpy(), x)
    np.testing.assert_array_equal(tdist.place_global(x[:4], ("data",)).numpy(), x[2:4])


LAUNCH_MP2 = "--nproc-per-node 2 -m <runner> --data-parallel 1 --model-parallel 2"


@pytest.mark.parametrize("runner,flags,message", [
    ("run", ["--model-parallel", "2"], LAUNCH_MP2),
    ("run_synthetic", ["--model-parallel", "2"], LAUNCH_MP2),
    ("run_luma", ["--model-parallel", "2"], LAUNCH_MP2),
    ("run", ["--probe-engine", "megakernel", "--data-parallel", "2"],
     "--probe-engine megakernel is single-device"),
    ("run", ["--probe-engine", "megakernel", "--model-parallel", "2"],
     "--probe-engine megakernel is single-device"),
], ids=["run", "run_synthetic", "run_luma", "megakernel_data", "megakernel_model"])
def test_runners_refuse(runner, flags, message, capsys, monkeypatch):
    """``--model-parallel 2`` parses; without a process group of its two
    ranks the runner exits naming the launch. ``run.py`` refuses the epoch
    kernel on a mesh, as the JAX runner does."""
    import importlib

    for var in tdist.CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)
    module = importlib.import_module(f"disentagled_multimodal_fusion_tpu_torch.runners.{runner}")
    argv = ["--seeds", "0", *flags, "--device", "cpu"]
    with pytest.raises(SystemExit) as exit_info:
        assert module.parse_args(argv).model_parallel == 2
        module.main(argv)
    assert message in capsys.readouterr().err + str(exit_info.value)


@pytest.mark.parametrize("runner", ["run", "run_synthetic", "run_luma"])
def test_data_parallel_without_a_process_group_names_the_launch(runner, monkeypatch):
    import importlib

    for var in tdist.CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)
    module = importlib.import_module(f"disentagled_multimodal_fusion_tpu_torch.runners.{runner}")
    args = module.parse_args(["--seeds", "0", "--data-parallel", "2", "--device", "cpu"])
    assert args.data_parallel == 2
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        module.main(["--seeds", "0", "--data-parallel", "2", "--device", "cpu"])


def _views(n, dims, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)) for d in dims)


def _objectives():
    dims, rows = (12, 8), 11
    xs = _views(rows, dims, 0)
    y = torch.from_numpy(np.random.default_rng(1).integers(0, 3, rows))
    zc, zp = torch.randn(rows, 4, generator=torch.Generator().manual_seed(2)), \
        torch.randn(rows, 2, 4, generator=torch.Generator().manual_seed(3))
    probe = {"zc": zc, "zp": zp, "y": y}
    raw = {"xs": xs, "y": y}
    out = {}
    for fused in (True, False):
        bb = ttasks.build_dmvae_task(output_dim=dims, hidden_dim=16, embed_dim=4, dropout=0.2,
                                     fused_modalities=fused, device="cpu")
        out["dmvae" if fused else "dmvae_unfused"] = (
            ttasks.dmvae_objective(bb, num_epochs=4)[0], {"xs": xs})
    kw = dict(num_modalities=2, num_classes=3, input_dim=4, hidden_dim=(8,), dropout=0.3,
              annealing_start=2, device="cpu")
    out["probe"] = (ttasks.build_probe_task(**kw).loss_fn, probe)
    out["disentangled_probe"] = (ttasks.build_disentangled_probe_task(**kw).loss_fn, probe)
    out["late_fusion"] = (ttasks.build_late_fusion_task(
        output_dims=dims, num_classes=3, hidden_dim=(8,), dropout=0.3, annealing_start=2,
        device="cpu").loss_fn, raw)
    out["probe_unfused"] = (ttasks.build_probe_task(fused_heads=False, **kw).loss_fn, probe)
    out["disentangled_probe_unfused"] = (
        ttasks.build_disentangled_probe_task(fused_heads=False, **kw).loss_fn, probe)
    out["late_fusion_unfused"] = (ttasks.build_late_fusion_task(
        output_dims=dims, num_classes=3, hidden_dim=(8,), dropout=0.3, annealing_start=2,
        fused_heads=False, device="cpu").loss_fn, raw)
    for fusion in TWO_VIEW_FUSIONS:
        out[f"intermediate_{fusion}"] = (ttasks.build_intermediate_fusion_task(
            output_dims=dims, num_classes=3, fusion=fusion, annealing_start=2,
            device="cpu").loss_fn, raw)
    return out


TWO_VIEW_FUSIONS = [f for f in INTERMEDIATE_FUSIONS if f != "mi3"]  # mi3 takes three views
OBJECTIVES = ["dmvae", "dmvae_unfused", "probe", "disentangled_probe", "late_fusion",
              "probe_unfused", "disentangled_probe_unfused", "late_fusion_unfused",
              *(f"intermediate_{f}" for f in TWO_VIEW_FUSIONS)]


@pytest.mark.parametrize("name", OBJECTIVES)
def test_objectives_are_row_means_over_their_cut_draws(name):
    loss_fn, data = _objectives()[name]
    rows = 11
    draws = loss_fn.draw_epoch(Randomness(4, "cpu"), [rows])[0]
    mask = torch.ones(rows)
    with torch.no_grad():
        whole, _ = loss_fn.compute(data, mask, 1, draws)
        for parts in (2, 3, 12):
            total = torch.zeros(())
            for lo, hi in split_rows(rows, parts):
                part = {k: (tuple(t[lo:hi] for t in v) if isinstance(v, tuple) else v[lo:hi])
                        for k, v in data.items()}
                loss, _ = loss_fn.compute(part, torch.ones(hi - lo), 1,
                                          loss_fn.rows(draws, lo, hi))
                total = total + loss * ((hi - lo) / rows)
            np.testing.assert_allclose(float(total), float(whole), rtol=2e-6, err_msg=str(parts))


def test_a_mesh_fit_keeps_no_earlier_steps_gradients():
    """Under a mesh each step's gradients come summed in one buffer; the
    step's loss is read from it, and must not keep it alive in the epoch's
    list of losses: at an epoch's fourth step only the last step's buffer
    may be live (the trainer still holds its gradients)."""
    import gc

    from disentagled_multimodal_fusion_tpu_torch.core.train import Objective, train

    task = ttasks.build_probe_task(num_modalities=2, num_classes=3, input_dim=4,
                                   hidden_dim=(8,), annealing_start=2, device="cpu")
    rows = 40
    data = {"zc": torch.randn(rows, 4), "zp": torch.randn(rows, 2, 4),
            "y": torch.from_numpy(np.random.default_rng(5).integers(0, 3, rows))}
    flat = 4 * (1 + sum(p.numel() for p in task.model.parameters()))
    live, calls = [], [0]

    def loss(*args):
        calls[0] += 1
        if calls[0] == 4:
            live.append(len({t.untyped_storage().data_ptr() for t in gc.get_objects()
                             if isinstance(t, torch.Tensor)
                             and t.untyped_storage().nbytes() == flat}))
        return task.loss_fn.loss(*args)

    objective = Objective(None, loss, draw_epoch=task.loss_fn.draw_epoch)
    train(model=task.model, loss_fn=objective, data=data, n_train=rows,
          optimizer=task.optimizer, epochs=1, batch_size=10, randomness=Randomness(6, "cpu"),
          mesh=Mesh(1))
    assert live == [1]


def test_engine_divisor_and_a_one_rank_mesh_serve_and_export():
    from disentagled_multimodal_fusion_tpu.core.serve import ServingEngine as JaxEngine

    for buckets, div in (((1, 8, 64, 256), 2), ((3, 5, 7), 3), ((1, 2), 1)):
        assert ServingEngine(None, buckets, div).buckets == JaxEngine(None, buckets, div).buckets
    with pytest.raises(ValueError, match="divisor"):
        ServingEngine(None, (1,), 0)
    task = ttasks.build_late_fusion_task(output_dims=(12, 8), num_classes=3, hidden_dim=(8,),
                                         device="cpu")
    xs = tuple(x.numpy() for x in _views(5, (12, 8), 5))
    plain = ServingEngine(build_inference_fn(task), (4, 8))(xs)
    meshed = build_inference_fn(task, mesh=Mesh(1))
    served = ServingEngine(meshed, (4, 8), divisor=1)(xs)
    for k, v in plain.items():
        np.testing.assert_array_equal(served[k], v, err_msg=k)
    with pytest.raises(ValueError, match="divisor=2"):
        build_inference_fn(task, mesh=Mesh(2))(xs)
    assert head_op_calls(export_inference(meshed, tuple(x[:4] for x in xs))) == 1
