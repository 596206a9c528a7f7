"""Checkpoint restore in the port: the JAX package's checkpoints carried
over, and the port's own.

* The JAX package saves an Orbax checkpoint of a perturbed backbone and
  heads and restores it; ``convert.py`` carries the trees into the port,
  which saves them as ``.pt`` under the same names. The port's
  ``runners/serve.py`` (restoring at its default paths) and
  ``runners/evaluate.py`` then match the JAX package's
  ``runners/serve.py::_load`` and ``runners/evaluate.py::_eval_mat`` on the
  same rows, at tests/test_torch_serve.py's tolerances: evidence and probs
  rtol 1e-4 / atol 1e-5, epistemic and aleatoric atol 1e-6, ``pred``
  equal (float32 sums of up to 1024 terms in another order).
* A checkpoint the port's ``run_condition`` wrote serves, and evaluates,
  bit for bit what the in-memory model does.
* ``restore_checkpoint`` never loads partially: a missing file, key or
  shape raises.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu.core import checkpoint as jckpt
from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu.runners import common as jcommon
from disentagled_multimodal_fusion_tpu.runners import evaluate as jevaluate
from disentagled_multimodal_fusion_tpu.runners import serve as jserve
from disentagled_multimodal_fusion_tpu_torch.convert import load_flax_params
from disentagled_multimodal_fusion_tpu_torch.core import checkpoint as tckpt
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.serve import to_host
from disentagled_multimodal_fusion_tpu_torch.data.multiview import DATASET_REGISTRY
from disentagled_multimodal_fusion_tpu_torch.runners import common as tcommon
from disentagled_multimodal_fusion_tpu_torch.runners import evaluate as tevaluate
from disentagled_multimodal_fusion_tpu_torch.runners import serve as tserve

CPU = torch.device("cpu")
DATASET = "CUB"


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + np.float32(0.05) * rng.standard_normal(
        a.shape, dtype=np.float32), params)


@pytest.fixture(scope="module")
def carried_over(tmp_path_factory):
    """A perturbed JAX checkpoint of the CUB backbone and of dmvae_cml's and
    cml_fusion's heads, restored by the JAX package; the port saves each
    tree after convert.py under the sweep's names (seed 0)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMF_ARTIFACT_ROOT", str(tmp_path_factory.mktemp("restore")))
        C = tcommon.make_getter(tcommon.load_config())
        views, _ = DATASET_REGISTRY[DATASET]().arrays()
        dims = [v.shape[1] for v in views]
        probe = dict(num_modalities=len(dims), num_classes=10, input_dim=C("probes.input_dim"),
                     hidden_dim=tuple(C("probes.model_hidden_dim")))
        _, bb_params, *_ = jtasks.build_dmvae_task(
            rng=jax.random.PRNGKey(0), xs_sample=[jnp.asarray(v[:2]) for v in views],
            output_dim=dims, a=C("dmvae.a"), hidden_dim=C("dmvae.hidden_dim"),
            embed_dim=C("dmvae.embed_dim"), fused_modalities=True)
        port = {
            tcommon.backbone_checkpoint(DATASET, 0, "normal"): (bb_params, ttasks.build_dmvae_task(
                output_dim=dims, hidden_dim=C("dmvae.hidden_dim"), embed_dim=C("dmvae.embed_dim"),
                fused_modalities=True, device=CPU)),
            f"checkpoints/{tcommon.head_name('dmvae_cml', DATASET, 0, 'normal')}": (
                jtasks.build_probe_task(rng=jax.random.PRNGKey(0), aggregation="cml",
                                        **probe).params,
                ttasks.build_probe_task(aggregation="cml", device=CPU, **probe).model),
            f"checkpoints/{tcommon.head_name('cml_fusion', DATASET, 0, 'normal')}": (
                jtasks.build_late_fusion_task(rng=jax.random.PRNGKey(0), output_dims=dims,
                                              num_classes=10, hidden_dim=probe["hidden_dim"],
                                              aggregation="cml").params,
                ttasks.build_late_fusion_task(output_dims=dims, num_classes=10,
                                              hidden_dim=probe["hidden_dim"], aggregation="cml",
                                              device=CPU).model),
        }
        for i, (name, (params, _)) in enumerate(port.items()):
            jckpt.save_checkpoint(name, _perturbed(params, 10 + i))
        for name, (params, module) in port.items():
            restored = jax.device_get(jckpt.restore_checkpoint(name, params))
            tckpt.save_checkpoint(name, load_flax_params(module, restored))
        yield C


def _close(port, ref, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(port, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


def _same_tree(port, ref, path=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _same_tree(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same_tree(a, b, f"{path}[{i}]")
    else:
        _close(port, ref, atol=1e-6 if "epistemic" in path or "aleatoric" in path else 1e-5)


@pytest.mark.parametrize("model", ["dmvae_cml", "cml_fusion"])
def test_serve_restores_a_jax_checkpoint_as_the_jax_package(carried_over, model):
    argv = ["--model", model, "--dataset", DATASET, "--seed", "0", "--buckets", "8"]
    targs = tserve.parse_args(argv + ["--device", "cpu"])
    jargs = argparse.Namespace(seed=0, model=model, dataset=DATASET, buckets=[8],
                               no_fused_dmvae=False, random_init=False, checkpoint=None,
                               dmvae_checkpoint=None)
    jinfer, jxs = jserve._load(jargs, jcommon.make_getter(jcommon.load_config("config.yaml")))
    tinfer, txs = tserve.load(targs, carried_over, CPU)
    ref = jax.device_get(jinfer(jxs))
    port = to_host(tinfer(txs))
    for k in ("evidence", "fused_evidence", "probs"):
        _close(port[k], ref[k])
    for k in ("epistemic", "aleatoric"):
        _close(port[k], ref[k], atol=1e-6)
    np.testing.assert_array_equal(port["pred"], np.asarray(ref["pred"]))
    # and the restored head is not its init
    fresh, _ = tserve.load(tserve.parse_args(argv + ["--device", "cpu", "--random-init"]),
                           carried_over, CPU)
    assert not np.allclose(to_host(fresh(txs))["evidence"], port["evidence"])


@pytest.mark.parametrize("model,condition", [("dmvae_cml", "normal"), ("cml_fusion", "conflict")])
def test_evaluate_restores_a_jax_checkpoint_as_the_jax_package(carried_over, model, condition):
    """The conflict case replays the perturbed split and names the
    checkpoints (the sweep's Normal ones) with --checkpoint."""
    names = ["--checkpoint", f"checkpoints/{tcommon.head_name(model, DATASET, 0, 'normal')}",
             "--dmvae-checkpoint", tcommon.backbone_checkpoint(DATASET, 0, "normal")]
    argv = ["--model", model, "--dataset", DATASET, "--seed", "0", "--condition", condition,
            *(names if condition != "normal" else [])]
    targs = tevaluate.parse_args(argv + ["--device", "cpu"])
    jargs = argparse.Namespace(**{k: v for k, v in vars(targs).items() if k != "device"})
    ref = jevaluate._eval_mat(jargs, jcommon.make_getter(jcommon.load_config("config.yaml")))
    _same_tree(tevaluate.eval_mat(targs, carried_over, CPU), ref)


def test_evaluate_refuses_the_datasets_whose_backbone_is_not_ported():
    # every dataset's backbone is ported now: the synthetic branch
    # (tests/test_torch_synthetic.py) and LUMA's (tests/test_torch_luma.py)
    # parse, and only an unknown model is refused
    assert tevaluate.parse_args(["--model", "dmvae_cml", "--dataset", "synthetic"]).dep == 50
    args = tevaluate.parse_args(["--model", "cml_fusion", "--dataset", "LUMA", "--data-path",
                                 "corpus", "--use-2d", "--replicate-image-bug"])
    assert (args.dataset, args.data_path, args.use_2d, args.replicate_image_bug) == (
        "LUMA", "corpus", True, True)
    with pytest.raises(SystemExit):
        tevaluate.parse_args(["--model", "intermediate_fusion", "--dataset", "LUMA"])


def _tiny_config():
    cfg = tcommon.load_config()
    cfg["dmvae"].update(hidden_dim=16, embed_dim=8, num_epochs=2)
    cfg["probes"].update(input_dim=8, model_hidden_dim=[8], model_epochs=2)
    return tcommon.make_getter(cfg)


def test_a_sweep_checkpoint_serves_and_evaluates_as_the_in_memory_model(tmp_path, monkeypatch):
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path))
    kept, real = {}, tckpt.save_checkpoint

    def keep(path, module, hparams=None):
        kept[path] = module
        return real(path, module, hparams)

    monkeypatch.setattr(tckpt, "save_checkpoint", keep)
    C, rows = _tiny_config(), {}
    runner.run_condition(C=C, seed=0, dataset_name=DATASET, conflict=False, quick=False,
                         device=CPU, rows_out=rows)
    backbone = kept[tcommon.backbone_checkpoint(DATASET, 0, "normal")]
    for model in ("dmvae_cml", "cml_fusion"):
        infer, xs = tserve.load(tserve.parse_args(
            ["--model", model, "--dataset", DATASET, "--buckets", "32", "--device", "cpu"]), C, CPU)
        head = kept[f"checkpoints/{tcommon.head_name(model, DATASET, 0, 'normal')}"]
        with torch.no_grad():
            zc, zp = backbone.get_embedding(xs)
            ev = head(zc, zp) if model.startswith("dmvae_") else head(xs)
        assert torch.equal(infer(xs)["evidence"], ev), model
        info = tevaluate.eval_mat(tevaluate.parse_args(
            ["--model", model, "--dataset", DATASET, "--device", "cpu"]), C, CPU)
        assert info == {k: v for k, v in rows[model].items() if k not in ("path", "fit_seconds")}


def test_restore_never_loads_partially(tmp_path, monkeypatch):
    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path))
    src = ttasks.build_late_fusion_task(output_dims=(5, 3), num_classes=4, hidden_dim=(6,),
                                        device=CPU).model
    path = tckpt.save_checkpoint("checkpoints/late", src, {"model": "late"})
    assert path == str(tmp_path / "checkpoints" / "late.pt")
    same = ttasks.build_late_fusion_task(output_dims=(5, 3), num_classes=4, hidden_dim=(6,),
                                         seed=9, device=CPU).model
    tckpt.restore_checkpoint("checkpoints/late", same)
    for a, b in zip(same.state_dict().values(), src.state_dict().values()):
        assert torch.equal(a, b)
    wider = ttasks.build_late_fusion_task(output_dims=(5, 3), num_classes=4, hidden_dim=(7,),
                                          device=CPU).model
    with pytest.raises(RuntimeError, match="size mismatch"):
        tckpt.restore_checkpoint("checkpoints/late", wider)
    with pytest.raises(RuntimeError, match="(?s)Missing key.*Unexpected key"):
        tckpt.restore_checkpoint("checkpoints/late", torch.nn.Linear(5, 4))
    with pytest.raises(FileNotFoundError, match="nothing.pt"):
        tckpt.restore_checkpoint("checkpoints/nothing", same)
