"""The mesh's ``model`` axis of the port in one process, against the JAX
package's rule.

For every parameter of the models the runners train (FusedDMVAE and the
per-modality DMVAE at HandWritten's widths and hidden 512, DisentangledSSL
at 512, the fused probes and late fusion at 128, the LUMA encoders under a
late fusion at 128 and a FusedDMVAE at 512, and IntermediateFusion over
``concat_linear`` at 128 and over ``lft`` at its feed-forward's 2048):

* ``convert.param_layouts`` maps the port's tensor onto the flax
  leaf ``convert.py`` maps it from, exactly;
* the port's partition spec equals JAX ``param_sharding_rule``'s;
* at each position (i, r) of ``make_mesh(2 | 4, model_parallel=2)`` the
  port's block (``shard_params`` for data index i, model index r) equals,
  after ``convert.py``, the JAX ``shard_params`` array's shard on the
  device at that position.

A width the model axis does not divide raises ``ValueError`` in both
packages. The fits on a real model axis are
``tests/test_torch_multiprocess_model.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu.models import layers as jlayers
from disentagled_multimodal_fusion_tpu.parallel import mesh as jmesh
from disentagled_multimodal_fusion_tpu_torch.convert import (
    _flatten,
    _port_key,
    flax_to_state_dict,
    load_flax_params,
    param_layouts,
)
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.train import Randomness, train
from disentagled_multimodal_fusion_tpu_torch.parallel.mesh import (
    Mesh,
    ShardPlan,
    make_mesh,
    param_sharding_rule,
    shard_params,
)

HW = (240, 76, 216, 47, 64, 6)  # HandWritten's view widths
KEY = jax.random.PRNGKey(0)


def _luma(use_2d, out=200):
    return ((jlayers.AudioEncoder(input_dim=40, output_dim=out, dropout=0.1, use_2d=use_2d),
             jlayers.TextEncoder(input_dim=128, output_dim=out, dropout=0.1),
             jlayers.ImageEncoder(output_dim=out, dropout=0.1)),
            (("AudioEncoder", dict(input_dim=40, output_dim=out, dropout=0.1, use_2d=use_2d)),
             ("TextEncoder", dict(input_dim=128, output_dim=out, dropout=0.1)),
             ("ImageEncoder", dict(output_dim=out, dropout=0.1))),
            [(40, 21) if use_2d else 40, 128, 3072])


def _filled(tree, seed):
    """The flax tree of shapes ``tree`` with standard-normal values."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


def _jax_params(build):
    """The (params, batch_stats) that ``build(key)`` makes through a JAX
    ``build_*_task``, drawn from normals: it is traced for its shapes only
    (``eval_shape``), not run."""
    params, stats = jax.eval_shape(build, KEY)
    return _filled(params, 1), (_filled(stats, 2) if stats else None)


def _dmvae(fused, dims=HW, hidden=512, embed=200, luma=None):
    kw = dict(output_dim=dims, hidden_dim=hidden, embed_dim=embed, fused_modalities=fused)
    jenc, tenc, shapes = luma or (None, None, None)
    xs = [jnp.zeros((2, *np.atleast_1d(s))) for s in (shapes or dims)]

    def build(key):
        _, params, _, _, stats = jtasks.build_dmvae_task(rng=key, xs_sample=xs,
                                                         feature_encoders=jenc, **kw)
        return params, stats

    return (*_jax_params(build), ttasks.build_dmvae_task(device="cpu", feature_encoders=tenc,
                                                          **kw))


def _dssl():
    kw = dict(output_dim=(24, 16), hidden_dim=512, embed_dim=20)

    def build(key):
        return jtasks.build_disentangledssl_task(rng=key, **kw)[1], None

    return (*_jax_params(build), ttasks.build_disentangledssl_task(device="cpu", **kw)[0])


def _task(kind, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if "feature_encoders" in kw:
        jkw["feature_encoders"], tkw["feature_encoders"] = kw["feature_encoders"]
        tkw.pop("input_dims")

    def build(key):
        jt = getattr(jtasks, f"build_{kind}_task")(rng=key, **jkw)
        return jt.params, jt.model_state

    return (*_jax_params(build),
            getattr(ttasks, f"build_{kind}_task")(device="cpu", **tkw).model)


def _luma_late():
    jenc, tenc, shapes = _luma(True)
    return _task("late_fusion", output_dims=(200,) * 3, num_classes=42, hidden_dim=(128,),
                 feature_encoders=(jenc, tenc), input_dims=shapes)


PROBE = dict(num_modalities=6, num_classes=10, input_dim=200, hidden_dim=(128,))
MODELS = {
    "fused_dmvae": (lambda: _dmvae(True), 512),
    "dmvae": (lambda: _dmvae(False), 512),
    "dssl": (_dssl, 512),
    "probe": (lambda: _task("probe", **PROBE), 128),
    "disentangled_probe": (lambda: _task("disentangled_probe", **PROBE), 128),
    "late_fusion": (lambda: _task("late_fusion", output_dims=HW, num_classes=10,
                                  hidden_dim=(128,)), 128),
    "luma_late_fusion": (_luma_late, 128),
    "luma_fused_dmvae": (lambda: _dmvae(True, (200,) * 3, luma=_luma(False)), 512),
    "intermediate_concat_linear": (lambda: _task(
        "intermediate_fusion", output_dims=HW[:2], num_classes=10, hidden_dim=128,
        fusion="concat_linear", fusion_output_dim=128), 128),
    "intermediate_lft": (lambda: _task(
        "intermediate_fusion", output_dims=(6, 5), num_classes=10, hidden_dim=128,
        fusion="lft"), 2048),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def built(request):
    make, hidden = MODELS[request.param]
    params, stats, port = make()
    load_flax_params(port, params, stats)
    return request.param, params, port, hidden


def test_layouts_and_specs_match_the_jax_rule(built):
    name, params, port, hidden = built
    layouts = param_layouts(port)
    own = dict(port.named_parameters())
    jrule, trule = jmesh.param_sharding_rule(hidden), param_sharding_rule(hidden)
    seen, cut = set(), 0
    for path, leaf in _flatten(params):
        key = _port_key(path)
        j = layouts[key].to_jax(own[key].detach())
        np.testing.assert_array_equal(j.numpy(), np.asarray(leaf), err_msg=key)
        spec = tuple(jrule(jnp.asarray(leaf)))
        assert trule(j.shape) == spec, (key, trule(j.shape), spec)
        seen.add(key)
        cut += "model" in spec
    assert seen == set(own), set(own) ^ seen
    assert cut > 0, f"{name}: the rule cuts nothing at {hidden}"


@pytest.mark.parametrize("n_devices", [2, 4])
def test_blocks_match_the_jax_shards(built, n_devices):
    name, params, port, hidden = built
    mesh = jmesh.make_mesh(n_devices, model_parallel=2)
    sharded = jmesh.shard_params(jax.tree.map(jnp.asarray, params), mesh, hidden)
    state = {k: p.detach() for k, p in port.named_parameters()}
    layouts = param_layouts(port)
    for i in range(n_devices // 2):
        for r in range(2):
            dev = mesh.devices[i, r]
            shard = jax.tree.map(
                lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                          if s.device == dev)), sharded)
            want = flax_to_state_dict(shard)
            got = shard_params(state, Mesh(n_devices // 2, 2, rank=2 * i + r), hidden, layouts)
            assert set(got) == set(want)
            for key, block in got.items():
                np.testing.assert_array_equal(block.numpy(), want[key].numpy(),
                                              err_msg=f"{name} {key} at ({i}, {r})")


def test_the_plan_feeds_blocks_to_the_megatron_layers_and_gathers_the_rest():
    """In the LUMA late fusion at hidden 128: the heads' stacked layers and
    the encoders' Dense layers of 128 inputs (row-parallel) take their
    blocks; the 128-channel convolutions and BatchNorm scales and biases
    are gathered on use."""
    _, _, port = _luma_late()
    names = [k for k, _ in port.named_parameters()]
    plan = ShardPlan(port, names, Mesh(1, 2, rank=1, groups=(None, None)), 128)
    taken = sorted(k for k, c in plan.cuts.items() if c.takes_block)
    gathered = sorted(k for k, c in plan.cuts.items() if not c.takes_block)
    assert taken == ["feat_encs.0.layers.0.weight", "feat_encs.1.layers.0.weight", "stack.b1",
                     "stack.w1", "stack.w2"]
    assert gathered == sorted(f"feat_encs.{e}.blocks.{m}.2.{p}" for e in (0, 2)
                              for m in ("bn", "conv") for p in ("weight", "bias"))
    assert plan.cuts["feat_encs.0.blocks.conv.2.weight"].axis == 3  # flax (3, 3, 64, 128)
    w1 = dict(port.named_parameters())["stack.w1"].detach()
    np.testing.assert_array_equal(plan.block("stack.w1", w1).numpy(), w1[..., 64:].numpy())


def test_an_undivided_hidden_width_raises_in_both_packages():
    params, _ = _jax_params(lambda key: (jtasks.build_probe_task(
        rng=key, num_modalities=2, num_classes=3, input_dim=4, hidden_dim=(7,)).params, None))
    with pytest.raises(ValueError, match="divisible by 2"):
        jmesh.shard_params(jax.tree.map(jnp.asarray, params),
                           jmesh.make_mesh(2, model_parallel=2), 7)
    task = ttasks.build_probe_task(num_modalities=2, num_classes=3, input_dim=4,
                                   hidden_dim=(7,), device="cpu")
    names = [k for k, _ in task.model.named_parameters()]
    with pytest.raises(ValueError, match="hidden width 7"):
        ShardPlan(task.model, names, Mesh(1, 2, groups=(None, None)), 7)
    with pytest.raises(ValueError, match="hidden width 7"):
        shard_params(dict(task.model.named_parameters()), Mesh(1, 2), 7)


def test_a_model_axis_needs_its_groups():
    mesh = Mesh(2, 2, rank=3)
    assert (mesh.data_index, mesh.model_index, mesh.size) == (1, 1, 4)
    with pytest.raises(RuntimeError, match="build it with make_mesh"):
        mesh.model_group
    assert Mesh(3).data_group is None and Mesh(3).model_group is None
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(4, model_parallel=2)


def test_a_mesh_without_a_model_cut_trains_as_before():
    """``tp_hidden_dim`` without a mesh, or on a mesh without a model axis,
    changes nothing: the fit is bit for bit the plain one."""
    fits = []
    for mesh, tp in ((None, None), (None, 8), (Mesh(1), 8)):
        task = ttasks.build_probe_task(num_modalities=2, num_classes=3, input_dim=4,
                                       hidden_dim=(8,), dropout=0.3, seed=1, device="cpu")
        rng = np.random.default_rng(0)
        data = {"zc": torch.from_numpy(rng.standard_normal((20, 4)).astype(np.float32)),
                "zp": torch.from_numpy(rng.standard_normal((20, 2, 4)).astype(np.float32)),
                "y": torch.from_numpy(rng.integers(0, 3, 20))}
        res = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=20,
                    optimizer=task.optimizer, epochs=2, batch_size=8,
                    randomness=Randomness(2, "cpu"), mesh=mesh, tp_hidden_dim=tp)
        fits.append((res.train_loss, task.model.stack.w1.detach().numpy().copy()))
    for loss, w1 in fits[1:]:
        np.testing.assert_array_equal(loss, fits[0][0])
        np.testing.assert_array_equal(w1, fits[0][1])
