"""The port's LUMA protocol against the JAX package's, on the CPU.

* The compiled-corpus loader: ``get_luma_arrays`` and ``get_luma_ood_arrays``
  of both packages on one fixture corpus (``make_fake_luma(n_classes=3,
  train_per_class=4, test_per_class=2, ood_classes=1)``), in one process
  (the hash text features are salted per process), with ``cache=False`` on
  both sides: bitwise equal, by default, with ``replicate_image_bug``,
  ``use_ood`` and ``use_2d``, and with the port reading the ``.npz`` image
  table and its metadata without pandas and PyYAML. The fixtures' files, the
  flat metadata reader and the feature cache's name are held to the JAX
  package's too. Network access is refused for the whole file (the JAX
  tokenizer probes a host first).
* The port's numpy MFCC against its native featurizer, at the tolerances
  of the JAX package's tests/test_data.py:134-150.
* Each encoder (Image; Audio 1-D and 2-D; Text) on ``convert.py``-carried
  weights, in eval mode and in train mode with the JAX dropout masks fed
  in: outputs and the new BatchNorm running statistics at rtol 1e-5 /
  atol 1e-6 (rtol 1e-4 / atol 1e-5 on the image encoder's output, whose
  three CPU convolutions sum in another order than XLA's; its statistics
  keep the tighter bound). The init laws: every tensor inside U(+-1 /
  sqrt(fan_in)); the std of every tensor of 4096 entries or more within 5 %
  of the JAX one's, of the smaller ones within 20 % of the law's, the JAX
  package's own check (tests/test_models.py:388).
* FusedDMVAE and the per-modality DMVAE over the encoders: loss, every aux
  term and every gradient at rtol 1e-4 / atol 1e-5, the JAX noise and masks
  fed in, and the running statistics after the step.
* FusedLateFusion and IntermediateFusion over the encoders: one stateful
  training step (loss, gradients, new statistics) at rtol 1e-4 / atol
  1e-5, then validation and evidences on the new statistics; a late-fusion
  fit of two epochs with a ragged tail against JAX ``train`` with its
  draws replayed at LUMA's learning rate (losses rtol 2e-5 / atol 2e-6,
  parameters and statistics rtol 5e-3 / atol 5e-5, the epoch-kernel
  tests' bounds; a convolution's bias, whose true gradient is 0 under the
  BatchNorm after it, within two learning rates per step).
* ``evaluate_ood``: the same AUROCs from the same evidence (ties included).
* ``LUMA_CONFIG`` equals ``configs/luma_config.yaml``.
* ``runners/run_luma.py`` on the CPU (one epoch each, ``--ood-eval
  --include-intermediate --rows-file``): rows, reports, checkpoints, its
  resume, and ``runners/evaluate.py --dataset LUMA`` reproducing its rows
  from the checkpoints (BatchNorm statistics included).
"""

import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu.core.train import StepInfo
from disentagled_multimodal_fusion_tpu.core.train import train as jax_train
from disentagled_multimodal_fusion_tpu.data import luma as jluma
from disentagled_multimodal_fusion_tpu.eval import ood as jood
from disentagled_multimodal_fusion_tpu.models import dmvae as jdmvae
from disentagled_multimodal_fusion_tpu.models import dmvae_fused as jfused
from disentagled_multimodal_fusion_tpu.models import layers as jlayers
from disentagled_multimodal_fusion_tpu_torch.configs.config import LUMA_CONFIG
from disentagled_multimodal_fusion_tpu_torch.convert import flax_to_state_dict, load_flax_params
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.train import train
from disentagled_multimodal_fusion_tpu_torch.data import luma as tluma
from disentagled_multimodal_fusion_tpu_torch.eval import ood as tood
from disentagled_multimodal_fusion_tpu_torch.models import dmvae as tdmvae
from disentagled_multimodal_fusion_tpu_torch.models import dmvae_fused as tfused
from disentagled_multimodal_fusion_tpu_torch.models import layers as tlayers

ENC_TOL = dict(rtol=1e-5, atol=1e-6)
CONV_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
STATE_TOL = dict(rtol=5e-3, atol=5e-5)
FOLD = 0x5CA1AB1E  # JAX core/train.py folds the fit's key with it
FIXTURE = dict(n_classes=3, train_per_class=4, test_per_class=2, ood_classes=1)


@pytest.fixture(autouse=True, scope="module")
def offline_and_one_thread():
    """No network (the JAX tokenizer opens a socket to its hub first; this
    makes it fail at once) and one torch thread (the suite runs these files
    beside other test processes)."""
    real = socket.create_connection

    def refuse(*args, **kwargs):
        raise OSError("network access is refused in the tests")

    socket.create_connection = refuse
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    socket.create_connection = real
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return tluma.make_fake_luma(str(tmp_path_factory.mktemp("luma") / "corpus"), **FIXTURE)


def _record(names, fn):
    """Run fn with the named jax.random functions recorded, in call order:
    (fn's result, [(name, draw)])."""
    draws, origs = [], {n: getattr(jax.random, n) for n in names}

    def spy(name):
        def wrapped(*a, **k):
            out = origs[name](*a, **k)
            draws.append((name, out))
            return out
        return wrapped

    for n in names:
        setattr(jax.random, n, spy(n))
    try:
        return fn(), draws
    finally:
        for n, f in origs.items():
            setattr(jax.random, n, f)


def jitted_draws(fn, names=("bernoulli", "normal")):
    """``fn`` under jit with its jax.random draws recorded: ``(run, kinds)``,
    ``run(*args) -> (fn(*args), [draw])``, ``kinds`` the draws' names."""
    kinds = []

    def traced(*args):
        out, rec = _record(names, lambda: fn(*args))
        kinds[:] = [name for name, _ in rec]
        return out, [d for _, d in rec]

    return jax.jit(traced), kinds


def port_mask(m):
    """A flax keep-mask in the port's layout: channel dropout's (B, 1, 1, C)
    becomes (B, C, 1, 1)."""
    m = np.asarray(m)
    return torch.from_numpy(np.ascontiguousarray(m.transpose(0, 3, 1, 2) if m.ndim == 4 else m))


def split_draws(kinds, rec):
    masks = [port_mask(d) for n, d in zip(kinds, rec) if n == "bernoulli"]
    normals = [torch.from_numpy(np.array(d)) for n, d in zip(kinds, rec) if n == "normal"]
    return masks, normals


class Replay:
    """The port's Randomness interface over one fit's recorded JAX draws."""

    def __init__(self, perms, masks=(), normals=()):
        self.perms, self.masks, self.normals = list(perms), list(masks), list(normals)

    def permutation(self, n):
        p = self.perms.pop(0)
        assert p.shape == (n,)
        return torch.from_numpy(p.astype(np.int64))

    def bernoulli(self, p, shape):
        m = self.masks.pop(0)
        assert tuple(m.shape) == tuple(shape), (m.shape, shape)
        return m

    def normal(self, shape):
        z = self.normals.pop(0)
        assert tuple(z.shape) == tuple(shape), (z.shape, shape)
        return z


def assert_state(port_module, ref_tree, tol, names=None):
    """Every entry of the port's state dict (or of ``names``) against the
    flax tree carried over by ``convert.py``."""
    ref = flax_to_state_dict(*ref_tree) if isinstance(ref_tree, tuple) else ref_tree
    got = port_module.state_dict()
    for name in names or got:
        np.testing.assert_allclose(got[name].detach().numpy(), ref[name].numpy(), err_msg=name,
                                   **tol)


# ------------------------------------------------------------------ loader
def test_fixture_files_match_the_jax_fixture(corpus, tmp_path):
    ref = jluma.make_fake_luma(str(tmp_path / "jax"), **FIXTURE)
    for name in ("audio_datalist.csv", "text_data.tsv", "metadata.yaml"):
        assert (tmp_path / "jax" / name).read_bytes() == open(f"{corpus}/{name}", "rb").read()
    import pandas as pd

    jdf, tdf = pd.read_pickle(f"{ref}/edm_images.pickle"), pd.read_pickle(f"{corpus}/edm_images.pickle")
    z = np.load(f"{corpus}/edm_images.npz")
    assert list(jdf["label"]) == list(tdf["label"]) == [str(x) for x in z["label"]]
    assert np.array_equal(np.stack(jdf["image"]), z["image"]) and z["image"].dtype == np.uint8
    assert np.array_equal(np.stack(jdf["image"]), np.stack(tdf["image"]))


def _same_arrays(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, tuple):
            _same_arrays(g, r)
        elif isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape and np.array_equal(g, r)
        else:
            assert g == r


def _hide(monkeypatch, *modules):
    for name in modules:
        monkeypatch.setitem(sys.modules, name, None)


LOADER_CASES = {
    "default": ({}, False),
    "replicate_image_bug": ({"replicate_image_bug": True}, False),
    "use_ood": ({"use_ood": True}, False),
    "use_2d": ({"audio_config": {"sample_rate": 16000, "max_length": 3.0, "n_mfcc": 40,
                                 "use_mfcc": True, "use_2d": True}}, False),
    "npz_without_pandas_or_yaml": ({}, True),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_get_luma_arrays_matches_jax_bitwise(corpus, monkeypatch, case):
    kw, hide = LOADER_CASES[case]
    ref = jluma.get_luma_arrays(corpus, cache=False, **kw)
    if hide:
        _hide(monkeypatch, "pandas", "yaml")
    got = tluma.get_luma_arrays(corpus, cache=False, **kw)
    _same_arrays(got, ref)
    assert got[4] == 3 + (1 if case == "use_ood" else 0)
    if case == "use_2d":
        assert got[0][0].shape[1:] == (40, 241)


@pytest.mark.parametrize("hide", [False, True], ids=["pickle", "npz_without_pandas_or_yaml"])
def test_get_luma_ood_arrays_matches_jax_bitwise(corpus, monkeypatch, hide):
    ref = jluma.get_luma_ood_arrays(corpus, cache=False)
    if hide:
        _hide(monkeypatch, "pandas", "yaml")
    got = tluma.get_luma_ood_arrays(corpus, cache=False)
    _same_arrays(got, ref)
    assert len(got[1]) == 2 and (got[1] >= got[2]).all()


def test_flat_metadata_reader_reads_what_pyyaml_reads(corpus):
    text = open(f"{corpus}/metadata.yaml").read()
    assert tluma.parse_block_yaml(text) == yaml.safe_load(text)
    meta = {"num_classes": 42, "ood_classes": ["a b", "it's", "1x"], "ratio": 0.5,
            "flag": True, "name": "bert-base-uncased", "none": None, "empty": []}
    dumped = yaml.safe_dump(meta)
    assert tluma.parse_block_yaml(dumped) == yaml.safe_load(dumped) == meta


def test_feature_cache_has_the_jax_name_and_is_reused(corpus, tmp_path):
    import shutil

    root = shutil.copytree(corpus, tmp_path / "c")
    ref = jluma.LUMADataset(str(root), "test").featurize()
    written = sorted(p.name for p in root.glob("features_*.npz"))
    assert len(written) == 1
    ds = tluma.LUMADataset(str(root), "test")
    assert ds.cache_file().name == written[0]
    _same_arrays(ds.featurize(), ref)  # read from the JAX package's cache
    (root / written[0]).unlink()
    _same_arrays(tluma.LUMADataset(str(root), "test").featurize(), ref)
    assert sorted(p.name for p in root.glob("features_*.npz")) == written


def test_numpy_mfcc_matches_the_native_featurizer(tmp_path):
    import wave

    from disentagled_multimodal_fusion_tpu_torch.data import native_featurizer as nf
    from disentagled_multimodal_fusion_tpu_torch.data.audio import mfcc, wav_to_mfcc_mean

    rng = np.random.default_rng(0)
    mono = (rng.standard_normal(24000) * 0.1).astype(np.float32)
    assert nf.available(), "g++ builds the native featurizer on this machine"
    np.testing.assert_allclose(nf.mfcc_mean_native(mono), mfcc(mono).mean(axis=1), atol=1e-4)
    path = tmp_path / "t.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes((rng.standard_normal((22050, 2)) * 3000).astype("<i2").tobytes())
    feats = nf.featurize_wav_files([str(path)])
    assert feats.shape == (1, 40)
    np.testing.assert_allclose(feats[0], wav_to_mfcc_mean(str(path)), atol=5e-3)
    assert nf.library_path().parent.name == "_build"


# ---------------------------------------------------------------- encoders
B = 6
ENCODERS = {
    "image": (lambda: jlayers.ImageEncoder(output_dim=16, dropout=0.2),
              ("ImageEncoder", dict(output_dim=16, dropout=0.2)), (3072,)),
    "audio_1d": (lambda: jlayers.AudioEncoder(input_dim=40, output_dim=16, dropout=0.2),
                 ("AudioEncoder", dict(input_dim=40, output_dim=16, dropout=0.2)), (40,)),
    "audio_2d": (lambda: jlayers.AudioEncoder(input_dim=40, output_dim=16, dropout=0.2,
                                              use_2d=True),
                 ("AudioEncoder", dict(input_dim=40, output_dim=16, dropout=0.2, use_2d=True)),
                 (40, 21)),
    "text": (lambda: jlayers.TextEncoder(input_dim=128, output_dim=16, dropout=0.2),
             ("TextEncoder", dict(input_dim=128, output_dim=16, dropout=0.2)), (128,)),
}


def _encoder_pair(name, seed=0):
    jmake, (cls, kw), shape = ENCODERS[name]
    jenc = jmake()
    x = np.random.default_rng(seed).standard_normal((B, *shape)).astype(np.float32)
    variables = jenc.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), train=False)
    # running statistics away from their init, so eval mode reads them
    stats = jax.tree.map(lambda a: a + 0.3 * jnp.arange(a.shape[0]) / a.shape[0],
                         variables.get("batch_stats", {}))
    port = tlayers.ENCODER_REGISTRY[cls](torch.Generator().manual_seed(1), **kw)
    load_flax_params(port, jax.device_get(variables["params"]), jax.device_get(stats))
    return jenc, variables["params"], stats, port, x


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_matches_jax(name, train_mode):
    jenc, params, stats, port, x = _encoder_pair(name)
    tol = CONV_TOL if name == "image" else ENC_TOL
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    if not train_mode:
        ref = jax.jit(lambda v, x: jenc.apply(v, x, train=False))(variables, jnp.asarray(x))
        np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                                   **tol)
        return

    def apply(v, x, key):
        return jenc.apply(v, x, train=True, rngs={"dropout": key}, mutable=["batch_stats"])

    run, kinds = jitted_draws(lambda v, x, k: apply(v, x, k))
    (ref, new), rec = run(variables, jnp.asarray(x), jax.random.PRNGKey(7))
    masks, _ = split_draws(kinds, rec)
    assert [tuple(m.shape) for m in masks] == port.drop_shapes(B)
    got = port(torch.from_numpy(x), masks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol)
    if stats:
        ref_stats = flax_to_state_dict({}, jax.device_get(new["batch_stats"]))
        assert_state(port, ref_stats, ENC_TOL, names=sorted(ref_stats))


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_init_law_matches_jax(name):
    jmake, (cls, kw), shape = ENCODERS[name]
    kw = dict(kw, output_dim=200)
    jenc = jmake().clone(output_dim=200)
    params = jenc.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((2, *shape)), train=False)
    ref = flax_to_state_dict(jax.device_get(params["params"]),
                             jax.device_get(params.get("batch_stats", {})))
    port = tlayers.ENCODER_REGISTRY[cls](torch.Generator().manual_seed(3), **kw)
    got = port.state_dict()
    assert set(got) == set(ref)
    for key, value in got.items():
        r = ref[key].numpy()
        v = value.numpy()
        if "bn" in key:  # scale 1, bias 0, mean 0, var 1
            assert np.array_equal(v, r), key
            continue
        fan_in = np.prod(v.shape[1:]) if v.ndim > 1 else None
        if fan_in is not None:
            assert np.abs(v).max() <= 1.0 / np.sqrt(fan_in) + 1e-7, key
        if v.size >= 4096:  # the std of the std's estimate is ~1 % here
            assert abs(v.std() - r.std()) / r.std() < 0.05, (key, v.std(), r.std())
        else:  # the JAX package's own check of small tensors
            expected = (1.0 / np.sqrt(fan_in if fan_in else port_fan_in(port, key))) / np.sqrt(3)
            assert abs(v.std() - expected) / expected < 0.2, (key, v.std(), expected)


def port_fan_in(module, bias_key):
    """A bias's fan_in: that of the weight beside it."""
    weight = module.state_dict()[bias_key[:-len("bias")] + "weight"]
    return int(np.prod(weight.shape[1:]))


# ------------------------------------------------------------------ models
def _luma_views(n, seed, use_2d=False):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((n, 40, 21) if use_2d else (n, 40)).astype(np.float32)
    return (audio, rng.random((n, 128), dtype=np.float32),
            rng.standard_normal((n, 3072)).astype(np.float32))


def _specs(use_2d=False, out=200):
    return (("AudioEncoder", dict(input_dim=40, output_dim=out, dropout=0.1, use_2d=use_2d)),
            ("TextEncoder", dict(input_dim=128, output_dim=out, dropout=0.1)),
            ("ImageEncoder", dict(output_dim=out, dropout=0.1)))


def _jax_encoders(use_2d=False, out=200):
    return (jlayers.AudioEncoder(input_dim=40, output_dim=out, dropout=0.1, use_2d=use_2d),
            jlayers.TextEncoder(input_dim=128, output_dim=out, dropout=0.1),
            jlayers.ImageEncoder(output_dim=out, dropout=0.1))


def _grads_match(port, loss, ref_grads):
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    ref = flax_to_state_dict(jax.device_get(ref_grads))
    assert set(ref) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), err_msg=name, **MODEL_TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dmvae_with_feature_encoders_matches_jax(fused):
    """The ELBO of the DMVAE over the LUMA encoders (the reconstruction
    target is the encoders' output, differentiated on both sides)."""
    dims, hidden, embed = (24, 24, 24), 32, 6
    xs = _luma_views(B, 0)
    mask = np.ones(B, np.float32)
    mask[-1] = 0.0
    kw = dict(x_dims=dims, hidden_dim=hidden, embed_dim=embed, a=0.3)
    jmodel = (jfused.FusedDMVAE if fused else jdmvae.DMVAE)(
        **kw, feature_encoders=_jax_encoders(out=24))
    jxs = [jnp.asarray(x) for x in xs]
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
                             "dropout": jax.random.PRNGKey(1)}, jxs, train=True)
    params, stats = variables["params"], variables["batch_stats"]
    keys = jax.random.split(jax.random.PRNGKey(5))

    def jloss(p):
        (loss, logs), new = jmodel.apply(
            {"params": p, "batch_stats": stats}, jxs, train=True, mask=jnp.asarray(mask),
            rngs={"noise": keys[0], "dropout": keys[1]}, mutable=["batch_stats"])
        return loss, (logs, new["batch_stats"])

    run, kinds = jitted_draws(jax.value_and_grad(jloss, has_aux=True))
    ((ref, (ref_logs, ref_stats)), ref_grads), rec = run(params)
    masks, normals = split_draws(kinds, rec)
    cls = tfused.FusedDMVAE if fused else tdmvae.DMVAE
    kw.pop("x_dims")
    port = load_flax_params(cls(dims, torch.Generator().manual_seed(3), **kw,
                                feature_encoders=_specs(out=24)),
                            jax.device_get(params), jax.device_get(stats))
    if fused:
        noise = tuple(normals)
    else:  # the JAX DMVAE draws per modality: N private, N unimodal, one PoE
        noise = (torch.stack(normals[:3], dim=1), torch.stack(normals[3:6], dim=1), normals[6])
    shapes = port.enc_drop_shapes(B)
    assert [tuple(m.shape) for m in masks] == [s for enc in shapes for s in enc]
    enc_masks, i = [], 0
    for enc in shapes:
        enc_masks.append(masks[i:i + len(enc)])
        i += len(enc)
    loss, logs = port([torch.from_numpy(x) for x in xs], noise, torch.from_numpy(mask), None,
                      enc_masks)
    for k, v in logs.items():
        np.testing.assert_allclose(float(v), float(ref_logs[k]), err_msg=k, **MODEL_TOL)
    _grads_match(port, loss, ref_grads)
    ref_state = flax_to_state_dict({}, jax.device_get(ref_stats))
    assert_state(port, ref_state, ENC_TOL, names=sorted(ref_state))
    # the objective draws the encoders' masks before the model's own
    objective, _ = ttasks.dmvae_objective(port)
    draws = objective.draw(Replay([], masks, list(noise)), B)
    assert len(draws) == 3 + len(masks)


def _late_tasks(kind, classes=4, use_2d=False, lr=LUMA_CONFIG["optim"]["luma_lr"]):
    specs = _specs(use_2d, out=24)
    input_dims = [(40, 21) if use_2d else 40, 128, 3072]
    if kind == "late":
        kw = dict(output_dims=[24] * 3, num_classes=classes, hidden_dim=(8,), dropout=0.2,
                  lr=lr, annealing_start=1, aggregation="cml")
        jtask = jtasks.build_late_fusion_task(rng=jax.random.PRNGKey(0), input_dims=input_dims,
                                              feature_encoders=_jax_encoders(use_2d, 24), **kw)
        ttask = ttasks.build_late_fusion_task(device="cpu", feature_encoders=specs, **kw)
    else:
        kw = dict(output_dims=[24] * 3, num_classes=classes, hidden_dim=8, dropout=0.2, lr=lr,
                  annealing_start=1, fusion="concat")
        jtask = jtasks.build_intermediate_fusion_task(
            rng=jax.random.PRNGKey(0), input_dims=input_dims,
            feature_encoders=_jax_encoders(use_2d, 24), **kw)
        ttask = ttasks.build_intermediate_fusion_task(device="cpu", feature_encoders=specs, **kw)
    load_flax_params(ttask.model, jax.device_get(jtask.params),
                     jax.device_get(jtask.model_state))
    return jtask, ttask


def _data(n, seed, classes=4, use_2d=False):
    xs = _luma_views(n, seed, use_2d)
    y = np.random.default_rng(seed + 1).integers(0, classes, n)
    return ({"xs": tuple(jnp.asarray(x) for x in xs), "y": jnp.asarray(y)},
            {"xs": tuple(torch.from_numpy(x) for x in xs), "y": torch.from_numpy(y)})


@pytest.mark.parametrize("kind,use_2d", [("late", False), ("late", True),
                                         ("intermediate", False)])
def test_fusion_with_encoders_step_validation_and_evidences_match_jax(kind, use_2d):
    """One stateful training step (loss, gradients, new BatchNorm
    statistics), then validation and the evidences on those statistics."""
    jtask, ttask = _late_tasks(kind, use_2d=use_2d)
    jdata, tdata = _data(B, 3, use_2d=use_2d)
    mask = jnp.ones(B).at[-1].set(0.0)
    key = jax.random.PRNGKey(4)

    def jloss(p):
        return jtask.loss_fn(p, jdata, mask, StepInfo(1, 0), key, jtask.model_state)

    run, kinds = jitted_draws(jax.value_and_grad(jloss, has_aux=True))
    ((ref_loss, ref_state), ref_grads), rec = run(jtask.params)
    masks, _ = split_draws(kinds, rec)
    loss, _ = ttask.loss_fn.compute(tdata, torch.from_numpy(np.array(mask)), 1, masks)
    np.testing.assert_allclose(loss.item(), float(ref_loss), **MODEL_TOL)
    _grads_match(ttask.model, loss, ref_grads)
    stats = flax_to_state_dict({}, jax.device_get(ref_state))
    assert_state(ttask.model, stats, ENC_TOL, names=sorted(stats))

    vdata_j, vdata_t = _data(5, 8, use_2d=use_2d)
    ref_val = jtask.val_fn(jtask.params, ref_state, vdata_j, StepInfo(1, 1))
    with torch.no_grad():
        val = ttask.val_fn(vdata_t, 1)
    np.testing.assert_allclose(float(val[0]), float(ref_val[0]), **MODEL_TOL)
    assert float(val[1]) == float(ref_val[1])
    ref_ev = jtask.evidences_fn(jtask.params, vdata_j, ref_state)
    with torch.no_grad():
        ev = ttask.evidences_fn(vdata_t)
    np.testing.assert_allclose(ev.numpy(), np.asarray(ref_ev), **MODEL_TOL)


def _jax_fit_draws(task, n, batch, epochs, key, data):
    """The permutations and per-step masks of a JAX ``train`` of a stateful
    task from ``key`` (its draws recorded while each step shape is traced)."""
    sizes = [batch] * (n // batch) + ([n % batch] if n % batch else [])
    runs = {}
    for rows in set(sizes):
        part = jax.tree.map(lambda a: a[:rows], data)
        runs[rows] = jitted_draws(lambda k, part=part, rows=rows: task.loss_fn(
            task.params, part, jnp.ones(rows), StepInfo(0, 0), k, task.model_state)[0])
    key = jax.random.fold_in(key, FOLD)
    perms, masks = [], []
    for _ in range(epochs):
        key, k_perm, k_steps = jax.random.split(key, 3)
        perms.append(np.asarray(jax.random.permutation(k_perm, n)))
        for k, rows in zip(jax.random.split(k_steps, len(sizes)), sizes):
            run, kinds = runs[rows]
            _, draws = run(k)
            masks += split_draws(kinds, draws)[0]
    return perms, masks


def test_late_fusion_fit_with_encoders_matches_jax_with_replayed_draws():
    """Two epochs of 11 rows in batches of 4 (a ragged tail of 3, whose
    BatchNorm statistics are its own three rows'), Adam + plateau at LUMA's
    learning rate, validation after each epoch. A convolution's bias feeds
    a BatchNorm, which subtracts it again in training: its true gradient is
    0, and both packages' gradients are rounding noise that Adam turns into
    steps of up to the learning rate of either sign. So those biases are
    held to lie within two learning rates per step of JAX's, and every
    other parameter and statistic at the bounds above."""
    jtask, ttask = _late_tasks("late")
    jdata, tdata = _data(11, 5)
    jval, tval = _data(5, 9)
    key = jax.random.PRNGKey(11)
    perms, masks = _jax_fit_draws(jtask, 11, 4, 2, key, jdata)
    ref = jax_train(rng=key, params=jtask.params, loss_fn=jtask.loss_fn, data=jdata, n_train=11,
                    optimizer=jtask.optimizer, epochs=2, batch_size=4, val_fn=jtask.val_fn,
                    val_data=jval, model_state=jtask.model_state, donate=False)
    res = train(model=ttask.model, loss_fn=ttask.loss_fn, data=tdata, n_train=11,
                optimizer=ttask.optimizer, epochs=2, batch_size=4,
                randomness=Replay(perms, masks), val_fn=ttask.val_fn, val_data=tval)
    np.testing.assert_allclose(res.train_loss, np.asarray(ref.train_loss), **LOSS_TOL)
    np.testing.assert_allclose(res.val_loss, np.asarray(ref.val_loss), **LOSS_TOL)
    np.testing.assert_array_equal(res.val_acc, np.asarray(ref.val_acc))
    want = flax_to_state_dict(jax.device_get(ref.params), jax.device_get(ref.model_state))
    free = sorted(k for k in want if ".conv." in k and k.endswith(".bias"))
    assert len(free) == 3  # the image encoder's three convolutions
    assert_state(ttask.model, want, STATE_TOL, names=sorted(set(want) - set(free)))
    got, lr = ttask.model.state_dict(), ttask.optimizer.lr
    for k in free:
        assert np.abs(got[k].numpy() - want[k].numpy()).max() <= 2 * lr * 6, k


# --------------------------------------------------------------------- OOD
def test_evaluate_ood_matches_jax():
    rng = np.random.default_rng(0)
    ev_id = np.exp(rng.standard_normal((40, 5)) * 2).astype(np.float32)
    ev_ood = np.exp(rng.standard_normal((12, 5))).astype(np.float32)
    ev_ood[:3] = ev_id[:3]  # ties across the two sides
    got = tood.evaluate_ood(torch.from_numpy(ev_id), torch.from_numpy(ev_ood), 5)
    ref = jood.evaluate_ood(ev_id, ev_ood, 5)
    assert got == ref
    assert set(got) == {"auroc_epistemic", "auroc_aleatoric", "auroc_neg_evidence"}
    assert np.isnan(tood.auroc(np.array([]), np.array([1.0])))
    assert tood.auroc(np.array([1.0, 2.0]), np.array([1.0, 0.0])) == 0.875


def test_luma_modules_import_no_pandas_yaml_or_jax():
    """The card's machine has neither pandas nor PyYAML: the port's LUMA
    modules import neither (nor JAX) at module level."""
    import subprocess
    from pathlib import Path

    script = """
import sys
for name in ("data.luma", "data.audio", "data.wordpiece", "data.native_featurizer",
             "eval.ood", "runners.run_luma", "runners.test_luma", "runners.evaluate",
             "runners.compile_luma"):
    __import__("disentagled_multimodal_fusion_tpu_torch." + name)
banned = ("pandas", "yaml", "jax", "flax", "transformers", "disentagled_multimodal_fusion_tpu")
loaded = [m for m in sys.modules if m.split(".")[0] in banned]
assert not loaded, loaded
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parent.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_luma_config_equals_the_yaml():
    from pathlib import Path

    import disentagled_multimodal_fusion_tpu

    path = Path(disentagled_multimodal_fusion_tpu.__file__).parent / "configs" / "luma_config.yaml"
    assert yaml.safe_load(path.read_text()) == LUMA_CONFIG


# ------------------------------------------------------------------ runner
@pytest.fixture(scope="module")
def luma_run(corpus, tmp_path_factory):
    import io
    from contextlib import redirect_stdout

    from disentagled_multimodal_fusion_tpu_torch.runners import run_luma

    root = tmp_path_factory.mktemp("luma_run")
    mp = pytest.MonkeyPatch()
    mp.setenv("DMF_ARTIFACT_ROOT", str(root))
    argv = ["--data-path", corpus, "--seeds", "0", "--ood-eval", "--include-intermediate",
            "--dmvae-epochs", "1", "--probe-epochs", "1", "--rows-file",
            str(root / "rows.json"), "--device", "cpu"]
    out = io.StringIO()
    with redirect_stdout(out):
        rows = run_luma.main(argv)
    yield root, rows, out.getvalue(), argv
    mp.undo()


def test_run_luma_writes_rows_reports_and_checkpoints(luma_run):
    import json

    root, rows, out, _ = luma_run
    models = rows[0]["Normal"]["LUMA"]
    assert sorted(models) == sorted(["dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion",
                                     "cml_fusion", "avg_fusion", "intermediate_fusion"])
    for name, info in models.items():
        assert np.isfinite(info["fused"]["accuracy"]), name
        assert all(0.0 <= v <= 1.0 for v in info["ood"].values()), name
        assert (root / "checkpoints" / f"{name}_fusion_dsLUMA_seed0.pt").exists()
    assert (root / "checkpoints" / "dmvae_datasetLUMA_seed0_a1e-05_normal.pt").exists()
    assert (root / "logs" / "luma_analysis.xlsx").exists()
    ood = json.loads((root / "logs" / "luma_ood.json").read_text())
    assert set(ood["mean"]) == set(models) and ood["per_seed"]["cml_fusion"] == [
        models["cml_fusion"]["ood"]]
    assert "OOD eval: 2 held-out rows from 1 OOD classes" in out
    assert "LUMA: 12 train / 6 test, 3 classes, dims [40, 128, 3072]" in out


def test_run_luma_resumes_from_its_rows_file(luma_run, monkeypatch):
    import io
    from contextlib import redirect_stdout

    from disentagled_multimodal_fusion_tpu_torch.runners import run_luma

    root, rows, _, argv = luma_run
    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(root))
    monkeypatch.setattr(run_luma, "run_seed", lambda **kw: pytest.fail("the resume trained"))
    out = io.StringIO()
    with redirect_stdout(out):
        again = run_luma.main(argv)
    assert "--rows-file: resuming; 1 completed seed(s) found [0]" in out.getvalue()
    assert "[seed 0] already complete (--rows-file), skipping" in out.getvalue()
    assert again[0] == rows[0]


@pytest.mark.parametrize("model", ["dmvae_cml", "dmvae_dis", "cml_fusion"])
def test_evaluate_luma_reproduces_the_runs_rows(luma_run, monkeypatch, model):
    """The checkpoints (BatchNorm statistics included) give the run's
    evaluation back."""
    from disentagled_multimodal_fusion_tpu_torch.runners import evaluate

    root, rows, _, argv = luma_run
    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(root))
    args = evaluate.parse_args(["--model", model, "--dataset", "LUMA", "--seed", "0",
                                "--data-path", argv[1], "--device", "cpu"])
    info = evaluate.eval_luma(args, torch.device("cpu"))
    ref = {k: v for k, v in rows[0]["Normal"]["LUMA"][model].items()
           if k not in ("ood", "path", "fit_seconds")}
    assert info == ref


def test_run_luma_runs_on_the_card_unless_asked_for_the_cpu(corpus):
    from disentagled_multimodal_fusion_tpu_torch.runners import run_luma

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_luma.main(["--data-path", corpus, "--seeds", "0"])
