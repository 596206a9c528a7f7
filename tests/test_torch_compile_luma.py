"""The port's LUMA compiler (runners/compile_luma.py) against the JAX
package's, offline (network refused for the whole file).

* tests/test_compile_luma.py's three tests on the port: the offline skip of
  the clone, the upstream ``compile_dataset.py`` run as a subprocess with
  ``-c <config>`` (and the fallback when it fails or is missing), and
  ``main`` preferring the upstream compile, then falling back to the
  simplified layout.
* On a raw layout cut from the fixture corpus: the port's compile config
  reads back (through PyYAML and through the port's own reader) equal to
  what PyYAML reads from the JAX package's, and ``main`` builds the
  simplified layout with the same files and bytes.
* On the compiled fixture corpus: ``main`` featurizes both splits into
  ``data.luma``'s feature cache, the arrays bitwise equal to the JAX
  package's features (in one process: the text features hash with Python's
  salted ``hash``), and ``run_luma``'s loader reads them from the cache
  without featurizing again.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml
from test_torch_luma import FIXTURE, offline_and_one_thread  # noqa: F401 (autouse fixture)

from disentagled_multimodal_fusion_tpu.runners import compile_luma as jcl
from disentagled_multimodal_fusion_tpu_torch.data import luma as tluma
from disentagled_multimodal_fusion_tpu_torch.runners import compile_luma as cl


def _make_raw(tmp_path: Path) -> Path:
    raw = tmp_path / "raw"
    (raw / "audio").mkdir(parents=True)
    (raw / "audio" / "datalist.csv").write_text("filepath,label\n")
    (raw / "text_data.tsv").write_text("text\tlabel\n")
    (raw / "edm_images.pickle").write_bytes(b"\x80\x04N.")  # pickled None
    return raw


def test_offline_skips_network_steps(capsys):
    assert cl.check_luma_repo(online=False, repo_dir=Path("/nonexistent/LUMA")) is None
    out = capsys.readouterr().out
    assert "[skip]" in out and "no network" in out
    assert not cl.has_network()  # refused here: every network step is skipped


def test_upstream_subprocess_path(tmp_path):
    repo = tmp_path / "LUMA"
    repo.mkdir()
    marker = tmp_path / "marker.json"
    (repo / "compile_dataset.py").write_text(
        "import json, sys\n"
        "cfg = sys.argv[sys.argv.index('-c') + 1]\n"
        f"json.dump({{'cfg': cfg, 'argv': sys.argv[1:]}}, open({str(marker)!r}, 'w'))\n"
    )
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("data_path: x\n")
    assert cl.run_upstream_compile(repo, cfg)
    assert json.loads(marker.read_text())["cfg"] == str(cfg.resolve())
    (repo / "compile_dataset.py").write_text("import sys; sys.exit(3)\n")
    assert not cl.run_upstream_compile(repo, cfg)
    assert not cl.run_upstream_compile(tmp_path / "empty", cfg)


def test_main_upstream_then_fallback(tmp_path, capsys):
    raw = _make_raw(tmp_path)
    out_dir = tmp_path / "compiled"
    repo = tmp_path / "LUMA"
    repo.mkdir()
    touched = tmp_path / "touched"
    (repo / "compile_dataset.py").write_text(f"open({str(touched)!r}, 'w').write('ran')\n")
    argv = ["--raw-dir", str(raw), "--out-dir", str(out_dir), "--config-out",
            str(tmp_path / "cfg.yaml"), "--offline", "--luma-repo", str(repo), "--skip-featurize"]
    assert cl.main(argv) == 0
    assert touched.read_text() == "ran"
    assert "upstream compile_dataset.py succeeded" in capsys.readouterr().out
    assert not (out_dir / "metadata.yaml").exists()

    (repo / "compile_dataset.py").write_text("import sys; sys.exit(9)\n")
    assert cl.main(argv) == 0
    assert (out_dir / "metadata.yaml").exists()
    assert (out_dir / "audio_datalist.csv").exists()


@pytest.fixture(scope="module")
def fixture_corpus(tmp_path_factory):
    return Path(tluma.make_fake_luma(str(tmp_path_factory.mktemp("luma") / "corpus"), **FIXTURE))


def _raw_from(corpus: Path, raw: Path) -> Path:
    """The raw download's layout, cut from a compiled fixture corpus."""
    shutil.copytree(corpus / "audio", raw / "audio")
    shutil.copy(corpus / "audio_datalist.csv", raw / "audio" / "datalist.csv")
    for name in ("text_data.tsv", "edm_images.pickle"):
        shutil.copy(corpus / name, raw / name)
    return raw


def _tree(root: Path) -> dict:
    """Every file under root (following the audio link) -> its bytes."""
    import os

    return {str(Path(d, f).relative_to(root)): Path(d, f).read_bytes()
            for d, _, files in os.walk(root, followlinks=True) for f in files}


def test_config_and_simplified_layout_match_jax(fixture_corpus, tmp_path):
    raw = _raw_from(fixture_corpus, tmp_path / "raw")
    runs = {}
    for name, module in (("jax", jcl), ("port", cl)):
        out_dir, cfg = tmp_path / f"{name}_out", tmp_path / f"{name}_cfg.yaml"
        assert module.main(["--raw-dir", str(raw), "--out-dir", str(out_dir), "--config-out",
                            str(cfg), "--offline", "--luma-repo", str(tmp_path / "no_repo"),
                            "--skip-featurize"]) == 0
        runs[name] = (out_dir, cfg)
    (jout, jcfg), (tout, tcfg) = runs["jax"], runs["port"]
    want = yaml.safe_load(jcfg.read_text())
    assert want["output_path"] == str(jout) and want["audio"]["diversity"] == {"compactness": 0}
    got = yaml.safe_load(tcfg.read_text())
    assert got == cl.compile_config(raw, tout) == tluma.parse_block_yaml(tcfg.read_text())
    got["output_path"] = str(jout)
    assert got == want
    assert (tout / "audio").is_symlink() and (tout / "audio").resolve() == (raw / "audio").resolve()
    tree = _tree(tout)
    assert tree == _tree(jout) and "metadata.yaml" in tree and "audio/datalist.csv" in tree


def test_featurize_matches_jax_bitwise_and_feeds_run_luma(fixture_corpus, tmp_path, monkeypatch,
                                                           capsys):
    from disentagled_multimodal_fusion_tpu_torch.runners import run_luma
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, tdir):
        shutil.copytree(fixture_corpus, d)
        for f in d.glob("features_*.npz"):
            f.unlink()
    argv = ["--raw-dir", str(tmp_path / "no_raw"), "--offline", "--luma-repo",
            str(tmp_path / "no_repo"), "--config-out", str(tmp_path / "cfg.yaml")]
    assert jcl.main(argv + ["--out-dir", str(jdir)]) == 0
    assert cl.main(argv + ["--out-dir", str(tdir)]) == 0
    assert "raw data missing but compiled layout present" in capsys.readouterr().out
    for split in ("train", "test"):
        (jfile,) = jdir.glob(f"features_{split}_*.npz")
        (tfile,) = tdir.glob(f"features_{split}_*.npz")
        jz, tz = np.load(jfile), np.load(tfile)
        assert sorted(jz.files) == sorted(tz.files) == ["audio", "image", "text", "y"]
        for k in jz.files:
            assert jz[k].dtype == tz[k].dtype and np.array_equal(jz[k], tz[k]), (split, k)

    # the protocol's loader finds them: nothing is featurized again
    monkeypatch.setattr(tluma.LUMADataset, "_featurize_audio",
                        lambda self: pytest.fail("featurized again"))
    audio, text, image = run_luma.feature_configs(make_getter(load_config("luma_config.yaml")))
    xs_tr, y_tr, xs_te, y_te, classes, _, _ = tluma.get_luma_arrays(str(tdir), audio, text, image)
    assert classes == FIXTURE["n_classes"]
    assert len(y_tr) == 12 and len(y_te) == 6 and xs_tr[2].shape == (12, 3072)
