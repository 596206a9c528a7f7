"""LUMA preprocessing: from the raw download to the compiled, featurized
corpus ``runners/run_luma.py`` reads.

Counterpart of ``disentagled_multimodal_fusion_tpu/runners/compile_luma.py``
(reference compile_luma.py:1-350), with the same six steps in the same
order: (1) the NLTK wordnet check, (2) the upstream LUMA repository, (3) the
raw data check, (4) the compile config, (5) the compiled layout, through the
upstream ``compile_dataset.py`` when there is one, else the simplified
layout builder, and (6) the offline featurization. The network steps (the
wordnet download, the clone, the upstream compile's own fetches) run only
when a probe of the network succeeds and ``--offline`` is not given;
otherwise each is a presence check with a message.

No PyYAML, pandas or ``transformers`` at module level: the config and the
metadata are written by ``data.luma.dump_yaml`` (the block YAML
``yaml.safe_dump`` writes, which ``data.luma.parse_block_yaml`` reads back),
and ``transformers``' tokenizer is only looked up, from local files, when
featurizing. Featurization goes through ``data.luma``'s feature cache with
``runners/run_luma.py``'s feature settings, so the protocol finds the
features it writes.

Example (no network needed):
  python -m disentagled_multimodal_fusion_tpu_torch.runners.compile_luma \\
      --raw-dir data/luma_raw --out-dir data/luma_compiled --offline
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

from ..data.luma import dump_yaml


def has_network(host: str = "github.com", port: int = 443, timeout: float = 2.0) -> bool:
    """A cheap probe of the network, so the network steps skip at once
    instead of hanging."""
    import socket

    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


def check_nltk_data(online: bool) -> bool:
    """The NLTK wordnet check, with a download when online
    (compile_luma.py:50-69)."""
    try:
        import nltk
    except ImportError:
        print("  [skip] nltk not installed (upstream compile would need it)")
        return False
    try:
        nltk.data.find("corpora/wordnet.zip")
        print("  [ok] NLTK wordnet found")
        return True
    except LookupError:
        if not online:
            print("  [skip] NLTK wordnet missing and no network to download")
            return False
        try:
            nltk.download("wordnet", quiet=True)
            nltk.data.find("corpora/wordnet.zip")
            print("  [ok] downloaded NLTK wordnet")
            return True
        except Exception as e:
            print(f"  [fail] NLTK wordnet download: {e}")
            return False


def check_luma_repo(online: bool, repo_dir: Path = Path("external/LUMA")):
    """The upstream LUMA repository: cloned when online
    (compile_luma.py:72-92), else a presence check. Its path, or None."""
    if repo_dir.exists():
        print(f"  [ok] LUMA repo at {repo_dir}")
        return repo_dir
    if not online:
        print(f"  [skip] LUMA repo absent at {repo_dir} and no network to clone")
        return None
    repo_dir.parent.mkdir(parents=True, exist_ok=True)
    try:
        subprocess.run(
            ["git", "clone", "https://github.com/bezirganyan/LUMA.git", str(repo_dir)],
            check=True, timeout=600,
        )
        print(f"  [ok] cloned LUMA repo to {repo_dir}")
        return repo_dir
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        print(f"  [fail] git clone: {e}")
        return None


def run_upstream_compile(repo_dir: Path, cfg_path: Path) -> bool:
    """The upstream ``compile_dataset.py -c <config>`` in a subprocess
    (compile_luma.py:175-215). False when it is missing or fails: the caller
    then builds the simplified layout."""
    script = repo_dir / "compile_dataset.py"
    if not script.exists():
        print(f"  [skip] {script} not found in the LUMA repo")
        return False
    try:
        subprocess.run(
            [sys.executable, str(script.resolve()), "-c", str(cfg_path.resolve())],
            check=True, cwd=Path.cwd(),
        )
        print("  [ok] upstream compile_dataset.py succeeded")
        return True
    except subprocess.CalledProcessError as e:
        print(f"  [fail] upstream compile: {e}")
        return False


def check_raw_data(raw_dir: Path) -> bool:
    """The raw LUMA download's three files (compile_luma.py:95-119)."""
    needed = {
        "audio datalist": raw_dir / "audio" / "datalist.csv",
        "text tsv": raw_dir / "text_data.tsv",
        "image pickle": raw_dir / "edm_images.pickle",
    }
    ok = True
    for name, p in needed.items():
        if p.exists():
            print(f"  [ok] {name}: {p}")
        else:
            print(f"  [missing] {name}: {p}")
            ok = False
    return ok


def compile_config(raw_dir: Path, out_dir: Path) -> dict:
    """The compile config (schema: compile_luma.py:122-172)."""
    def modality(**paths):
        return {**paths, "sample_noise": {"add_noise_train": False, "add_noise_test": False},
                "label_switch_prob": 0.0, "diversity": {"compactness": 0}}

    return {
        "data_path": str(raw_dir),
        "output_path": str(out_dir),
        "train_samples_per_class": 500,
        "test_samples_per_class": 100,
        "modalities": {"audio": True, "image": True, "text": True},
        "ood": {"add_ood": False, "ratio": 0.0},
        "noise": {"add_noise_train": False, "add_noise_test": False},
        "label_noise": {"add_noise_train": False, "add_noise_test": False, "ratio": 0.0},
        "audio": modality(audio_data_path=str(raw_dir / "audio"),
                          audio_csv_path=str(raw_dir / "audio" / "datalist.csv")),
        "text": modality(text_tsv_path=str(raw_dir / "text_data.tsv")),
        "image": modality(image_data_path=str(raw_dir / "edm_images.pickle")),
    }


def create_config_file(raw_dir: Path, out_dir: Path, cfg_path: Path) -> None:
    """Write the compile config as YAML to ``cfg_path``."""
    cfg_path.parent.mkdir(parents=True, exist_ok=True)
    cfg_path.write_text(dump_yaml(compile_config(raw_dir, out_dir), sort_keys=False))
    print(f"  wrote {cfg_path}")


def create_simplified_dataset(raw_dir: Path, out_dir: Path) -> None:
    """The fallback compiled layout (compile_luma.py:175-313): the audio tree
    linked (copied where links fail), the datalist, text table and image
    pickle copied, and ``metadata.yaml`` written."""
    out_dir.mkdir(parents=True, exist_ok=True)
    audio_src = raw_dir / "audio"
    audio_dst = out_dir / "audio"
    if audio_src.exists() and not audio_dst.exists():
        try:
            audio_dst.symlink_to(audio_src.resolve(), target_is_directory=True)
        except OSError:
            shutil.copytree(audio_src, audio_dst)

    src_csv = audio_src / "datalist.csv"
    if src_csv.exists():
        shutil.copy(src_csv, out_dir / "audio_datalist.csv")
    for name in ["text_data.tsv", "edm_images.pickle"]:
        src = raw_dir / name
        if src.exists():
            shutil.copy(src, out_dir / name)

    (out_dir / "metadata.yaml").write_text(dump_yaml({
        "num_classes": 42,
        "num_ood_classes": 8,
        "train_samples_per_class": 500,
        "test_samples_per_class": 100,
        "source": "create_simplified_dataset",
    }))
    print(f"  compiled layout at {out_dir}")


def featurize(out_dir: Path, replicate_image_bug: bool = False) -> None:
    """Featurize the train and test splits into ``data.luma``'s feature
    cache beside the corpus, with ``runners/run_luma.py``'s settings."""
    from ..data.luma import LUMADataset
    from ..data.wordpiece import find_local_vocab
    from .common import load_config, make_getter
    from .run_luma import feature_configs

    audio, text, image = feature_configs(make_getter(load_config("luma_config.yaml")))
    # say up front what the text features will be: without transformers'
    # tokenizer in a local cache or a vendored vocab they are hashed ids
    hf_ok = False
    try:
        from transformers import AutoTokenizer

        AutoTokenizer.from_pretrained(text["model_name"], local_files_only=True)
        hf_ok = True
    except Exception:
        pass
    if find_local_vocab() is None and not hf_ok:
        print("  WARNING: no bert-base-uncased vocab found (data/bert-base-uncased-vocab.txt) "
              "and no local transformers tokenizer: TEXT FEATURES WILL BE HASH-DEGRADED (not "
              "reference-identical). Drop the ~230KB vocab.txt at "
              "data/bert-base-uncased-vocab.txt to fix.")

    for split in ["train", "test"]:
        ds = LUMADataset(str(out_dir), split, audio, text, image,
                         replicate_image_bug=replicate_image_bug)
        xs, y = ds.featurize()
        print(f"  featurized {split}: audio {xs[0].shape}, text {xs[1].shape}, "
              f"image {xs[2].shape}, {len(y)} labels -> {ds.cache_file().name}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--raw-dir", type=str, default="data/luma_raw")
    parser.add_argument("--out-dir", type=str, default="data/luma_compiled")
    parser.add_argument("--config-out", type=str,
                        default="disentagled_multimodal_fusion_tpu_torch/configs/"
                                "luma_compile_config.yaml")
    parser.add_argument("--skip-featurize", action="store_true")
    parser.add_argument("--replicate-image-bug", action="store_true")
    parser.add_argument("--offline", action="store_true",
                        help="skip all network steps without probing")
    parser.add_argument("--luma-repo", type=str, default="external/LUMA",
                        help="upstream LUMA repo checkout (cloned when online)")
    args = parser.parse_args(argv)

    raw_dir, out_dir = Path(args.raw_dir), Path(args.out_dir)
    online = (not args.offline) and has_network()
    print(f"network: {'available' if online else 'unavailable — network steps skipped'}")

    print("[1/6] NLTK wordnet")
    check_nltk_data(online)
    print("[2/6] upstream LUMA repo")
    repo = check_luma_repo(online, Path(args.luma_repo))
    print(f"[3/6] raw data check (offline: place the raw HF corpus at {raw_dir})")
    if not check_raw_data(raw_dir):
        # the compiled layout may already be there (e.g. the test fixture)
        if (out_dir / "audio_datalist.csv").exists():
            print("  raw data missing but compiled layout present — continuing")
            if not args.skip_featurize:
                print("[6/6] offline featurization")
                featurize(out_dir, args.replicate_image_bug)
            return 0
        print("  aborting: no raw or compiled data found")
        return 1
    print("[4/6] compile config")
    cfg_path = Path(args.config_out)
    create_config_file(raw_dir, out_dir, cfg_path)
    print("[5/6] compiled layout")
    compiled_upstream = repo is not None and run_upstream_compile(repo, cfg_path)
    if not compiled_upstream:
        print("  falling back to the simplified layout builder")
        create_simplified_dataset(raw_dir, out_dir)
    if not args.skip_featurize:
        print("[6/6] offline featurization")
        featurize(out_dir, args.replicate_image_bug)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
