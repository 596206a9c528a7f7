"""LUMA smoke-test script with ✓/✗ prints and an exit code.

Counterpart of ``disentagled_multimodal_fusion_tpu/runners/test_luma.py`` on
the port's loader (``data/luma.py``: no pandas; the image table is optional,
as the pickle or the ``.npz``). Reference semantics: test_luma.py:14-252 — four sequential checks:
(1) compiled-artifact existence, (2) dataset construction + metadata
invariants (classes/views/dims), (3) one featurized batch with shape/dtype
assertions, (4) raw audio decode through the featurizer with directory
diagnostics. (The reference's check 3 unpacks batches in a way that doesn't
match its own collate — test_luma.py:98 — ours asserts the real contract.)
"""

from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

import numpy as np


def test_compilation(data_path: Path) -> bool:
    print("\n[1/4] compiled-artifact existence")
    needed = ["audio_datalist.csv", "text_data.tsv", "metadata.yaml"]
    ok = True
    for name in needed:
        p = data_path / name
        print(f"  {'✓' if p.exists() else '✗'} {p}")
        ok &= p.exists()
    for opt in (data_path / "edm_images.pickle", data_path / "edm_images.npz"):
        print(f"  {'✓' if opt.exists() else '(optional, missing)'} {opt}")
    return ok


def test_dataset_construction(data_path: Path) -> bool:
    print("\n[2/4] dataset construction + metadata invariants")
    from ..data.luma import LUMADataset

    try:
        train = LUMADataset(str(data_path), "train")
        test = LUMADataset(str(data_path), "test")
    except Exception as e:
        print(f"  ✗ construction failed: {e}")
        return False
    ok = True
    for name, cond in [
        ("num_views == 3", train.num_views == 3),
        ("train classes == test classes", train.num_classes == test.num_classes),
        ("dims shape (3, 1)", train.dims.shape == (3, 1)),
        ("train non-empty", len(train) > 0),
        ("test non-empty", len(test) > 0),
    ]:
        print(f"  {'✓' if cond else '✗'} {name}")
        ok &= bool(cond)
    return ok


def test_one_batch(data_path: Path) -> bool:
    print("\n[3/4] featurized batch shapes/dtypes")
    from ..data.luma import LUMADataset

    try:
        ds = LUMADataset(str(data_path), "test")
        (audio, text, image), y = ds.featurize()
    except Exception as e:
        traceback.print_exc()
        print(f"  ✗ featurize failed: {e}")
        return False
    dims = [int(d[0]) for d in ds.dims]
    ok = True
    for name, cond in [
        (f"audio (N, {dims[0]}) f32", audio.shape[1] == dims[0] and audio.dtype == np.float32),
        (f"text (N, {dims[1]}) f32", text.shape[1] == dims[1] and text.dtype == np.float32),
        (f"image (N, {dims[2]}) f32", image.shape[1] == dims[2] and image.dtype == np.float32),
        ("labels int64 in [0, C)", y.dtype == np.int64 and y.min() >= 0 and y.max() < ds.num_classes),
        ("aligned lengths", len({len(audio), len(text), len(image), len(y)}) == 1),
        ("audio features finite+nonzero", np.isfinite(audio).all() and np.abs(audio).sum() > 0),
    ]:
        print(f"  {'✓' if cond else '✗'} {name}")
        ok &= bool(cond)
    return ok


def test_audio_decode(data_path: Path) -> bool:
    print("\n[4/4] raw audio decode")
    from ..data.audio import read_wav
    from ..data.luma import Table
    from ..data.native_featurizer import available

    csv = data_path / "audio_datalist.csv"
    if not csv.exists():
        print("  ✗ no datalist")
        return False
    fp = Path(Table.read(csv).columns["filepath"][0])
    path = fp if fp.is_absolute() else data_path / fp
    if not path.exists():
        print(f"  ✗ first audio file missing: {path}")
        print(f"    directory contents: {list((data_path).iterdir())[:10]}")
        return False
    try:
        wav, rate = read_wav(str(path))
    except Exception as e:
        print(f"  ✗ decode failed: {e}")
        return False
    print(f"  ✓ decoded {path.name}: shape {wav.shape}, rate {rate}")
    print(f"  {'✓' if available() else '(numpy fallback)'} native featurizer")
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-path", type=str, default="data/luma_compiled")
    args = parser.parse_args(argv)
    data_path = Path(args.data_path)

    results = [
        ("compilation", test_compilation(data_path)),
        ("dataset", test_dataset_construction(data_path)),
        ("batch", test_one_batch(data_path)),
        ("audio", test_audio_decode(data_path)),
    ]
    print("\n" + "=" * 50)
    passed = sum(ok for _, ok in results)
    for name, ok in results:
        print(f"  {'✓' if ok else '✗'} {name}")
    print(f"{passed}/{len(results)} checks passed")
    return 0 if passed == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
