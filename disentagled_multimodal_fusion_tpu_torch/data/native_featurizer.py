"""ctypes binding of the native LUMA featurizer (``native/luma_featurizer.cc``).

Counterpart of ``disentagled_multimodal_fusion_tpu/data/native_featurizer.py``
over the same C++ source. The library is built with ``g++`` on first use into
the port's ``_build/`` directory, named by a hash of the source and the flags
(``native/Makefile``'s: no ``-march=native``, so both packages' libraries give
the same features). Where no compiler is found, or the build fails, the
pure-numpy pipeline of ``data/audio.py`` runs instead. This is host
featurization, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "native" / "luma_featurizer.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-fopenmp")

_lib = None


def library_path() -> Optional[Path]:
    """Where the built library lies (None without the source)."""
    if not SOURCE.exists():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"luma_featurizer-{digest}.so"


def _build(target: Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    target = library_path()
    if target is None or (not target.exists() and not _build(target)):
        return None
    try:
        lib = ctypes.CDLL(str(target))
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mfcc_mean.argtypes = [f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, f32p]
    lib.mfcc_mean.restype = ctypes.c_int
    lib.featurize_batch.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_double, ctypes.c_int, f32p]
    lib.featurize_batch.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def mfcc_mean_native(mono: np.ndarray, sample_rate: int = 16000, n_mfcc: int = 40,
                     n_mels: int = 40, n_fft: int = 400, hop: int = 200) -> Optional[np.ndarray]:
    """The time-mean MFCC of a mono signal, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    mono = np.ascontiguousarray(mono, dtype=np.float32)
    out = np.zeros(n_mfcc, np.float32)
    rc = lib.mfcc_mean(mono.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), mono.size,
                       sample_rate, n_mfcc, n_mels, n_fft, hop,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def featurize_wav_files(paths: List[str], sample_rate: int = 16000, max_length_s: float = 3.0,
                        n_mfcc: int = 40) -> np.ndarray:
    """WAV files -> (N, n_mfcc) time-mean MFCCs: natively when the library
    loads (the rows it fails on, NaN-filled by the C side, go through the
    numpy pipeline), else all through the numpy pipeline."""
    from .audio import wav_to_mfcc_mean

    lib = _load()
    if lib is None:
        return np.stack([wav_to_mfcc_mean(p, sample_rate, max_length_s, n_mfcc) for p in paths])
    blob = b"\0".join(str(p).encode() for p in paths) + b"\0"
    out = np.zeros((len(paths), n_mfcc), np.float32)
    failures = lib.featurize_batch(blob, len(paths), sample_rate, max_length_s, n_mfcc,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if failures:
        for i in np.where(np.isnan(out).any(axis=1))[0]:
            out[i] = wav_to_mfcc_mean(paths[i], sample_rate, max_length_s, n_mfcc)
    return out
