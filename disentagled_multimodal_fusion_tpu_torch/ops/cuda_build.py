"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface, ``_build/<name>-<hash>.so`` (the hash covers the source
and the flags, so an edited source builds anew). All missing sources are
compiled at once, one ``nvcc`` process each. Nothing is built at import
time: machines without ``nvcc`` import this module and never call it.
The spans ``kernels.build`` (the nvcc processes, when a source is built)
and ``kernels.load`` (``load_library``'s load) time both (``core/logging.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

from ..core.logging import span

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuildInfo:
    """Where a source's library lies, how long its build took in this
    process (0.0 when it was already built) and what ptxas reported."""

    library: Path
    seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _paths(name: str):
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    stem = BUILD_DIR / f"{name}-{digest}"
    return source, stem.with_suffix(".so"), stem.with_suffix(".log")


def build(names: Sequence[str]) -> Dict[str, BuildInfo]:
    """Compile every source in ``names`` that is not built yet, all at once.

    Raises with nvcc's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started, infos = {}, {}
    t0 = time.perf_counter()
    for name in names:
        source, lib, log = _paths(name)
        if lib.exists():
            infos[name] = BuildInfo(lib, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        started[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib, log)
    if not started:
        return infos
    with span("kernels.build", sources=",".join(started)):
        for name, (proc, tmp, lib, log) in started.items():
            output, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{output}")
            log.write_text(output)
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
            infos[name] = BuildInfo(lib, time.perf_counter() - t0, output)
    return infos


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    library = build([name])[name].library
    with span("kernels.load", source=name):
        return ctypes.CDLL(str(library))
