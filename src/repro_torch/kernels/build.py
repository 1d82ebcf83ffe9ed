"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, under
``build/`` at the repository root (a directory ``.gitignore`` lists).  The
library's file name carries a hash of its source, so an edited kernel is
rebuilt and a current one is loaded as it is.  All sources are compiled
concurrently, one ``nvcc`` each.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("matmul",)
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                       "needs the CUDA toolkit (nvcc on PATH or under "
                       "/usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> List[Path]:
    """Compile every source in ``names`` that has no current library, all
    ``nvcc`` processes started together; raise if any fails."""
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        tmp.replace(out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        (path,) = build_all((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
