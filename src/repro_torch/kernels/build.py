"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, under
``build/`` at the repository root (a directory ``.gitignore`` lists).  The
library's file name carries a hash of its source and of every header under
``csrc/`` (``hopper.cuh``), so an edited kernel or header is rebuilt and a
current one is loaded as it is.  All sources are compiled
concurrently, one ``nvcc`` each, with ``-Xptxas -v``: each kernel's
registers, shared memory and spills are kept in ``LOGS``.  A failed build
raises; nothing falls back.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("matmul", "bitonic_sort", "flash_attention", "wkv")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_loaded: Dict[tuple, ctypes.CDLL] = {}
LOGS: Dict[str, str] = {}  # source name -> nvcc's output of its last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                       "needs the CUDA toolkit (nvcc on PATH or under "
                       "/usr/local/cuda/bin)")


def library_path(name: str, defines=()) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: its name hashes the
    source, every ``csrc/*.cuh`` (in name order), which a source may
    include, and the macros ``defines`` (``NAME=VALUE``) it is built with."""
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    for define in defines:
        digest.update(b"-D" + define.encode() + b"\0")
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES, defines=()) -> List[Path]:
    """Compile every source in ``names`` that has no current library, with
    the macros ``defines``, all ``nvcc`` processes started together; raise
    if any fails."""
    return build_jobs([(n, tuple(defines)) for n in names])


def build_jobs(jobs) -> List[Path]:
    """Compile each (source name, macros) of ``jobs`` that has no current
    library, one ``nvcc`` each, all started together (the sort's tile and
    group candidates are such jobs); raise if any fails.  Returns the
    libraries' paths in the order of ``jobs``."""
    todo = [(n, d, library_path(n, d)) for n, d in dict.fromkeys(jobs)
            if not library_path(n, d).exists()]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defines, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        LOGS[name] = log
        tmp.replace(out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return [library_path(n, d) for n, d in jobs]


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` with the macros
    ``defines`` (none for the port's own), built first if needed."""
    lib = _loaded.get((name, tuple(defines)))
    if lib is None:
        (path,) = build_all((name,), defines)
        lib = ctypes.CDLL(str(path))
        _loaded[(name, tuple(defines))] = lib
    return lib
