"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` exposes a plain C interface.  It is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library, at first use,
under ``_build/`` beside this file (git-ignored), and loaded with
``ctypes``; the library's name carries a hash of its source and flags, so
an edited source is rebuilt and an unchanged one is reused.  Nothing is
built when the module is imported: CPU-only machines import it freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")

#: kernel library name -> its source under csrc/
SOURCES = {"rank_topk": "rank_topk.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
            "CUDA toolkit is needed to build the port's kernels")
    return path


def library_path(name: str) -> str:
    """Where the library of kernel ``name`` is (or will be) built."""
    src = os.path.join(CSRC, SOURCES[name])
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:12]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel library (default: all) that is not built
    yet, one ``nvcc`` per source, all started together.  Returns, per
    library compiled, its wall seconds and ``nvcc``'s report (``-Xptxas
    -v``: registers, shared memory, spills).  Raises with the compiler's
    output when a build fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    report = {}
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build kernel {name!r} "
                f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": seconds, "nvcc": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LOADED:
        path = library_path(name)
        if not os.path.exists(path):
            build_all([name])
        _LOADED[name] = ctypes.CDLL(path)
    return _LOADED[name]
