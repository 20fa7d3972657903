"""Build and load the port's hand-written CUDA kernels.

Each source in ``seed_tpu_torch/csrc/`` has a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into its own shared library under
``build/seed_tpu_torch/`` of the checkout and loaded with ``ctypes``. Nothing
here includes PyTorch's headers, so a build takes seconds. A library is named
after a digest of its source, so an edited source is rebuilt and a stale one
is never loaded.

Building happens at first use (or up front through :func:`build`), never at
import: the CPU tests import every module of the package on machines with no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "seed_tpu_torch"
SOURCES = {"short_mha": "short_mha.cu", "int8_matmul": "int8_matmul.cu",
           "flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of seed_tpu_torch "
                           "are built with the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns the compiler's report (registers,
    shared memory, spills) per kernel built; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed.
    ``signatures`` maps each C function to its ``argtypes``; every function
    returns an int (a cudaError_t or a size)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
