"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes``.
Libraries go to ``_build/`` inside the package (listed in .gitignore),
named by a hash of the source, the shared headers and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Nothing is built when a
module is imported: the first launch builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> source under csrc/
SOURCES = {"dense_block": "dense_block.cu",
           "dense_block_bwd": "dense_block_bwd.cu",
           "conv3x3": "conv3x3.cu",
           "dense_block_int8": "dense_block_int8.cu"}
# headers under csrc/ that the sources include
HEADERS = ("conv3x3_tile.cuh",)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled from "
            f"{CSRC} with the CUDA toolkit on the machine that has the card")
    return path


def library_path(name: str) -> str:
    """Where the built library for ``name`` lives (content-addressed)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name], *HEADERS):
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start_nvcc(name: str, dst: str):
    """Start nvcc for ``name`` into a temporary file beside ``dst``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_nvcc(name: str, proc, tmp: str, dst: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} (exit "
                           f"{proc.returncode}):\n{out}")
    os.replace(tmp, dst)   # a reader never sees a partial file


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            dst = library_path(name)
            if not os.path.exists(dst):
                _finish_nvcc(name, *_start_nvcc(name, dst), dst)
            lib = ctypes.CDLL(dst)
            _loaded[name] = lib
        return lib


def build_all() -> None:
    """Build every source that is not built yet, one nvcc each, all
    started together."""
    with _lock:
        todo = {n: library_path(n) for n in SOURCES}
        started = {n: _start_nvcc(n, dst) for n, dst in todo.items()
                   if not os.path.exists(dst)}
        errors = []
        for n, (proc, tmp) in started.items():   # wait for every nvcc
            try:
                _finish_nvcc(n, proc, tmp, todo[n])
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
