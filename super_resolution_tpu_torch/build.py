"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes``.
Libraries go to ``BUILD_DIR``, by default ``_build/`` inside the
package (listed in .gitignore), named by a hash of the source, the
shared headers and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  That directory is the port's
compile cache, the counterpart of the JAX package's XLA cache
(``compile_cache.py``): :func:`set_build_dir` points it elsewhere (the
CLI's ``--compile_cache_dir``), :func:`temporary_build_dir` at a
directory removed at exit (``--no_compile_cache``).  Nothing is built when a
module is imported: the first launch builds what it needs.  ``ptxas -v``
reports each kernel's registers, shared memory and spills into a log
beside the library; :func:`ptxas_report` reads it.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List, Sequence

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> source under csrc/
SOURCES = {"dense_block": "dense_block.cu",
           "dense_block_chain": "dense_block_chain.cu",
           "dense_block_bwd": "dense_block_bwd.cu",
           "conv3x3": "conv3x3.cu",
           "dense_block_int8": "dense_block_int8.cu",
           "window_attention": "window_attention.cu"}
# headers under csrc/ that the sources include
HEADERS = ("conv3x3_tile.cuh", "conv3x3_wgmma.cuh")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def set_build_dir(path: str) -> str:
    """Build and load the libraries under ``path`` from now on (a
    library already loaded stays loaded); returns the absolute path."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = os.path.abspath(os.path.expanduser(path))
    return BUILD_DIR


def temporary_build_dir() -> str:
    """Build into a fresh temporary directory, removed when the process
    exits (no cache across runs)."""
    path = tempfile.mkdtemp(prefix="sr_torch_build_")
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return set_build_dir(path)


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
    with open(f"{dst}.log", "w") as f:
        f.write(out)
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


def load_all(names: Sequence[str]) -> List[ctypes.CDLL]:
    """The loaded libraries for ``names``, those not built yet built
    together first."""
    if any(n not in _loaded for n in names):
        build_all(names)
    return [load(n) for n in names]


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Build every source (of ``names``) that is not built yet, one nvcc
    each, all started together."""
    with _lock:
        todo = {n: library_path(n) for n in names}
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


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(log: str) -> List[dict]:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its (mangled) name,
    registers, static shared memory and spill bytes; ptxas lines that
    mention wgmma (serialized wgmma, for one) go under ``notes``."""
    kernels: List[dict] = []
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            kernels.append({"kernel": m.group(1), "registers": None,
                            "smem_bytes": 0, "spill_stores": None,
                            "spill_loads": None, "notes": []})
            continue
        if not kernels:
            continue
        k = kernels[-1]
        m = _SPILLS.search(line)
        if m:
            k["spill_stores"], k["spill_loads"] = (int(m.group(2)),
                                                   int(m.group(3)))
        m = _USED.search(line)
        if m:
            k["registers"] = int(m.group(1))
            m = _SMEM.search(line)
            k["smem_bytes"] = int(m.group(1)) if m else 0
        if "wgmma." in line:       # a ptxas note on the instructions
            k["notes"].append(line.strip())
    return kernels


def ptxas_report(name: str) -> List[dict]:
    """:func:`parse_ptxas` of the build log of ``name`` (empty when the
    library was built before logs were kept)."""
    path = f"{library_path(name)}.log"
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return parse_ptxas(f.read())
