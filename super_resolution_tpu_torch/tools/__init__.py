"""The port's dense-block variant tools, after the JAX package's
``tools/kernel_bench.py``, ``tools/model_bench.py`` and
``tools/kernel_dev_check.py``; run each as ``python -m
super_resolution_tpu_torch.tools.<name>``.  They take the JAX tools'
flags, defaults and printed lines, plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions).  Times come from
CUDA events after a warm-up on the card (the host clock on the CPU).

Shared here: the variants by the JAX tools' names, each as a function of
NCHW x, HWIO weights, f32 biases and ``rows`` with the counter of its
launches, and the timing.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable, Dict, Tuple

import torch

# the modules: the package's ``ops`` exports functions of these names
_db = importlib.import_module("super_resolution_tpu_torch.ops.dense_block")
_ex = importlib.import_module(
    "super_resolution_tpu_torch.ops.experiments_dense_block")

FWD_CARRY_REFUSED = (
    "--fwd_carry: the fused forward's halo carry is a TPU band carry and "
    "is not ported (ROADMAP.md: the fwd/bwd halo carries exist only to "
    "fit VMEM); the port's kernels recompute nothing across bands")


def _v5(x, ws, bs, *, rows, res_scale=0.2, slope=0.2):
    """v5 and v9 (``fused_dense_block_cf5`` / ``cf9``): the dense-block
    kernel itself; ``rows`` is checked as the JAX kernels check it."""
    _ex._check_rows(x, rows)
    wp, bp = _ex._packed(x, ws, bs)
    return _db.dense_block(x, wp, bp, res_scale=res_scale, slope=slope)


def variants() -> Dict[str, Tuple[Callable, Callable]]:
    """name -> (function, the function whose ``launches`` count it)."""
    return {"v3": (_ex.fused_dense_block_cf, _ex.fused_dense_block_cf),
            "v3b": (_ex.fused_dense_block_cf2, _ex.fused_dense_block_cf2),
            "v4": (_ex.fused_dense_block_cf3, _ex.fused_dense_block_cf3),
            "v5": (_v5, _db.dense_block),
            "v6": (_ex.fused_dense_block_cf6, _ex.fused_dense_block_cf6),
            "v8": (_ex.fused_dense_block_cf8, _ex.fused_dense_block_cf8),
            "v9": (_v5, _db.dense_block)}


def time_ms(fn: Callable, device: torch.device, iters: int,
            warmup: int = 2) -> float:
    """ms per call of ``fn`` over ``iters`` calls after ``warmup``: CUDA
    events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
