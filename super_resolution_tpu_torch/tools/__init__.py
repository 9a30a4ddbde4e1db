"""The port's tools, after the JAX package's ``tools/``: the dense-block
variant tools (``kernel_bench``, ``model_bench``, ``kernel_dev_check``),
the benches (``tiled_bench``, ``train_bench``, ``grad_bench``,
``profile_gan``), the checks (``verify_grads_onchip``, ``halo_parity``),
the train/eval demo (``demo_train_eval``) and ``convert_vgg``; run each
as ``python -m super_resolution_tpu_torch.tools.<name>``.  They take the
JAX tools' flags, defaults and printed lines, plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions).  Times come from
CUDA events after a warm-up on the card, or from the host clock around
work that ends in a synchronise (the host clock alone on the CPU).  A
flag that tunes a TPU mechanism the port does not have is refused with a
message that names it, never ignored.  A tool that launches the port's
kernels ends with a ``launches: {counter: n}`` line.

Shared here: the variants by the JAX tools' names, each as a function of
NCHW x, HWIO weights, f32 biases and ``rows`` with the counter of its
launches, the launch counters, the timing and the refusals.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable, Dict, Optional, Tuple

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


BWD_CARRY_REFUSED = (
    "--bwd_carry: the Mosaic backward's halo-recompute carry is a TPU band "
    "carry and is not ported (ROADMAP.md: the fwd/bwd halo carries exist "
    "only to fit VMEM)")
LANE_CAP_REFUSED = (
    "--{flag}: the Pallas kernels' lane cap bounds a VMEM band and is not "
    "ported (ROADMAP.md: the lane caps exist only to fit VMEM); the port's "
    "kernels take every plane")
ROWS_REFUSED = (
    "--rows: the Pallas kernels' band height is a VMEM tiling and is not "
    "ported; the port's dense-block kernels have no band rows")
CF9_REFUSED = (
    "--cf9: the dy-extended v9 kernel's routing (partitioned.CF9_ENABLED) "
    "is a TPU layout choice and is not ported; v5 and v9 are one kernel "
    "in the port")


def refuse(args, **messages) -> None:
    """Exit with the message of the first refused flag that was given:
    any value but ``None`` and the integer 0 (``--rows 0`` means auto;
    ``--no-bwd_carry`` is given, and refused)."""
    for flag, msg in messages.items():
        v = getattr(args, flag, None)
        if v is not None and not (type(v) is int and v == 0):
            raise SystemExit(msg.format(flag=flag))


def launch_counters() -> Dict[str, Callable]:
    """Kernel counter name -> the wrapper that counts its launches, for
    the kernels of the generator's paths."""
    c3 = importlib.import_module("super_resolution_tpu_torch.ops.conv3x3")
    return {"dense_block": _db.dense_block,
            "dense_block_bwd": _db.dense_block_bwd,
            "dense_block_nhwc": _db.fused_dense_block,
            "conv3x3": c3.conv3x3}


def reset_launches(counters: Dict[str, Callable]) -> None:
    for f in counters.values():
        f.launches = 0


def read_launches(counters: Dict[str, Callable]) -> Dict[str, int]:
    return {n: f.launches for n, f in counters.items()}


def device_ms(fn: Callable, device: torch.device,
              iters: int = 3) -> Optional[float]:
    """Device ms per call of ``fn``: the kernels' and copies' time from
    ``torch.profiler`` over ``iters`` calls (no host time, no gaps).
    None on the CPU, or where the profiler records no device kernel."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(device)
    # kernels and copies only: an annotation carried over to the device
    # (Optimizer.step#Adam.step) spans kernels and gaps alike
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and not (
                   getattr(e, "is_user_annotation", False)
                   or e.name.startswith(("Optimizer.", "ProfilerStep"))))
    return busy / 1e3 / iters if busy else None


def host_sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
