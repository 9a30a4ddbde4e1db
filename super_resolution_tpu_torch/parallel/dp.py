"""Data parallelism over several devices (the JAX package's
``parallel/dp.py``), with the JAX package's global-batch semantics.

The JAX package runs one process per host over a mesh of devices, and
XLA's SPMD partitioner inserts the psums.  PyTorch's idiom is one
process per device, a *rank*: ``cfg.data_parallel`` = N is the global
number of ranks, as the JAX mesh size is the global device count.
:func:`launch` runs a function once per device of a list, each in its
own process inside one ``torch.distributed`` process group (NCCL when
every rank has a CUDA device of its own, gloo otherwise, printed).

The train steps are written for the global batch
(``train/steps.py``): N ranks with B/N rows each compute the step of
one process with B rows.  Where a step reduces over the batch, these
helpers make the reduction global:

- :func:`global_mean`, differentiable: the RaGAN batch means, D's
  BatchNorm statistics, the feature-matching normaliser;
- :func:`average_gradients`: the gradient lists, coalesced per dtype.
  The steps take gradients with ``torch.autograd.grad``, so the reducer
  of ``DistributedDataParallel``, which hooks ``.grad`` accumulation,
  would never fire; this is the port's counterpart of the psum of dW/db
  in the JAX package's ``ops/pallas/partitioned.py``;
- :func:`average_metrics`: the per-rank losses, so that rank 0 logs the
  global values;
- :func:`broadcast_`: the starting state from rank 0.

Every rank holds the same number of rows, so the global mean is the
mean over ranks of the local means.  Without a process group each
helper is the identity and the single-process path runs unchanged; in
a group of one rank the all-reduces run and are exact.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


# --------------------------------------------------------------------------
# The process group
# --------------------------------------------------------------------------

def active() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def barrier() -> None:
    if active():
        dist.barrier()


def devices_for(n: int, device: str | torch.device = "cuda"
                ) -> List[torch.device]:
    """The first ``n`` devices of ``device``'s type, one per rank: CUDA
    devices 0..n-1 (raises when there are fewer, as the JAX
    ``make_mesh`` does; never two ranks on one card), or ``n`` CPU
    ranks."""
    device = torch.device(device)
    if n < 1:
        raise ValueError(f"data parallel over {n} devices")
    if device.type == "cpu":
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(f"need {n} devices, have {have} CUDA device(s)")
    return [torch.device("cuda", i) for i in range(n)]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a CUDA device of its own; gloo
    otherwise (CPU ranks, or several ranks on one card, which NCCL
    refuses)."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) \
            and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def init_group(backend: str, init_method: str, world: int, rank_: int,
               timeout_s: Optional[float] = None) -> None:
    """``init_process_group``; a failure raises (no rank goes on
    alone)."""
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank_, **kw)


def _run_rank(local_rank: int, fn: Callable, args: tuple,
              devices: Sequence[str], rank_offset: int, world: int,
              init_method: str, backend: str, build_dir: str,
              timeout_s: Optional[float]):
    """One rank: its device, the kernels' build directory of the
    launching process, the group, then ``fn(device, *args)``."""
    from super_resolution_tpu_torch import build

    build.set_build_dir(build_dir)
    device = torch.device(devices[local_rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_group(backend, init_method, world, rank_offset + local_rank,
               timeout_s)
    try:
        return fn(device, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, args: tuple = (),
           devices: Sequence[str | torch.device] = ("cuda:0",),
           init_method: Optional[str] = None, rank_offset: int = 0,
           world: Optional[int] = None,
           timeout_s: Optional[float] = None):
    """Run ``fn(device, *args)`` once per device of ``devices``, ranks
    ``rank_offset`` .. ``rank_offset + len(devices) - 1`` of a group of
    ``world`` ranks (default ``len(devices)``).

    One device runs in this process, and ``fn``'s result is returned.
    Several run in spawned processes (``fn`` and ``args`` must pickle);
    every one is joined, and a rank that fails takes the launch down
    with its exception.  ``init_method`` defaults to a file store in a
    temporary directory, which serves one host; ranks on several hosts
    meet at a ``tcp://`` address (:mod:`parallel.multihost`).  The same
    device may appear more than once (two ranks on one card): the
    backend is then gloo, which the printed line says."""
    from super_resolution_tpu_torch import build

    devices = [str(torch.device(d)) for d in devices]
    world = len(devices) if world is None else world
    backend = backend_for(devices)
    why = ""
    if backend == "gloo" and any(d.startswith("cuda") for d in devices):
        why = " (several ranks on one CUDA device: NCCL refuses that)"
    print(f"[dp] ranks {rank_offset}..{rank_offset + len(devices) - 1} of "
          f"{world} on {', '.join(devices)}: backend {backend}{why}",
          flush=True)
    tmp = None
    if init_method is None:
        if world != len(devices):
            raise ValueError("ranks on several hosts need an init_method "
                             "(tcp://host:port) they can all reach")
        tmp = tempfile.mkdtemp(prefix="sr_dp_")
        init_method = "file://" + os.path.join(tmp, "store")
    rank_args = (fn, tuple(args), devices, rank_offset, world, init_method,
                 backend, build.BUILD_DIR, timeout_s)
    try:
        if len(devices) == 1:
            return _run_rank(0, *rank_args)
        if any(d.startswith("cuda") for d in devices):
            build.build_all()   # one nvcc per source, not one per rank
        torch.multiprocessing.start_processes(
            _run_rank, args=rank_args, nprocs=len(devices), join=True,
            start_method="spawn")
        return None
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# Global-batch reductions
# --------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks in the forward, and in the backward: the
    adjoint of summing every rank's value into every rank's result is
    that same sum of the cotangents."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``x`` over the ranks (``x`` alone
    without a group)."""
    return _AllReduceSum.apply(x) if active() else x


def global_mean(local_mean: torch.Tensor) -> torch.Tensor:
    """The global-batch mean from this rank's mean over its rows (every
    rank holds as many rows); differentiable."""
    if not active():
        return local_mean
    return all_reduce_sum(local_mean) / world_size()


def _coalesced(tensors: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    """``op`` (in place) on one flat buffer per dtype; the tensors back
    in their shapes, in order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        op(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def average_gradients(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient averaged over the ranks: one all-reduce per dtype."""
    if not active():
        return list(grads)
    w = world_size()

    def op(flat):
        dist.all_reduce(flat)
        flat /= w

    return _coalesced([g.detach() for g in grads], op)


def average_metrics(metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """0-dim metrics averaged over the ranks in one all-reduce (each a
    mean over its rank's rows: their average is the global mean)."""
    if not active() or not metrics:
        return dict(metrics)
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(flat)
    flat /= world_size()
    return dict(zip(keys, flat.unbind()))


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite every tensor with rank ``src``'s, in place, one
    broadcast per dtype."""
    if not active() or not tensors:
        return
    tensors = list(tensors)
    for t, new in zip(tensors, _coalesced(
            tensors, lambda flat: dist.broadcast(flat, src))):
        t.copy_(new)


# --------------------------------------------------------------------------
# Rows
# --------------------------------------------------------------------------

def local_rows(global_batch: int, world: Optional[int] = None) -> int:
    """Rows per rank of a global batch."""
    n = world_size() if world is None else world
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide "
                         f"over {n} ranks")
    return global_batch // n


def pad_batch_to_mesh(batch: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to a multiple of ``n`` ranks by repeating the last row,
    so that any batch splits evenly."""
    rem = batch.shape[0] % n
    if rem == 0:
        return batch
    return np.concatenate([batch, np.repeat(batch[-1:], n - rem, axis=0)])
