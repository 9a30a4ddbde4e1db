"""Training over several hosts (the JAX package's
``parallel/multihost.py``).

The JAX package runs one process per host, and the same compiled step
scales across hosts because jit over a global mesh is multi-process
aware.  The port runs one process per device (a rank, :mod:`parallel.dp`)
on every host: host ``process_id`` of ``num_hosts`` starts its
``data_parallel / num_hosts`` local ranks, of global rank
``process_id · local + local_rank``, and all of them meet at the
coordinator's ``tcp://`` address (rank 0, on host 0, serves the store).
What changes across hosts is what surrounds the step:

1. **Runtime init**: :func:`initialize` (one rank) and :func:`launch`
   (every local rank of a host) bring up the process group.
2. **Input**: each rank loads only its rows of the global batch.  The
   loaders take ``part=`` :func:`data_part`, and their rows come from
   the global ``(seed, step, row)``, so the concatenation over the ranks
   is the single-process stream bit for bit.  The JAX package's
   ``global_batch`` / ``global_batch_iter`` have no counterpart here:
   they assemble the host's rows into one global array over its
   devices, and each rank of the port already feeds its own device.
3. **Side effects**: logging, sample grids, in-loop eval and the
   checkpoint writes run on rank 0 alone (:func:`is_primary`), against
   a file system every host shares, each save followed by a barrier.

In the port a *process* is a rank, so :func:`process_count` is the
number of ranks and :func:`process_index` this rank; each helper
degrades exactly to the single-process path without a group.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from super_resolution_tpu_torch.parallel import dp


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str = "nccl",
               timeout_s: Optional[float] = None) -> None:
    """This process as rank ``process_id`` of ``num_processes`` ranks,
    meeting at ``tcp://coordinator_address``; a failure raises."""
    dp.init_group(backend, f"tcp://{coordinator_address}", num_processes,
                  process_id, timeout_s)


def launch(fn: Callable, args: tuple, coordinator_address: str,
           num_hosts: int, host_id: int, data_parallel: int,
           device: str = "cuda", timeout_s: Optional[float] = None):
    """``fn(device, *args)`` on each local rank of host ``host_id`` of
    ``num_hosts``, in a group of ``data_parallel`` ranks (the global
    count, as the JAX package's mesh size), through :func:`dp.launch`."""
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host {host_id} of {num_hosts}")
    if data_parallel % num_hosts:
        raise ValueError(f"data_parallel={data_parallel} does not divide "
                         f"over {num_hosts} hosts")
    local = data_parallel // num_hosts
    return dp.launch(fn, args, dp.devices_for(local, device),
                     init_method=f"tcp://{coordinator_address}",
                     rank_offset=host_id * local, world=data_parallel,
                     timeout_s=timeout_s)


def process_count() -> int:
    return dp.world_size()


def process_index() -> int:
    return dp.rank()


def is_primary() -> bool:
    """Whether this rank owns the side effects that are not collective
    (logs, sample grids, in-loop eval, checkpoint writes)."""
    return dp.rank() == 0


def data_part() -> Tuple[int, int]:
    """The ``part=(index, count)`` this rank feeds the loaders."""
    return dp.rank(), dp.world_size()


def local_rows(global_batch_size: int) -> int:
    return dp.local_rows(global_batch_size)
