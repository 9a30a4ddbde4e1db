"""One process per card: a cell on ``chips`` cards runs ``chips`` ranks.

Rank 0 is the process the command started.  It starts ranks 1 .. n-1 as
copies of its own command with ``--rank r --port p`` added, and every
rank joins one ``torch.distributed`` group at ``tcp://localhost:<p>``
(NCCL on cards, gloo on the CPU).  The program under test finds the
group by itself (its gradient and metric reductions are the identity
without one).  Rank 0 gathers what each rank reports and prints the
result; the others print nothing on stdout.  Rank 0 waits for every
rank it started, and ends any that outlive the run.
"""

from __future__ import annotations

import datetime
import socket
import subprocess
import sys
from typing import List, Sequence

import torch
import torch.distributed as dist

TIMEOUT_S = 240.0


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(script: str, argv: Sequence[str], n: int, port: int
          ) -> List[subprocess.Popen]:
    """Ranks 1 .. n-1: ``script`` with ``argv`` and their rank."""
    return [subprocess.Popen(
        [sys.executable, script, *argv, "--rank", str(r), "--port",
         str(port)], stdout=subprocess.DEVNULL)
        for r in range(1, n)]


def join(rank_: int, n: int, port: int, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", world_size=n, rank=rank_,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def leave() -> None:
    if active():
        dist.destroy_process_group()


def wait(procs: List[subprocess.Popen], timeout_s: float = 60.0
         ) -> List[int]:
    """Each started rank's exit code; a rank still running after
    ``timeout_s`` is killed (and reads as failed)."""
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=timeout_s))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rcs.append(-9)
    return rcs


def gather(obj) -> list:
    """Every rank's ``obj``, in rank order (on every rank)."""
    if not active():
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def any_(flag: bool, device: torch.device) -> bool:
    """True on every rank once one rank says so (a window closes on all
    ranks at the same step)."""
    if not active():
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    if active():
        dist.barrier()
