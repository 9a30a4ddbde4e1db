"""The traced run: ``torch.profiler`` over a window, reduced to what the
per-layer metrics and the result's ``breakdown`` read.

The window is the host span ``bench.window``, which ends in a
synchronise.  Device activity is every kernel, copy and set on the
card, not the annotations the profiler mirrors onto the device's
timeline; busy time is the union of their intervals inside the window,
and an idle gap is a stretch of the window with none of them running,
named by what the host was doing at its middle: the innermost
``bench.*`` span and the innermost operation then open.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch

WINDOW = "bench.window"


@contextlib.contextmanager
def profiled(device: torch.device):
    """Profile the body; yields a holder whose ``prof`` is the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _short(name: str) -> str:
    name = re.sub(r"^void ", "", name)
    return name[:160]


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: Dict[str, float] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, patterns: Iterable[str]) -> float:
        """Device seconds of the kernels whose name matches any of the
        regular expressions."""
        res = [re.compile(p) for p in patterns]
        return sum(s for n, s in self.device_s.items()
                   if any(r.search(n) for r in res))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:top]]}


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not (
        getattr(e, "is_user_annotation", False)
        or e.name.startswith(("Optimizer.", "ProfilerStep")))


def reduce(prof, top_gaps: int = 10) -> Optional[Trace]:
    """The window's busy time, device time by kernel name and its
    longest idle gaps; None without a ``bench.window`` span."""
    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW]
    if not win:
        return None
    t0, t1 = win[0].time_range.start, win[0].time_range.end
    spans = []
    device_s: Dict[str, float] = {}
    for e in events:
        if not _is_device(e):
            continue
        a, b = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if b <= a:
            continue
        spans.append((a, b))
        key = _short(e.name)
        device_s[key] = device_s.get(key, 0.0) + (b - a) / 1e6
    spans.sort()
    busy, gaps, cur = 0.0, [], t0
    for a, b in spans:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if t1 > cur:
        gaps.append((cur, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if not _is_device(e)
            and e.thread == win[0].thread and e.name != WINDOW]
    named = [(_host_at(host, (a + b) / 2), (b - a) / 1e6)
             for a, b in gaps[:top_gaps]]
    return Trace(window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6,
                 device_s=device_s, gaps=named)


def _host_at(host, t: float) -> str:
    """What the host was doing at time ``t``: the innermost open
    ``bench.*`` span and the innermost open operation."""
    span, op = None, None
    for e in host:
        if e.time_range.start <= t <= e.time_range.end:
            if e.name.startswith("bench."):
                if span is None or e.time_range.start > span.time_range.start:
                    span = e
            elif op is None or e.time_range.start > op.time_range.start:
                op = e
    parts = [x.name for x in (span, op) if x is not None]
    return " > ".join(parts) or "host idle (no open span)"
