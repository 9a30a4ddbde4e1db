"""The program's own spans and counters over the traced part
(``super_resolution_tpu_torch.metrics.span_report``): the program
records while a profiler records, and starts a fresh report when it
turns on, so after a traced run the report covers the traced part
alone.  A program without spans gives None, as does an untraced run."""

from __future__ import annotations

from typing import Dict, Optional


def report(m) -> Optional[Dict]:
    """The traced part's span report, or None."""
    if m.trace is None:
        return None
    try:
        from super_resolution_tpu_torch.metrics import span_report
    except ImportError:             # a program that records no spans
        return None
    r = span_report()
    return r if r["spans"] or r["counters"] else None


def value(r: Dict, name: str, key: str) -> Optional[float]:
    """``key`` (``calls``, ``host_s``, ``self_host_s``, ``device_s``)
    of span ``name``, or None."""
    return r["spans"].get(name, {}).get(key)
