"""One run of one cell: set-up, the window, with ``--trace 1`` a traced
part after it, the check, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json``, whose ``kind`` names its driver,
``drivers/<kind>.py`` (a class ``Driver``), its limits
``limits/<cell>.json``, and each per-layer metric it reports a reader
``metrics/<metric>.py`` with a function ``read(m)`` that returns the
metric or None.  A cell on several cards runs one rank per card
(:mod:`ranks`); rank 0 reports.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import re
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from benchmark.lib import compare, ranks, trace as trace_lib

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "super_resolution_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> Dict:
    return _json(ROOT, "BENCHMARK.json")


def _reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    bench = bench or spec()
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if _reports(m, name, [m["name"]])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=entry["chips"],
                config=_json(BENCH, "configs", f"{entry['config']}.json"),
                traffic=_json(BENCH, "traffic", f"{entry['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def driver(kind: str):
    """The ``Driver`` class of ``drivers/<kind>.py``."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", kind):
        raise SystemExit(f"traffic kind {kind!r} names no driver module")
    return importlib.import_module(f"benchmark.drivers.{kind}").Driver


def reader(metric: str) -> Callable:
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec_ = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``super_resolution_tpu_torch`` is not
    ``super_resolution_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Measured:
    """What a per-layer reader reads: the cell, the window's counts
    (``window``, untraced), the traced part's counts and spans
    (``traced``) and its reduced trace (``trace``; None where nothing
    was traced), and the number of cards the run used (``chips``)."""

    def __init__(self, cell: Cell, window: Dict, traced: Optional[Dict],
                 trace: Optional[trace_lib.Trace], chips: int):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.chips = chips
        self.window, self.traced = window, traced
        self.trace = trace


def device_info(device: torch.device) -> Dict:
    """The card's name, and from every rank that ran: their number and
    the peak of the fullest."""
    peaks = ranks.gather(int(torch.cuda.max_memory_allocated(device))
                         if device.type == "cuda" else 0)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": len(peaks), "memory_peak_bytes": max(peaks)}


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, process_start: float,
        limits: Optional[Dict] = None) -> Optional[Dict]:
    """Run ``cell`` once and return the result line's object (None on
    ranks other than 0).  Device metrics are reported only from a run
    on the card.  With ``trace`` the per-layer metrics read the
    untraced window's counts and, after it, a part of
    ``traffic["trace_count"]`` frames or steps under ``torch.profiler``
    (rank 0's)."""
    from torch.profiler import record_function

    if ranks.world() != cell.chips and device.type == "cuda":
        raise SystemExit(f"{cell.name} asks for {cell.chips} card(s); "
                         f"{ranks.world()} rank(s) run")
    drv = driver(cell.traffic["kind"])(cell.config, cell.traffic, seed,
                                       device)
    drv.warmup()
    window = drv.run(seconds)
    traced = tr = None
    if trace:
        n = cell.traffic["trace_count"]
        if ranks.rank() == 0:
            with trace_lib.profiled(device) as prof:
                with record_function(trace_lib.WINDOW):
                    traced = drv.run(None, count=n, traced=True)
            tr = trace_lib.reduce(prof)
        else:
            drv.run(None, count=n, traced=True)
    setup_s = window["t_start"] - process_start
    dev = device_info(device)
    drv.free_program()
    numbers = drv.check()
    ranks.barrier()
    if ranks.rank():
        return None
    limits = compare.load_limits(cell.name) if limits is None else limits
    correct, checks = compare.judge(numbers, limits)

    metrics: Dict[str, Dict] = {}
    if device.type == "cuda":
        if trace:
            m = Measured(cell, window, traced, tr, dev["count"])
            for spec_ in cell.per_layer:
                value = reader(spec_["name"])(m)
                if value is not None:
                    metrics[spec_["name"]] = {"value": value,
                                              "unit": spec_["unit"]}
            dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        else:
            e2e = drv.end_to_end(window)
            e2e["setup_s"] = setup_s
            for spec_ in cell.end_to_end:
                metrics[spec_["name"]] = {"value": e2e[spec_["name"]],
                                          "unit": spec_["unit"]}
    units = window.get("frames", window.get("steps"))
    result = {"correct": bool(correct), "attempted": units, "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None and device.type == "cuda":
        result["breakdown"] = tr.breakdown()
    result["checks"] = {n: {k: v if v is None or math.isfinite(v)
                            else str(v) for k, v in c.items()}
                        for n, c in checks.items()}
    for name, c in checks.items():
        lim = "not compared" if c["limit"] is None else c["limit"]
        print(f"check {name} {c['value']!r} limit {lim}", file=sys.stderr,
              flush=True)
    return result
