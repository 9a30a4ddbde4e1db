"""Observability (the JAX package's ``metrics.py``): the image metrics
of eval (PSNR and SSIM, RGB and Y channel), windowed scalar averaging
with JSONL, stdout and optional tensorboard sinks, the throughput
meter, the profiler trace, and the program's own spans and counters
(:func:`span`, :func:`count`, :func:`recording`, :func:`span_report`).

Images keep the JAX package's layout, ``(..., H, W, C)`` in [0, 1].
:func:`ssim` takes its local moments as E[x²] − μ², which cancels: under
TF32 (cuDNN's default for float32 convs, about three decimal digits) it
gives SSIM above 1.  So its Gaussian filter runs inside
:func:`device.no_tf32`, in full float32, as the JAX package pins
``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import socket
import threading
import time
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.device import no_tf32


# --------------------------------------------------------------------------
# Image metrics
# --------------------------------------------------------------------------

def rgb_to_y(x: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma of [0, 1] RGB (SR papers report Y-channel PSNR
    beside RGB)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return (65.481 * r + 128.553 * g + 24.966 * b + 16.0) / 255.0


def psnr01(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))


def _gaussian_window() -> np.ndarray:
    """The 11×11 Gaussian window (σ = 1.5), float32, summing to 1."""
    xs = np.arange(-5, 6, dtype=np.float64)
    win = np.exp(-(xs ** 2) / (2 * 1.5 ** 2))
    win = (win / win.sum()).astype(np.float32)
    return np.outer(win, win)


def ssim(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """SSIM of (H, W, C) or (B, H, W, C) images with the standard 11×11
    Gaussian window (σ = 1.5) as a depthwise VALID float32 conv
    (skimage / Wang et al. constants), TF32 off."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    if pred.dim() == 3:
        pred, target = pred[None], target[None]
    c = pred.shape[-1]
    w = torch.from_numpy(_gaussian_window()).to(pred.device)
    w = w[None, None].expand(c, 1, 11, 11).contiguous()

    def filt(img):
        return F.conv2d(img.float().permute(0, 3, 1, 2), w, groups=c)

    with no_tf32():
        mu_x, mu_y = filt(pred), filt(target)
        mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        sig_x = filt(pred * pred) - mu_x2
        sig_y = filt(target * target) - mu_y2
        sig_xy = filt(pred * target) - mu_xy
    s = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / \
        ((mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2))
    return torch.mean(s)


def eval_metrics(sr01: torch.Tensor,
                 hr01: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The eval table: RGB and Y-channel PSNR, and SSIM."""
    return {
        "psnr_rgb": psnr01(sr01, hr01),
        "psnr_y": psnr01(rgb_to_y(sr01), rgb_to_y(hr01)),
        "ssim": ssim(sr01, hr01),
    }


# --------------------------------------------------------------------------
# Scalar aggregation / logging
# --------------------------------------------------------------------------


class MetricLogger:
    """Windowed scalar averaging + JSONL sink + stdout lines +
    tensorboard scalars/images when ``tensorboardX`` is installed (event
    files land in ``<log_dir>/tb``)."""

    def __init__(self, log_dir: Optional[str] = None, stdout: bool = True):
        self._acc: Dict[str, list] = {}
        self._file = None
        self._tb = None
        self._stdout = stdout
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except ImportError:             # tensorboard is optional
                print("[metrics] tensorboardX unavailable — "
                      "JSONL/stdout only")

    def _emit(self, step: int, prefix: str, vals: Dict[str, float]) -> None:
        line = " ".join(f"{k}={v:.4g}" for k, v in sorted(vals.items()))
        if self._stdout:
            print(f"[{prefix} step {step}] {line}", flush=True)
        if self._file:
            self._file.write(json.dumps({"step": step, "prefix": prefix,
                                         **vals}) + "\n")
            self._file.flush()
        if self._tb is not None:
            for k, v in vals.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)

    def log_image(self, step: int, tag: str, image_hwc_uint8) -> None:
        """Tensorboard image (the periodic sample grid); no-op without a
        tensorboard writer."""
        if self._tb is None:
            return
        self._tb.add_image(tag, np.asarray(image_hwc_uint8), step,
                           dataformats="HWC")
        self._tb.flush()

    def update(self, metrics: Dict[str, torch.Tensor]) -> None:
        """Keep a step's metrics (device scalars; nothing is copied to
        the host until :meth:`flush`)."""
        for k, v in metrics.items():
            self._acc.setdefault(k, []).append(v)

    def flush(self, step: int, prefix: str = "train",
              extra: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        out = {k: float(torch.stack([torch.as_tensor(v, dtype=torch.float32)
                                     for v in vs]).mean())
               for k, vs in self._acc.items()}
        self._acc.clear()
        if extra:
            out.update(extra)
        self._emit(step, prefix, out)
        return out

    def log_once(self, step: int, prefix: str,
                 metrics: Dict[str, float]) -> None:
        """Write a one-off metrics line (an eval result) at once, without
        touching the windowed accumulator; non-numeric values are
        dropped."""
        self._emit(step, prefix, {k: float(v) for k, v in metrics.items()
                                  if isinstance(v, (int, float))})

    def close(self):
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


# --------------------------------------------------------------------------
# Spans and counters
# --------------------------------------------------------------------------
#
# One recorder for the process.  Recording is on while a torch profiler
# records (its start and stop hooks below) or inside ``recording()``;
# each time it turns on from off, a fresh report starts.  When it is off
# a span is one flag check and a shared no-op context.

_ON = False                 # read by span() and count() on every call
_PROFILERS = 0              # torch profilers recording now
_DEPTH = 0                  # open recording() contexts
_REPORT = None              # the latest recording's _Report
_LOCK = threading.Lock()
_LOCAL = threading.local()  # .stack: the thread's open spans
_EVENTS: Dict[int, list] = {}   # card index -> idle (start, end) pairs
# resolve finished events past this many: above the benchmark's traced
# parts (at most about 3,800 device spans), which resolve at the end
_DRAIN_EVERY = 8192
# the kernel wrappers whose ``launches`` a report reads in, and their
# modules under ``ops``
_LAUNCH_COUNTERS = {"dense_block": "dense_block",
                    "dense_block_bwd": "dense_block",
                    "fused_dense_block": "dense_block",
                    "conv3x3": "conv3x3",
                    "window_attention": "window_attention"}


def _launches() -> Dict[str, int]:
    return {name: getattr(importlib.import_module(
        f"super_resolution_tpu_torch.ops.{module}"), name).launches
        for name, module in _LAUNCH_COUNTERS.items()}


class _Report:
    """One recording: per span name [calls, host ns, self host ns,
    device ms or None], the counters, the device spans' events still to
    be resolved, and the launch counters where it began."""

    def __init__(self):
        self.spans: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}
        self.pending: list = []
        self.drain_at = _DRAIN_EVERY
        self.launches = _launches()

    def resolve(self, wait: bool) -> None:
        """Add the finished device spans' event times to their rows and
        return the events to the pool; ``wait`` waits for every one."""
        done = 0
        for row, index, start, end in self.pending:
            if wait:
                end.synchronize()
            elif not end.query():
                break
            row[3] += start.elapsed_time(end)
            _EVENTS.setdefault(index, []).append((start, end))
            done += 1
        del self.pending[:done]
        self.drain_at = len(self.pending) + _DRAIN_EVERY


def _update(profilers: int = 0, depth: int = 0) -> None:
    global _ON, _PROFILERS, _DEPTH, _REPORT
    with _LOCK:
        _PROFILERS = max(0, _PROFILERS + profilers)
        _DEPTH += depth
        on = bool(_PROFILERS or _DEPTH)
        if on and not _ON:
            _REPORT = _Report()
        _ON = on


def _hook_profiler() -> None:
    """Follow every torch profiler's start and stop (the hooks
    ``torch.autograd.profiler`` runs around them)."""
    prof = torch.autograd.profiler
    start = getattr(prof, "_run_on_profiler_start", None)
    stop = getattr(prof, "_run_on_profiler_stop", None)
    if start is None or stop is None:
        return

    def on_start():
        start()
        _update(profilers=1)

    def on_stop():
        stop()
        _update(profilers=-1)

    prof._run_on_profiler_start = on_start
    prof._run_on_profiler_stop = on_stop


_hook_profiler()


class _NoSpan:
    """The shared span of recording off (slots and plain methods: the
    cheapest context manager Python runs)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    """A recorded span: a ``record_function`` of its name while a
    profiler records, host time from ``perf_counter_ns``, and on a CUDA
    device a pair of timing events on the current stream."""

    __slots__ = ("name", "stream", "index", "events", "rf", "t0", "child")

    def __init__(self, name: str, device):
        self.name, self.events, self.rf, self.child = name, None, None, 0
        self.stream = None
        if device and torch.device(device).type == "cuda":
            self.stream = torch.cuda.current_stream(device)
            self.index = self.stream.device.index

    def __enter__(self):
        _stack().append(self)
        if _PROFILERS:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.stream is not None:
            try:
                self.events = _EVENTS.setdefault(self.index, []).pop()
            except IndexError:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child += host
        with _LOCK:
            report = _REPORT
            if report is None:
                return False
            row = report.spans.get(self.name)
            if row is None:
                row = report.spans[self.name] = [0, 0, 0, None]
            row[0] += 1
            row[1] += host
            row[2] += host - self.child
            if self.events is not None:
                row[3] = row[3] or 0.0
                report.pending.append((row, self.index, *self.events))
                if len(report.pending) >= report.drain_at:
                    report.resolve(wait=False)
        return False


def span(name: str, device: Union[bool, str, torch.device] = False):
    """A context manager timing its body as span ``name`` while
    recording is on, and a shared no-op otherwise.  ``device``: False
    for host time alone, or the device the body queues its work on: on
    a CUDA device the span also records its device time (timing events
    on the current stream, resolved by :func:`span_report`).  A span's
    parent is the innermost span open on the same thread."""
    if not _ON:
        return _NO_SPAN
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording is on."""
    if not _ON:
        return
    with _LOCK:
        if _REPORT is not None:
            _REPORT.counters[name] = _REPORT.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the body, with or without a
    profiler (a fresh report if recording was off)."""
    _update(depth=1)
    try:
        yield
    finally:
        _update(depth=-1)


def span_report() -> Dict[str, Dict]:
    """The latest recording (from the moment recording last turned on):
    ``{"spans": {name: {"calls", "host_s", "self_host_s"[,
    "device_s"]}}, "counters": {name: n}}``.  ``self_host_s`` is the
    host time less that of the span's children on its thread;
    ``device_s``, of spans on a CUDA device, is the time between their
    events on the stream, read here (call it after a synchronise: it
    waits for the events).  The counters include ``launches.<kernel>``,
    the kernel wrappers' launch counters since the recording began."""
    with _LOCK:
        report = _REPORT
        if report is None:
            return {"spans": {}, "counters": {}}
        report.resolve(wait=True)
        spans = {}
        for name, (calls, host, own, dev_ms) in report.spans.items():
            spans[name] = {"calls": calls, "host_s": host / 1e9,
                           "self_host_s": own / 1e9}
            if dev_ms is not None:
                spans[name]["device_s"] = dev_ms / 1e3
        counters = dict(report.counters)
        for name, n in _launches().items():
            counters[f"launches.{name}"] = n - report.launches[name]
    return {"spans": spans, "counters": counters}


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the body, CPU and (where there is a card)
    CUDA activities, its Chrome trace written into ``log_dir`` as
    ``<host>_<pid>.pt.trace.json`` (the JAX package's
    ``jax.profiler`` trace) and the body's :func:`span_report` beside
    it as ``<host>_<pid>.spans.json``; a no-op for ``None``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    base = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(base + ".pt.trace.json")
        with open(base + ".spans.json", "w") as f:
            json.dump(span_report(), f, indent=1)
        print(f"[profile] trace written to {base}.pt.trace.json, spans to "
              f"{base}.spans.json", flush=True)


class Throughput:
    """Megapixels per second per chip, counting output (HR) pixels, over
    finished work: on a CUDA ``device`` each reading of the clock first
    waits for the device's queued work."""

    def __init__(self, n_chips: int = 1,
                 device: Union[None, str, torch.device] = None):
        self.n_chips = n_chips
        self.device = None if device is None else torch.device(device)
        self.reset()

    def _now(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def reset(self):
        self._pixels = 0
        self._t0 = self._now()

    def add(self, n_pixels: int):
        self._pixels += n_pixels

    def mp_per_sec_per_chip(self) -> float:
        dt = self._now() - self._t0
        return self._pixels / 1e6 / dt / self.n_chips if dt > 0 else 0.0
