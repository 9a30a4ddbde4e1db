"""Observability (the JAX package's ``metrics.py``): the image metrics
of eval (PSNR and SSIM, RGB and Y channel), windowed scalar averaging
with JSONL, stdout and optional tensorboard sinks, the throughput
meter and the profiler trace.

Images keep the JAX package's layout, ``(..., H, W, C)`` in [0, 1].
:func:`ssim` takes its local moments as E[x²] − μ², which cancels: under
TF32 (cuDNN's default for float32 convs, about three decimal digits) it
gives SSIM above 1.  So its Gaussian filter runs inside
:func:`device.no_tf32`, in full float32, as the JAX package pins
``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Dict, Optional

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


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the body, CPU and (where there is a card)
    CUDA activities, its Chrome trace written into ``log_dir`` as
    ``<host>_<pid>.pt.trace.json`` (the JAX package's
    ``jax.profiler`` trace); a no-op for ``None``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}"
                                 ".pt.trace.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        print(f"[profile] trace written to {path}", flush=True)


class Throughput:
    """Megapixels per second per chip, counting output (HR) pixels."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = n_chips
        self.reset()

    def reset(self):
        self._pixels = 0
        self._t0 = time.perf_counter()

    def add(self, n_pixels: int):
        self._pixels += n_pixels

    def mp_per_sec_per_chip(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._pixels / 1e6 / dt / self.n_chips if dt > 0 else 0.0
