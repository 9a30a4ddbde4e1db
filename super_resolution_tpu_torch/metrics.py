"""Observability of the training loop (the JAX package's ``metrics.py``):
windowed scalar averaging with JSONL, stdout and optional tensorboard
sinks, and the throughput meter.  The image metrics (PSNR/SSIM tables)
come with the eval slice."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


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

    def close(self):
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


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
