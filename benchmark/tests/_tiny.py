"""Tiny cells for the CPU tests: the real configurations and mixes at a
width, depth and frame size a test run holds, in float32 (the port's
plain versions on the CPU), with the cells' own limits."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.lib import harness

CPU = torch.device("cpu")


def frame_cell(name: str = "esrgan_x4_rrdb23.frame2k",
               dtype: str = "float32") -> harness.Cell:
    """float32 at width 16: the program's plain path agrees with the
    reference to rounding.  bfloat16 at the published widths and two
    blocks: the configuration's precision, for the control's test."""
    cell = harness.load_cell(name)
    size = (dict(n_blocks=1, filters=16, growth=8) if dtype == "float32"
            else dict(n_blocks=2))
    return dataclasses.replace(
        cell,
        config=dict(cell.config, compute_dtype=dtype, **size),
        traffic=dict(cell.traffic, tile=32, halo=4, warmup_frames=3,
                     trace_count=3,
                     sizes=[{"w": 40, "h": 48, "per_cycle": 2},
                            {"w": 20, "h": 20, "per_cycle": 1}]))


def train_cell(batch: int = 2) -> harness.Cell:
    cell = harness.load_cell("esrgan_x4_rrdb23.train_gan")
    cfg = cell.config
    return dataclasses.replace(
        cell,
        config=dict(cfg, n_blocks=1, filters=16, growth=8,
                    compute_dtype="float32",
                    training=dict(cfg["training"], hr_patch=32)),
        traffic=dict(cell.traffic, batch=batch, pool=3, warmup_steps=1,
                     trace_count=2))
