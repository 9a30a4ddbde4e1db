"""Overlap-blend tiled inference for arbitrarily large frames (the JAX
package's ``parallel/tiling.py``), on one device or split over several.

    clamp a T×T tile grid INSIDE the frame (stride S = T − 2h, the last
    row/column shifted inward so every tile is a true sub-window) →
    batch tiles through the generator → multiply by a 2-D blending
    window (linear ramp over the overlaps) → add into the ×r canvas →
    divide by the accumulated weight map of the actual tile offsets.

Clamping, not padding, keeps tiling exact at frame borders: an output
pixel on the frame edge comes only from tiles whose boundary lies on the
frame edge there, so the generator's own SAME zero padding applies as in
whole-frame inference.  Frames that fit in one tile run whole.

Over several devices (the JAX package's tiles sharded over its mesh)
the generator is replicated once per device, each group of
``tile_batch · N`` tiles is split into N batches of ``tile_batch``, one
per replica, and the results are blended on the first device.  The
batches are the single device's, so the frame is the same bit for bit.
The last group is not padded to full size (the port's kernels take
every batch size).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from super_resolution_tpu_torch.metrics import count, span


def _axis_offsets(n: int, tile: int, stride: int) -> tuple:
    """Clamped 1-D tile offsets covering [0, n): multiples of ``stride``
    with the last tile shifted inward to end exactly at ``n``."""
    if n <= tile:
        return (0,)
    k = math.ceil((n - tile) / stride) + 1
    return tuple(min(i * stride, n - tile) for i in range(k))


def plan_tiles(h: int, w: int, tile: int, halo: int,
               tile_w: Optional[int] = None):
    """Tile plan over an H×W LR frame: ((tile_h, tile_w), oys, oxs) —
    per-axis tile sizes (clamped to the frame) and clamped offsets."""
    tile_w = tile if tile_w is None else tile_w
    tile_h = tile
    for t in (tile_h, tile_w):
        if t - 2 * halo <= 0:
            raise ValueError(f"tile {t} must exceed 2*halo ({2 * halo})")
    tile_h, tile_w = min(tile_h, h), min(tile_w, w)
    return ((tile_h, tile_w),
            _axis_offsets(h, tile_h, tile_h - 2 * halo),
            _axis_offsets(w, tile_w, tile_w - 2 * halo))


# Relative generator rate against tile height, for the bucketed height
# planner.  Flat: the H100 knots are still to be measured (ROADMAP.md);
# with every knot at 1.0 the planner minimises tile area alone.
_HEIGHT_RATE_KNOTS = ((128, 1.0), (256, 1.0), (704, 1.0),
                      (1056, 1.0), (2048, 1.0))


def _height_rate(t: int) -> float:
    """Piecewise-linear interpolation of the height-rate curve (clamped
    to the end knots)."""
    knots = _HEIGHT_RATE_KNOTS
    if t <= knots[0][0]:
        return knots[0][1]
    for (h0, r0), (h1, r1) in zip(knots, knots[1:]):
        if t <= h1:
            return r0 + (r1 - r0) * (t - h0) / (h1 - h0)
    return knots[-1][1]


def bucket_tile_h(h: int, tile_h: int, halo: int, bucket: int) -> int:
    """Bucketed tile height: the multiple of ``bucket`` in
    (2*halo, min(tile_h, h)] minimising estimated frame time (clamped-grid
    tile area over the height rate, plus 0.3% per vertical tile), ties
    toward taller tiles.  Falls back to ``min(tile_h, h)`` when no
    multiple fits, and to ``tile_h`` when even that is <= 2*halo."""
    cap = min(tile_h, h)
    best = None
    for t in range(bucket, cap + 1, bucket):
        if t - 2 * halo <= 0:
            continue
        k = 1 if t >= h else math.ceil((h - t) / (t - 2 * halo)) + 1
        cost = (k * t / _height_rate(t)) * (1.0 + 0.003 * k)
        key = (cost, -t)
        if best is None or key < best[0]:
            best = (key, t)
    if best is None:
        return tile_h if cap <= 2 * halo else cap
    return best[1]


def _ramp(t_hr: int, ramp_len: int) -> np.ndarray:
    x = np.arange(t_hr, dtype=np.float32) + 0.5
    if ramp_len > 0:
        w1 = np.clip(x / ramp_len, 0.0, 1.0)
        return np.minimum(w1, np.clip((t_hr - x) / ramp_len, 0.0, 1.0))
    return np.ones_like(x)


def blend_window(tile: int, halo: int, scale: int,
                 tile_w: Optional[int] = None) -> np.ndarray:
    """(T_h·r, T_w·r, 1) HR-resolution weight window: 1 in the core,
    linear ramp 0→1 across the 2h overlap."""
    tile_w = tile if tile_w is None else tile_w
    ramp_len = 2 * halo * scale
    return np.outer(_ramp(tile * scale, ramp_len),
                    _ramp(tile_w * scale, ramp_len))[..., None]


def _weight_profiles(oys: Sequence[int], oxs: Sequence[int], tile_h: int,
                     tile_w: int, halo: int, scale: int, h_hr: int,
                     w_hr: int) -> tuple:
    """Per-axis accumulated blend-weight profiles for the actual offsets:
    the weight canvas is their outer product."""
    ramp_len = 2 * halo * scale

    def profile(offsets, t_hr, n_hr):
        w1 = _ramp(t_hr, ramp_len)
        p = np.zeros(n_hr, np.float32)
        for o in offsets:
            p[o * scale:o * scale + t_hr] += w1
        return p

    return (profile(oys, tile_h * scale, h_hr),
            profile(oxs, tile_w * scale, w_hr))


def extract_tiles(lr: torch.Tensor, tile: int, halo: int,
                  tile_w: Optional[int] = None):
    """(H, W, C) → (n_tiles, T_h, T_w, C), every tile a true sub-window
    of the frame, in row-major grid order."""
    h, w, _ = lr.shape
    (tile_h, tile_w), oys, oxs = plan_tiles(h, w, tile, halo, tile_w)
    tiles = torch.stack([lr[oy:oy + tile_h, ox:ox + tile_w]
                         for oy in oys for ox in oxs])
    return tiles, ((tile_h, tile_w), oys, oxs)


InferFn = Callable[[torch.Tensor], torch.Tensor]


def tiled_upscale(
        infer_fn: Union[InferFn, Sequence[InferFn]],
        lr: torch.Tensor,
        scale: int = 4,
        tile: int = 128,
        halo: int = 8,
        tile_batch: int = 8,
        tile_w: Optional[int] = None,
        align: Optional[tuple] = None,
        bucket_h: Optional[int] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> torch.Tensor:
    """Upscale an (H, W, C) normalised LR frame by ×``scale`` on the
    frame's device.

    ``infer_fn`` maps a normalised (B, T_h, T_w, C) LR batch to the
    (B, T_h·r, T_w·r, C) SR batch; it sees at most ``tile_batch`` tiles
    at a time.  With ``devices`` (N of them), ``infer_fn`` is a sequence
    of N such functions, the i-th a replica on ``devices[i]``: each
    group of ``tile_batch · N`` tiles is split over them, and the frame
    is blended on ``devices[0]``.  ``align=(align_h, align_w)`` clamps
    the effective tile sizes down to multiples of the alignments when the
    frame exceeds them; ``bucket_h`` quantises the tile height
    (:func:`bucket_tile_h`).  Frames that fit in one tile run whole.

    While recording (:mod:`metrics`) the call is the device span
    ``tiling.tiled_upscale``, with children ``tiling.extract``, one
    ``tiling.generator`` per batch call (or the whole-frame call) and
    ``tiling.blend``; it counts the frame's LR pixels
    (``tiling.frame_lr_px``), the LR pixels the generator runs over
    (``tiling.generator_lr_px``: every tile's, or the frame's when it
    runs whole) and the tiles run (``tiling.tiles``, 1 for a whole
    frame)."""
    h, w, _ = lr.shape
    tile_h = tile
    tile_w = tile if tile_w is None else tile_w
    if bucket_h is not None:
        tile_h = bucket_tile_h(h, tile_h, halo, bucket_h)
    if align is not None:
        a_h, a_w = align
        eff_h, eff_w = min(tile_h, h), min(tile_w, w)
        if h > a_h and eff_h % a_h and a_h * (eff_h // a_h) > 2 * halo:
            tile_h = a_h * (eff_h // a_h)
        if w > a_w and eff_w % a_w and a_w * (eff_w // a_w) > 2 * halo:
            tile_w = a_w * (eff_w // a_w)
    if devices is None:
        replicas, devices = [infer_fn], [lr.device]
    else:
        replicas, devices = list(infer_fn), [torch.device(d)
                                             for d in devices]
        if len(replicas) != len(devices):
            raise ValueError(f"{len(replicas)} replicas for "
                             f"{len(devices)} devices")
    count("tiling.frame_lr_px", h * w)
    with span("tiling.tiled_upscale", lr.device):
        if h <= tile_h and w <= tile_w:
            count("tiling.generator_lr_px", h * w)
            count("tiling.tiles")
            with span("tiling.generator", devices[0]):
                return replicas[0](lr[None].to(devices[0]))[0]

        with span("tiling.extract", lr.device):
            tiles, ((tile_h, tile_w), oys, oxs) = extract_tiles(
                lr, tile_h, halo, tile_w)
        count("tiling.generator_lr_px", tiles.shape[0] * tile_h * tile_w)
        count("tiling.tiles", tiles.shape[0])
        batches = [tiles[s:s + tile_batch]
                   for s in range(0, tiles.shape[0], tile_batch)]
        sr_tiles = []
        for g in range(0, len(batches), len(replicas)):
            # every replica's batch is launched before any result is read
            outs = []
            for fn, dev, b in zip(replicas, devices,
                                  batches[g:g + len(replicas)]):
                with span("tiling.generator", dev):
                    outs.append(fn(b.to(dev, non_blocking=True)))
            sr_tiles += [o.to(devices[0]) for o in outs]
        sr_tiles = torch.cat(sr_tiles)
        py, px = _weight_profiles(oys, oxs, tile_h, tile_w, halo, scale,
                                  h * scale, w * scale)
        ramp_len = 2 * halo * scale
        grid = [(oy * scale, ox * scale) for oy in oys for ox in oxs]
        with span("tiling.blend", devices[0]):
            return _blend_scatter(sr_tiles, _ramp(tile_h * scale, ramp_len),
                                  _ramp(tile_w * scale, ramp_len), py, px,
                                  grid, h * scale, w * scale)


def _blend_scatter(sr_tiles: torch.Tensor, wy: np.ndarray, wx: np.ndarray,
                   py: np.ndarray, px: np.ndarray, grid, h_hr: int,
                   w_hr: int) -> torch.Tensor:
    """Window-weight every tile, add them into the canvas in grid order
    (the JAX package's scan order), divide by the offset-exact weight
    map.  Both the window and the map are outer products of 1-D factors,
    so only those cross to the device."""
    dev = sr_tiles.device
    t_h, t_w, c = sr_tiles.shape[1:]
    wy, wx, py, px = (torch.from_numpy(v).to(dev) for v in (wy, wx, py, px))
    window = (wy[:, None] * wx[None, :])[..., None]
    weighted = (sr_tiles * window).float()
    canvas = torch.zeros((h_hr, w_hr, c), dtype=torch.float32, device=dev)
    for t, (oy, ox) in zip(weighted, grid):
        canvas[oy:oy + t_h, ox:ox + t_w] += t
    wmap = (py[:, None] * px[None, :])[..., None]
    return canvas / torch.clamp(wmap, min=1e-8)
