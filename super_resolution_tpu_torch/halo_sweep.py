"""Checkpoint-conditioned halo admissibility (the JAX package's
``halo_sweep.py``): the sweep, the release metadata, and the read side
that ``--halo auto`` uses.

The tiling halo trades overlap recompute for fidelity (stride = tile −
2·halo).  Whether a small halo is admissible is a property of the
released checkpoint's trained weights, so it is decided once per
checkpoint at release time:

- :func:`sweep_admissible_halo` measures tiled-vs-whole deviation on a
  structured synthetic probe for each candidate halo and picks the
  smallest one whose deviation PSNR clears a threshold (default 55 dB,
  which moves a ~25 dB PSNR-vs-ground-truth by ~0.005 dB);
- :func:`val_dir_contract` records, on real images, how much the tiled
  path at that halo moves PSNR against the ground truth;
- :func:`write_halo_meta` / :func:`read_halo_meta` keep the result in a
  JSON sidecar next to the release (``<release>.pth.meta.json``;
  ``<dir>/release_meta.json``), with the JAX package's keys and
  rounding, so a sidecar written by either package reads the same in
  both.

``cli export`` runs the sweep with an fp32 ``conv_impl="lax"`` forward
(cuDNN, TF32 off) on ``--device``: like the JAX package's CPU sweep it
isolates the truncation of the receptive field from kernel and bf16
rounding.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from super_resolution_tpu_torch.config import DataConfig
from super_resolution_tpu_torch.data import (
    denormalize,
    list_images,
    normalize,
)
from super_resolution_tpu_torch.device import resolve_device
from super_resolution_tpu_torch.metrics import psnr01
from super_resolution_tpu_torch.ops.resize import bicubic_downsample
from super_resolution_tpu_torch.parallel import tiled_upscale


def structured_probe(frame: int, seed: int = 0) -> np.ndarray:
    """(frame, frame, 3) float32 probe in [0, 1]: gradients + sinusoidal
    texture + light noise.  Structured content, not white noise: tiling
    error concentrates at edges, and white noise has none of the
    statistics trained weights respond to."""
    rng = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:frame, 0:frame].astype(np.float32)
    img = np.stack([gx, gy, (gx + gy) / 2], -1) / frame
    img += 0.25 * np.sin(gx[..., None] / 3.1) * np.cos(gy[..., None] / 4.7)
    return np.clip(img + rng.rand(frame, frame, 3) * 0.05,
                   0, 1).astype(np.float32)


def sweep_admissible_halo(
        infer_fn: Callable[[torch.Tensor], torch.Tensor],
        scale: int = 4,
        frame: int = 192,
        tile_w: int = 64,
        halos: Sequence[int] = (2, 4, 6, 8),
        threshold_db: float = 55.0,
        denorm_std=None,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
) -> dict:
    """Measure tiled-vs-whole deviation per halo and pick the minimal
    admissible one.

    ``infer_fn``: normalised (B, H, W, C) LR → (B, H·r, W·r, C) SR on
    ``device``, with the CHECKPOINT's weights (on random weights, whose
    effective receptive field is much shorter, the sweep means nothing).
    The probe is column-tiled (``tile_w`` wide, full height), so the
    deviation comes from horizontal truncation alone.  Returns the
    metadata dict; ``admissible_halo`` is None when no candidate clears
    ``threshold_db``."""
    if frame <= tile_w:
        raise ValueError(f"probe frame ({frame}) must exceed tile_w "
                         f"({tile_w}) so the grid actually tiles")
    device = resolve_device(device)
    dc = DataConfig()
    std = np.asarray(dc.normalize_std if denorm_std is None else denorm_std,
                     np.float32)
    x = normalize(torch.from_numpy(structured_probe(frame, seed)).to(device),
                  dc.normalize_mean, dc.normalize_std)
    whole = infer_fn(x[None])[0].float().cpu().numpy()

    rows = []
    for halo in sorted(halos):
        tiled = tiled_upscale(infer_fn, x, scale=scale, tile=frame,
                              tile_w=tile_w, halo=halo, tile_batch=1)
        err01 = np.abs(tiled.float().cpu().numpy() - whole) * std
        psnr = float(-10.0 * np.log10(np.mean(err01 ** 2) + 1e-30))
        rows.append({
            "halo": int(halo),
            "psnr_vs_whole_db": round(psnr, 2),
            "max_err01": float(err01.max()),
            "mean_err01": float(err01.mean()),
            "uint8_lsb_max": int(math.ceil(float(err01.max()) * 255)),
        })
    return {
        "admissible_halo": select_admissible(rows, threshold_db),
        "threshold_db": threshold_db,
        "frame": int(frame),
        "tile_w": int(tile_w),
        "scale": int(scale),
        "method": "structured_probe_sweep",
        "sweep": rows,
    }


def select_admissible(rows: Sequence[dict],
                      threshold_db: float) -> Optional[int]:
    """Smallest halo of the LARGEST passing suffix of the (halo-sorted)
    sweep rows.  Deviation should not grow with the halo, so a small
    halo that passes while a larger one fails is probe noise near the
    threshold: the pick and every larger candidate must clear it."""
    admissible = None
    for row in sorted(rows, key=lambda r: r["halo"], reverse=True):
        if row["psnr_vs_whole_db"] >= threshold_db:
            admissible = int(row["halo"])
        else:
            break
    return admissible


def val_dir_contract(
        infer_fn: Callable[[torch.Tensor], torch.Tensor],
        val_dir: str,
        scale: int,
        halo: int,
        tile_w: int = 64,
        max_images: int = 4,
        device: Union[str, torch.device] = "cuda",
) -> dict:
    """Admissibility on REAL images: mean PSNR against the ground truth
    of whole-frame and of tiled SR at ``halo`` (images taken as HR, LR
    the PIL-parity bicubic ÷scale), and their delta, for the release
    sidecar.  Images whose LR has at most 2·halo rows cannot be tiled
    and are skipped with a message."""
    from super_resolution_tpu_torch.train.evaluate import _load_image

    device = resolve_device(device)
    dc = DataConfig()
    whole_db, tiled_db = [], []
    n_used = 0
    for path in list_images(val_dir):
        if n_used >= max_images:
            break
        hr01 = _load_image(path)
        h, w = (hr01.shape[0] // scale) * scale, \
            (hr01.shape[1] // scale) * scale
        # the tiled pass needs LR height above 2*halo (plan_tiles):
        # skip a small image rather than lose the sweep's result
        if h // scale <= 2 * halo or w // scale < 1:
            print(f"[halo] val contract: skipping {path} — LR "
                  f"{w // scale}x{h // scale} too small to tile at "
                  f"halo={halo}")
            continue
        hr = torch.from_numpy(np.ascontiguousarray(hr01[:h, :w])).to(device)
        lrn = normalize(bicubic_downsample(hr, scale),
                        dc.normalize_mean, dc.normalize_std)

        def score(srn):
            sr01 = torch.clamp(denormalize(srn, dc.normalize_mean,
                                           dc.normalize_std), 0.0, 1.0)
            return float(psnr01(sr01, hr))

        whole_db.append(score(infer_fn(lrn[None])[0]))
        tiled_db.append(score(tiled_upscale(
            infer_fn, lrn, scale=scale, tile=h // scale,
            tile_w=tile_w, halo=halo, tile_batch=1)))
        n_used += 1
    if not whole_db:
        return {
            "val_dir": os.path.abspath(val_dir),
            "n_images": 0,
            "halo": int(halo),
            "tile_w": int(tile_w),
            "note": "no val image large enough to tile at this halo",
        }
    mw = float(np.mean(whole_db))
    mt = float(np.mean(tiled_db))
    return {
        "val_dir": os.path.abspath(val_dir),
        "n_images": n_used,
        "halo": int(halo),
        "tile_w": int(tile_w),
        "psnr_gt_whole_db": round(mw, 4),
        "psnr_gt_tiled_db": round(mt, 4),
        "delta_db": round(mt - mw, 4),
    }


def halo_meta_path(checkpoint: str) -> str:
    """Sidecar location for a checkpoint's release metadata: a JSON next
    to a file artifact, inside a checkpoint directory."""
    if os.path.isdir(checkpoint):
        return os.path.join(checkpoint, "release_meta.json")
    return checkpoint + ".meta.json"


def write_halo_meta(checkpoint: str, meta: dict) -> str:
    path = halo_meta_path(checkpoint)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
        f.write("\n")
    return path


def read_halo_meta(checkpoint: str) -> Optional[dict]:
    path = halo_meta_path(checkpoint)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def read_admissible_halo(checkpoint: str) -> Optional[int]:
    """The stamped admissible halo for ``checkpoint``, or None when no
    metadata exists (or the sweep found no candidate admissible)."""
    meta = read_halo_meta(checkpoint)
    if not meta:
        return None
    halo = meta.get("admissible_halo")
    return None if halo is None else int(halo)
