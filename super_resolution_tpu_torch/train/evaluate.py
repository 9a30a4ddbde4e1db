"""Dataset evaluation: PSNR/SSIM tables over a validation directory (the
JAX package's ``train/evaluate.py``), RGB and Y channel both.

Each HR image is bicubic-downsampled ÷scale (the LR synthesis of the
reference's eval), super-resolved through the overlap-blend tiler on the
generator's ``conv_impl`` path, and scored against the ground truth in
[0, 1].  The JAX package clamps tiles to (8, 128) multiples for its TPU
kernels; the port's kernels take every tile shape, so it does not.
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Union)

import numpy as np
import torch

from super_resolution_tpu_torch.config import TrainConfig
from super_resolution_tpu_torch.data import denormalize, list_images, normalize
from super_resolution_tpu_torch.device import resolve_device
from super_resolution_tpu_torch.metrics import eval_metrics
from super_resolution_tpu_torch.ops.resize import bicubic_downsample
from super_resolution_tpu_torch.parallel import tiled_upscale


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def evaluate_directory(
        cfg: TrainConfig, g_params: Optional[Dict[str, torch.Tensor]],
        val_dir: str,
        tile: int = 128, halo: int = 8, tile_batch: int = 4,
        max_images: Optional[int] = None,
        files: Optional[Iterable[str]] = None,
        infer_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        use_self_ensemble: bool = False,
        lr_dir: Optional[str] = None,
        tile_w: Optional[int] = None,
        bucket_h: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        ) -> Dict[str, float]:
    """Evaluate G over every image in ``val_dir`` on ``device``; returns
    the mean metrics and ``n_images``.

    With ``lr_dir``, each HR image's LR input comes from the paired file
    (matched by stem) instead of being bicubic-synthesized.

    ``infer_fn`` is a ready forward of the generator (normalised NHWC LR
    → SR on ``device``, as ``train.steps.make_infer_fn`` builds); when
    it is given ``g_params`` is not read.  Without it the forward is
    built from ``g_params`` (the port's state dict) and ``cfg``.  With
    ``devices`` (the first is ``device``) the tiles of a frame are split
    over one replica per device (``parallel.tiling.tiled_upscale``), and
    ``infer_fn``, if given, is the sequence of the replicas."""
    device = resolve_device(device)
    scale = cfg.data.scale
    mean, std = cfg.data.normalize_mean, cfg.data.normalize_std
    if infer_fn is None:
        from super_resolution_tpu_torch.train.steps import make_infer_fn

        infer_fn = make_infer_fn(cfg, g_params, device) if devices is None \
            else [make_infer_fn(cfg, g_params, d) for d in devices]

    lr_for = None
    if lr_dir is not None:
        from super_resolution_tpu_torch.data import pair_images

        lr_for = dict(pair_images(val_dir, lr_dir))

    paths: List[str] = list(files) if files is not None \
        else list_images(val_dir)
    if max_images:
        paths = paths[:max_images]

    def upscale(img):
        return tiled_upscale(infer_fn, img, scale=scale, tile=tile,
                             halo=halo, tile_batch=tile_batch, tile_w=tile_w,
                             bucket_h=bucket_h, devices=devices)

    per_image = []
    for path in paths:
        hr01 = _load_image(path)
        if lr_for is not None:
            lr01 = torch.from_numpy(_load_image(lr_for[path])).to(device)
            h, w = lr01.shape[0] * scale, lr01.shape[1] * scale
            if hr01.shape[0] < h or hr01.shape[1] < w:
                raise ValueError(
                    f"paired eval: HR {hr01.shape[:2]} smaller than "
                    f"LR×{scale} {(h, w)} for {path}")
            hr = torch.from_numpy(np.ascontiguousarray(hr01[:h, :w]))
            hr = hr.to(device)
        else:
            h, w = (hr01.shape[0] // scale) * scale, \
                   (hr01.shape[1] // scale) * scale
            hr = torch.from_numpy(np.ascontiguousarray(hr01[:h, :w]))
            hr = hr.to(device)
            lr01 = bicubic_downsample(hr, scale)
        lrn = normalize(lr01, mean, std)
        if use_self_ensemble:
            from super_resolution_tpu_torch.ops import self_ensemble

            srn = self_ensemble(upscale, lrn)
        else:
            srn = upscale(lrn)
        sr01 = torch.clamp(denormalize(srn, mean, std), 0.0, 1.0)
        m = eval_metrics(sr01, hr)
        per_image.append({k: float(v) for k, v in m.items()})

    agg = {k: float(np.mean([m[k] for m in per_image]))
           for k in per_image[0]} if per_image else {}
    agg["n_images"] = len(per_image)
    return agg
