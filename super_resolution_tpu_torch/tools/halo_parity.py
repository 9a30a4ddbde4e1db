"""Tiled-vs-whole-frame error against the halo width: the port of the JAX
package's ``tools/halo_parity.py``.

The tiling halo trades overlap recompute for fidelity (stride = tile −
2·halo).  Whether a small halo is admissible depends on the trained
model's effective receptive field, so this probe answers it for a real
checkpoint: whole-frame SR against tiled SR at each candidate halo, the
max and mean absolute error in [0, 1] output space, the uint8-LSB view
and the PSNR of tiled against whole.

    python -m super_resolution_tpu_torch.tools.halo_parity \\
        --checkpoint ck/ [--weights auto|ema|raw] [--frame 256] \\
        [--tile_w 64] [--halos 2,4,6,8,12] [--dtype float32|bfloat16]

``--checkpoint`` is a torch ``.pth`` (any of the three naming families)
or a step directory of ``cli train``; ``--weights auto`` (default)
applies the EMA maturity gate of ``cli eval/upscale/serve``, so the
halo is measured on the weights inference will load.  Orbax directories
are the JAX package's format and are refused.  The probe is
``halo_sweep.structured_probe``; ``--val_dir`` instead scores real
images (HR, LR by bicubic ÷scale): PSNR against the ground truth of the
whole-frame and the tiled SR at each halo.  The default impl is ``lax``
on ``--device cpu`` and ``auto`` on the card; in float32 (the default,
which keeps bf16 rounding out of the measure of truncation) every
forward runs with cuDNN's TF32 off.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from super_resolution_tpu_torch.config import DataConfig
from super_resolution_tpu_torch.tools import (
    launch_counters,
    read_launches,
    reset_launches,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_generator(checkpoint: str, weights: str = "auto"):
    """(state dict, GeneratorConfig) of a ``.pth`` or a ``cli train``
    step directory, the latter's tree picked by ``weights``."""
    from super_resolution_tpu_torch.import_torch import (
        import_generator,
        load_pth,
    )

    if checkpoint.endswith(".pth"):
        return import_generator(load_pth(checkpoint))
    from super_resolution_tpu_torch.checkpoint import restore_generator_params
    from super_resolution_tpu_torch.cli import _train_dir
    from super_resolution_tpu_torch.config import TrainConfig

    if not _train_dir(checkpoint):       # raises for an orbax directory
        raise SystemExit(f"checkpoint not found: {checkpoint!r}")
    kw = {"auto": {"ema_decay": TrainConfig().ema_decay},
          "ema": {},
          "raw": {"prefer_ema": False}}[weights]
    sd, _step = restore_generator_params(checkpoint, **kw)
    return import_generator(sd)


def make_infer(sd, gcfg, dtype: torch.dtype, device: torch.device):
    """The generator's forward (NHWC normalised LR -> SR) in ``dtype``;
    float32 with TF32 off."""
    from super_resolution_tpu_torch.device import no_tf32
    from super_resolution_tpu_torch.models.rrdb import RRDBNet

    model = RRDBNet(gcfg)
    model.load_state_dict(sd, strict=True)
    model = model.to(device).eval().prepare(dtype)
    guard = no_tf32 if dtype == torch.float32 else contextlib.nullcontext

    def infer(x):
        with torch.inference_mode(), guard():
            return model(x)

    return infer


def synthetic_rows(infer, frame: int, tile_w: int, halos: Sequence[int],
                   scale: int, device: torch.device) -> List[Dict]:
    """Per halo: the tiled frame's max and mean |error| against the whole
    frame in [0, 1] space, the waste of the column grid, the PSNR of
    tiled against whole."""
    from super_resolution_tpu_torch.data import normalize
    from super_resolution_tpu_torch.halo_sweep import structured_probe
    from super_resolution_tpu_torch.parallel import tiled_upscale

    dc = DataConfig()
    x = normalize(torch.from_numpy(structured_probe(frame)).to(device),
                  dc.normalize_mean, dc.normalize_std)
    whole = infer(x[None])[0].float().cpu().numpy()
    std = np.asarray(dc.normalize_std, np.float32)
    rows = []
    for halo in halos:
        tiled = tiled_upscale(infer, x, scale=scale, tile=frame,
                              tile_w=tile_w, halo=halo, tile_batch=1)
        err01 = np.abs(tiled.float().cpu().numpy() - whole) * std
        stride = tile_w - 2 * halo
        k = math.ceil((frame - tile_w) / stride) + 1
        rows.append(dict(
            halo=halo, waste=k * tile_w / frame, max=float(err01.max()),
            mean=float(err01.mean()),
            psnr_vs_whole=float(-10.0 * np.log10(np.mean(err01 ** 2)
                                                 + 1e-30))))
    return rows


def val_dir_scores(infer, val_dir: str, tile_w: int, halos: Sequence[int],
                   scale: int, device: torch.device
                   ) -> Tuple[List[float], Dict[int, List[float]]]:
    """(whole-frame PSNR per image, {halo: tiled PSNR per image}) against
    the ground truth."""
    from super_resolution_tpu_torch.data import (
        denormalize,
        list_images,
        normalize,
    )
    from super_resolution_tpu_torch.metrics import psnr01
    from super_resolution_tpu_torch.ops.resize import bicubic_downsample
    from super_resolution_tpu_torch.parallel import tiled_upscale
    from super_resolution_tpu_torch.train.evaluate import _load_image

    dc = DataConfig()
    whole, tiled = [], {h: [] for h in halos}
    for path in list_images(val_dir):
        hr01 = _load_image(path)
        h, w = (hr01.shape[0] // scale) * scale, \
            (hr01.shape[1] // scale) * scale
        hr01 = torch.from_numpy(np.ascontiguousarray(hr01[:h, :w])) \
            .to(device)
        lrn = normalize(bicubic_downsample(hr01, scale), dc.normalize_mean,
                        dc.normalize_std)

        def score(srn):
            sr01 = torch.clamp(denormalize(srn.float(), dc.normalize_mean,
                                           dc.normalize_std), 0.0, 1.0)
            return float(psnr01(sr01, hr01))

        whole.append(score(infer(lrn[None])[0]))
        for halo in halos:
            tiled[halo].append(score(tiled_upscale(
                infer, lrn, scale=scale, tile=h // scale, tile_w=tile_w,
                halo=halo, tile_batch=1)))
    return whole, tiled


def main(argv=None):
    ap = argparse.ArgumentParser(prog="halo_parity")
    ap.add_argument("--checkpoint", required=True,
                    help=".pth or a cli train step directory (trained "
                         "weights: the point of the probe)")
    ap.add_argument("--frame", type=int, default=256,
                    help="square LR frame side; must exceed the tile so "
                         "the grid actually tiles")
    ap.add_argument("--tile_w", type=int, default=64,
                    help="column width (frame-height columns)")
    ap.add_argument("--halos", default="2,4,6,8,12")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="float32 isolates RF truncation from rounding")
    ap.add_argument("--conv_impl", default=None,
                    help="override (default: lax on the CPU, auto on the "
                         "card)")
    ap.add_argument("--val_dir", default=None,
                    help="instead of a synthetic frame, the PSNR against "
                         "the ground truth of whole-frame vs tiled SR on "
                         "real images (treated as HR, LR = bicubic "
                         "÷scale)")
    ap.add_argument("--weights", default="auto",
                    choices=("auto", "ema", "raw"),
                    help="which tree of a step directory to probe: "
                         "'auto' (default) applies the EMA maturity gate "
                         "of the inference CLI; 'ema'/'raw' force one")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    from super_resolution_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    sd, gcfg = load_generator(args.checkpoint, args.weights)
    impl = args.conv_impl or ("lax" if device.type == "cpu" else "auto")
    gcfg = dataclasses.replace(gcfg, conv_impl=impl)
    infer = make_infer(sd, gcfg, _DTYPES[args.dtype], device)
    halos = [int(h) for h in args.halos.split(",")]
    counters = launch_counters()
    reset_launches(counters)

    if args.val_dir:
        whole, tiled = val_dir_scores(infer, args.val_dir, args.tile_w,
                                      halos, gcfg.scale, device)
        ref = float(np.mean(whole))
        print(f"[halo] val_dir={args.val_dir}: whole-frame "
              f"psnr_rgb={ref:.4f} dB "
              f"({len(whole)} images, {args.dtype}, {impl})")
        for halo in halos:
            v = float(np.mean(tiled[halo]))
            print(f"[halo] halo={halo:2d} tile_w={args.tile_w}: "
                  f"psnr_rgb={v:.4f} dB  delta_vs_whole={v - ref:+.4f} dB")
    else:
        rows = synthetic_rows(infer, args.frame, args.tile_w, halos,
                              gcfg.scale, device)
        print(f"[halo] frame {args.frame}² whole-frame reference computed "
              f"({args.dtype}, {impl})")
        for r in rows:
            print(f"[halo] halo={r['halo']:2d} (waste {r['waste']:.4f}x at "
                  f"tile_w={args.tile_w}): max={r['max']:.2e} "
                  f"mean={r['mean']:.2e} "
                  f"uint8_lsb_max={np.ceil(r['max'] * 255):.0f} "
                  f"psnr_vs_whole={r['psnr_vs_whole']:.2f}dB")
    print("launches: " + json.dumps(read_launches(counters)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
