"""End-to-end training demonstration: the port of the JAX package's
``tools/demo_train_eval.py``.

Synthesizes a structured-texture dataset (piecewise-smooth shapes with
edges: learnable SR structure, no external data), pretrains the
canonical 23-block RRDBNet with the PSNR/L1 objective, then (with
``--gan_steps``) runs the ESRGAN pretrain -> GAN recipe with the
discriminator-feature-matching perceptual loss (no VGG asset), and
compares bicubic / PSNR model / GAN model (and its EMA) on the held-out
images: PSNR, SSIM and edge sharpness (mean gradient magnitude, which
the adversarial phase should raise while L1-only training stays
blurry).  The models tile through ``make_infer_fn`` + ``tiled_upscale``
at tile 96, halo 8.  Writes a side-by-side comparison strip per val
image (the first four), then the kernel launches of the run by counter.

    python -m super_resolution_tpu_torch.tools.demo_train_eval \\
        [--steps 2000] [--gan_steps 1500] [--out DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from super_resolution_tpu_torch.tools import (
    launch_counters,
    read_launches,
    reset_launches,
)


def make_dataset(root: str, n_train: int = 100, n_val: int = 10,
                 size: int = 384, seed: int = 0) -> None:
    from PIL import Image, ImageDraw

    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            # smooth background gradient
            gy, gx = np.mgrid[0:size, 0:size].astype(np.float32) / size
            a, b, c = rng.rand(3)
            base = np.stack([
                (a * gx + (1 - a) * gy),
                (b * (1 - gx) + (1 - b) * gy),
                (c * gx * gy + (1 - c) * 0.5)], -1)
            img = Image.fromarray(
                (base * 200 + 27).astype(np.uint8), "RGB")
            draw = ImageDraw.Draw(img)
            # sharp-edged shapes at random scales (the SR-learnable part)
            for _ in range(rng.randint(20, 40)):
                x0, y0 = rng.randint(0, size - 8, 2)
                w, h = rng.randint(4, size // 3, 2)
                color = tuple(int(v) for v in rng.randint(0, 256, 3))
                if rng.rand() < 0.5:
                    draw.ellipse([x0, y0, x0 + w, y0 + h], outline=color,
                                 width=rng.randint(1, 4))
                else:
                    draw.rectangle([x0, y0, x0 + w, y0 + h], fill=color
                                   if rng.rand() < 0.5 else None,
                                   outline=color, width=rng.randint(1, 3))
            img.save(os.path.join(d, f"im{i:03d}.png"))


def sharpness(img01: torch.Tensor) -> float:
    """Mean gradient magnitude: the edge energy the GAN phase should raise
    over the L1-blurry PSNR model."""
    gy = torch.abs(torch.diff(img01, dim=0)).mean()
    gx = torch.abs(torch.diff(img01, dim=1)).mean()
    return float(gy + gx)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="demo_train_eval")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--gan_steps", type=int, default=0,
                    help="GAN phase length (0 = pretrain only)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "srdemo"))
    ap.add_argument("--blocks", type=int, default=23)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--skip_pretrain", action="store_true",
                    help="reuse the existing pretrain checkpoint")
    ap.add_argument("--gan_pixel", type=float, default=1e-2,
                    help="lambda_pixel for the GAN phase (the ESRGAN "
                         "default 1e-2 assumes a FIXED VGG feature space; "
                         "the D-feature substitute is nonstationary and "
                         "needs a stronger pixel anchor)")
    ap.add_argument("--gan_lr_d", type=float, default=1e-4)
    ap.add_argument("--gan_suffix", default="",
                    help="suffix for the GAN checkpoint/log dirs (ablations)")
    ap.add_argument("--conv_impl", default="lax",
                    choices=("lax", "pallas_cf"),
                    help="generator conv path (pallas_cf = the dense-block "
                         "kernels, forward and backward)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)

    from PIL import Image

    from super_resolution_tpu_torch.checkpoint import restore_generator_params
    from super_resolution_tpu_torch.config import (
        DataConfig,
        GeneratorConfig,
        LossConfig,
        OptimConfig,
        preset,
    )
    from super_resolution_tpu_torch.data import (
        denormalize,
        list_images,
        normalize,
    )
    from super_resolution_tpu_torch.device import resolve_device
    from super_resolution_tpu_torch.metrics import eval_metrics
    from super_resolution_tpu_torch.ops.resize import (
        bicubic_downsample,
        bicubic_resize,
    )
    from super_resolution_tpu_torch.parallel import tiled_upscale
    from super_resolution_tpu_torch.train import train
    from super_resolution_tpu_torch.train.evaluate import _load_image
    from super_resolution_tpu_torch.train.steps import make_infer_fn

    device = resolve_device(args.device)
    counters = launch_counters()
    reset_launches(counters)
    root = args.out
    if not os.path.isdir(os.path.join(root, "train")):
        print("[demo] generating dataset...")
        make_dataset(root)

    cfg = preset("pretrain_psnr")
    cfg = dataclasses.replace(
        cfg,
        generator=GeneratorConfig(n_blocks=args.blocks,
                                  conv_impl=args.conv_impl),
        data=DataConfig(dataset_dir=os.path.join(root, "train"),
                        hr_patch=192, batch_size=args.batch, n_workers=4),
        checkpoint_dir=os.path.join(root, "ck"),
        checkpoint_interval=args.steps,
        sample_interval=max(200, args.steps // 4),
    )

    val_dir = os.path.join(root, "val")
    if args.skip_pretrain and os.path.isdir(cfg.checkpoint_dir):
        print("[demo] skipping pretrain (reusing checkpoint)")
    else:
        print(f"[demo] training {args.steps} steps "
              f"({args.blocks}-block RRDBNet, batch {args.batch} @192²)...")
        train(cfg, total_steps=args.steps,
              log_dir=os.path.join(root, "logs"),
              sample_dir=os.path.join(root, "samples"),
              eval_dir=val_dir,
              eval_interval=max(500, args.steps // 2), device=device)

    models = {}          # name -> the generator's state dict
    # maturity-gated: a pretrain shorter than 5/(1-decay) steps gets the
    # raw parameters, its EMA still remembering the random init
    models["psnr"], _ = restore_generator_params(
        cfg.checkpoint_dir, ema_decay=cfg.ema_decay)

    if args.gan_steps > 0:
        gan_cfg = dataclasses.replace(
            preset("train_gan"),
            generator=GeneratorConfig(n_blocks=args.blocks,
                                      conv_impl=args.conv_impl),
            data=cfg.data,
            loss=LossConfig(perceptual_source="d_features",
                            lambda_percep=1.0,
                            lambda_pixel=args.gan_pixel),
            optim_g=OptimConfig(lr=1e-4),
            optim_d=OptimConfig(lr=args.gan_lr_d),
            warmup_batches=0,
            checkpoint_dir=os.path.join(root, "ck_gan" + args.gan_suffix),
            checkpoint_interval=args.gan_steps,
            sample_interval=max(200, args.gan_steps // 4),
        )
        print(f"[demo] GAN phase: {args.gan_steps} steps "
              "(RaGAN + D-feature-matching perceptual, warm-started "
              "from the PSNR checkpoint)...")
        gan_state = train(gan_cfg, total_steps=args.gan_steps,
                          init_g_from=cfg.checkpoint_dir,
                          log_dir=os.path.join(root,
                                               "logs_gan" + args.gan_suffix),
                          sample_dir=os.path.join(
                              root, "samples_gan" + args.gan_suffix),
                          eval_dir=val_dir,
                          eval_interval=max(250, args.gan_steps // 4),
                          device=device)
        models["gan"] = {k: v.detach().clone()
                         for k, v in gan_state.g.state_dict().items()}
        if gan_state.g_ema is not None:
            # the release shape (cli export): the decay-0.999 weight
            # average beside the raw parameters
            models["gan_ema"] = gan_state.g_ema

    def load_hr(path):
        hr01 = _load_image(path)
        h, w = (hr01.shape[0] // 4) * 4, (hr01.shape[1] // 4) * 4
        return torch.from_numpy(np.ascontiguousarray(hr01[:h, :w])) \
            .to(device), h, w

    # ---- comparison: bicubic vs every trained model ----
    print("[demo] final eval on held-out images")
    rows = {}
    bic_scores, hr_sharp = [], []
    for path in list_images(val_dir):
        hr01, h, w = load_hr(path)
        up = torch.clamp(bicubic_resize(bicubic_downsample(hr01, 4), h, w),
                         0.0, 1.0)
        m = {k: float(v) for k, v in eval_metrics(up, hr01).items()}
        m["sharpness"] = sharpness(up)
        bic_scores.append(m)
        hr_sharp.append(sharpness(hr01))
    rows["bicubic"] = {k: float(np.mean([s[k] for s in bic_scores]))
                       for k in bic_scores[0]}

    sr_images = {}
    mean, std = cfg.data.normalize_mean, cfg.data.normalize_std
    for name, params in models.items():
        scores = []
        infer = make_infer_fn(cfg, params, device)
        for path in list_images(val_dir):
            hr01, h, w = load_hr(path)
            lrn = normalize(bicubic_downsample(hr01, 4), mean, std)
            srn = tiled_upscale(infer, lrn, tile=96, halo=8)
            sr01 = torch.clamp(denormalize(srn.float(), mean, std), 0.0, 1.0)
            m = {k: float(v) for k, v in eval_metrics(sr01, hr01).items()}
            m["sharpness"] = sharpness(sr01)
            scores.append(m)
            sr_images.setdefault(path, {})[name] = sr01.cpu().numpy()
        rows[name] = {k: float(np.mean([s[k] for s in scores]))
                      for k in scores[0]}

    print(f"[demo] HR ground-truth sharpness: {np.mean(hr_sharp):.4f}")
    for name, m in rows.items():
        print(f"[demo] {name:8s}: " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(m.items())))
    if "psnr" in rows:
        delta = rows["psnr"]["psnr_rgb"] - rows["bicubic"]["psnr_rgb"]
        print(f"[demo] PSNR-model gain over bicubic: {delta:+.3f} dB "
              f"({'SUCCESS' if delta > 0 else 'NOT YET'})")
    if "gan" in rows:
        ds = rows["gan"]["sharpness"] - rows["psnr"]["sharpness"]
        print(f"[demo] GAN sharpness gain over PSNR model: {ds:+.4f} "
              f"(HR={np.mean(hr_sharp):.4f}; "
              f"{'SHARPENED' if ds > 0 else 'NOT SHARPER'})")

    # side-by-side comparison PNGs: bicubic | psnr | (gan) | HR crop
    cmp_dir = os.path.join(root, "compare")
    os.makedirs(cmp_dir, exist_ok=True)
    for path in list(sr_images)[:4]:
        hr01, h, w = load_hr(path)
        up = torch.clamp(bicubic_resize(bicubic_downsample(hr01, 4), h, w),
                         0.0, 1.0).cpu().numpy()
        panels = [up] + [sr_images[path][n] for n in models] \
            + [hr01.cpu().numpy()]
        ch, cw = min(256, h), min(256, w)
        strip = np.concatenate([p[:ch, :cw] for p in panels], axis=1)
        Image.fromarray((strip * 255).astype(np.uint8)).save(
            os.path.join(cmp_dir, os.path.basename(path)))
    print(f"[demo] comparison strips (bicubic|{'|'.join(models)}|HR) "
          f"in {cmp_dir}")
    print("launches: " + json.dumps(read_launches(counters)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
