"""CLI of the port: the ``train``, ``upscale`` and ``serve`` subcommands
of the JAX package's CLI, with the same flags, running on the card.

    python -m super_resolution_tpu_torch.cli train --dataset_dir data/train \
        --preset train_gan_dfm --checkpoint_dir ck/
    python -m super_resolution_tpu_torch.cli upscale --image frame.png \
        --checkpoint gen.pth --out sr.png
    python -m super_resolution_tpu_torch.cli serve --checkpoint gen.pth \
        --watch in/ --out sr/

``--device`` (default ``cuda``) picks where the model runs; asking for
``cuda`` on a machine without a card raises, and ``--device cpu`` runs
every kernel's plain version on the CPU.  Checkpoints are torch ``.pth``
files in any of the three naming families, or a checkpoint directory
written by ``train``; orbax directories are the JAX package's format and
are refused.  ``--data_parallel`` above 1, ``--multihost``,
``--loader grain``, ``--profile_dir`` and ``--eval_dir`` are accepted by
the parser and raise: they are not ported yet (ROADMAP.md).
``--conv_impl`` picks the conv path by the JAX package's names (``auto``
= ``pallas_cf``, ``pallas_cf_tail``, ``pallas``, ``pallas_fused``, and
``lax``: cuDNN, no kernel of the port) for ``upscale``, ``serve`` and
``train``; a checkpoint sets the architecture, never the impl.  Default
tile geometry: square 384, no height bucket, no alignment under every
impl: the port's kernels take every tile shape, so the JAX package's
(8, 128) clamp for its TPU kernels' bands is not carried over (the H100
geometry sweep is a ROADMAP item).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def _build_cfg(args):
    from super_resolution_tpu_torch.config import (
        OptimConfig,
        TrainConfig,
        preset,
    )

    cfg = preset(args.preset) if args.preset else TrainConfig()

    def ov(name, cur):
        """CLI value if given, else the preset/default value: flags a
        preset may set default to None, so an argparse default cannot
        clobber a --preset."""
        v = getattr(args, name, None)
        return cur if v is None else v

    gen = dataclasses.replace(
        cfg.generator,
        n_blocks=ov("residual_blocks", cfg.generator.n_blocks),
        channels=ov("channels", cfg.generator.channels),
        upsampler=ov("upsampler", cfg.generator.upsampler),
        conv_impl=ov("conv_impl", cfg.generator.conv_impl),
    )
    data = dataclasses.replace(
        cfg.data,
        dataset_dir=ov("dataset_dir", cfg.data.dataset_dir),
        lr_dir=ov("lr_dir", cfg.data.lr_dir),
        hr_patch=ov("hr_height", cfg.data.hr_patch),
        hr_patch_w=ov("hr_width", cfg.data.hr_patch_w),
        batch_size=ov("batch_size", cfg.data.batch_size),
        n_workers=ov("n_cpu", cfg.data.n_workers),
    )
    loss = dataclasses.replace(
        cfg.loss,
        lambda_adv=ov("lambda_adv", cfg.loss.lambda_adv),
        lambda_pixel=ov("lambda_pixel", cfg.loss.lambda_pixel),
        lambda_percep=ov("lambda_percep", cfg.loss.lambda_percep),
        perceptual_source=ov("perceptual_source",
                             cfg.loss.perceptual_source),
        ragan_g_two_sided=cfg.loss.ragan_g_two_sided
        or bool(getattr(args, "ragan_two_sided", False)),
        use_perceptual=cfg.loss.use_perceptual
        and not getattr(args, "no_perceptual", False),
    )

    def opt_with_flags(cur: OptimConfig) -> OptimConfig:
        """Overlay the flags on a preset's optimizer config; flags that
        were not passed keep the preset's values."""
        halve = getattr(args, "lr_halve_steps", None)
        return dataclasses.replace(
            cur, lr=ov("lr", cur.lr), b1=ov("b1", cur.b1),
            b2=ov("b2", cur.b2),
            lr_halve_steps=cur.lr_halve_steps if halve is None
            else tuple(halve))

    return dataclasses.replace(
        cfg, generator=gen, data=data, loss=loss,
        optim_g=opt_with_flags(cfg.optim_g),
        optim_d=opt_with_flags(cfg.optim_d),
        n_epochs=ov("n_epochs", cfg.n_epochs),
        warmup_batches=ov("warmup_batches", cfg.warmup_batches),
        sample_interval=ov("sample_interval", cfg.sample_interval),
        checkpoint_interval=ov("checkpoint_interval",
                               cfg.checkpoint_interval),
        checkpoint_dir=ov("checkpoint_dir", cfg.checkpoint_dir),
        compute_dtype=ov("dtype", cfg.compute_dtype),
        data_parallel=ov("data_parallel", cfg.data_parallel),
        seed=ov("seed", cfg.seed),
        vgg=dataclasses.replace(cfg.vgg, weights_path=args.vgg_weights)
        if getattr(args, "vgg_weights", None) else cfg.vgg,
    )


def _load_generator(args, cfg):
    """(port state dict, cfg with the checkpoint's architecture)."""
    from super_resolution_tpu_torch.import_torch import (
        import_generator,
        load_pth,
    )

    path = args.checkpoint
    if os.path.isdir(path):
        from super_resolution_tpu_torch.checkpoint import (
            latest_step,
            restore_generator_params,
        )

        if latest_step(path) is not None:      # written by `train`
            sd, _ = restore_generator_params(path,
                                             ema_decay=cfg.ema_decay)
            sd, gen_cfg = import_generator(sd)
            gen_cfg = dataclasses.replace(
                gen_cfg, conv_impl=cfg.generator.conv_impl,
                tail_up=cfg.generator.tail_up,
                lrelu_slope=cfg.generator.lrelu_slope)
            return sd, dataclasses.replace(cfg, generator=gen_cfg)
        raise SystemExit(
            f"{path!r} is a directory: orbax checkpoints are the JAX "
            f"package's format; export one to .pth with "
            f"`python -m super_resolution_tpu.cli export` first")
    if not os.path.isfile(path):
        raise SystemExit(f"checkpoint not found: {path!r} (expected a "
                         f"torch .pth file)")
    sd, gen_cfg = import_generator(load_pth(path),
                                   strict=not args.lenient_import)
    # the checkpoint determines the architecture, the command line keeps
    # its runtime knobs
    gen_cfg = dataclasses.replace(gen_cfg,
                                  conv_impl=cfg.generator.conv_impl,
                                  tail_up=cfg.generator.tail_up)
    return sd, dataclasses.replace(cfg, generator=gen_cfg)


def _halo_arg(v: str):
    """argparse type for ``--halo``: an int or the literal 'auto'."""
    if v.lower() == "auto":
        return "auto"
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {v!r}")


def _resolve_halo(args) -> int:
    """``--halo`` as an int; ``auto`` reads the checkpoint's stamped
    admissible halo, falling back to the conservative 8."""
    if args.halo != "auto":
        return int(args.halo)
    from super_resolution_tpu_torch.halo_sweep import (
        halo_meta_path,
        read_halo_meta,
    )

    meta = read_halo_meta(args.checkpoint)
    if meta is None:
        print(f"[cli] --halo auto: no release-metadata sidecar at "
              f"{halo_meta_path(args.checkpoint)} — using conservative "
              f"halo=8")
        return 8
    halo = meta.get("admissible_halo")
    if halo is None:
        print(f"[cli] --halo auto: sidecar "
              f"{halo_meta_path(args.checkpoint)} exists but its sweep "
              f"found NO admissible halo (threshold "
              f"{meta.get('threshold_db')} dB) — using conservative halo=8")
        return 8
    print(f"[cli] --halo auto: halo={int(halo)} from release metadata")
    return int(halo)


def _resolve_tile_geometry(args):
    """(tile, tile_w, bucket_h): square 384 with no height bucket unless
    the flags say otherwise (``--tile_bucket 0`` also means none)."""
    tile = args.tile if args.tile is not None else 384
    bucket = args.tile_bucket or None
    return tile, args.tile_w, bucket


def _add_tile_flags(p: argparse.ArgumentParser):
    p.add_argument("--tile", type=int, default=None,
                   help="tile height incl. overlap (default 384)")
    p.add_argument("--halo", type=_halo_arg, default="auto",
                   help="tile overlap halo (int), or 'auto' (default): "
                        "the checkpoint's stamped admissible halo, "
                        "falling back to 8")
    p.add_argument("--tile_bucket", type=int, default=None,
                   help="quantize the tile height to multiples of this "
                        "(default off; 0 also disables)")
    p.add_argument("--tile_w", type=int, default=None,
                   help="tile width for a rectangular grid (default: "
                        "square --tile)")
    p.add_argument("--tile_batch", type=int, default=2)


def _add_common(p: argparse.ArgumentParser):
    from super_resolution_tpu_torch.config import PRESETS

    p.add_argument("--preset", choices=PRESETS, default=None)
    p.add_argument("--residual_blocks", type=int, default=None,
                   help="number of RRDB blocks (default 23)")
    p.add_argument("--channels", type=int, default=None)
    p.add_argument("--hr_height", type=int, default=None)
    p.add_argument("--hr_width", type=int, default=None)
    p.add_argument("--upsampler", choices=("nearest_conv", "pixelshuffle"),
                   default=None)
    p.add_argument("--dtype", default=None,
                   choices=("bfloat16", "float32"))
    p.add_argument("--conv_impl", default=None,
                   choices=("auto", "lax", "pallas", "pallas_fused",
                            "pallas_cf", "pallas_cf_tail"),
                   help="conv path, by the JAX package's names: auto "
                        "(= pallas_cf: the dense-block kernel), "
                        "pallas_cf_tail (+ the single-conv kernel on the "
                        "upsample tail), pallas (every conv through the "
                        "single-conv kernel), pallas_fused (the NHWC "
                        "dense-block entry), lax (every conv through "
                        "cuDNN, no kernel).  Training runs pallas and "
                        "pallas_fused on lax (no backward)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--data_parallel", type=int, default=None,
                   help="DP-of-tiles over this many devices (the port "
                        "runs one device until DDP is ported)")
    p.add_argument("--vgg_weights", default=None,
                   help="npz from tools/convert_vgg.py (training's "
                        "perceptual loss)")
    p.add_argument("--lenient_import", action="store_true",
                   help="ignore unmapped keys when importing a torch .pth")
    p.add_argument("--compile_cache_dir", default=None,
                   help="accepted for command-line compatibility: the "
                        "port runs eagerly and builds its kernels into "
                        "the package's _build/ directory")
    p.add_argument("--no_compile_cache", action="store_true",
                   help="accepted for command-line compatibility")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: 'cuda' (default) or 'cpu'")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="super_resolution_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="GAN / PSNR-pretrain training")
    _add_common(t)
    t.add_argument("--dataset_dir", required=True)
    t.add_argument("--lr_dir", default=None,
                   help="paired-LR directory (files matched to "
                        "--dataset_dir by stem); omits bicubic LR "
                        "synthesis")
    t.add_argument("--n_epochs", type=int, default=None)
    t.add_argument("--steps", type=int, default=None,
                   help="total steps override (default epochs*1000)")
    t.add_argument("--batch_size", type=int, default=None)
    t.add_argument("--n_cpu", type=int, default=None)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--b1", type=float, default=None)
    t.add_argument("--b2", type=float, default=None)
    t.add_argument("--lr_halve_steps", type=int, nargs="*", default=None,
                   help="steps at which lr halves (MultiStepLR)")
    t.add_argument("--warmup_batches", type=int, default=None)
    t.add_argument("--lambda_adv", type=float, default=None)
    t.add_argument("--lambda_pixel", type=float, default=None)
    t.add_argument("--lambda_percep", type=float, default=None)
    t.add_argument("--no_perceptual", action="store_true")
    t.add_argument("--perceptual_source", default=None,
                   choices=("vgg", "d_features"),
                   help="perceptual feature space: ImageNet VGG-19 "
                        "(needs --vgg_weights) or discriminator feature "
                        "matching (no external asset)")
    t.add_argument("--ragan_two_sided", action="store_true",
                   help="the paper's G-side RaGAN (both directions "
                        "averaged) instead of the single-direction recipe")
    t.add_argument("--sample_interval", type=int, default=None)
    t.add_argument("--checkpoint_interval", type=int, default=None)
    t.add_argument("--checkpoint_dir", default=None)
    t.add_argument("--sample_dir", default=None)
    t.add_argument("--log_dir", default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--init_g_from", default=None,
                   help="warm-start G from a PSNR checkpoint (.pth or a "
                        "checkpoint directory of `train`) into a fresh GAN "
                        "state — the ESRGAN pretrain->GAN recipe")
    t.add_argument("--eval_dir", default=None,
                   help="validation dir for periodic in-loop eval (not "
                        "ported yet)")
    t.add_argument("--eval_interval", type=int, default=None)
    t.add_argument("--profile_dir", default=None,
                   help="profiler trace output dir (not ported yet)")
    t.add_argument("--multihost", action="store_true",
                   help="multi-host training (not ported yet)")
    t.add_argument("--coordinator", default=None)
    t.add_argument("--num_processes", type=int, default=None)
    t.add_argument("--process_id", type=int, default=None)
    t.add_argument("--loader", choices=("threads", "grain"),
                   default="threads",
                   help="input pipeline backend ('grain' is not ported "
                        "yet)")

    u = sub.add_parser("upscale",
                       help="×4 upscale an image, or every image in a "
                            "directory (tiled)")
    _add_common(u)
    u.add_argument("--image", required=True,
                   help="input image, or a directory of images")
    u.add_argument("--checkpoint", required=True)
    u.add_argument("--out", required=True,
                   help="output image, or a directory when --image is one")
    _add_tile_flags(u)
    u.add_argument("--self_ensemble", action="store_true",
                   help="x8 flip/rotation test-time augmentation")

    sv = sub.add_parser("serve",
                        help="resident model over a frame stream: watch a "
                             "directory, upscale new frames as they appear")
    _add_common(sv)
    sv.add_argument("--checkpoint", required=True)
    sv.add_argument("--watch", required=True,
                    help="directory to watch for incoming LR frames")
    sv.add_argument("--out", required=True, help="output directory")
    _add_tile_flags(sv)
    sv.add_argument("--poll", type=float, default=0.5,
                    help="poll interval, seconds")
    sv.add_argument("--once", action="store_true",
                    help="drain the current backlog and exit")
    sv.add_argument("--max_frames", type=int, default=None,
                    help="exit after N frames (default: run forever)")
    sv.add_argument("--pipeline_write",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="overlap PNG encode+save of frame N with the "
                         "compute of frame N+1 (default on)")
    sv.add_argument("--prewarm", default=None,
                    help="comma-separated WxH frame sizes (e.g. "
                         "'1920x1080,2048x2048'): one warm-up forward per "
                         "size before watching")

    args = parser.parse_args(argv)
    cfg = _build_cfg(args)
    if cfg.data_parallel > 1:
        raise NotImplementedError(
            "--data_parallel > 1 needs DDP, which is not ported yet "
            "(ROADMAP.md Queue 1)")

    if args.cmd == "train":
        for flag, on in (("--multihost", args.multihost),
                         ("--loader grain", args.loader == "grain"),
                         ("--profile_dir", bool(args.profile_dir)),
                         ("--eval_dir", bool(args.eval_dir))):
            if on:
                raise NotImplementedError(
                    f"{flag} is not ported yet (ROADMAP.md)")
        from super_resolution_tpu_torch.train import train

        train(cfg, total_steps=args.steps, resume=args.resume,
              init_g_from=args.init_g_from, log_dir=args.log_dir,
              sample_dir=args.sample_dir, device=args.device)
        return 0

    import torch

    from super_resolution_tpu_torch.data import (
        list_images,
        merge_alpha,
        normalize,
        split_alpha,
        to_uint8_image,
    )
    from super_resolution_tpu_torch.device import resolve_device
    from super_resolution_tpu_torch.parallel import tiled_upscale
    from super_resolution_tpu_torch.train.steps import make_infer_fn

    device = resolve_device(args.device)
    g_sd, cfg = _load_generator(args, cfg)
    infer = make_infer_fn(cfg, g_sd, device)
    mean, std = cfg.data.normalize_mean, cfg.data.normalize_std
    scale = cfg.generator.scale
    halo = _resolve_halo(args)
    tile, tile_w, bucket_h = _resolve_tile_geometry(args)

    def up(lrn):
        return tiled_upscale(infer, lrn, scale=scale, tile=tile, halo=halo,
                             tile_w=tile_w, bucket_h=bucket_h,
                             tile_batch=args.tile_batch)

    def upscale_u8(lr_u8: np.ndarray, ensemble: bool = False) -> np.ndarray:
        # ship uint8 and convert on the device: a quarter of the bytes.
        # np.array copies: a decoded PIL frame is read-only
        lr = torch.from_numpy(np.array(lr_u8)).to(device)
        lrn = normalize(lr.float() / 255.0, mean, std)
        if ensemble:
            from super_resolution_tpu_torch.ops.ensemble import (
                self_ensemble,
            )

            srn = self_ensemble(up, lrn)
        else:
            srn = up(lrn)
        return to_uint8_image(srn, cfg.data).cpu().numpy()

    if args.cmd == "upscale":
        from PIL import Image

        def upscale_one(src: str, dst: str):
            with Image.open(src) as im:
                lr_u8, alpha_u8 = split_alpha(im)
            sr_u8 = upscale_u8(lr_u8, args.self_ensemble)
            if alpha_u8 is not None and dst.lower().endswith((".jpg",
                                                              ".jpeg")):
                print(f"[cli] warning: {src} has an alpha channel but "
                      f"{dst} is JPEG — transparency dropped (use .png)")
                alpha_u8 = None
            sr_rgba = merge_alpha(sr_u8, alpha_u8, scale, device)
            try:
                Image.fromarray(sr_rgba).save(dst)
                sr_u8 = sr_rgba
            except (OSError, ValueError, KeyError):
                if alpha_u8 is None:
                    raise            # not an alpha problem — real error
                print(f"[cli] warning: {dst} format cannot store the "
                      f"alpha channel of {src} — transparency dropped "
                      f"(use .png)")
                Image.fromarray(sr_u8).save(dst)
            print(f"[cli] {lr_u8.shape[1]}x{lr_u8.shape[0]} → "
                  f"{sr_u8.shape[1]}x{sr_u8.shape[0]} saved to {dst}")

        if os.path.isdir(args.image):      # batch mode over a directory
            os.makedirs(args.out, exist_ok=True)
            for src in list_images(args.image):
                stem, _ = os.path.splitext(os.path.basename(src))
                upscale_one(src, os.path.join(args.out,
                                              f"{stem}_x{scale}.png"))
        else:
            upscale_one(args.image, args.out)
        return 0

    from super_resolution_tpu_torch.serve import serve_watch

    if args.prewarm:
        for size in args.prewarm.split(","):
            try:
                w, h = (int(v) for v in size.lower().split("x"))
            except ValueError:
                raise SystemExit(f"--prewarm expects WxH sizes, got {size!r}")
            t0 = time.perf_counter()
            upscale_u8(np.zeros((h, w, 3), np.uint8))
            print(f"[serve] prewarmed {w}x{h} in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)

    n = serve_watch(upscale_u8, args.watch, args.out, scale=scale,
                    poll_s=args.poll, once=args.once,
                    max_frames=args.max_frames,
                    pipeline_write=args.pipeline_write, device=device)
    print(f"[serve] processed {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
