"""CLI of the port: the ``train``, ``eval``, ``upscale``, ``serve``,
``export`` and ``interp`` subcommands of the JAX package's CLI, with the
same flags, running on the card.

    python -m super_resolution_tpu_torch.cli train --dataset_dir data/train \
        --preset train_gan_dfm --checkpoint_dir ck/ --eval_dir data/val
    python -m super_resolution_tpu_torch.cli eval --dataset_dir data/val \
        --checkpoint ck/ --json
    python -m super_resolution_tpu_torch.cli export --checkpoint ck/ \
        --out release.pth --val_dir data/val
    python -m super_resolution_tpu_torch.cli interp --psnr_ckpt psnr.pth \
        --gan_ckpt gan.pth --alpha 0.8 --out blend.pth
    python -m super_resolution_tpu_torch.cli upscale --image frame.png \
        --checkpoint release.pth --out sr.png
    python -m super_resolution_tpu_torch.cli serve --checkpoint gen.pth \
        --watch in/ --out sr/

``--device`` (default ``cuda``) picks where the model runs; asking for
``cuda`` on a machine without a card raises, and ``--device cpu`` runs
every kernel's plain version on the CPU.  Checkpoints are torch ``.pth``
files in any of the three naming families, or a checkpoint directory
written by ``train`` (EMA maturity-gated); orbax directories are the JAX
package's format and are refused.  ``--data_parallel N`` trains on N
devices, one process (rank) per device spawned from the one command,
with the JAX package's global-batch semantics; with ``--multihost
--coordinator host:port --num_processes H --process_id i`` host i of H
starts its N / H ranks, which meet at the coordinator (N is the global
rank count).  ``upscale``, ``serve`` and ``eval`` split each frame's
tiles over N devices.  N devices must exist: ranks are never put two to
a card.  ``--profile_dir D`` writes a ``torch.profiler`` trace of
training (rank 0's) into D.  ``--compile_cache_dir D`` builds and keeps
the CUDA kernels' libraries in D (default: the package's ``_build/``),
``--no_compile_cache`` builds them into a temporary directory removed
at exit.  ``--loader grain`` feeds training from the grain loader
(``data/grain_source.py``, each rank its rows); it needs the ``grain``
package and raises without it, never falling back to ``threads``.
``--preset swinir_l_real_x4`` runs SwinIR-L real-world ×4
(``models/swinir.py``) in ``upscale`` and ``serve``, from a released
SwinIR ``.pth`` (``003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4_GAN.pth``),
normalised as SwinIR is (x − the DIV2K mean, unit std); the other
commands refuse it.  ``--conv_impl`` picks the conv path by the JAX
package's names (``auto`` = ``pallas_cf``, ``pallas_cf_tail``,
``pallas``, ``pallas_fused``, and ``lax``: cuDNN, no kernel of the
port) for ``upscale``, ``serve``,
``eval`` and ``train``; a checkpoint sets the architecture, never the
impl.  Default tile geometry: square 384, no height bucket, no alignment
under every impl: the port's kernels take every tile shape, so the JAX
package's (8, 128) clamp for its TPU kernels' bands is not carried over
(the H100 geometry sweep is a ROADMAP item).  ``export``'s halo sweep
runs an fp32 ``lax`` forward (cuDNN, TF32 off) on ``--device``, where
the JAX package forces its CPU backend: both keep kernel and bf16
rounding out of the measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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

    if _swinir(cfg):
        rrdb_only = [f"--{f}" for f in ("residual_blocks", "channels",
                                        "upsampler", "conv_impl")
                     if getattr(args, f, None) is not None]
        if rrdb_only:
            raise SystemExit(f"--preset {args.preset} is SwinIR: "
                             f"{', '.join(rrdb_only)} set RRDBNet's "
                             f"architecture")
        gen = cfg.generator
    else:
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


def _train_dir(path: str) -> bool:
    """Whether ``path`` is a checkpoint directory written by ``train``;
    any other directory is refused: orbax is the JAX package's format."""
    if not os.path.isdir(path):
        return False
    from super_resolution_tpu_torch.checkpoint import latest_step

    if latest_step(path) is not None:
        return True
    raise SystemExit(
        f"{path!r} is a directory: orbax checkpoints are the JAX "
        f"package's format; export one to .pth with "
        f"`python -m super_resolution_tpu.cli export` first")


def _swinir(cfg) -> bool:
    from super_resolution_tpu_torch.config import SwinIRConfig

    return isinstance(cfg.generator, SwinIRConfig)


def _load_generator(args, cfg):
    """(port state dict, cfg with the checkpoint's architecture).  Under
    a SwinIR preset the checkpoint is a SwinIR ``.pth`` (released names),
    whose shapes set the SwinIR architecture."""
    from super_resolution_tpu_torch.import_torch import (
        import_generator,
        import_swinir,
        load_pth,
    )

    path = args.checkpoint
    if _swinir(cfg):
        if not os.path.isfile(path):
            raise SystemExit(f"checkpoint not found: {path!r} (expected a "
                             f"SwinIR .pth file)")
        sd, gen_cfg = import_swinir(load_pth(path))
        return sd, dataclasses.replace(cfg, generator=gen_cfg)
    if _train_dir(path):
        from super_resolution_tpu_torch.checkpoint import (
            restore_generator_params,
        )

        sd, _ = restore_generator_params(path, ema_decay=cfg.ema_decay)
        sd, gen_cfg = import_generator(sd)
        gen_cfg = dataclasses.replace(
            gen_cfg, conv_impl=cfg.generator.conv_impl,
            tail_up=cfg.generator.tail_up,
            lrelu_slope=cfg.generator.lrelu_slope)
        return sd, dataclasses.replace(cfg, generator=gen_cfg)
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


def _export(args, cfg) -> int:
    """``cli export``: the release ``.pth`` (EMA maturity-gated), then the
    halo sweep or stamp, the val contract and the sidecar."""
    from super_resolution_tpu_torch.device import resolve_device
    from super_resolution_tpu_torch.import_torch import (
        export_generator_release,
        import_generator,
        load_pth,
        save_pth,
    )

    sweep = args.halo_sweep and args.stamp_halo is None
    # the forwards' device; a missing card is refused before anything
    # is written
    device = resolve_device(args.device) if sweep or args.val_dir else None
    if os.path.isfile(args.checkpoint):    # .pth → re-wrap
        g_sd, gcfg = import_generator(load_pth(args.checkpoint))
        g_ema = None
        if args.ema is not None:
            # the import already collapsed the file to ONE tree
            # (params_ema preferred when present): there is no second
            # tree to force in or strip
            print("[cli] warning: --ema/--no-ema has no effect on "
                  "a .pth input — load_pth already selected "
                  "params_ema when the file carries one, and the "
                  "re-wrapped release has a single tree")
    elif _train_dir(args.checkpoint):
        from super_resolution_tpu_torch.checkpoint import (
            read_ema_provenance,
            restore_generator_trees,
        )
        from super_resolution_tpu_torch.config import ema_maturity_steps

        g_sd, g_ema, step = restore_generator_trees(args.checkpoint)
        g_sd, gcfg = import_generator(g_sd)
        if g_ema is not None and args.ema is not True:
            need = ema_maturity_steps(cfg.ema_decay)
            prov = read_ema_provenance(args.checkpoint) or {}
            if args.ema is False:
                g_ema = None
            elif step < need and not prov.get("warm_start"):
                # an immature from-scratch EMA is the run's worst
                # weights, and every importer prefers params_ema; a
                # warm-started run's EMA was seeded from the warm-start
                # weights and is release-grade at any step
                print(f"[cli] warning: step {step} is inside the "
                      f"EMA maturity horizon ({need} steps at "
                      f"decay {cfg.ema_decay}) with no warm-start "
                      f"provenance — params_ema would be dominated "
                      f"by early-training weights, so the release "
                      f"carries raw params only (--ema forces the "
                      f"EMA tree in)")
                g_ema = None
        if g_ema is not None:
            g_ema, _ = import_generator(g_ema)
        print(f"[cli] exporting step-{step} checkpoint"
              + (" (with params_ema)" if g_ema is not None else ""))
    else:
        raise SystemExit(f"checkpoint not found: {args.checkpoint!r}")
    save_pth(export_generator_release(g_sd, gcfg, g_ema, style=args.style),
             args.out)
    print(f"[cli] wrote {args.out}")
    if args.stamp_halo is None and not args.halo_sweep:
        return 0

    from super_resolution_tpu_torch.halo_sweep import (
        sweep_admissible_halo,
        val_dir_contract,
        write_halo_meta,
    )
    from super_resolution_tpu_torch.train.steps import make_infer_fn

    infer = None
    if device is not None:
        # an fp32 lax forward (the model runs inside device.no_tf32) of
        # the weights inference will load: importers prefer params_ema
        sweep_cfg = dataclasses.replace(
            cfg, compute_dtype="float32",
            generator=dataclasses.replace(gcfg, conv_impl="lax"))
        infer = make_infer_fn(sweep_cfg, g_sd if g_ema is None else g_ema,
                              device)
    if args.stamp_halo is not None:
        meta = {"admissible_halo": int(args.stamp_halo),
                "method": "stamped",
                "scale": gcfg.scale}
    else:
        meta = sweep_admissible_halo(
            infer, scale=gcfg.scale, frame=args.sweep_frame,
            tile_w=args.sweep_tile_w,
            halos=[int(h) for h in args.sweep_halos.split(",")],
            threshold_db=args.sweep_threshold_db, device=device)
        meta["weights"] = "params_ema" if g_ema is not None else "params"
    if args.val_dir and meta["admissible_halo"] is not None:
        vc = meta["val_contract"] = val_dir_contract(
            infer, args.val_dir, scale=gcfg.scale,
            halo=meta["admissible_halo"], tile_w=args.sweep_tile_w,
            max_images=args.val_max_images, device=device)
        if vc["n_images"] == 0:
            print(f"[cli] val contract: {vc['note']} "
                  f"(halo={meta['admissible_halo']})")
        else:
            print(f"[cli] val contract at halo="
                  f"{meta['admissible_halo']}: psnr_gt "
                  f"whole={vc['psnr_gt_whole_db']:.4f} dB, "
                  f"tiled={vc['psnr_gt_tiled_db']:.4f} dB "
                  f"(delta {vc['delta_db']:+.4f} dB over "
                  f"{vc['n_images']} images)")
    path = write_halo_meta(args.out, meta)
    if meta["admissible_halo"] is None:
        # distinct from "no sidecar": the sidecar exists with
        # admissible_halo=null, and `--halo auto` says so
        print(f"[cli] warning: halo sweep found NO admissible "
              f"halo at threshold {meta.get('threshold_db')} dB — "
              f"sidecar {path} records the sweep; `--halo auto` will "
              f"fall back to the conservative 8")
    else:
        print(f"[cli] stamped admissible_halo={meta['admissible_halo']} "
              f"into {path}")
    return 0


def _interp(args, cfg) -> int:
    """``cli interp``: θ = α·θ_GAN + (1−α)·θ_PSNR on ``--device``, written
    as a BasicSR ``.pth``."""
    from super_resolution_tpu_torch.checkpoint import net_interp
    from super_resolution_tpu_torch.device import resolve_device
    from super_resolution_tpu_torch.import_torch import (
        export_generator,
        import_generator,
        load_pth,
        save_pth,
    )

    device = resolve_device(args.device)

    def load_any(path):
        """(state dict, cfg) of a .pth or a `train` directory, the latter
        EMA maturity-gated: blending an immature EMA would poison both
        ends of the interpolation."""
        if os.path.isfile(path):
            return import_generator(load_pth(path))
        if _train_dir(path):
            from super_resolution_tpu_torch.checkpoint import (
                restore_generator_params,
            )

            sd, step = restore_generator_params(path,
                                                ema_decay=cfg.ema_decay)
            print(f"[cli] restored checkpoint at step {step}")
            return import_generator(sd)
        raise SystemExit(f"interp: checkpoint not found: {path!r}")

    pa, ca = load_any(args.psnr_ckpt)
    pb, cb = load_any(args.gan_ckpt)
    structural = ("channels", "filters", "growth", "n_blocks", "upsampler")
    if any(getattr(ca, f) != getattr(cb, f) for f in structural):
        raise SystemExit("interp: checkpoint architectures differ "
                         f"({ca} vs {cb})")
    blended = net_interp({k: v.to(device) for k, v in pa.items()},
                         {k: v.to(device) for k, v in pb.items()},
                         args.alpha)
    save_pth(export_generator(blended, ca), args.out)
    print(f"[cli] wrote interpolated .pth (alpha={args.alpha}) "
          f"to {args.out}")
    return 0


def _train_rank(device, cfg, train_kw: dict, profile_dir,
                loader: str = "threads") -> None:
    """One rank of ``cli train`` (the whole run without data
    parallelism); rank 0 alone traces.  A grain loader is built here,
    in the rank, for the rank's rows: it does not pickle across the
    spawn."""
    from super_resolution_tpu_torch.metrics import profiler_trace
    from super_resolution_tpu_torch.parallel import dp, multihost
    from super_resolution_tpu_torch.train import train

    if loader == "grain":
        from super_resolution_tpu_torch.data.grain_source import (
            GrainPatchLoader,
        )

        train_kw = dict(train_kw, data_loader=GrainPatchLoader(
            cfg.data, seed=cfg.seed, part=multihost.data_part()))
    with profiler_trace(profile_dir if dp.rank() == 0 else None):
        train(cfg, device=device, **train_kw)


def _train(args, cfg) -> int:
    """``cli train``: in this process, or as ``--data_parallel`` ranks
    on this host's devices, or as this host's ranks of a multi-host
    group."""
    from super_resolution_tpu_torch.device import resolve_device
    from super_resolution_tpu_torch.parallel import dp, multihost

    if args.loader == "grain":
        from super_resolution_tpu_torch.data.grain_source import (
            import_grain,
        )

        import_grain()           # raises before any rank starts
    device = resolve_device(args.device)
    rank_args = (cfg, dict(
        total_steps=args.steps, resume=args.resume,
        init_g_from=args.init_g_from, log_dir=args.log_dir,
        sample_dir=args.sample_dir, eval_dir=args.eval_dir,
        eval_interval=args.eval_interval), args.profile_dir, args.loader)
    if args.multihost:
        if args.coordinator is None or args.num_processes is None \
                or args.process_id is None:
            raise SystemExit("--multihost needs --coordinator host:port, "
                             "--num_processes and --process_id")
        multihost.launch(_train_rank, rank_args, args.coordinator,
                         args.num_processes, args.process_id,
                         cfg.data_parallel, device.type)
    elif cfg.data_parallel > 1:
        dp.launch(_train_rank, rank_args,
                  dp.devices_for(cfg.data_parallel, device))
    else:
        _train_rank(device, *rank_args)
    return 0


def _inference_devices(cfg, device):
    """The devices a frame's tiles are split over (``--data_parallel``
    above 1), or None for ``device`` alone."""
    if cfg.data_parallel <= 1:
        return None
    from super_resolution_tpu_torch.parallel import dp

    return dp.devices_for(cfg.data_parallel, device)


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
    from super_resolution_tpu_torch.config import MODEL_PRESETS, PRESETS

    p.add_argument("--preset", choices=PRESETS + MODEL_PRESETS,
                   default=None,
                   help="a configuration by name; swinir_l_real_x4 "
                        "(upscale, serve) is SwinIR-L real-world x4, "
                        "normalised by the DIV2K mean")
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
                   help="devices to run on: training ranks (the global "
                        "count under --multihost), or the devices a "
                        "frame's tiles are split over")
    p.add_argument("--vgg_weights", default=None,
                   help="npz from tools/convert_vgg.py (training's "
                        "perceptual loss)")
    p.add_argument("--lenient_import", action="store_true",
                   help="ignore unmapped keys when importing a torch .pth")
    p.add_argument("--compile_cache_dir", default=None,
                   help="where the CUDA kernels' libraries are built and "
                        "kept across runs (default: the package's "
                        "_build/)")
    p.add_argument("--no_compile_cache", action="store_true",
                   help="build the kernels into a temporary directory "
                        "removed at exit")
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
                   help="validation dir for periodic in-loop eval")
    t.add_argument("--eval_interval", type=int, default=None)
    t.add_argument("--profile_dir", default=None,
                   help="torch.profiler trace output dir (rank 0's)")
    t.add_argument("--multihost", action="store_true",
                   help="multi-host training: this host's ranks join "
                        "the others' at --coordinator")
    t.add_argument("--coordinator", default=None,
                   help="host:port every rank can reach (rank 0, on "
                        "--process_id 0, serves it)")
    t.add_argument("--num_processes", type=int, default=None,
                   help="number of hosts")
    t.add_argument("--process_id", type=int, default=None,
                   help="this host's index")
    t.add_argument("--loader", choices=("threads", "grain"),
                   default="threads",
                   help="input pipeline backend (grain = grain's "
                        "MapDataset with multiprocess prefetch; needs "
                        "the grain package)")

    e = sub.add_parser("eval", help="PSNR/SSIM over a validation dir")
    _add_common(e)
    e.add_argument("--dataset_dir", required=True)
    e.add_argument("--lr_dir", default=None,
                   help="paired-LR directory for eval inputs (matched by "
                        "stem) instead of bicubic synthesis")
    e.add_argument("--checkpoint", required=True)
    _add_tile_flags(e)
    e.add_argument("--max_images", type=int, default=None)
    e.add_argument("--self_ensemble", action="store_true",
                   help="x8 flip/rotation test-time augmentation")
    e.add_argument("--json", action="store_true")

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

    x = sub.add_parser("export",
                       help="train checkpoint → release-shaped torch .pth "
                            "({params, params_ema} per the BasicSR family "
                            "convention)")
    _add_common(x)
    x.add_argument("--checkpoint", required=True,
                   help="checkpoint directory of `train` (a torch .pth "
                        "passes through re-wrapped)")
    x.add_argument("--out", required=True)
    x.add_argument("--style", default="basicsr",
                   choices=("basicsr", "xinntao_old", "erik"),
                   help="torch naming family to emit")
    x.add_argument("--halo_sweep", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="measure the checkpoint's minimal admissible "
                        "tiling halo (tiled-vs-whole probe sweep, fp32 "
                        "lax with TF32 off, on --device) and stamp it "
                        "into <out>.meta.json, which `upscale/serve/eval "
                        "--halo auto` (the default) read.  On by "
                        "default; --no-halo_sweep skips it, --stamp_halo "
                        "records a measured halo instead")
    x.add_argument("--val_dir", default=None,
                   help="also measure, on real images at the stamped "
                        "halo, PSNR against the ground truth of whole-"
                        "frame and of tiled SR (images taken as HR, "
                        "PIL-parity bicubic LR) and record the delta in "
                        "the sidecar")
    x.add_argument("--val_max_images", type=int, default=4,
                   help="cap --val_dir images (each costs a whole-frame "
                        "and a tiled inference)")
    x.add_argument("--ema", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="include params_ema in the release (default: "
                        "auto — included only when the checkpoint step "
                        "is past the EMA maturity horizon 5/(1-decay) or "
                        "the run was warm-started, because importers "
                        "prefer params_ema and an immature EMA is the "
                        "run's worst weights; --ema forces it in, "
                        "--no-ema strips it)")
    x.add_argument("--stamp_halo", type=int, default=None,
                   help="stamp this admissible halo into <out>.meta.json "
                        "without sweeping")
    x.add_argument("--sweep_frame", type=int, default=192,
                   help="probe frame side for --halo_sweep (must exceed "
                        "--sweep_tile_w)")
    x.add_argument("--sweep_tile_w", type=int, default=64)
    x.add_argument("--sweep_halos", default="2,4,6,8")
    x.add_argument("--sweep_threshold_db", type=float, default=55.0,
                   help="minimal tiled-vs-whole PSNR to admit a halo "
                        "(55 dB perturbs a ~25 dB PSNR-vs-GT by "
                        "~0.005 dB)")

    i = sub.add_parser("interp", help="network interpolation (ESRGAN §3.4)")
    _add_common(i)
    i.add_argument("--psnr_ckpt", required=True)
    i.add_argument("--gan_ckpt", required=True)
    i.add_argument("--alpha", type=float, required=True)
    i.add_argument("--out", required=True)

    args = parser.parse_args(argv)
    if args.cmd == "export" and args.val_dir and not args.halo_sweep \
            and args.stamp_halo is None:
        # the contract measurement needs a halo to measure at; without
        # a sweep or a stamp it would be silently skipped
        parser.error("--val_dir needs a halo to measure at: drop "
                     "--no-halo_sweep, or pass --stamp_halo N")
    from super_resolution_tpu_torch import build

    if args.no_compile_cache:
        build.temporary_build_dir()
    elif args.compile_cache_dir:
        build.set_build_dir(args.compile_cache_dir)
    cfg = _build_cfg(args)
    if _swinir(cfg) and args.cmd not in ("upscale", "serve"):
        raise SystemExit(f"--preset {args.preset} runs upscale and serve "
                         f"only: the port does not train, score or export "
                         f"SwinIR")

    if args.cmd == "train":
        return _train(args, cfg)

    if args.cmd == "eval":
        from super_resolution_tpu_torch.device import resolve_device
        from super_resolution_tpu_torch.train.evaluate import (
            evaluate_directory,
        )

        device = resolve_device(args.device)
        devices = _inference_devices(cfg, device)
        g_sd, cfg = _load_generator(args, cfg)
        tile, tile_w, bucket_h = _resolve_tile_geometry(args)
        out = evaluate_directory(cfg, g_sd, args.dataset_dir,
                                 tile=tile, halo=_resolve_halo(args),
                                 tile_w=tile_w, bucket_h=bucket_h,
                                 tile_batch=args.tile_batch,
                                 max_images=args.max_images,
                                 use_self_ensemble=args.self_ensemble,
                                 lr_dir=args.lr_dir, device=device,
                                 devices=devices)
        if args.json:
            print(json.dumps(out))
        else:
            for k, v in out.items():
                print(f"{k}: {v:.4f}" if isinstance(v, float)
                      else f"{k}: {v}")
        return 0

    if args.cmd == "export":
        return _export(args, cfg)
    if args.cmd == "interp":
        return _interp(args, cfg)

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
    devices = _inference_devices(cfg, device)
    g_sd, cfg = _load_generator(args, cfg)
    infer = make_infer_fn(cfg, g_sd, device) if devices is None \
        else [make_infer_fn(cfg, g_sd, d) for d in devices]
    mean, std = cfg.data.normalize_mean, cfg.data.normalize_std
    scale = cfg.generator.scale
    halo = _resolve_halo(args)
    tile, tile_w, bucket_h = _resolve_tile_geometry(args)

    def up(lrn):
        return tiled_upscale(infer, lrn, scale=scale, tile=tile, halo=halo,
                             tile_w=tile_w, bucket_h=bucket_h,
                             tile_batch=args.tile_batch, devices=devices)

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
