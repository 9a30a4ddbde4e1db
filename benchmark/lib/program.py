"""The harness's calls into the program under test,
``super_resolution_tpu_torch``: its public entry points and its build
directory, imported only when a run starts.  The drivers call the
program through these adapters; a driver of a later kind may add its
own."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict

import numpy as np
import torch

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_cache")


def use_build_cache() -> str:
    """Build and load the program's CUDA kernels in the checkout's fixed
    ``benchmark/_cache/build``, so only a checkout's first run builds."""
    from super_resolution_tpu_torch import build

    return build.set_build_dir(os.path.join(CACHE, "build"))


def generator_config(cfg: Dict):
    from super_resolution_tpu_torch.config import GeneratorConfig

    return GeneratorConfig(
        channels=cfg["channels"], filters=cfg["filters"],
        growth=cfg["growth"], n_blocks=cfg["n_blocks"],
        n_dense=cfg["n_dense"], n_dense_convs=cfg["n_dense_convs"],
        scale=cfg["scale"], res_scale=cfg["res_scale"],
        lrelu_slope=cfg["lrelu_slope"], upsampler=cfg["upsampler"],
        init=cfg["init"], conv_impl=cfg["conv_impl"])


def _check_normalisation(data, cfg: Dict) -> None:
    if (list(data.normalize_mean) != cfg["normalize_mean"]
            or list(data.normalize_std) != cfg["normalize_std"]):
        raise ValueError("the program's normalisation differs from the "
                         "configuration's")


class Upscaler:
    """The command-line upscale path (``cli upscale``) for one
    generator: uint8 frame on the host -> device -> ``normalize`` ->
    ``parallel.tiled_upscale`` over ``train.steps.make_infer_fn`` ->
    ``to_uint8_image`` -> host.  A call may pass ``infer``, a wrapper of
    :attr:`infer` (the traced run's spans)."""

    def __init__(self, cfg: Dict, traffic: Dict, weights: Dict,
                 device: torch.device):
        from super_resolution_tpu_torch.config import TrainConfig
        from super_resolution_tpu_torch.train.steps import make_infer_fn

        self.tcfg = TrainConfig(generator=generator_config(cfg),
                                compute_dtype=cfg["compute_dtype"])
        _check_normalisation(self.tcfg.data, cfg)
        self.infer = make_infer_fn(self.tcfg, weights, device)
        self.device = device
        self.scale = cfg["scale"]
        self.tile, self.halo = traffic["tile"], traffic["halo"]
        self.tile_batch = traffic["tile_batch"]

    def __call__(self, lr_u8: np.ndarray,
                 infer: Callable = None) -> np.ndarray:
        from super_resolution_tpu_torch.data import normalize, to_uint8_image
        from super_resolution_tpu_torch.parallel import tiled_upscale

        data = self.tcfg.data
        lr = torch.from_numpy(np.array(lr_u8)).to(self.device)
        lrn = normalize(lr.float() / 255.0, data.normalize_mean,
                        data.normalize_std)
        srn = tiled_upscale(infer or self.infer, lrn, scale=self.scale,
                            tile=self.tile, halo=self.halo,
                            tile_batch=self.tile_batch)
        return to_uint8_image(srn, data).cpu().numpy()


class GANTrainer:
    """``train.steps.make_gan_step`` under the configuration's preset,
    on a state from ``train.state.init_state`` whose G, D and VGG
    parameters are replaced by the given weights (G's EMA restarted
    from them)."""

    def __init__(self, cfg: Dict, batch: int, weights: Dict[str, Dict],
                 seed: int, device: torch.device):
        from super_resolution_tpu_torch.config import DataConfig, preset
        from super_resolution_tpu_torch.train.state import (
            init_state,
            set_generator_params,
        )
        from super_resolution_tpu_torch.train.steps import (
            make_gan_step,
            training_cfg,
        )

        t = cfg["training"]
        base = preset(t["preset"])
        tcfg = dataclasses.replace(
            base, generator=generator_config(cfg),
            data=DataConfig(hr_patch=t["hr_patch"], batch_size=batch,
                            augment=t["augment"]),
            compute_dtype=cfg["compute_dtype"], seed=seed, warmup_batches=0)
        self.cfg = tcfg = training_cfg(tcfg)
        _check_normalisation(tcfg.data, cfg)
        self._check(cfg)
        self.state = init_state(tcfg, device)
        set_generator_params(self.state, weights["g"])
        with torch.no_grad():
            for module, w in ((self.state.d, weights["d"]),
                              (self.state.vgg, weights["v"])):
                params = dict(module.named_parameters())
                if set(params) != set(w):
                    raise ValueError("the program's parameters are not the "
                                     "configuration's")
                for name, p in params.items():
                    p.copy_(w[name])
        self.step_fn = make_gan_step(tcfg)

    def _check(self, cfg: Dict) -> None:
        """The program runs as the configuration states, or not at all."""
        t, c = cfg["training"], self.cfg
        a = t["adam"]
        d = t["discriminator"]
        stated = {
            "lambda_adv": (c.loss.lambda_adv, t["lambda_adv"]),
            "lambda_pixel": (c.loss.lambda_pixel, t["lambda_pixel"]),
            "lambda_percep": (c.loss.lambda_percep, t["lambda_percep"]),
            "perceptual": (c.loss.use_perceptual
                           and c.loss.perceptual_source, "vgg"),
            "ragan_g_two_sided": (c.loss.ragan_g_two_sided,
                                  t["ragan_g_two_sided"]),
            "ema_decay": (c.ema_decay, t["ema_decay"]),
            "adam_g": ((c.optim_g.lr, c.optim_g.b1, c.optim_g.b2,
                        c.optim_g.eps, c.optim_g.lr_halve_steps),
                       (a["lr"], a["b1"], a["b2"], a["eps"], ())),
            "adam_d": ((c.optim_d.lr, c.optim_d.b1, c.optim_d.b2,
                        c.optim_d.eps, c.optim_d.lr_halve_steps),
                       (a["lr"], a["b1"], a["b2"], a["eps"], ())),
            "discriminator": ((c.discriminator.base_filters,
                               c.discriminator.n_scales,
                               c.discriminator.lrelu_slope,
                               c.discriminator.bn_eps),
                              (d["base_filters"], d["n_scales"],
                               d["lrelu_slope"], d["bn_eps"])),
            "one_sided_bn": (c.bn_track_g_step or c.dedup_d_hr, False),
        }
        wrong = [k for k, (have, want) in stated.items() if have != want]
        if wrong:
            raise ValueError(f"the program's preset {t['preset']!r} departs "
                             f"from the configuration in {wrong}")

    def step(self, hr_u8: torch.Tensor):
        return self.step_fn(self.state, hr_u8)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """G's and D's parameters and G's EMA, by the comparison's
        names."""
        s = self.state
        return {**{f"g.{k}": p for k, p in s.g.named_parameters()},
                **{f"d.{k}": p for k, p in s.d.named_parameters()},
                **{f"ema.{k}": x for k, x in s.g_ema.items()}}

    def first_gradients(self) -> Dict[str, torch.Tensor]:
        """After one step: each G and D gradient as Adam received it,
        from its first moment, m = (1 - b1)·g (zero where Adam holds no
        state: no update was made)."""
        out = {}
        for prefix, opt, module in (("g", self.state.g_opt, self.state.g),
                                    ("d", self.state.d_opt, self.state.d)):
            b1 = opt.param_groups[0]["betas"][0]
            for k, p in module.named_parameters():
                m = opt.state.get(p, {}).get("exp_avg")
                out[f"{prefix}.{k}"] = (torch.zeros_like(p) if m is None
                                        else m / (1.0 - b1))
        return out

