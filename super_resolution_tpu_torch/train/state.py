"""Training state (the JAX package's ``train/state.py``): one dataclass
carrying the generator, the discriminator (with its BatchNorm running
statistics), the frozen VGG trunk, both Adam optimizers, the EMA of the
generator's parameters, the step count and the two random generators.
A train step mutates it in place; :func:`state_dict` /
:func:`load_state_dict` turn all of it into one tree for a checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch
import torch.nn as nn

from super_resolution_tpu_torch.config import (
    OptimConfig,
    TrainConfig,
    ema_maturity_steps,
)
from super_resolution_tpu_torch.device import resolve_device
from super_resolution_tpu_torch.models.discriminator import Discriminator
from super_resolution_tpu_torch.models.rrdb import RRDBNet
from super_resolution_tpu_torch.models.vgg import VGGFeatures, load_vgg_params

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {cfg.compute_dtype!r}")
    return _DTYPES[cfg.compute_dtype]


def lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Updates done so far -> learning rate: constant, or halved from
    each of ``lr_halve_steps`` on (the update whose count equals a
    listed step is the first at the halved rate, as
    ``optax.piecewise_constant_schedule`` has it)."""
    def lr_at(count: int) -> float:
        return cfg.lr * 0.5 ** sum(count >= int(s)
                                   for s in cfg.lr_halve_steps)

    return lr_at


def make_optimizer(cfg: OptimConfig, params) -> torch.optim.Adam:
    """Adam with the reference family's hyper-parameters.  Each group
    counts its updates in ``n_updates`` (saved with the optimizer), which
    :func:`apply_update` feeds to the schedule."""
    opt = torch.optim.Adam(list(params), lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                           eps=cfg.eps)
    for group in opt.param_groups:
        group["n_updates"] = 0
    return opt


def apply_update(opt: torch.optim.Adam, sched: Callable[[int], float],
                 grads) -> None:
    """One Adam update from ``grads`` (in the order of the optimizer's
    parameters) at the scheduled rate.  The gradients stay in ``.grad``."""
    it = iter(grads)
    for group in opt.param_groups:
        group["lr"] = sched(group["n_updates"])
        for p in group["params"]:
            p.grad = next(it)
    opt.step()
    for group in opt.param_groups:
        group["n_updates"] += 1


@dataclasses.dataclass
class GANTrainState:
    step: int
    g: RRDBNet                        # float32 params, live compute dtype
    g_opt: torch.optim.Adam
    d: Discriminator                  # params and BatchNorm running stats
    d_opt: torch.optim.Adam
    vgg: Optional[VGGFeatures]        # frozen; None when perceptual is off
    g_ema: Optional[Dict[str, torch.Tensor]]   # None when ema_decay == 0
    init_rng: torch.Generator         # drew the initial weights
    aug_rng: torch.Generator          # draws the flip/rot decisions


@torch.no_grad()
def ema_update(cfg: TrainConfig, g_ema: Optional[Dict[str, torch.Tensor]],
               g: nn.Module) -> None:
    """One EMA step in place: e <- d·e + (1−d)·p for every parameter."""
    if g_ema is None:
        return
    names, params = zip(*g.named_parameters())
    ema = [g_ema[n] for n in names]
    torch._foreach_mul_(ema, cfg.ema_decay)
    torch._foreach_add_(ema, list(params), alpha=1.0 - cfg.ema_decay)


def eval_params(cfg: TrainConfig, state: GANTrainState,
                warm_start: bool = False) -> Dict[str, torch.Tensor]:
    """The generator weights eval and sampling should use: the EMA when
    it is kept, ``cfg.eval_use_ema`` is set and it can be trusted — the
    run is past the maturity horizon (``config.ema_maturity_steps``) or
    ``warm_start`` says it was seeded from warm-start weights, not from a
    random init; else the raw parameters."""
    if cfg.eval_use_ema and state.g_ema is not None and (
            warm_start or state.step >= ema_maturity_steps(cfg.ema_decay)):
        return state.g_ema
    return state.g.state_dict()


def build_models(cfg: TrainConfig, generator: torch.Generator):
    """(G, D, VGG or None), weights drawn from ``generator`` in that
    order.  No VGG tower is built for the d_features perceptual source."""
    dtype = compute_dtype(cfg)
    g = RRDBNet(cfg.generator, generator)
    d = Discriminator(cfg.discriminator, dtype, generator)
    vgg = None
    if cfg.loss.use_perceptual and cfg.loss.perceptual_source == "vgg":
        vgg = VGGFeatures(cfg.vgg, dtype, generator, cfg.generator.channels)
    return g, d, vgg


def init_state(cfg: TrainConfig,
               device: Union[str, torch.device] = "cuda") -> GANTrainState:
    device = resolve_device(device)
    init_rng = torch.Generator().manual_seed(cfg.seed)
    aug_rng = torch.Generator().manual_seed(cfg.seed)
    g, d, vgg = build_models(cfg, init_rng)
    if vgg is not None:
        if cfg.vgg.weights_path:
            vgg.load_state_dict(load_vgg_params(cfg.vgg.weights_path))
        else:
            print("[init] WARNING: perceptual loss is using RANDOM VGG "
                  "weights (no vgg.weights_path). Random features shrink "
                  "to ~1e-5 magnitude through 16 conv layers, so the "
                  "perceptual term is effectively inert and GAN training "
                  "will be dominated by the adversarial loss — convert "
                  "ImageNet weights with python -m "
                  "super_resolution_tpu_torch.tools.convert_vgg, use "
                  "--perceptual_source d_features (discriminator feature "
                  "matching, no external asset), or train with "
                  "use_perceptual=False / --no_perceptual and a higher "
                  "lambda_pixel.", flush=True)
        vgg = vgg.to(device)
    g = g.to(device).prepare(compute_dtype(cfg), live=True)
    d = d.to(device)
    return GANTrainState(
        step=0, g=g, g_opt=make_optimizer(cfg.optim_g, g.parameters()),
        d=d, d_opt=make_optimizer(cfg.optim_d, d.parameters()), vgg=vgg,
        g_ema=({k: v.detach().clone() for k, v in g.named_parameters()}
               if cfg.ema_decay > 0 else None),
        init_rng=init_rng, aug_rng=aug_rng)


def set_generator_params(state: GANTrainState,
                         sd: Dict[str, torch.Tensor]) -> None:
    """Replace G's parameters (a warm start) and seed the EMA from them."""
    state.g.load_state_dict(sd, strict=True)
    if state.g_ema is not None:
        state.g_ema = {k: v.detach().clone()
                       for k, v in state.g.named_parameters()}


def state_dict(state: GANTrainState) -> dict:
    """Everything a step-exact resume needs, as one tree of tensors and
    numbers.  The frozen VGG trunk is not in it: ``init_state`` rebuilds
    it from the seed or the weights file."""
    return {"step": state.step,
            "g": state.g.state_dict(), "g_opt": state.g_opt.state_dict(),
            "d": state.d.state_dict(), "d_opt": state.d_opt.state_dict(),
            "g_ema": state.g_ema,
            "init_rng": state.init_rng.get_state(),
            "aug_rng": state.aug_rng.get_state()}


def load_state_dict(state: GANTrainState, tree: dict) -> None:
    """Load :func:`state_dict`'s tree into a state built by
    ``init_state`` on the same config; raises ValueError when the trees
    differ."""
    if (tree.get("g_ema") is None) != (state.g_ema is None):
        raise ValueError("the checkpoint and the config disagree on "
                         "keeping an EMA of the generator (ema_decay)")
    try:
        state.g.load_state_dict(tree["g"], strict=True)
        state.d.load_state_dict(tree["d"], strict=True)
        state.g_opt.load_state_dict(tree["g_opt"])
        state.d_opt.load_state_dict(tree["d_opt"])
    except (RuntimeError, KeyError, ValueError) as e:
        raise ValueError(
            "the checkpoint has a different state tree than the current "
            "config. To warm-start the generator into a fresh GAN state "
            "use train(init_g_from=...) / --init_g_from instead of "
            f"--resume. ({e})") from e
    device = next(state.g.parameters()).device
    if state.g_ema is not None:
        state.g_ema = {k: v.to(device) for k, v in tree["g_ema"].items()}
    state.step = int(tree["step"])
    state.init_rng.set_state(tree["init_rng"].cpu())
    state.aug_rng.set_state(tree["aug_rng"].cpu())


def n_params(tree: Union[nn.Module, Dict[str, torch.Tensor]]) -> int:
    tensors = tree.parameters() if isinstance(tree, nn.Module) \
        else tree.values()
    return sum(t.numel() for t in tensors)
