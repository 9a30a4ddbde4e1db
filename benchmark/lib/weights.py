"""Seeded weights, drawn on the card in one call per model.

G's and D's convs take nn.Conv2d's default init, U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for weight and bias: one uniform draw for the whole
model from a ``torch.Generator`` on the device, scaled per element by
its conv's bound.  BatchNorm scales are 1 and shifts 0.  VGG-19's convs
take torchvision's VGG init, Kaiming normal with fan_out and ReLU's
gain, std sqrt(2 / (9·cout)), and zero biases: one normal draw.  Under
nn.Conv2d's default the features shrink by about sqrt(6) at each of the
16 convs, and the perceptual term of G's loss would be round-off.  The names are
the released checkpoints' (BasicSR's RRDBNet names; the discriminator's
and VGG trunk's as the program's modules have them), so the same
dictionary loads into the program and drives the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.lib.flops import VGG19_CONV5_4, block_convs, n_upsample

Shapes = List[Tuple[str, Tuple[int, ...]]]


def _conv(name: str, cin: int, cout: int) -> Shapes:
    return [(f"{name}.weight", (cout, cin, 3, 3)), (f"{name}.bias", (cout,))]


def generator_shapes(cfg: Dict) -> Shapes:
    nf, gc, ch = cfg["filters"], cfg["growth"], cfg["channels"]
    out = _conv("conv_first", ch, nf)
    for i in range(cfg["n_blocks"]):
        for k in range(1, cfg["n_dense"] + 1):
            for j, (cin, cout) in enumerate(
                    block_convs(nf, gc, cfg["n_dense_convs"]), 1):
                out += _conv(f"body.{i}.rdb{k}.conv{j}", cin, cout)
    out += _conv("conv_body", nf, nf)
    up_out = 4 * nf if cfg["upsampler"] == "pixelshuffle" else nf
    for u in range(1, n_upsample(cfg["scale"]) + 1):
        out += _conv(f"conv_up{u}", nf, up_out)
    out += _conv("conv_hr", nf, nf) + _conv("conv_last", nf, ch)
    return out


def discriminator_shapes(cfg: Dict) -> Tuple[Shapes, Shapes]:
    """(conv shapes, BatchNorm shapes) of the VGG-style discriminator."""
    d = cfg["training"]["discriminator"]
    convs, norms, cin = [], [], cfg["channels"]
    for i in range(d["n_scales"]):
        feats = d["base_filters"] * 2 ** i
        for j in range(2):
            convs += _conv(f"conv{i}_{j}", cin, feats)
            if (i, j) != (0, 0):
                norms += [(f"bn{i}_{j}.weight", (feats,)),
                          (f"bn{i}_{j}.bias", (feats,))]
            cin = feats
    convs += _conv("head", cin, 1)
    return convs, norms


def vgg_shapes(cfg: Dict) -> Shapes:
    out, cin, k = [], cfg["channels"], 0
    for item in VGG19_CONV5_4:
        if item == "M":
            continue
        out += _conv(f"conv{k}", cin, item)
        cin, k = item, k + 1
    return out


def draw_convs(shapes: Shapes, gen: torch.Generator,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 conv weights and biases for ``shapes`` (weight before its
    bias), one uniform draw from ``gen`` on ``device``."""
    sizes = [math.prod(s) for _, s in shapes]
    bounds = []
    for name, shape in shapes:
        if name.endswith(".weight"):
            bound = 1.0 / math.sqrt(shape[1] * shape[2] * shape[3])
        bounds.append(bound)         # a bias takes its weight's bound
    scale = torch.repeat_interleave(
        torch.tensor(bounds, device=device),
        torch.tensor(sizes, device=device))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat = (flat * 2.0 - 1.0) * scale
    return {name: part.view(shape) for (name, shape), part in
            zip(shapes, flat.split(sizes))}


def draw_vgg_convs(shapes: Shapes, gen: torch.Generator,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 VGG conv weights, N(0, 2 / (9·cout)), one normal draw
    from ``gen`` on ``device``; zero biases."""
    weights = [(n, s) for n, s in shapes if n.endswith(".weight")]
    sizes = [math.prod(s) for _, s in weights]
    stds = [math.sqrt(2.0 / (s[0] * s[2] * s[3])) for _, s in weights]
    scale = torch.repeat_interleave(
        torch.tensor(stds, device=device),
        torch.tensor(sizes, device=device))
    flat = torch.randn(sum(sizes), generator=gen, device=device) * scale
    out = {n: part.view(s) for (n, s), part in
           zip(weights, flat.split(sizes))}
    for name, shape in shapes:
        if not name.endswith(".weight"):
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, _ in shapes}


def card_generator(seed: int, stream: int, device: torch.device
                   ) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + stream) % (2 ** 63))
    return gen


def generator_weights(cfg: Dict, seed: int, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    return draw_convs(generator_shapes(cfg), card_generator(seed, 1, device),
                      device)


def discriminator_weights(cfg: Dict, seed: int, device: torch.device
                          ) -> Dict[str, torch.Tensor]:
    convs, norms = discriminator_shapes(cfg)
    out = draw_convs(convs, card_generator(seed, 2, device), device)
    for name, shape in norms:
        fill = 1.0 if name.endswith(".weight") else 0.0
        out[name] = torch.full(shape, fill, device=device)
    return out


def vgg_weights(cfg: Dict, seed: int, device: torch.device
                ) -> Dict[str, torch.Tensor]:
    return draw_vgg_convs(vgg_shapes(cfg), card_generator(seed, 3, device),
                          device)
