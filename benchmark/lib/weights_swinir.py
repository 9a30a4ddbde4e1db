"""SwinIR's seeded weights, drawn on the card in one call per kind of
draw, under the released checkpoint's names (less the buffers
``relative_position_index`` and ``attn_mask``, which are not weights),
so the same dictionary loads into the program and drives the reference.

The draw (the configuration's ``init``, ``strong``) is one at which the
trunk moves the output, so that a fault in the attention shows in the
uint8 frame: the Linears take nn.Linear's default, U(−1/√fan_in,
1/√fan_in) for weight and bias; the relative-position tables N(0, 3²);
the trunk's convs (``conv_first``, the '3conv' stacks,
``conv_after_body``) Kaiming normal weights, std √(2/fan_in); the tail's
convs (``conv_before_upsample`` to ``conv_last``) nn.Conv2d's default,
U(−1/√fan_in, 1/√fan_in), which keeps the frame inside the uint8 range;
every conv bias nn.Conv2d's; LayerNorms 1 and 0.  Under SwinIR's own
``_init_weights`` (Linears and tables trunc-normal std 0.02, convs
nn.Conv2d's default) the attention's faults move the frame less than
bfloat16 rounding does; with every conv Kaiming normal the frame
saturates at 0 and 255 over most of its pixels, by a share that changes
with the seed, and the readings with it (PERF.md gives them).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.lib.weights import card_generator

# (name, shape, kind, scale): kind "uniform" (scale the bound), "normal"
# (std) or "const" (the value)
Draw = List[Tuple[str, Tuple[int, ...], str, float]]
TABLE_STD = 3.0


def shapes(cfg: Dict) -> Draw:
    """Every weight with its draw."""
    if cfg["init"] != "strong":
        raise ValueError(f"unknown SwinIR init {cfg['init']!r}")
    e, nf, w = cfg["embed_dim"], cfg["num_feat"], cfg["window_size"]
    hidden = int(e * cfg["mlp_ratio"])
    out: Draw = []

    def conv(name, cin, cout, k=3, trunk=True):
        bound = 1.0 / math.sqrt(cin * k * k)
        weight = ("normal", math.sqrt(2.0) * bound) if trunk else \
            ("uniform", bound)
        out.extend([(f"{name}.weight", (cout, cin, k, k), *weight),
                    (f"{name}.bias", (cout,), "uniform", bound)])

    def lin(name, cin, cout):
        bound = 1.0 / math.sqrt(cin)
        out.extend([(f"{name}.weight", (cout, cin), "uniform", bound),
                    (f"{name}.bias", (cout,), "uniform", bound)])

    def ln(name, c):
        out.extend([(f"{name}.weight", (c,), "const", 1.0),
                    (f"{name}.bias", (c,), "const", 0.0)])

    def three(name, c):
        conv(f"{name}.0", c, c // 4)
        conv(f"{name}.2", c // 4, c // 4, 1)
        conv(f"{name}.4", c // 4, c)

    conv("conv_first", cfg["in_chans"], e)
    ln("patch_embed.norm", e)
    for i, (depth, heads) in enumerate(zip(cfg["depths"],
                                           cfg["num_heads"])):
        for j in range(depth):
            n = f"layers.{i}.residual_group.blocks.{j}"
            ln(f"{n}.norm1", e)
            out.append((f"{n}.attn.relative_position_bias_table",
                        ((2 * w - 1) ** 2, heads), "normal", TABLE_STD))
            lin(f"{n}.attn.qkv", e, 3 * e)
            lin(f"{n}.attn.proj", e, e)
            ln(f"{n}.norm2", e)
            lin(f"{n}.mlp.fc1", e, hidden)
            lin(f"{n}.mlp.fc2", hidden, e)
        three(f"layers.{i}.conv", e)
    ln("norm", e)
    three("conv_after_body", e)
    conv("conv_before_upsample.0", e, nf, trunk=False)
    for name in ("conv_up1", "conv_up2", "conv_hr"):
        conv(name, nf, nf, trunk=False)
    conv("conv_last", nf, cfg["in_chans"], trunk=False)
    return out


def n_parameters(cfg: Dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in shapes(cfg))


def swinir_weights(cfg: Dict, seed: int, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """float32 weights on ``device`` from the run's seed."""
    items = shapes(cfg)
    gen = card_generator(seed, 4, device)
    out: Dict[str, torch.Tensor] = {}
    for kind in ("uniform", "normal"):
        part = [(n, s, k) for n, s, kd, k in items if kd == kind]
        sizes = [math.prod(s) for _, s, _ in part]
        scale = torch.repeat_interleave(
            torch.tensor([k for _, _, k in part], device=device),
            torch.tensor(sizes, device=device))
        flat = torch.empty(sum(sizes), device=device)
        if kind == "uniform":
            flat.uniform_(-1.0, 1.0, generator=gen)
        else:
            flat.normal_(generator=gen)
        flat *= scale
        for (name, shape, _), t in zip(part, flat.split(sizes)):
            out[name] = t.view(shape)
    for name, shape, kind, value in items:
        if kind == "const":
            out[name] = torch.full(shape, value, device=device)
    return {name: out[name] for name, _, _, _ in items}
