"""Conv initializers of the reference family, drawn from an explicit
``torch.Generator`` into OIHW weights (fan_in = in_ch · kh · kw).

- ``torch_default``: ``nn.Conv2d``'s default, U(-1/√fan_in, 1/√fan_in)
  for kernel and bias.
- ``msra_scaled``: the xinntao branch's init, Kaiming-normal (fan_in,
  gain √2) × 0.1 and zero bias.

The JAX package draws from ``jax.random``: the same seed gives other
numbers, so tests carry weights across with
``import_torch.state_dict_from_flax`` instead of re-drawing them.
"""

from __future__ import annotations

import math

import torch


def _fan_in(weight: torch.Tensor) -> int:
    return weight.shape[1] * weight.shape[2] * weight.shape[3]


@torch.no_grad()
def torch_default_(weight: torch.Tensor, bias: torch.Tensor,
                   generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(_fan_in(weight))
    weight.uniform_(-bound, bound, generator=generator)
    bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def msra_scaled_(weight: torch.Tensor, bias: torch.Tensor,
                 generator: torch.Generator, scale: float = 0.1) -> None:
    std = math.sqrt(2.0 / _fan_in(weight))
    weight.normal_(0.0, scale * std, generator=generator)
    bias.zero_()


def conv_init_(scheme: str, weight: torch.Tensor, bias: torch.Tensor,
               generator: torch.Generator) -> None:
    """Initialise one conv's (OIHW weight, bias) in place by name."""
    if scheme == "torch_default":
        torch_default_(weight, bias, generator)
    elif scheme == "msra_scaled":
        msra_scaled_(weight, bias, generator)
    else:
        raise ValueError(f"unknown init scheme {scheme!r}")
