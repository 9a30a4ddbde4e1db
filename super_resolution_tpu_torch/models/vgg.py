"""VGG-19 perceptual feature extractor in PyTorch, frozen: the conv
trunk truncated at conv5_4 pre-activation (torchvision
``vgg19.features[:35]``), as in the JAX package's ``models/vgg.py``.
NHWC in and out; modules are named ``conv0`` .. ``conv15`` like the flax
tree.  Used only inside the perceptual loss; its parameters never
require a gradient.

Weights come from the npz of ``python -m
super_resolution_tpu_torch.tools.convert_vgg vgg19.pth out.npz`` through
:func:`load_vgg_params`; without a file the trunk keeps its random init
(a random-feature perceptual loss, what the tests hold against the JAX
trunk with the same weights).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from super_resolution_tpu_torch.config import VGGConfig
from super_resolution_tpu_torch.device import no_tf32
from super_resolution_tpu_torch.models.initializers import conv_init_


class VGGFeatures(nn.Module):
    """Truncated VGG-19 trunk: conv1_1 .. conv5_4 (pre-activation)."""

    def __init__(self, cfg: VGGConfig = VGGConfig(),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 channels: int = 3):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cin, n_conv = channels, 0
        for item in cfg.arch:
            if item == "M":
                continue
            conv = nn.Conv2d(cin, item, 3, 1, 1)
            conv_init_("torch_default", conv.weight, conv.bias, generator)
            setattr(self, f"conv{n_conv}", conv)
            cin, n_conv = item, n_conv + 1
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_conv, last = 0, len(self.cfg.arch) - 1
        with no_tf32():
            h = x.permute(0, 3, 1, 2).to(self.dtype)
            for idx, item in enumerate(self.cfg.arch):
                if item == "M":
                    h = F.max_pool2d(h, 2, 2)
                    continue
                conv = getattr(self, f"conv{n_conv}")
                h = F.conv2d(h, conv.weight.to(self.dtype),
                             conv.bias.to(self.dtype), padding=1)
                n_conv += 1
                if idx != last:      # the final conv5_4 stays pre-activation
                    h = F.relu(h)
        return h.float().permute(0, 2, 3, 1)


def load_vgg_params(npz_path: str) -> Dict[str, torch.Tensor]:
    """Converted VGG-19 weights (``tools.convert_vgg``) as a state
    dict of :class:`VGGFeatures`.  The npz holds ``conv{i}_kernel``
    (HWIO) and ``conv{i}_bias`` for i in conv order 0..15."""
    raw = np.load(npz_path)
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"conv{i}_kernel" in raw:
        sd[f"conv{i}.weight"] = torch.from_numpy(np.ascontiguousarray(
            raw[f"conv{i}_kernel"].astype(np.float32).transpose(3, 2, 0, 1)))
        sd[f"conv{i}.bias"] = torch.from_numpy(
            raw[f"conv{i}_bias"].astype(np.float32))
        i += 1
    if i == 0:
        raise ValueError(f"no conv weights found in {npz_path}")
    return sd
