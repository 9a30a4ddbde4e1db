"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes its inputs from the run's seed.

- ``frames``: a cycle of LR frames, ``per_cycle`` of each ``w`` x ``h``
  size; the frames' pixels are drawn on the card (a smooth field plus
  fine noise, uint8 RGB) and kept on the host, where the caller hands
  them in.  The window sends the cycle again and again, each time in a
  new order drawn from the seed, so every seed runs the same sizes.
- ``gan_train``: a pool of ``pool`` batches of ``batch`` uint8 HR
  patches made on the card, fed in turn; every row of the pool differs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.lib.weights import card_generator

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(mix: str) -> Dict:
    with open(os.path.join(HERE, "traffic", f"{mix}.json")) as f:
        return json.load(f)


def frame_cycle(traffic: Dict) -> List[Tuple[int, int]]:
    """(w, h) of every slot of one cycle, in the file's order."""
    return [(s["w"], s["h"]) for s in traffic["sizes"]
            for _ in range(s["per_cycle"])]


def frame_order(traffic: Dict, seed: int) -> Iterator[int]:
    """Cycle slots in the order the window sends them: each cycle a
    permutation drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    n = len(frame_cycle(traffic))
    while True:
        yield from (int(i) for i in rng.permutation(n))


def _images(n: int, h: int, w: int, gen: torch.Generator,
            device: torch.device) -> torch.Tensor:
    """(n, h, w, 3) uint8: a field smooth over 16 pixels, plus noise."""
    low = torch.rand((n, 3, h // 16 + 2, w // 16 + 2), generator=gen,
                     device=device)
    smooth = F.interpolate(low, size=(h, w), mode="bilinear",
                           align_corners=False)
    noise = torch.rand((n, 3, h, w), generator=gen, device=device)
    img = smooth * 215.0 + noise * 40.0
    return img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)


def make_frames(traffic: Dict, seed: int, device: torch.device
                ) -> List[np.ndarray]:
    """One host uint8 (h, w, 3) frame per slot of the cycle."""
    gen = card_generator(seed, 10, device)
    return [_images(1, h, w, gen, device)[0].contiguous().cpu().numpy()
            for w, h in frame_cycle(traffic)]


def make_batches(traffic: Dict, hr: int, seed: int, device: torch.device
                 ) -> List[torch.Tensor]:
    """``pool`` uint8 (batch, hr, hr, 3) batches on ``device``."""
    gen = card_generator(seed, 11, device)
    b, n = traffic["batch"], traffic["pool"]
    rows = _images(b * n, hr, hr, gen, device).contiguous()
    return list(rows.split(b))
