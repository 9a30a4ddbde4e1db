"""The numbers that decide ``correct``, and their limits.

Frames: the program's uint8 SR frame against the reference's, in uint8
steps (LSB): the mean absolute difference over every sampled frame's
pixels and channels (``sr_mean_abs_lsb``), and the worst mean absolute
difference of one 128 x 128 HR block (``sr_block_mean_abs_max_lsb``);
a frame of the wrong shape reads infinity.  The mean, not the root mean
square: where rounding moves a pixel by one step at most, the mean
grows with the share of pixels it moves, in proportion to the error
before the uint8 rounding, where the root mean square grows with its
square root and separates the control from sound runs less.

Training, per leaf (``leaf_gaps``): the gap between the program's norm
of a leaf and the reference's, |‖p‖ − ‖r‖|, over the reference's norm
of that leaf or of its model's median leaf, whichever is larger; taken
by the worst leaf, or by the median leaf where the worst is noise
(``drivers/gan_train.py`` says which).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 128


def load_limits(cell: str) -> Dict[str, Dict]:
    path = os.path.join(HERE, "limits", f"{cell}.json")
    with open(path) as f:
        return json.load(f)["limits"]


class FrameErrors:
    """Accumulates the uint8 differences of (program, reference) frames."""

    def __init__(self):
        self.total, self.count, self.worst = 0.0, 0, 0.0

    def add(self, prog: np.ndarray, ref: torch.Tensor) -> None:
        if tuple(prog.shape) != tuple(ref.shape):
            self.worst = self.total = math.inf
            return
        d = (torch.from_numpy(prog).to(ref.device).float() - ref.float())
        ad = d.abs().sum(-1)[None, None]             # (1, 1, H, W)
        h, w = ad.shape[-2:]
        pad = (0, -w % BLOCK, 0, -h % BLOCK)
        blk = F.avg_pool2d(F.pad(ad, pad), BLOCK)
        blk_n = F.avg_pool2d(F.pad(torch.ones_like(ad), pad), BLOCK) * 3.0
        self.total += float(ad.sum())
        self.count += d.numel()
        self.worst = max(self.worst, float((blk / blk_n).max()))

    def numbers(self) -> Dict[str, float]:
        if not self.count:
            return {"sr_mean_abs_lsb": math.inf,
                    "sr_block_mean_abs_max_lsb": math.inf}
        return {"sr_mean_abs_lsb": self.total / self.count,
                "sr_block_mean_abs_max_lsb": self.worst}


def _norms(tree: Dict[str, torch.Tensor], keys: Iterable[str]
           ) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(tree[k].detach().float()))
            for k in keys}


def group(key: str) -> str:
    """A leaf's model: the part of its name before the first dot."""
    return key.split(".", 1)[0]


def group_medians(norms: Dict[str, float]) -> Dict[str, float]:
    """The median leaf norm of each model (G, D and G's EMA apart: their
    gradients differ by orders of magnitude)."""
    out: Dict[str, List[float]] = {}
    for k, v in norms.items():
        out.setdefault(group(k), []).append(v)
    return {g: float(np.median(v)) for g, v in out.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: List[str]) -> Dict[str, float]:
    """Each leaf's gap; the median leaf is its model's."""
    p, r = _norms(prog, keys), _norms(ref, keys)
    med = group_medians(r)
    return {k: abs(p[k] - r[k]) / max(r[k], med[group(k)], 1e-30)
            for k in keys}


def worst(gaps: Dict[str, float]) -> float:
    return max((g if math.isfinite(g) else math.inf
                for g in gaps.values()), default=math.inf)


def median(gaps: Dict[str, float]) -> float:
    vals = list(gaps.values())
    if not vals or not all(math.isfinite(g) for g in vals):
        return math.inf
    return float(np.median(vals))


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]
          ) -> Tuple[bool, Dict[str, Dict[str, Optional[float]]]]:
    """(correct, {name: {"value", "limit"}}): every compared number at
    or under its limit; a compared number without a limit, or not
    finite, fails.  A number whose entry says ``"compared": false`` is
    reported with no limit and decides nothing."""
    checks, ok = {}, True
    for name, value in numbers.items():
        entry = limits.get(name, {})
        compared = entry.get("compared", True)
        limit = entry.get("limit") if compared else None
        checks[name] = {"value": value, "limit": limit}
        if compared and (limit is None or not value <= limit):
            ok = False
    return ok, checks
