"""SwinIR frame cells (``kind: swinir_frames``): the frame cells' closed
loop (:mod:`drivers.frames`: one caller, one uint8 image at a time, the
window closed at the end of a cycle, a seeded reservoir of finished
images per size), with SwinIR in the generator's place.

The program runs through its command-line upscale path under the
configuration's preset (``cli upscale --preset swinir_l_real_x4``:
``train.steps.make_infer_fn`` + ``parallel.tiled_upscale`` + the uint8
glue, :class:`Upscaler`), on weights drawn from the seed
(:mod:`lib.weights_swinir`).  The check runs the float32 reference of
:mod:`reference.swinir`, tiled as the program tiles.  The candidates a
limit is read from, in the program's place on the same images: the
control (every product in fp8) and three planted faults of the
reference, the shift mask dropped, the relative bias dropped and the
cyclic shift skipped.

Besides the frame cells' two numbers the check reads a third,
``sr_edge_mean_abs_max_lsb`` (:class:`EdgeFrameErrors`): the shift mask
acts only where the cyclic shift wraps the map, in the windows that join
a frame's last 4 LR rows (columns) to its first 4, so a dropped mask
moves a thin band along each side and barely moves a 128 × 128 block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.drivers import frames
from benchmark.lib import program, ranks, traffic as traffic_lib
from benchmark.lib.compare import FrameErrors
from benchmark.lib.weights_swinir import swinir_weights
from benchmark.reference import swinir

# the control and the planted faults, in the program's place
CANDIDATES = {
    "control": lambda: swinir.fp8_ops(),
    "no_mask": lambda: swinir.Ops(mask=False),
    "no_bias": lambda: swinir.Ops(bias=False),
    "no_shift": lambda: swinir.Ops(shift=False),
}


# HR rows (columns) of a frame's side that the wrapped windows hold: the
# shift, 4 LR pixels, at x4
EDGE = 16


class EdgeFrameErrors(FrameErrors):
    """:class:`FrameErrors` and ``sr_edge_mean_abs_max_lsb``: the mean
    absolute difference, in uint8 steps, over a band of ``EDGE`` HR rows
    or columns along one side of a frame, by the worst side of any
    frame; a frame of the wrong shape reads infinity."""

    def __init__(self):
        super().__init__()
        self.edge = 0.0

    def add(self, prog: np.ndarray, ref: torch.Tensor) -> None:
        super().add(prog, ref)
        if tuple(prog.shape) != tuple(ref.shape):
            self.edge = math.inf
            return
        ad = (torch.from_numpy(prog).to(ref.device).float()
              - ref.float()).abs()
        for band in (ad[:EDGE], ad[-EDGE:], ad[:, :EDGE], ad[:, -EDGE:]):
            self.edge = max(self.edge, float(band.mean()))

    def numbers(self) -> Dict[str, float]:
        out = super().numbers()
        out["sr_edge_mean_abs_max_lsb"] = (self.edge if self.count
                                           else math.inf)
        return out


# what the program's SwinIR runs of the configuration's fixed keys
FIXED = {"in_chans": 3, "upscale": 4, "img_range": 1.0,
         "upsampler": "nearest+conv", "resi_connection": "3conv",
         "qkv_bias": True, "ape": False, "patch_norm": True,
         "window_size": 8}


def swinir_config(cfg: Dict):
    """The program's ``SwinIRConfig`` of the configuration's widths."""
    from super_resolution_tpu_torch.config import SwinIRConfig

    wrong = [k for k, v in FIXED.items() if cfg[k] != v]
    if wrong:
        raise ValueError(f"the program's SwinIR does not run {wrong} as "
                         f"the configuration states")
    return SwinIRConfig(
        embed_dim=cfg["embed_dim"], depths=tuple(cfg["depths"]),
        num_heads=tuple(cfg["num_heads"]), mlp_ratio=float(cfg["mlp_ratio"]), num_feat=cfg["num_feat"])


class Upscaler(program.Upscaler):
    """:class:`program.Upscaler` (the command-line upscale path) on the
    program's preset of the configuration's name, which must hold the
    configuration's architecture and normalisation."""

    def __init__(self, cfg: Dict, traffic: Dict, weights: Dict,
                 device: torch.device):
        from super_resolution_tpu_torch.config import preset
        from super_resolution_tpu_torch.train.steps import make_infer_fn

        base = preset(cfg["name"])
        if base.generator != swinir_config(cfg):
            raise ValueError(f"the program's preset {cfg['name']!r} departs "
                             f"from the configuration")
        self.tcfg = dataclasses.replace(base,
                                        compute_dtype=cfg["compute_dtype"])
        program._check_normalisation(self.tcfg.data, cfg)
        self.infer = make_infer_fn(self.tcfg, weights, device)
        self.device = device
        self.scale = cfg["upscale"]
        self.tile, self.halo = traffic["tile"], traffic["halo"]
        self.tile_batch = traffic["tile_batch"]


class Driver(frames.Driver):
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device, build_program: bool = True):
        if ranks.world() > 1:
            raise SystemExit("the swinir_frames driver runs on one card")
        self.cfg, self.traffic, self.device = config, traffic, device
        self.weights = swinir_weights(config, seed, device)
        self.up = (Upscaler(config, traffic, self.weights, device)
                   if build_program else None)
        self.frames = traffic_lib.make_frames(traffic, seed, device)
        self.order = traffic_lib.frame_order(traffic, seed)
        self.rng = np.random.default_rng([seed, 2])
        self.kept, self.seen = {}, {}
        self.calls, self.events = [], []

    def _reference(self, slot: int, ops: swinir.Ops = swinir.Ops()
                   ) -> torch.Tensor:
        lr = torch.from_numpy(self.frames[slot]).to(self.device)
        return swinir.upscale_frame(self.weights, self.cfg, lr,
                                    self.traffic["tile"],
                                    self.traffic["halo"], ops)

    def check(self) -> Dict[str, float]:
        """The kept images against the float32 reference."""
        errs = EdgeFrameErrors()
        for items in self.kept.values():
            for slot, sr in items:
                errs.add(sr, self._reference(slot))
        return errs.numbers()

    def candidate(self, name: str) -> Dict[str, float]:
        """One of ``CANDIDATES`` in the program's place, on the first
        ``check_per_size`` images of each size, judged as a run is."""
        if name not in CANDIDATES:
            raise ValueError(f"swinir frame cells have no candidate "
                             f"{name!r}")
        errs = EdgeFrameErrors()
        k = self.traffic["check_per_size"]
        picked: Dict[Tuple[int, int], int] = {}
        for slot, frame in enumerate(self.frames):
            size = frame.shape[:2]
            if picked.get(size, 0) < k:
                picked[size] = picked.get(size, 0) + 1
                sr = self._reference(slot, CANDIDATES[name]()).cpu().numpy()
                errs.add(sr, self._reference(slot))
        return errs.numbers()
