"""Frame cells (``kind: frames``): one caller, closed loop, one uint8
frame at a time through the command-line upscale path
(:class:`program.Upscaler`), on one card.

Set-up draws the generator's weights and the cycle of frames from the
seed and sends ``warmup_frames`` frames, every slot of the cycle in
turn, so every size has run before the window opens.  The window sends
the cycle in seeded orders until ``--seconds`` have passed; each frame
is timed on the host from the uint8 frame on the host to the uint8 SR
frame on the host (the copy to the host synchronises).  The window closes at the end of a cycle, so
every run does the same work in every whole cycle it sends, whatever
order the seed gives.  A seeded reservoir keeps ``check_per_size``
finished frames of each size, which the reference judges once the
window has closed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.lib import program, ranks, traffic as traffic_lib
from benchmark.lib.compare import FrameErrors
from benchmark.lib.weights import generator_weights
from benchmark.reference import rrdbnet
from benchmark.reference.lowp import conv_fp8


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device, build_program: bool = True):
        if ranks.world() > 1:
            raise SystemExit("the frames driver runs on one card: a cell "
                             "on several needs a driver of its own")
        self.cfg, self.traffic, self.device = config, traffic, device
        self.weights = generator_weights(config, seed, device)
        self.up = (program.Upscaler(config, traffic, self.weights, device)
                   if build_program else None)
        self.frames = traffic_lib.make_frames(traffic, seed, device)
        self.order = traffic_lib.frame_order(traffic, seed)
        self.rng = np.random.default_rng([seed, 2])
        self.kept: Dict[Tuple[int, int], List[Tuple[int, np.ndarray]]] = {}
        self.seen: Dict[Tuple[int, int], int] = {}
        self.calls: List[Tuple[int, int, int]] = []
        self.events: list = []

    def warmup(self) -> None:
        n = len(self.frames)
        for i in range(self.traffic["warmup_frames"]):
            self.up(self.frames[i % n])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _keep(self, slot: int, sr: np.ndarray) -> None:
        """Reservoir sampling per frame size, drawn from the seed."""
        size = self.frames[slot].shape[:2]
        k = self.traffic["check_per_size"]
        n = self.seen[size] = self.seen.get(size, 0) + 1
        kept = self.kept.setdefault(size, [])
        if n <= k:
            kept.append((slot, sr))
        else:
            j = int(self.rng.integers(n))
            if j < k:
                kept[j] = (slot, sr)

    def _traced_infer(self):
        from torch.profiler import record_function

        infer, cuda = self.up.infer, self.device.type == "cuda"

        def run(x: torch.Tensor) -> torch.Tensor:
            self.calls.append(tuple(x.shape[:3]))
            with record_function("bench.generator"):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    y = infer(x)
                    end.record()
                    self.events.append((start, end))
                else:
                    y = infer(x)
            return y

        return run

    def run(self, seconds: Optional[float], count: Optional[int] = None,
            traced: bool = False) -> Dict:
        """The window: until ``seconds`` have passed, or ``count``
        frames; returns what the metrics read."""
        from torch.profiler import record_function

        self.calls, self.events = [], []
        infer = self._traced_infer() if traced else None
        lat: List[float] = []
        lr_px = out_px = 0
        cycle = len(self.frames)
        t_start = t1 = time.perf_counter()
        for slot in self.order:
            lr = self.frames[slot]
            t0 = time.perf_counter()
            if traced:
                with record_function("bench.frame"):
                    sr = self.up(lr, infer)
            else:
                sr = self.up(lr)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            lr_px += lr.shape[0] * lr.shape[1]
            out_px += sr.shape[0] * sr.shape[1]
            self._keep(slot, sr)
            if count is not None:
                if len(lat) >= count:
                    break
            elif t1 - t_start >= seconds and len(lat) % cycle == 0:
                break
        gen_s = sum(s.elapsed_time(e) for s, e in self.events) / 1e3
        return {"t_start": t_start, "window_s": t1 - t_start,
                "latencies": lat, "frames": len(lat), "lr_px": lr_px,
                "out_px": out_px, "calls": list(self.calls),
                "generator_event_s": gen_s if self.events else None,
                "frame_wall_s": sum(lat)}

    @staticmethod
    def end_to_end(m: Dict) -> Dict[str, float]:
        lat = sorted(m["latencies"])
        return {"upscale_mp_s": m["out_px"] / 1e6 / m["window_s"],
                "frame_p95_s": float(np.percentile(lat, 95))}

    def free_program(self) -> None:
        self.up = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, slot: int, conv=rrdbnet.conv_f32) -> torch.Tensor:
        lr = torch.from_numpy(self.frames[slot]).to(self.device)
        return rrdbnet.upscale_frame(self.weights, self.cfg, lr,
                                     self.traffic["tile"],
                                     self.traffic["halo"], conv)

    def check(self) -> Dict[str, float]:
        """The kept frames against the float32 reference."""
        errs = FrameErrors()
        for items in self.kept.values():
            for slot, sr in items:
                errs.add(sr, self._reference(slot))
        return errs.numbers()

    def candidate(self, name: str) -> Dict[str, float]:
        """The control (``name`` "control") in the program's place: the
        reference in fp8 on the same frames as a run would check,
        judged the same way."""
        if name != "control":
            raise ValueError(f"frame cells have no candidate {name!r}")
        errs = FrameErrors()
        k = self.traffic["check_per_size"]
        picked: Dict[Tuple[int, int], int] = {}
        for slot, frame in enumerate(self.frames):
            size = frame.shape[:2]
            if picked.get(size, 0) < k:
                picked[size] = picked.get(size, 0) + 1
                sr = self._reference(slot, conv_fp8).cpu().numpy()
                errs.add(sr, self._reference(slot))
        return errs.numbers()
