"""Training cells (``kind: gan_train``): ESRGAN GAN steps back to back,
on one card or as one rank per card.

Set-up draws G's, D's and VGG's weights and a pool of uint8 HR batches
of the traffic's global ``batch`` on the card from the seed (every rank
draws the same), builds the program's training state and step
(:class:`program.GANTrainer`), and drives that same object through its
first ``checked_steps`` steps on the pool's first batches (the checked
steps), then ``warmup_steps`` more.  Rank r feeds rows [r·b, (r+1)·b)
of each global batch, b = batch / ranks; the program averages the
gradients over the ranks.  The window runs steps on the pool in turn
until ``--seconds`` have passed (on several ranks the ranks agree on
the step that closes it), then synchronises.

The check, on rank 0: the reference trains from the same weights on
the same global batches for the checked steps.  Compared are
``percep_gap_step1``, the gap of step 1's perceptual loss over the
reference's; the first gradient as Adam received it, G's by the median
leaf (``grad_gap_g_median``) and D's by the median leaf
(``grad_gap_d_median``); and each leaf's change after the checked steps
by the worst leaf (``change_gap``; G, D and G's EMA).  Reported beside
them, and compared by no limit: the first gradient of G by its worst
leaf (``grad_gap_g_worst``), of both models by the worst leaf
(``grad_gap``), and each checked step's G and D losses by the worst
(``loss_gap``).  PERF.md gives the
readings each limit was set from.  Leaves whose reference gradient is
under a thousandth of their model's median leaf's are left out of the
gradient and the change: their gradient is round-off (D's conv biases
ahead of BatchNorm, and D's head bias, which the relativistic losses
cancel), and Adam moves them by round-off alone.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from benchmark.lib import program, ranks, traffic as traffic_lib
from benchmark.lib.compare import (
    group,
    group_medians,
    leaf_gaps,
    median,
    worst,
)
from benchmark.lib.flops import gan_step_flops
from benchmark.lib.weights import (
    discriminator_weights,
    generator_weights,
    vgg_weights,
)
from benchmark.reference.gan import GANTraining
from benchmark.reference.lowp import conv_fp8
from benchmark.reference.rrdbnet import conv_f32

LOSSES = ("loss_g", "loss_d")
PARTS = ("loss_pixel", "loss_adv", "loss_percep")

# the control and the planted faults, in the program's place: the
# reference with these arguments (``readings.py`` reads them)
CANDIDATES = {
    "control": dict(conv=conv_fp8),
    "half_batch": dict(rows=0.5),
    "g_half_batch": dict(g_rows=0.5),
    "g_grad_x2": dict(g_grad_scale=2.0),
    "no_vgg": dict(percep=False),
}


def _of(gaps: Dict[str, float], model: str) -> Dict[str, float]:
    return {k: v for k, v in gaps.items() if group(k) == model}


class Driver:
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device, build_program: bool = True):
        self.cfg, self.traffic, self.device = config, traffic, device
        self.rank, self.world = ranks.rank(), ranks.world()
        self.hr = config["training"]["hr_patch"]
        self.batch = traffic["batch"]
        if self.batch % self.world:
            raise ValueError(f"a global batch of {self.batch} does not "
                             f"divide over {self.world} ranks")
        self.local = self.batch // self.world
        self.train_seed = seed % 2 ** 63
        self.weights = {"g": generator_weights(config, seed, device),
                        "d": discriminator_weights(config, seed, device),
                        "v": vgg_weights(config, seed, device)}
        self.pool = traffic_lib.make_batches(traffic, self.hr, seed, device)
        self.i = 0
        self.trainer = None
        if not build_program:
            return
        self.trainer = program.GANTrainer(config, self.local, self.weights,
                                          self.train_seed, device)
        self.losses: List[Dict[str, float]] = []
        for k in range(traffic["checked_steps"]):
            m = self.trainer.step(self._next())
            self.losses.append({n: float(m[n]) for n in LOSSES + PARTS})
            if k == 0:
                self.first = {n: g.detach().clone() for n, g in
                              self.trainer.first_gradients().items()}
        self.after = {n: x.detach().clone()
                      for n, x in self.trainer.leaves().items()}

    def _next(self) -> torch.Tensor:
        b = self.pool[self.i % len(self.pool)]
        self.i += 1
        return b[self.rank * self.local:(self.rank + 1) * self.local]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        for _ in range(self.traffic["warmup_steps"]):
            self.trainer.step(self._next())
        self._sync()

    def run(self, seconds: Optional[float], count: Optional[int] = None,
            traced: bool = False) -> Dict:
        """The window: until ``seconds`` have passed, or ``count``
        steps; returns what the metrics read."""
        from torch.profiler import record_function

        n = 0
        t_start = time.perf_counter()
        while True:
            if traced:
                with record_function("bench.gan_step"):
                    self.trainer.step(self._next())
            else:
                self.trainer.step(self._next())
            n += 1
            if count is not None:
                if n >= count:
                    break
            elif ranks.any_(time.perf_counter() - t_start >= seconds,
                            self.device):
                break
        self._sync()
        return {"t_start": t_start,
                "window_s": time.perf_counter() - t_start, "steps": n,
                "batch": self.batch, "hr": self.hr,
                "step_flops": gan_step_flops(self.cfg, self.batch,
                                             self.hr)["total"]}

    @staticmethod
    def end_to_end(m: Dict) -> Dict[str, float]:
        mp = m["steps"] * m["batch"] * m["hr"] ** 2 / 1e6
        return {"train_hr_mp_s": mp / m["window_s"]}

    def free_program(self) -> None:
        self.trainer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, conv=conv_f32, rows: float = 1.0, **fault
                   ) -> GANTraining:
        ref = GANTraining(self.cfg, self.weights["g"], self.weights["d"],
                          self.weights["v"], self.train_seed, conv, **fault)
        n = int(self.batch * rows)
        ref.losses = [ref.step(self.pool[k % len(self.pool)][:n])
                      for k in range(self.traffic["checked_steps"])]
        return ref

    def _numbers(self, losses, first, after, ref: GANTraining
                 ) -> Dict[str, float]:
        loss_gap = max(abs(p[n] - r[n]) / max(abs(r[n]), 1e-30)
                       for p, r in zip(losses, ref.losses) for n in LOSSES)
        norms = {k: float(torch.linalg.vector_norm(g))
                 for k, g in ref.first_grads.items()}
        med = group_medians(norms)

        def grad_of(k: str) -> str:       # an EMA leaf follows its param
            return "g." + k[4:] if k.startswith("ema.") else k

        moved = [k for k in ref.leaves() if norms[grad_of(k)]
                 >= 1e-3 * med[group(grad_of(k))]]
        grads = leaf_gaps(first, ref.first_grads,
                          [k for k in moved if k in norms])
        init = {**{f"g.{k}": x for k, x in self.weights["g"].items()},
                **{f"d.{k}": x for k, x in self.weights["d"].items()},
                **{f"ema.{k}": x for k, x in self.weights["g"].items()}}
        ref_leaves = ref.leaves()
        d_prog = {k: after[k].float() - init[k] for k in moved}
        d_ref = {k: ref_leaves[k] - init[k] for k in moved}
        p1, r1 = losses[0]["loss_percep"], ref.losses[0]["loss_percep"]
        return {
            "percep_gap_step1": abs(p1 - r1) / max(abs(r1), 1e-30),
            "grad_gap_g_median": median(_of(grads, "g")),
            "grad_gap_d_median": median(_of(grads, "d")),
            "change_gap": worst(leaf_gaps(d_prog, d_ref, moved)),
            "grad_gap_g_worst": worst(_of(grads, "g")),
            "grad_gap": worst(grads), "loss_gap": loss_gap}

    def check(self) -> Optional[Dict[str, float]]:
        """Rank 0's numbers against the float32 reference over the
        global batches; None on the other ranks."""
        if self.rank:
            return None
        return self._numbers(self.losses, self.first, self.after,
                             self._reference())

    def candidate(self, name: str) -> Dict[str, float]:
        """The numbers of one of ``CANDIDATES`` in the program's place:
        the control (the reference in fp8), or the float32 reference
        with a planted fault (half of each batch left out, the mean
        taken over the rest; the same for G's losses alone; G's
        gradient doubled; G's perceptual term dropped)."""
        cand = self._reference(**CANDIDATES[name])
        return self._numbers(cand.losses, cand.first_grads, cand.leaves(),
                             self._reference())
