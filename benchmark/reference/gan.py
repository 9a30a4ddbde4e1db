"""Plain float32 ESRGAN GAN training step (arXiv 1809.00219 §3.2-3.4,
with the loss weights of the configuration's ``training`` group).

One step on a uint8 HR batch (B, H, W, 3):

1. Data: HR scaled to [0, 1]; per row a horizontal flip, a vertical
   flip and (square patches) a transpose, each where a uniform draw of
   ``torch.rand((3, B), generator)`` is below 0.5, the generator seeded
   with the run's training seed and drawn once per step; LR is HR
   downscaled ÷scale by PIL's antialiased bicubic (a = −0.5, support
   2·scale, rows of weights normalised), rows then columns; both
   normalised with the ImageNet mean and std.
2. G's gradient: SR = G(LR); L1 = mean|SR − HR|; D(HR) without a
   gradient; RaGAN for G, BCE(D(SR) − mean_batch D(HR), 1); the
   perceptual term, mean|VGG(SR) − VGG(HR)| on the VGG-19 trunk to
   conv5_4 before its ReLU; total λ_adv·adv + λ_pix·L1 + λ_per·per.
3. D's gradient on fresh forwards, SR detached: 0.5·[BCE(D(HR) −
   mean D(SR), 1) + BCE(D(SR) − mean D(HR), 0)].
4. Adam on G and on D (bias-corrected, ε outside the square root), then
   the EMA of G's parameters, e ← d·e + (1 − d)·p.

D is the VGG-style patch discriminator: 3×3 convs at widths base·2^i,
stride 1 then 2 at each scale, BatchNorm on all but the first (batch
statistics over (B, H, W), variance E[x²] − E[x]² clipped at 0,
ε = 1e-5), LeakyReLU 0.2, a 1-channel 3×3 conv head.  BCE with logits
is log(1 + exp(−|x|)) + max(x, 0) − x·t, averaged.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.rrdbnet import Conv, Params, conv_f32, \
    full_float32, generator

VGG19_CONV5_4 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512)


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
                    np.where(ax < 2.0,
                             (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a, 0.0))


def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """PIL's antialiased bicubic weights, (n_out, n_in) float32."""
    scale = n_in / n_out
    support = 2.0 * max(scale, 1.0)
    mat = np.zeros((n_out, n_in))
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(0, int(center - support + 0.5))
        hi = min(n_in, int(center + support + 0.5))
        xs = np.arange(lo, hi, dtype=np.float64)
        wts = _cubic((xs - center + 0.5) / max(scale, 1.0))
        if wts.sum() != 0.0:
            wts = wts / wts.sum()
        mat[i, lo:hi] = wts
    return mat.astype(np.float32)


def downscale(hr: torch.Tensor, factor: int) -> torch.Tensor:
    """NHWC float32 ÷factor."""
    _, h, w, _ = hr.shape
    mh = torch.from_numpy(bicubic_matrix(h, h // factor)).to(hr.device)
    mw = torch.from_numpy(bicubic_matrix(w, w // factor)).to(hr.device)
    y = torch.einsum("oh,bhwc->bowc", mh, hr)
    return torch.einsum("ow,bhwc->bhoc", mw, y)


def bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return (F.softplus(-logits.abs()) + logits.clamp_min(0.0)
            - logits * target).mean()


def discriminator(p: Params, cfg: Dict, x: torch.Tensor,
                  conv: Conv = conv_f32) -> torch.Tensor:
    """NHWC normalised images -> NCHW float32 logits."""
    d = cfg["training"]["discriminator"]
    h = x.permute(0, 3, 1, 2)
    for i in range(d["n_scales"]):
        for j, stride in enumerate((1, 2)):
            h = conv(h, p[f"conv{i}_{j}.weight"], p[f"conv{i}_{j}.bias"],
                     stride)
            if (i, j) != (0, 0):
                mean = h.mean((0, 2, 3))
                var = ((h * h).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
                mul = torch.rsqrt(var + d["bn_eps"]) * p[f"bn{i}_{j}.weight"]
                h = (h - mean[None, :, None, None]) * mul[None, :, None, None] \
                    + p[f"bn{i}_{j}.bias"][None, :, None, None]
            h = F.leaky_relu(h, d["lrelu_slope"])
    return conv(h, p["head.weight"], p["head.bias"])


def vgg(p: Params, x: torch.Tensor, conv: Conv = conv_f32) -> torch.Tensor:
    """NHWC normalised images -> conv5_4 features (before the ReLU)."""
    h, k = x.permute(0, 3, 1, 2), 0
    last = len(VGG19_CONV5_4) - 1
    for idx, item in enumerate(VGG19_CONV5_4):
        if item == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        h = conv(h, p[f"conv{k}.weight"], p[f"conv{k}.bias"])
        k += 1
        if idx != last:
            h = F.relu(h)
    return h


class Adam:
    """Adam over a list of tensors, updated in place."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float):
        self.params, self.lr, self.b1, self.b2, self.eps = (
            params, lr, b1, b2, eps)
        self.m = [torch.zeros_like(t) for t in params]
        self.v = [torch.zeros_like(t) for t in params]
        self.t = 0

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2 ** 0.5 + self.eps))


class GANTraining:
    """The reference's training state: G, D and VGG parameters (float32
    copies of what it is given), both Adams, the EMA, the augmentation
    generator.  ``step(hr_u8)`` returns the step's losses as floats."""

    def __init__(self, cfg: Dict, g: Params, d: Params, v: Params,
                 seed: int, conv: Conv = conv_f32, g_rows: float = 1.0,
                 g_grad_scale: float = 1.0, percep: bool = True):
        t = cfg["training"]
        self.cfg, self.conv = cfg, conv
        # planted faults, for the readings of the limits only: G's
        # losses over the first ``g_rows`` of each batch's rows, G's
        # gradient times ``g_grad_scale``, G's perceptual term dropped
        self.g_rows, self.g_grad_scale, self.percep = (
            g_rows, g_grad_scale, percep)
        self.g = {k: x.detach().float().clone() for k, x in g.items()}
        self.d = {k: x.detach().float().clone() for k, x in d.items()}
        self.v = {k: x.detach().float().clone() for k, x in v.items()}
        a = t["adam"]
        self.g_opt = Adam(list(self.g.values()), a["lr"], a["b1"], a["b2"],
                          a["eps"])
        self.d_opt = Adam(list(self.d.values()), a["lr"], a["b1"], a["b2"],
                          a["eps"])
        self.ema = {k: x.clone() for k, x in self.g.items()}
        self.aug = torch.Generator().manual_seed(seed)
        self.first_grads: Dict[str, torch.Tensor] = {}

    def _pair(self, hr_u8: torch.Tensor):
        cfg = self.cfg
        dev = hr_u8.device
        hr = hr_u8.float() / 255.0
        if cfg["training"]["augment"]:
            draws = torch.rand((3, hr.shape[0]), generator=self.aug) < 0.5
            do_h, do_v, do_r = (x.to(dev)[:, None, None, None]
                                for x in draws)
            hr = torch.where(do_h, hr.flip(2), hr)
            hr = torch.where(do_v, hr.flip(1), hr)
            if hr.shape[1] == hr.shape[2]:
                hr = torch.where(do_r, hr.transpose(1, 2), hr)
        lr = downscale(hr, cfg["scale"])
        mean = torch.tensor(cfg["normalize_mean"], device=dev)
        std = torch.tensor(cfg["normalize_std"], device=dev)
        return (lr - mean) / std, (hr - mean) / std

    def step(self, hr_u8: torch.Tensor) -> Dict[str, float]:
        cfg, conv, t = self.cfg, self.conv, self.cfg["training"]
        with full_float32():
            lr, hr = self._pair(hr_u8)
            g_names, d_names = list(self.g), list(self.d)
            gp = [self.g[k].requires_grad_(True) for k in g_names]
            sr = generator(self.g, cfg, lr.permute(0, 3, 1, 2).contiguous(),
                           conv).permute(0, 2, 3, 1)
            n = int(sr.shape[0] * self.g_rows)
            sr_g, hr_g = sr[:n], hr[:n]
            with torch.no_grad():
                pr = discriminator(self.d, cfg, hr_g, conv)
            pix = (sr_g - hr_g).abs().mean()
            pf = discriminator(self.d, cfg, sr_g, conv)
            adv = bce(pf - pr.mean(0, keepdim=True), 1.0)
            per = ((vgg(self.v, sr_g, conv)
                    - vgg(self.v, hr_g, conv).detach()).abs().mean()
                   if self.percep else torch.zeros((), device=sr.device))
            total = (t["lambda_adv"] * adv + t["lambda_pixel"] * pix
                     + t["lambda_percep"] * per)
            g_grads = tuple(x * self.g_grad_scale for x in
                            torch.autograd.grad(total, gp))
            for x in gp:
                x.requires_grad_(False)

            dp = [self.d[k].requires_grad_(True) for k in d_names]
            srd = sr.detach()
            pr = discriminator(self.d, cfg, hr, conv)
            pf = discriminator(self.d, cfg, srd, conv)
            d_loss = 0.5 * (bce(pr - pf.mean(0, keepdim=True), 1.0)
                            + bce(pf - pr.mean(0, keepdim=True), 0.0))
            d_grads = torch.autograd.grad(d_loss, dp)
            for x in dp:
                x.requires_grad_(False)

        if self.g_opt.t == 0:
            self.first_grads = {**{f"g.{k}": x for k, x in
                                   zip(g_names, g_grads)},
                                **{f"d.{k}": x for k, x in
                                   zip(d_names, d_grads)}}
        self.g_opt.update(list(g_grads))
        self.d_opt.update(list(d_grads))
        decay = t["ema_decay"]
        with torch.no_grad():
            for k in g_names:
                self.ema[k].mul_(decay).add_(self.g[k], alpha=1.0 - decay)
        return {"loss_g": float(total.detach()),
                "loss_d": float(d_loss.detach()),
                "loss_pixel": float(pix.detach()),
                "loss_adv": float(adv.detach()),
                "loss_percep": float(per.detach())}

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every trained tensor by the names the comparison uses."""
        return {**{f"g.{k}": x for k, x in self.g.items()},
                **{f"d.{k}": x for k, x in self.d.items()},
                **{f"ema.{k}": x for k, x in self.ema.items()}}
