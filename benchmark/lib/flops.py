"""Operations and bytes from shapes, and the H100's published peaks.

A frozen copy of the roofline arithmetic of the repository's
``chip_smoke.py`` (``PEAK_FLOPS``, ``PEAK_BYTES``, ``block_bound``,
``bwd_bound``, ``conv_bound``), plus the model-level counts the
per-layer metrics divide by: the generator's MACs per LR pixel from its
widths, and the convolutions of one GAN training step.  Only
convolutions are counted; activations, norms, losses and resampling are
left out (under 1 % of the step's operations).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12            # HBM3, bytes/s


def _elt(dtype_name: str) -> int:
    return 2 if dtype_name == "bfloat16" else 4


def block_convs(c: int, growth: int, n: int = 5) -> List[Tuple[int, int]]:
    """(cin, cout) of each conv of an n-conv dense block."""
    return [(c + k * growth, c if k == n - 1 else growth) for k in range(n)]


def _bound(flops: float, nbytes: float, dtype_name: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def block_bound(shape, growth: int, dtype_name: str, n: int = 5):
    """(bound_ms, bound_by, flops, bytes) of one n-conv dense block on
    NCHW ``shape``: each input (x, weights, biases) read once, y written
    once."""
    b, c, h, w = shape
    elt = _elt(dtype_name)
    convs = block_convs(c, growth, n)
    macs = sum(9 * cin * cout for cin, cout in convs)
    wbytes = sum(9 * cin * cout * elt + 4 * cout for cin, cout in convs)
    flops = 2 * b * h * w * macs
    nbytes = 2 * b * c * h * w * elt + wbytes
    return _bound(flops, nbytes, dtype_name)


def bwd_bound(shape, growth: int, dtype_name: str, n: int = 5):
    """(bound_ms, bound_by, flops, bytes) of one n-conv dense block's
    backward: twice the forward's operations (a data and a weight
    product per conv); the saved feature buffer, the cotangent and the
    weights read once, dx, dW (float32) and db written once."""
    b, c, h, w = shape
    elt = _elt(dtype_name)
    _, _, fwd_flops, _ = block_bound(shape, growth, dtype_name, n)
    convs = block_convs(c, growth, n)
    n_w = sum(9 * cin * cout for cin, cout in convs)
    n_b = sum(cout for _, cout in convs)
    pix = b * h * w
    nbytes = (pix * (c + (n - 1) * growth) * elt
              + 2 * pix * c * elt
              + n_w * elt
              + (n_w + n_b) * 4)
    return _bound(2 * fwd_flops, nbytes, dtype_name)


def conv_bound(shape, cout: int, dtype_name: str, out_elt=None):
    """(bound_ms, bound_by, flops, bytes) of one 3x3 conv on NHWC
    ``shape``: x, weights and bias read once, y written once."""
    b, h, w, cin = shape
    elt = _elt(dtype_name)
    out_elt = out_elt or elt
    flops = 2 * b * h * w * 9 * cin * cout
    nbytes = (b * h * w * (cin * elt + cout * out_elt)
              + 9 * cin * cout * elt + 4 * cout)
    return _bound(flops, nbytes, dtype_name)


# --------------------------------------------------------------------------
# The generator
# --------------------------------------------------------------------------

def n_upsample(scale: int) -> int:
    n = 0
    while scale > 1:
        if scale % 2:
            raise ValueError(f"scale {scale} is not a power of two")
        scale //= 2
        n += 1
    return n


def generator_macs_per_lr_px(cfg: Dict) -> Dict[str, int]:
    """MACs per LR pixel of an RRDBNet from its widths, by part:
    ``trunk`` (the dense blocks), ``head`` (conv_first, conv_body),
    ``tail`` (the upsample convs, conv_hr, conv_last) and ``total``."""
    nf, gc, ch = cfg["filters"], cfg["growth"], cfg["channels"]
    block = sum(9 * cin * cout for cin, cout in
                block_convs(nf, gc, cfg["n_dense_convs"]))
    trunk = cfg["n_blocks"] * cfg["n_dense"] * block
    head = 9 * ch * nf + 9 * nf * nf
    tail, res = 0, 1
    for _ in range(n_upsample(cfg["scale"])):
        if cfg["upsampler"] == "pixelshuffle":
            tail += 9 * nf * 4 * nf * res
            res *= 4
        else:
            res *= 4
            tail += 9 * nf * nf * res
    tail += 9 * nf * nf * res + 9 * nf * ch * res
    return {"trunk": trunk, "head": head, "tail": tail,
            "total": trunk + head + tail}


def generator_flops_per_lr_px(cfg: Dict) -> float:
    return 2.0 * generator_macs_per_lr_px(cfg)["total"]


# --------------------------------------------------------------------------
# The GAN step
# --------------------------------------------------------------------------

def _conv_out(n: int, stride: int) -> int:
    return (n + 2 - 3) // stride + 1        # 3x3, padding 1


def discriminator_convs(h: int, w: int, channels: int, base: int,
                        n_scales: int) -> List[int]:
    """MACs per image of each conv of the VGG-style discriminator, in
    order (conv0_0 first, the head last)."""
    macs, cin = [], channels
    for i in range(n_scales):
        feats = base * 2 ** i
        for stride in (1, 2):
            h, w = _conv_out(h, stride), _conv_out(w, stride)
            macs.append(h * w * 9 * cin * feats)
            cin = feats
    macs.append(h * w * 9 * cin * 1)
    return macs


def vgg_convs(h: int, w: int, channels: int, arch: Sequence) -> List[int]:
    """MACs per image of each conv of the VGG trunk (``arch``: widths,
    ``"M"`` a 2x2 max pool)."""
    macs, cin = [], channels
    for item in arch:
        if item == "M":
            h, w = h // 2, w // 2
            continue
        macs.append(h * w * 9 * cin * item)
        cin = item
    return macs


VGG19_CONV5_4 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512)


def gan_step_flops(cfg: Dict, batch: int, hr: int) -> Dict[str, float]:
    """Model FLOPs of one ESRGAN GAN step on ``batch`` HR patches of
    ``hr``², by part.

    - G: one forward, and a backward with the data and weight products
      (the first conv's data product is not needed: LR needs no
      gradient).
    - D: four forwards (D(hr) for the G loss, D(sr), and the D step's
      D(hr) and D(sr detached)); the G pass's backward into SR (data
      products only); the D step's two backwards (weight products, and
      data products but the first conv's).
    - VGG: two forwards (SR, HR) and the backward into SR (data
      products)."""
    lr = hr // cfg["scale"]
    g_fwd = 2.0 * batch * lr * lr * generator_macs_per_lr_px(cfg)["total"]
    g_first = 2.0 * batch * lr * lr * 9 * cfg["channels"] * cfg["filters"]
    t = cfg["training"]
    dcfg = t["discriminator"]
    d = [2.0 * batch * m for m in discriminator_convs(
        hr, hr, cfg["channels"], dcfg["base_filters"], dcfg["n_scales"])]
    v = [2.0 * batch * m for m in vgg_convs(hr, hr, cfg["channels"],
                                            VGG19_CONV5_4)]
    d_fwd, v_fwd = sum(d), sum(v)
    parts = {"generator": 3 * g_fwd - g_first,
             "discriminator": 4 * d_fwd + d_fwd + 2 * (2 * d_fwd - d[0]),
             "vgg": 3 * v_fwd}
    parts["total"] = sum(parts.values())
    return parts
