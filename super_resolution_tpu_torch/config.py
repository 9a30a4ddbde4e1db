"""Configuration of the port.

The dataclasses are the JAX package's (``super_resolution_tpu/
config.py``) field for field, so configs of the two packages compare
equal, and ``preset`` knows its presets by name.  ``train_gan_dp8``
(``data_parallel=8``) trains on eight devices, one rank each
(:mod:`parallel.dp`).

``conv_impl`` picks the conv path of the JAX package's name
(:func:`resolve_conv_impl`): ``"auto"`` is ``"pallas_cf"``, the JAX
package's TPU path (every dense block through the dense-block kernel,
NCHW inside); ``"pallas_cf_tail"`` also runs ``conv_body``, the upsample
convs and ``conv_hr`` through the single-conv kernel; ``"pallas"`` runs
every conv through the single-conv kernel and ``"pallas_fused"`` every
dense block through the NHWC dense-block entry, both NHWC inside.  Each
kernel dispatches by the device of the tensor it is given (the kernel
on CUDA, its plain version on the CPU), so there is no backend
fallback.  ``"lax"`` is the JAX package's XLA conv path: every conv
through ``F.conv2d`` (cuDNN on the card), no kernel of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional, Tuple, Union

IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)
# SwinIR's img_range 1 normalisation: x − the DIV2K mean, unit std
DIV2K_MEAN: Tuple[float, float, float] = (0.4488, 0.4371, 0.4040)
UNIT_STD: Tuple[float, float, float] = (1.0, 1.0, 1.0)

CONV_IMPLS = ("auto", "lax", "pallas_cf", "pallas_cf_tail", "pallas",
              "pallas_fused")


def resolve_conv_impl(impl: str) -> str:
    """``"auto"`` -> ``"pallas_cf"``, the JAX package's choice on its own
    accelerator; named impls pass through unchanged."""
    return "pallas_cf" if impl == "auto" else impl


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """RRDBNet generator hyper-parameters.  The canonical 23-block ×4
    generator (filters 64, growth 32, nearest+conv upsampler) has
    16,697,987 parameters; ``growth=64`` + ``upsampler='pixelshuffle'``
    + ``lrelu_slope=0.01`` is the eriklindernoren variant."""

    channels: int = 3
    filters: int = 64            # base feature width (nf)
    growth: int = 32             # dense-block growth channels (gc)
    n_blocks: int = 23
    n_dense: int = 3             # dense blocks per RRDB
    n_dense_convs: int = 5       # convs per dense block
    scale: int = 4               # two ×2 upsample stages
    res_scale: float = 0.2
    lrelu_slope: float = 0.2
    upsampler: str = "nearest_conv"   # "nearest_conv" | "pixelshuffle"
    init: str = "msra_scaled"         # "msra_scaled" (×0.1) | "torch_default"
    conv_impl: str = "auto"
    tail_up: str = "naive"            # "naive" | "polyphase"

    def __post_init__(self):
        if self.conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {self.conv_impl!r}; have "
                             f"{CONV_IMPLS}")

    @property
    def n_upsample(self) -> int:
        s, n = self.scale, 0
        while s > 1:
            if s % 2:
                raise ValueError(f"scale {self.scale} is not a power of two")
            s //= 2
            n += 1
        return n


@dataclasses.dataclass(frozen=True)
class SwinIRConfig:
    """SwinIR hyper-parameters (arXiv 2108.10257; ``define_model`` of
    ``main_test_swinir.py``, task ``real_sr`` with ``--large_model``):
    the defaults are SwinIR-L real-world ×4
    (``003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4_GAN.pth``), 28,013,059
    parameters.  The widths vary between SwinIR's releases; what the port
    runs of the rest is fixed: RGB ×4, upsampler 'nearest+conv',
    resi_connection '3conv', qkv biases, ``patch_norm``, ``img_range`` 1
    (the ``swinir_l_real_x4`` preset normalises x − the DIV2K mean), and
    8×8 windows (``ops.window_attention.WINDOW``; every SwinIR SR release).
    Inference only (no D, VGG or backward for it)."""

    channels: ClassVar[int] = 3
    scale: ClassVar[int] = 4
    n_upsample: ClassVar[int] = 2
    lrelu_slope: ClassVar[float] = 0.2     # the tail's

    embed_dim: int = 240
    depths: Tuple[int, ...] = (6,) * 9
    num_heads: Tuple[int, ...] = (8,) * 9
    mlp_ratio: float = 2.0
    num_feat: int = 64

    def __post_init__(self):
        if len(self.depths) != len(self.num_heads):
            raise ValueError("depths and num_heads differ in length")


AnyGeneratorConfig = Union[GeneratorConfig, SwinIRConfig]


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """VGG-style patch discriminator: conv pairs at widths
    (64, 128, 256, 512), stride 1 then stride 2, BatchNorm except on the
    very first conv, LeakyReLU 0.2, and a 1-channel conv head producing
    an (H/16, W/16) logit map.  4,693,697 params at default width."""

    channels: int = 3
    base_filters: int = 64
    n_scales: int = 4            # number of width-doubling stages
    lrelu_slope: float = 0.2
    bn_momentum: float = 0.9     # flax convention: 1 - torch momentum (0.1)
    bn_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    """Frozen VGG-19 trunk truncated at conv5_4 pre-activation
    (torchvision ``vgg19.features[:35]``).  ``weights_path`` is an npz
    from ``tools/convert_vgg.py``; None means random init."""

    weights_path: Optional[str] = None
    # conv widths of VGG-19 cfg E, 'M' marking 2x2 maxpools; truncated
    # after conv5_4 (no ReLU, no final pool)
    arch: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                   512, 512, 512, 512, "M", 512, 512, 512, 512)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """ESRGAN loss weights: total G loss = lambda_percep * perceptual +
    lambda_adv * RaGAN + lambda_pixel * L1."""

    lambda_adv: float = 5e-3
    lambda_pixel: float = 1e-2
    use_perceptual: bool = True
    # "vgg" (VGG-19 conv5_4 features) or "d_features" (discriminator
    # feature matching, the VGG-free substitute)
    perceptual_source: str = "vgg"
    lambda_percep: float = 1.0
    # False = single fake-vs-E[real] direction; True = both directions
    # averaged (the paper's recipe)
    ragan_g_two_sided: bool = False


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Adam settings; ``lr_halve_steps`` is the MultiStepLR-style
    schedule (lr x0.5 at the listed steps), empty = constant lr."""

    lr: float = 2e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    lr_halve_steps: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Patch pipeline settings: 48x48 LR -> 192x192 HR patches, bicubic
    /4 synthesis, ImageNet normalisation, flip/rotate augmentation."""

    dataset_dir: str = "data/train"
    lr_dir: Optional[str] = None
    hr_patch: int = 192
    hr_patch_w: Optional[int] = None
    scale: int = 4
    batch_size: int = 16
    augment: bool = True
    n_workers: int = 4
    normalize_mean: Tuple[float, float, float] = IMAGENET_MEAN
    normalize_std: Tuple[float, float, float] = IMAGENET_STD
    prefetch: int = 2

    @property
    def lr_patch(self) -> int:
        return self.hr_patch // self.scale

    @property
    def patch_hw(self) -> Tuple[int, int]:
        return (self.hr_patch, self.hr_patch_w or self.hr_patch)

    @property
    def lr_patch_hw(self) -> Tuple[int, int]:
        h, w = self.patch_hw
        return (h // self.scale, w // self.scale)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Top-level config: the union of the train CLI's flags plus the
    compute dtype.  Inference reads the generator, the data
    normalisation, ``compute_dtype``, ``data_parallel`` and ``seed``."""

    generator: AnyGeneratorConfig = GeneratorConfig()
    discriminator: DiscriminatorConfig = DiscriminatorConfig()
    vgg: VGGConfig = VGGConfig()
    loss: LossConfig = LossConfig()
    optim_g: OptimConfig = OptimConfig()
    optim_d: OptimConfig = OptimConfig()
    data: DataConfig = DataConfig()

    n_epochs: int = 200
    steps_per_epoch: int = 1000
    warmup_batches: int = 500    # L1-only pretrain steps before the GAN
    sample_interval: int = 100
    checkpoint_interval: int = 1000
    checkpoint_dir: str = "checkpoints"
    seed: int = 0

    # True: D's running stats update on all four forwards of an iteration
    # (hr, sr, hr, sr detached), the reference family's bookkeeping;
    # False: only on the D step's two forwards.
    bn_track_g_step: bool = False
    # Compute the D(hr) forward once per iteration (train/steps.py
    # _dedup_gan_step); ignored when bn_track_g_step is set.
    dedup_d_hr: bool = False
    # EMA of G's params (BasicSR 'params_ema'); 0.0 disables.
    ema_decay: float = 0.999
    eval_use_ema: bool = True

    compute_dtype: str = "bfloat16"   # conv compute dtype; params stay fp32
    data_parallel: int = 1
    donate_buffers: bool = True       # kept so configs compare equal


def ema_maturity_steps(decay: float) -> int:
    """Steps before the EMA is a release-grade artifact: 5 time constants
    of e <- d*e + (1-d)*p, i.e. 5/(1-d) (5000 at the default 0.999).
    Below it a from-scratch EMA is still dominated by the random init."""
    return int(math.ceil(5.0 / max(1e-9, 1.0 - decay)))


PRESETS = ("infer_single", "pretrain_psnr", "train_gan", "train_gan_dfm",
           "infer_tiled", "train_gan_dp8")
# the port's own: other architectures, for ``upscale`` and ``serve``
MODEL_PRESETS = ("swinir_l_real_x4",)


def preset(name: str) -> TrainConfig:
    """The JAX package's presets by name (:data:`PRESETS`), and the
    port's :data:`MODEL_PRESETS`."""
    presets = {
        "infer_single": TrainConfig(compute_dtype="float32"),
        "pretrain_psnr": TrainConfig(
            loss=LossConfig(lambda_adv=0.0, use_perceptual=False),
            warmup_batches=10**9,
            optim_g=OptimConfig(lr=2e-4),
        ),
        "train_gan": TrainConfig(),
        # the VGG-free recipe: D-feature matching anchors harder and
        # slows D
        "train_gan_dfm": TrainConfig(
            loss=LossConfig(perceptual_source="d_features",
                            lambda_percep=1.0, lambda_pixel=0.1),
            optim_d=OptimConfig(lr=3e-5),
        ),
        "infer_tiled": TrainConfig(compute_dtype="bfloat16"),
        "train_gan_dp8": TrainConfig(data_parallel=8),
        # SwinIR-L real-world x4 (upscale and serve only)
        "swinir_l_real_x4": TrainConfig(
            generator=SwinIRConfig(),
            data=DataConfig(normalize_mean=DIV2K_MEAN,
                            normalize_std=UNIT_STD)),
    }
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; have "
                       f"{sorted(PRESETS + MODEL_PRESETS)}")
    return presets[name]
