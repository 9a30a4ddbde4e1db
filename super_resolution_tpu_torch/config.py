"""Configuration of the port's inference path.

:class:`GeneratorConfig` and :class:`DataConfig` are the JAX package's
(``super_resolution_tpu/config.py``) field for field, so configs of the
two packages compare equal.  :class:`InferConfig` holds the fields of
the JAX ``TrainConfig`` that inference reads (the generator, the data
normalisation, ``compute_dtype``, ``data_parallel``, ``seed``); the
training fields come with the training slice.  ``preset`` knows the two
inference presets of the JAX package.

``conv_impl`` stays a field so configs compare equal, but the port
takes only ``"auto"``: every conv dispatches by the device of the
tensor it is given (the dense-block kernel on CUDA, its plain version on
the CPU).  There is no backend fallback to resolve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


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
    tail_up: str = "naive"            # "polyphase" is not ported yet

    def __post_init__(self):
        if self.conv_impl != "auto":
            raise NotImplementedError(
                f"conv_impl={self.conv_impl!r}: the port dispatches every "
                f"conv by the tensor's device and takes only 'auto'; the "
                f"JAX package's other conv paths are queued in ROADMAP.md")

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
class DataConfig:
    """Patch pipeline settings (only the normalisation is read by the
    inference path; the rest keeps the JAX package's fields)."""

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
class InferConfig:
    """What inference reads of the JAX package's ``TrainConfig``."""

    generator: GeneratorConfig = GeneratorConfig()
    data: DataConfig = DataConfig()
    compute_dtype: str = "bfloat16"   # conv compute dtype; params stay fp32
    data_parallel: int = 1
    seed: int = 0


INFER_PRESETS = ("infer_single", "infer_tiled")


def preset(name: str) -> InferConfig:
    """The JAX package's inference presets: single-image fp32 and tiled
    large-frame bf16."""
    presets = {
        "infer_single": InferConfig(compute_dtype="float32"),
        "infer_tiled": InferConfig(compute_dtype="bfloat16"),
    }
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; the port has "
                       f"{sorted(presets)} (training presets come with the "
                       f"training slice, ROADMAP.md)")
    return presets[name]
