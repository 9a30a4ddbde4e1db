"""Ops of the port: the dense-block kernel (``ops.dense_block``), the
single-conv kernel (``ops.conv3x3``), shuffles, PIL-parity bicubic
resampling and self-ensemble."""

from super_resolution_tpu_torch.ops.dense_block import dense_block  # noqa: F401
from super_resolution_tpu_torch.ops.ensemble import self_ensemble  # noqa: F401
from super_resolution_tpu_torch.ops.resize import (  # noqa: F401
    bicubic_downsample,
    bicubic_resize,
)
from super_resolution_tpu_torch.ops.shuffle import (  # noqa: F401
    nearest_upsample,
    pixel_shuffle,
)
