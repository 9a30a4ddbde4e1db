"""Image IO and normalisation for the port's inference path."""

from super_resolution_tpu_torch.data.augment import (  # noqa: F401
    denormalize,
    normalize,
    to_uint8_image,
)
from super_resolution_tpu_torch.data.image_io import (  # noqa: F401
    merge_alpha,
    split_alpha,
    upscale_alpha,
)
from super_resolution_tpu_torch.data.pipeline import list_images  # noqa: F401
