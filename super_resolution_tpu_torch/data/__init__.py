"""Image IO, normalisation, augmentation and the patch loaders."""

from super_resolution_tpu_torch.data.augment import (  # noqa: F401
    augment_batch,
    denormalize,
    normalize,
    preprocess_batch,
    to_uint8_image,
)
from super_resolution_tpu_torch.data.image_io import (  # noqa: F401
    merge_alpha,
    split_alpha,
    upscale_alpha,
)
from super_resolution_tpu_torch.data.pipeline import (  # noqa: F401
    PatchLoader,
    SyntheticPatches,
    device_prefetch,
    list_images,
    pair_images,
)
