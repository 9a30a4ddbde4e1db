"""Tiled inference (on one device or split over several), and data
parallel and multi-host training (:mod:`.dp`, :mod:`.multihost`)."""

from super_resolution_tpu_torch.parallel.dp import (  # noqa: F401
    pad_batch_to_mesh,
)
from super_resolution_tpu_torch.parallel.tiling import (  # noqa: F401
    blend_window,
    bucket_tile_h,
    extract_tiles,
    plan_tiles,
    tiled_upscale,
)
