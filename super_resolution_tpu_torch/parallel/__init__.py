"""Tiled inference on one device (data parallelism comes with DDP)."""

from super_resolution_tpu_torch.parallel.tiling import (  # noqa: F401
    blend_window,
    bucket_tile_h,
    extract_tiles,
    plan_tiles,
    tiled_upscale,
)
