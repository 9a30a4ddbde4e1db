"""Image listing for the inference surfaces.  The training loader of the
JAX package's ``data/pipeline.py`` comes with the training slice."""

from __future__ import annotations

import os
from typing import List

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def list_images(root: str) -> List[str]:
    """Every image under ``root`` (recursive), sorted; raises when none."""
    files = []
    for dirpath, _, names in os.walk(root):
        for n in sorted(names):
            if n.lower().endswith(IMAGE_EXTS):
                files.append(os.path.join(dirpath, n))
    if not files:
        raise FileNotFoundError(f"no images under {root!r}")
    return sorted(files)
