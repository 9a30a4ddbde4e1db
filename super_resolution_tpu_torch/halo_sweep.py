"""Read side of the release metadata that ``--halo auto`` uses.

A release checkpoint can carry its admissible tiling halo (the smallest
overlap whose tiled output matches whole-frame inference) in a JSON
sidecar next to it, written by the JAX package's ``cli export``.  The
sweep that measures it comes with the port's export slice.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def halo_meta_path(checkpoint: str) -> str:
    """Sidecar location for a checkpoint's release metadata: a JSON next
    to a file artifact, inside a checkpoint directory."""
    if os.path.isdir(checkpoint):
        return os.path.join(checkpoint, "release_meta.json")
    return checkpoint + ".meta.json"


def read_halo_meta(checkpoint: str) -> Optional[dict]:
    path = halo_meta_path(checkpoint)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def read_admissible_halo(checkpoint: str) -> Optional[int]:
    """The stamped admissible halo for ``checkpoint``, or None when no
    metadata exists (or the sweep found no candidate admissible)."""
    meta = read_halo_meta(checkpoint)
    if not meta:
        return None
    halo = meta.get("admissible_halo")
    return None if halo is None else int(halo)
