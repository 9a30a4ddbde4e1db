"""VGG-19 ``.pth`` -> npz weight conversion: the port of the JAX
package's ``tools/convert_vgg.py``.

    python -m super_resolution_tpu_torch.tools.convert_vgg vgg19.pth \\
        vgg19_features.npz

The ImageNet weights are not in the repository and there is no network,
so they come out of band: torchvision's ``vgg19-*.pth`` state dict, or
any dict (or module) holding ``features.{idx}.weight/bias`` or bare
``{idx}.weight/bias``.  The npz holds ``conv{i}_kernel`` (HWIO) and
``conv{i}_bias`` for the 16 convs through conv5_4, the layout that
:func:`super_resolution_tpu_torch.models.vgg.load_vgg_params` reads (and
the JAX package's loader, byte for byte).  Runs on the CPU: it moves
weights, it computes nothing.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)


def convert(src: str, dst: str) -> None:
    sd = torch.load(src, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out = {}
    for n, idx in enumerate(VGG_CONV_IDX):
        for prefix in (f"features.{idx}", str(idx)):
            if f"{prefix}.weight" in sd:
                w = sd[f"{prefix}.weight"].numpy()
                b = sd[f"{prefix}.bias"].numpy()
                break
        else:
            raise KeyError(f"conv at features index {idx} not found in {src}")
        out[f"conv{n}_kernel"] = w.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        out[f"conv{n}_bias"] = b
    np.savez(dst, **out)
    print(f"wrote {dst}: {len(out) // 2} convs, "
          f"{sum(v.size for v in out.values()):,} params")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit(__doc__)
    convert(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
