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

from super_resolution_tpu_torch.import_torch import vgg_convs


def convert(src: str, dst: str) -> None:
    sd = torch.load(src, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out = {}
    for n, (w, b) in enumerate(vgg_convs(sd)):
        out[f"conv{n}_kernel"] = w.numpy().transpose(2, 3, 1, 0)  # -> HWIO
        out[f"conv{n}_bias"] = b.numpy()
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
