"""Training of the port: state, steps and the loop."""

from super_resolution_tpu_torch.train.loop import train  # noqa: F401
from super_resolution_tpu_torch.train.steps import (  # noqa: F401
    make_gan_step,
    make_infer_fn,
    make_pretrain_step,
)
