"""Training of the port: state, steps, the loop and the eval batch."""

from super_resolution_tpu_torch.train.loop import train  # noqa: F401
from super_resolution_tpu_torch.train.state import (  # noqa: F401
    GANTrainState,
    build_models,
    init_state,
    make_optimizer,
    n_params,
)
from super_resolution_tpu_torch.train.steps import (  # noqa: F401
    eval_batch,
    make_gan_step,
    make_infer_fn,
    make_pretrain_step,
)
