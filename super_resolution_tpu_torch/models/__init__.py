"""Models of the port: the RRDBNet generator, the VGG-style
discriminator and the VGG-19 feature trunk."""

from super_resolution_tpu_torch.models.discriminator import (  # noqa: F401
    Discriminator,
)
from super_resolution_tpu_torch.models.rrdb import (  # noqa: F401
    RRDB,
    DenseBlock,
    RRDBNet,
)
from super_resolution_tpu_torch.models.vgg import (  # noqa: F401
    VGGFeatures,
    load_vgg_params,
)
