"""Models of the port: the RRDBNet generator."""

from super_resolution_tpu_torch.models.rrdb import (  # noqa: F401
    RRDB,
    DenseBlock,
    RRDBNet,
)
