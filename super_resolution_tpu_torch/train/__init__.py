"""Steps of the port (inference only in this slice)."""

from super_resolution_tpu_torch.train.steps import make_infer_fn  # noqa: F401
