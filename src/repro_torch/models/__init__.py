"""Model families of the port (this slice: the dense decoder-only family)."""

from repro_torch.models.model import Model, build_model  # noqa: F401
