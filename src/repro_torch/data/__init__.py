"""Deterministic synthetic training data (the counterpart of
``repro.data``)."""

from repro_torch.data.pipeline import SyntheticLMData  # noqa: F401
