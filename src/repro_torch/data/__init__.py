"""Deterministic synthetic training data (the counterpart of
``repro.data``)."""

from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLMData,
    make_batch_specs,
)
