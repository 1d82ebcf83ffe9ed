"""Atomic, restartable checkpoints of the train state (the counterpart of
``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step,
    restore,
    restore_resharded,
    save,
)
