"""Optimizer of the training loop: AdamW with global-norm clipping, the
warmup-cosine schedule and gradient compression (the counterparts of
``repro.optim``)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
)
from repro_torch.optim.compression import (  # noqa: F401
    CompressionState,
    compress_gradients,
    init_compression,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
