"""Step factories of the port (this slice: the serving steps)."""

from repro_torch.training.step import (  # noqa: F401
    make_batched_prefill,
    make_decode_macro_step,
    make_serve_step,
)
