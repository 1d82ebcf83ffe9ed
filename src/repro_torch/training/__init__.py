"""Step factories of the port: training and the serving steps."""

from repro_torch.training.step import (  # noqa: F401
    TrainLoopConfig,
    init_train_state,
    make_batched_prefill,
    make_decode_macro_step,
    make_grad_fn,
    make_serve_step,
    make_train_step,
    train_state_shapes,
)
