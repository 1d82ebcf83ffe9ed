"""Serving stack of the port: request lifecycle + CostEngine scheduler,
slot-pooled decode state, and the static and continuous engines."""

from repro_torch.serving.engine import (  # noqa: F401
    ContinuousServeEngine,
    ServeEngine,
    ServeReport,
    emitted_count,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    InvalidRequestError,
    Request,
    RequestState,
    ServeScheduler,
    supports_chunked_prefill,
    validate_request,
)
from repro_torch.serving.slots import SlotPool  # noqa: F401
