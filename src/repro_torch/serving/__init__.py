"""Serving stack of the port: request lifecycle + CostEngine scheduler,
slot-pooled decode state (dense, or paged with the radix prefix cache of
``paging.py``), the static and continuous engines, and the in-process
token stream (``frontend/``)."""

from repro_torch.serving.engine import (  # noqa: F401
    ContinuousServeEngine,
    ServeEngine,
    ServeReport,
    emitted_count,
)
from repro_torch.serving.frontend import (  # noqa: F401
    StreamBroken,
    StreamEvent,
    TokenStream,
)
from repro_torch.serving.paging import (  # noqa: F401
    BlockPool,
    PrefixMatch,
    default_kv_blocks,
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
