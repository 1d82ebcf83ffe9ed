"""Serving front end.  The port has the in-process token stream
(``stream.py``): per-request incremental token streams published at
macro-step boundaries with zero added device syncs.  The reference's host
topology discovery and worker processes are not ported yet."""

from repro_torch.serving.frontend.stream import (StreamBroken, StreamEvent,
                                                 TokenStream)

__all__ = ["StreamBroken", "StreamEvent", "TokenStream"]
