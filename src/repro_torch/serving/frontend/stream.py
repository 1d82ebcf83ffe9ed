"""Per-request incremental token streams, surfaced at macro-step boundaries.

The continuous engine already parses every macro-step's emission matrix on
the host (``em[slot, j]`` from the ONE host sync per macro-step) and keeps
``_last_tok`` / budget mirrors, so streaming costs ZERO additional device
syncs: the engine publishes the tokens it has just parsed.  A stream
therefore advances in bursts of up to K tokens (the macro horizon), which
is the latency/throughput trade the ``serve_macro`` cost site already
prices; a request's first token is published at group-prefill time, where
first tokens are captured.

:class:`TokenStream` is the in-process surface: the engine is the single
producer, callers read per-request event lists after (or, from another
thread, during) the run.  A consumer that can no longer take tokens raises
:class:`StreamBroken` from ``publish``; the engine turns that into typed
FAILED terminal states for everything in flight.  The reference's
multi-process front end (``FrontendStream`` and its workers) is not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


class StreamBroken(RuntimeError):
    """The downstream consumer (emission worker) is gone; publishing can
    no longer succeed.  The engine fails in-flight requests typed, it does
    NOT abort the process."""


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One burst of tokens for one request.

    ``t`` is engine-relative time (same clock as ``Request`` timestamps).
    ``done`` marks the terminal event; a terminal event may carry zero
    tokens (deadline eviction, failure).
    """

    rid: str
    tokens: Tuple[int, ...]
    done: bool
    t: float


class TokenStream:
    """Single-producer per-request token stream with TTFT stamping."""

    def __init__(self) -> None:
        self._events: Dict[str, List[StreamEvent]] = {}
        self._first_s: Dict[str, float] = {}
        self._done: Dict[str, bool] = {}
        self.published_events = 0
        self.published_tokens = 0

    # ---------------------------------------------------------- producer --
    def publish(self, rid: str, tokens: Sequence[int], done: bool,
                t: float) -> None:
        """Engine-side: append a burst (called at macro boundaries and at
        group prefill).  Idempotent on terminal: publishing after ``done``
        is a no-op so failure paths can close streams defensively."""
        if self._done.get(rid):
            return
        ev = StreamEvent(rid=rid, tokens=tuple(int(x) for x in tokens),
                         done=bool(done), t=float(t))
        self._events.setdefault(rid, []).append(ev)
        if ev.tokens and rid not in self._first_s:
            self._first_s[rid] = ev.t
        if done:
            self._done[rid] = True
        self.published_events += 1
        self.published_tokens += len(ev.tokens)

    # ---------------------------------------------------------- consumer --
    def rids(self) -> List[str]:
        return list(self._events)

    def events(self, rid: str) -> List[StreamEvent]:
        return list(self._events.get(rid, ()))

    def tokens(self, rid: str) -> List[int]:
        """All tokens streamed so far for ``rid``, in order."""
        return [t for ev in self._events.get(rid, ()) for t in ev.tokens]

    def is_done(self, rid: str) -> bool:
        return self._done.get(rid, False)

    def first_token_s(self, rid: str) -> Optional[float]:
        """Engine-relative time of the first streamed token (stream TTFT
        reference; arrival-relative TTFT = this minus ``arrival_s``)."""
        return self._first_s.get(rid)

    def close(self) -> None:
        """Release downstream resources (no-op for the in-process stream;
        the multi-process subclass stops its emission worker here)."""
