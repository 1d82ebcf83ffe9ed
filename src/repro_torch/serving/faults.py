"""Fault injection + guarded device-step execution for the serve engine.

The failure model: a device step can RAISE (a transient CUDA / runtime
error), return CORRUPT output (NaN logits surfacing as garbage tokens), or
STALL (a hung kernel or driver call).  The engine wraps every dispatched
step in ``guarded_call`` — a watchdog-timed, bounded retry-with-backoff
harness — so transient faults retry, poison work fails the individual
requests it carried, and a true hang is abandoned rather than blocking
``run()`` forever.  ``FaultInjector`` makes each class reproducible on
demand so tests and drills can prove the drain invariant (every request
reaches a terminal state, the slot pool stays reusable) without real
hardware misbehaving on cue.

Injection sites fire BEFORE the step touches the pooled decode state
(``raise``/``stall`` raise in the dispatch wrapper; ``nan`` corrupts the
host-side copy of the outputs after the step), so a retried step re-runs
against intact state — the same property a real pre-launch runtime error
has.  Only an abandoned hang (``StepFailed(abandoned=True)``) leaves a
worker thread that may still write into the state it was given (the paged
pools are written in place), which is why the engine answers it with
``SlotPool.drain(fresh=True)``: new state tensors the abandoned worker
cannot reach.

Pure Python, the same classes, policy and messages as the reference's
``repro.serving.faults``; the port keeps its own copy.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, List, Optional, Tuple


class InjectedFault(RuntimeError):
    """A deliberately injected, transient step failure (retryable)."""


class FatalFault(RuntimeError):
    """An injected non-retryable failure: propagates out of ``run()`` so
    tests can prove the engine's abort path leaves it reusable."""


class WatchdogTimeout(RuntimeError):
    """The watchdog fired on a stalled step; raised to the retry loop after
    the stalled worker acknowledged cancellation (state still intact)."""


class StepFailed(RuntimeError):
    """A guarded step exhausted its retries or had to be abandoned mid-run
    (true hang: the worker never acknowledged cancellation, so the state it
    was given must be treated as lost: it may still write into it)."""

    def __init__(self, msg: str, *, abandoned: bool = False,
                 cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.abandoned = abandoned
        self.cause = cause


@dataclasses.dataclass
class FaultSpec:
    """One injected fault: ``kind`` in {raise, nan, stall}; fires at
    ``site`` (macro | prefill) after ``after`` prior calls, for ``count``
    consecutive calls.  ``stall_s`` is how long a stall sleeps if never
    cancelled; ``fatal`` upgrades a raise to ``FatalFault`` (no retry)."""

    kind: str
    site: str = "macro"
    after: int = 0
    count: int = 1
    stall_s: float = 30.0
    fatal: bool = False

    def __post_init__(self):
        if self.kind not in ("raise", "nan", "stall"):
            raise ValueError(
                f"fault kind must be raise|nan|stall, got {self.kind!r}")
        if self.site not in ("macro", "prefill"):
            raise ValueError(
                f"fault site must be macro|prefill, got {self.site!r}")


class FaultInjector:
    """Deterministic fault source the engine consults around each step.

    ``before(site, cancel)`` runs in the dispatch wrapper before the step
    touches the pooled state: a matching ``raise`` spec raises
    InjectedFault/FatalFault; a ``stall`` spec sleeps (checking ``cancel``
    so the watchdog's cancellation turns the hang into a retryable
    InjectedFault — a spec with a huge ``stall_s`` and no watchdog models
    a true hang).  ``corrupt(site, tokens)`` implements ``nan``: NaN logits
    argmax to an arbitrary in-vocab token, so the observable symptom is
    emitted garbage — modeled as an out-of-range sentinel the engine's
    token validation (piggybacked on the existing per-macro host sync)
    catches and converts to per-request FAILED."""

    def __init__(self, specs: Tuple[FaultSpec, ...] = ()):
        self.specs: List[FaultSpec] = list(specs)
        self._calls: dict = {}
        self.injected: List[Tuple[str, str, int]] = []  # (kind, site, call#)

    def add(self, spec: FaultSpec) -> None:
        self.specs.append(spec)

    def _armed(self, site: str, kinds: Tuple[str, ...],
               n: int) -> Optional[FaultSpec]:
        for spec in self.specs:
            if (spec.site == site and spec.kind in kinds
                    and spec.after <= n < spec.after + spec.count):
                return spec
        return None

    def before(self, site: str,
               cancel: Optional[threading.Event] = None) -> None:
        n = self._calls.get(site, 0)
        self._calls[site] = n + 1
        spec = self._armed(site, ("raise", "stall"), n)
        if spec is None:
            return
        self.injected.append((spec.kind, site, n))
        if spec.kind == "raise":
            if spec.fatal:
                raise FatalFault(f"injected fatal fault at {site} call {n}")
            raise InjectedFault(f"injected raise at {site} call {n}")
        # stall: hold the step, polling for watchdog cancellation
        deadline = time.monotonic() + spec.stall_s
        while time.monotonic() < deadline:
            if cancel is not None and cancel.is_set():
                raise InjectedFault(
                    f"injected stall at {site} call {n} cancelled by watchdog")
            time.sleep(0.001)

    def corrupt(self, site: str, tokens: Any,
                active_slots: Optional[List[int]] = None) -> Any:
        """Post-step token corruption for ``nan`` specs: poison the FIRST
        active slot's emitted tokens with an out-of-vocab sentinel.
        ``tokens`` is the host-side (n_slots, K) int array the engine
        already syncs — corrupting it models exactly what NaN logits do
        (argmax over NaNs emits garbage) at the point the engine can
        actually observe it."""
        n = self._calls.get(site, 1) - 1  # index of the call just made
        spec = self._armed(site, ("nan",), n)
        if spec is None or not active_slots:
            return tokens
        self.injected.append(("nan", site, n))
        tokens = tokens.copy()
        tokens[active_slots[0], ...] = -1
        return tokens


def guarded_call(thunk: Callable[[threading.Event], Any], *,
                 watchdog_s: Optional[float] = None, retries: int = 2,
                 backoff_s: float = 0.01,
                 on_retry: Optional[Callable[[int, BaseException], None]] = None,
                 on_watchdog: Optional[Callable[[int], None]] = None) -> Any:
    """Run a device-step thunk under a watchdog and bounded retry.

    ``thunk(cancel)`` performs one dispatch+sync; it receives a cancel
    Event it may poll (injected stalls do; real kernel launches cannot,
    which is exactly what the abandon path below is for).  Policy:

    * success → return the result.
    * ``FatalFault`` → re-raise immediately, no retry (the abort path).
    * any other exception → retry up to ``retries`` times with exponential
      backoff (transient runtime errors and cancelled stalls land here; the
      pooled state was not touched, so a retry is safe).
    * watchdog expiry → set ``cancel``, grace-join: if the worker
      acknowledges (raises/returns) the attempt is retried like any other
      failure; if it stays hung, abandon it and raise ``StepFailed``
      (abandoned=True) — the caller must treat in-flight state as lost.

    Runs the thunk on a worker thread ONLY when a watchdog is armed;
    without one the call is direct, so the unperturbed hot path keeps its
    thread-free dispatch."""
    if watchdog_s is None:
        watchdog_s = 0.0
    attempt = 0
    while True:
        cancel = threading.Event()
        if watchdog_s <= 0:
            try:
                return thunk(cancel)
            except FatalFault:
                raise
            except Exception as e:  # noqa: BLE001 — retry policy boundary
                err: BaseException = e
        else:
            box: dict = {}

            def _worker(cancel=cancel, box=box):
                try:
                    box["result"] = thunk(cancel)
                except BaseException as e:  # noqa: BLE001
                    box["error"] = e

            t = threading.Thread(target=_worker, daemon=True)
            t.start()
            t.join(watchdog_s)
            if t.is_alive():
                if on_watchdog is not None:
                    on_watchdog(attempt)
                cancel.set()
                t.join(max(watchdog_s, 0.2))
                if t.is_alive():
                    # true hang: the step never acknowledged cancellation;
                    # the state it holds must be assumed lost
                    raise StepFailed(
                        f"device step hung > {watchdog_s:.3f}s and ignored "
                        f"cancellation; abandoning it", abandoned=True)
                err = box.get(
                    "error", WatchdogTimeout(
                        f"device step exceeded watchdog {watchdog_s:.3f}s"))
                if "error" not in box and "result" in box:
                    # late success inside the grace join: use it
                    return box["result"]
            elif "error" in box:
                err = box["error"]
            else:
                return box["result"]
            if isinstance(err, FatalFault):
                raise err
        if attempt >= retries:
            raise StepFailed(
                f"device step failed after {attempt + 1} attempts: {err!r}",
                cause=err)
        if on_retry is not None:
            on_retry(attempt, err)
        time.sleep(backoff_s * (2 ** attempt))
        attempt += 1
