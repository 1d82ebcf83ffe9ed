"""Multi-process serving front end: pinned intake + emission workers.

Process layout (one deployment)::

    parent (engine thread, pinned to its reserved physical core)
      ├── intake worker 0..N-1   validate + pre-process submissions
      │     in:  per-worker bounded Queue   (round-robin from parent)
      │     out: per-worker bounded Queue   (validated payloads / errors;
      │          per-worker so a hard-killed process can only lock-poison
      │          queues its own respawn replaces)
      └── emission worker        coalesced token bursts -> detok streams
            in:  bounded Queue  (parent flushes at macro boundaries)
            out: result Queue   (final per-request transcript at drain)

Everything crosses process boundaries through BOUNDED ``multiprocessing``
queues: a full queue blocks the producer, so front-end backpressure
composes with the engine's admission ``queue_limit`` and the parent never
buffers unboundedly on behalf of a slow worker.

Workers are spawned, never forked: the parent holds CUDA state and the
engine's threads.  No child touches the card.  What crosses a queue is
plain Python (ints, floats, bools, strs, lists, tuples, dicts): importing
torch registers reductions that would carry a tensor across by shared
memory or a CUDA IPC handle, so ``FrontendStream.publish`` turns every
token into an ``int`` before the put.  A worker imports this module, the
topology module and (intake only) the scheduler's request validation; the
port's package ``__init__`` files resolve their names lazily, so that
chain loads no torch.

Failure semantics (composing with the request lifecycle): a crashed worker
is first auto-respawned up to ``FrontendConfig.respawn`` times under the
same bounded retry-with-backoff harness the engine uses for device steps
(``guarded_call``): the replacement is re-pinned from the original
affinity plan, must pass the two-ping readiness barrier, and inherits the
dead worker's outstanding work — intake submissions are resubmitted
(validation is pure and idempotent), emission state is rebuilt by
replaying the log of previously published bursts so the assembled
transcript survives.  Only after respawn attempts exhaust does the typed
path fire: intake submissions become typed FAILED requests before they
reach the engine; a dead emission worker raises
:class:`~repro_torch.serving.frontend.stream.StreamBroken` out of
``FrontendStream.publish``, which the engine converts into typed FAILED
for every in-flight request — every request still reaches a terminal
state and every slot and page returns to the pool.

Token generation itself never leaves the engine process, so front-end
output is token-identical to the in-process engine by construction; the
emission worker re-assembles per-request streams and the parent
cross-checks them against the engine's transcript at ``finish()``.

The reference is ``repro.serving.frontend.workers``; the port keeps its
names, messages, timeouts and failure policy, and adds three things: a
worker's readiness pong also says whether its pin took effect (so
``workers_pinned`` counts the pinned workers), ``close()`` gives the
calling thread back the CPU mask ``start()`` found, and the front end
times its spawn and each respawn (``spawn_s``, ``respawn_s``).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue as _queue
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.faults import guarded_call
from repro_torch.serving.frontend import topology as topo_mod
from repro_torch.serving.frontend.stream import StreamBroken, TokenStream

_JOIN_TIMEOUT_S = 5.0
_RESULT_TIMEOUT_S = 60.0


class FrontendError(RuntimeError):
    """Front-end infrastructure failure (worker death, protocol breach)."""


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Deployment knobs for :class:`ServingFrontend`.

    ``workers``/``coalesce`` arrive here already resolved to ints — the
    ``serve_ipc`` cost site (Runtime layer) owns the "auto" choice.
    ``queue_depth`` bounds every IPC queue (backpressure, not buffering).
    ``pin`` requests affinity masks from :mod:`.topology`; hosts where
    ``sched_setaffinity`` is unavailable degrade to unpinned workers.
    ``respawn`` bounds how many times a crashed worker is automatically
    replaced per incident (0 disables self-healing: a dead worker goes
    straight to the typed-FAILED path).
    """

    workers: int = 2
    coalesce: int = 1
    pin: bool = False
    queue_depth: int = 64
    respawn: int = 2

    def __post_init__(self) -> None:
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.coalesce < 1:
            raise ValueError(f"coalesce must be >= 1, got {self.coalesce}")
        if self.queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.respawn < 0:
            raise ValueError(f"respawn must be >= 0, got {self.respawn}")


def _pickled_size(obj: Any) -> int:
    try:
        return len(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    except Exception:
        return 0


# ---------------------------------------------------------------------------
# Worker entry points (module-level: importable under a spawn context)
# ---------------------------------------------------------------------------

def _intake_main(wid: int, in_q, out_q, cpus: Optional[Sequence[int]],
                 max_len: int) -> None:
    """Validate + pre-process submissions.  Messages:

    in:  ("ping", t)                      -> out ("pong", wid, t, pinned)
         ("req", payload_dict)           -> out ("ok", rid, payload)
                                          | out ("invalid", rid, message)
         None                            -> out ("bye", wid); exit
    """
    pinned = bool(cpus) and topo_mod.apply_affinity(cpus)
    # heavier imports AFTER pinning so they run on the assigned core
    from repro_torch.serving.scheduler import (InvalidRequestError, Request,
                                               validate_request)
    while True:
        msg = in_q.get()
        if msg is None:
            out_q.put(("bye", wid))
            return
        kind = msg[0]
        if kind == "ping":
            out_q.put(("pong", wid, msg[1], pinned))
            continue
        payload = msg[1]
        rid = payload.get("rid", "?")
        try:
            req = Request(
                rid=str(rid),
                prompt=[int(t) for t in payload["prompt"]],
                max_new_tokens=int(payload["max_new_tokens"]),
                arrival_s=float(payload.get("arrival_s", 0.0)),
                priority=int(payload.get("priority", 0)),
                deadline_s=payload.get("deadline_s"),
                ttft_deadline_s=payload.get("ttft_deadline_s"),
            )
            validate_request(req, max_len=max_len)
        except InvalidRequestError as e:
            out_q.put(("invalid", rid, str(e)))
            continue
        except Exception as e:  # malformed payload: typed, not fatal
            out_q.put(("invalid", rid, f"malformed submission: {e}"))
            continue
        out_q.put(("ok", rid, {
            "prompt": req.prompt,
            "prompt_len": req.prompt_len,
            "max_new_tokens": req.max_new_tokens,
            "arrival_s": req.arrival_s,
            "priority": req.priority,
            "deadline_s": req.deadline_s,
            "ttft_deadline_s": req.ttft_deadline_s,
            "intake_worker": wid,
        }))


def _detok(tokens: Sequence[int]) -> str:
    """Stand-in detokenizer: the repo serves raw token ids (no vocab file),
    so "text" is the canonical space-joined id rendering."""
    return " ".join(str(int(t)) for t in tokens)


def _emission_main(in_q, out_q, cpus: Optional[Sequence[int]]) -> None:
    """Assemble per-request streams and detokenize off the engine thread.

    in:  ("ping", t)                          -> out ("pong", -1, t, pinned)
         ("emit", [(rid, tokens, done, t), ...])   coalesced event burst
         None -> out ("result", transcript); exit

    transcript: rid -> {"tokens": [...], "text": str, "events": int,
                        "first_t": float | None, "done": bool}
    """
    pinned = bool(cpus) and topo_mod.apply_affinity(cpus)
    transcript: Dict[str, Dict[str, Any]] = {}
    while True:
        msg = in_q.get()
        if msg is None:
            for rec in transcript.values():
                rec["text"] = _detok(rec["tokens"])
            out_q.put(("result", transcript))
            return
        kind = msg[0]
        if kind == "ping":
            out_q.put(("pong", -1, msg[1], pinned))
            continue
        for rid, tokens, done, t in msg[1]:
            rec = transcript.setdefault(
                rid, {"tokens": [], "text": "", "events": 0,
                      "first_t": None, "done": False})
            rec["tokens"].extend(int(x) for x in tokens)
            rec["events"] += 1
            if tokens and rec["first_t"] is None:
                rec["first_t"] = t
            if done:
                rec["done"] = True


# ---------------------------------------------------------------------------
# Parent-side deployment
# ---------------------------------------------------------------------------

class FrontendStream(TokenStream):
    """TokenStream that forwards every publish to the emission worker,
    coalescing ``coalesce`` events per IPC message.  The engine calls
    ``publish`` at macro boundaries; a dead emission worker surfaces as
    :class:`StreamBroken` (the engine then fails in-flight typed).  Every
    field of an event is made plain Python here, so no tensor or numpy
    scalar is ever pickled onto a queue."""

    def __init__(self, frontend: "ServingFrontend", coalesce: int) -> None:
        super().__init__()
        self._fe = frontend
        self._coalesce = max(1, int(coalesce))
        self._buf: List[Tuple[str, Tuple[int, ...], bool, float]] = []

    def publish(self, rid: str, tokens: Sequence[int], done: bool,
                t: float) -> None:
        if self._done.get(rid):
            return
        super().publish(rid, tokens, done, t)
        self._buf.append((str(rid), tuple(int(x) for x in tokens),
                          bool(done), float(t)))
        # terminal events flush eagerly so downstream consumers see request
        # completion without waiting for the coalescing window to fill
        if done or len(self._buf) >= self._coalesce:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            burst, self._buf = self._buf, []
            self._fe._emit_burst(burst)

    def close(self) -> None:
        self.flush()


class ServingFrontend:
    """Owns the worker processes, queues, affinity plan, and IPC accounting
    for one serve run.  Lifecycle::

        fe = ServingFrontend(cfg, max_len=...)
        fe.start()
        payloads, failures = fe.submit(submissions)   # intake workers
        stream = fe.stream()                          # -> engine
        ... engine.run(...) publishes into stream ...
        transcript = fe.finish()                      # emission transcript
        fe.close()

    ``spawn_s`` is the wall time from the first spawn to the last worker's
    first pong (process start and imports), ``respawn_s`` each respawn's
    time to a ready replacement; ``ping_round_trips_s`` the steady-state
    round trips the ``serve_ipc`` ledger rows measure against.
    """

    def __init__(self, config: FrontendConfig, *, max_len: int,
                 topology: Optional[topo_mod.HostTopology] = None) -> None:
        self.config = config
        self.max_len = int(max_len)
        self.topology = topology
        self.plan: Optional[topo_mod.AffinityPlan] = None
        self.engine_pinned = False
        self.ipc_messages = 0
        self.ipc_bytes = 0
        self.respawns = 0
        self.ping_round_trips_s: List[float] = []
        self.spawn_s: Optional[float] = None
        self.respawn_s: List[float] = []
        self._pinned: List[bool] = []  # per worker slot, from its pong
        self._saved_mask: Optional[set] = None
        self._worker_cpus: List[Optional[Sequence[int]]] = []
        self._emit_log: List[Any] = []
        self._ctx = None
        self._intake_procs: List[Any] = []
        self._intake_qs: List[Any] = []
        # one reply queue PER worker: a hard-killed process can die holding
        # a queue's shared write lock, poisoning it for every later writer
        # — per-worker queues keep the blast radius to the queues a respawn
        # replaces anyway
        self._intake_outs: List[Any] = []
        self._emit_q = None
        self._emit_out = None
        self._emit_proc = None
        self._started = False
        self._rr = 0

    @property
    def workers_pinned(self) -> int:
        """Live worker slots (intake and emission) whose pin took effect."""
        return sum(self._pinned)

    # ----------------------------------------------------------- startup --
    def start(self) -> None:
        import multiprocessing as mp
        if self._started:
            raise FrontendError("frontend already started")
        cfg = self.config
        if self.topology is None:
            self.topology = topo_mod.discover()
        worker_cpus: List[Optional[Sequence[int]]] = [None] * (cfg.workers + 1)
        if cfg.pin:
            # +1 planned mask: the emission worker is a worker too
            self.plan = topo_mod.plan_affinity(self.topology, cfg.workers + 1)
            getaff = getattr(os, "sched_getaffinity", None)
            self._saved_mask = getaff(0) if getaff is not None else None
            self.engine_pinned = topo_mod.apply_affinity(
                sorted(self.plan.engine_cpus))
            worker_cpus = [sorted(m) for m in self.plan.worker_cpus]
        self._ctx = mp.get_context("spawn")
        self._worker_cpus = worker_cpus  # kept so respawns re-pin identically
        self._pinned = [False] * (cfg.workers + 1)
        t0 = time.perf_counter()
        for wid in range(cfg.workers):
            q, out_q, p = self._spawn_intake_proc(wid)
            self._intake_qs.append(q)
            self._intake_outs.append(out_q)
            self._intake_procs.append(p)
        self._emit_q, self._emit_out, self._emit_proc = self._spawn_emit_proc()
        self._started = True
        self._ping_all()
        self.spawn_s = time.perf_counter() - t0

    def _spawn_intake_proc(self, wid: int) -> Tuple[Any, Any, Any]:
        q = self._ctx.Queue(maxsize=self.config.queue_depth)
        out_q = self._ctx.Queue(maxsize=self.config.queue_depth)
        p = self._ctx.Process(
            target=_intake_main,
            args=(wid, q, out_q, self._worker_cpus[wid],
                  self.max_len),
            daemon=True, name=f"repro-intake-{wid}")
        p.start()
        return q, out_q, p

    def _spawn_emit_proc(self) -> Tuple[Any, Any, Any]:
        in_q = self._ctx.Queue(maxsize=self.config.queue_depth)
        out_q = self._ctx.Queue(maxsize=self.config.queue_depth)
        p = self._ctx.Process(
            target=_emission_main,
            args=(in_q, out_q, self._worker_cpus[self.config.workers]),
            daemon=True, name="repro-emission")
        p.start()
        return in_q, out_q, p

    def _ping_all(self) -> None:
        """Readiness barrier + measured per-message IPC round trips (the
        measured side of the ``serve_ipc`` ledger rows).  Each worker is
        pinged TWICE: the first round trip absorbs spawn/import startup
        and is discarded; only the second — a steady-state queue round
        trip — is recorded."""
        slots = list(zip(self._intake_qs, self._intake_outs,
                         self._intake_procs))
        slots.append((self._emit_q, self._emit_out, self._emit_proc))
        for slot, (in_q, out_q, proc) in enumerate(slots):
            self._pinned[slot] = self._ping_worker(in_q, out_q, proc)

    def _ping_worker(self, in_q, out_q, proc) -> bool:
        """Two pings; returns whether the worker's pin took effect."""
        pinned = False
        for warm in (True, False):
            t0 = time.perf_counter()
            in_q.put(("ping", t0))
            pinned = self._expect_pong(out_q, proc)
            if not warm:
                self.ping_round_trips_s.append(time.perf_counter() - t0)
        return pinned

    def _expect_pong(self, out_q, proc) -> bool:
        deadline = time.monotonic() + _RESULT_TIMEOUT_S
        while True:
            try:
                msg = out_q.get(timeout=1.0)
            except _queue.Empty:
                if not proc.is_alive():
                    raise FrontendError(
                        f"worker {proc.name} died during startup "
                        f"(exitcode {proc.exitcode})")
                if time.monotonic() > deadline:
                    raise FrontendError(
                        f"worker {proc.name} unresponsive at startup")
                continue
            if msg[0] == "pong":
                return bool(msg[3])
            # reply queues are per-worker and fresh at spawn: anything
            # non-pong here is a stray from a killed predecessor's drain

    # -------------------------------------------------------- self-healing --
    def _respawn_intake(self, wid: int) -> bool:
        """Replace a crashed intake worker: fresh process on fresh queues
        BOTH ways (the dead worker's in-queue may hold a half-read message;
        its reply queue may be lock-poisoned if the kill landed mid-write),
        re-pinned from the stored affinity plan, two-ping readiness barrier.
        Bounded by ``config.respawn`` attempts under the same
        exponential-backoff harness as device-step retries.  Returns True
        when a live worker holds slot ``wid`` afterwards."""
        if self.config.respawn < 1 or not self._started:
            return False
        old = self._intake_procs[wid]
        if old.is_alive():
            return True
        old.join(timeout=_JOIN_TIMEOUT_S)
        self._pinned[wid] = False
        t0 = time.perf_counter()

        def attempt(_cancel):
            q, out_q, p = self._spawn_intake_proc(wid)
            try:
                pinned = self._ping_worker(q, out_q, p)
            except Exception:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=_JOIN_TIMEOUT_S)
                raise
            return q, out_q, p, pinned

        try:
            q, out_q, p, pinned = guarded_call(
                attempt, retries=self.config.respawn - 1)
        except Exception:
            return False
        for dead_q in (self._intake_qs[wid], self._intake_outs[wid]):
            dead_q.cancel_join_thread()
            dead_q.close()
        self._intake_qs[wid] = q
        self._intake_outs[wid] = out_q
        self._intake_procs[wid] = p
        self._pinned[wid] = pinned
        self.respawns += 1
        self.respawn_s.append(time.perf_counter() - t0)
        return True

    def _respawn_emission(self) -> bool:
        """Replace a crashed emission worker and replay the burst log into
        it, rebuilding the per-request transcript state the crash destroyed.
        Tokens were generated in the engine process, so replay reconstructs
        exactly what the dead worker had seen — the transcript survives the
        crash bit-for-bit.  Bounded like :meth:`_respawn_intake`."""
        if self.config.respawn < 1 or not self._started \
                or self._emit_proc is None:
            return False
        if self._emit_proc.is_alive():
            return True
        self._emit_proc.join(timeout=_JOIN_TIMEOUT_S)
        slot = self.config.workers
        self._pinned[slot] = False
        t0 = time.perf_counter()

        def attempt(_cancel):
            in_q, out_q, p = self._spawn_emit_proc()
            try:
                pinned = self._ping_worker(in_q, out_q, p)
                for burst in self._emit_log:
                    msg = ("emit", burst)
                    in_q.put(msg, timeout=_RESULT_TIMEOUT_S)
                    self._count_msg(msg)
            except Exception:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=_JOIN_TIMEOUT_S)
                raise
            return in_q, out_q, p, pinned

        try:
            in_q, out_q, p, pinned = guarded_call(
                attempt, retries=self.config.respawn - 1)
        except Exception:
            return False
        for q in (self._emit_q, self._emit_out):
            q.cancel_join_thread()
            q.close()
        self._emit_q, self._emit_out, self._emit_proc = in_q, out_q, p
        self._pinned[slot] = pinned
        self.respawns += 1
        self.respawn_s.append(time.perf_counter() - t0)
        return True

    # ------------------------------------------------------------ intake --
    def submit(self, submissions: Sequence[Dict[str, Any]],
               ) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, str]]:
        """Round-robin raw submissions over the intake workers; wait for
        every verdict.  Returns ``(validated, failures)`` keyed by rid —
        ``failures`` carries typed reasons for invalid submissions and for
        submissions routed to a worker that died with respawns exhausted
        (those become FAILED, not a crashed serve run).  A crashed worker
        is respawned in place when the budget allows, and its unanswered
        submissions are resubmitted — validation is pure and idempotent,
        so a submission the dead worker half-processed re-validates to the
        same verdict."""
        if not self._started:
            raise FrontendError("frontend not started")
        routed: Dict[str, int] = {}
        subs_by_rid: Dict[str, Dict[str, Any]] = {}
        for sub in submissions:
            wid = self._rr % len(self._intake_qs)
            self._rr += 1
            rid = str(sub.get("rid", "?"))
            subs_by_rid[rid] = sub
            msg = ("req", sub)
            if not self._intake_procs[wid].is_alive() \
                    and not self._respawn_intake(wid):
                routed[rid] = -1  # dead on arrival: typed failure below
                continue
            try:
                self._intake_qs[wid].put(msg, timeout=_RESULT_TIMEOUT_S)
            except _queue.Full:
                routed[rid] = -1
                continue
            self._count_msg(msg)
            routed[rid] = wid
        validated: Dict[str, Dict[str, Any]] = {}
        failures: Dict[str, str] = {
            rid: "frontend: intake worker unavailable"
            for rid, wid in routed.items() if wid < 0}
        pending = {rid for rid, wid in routed.items() if wid >= 0}
        deadline = time.monotonic() + _RESULT_TIMEOUT_S
        while pending:
            progressed = False
            for wid in sorted({routed[rid] for rid in pending}):
                try:
                    msg = self._intake_outs[wid].get(timeout=0.25)
                except _queue.Empty:
                    continue
                self._count_msg(msg)
                self._dispatch_verdict(msg, validated, failures, pending)
                progressed = True
            if progressed:
                continue
            dead_wids = {routed[rid] for rid in pending
                         if not self._intake_procs[routed[rid]].is_alive()}
            for wid in dead_wids:
                rids = [r for r in pending if routed[r] == wid]
                if self._respawn_intake(wid):
                    # the crashed worker's reply queue went with it: every
                    # unanswered rid re-validates on the fresh worker
                    for rid in rids:
                        msg = ("req", subs_by_rid[rid])
                        try:
                            self._intake_qs[wid].put(
                                msg, timeout=_RESULT_TIMEOUT_S)
                        except _queue.Full:
                            failures[rid] = "frontend: intake worker crashed"
                            pending.discard(rid)
                            continue
                        self._count_msg(msg)
                    # fresh worker, fresh clock for the work sent again
                    deadline = time.monotonic() + _RESULT_TIMEOUT_S
                else:
                    for rid in rids:
                        failures[rid] = "frontend: intake worker crashed"
                        pending.discard(rid)
            if time.monotonic() > deadline and pending:
                for rid in list(pending):
                    failures[rid] = "frontend: intake timed out"
                    pending.discard(rid)
        return validated, failures

    @staticmethod
    def _dispatch_verdict(msg, validated, failures, pending) -> None:
        if msg[0] == "ok":
            _, rid, payload = msg
            validated[str(rid)] = payload
            pending.discard(str(rid))
        elif msg[0] == "invalid":
            _, rid, why = msg
            failures[str(rid)] = why
            pending.discard(str(rid))
        # stray pongs from startup retries are ignored

    # ---------------------------------------------------------- emission --
    def stream(self) -> FrontendStream:
        return FrontendStream(self, self.config.coalesce)

    def _emit_burst(self, burst) -> None:
        if not self._started or self._emit_proc is None:
            raise StreamBroken("frontend not started")
        if not self._emit_proc.is_alive() and not self._respawn_emission():
            raise StreamBroken(
                f"emission worker died (exitcode {self._emit_proc.exitcode})")
        msg = ("emit", burst)
        try:
            self._emit_q.put(msg, timeout=_RESULT_TIMEOUT_S)
        except _queue.Full:
            raise StreamBroken("emission queue wedged (backpressure "
                               "timeout with worker alive)") from None
        self._count_msg(msg)
        # replay log: the price of emission self-healing is one host-side
        # copy of the published stream (proportional to transcript size)
        self._emit_log.append(burst)

    def finish(self) -> Dict[str, Dict[str, Any]]:
        """Drain the emission worker: returns its per-request transcript
        (tokens, detok text, event counts, first-burst times).  A worker
        that died between the last burst and the drain is respawned and
        fed the replay log first, so the crash is invisible here too."""
        if self._emit_proc is None:
            raise StreamBroken("emission worker is not running")
        if not self._emit_proc.is_alive() and not self._respawn_emission():
            raise StreamBroken("emission worker is not running")
        self._emit_q.put(None)
        deadline = time.monotonic() + _RESULT_TIMEOUT_S
        while True:
            try:
                msg = self._emit_out.get(timeout=1.0)
            except _queue.Empty:
                if time.monotonic() > deadline:
                    raise StreamBroken(
                        "emission worker did not return a transcript")
                if not self._emit_proc.is_alive() \
                        and self._emit_proc.exitcode not in (0, None):
                    raise StreamBroken(
                        f"emission worker died before transcript "
                        f"(exitcode {self._emit_proc.exitcode})")
                continue
            if msg[0] == "result":
                self._count_msg(msg)
                self._emit_proc.join(timeout=_JOIN_TIMEOUT_S)
                self._emit_proc = None
                return msg[1]

    # ----------------------------------------------------------- teardown --
    def close(self) -> None:
        """Stop every worker (idempotent; survives dead/wedged workers),
        and give the calling thread back the CPU mask ``start()`` found."""
        for q, p in zip(self._intake_qs, self._intake_procs):
            if p.is_alive():
                try:
                    q.put(None, timeout=1.0)
                except _queue.Full:
                    pass
        if self._emit_proc is not None and self._emit_proc.is_alive():
            try:
                self._emit_q.put(None, timeout=1.0)
            except _queue.Full:
                pass
        procs = list(self._intake_procs)
        if self._emit_proc is not None:
            procs.append(self._emit_proc)
        for p in procs:
            p.join(timeout=_JOIN_TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join(timeout=_JOIN_TIMEOUT_S)
        for q in (*self._intake_qs, *self._intake_outs, self._emit_q,
                  self._emit_out):
            if q is not None:
                q.cancel_join_thread()
                q.close()
        if self._saved_mask is not None:
            topo_mod.apply_affinity(sorted(self._saved_mask))
            self._saved_mask = None
        self._intake_procs, self._intake_qs = [], []
        self._intake_outs = []
        self._emit_q = self._emit_out = None
        self._emit_proc = None
        self._emit_log = []
        self._pinned = []
        self._started = False

    # --------------------------------------------------------- accounting --
    def _count_msg(self, msg: Any) -> None:
        self.ipc_messages += 1
        self.ipc_bytes += _pickled_size(msg)

    def kill_intake_workers(self) -> None:
        """Test hook: hard-kill every intake worker (crash drills)."""
        for p in self._intake_procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=_JOIN_TIMEOUT_S)

    def kill_emission_worker(self) -> None:
        """Test hook: hard-kill the emission worker (crash drills)."""
        if self._emit_proc is not None and self._emit_proc.is_alive():
            self._emit_proc.terminate()
            self._emit_proc.join(timeout=_JOIN_TIMEOUT_S)
