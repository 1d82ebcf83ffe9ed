"""Request lifecycle + CostEngine-driven serving scheduler.

Every scheduling choice on the serve path — whether to admit waiting
requests, what prefill chunk length to lower, what decode horizon to run,
what the current decode batch composition costs — is phrased as a
``CostQuery`` against the calibrated CostEngine and ledgered, exactly like
the other fork-join decision sites.  The scheduler never touches
device state; it hands verdicts to the ContinuousServeEngine, which
executes them and attaches measured wall times back onto the ledger rows.

Every ``Request`` moves through an explicit state machine:

    QUEUED -> PREFILLING -> DECODING -> COMPLETED
       |           |            |
       |           |            +-> PREEMPTED -> QUEUED (re-prefills
       |           |            |                prompt + generated)
       |           |            +-> TIMED_OUT (total-latency deadline)
       |           +----------------+-> FAILED (unrecoverable step fault)
       +-> REJECTED (invalid / queue_full / deadline_infeasible)
       +-> TIMED_OUT (deadline expired while queued)

Terminal states: COMPLETED, REJECTED, TIMED_OUT, FAILED.  Transitions are
timestamped into ``Request.history`` so ``ServeReport`` can account for
every request's fate — the engine's drain invariant is that a finished run
leaves NO request non-terminal.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costs.engine import CostEngine, Decision, resolve_engine


def _quantize_us(slack_s: Optional[float]) -> Optional[int]:
    """Quantize a deadline slack (seconds) to two significant figures of
    microseconds.  serve_admit CostQueries embed the slack; without
    quantization every query is unique and the decision cache grows without
    bound as a long-running server counts budgets down.  Negative slack
    (already past deadline) pins to -1: one cache entry for 'hopeless'."""
    if slack_s is None:
        return None
    us = slack_s * 1e6
    if us <= 0:
        return -1
    exp = max(int(np.floor(np.log10(us))) - 1, 0)
    step = 10 ** exp
    return int(us // step) * step


PREFILL_CHUNK_CANDIDATES = (1, 8, 16, 32, 64, 128, 256)
# decode macro-step horizons: a FIXED candidate set (filtered, never clamped
# to ad-hoc values) so the engine's per-K compiled macro-step cache stays
# bounded and warmup can precompile every horizon a trace may pick
MACRO_STEP_CANDIDATES = (1, 2, 4, 8, 16, 32)


class RequestState(str, enum.Enum):
    """The request lifecycle state machine (module docstring diagram)."""

    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    DECODING = "DECODING"
    COMPLETED = "COMPLETED"
    REJECTED = "REJECTED"
    TIMED_OUT = "TIMED_OUT"
    PREEMPTED = "PREEMPTED"
    FAILED = "FAILED"

    @property
    def terminal(self) -> bool:
        return self in (RequestState.COMPLETED, RequestState.REJECTED,
                        RequestState.TIMED_OUT, RequestState.FAILED)


class InvalidRequestError(ValueError):
    """A malformed request, rejected at submission time (never mid-trace):
    empty prompt, non-positive token budget, or prompt + budget overflowing
    the slot capacity.  Subclasses ValueError so pre-lifecycle callers that
    caught the old untyped error keep working."""


def validate_request(req: "Request", max_len: int) -> None:
    """Fail-fast submission-time validation; raises InvalidRequestError
    naming the request id."""
    plen = req.prompt_len
    if plen <= 0:
        raise InvalidRequestError(f"request {req.rid!r}: empty prompt")
    if req.max_new_tokens <= 0:
        raise InvalidRequestError(
            f"request {req.rid!r}: max_new_tokens must be >= 1, got "
            f"{req.max_new_tokens}")
    need = plen + req.max_new_tokens
    if need > max_len:
        raise InvalidRequestError(
            f"request {req.rid!r}: prompt_len {plen} + max_new_tokens "
            f"{req.max_new_tokens} = {need} exceeds max_len {max_len}; "
            f"raise max_len (it must cover prompt + generated tokens) or "
            f"shorten the request")
    for name in ("deadline_s", "ttft_deadline_s"):
        v = getattr(req, name)
        if v is not None and v <= 0:
            raise InvalidRequestError(
                f"request {req.rid!r}: {name} must be positive, got {v}")


@dataclasses.dataclass
class Request:
    """One serving request.  ``arrival_s`` is relative to trace start;
    lifecycle/result fields are filled in by the engine.

    ``deadline_s`` / ``ttft_deadline_s`` are per-request latency budgets
    measured from arrival (None = no deadline).  ``priority``: larger wins;
    a waiting request with strictly higher priority preempts the
    lowest-priority active slot when the pool is full."""

    rid: str
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    arrival_s: float = 0.0
    priority: int = 0
    deadline_s: Optional[float] = None  # total-latency budget from arrival
    ttft_deadline_s: Optional[float] = None  # first-token budget from arrival
    # --- filled by the engine ---
    tokens: List[int] = dataclasses.field(default_factory=list)
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    state: RequestState = RequestState.QUEUED
    reason: Optional[str] = None  # detail for REJECTED/TIMED_OUT/FAILED
    preemptions: int = 0
    retries: int = 0  # guarded device-step retries that touched this request
    history: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    def mark(self, state: RequestState, t: float,
             reason: Optional[str] = None) -> None:
        """One timestamped state-machine transition (terminal states also
        stamp ``finish_s``, except REJECTED — never served, no latency)."""
        self.state = state
        self.history.append((state.value, t))
        if reason is not None:
            self.reason = reason
        if state.terminal and state != RequestState.REJECTED:
            self.finish_s = t

    def reset_lifecycle(self) -> None:
        """Fresh run: clear everything the engine fills in."""
        self.tokens = []
        self.admitted_s = self.first_token_s = self.finish_s = None
        self.state = RequestState.QUEUED
        self.reason = None
        self.preemptions = 0
        self.retries = 0
        self.history = []

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[-1])

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admitted_s is None:
            return None
        return self.admitted_s - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, from arrival (includes queue wait)."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill lowers multi-token chunks through the decode path.
    That is exact for full-attention stacks (per-query rows of the same
    cache attention the per-token loop runs).  Families with ring-buffer
    local windows (wrap-around inserts) or recurrent single-step decode
    forms (wkv_step vs the chunked form) fall back to chunk-1 replay, which
    reproduces the per-token path bit for bit."""
    return all(kind == "attn" for kind in cfg.block_pattern)


class ServeScheduler:
    """Admission + granularity decisions for the continuous-batching engine."""

    def __init__(self, cfg: ModelConfig, engine: Optional[CostEngine] = None, *,
                 max_len: int,
                 chunk_candidates: Tuple[int, ...] = PREFILL_CHUNK_CANDIDATES,
                 macro_candidates: Tuple[int, ...] = MACRO_STEP_CANDIDATES):
        self.cfg = cfg
        self.engine = resolve_engine(engine)
        self.max_len = int(max_len)
        self.chunk_candidates = tuple(chunk_candidates)
        self.macro_candidates = tuple(macro_candidates)
        self.dtype_bytes = 4 if cfg.dtype == "float32" else 2
        # per-token work/weight-stream constants for the analytic serve costs
        active_params = cfg.active_param_count()
        self.flops_per_token = 2 * active_params
        self.weight_bytes = active_params * self.dtype_bytes
        self.kv_bytes_per_slot = self._kv_bytes_per_slot(cfg, max_len)
        # per-TOKEN KV bytes across full-attention layers (the unit the
        # paged pool allocates in; prices prefix-cache CoW page copies)
        hd = cfg.resolved_head_dim
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.block_kind(i) == "attn")
        self.kv_bytes_per_token = (
            2 * n_attn * cfg.n_kv_heads * hd * self.dtype_bytes)

    @staticmethod
    def _kv_bytes_per_slot(cfg: ModelConfig, max_len: int) -> int:
        """Approximate per-slot decode-state bytes re-read each step."""
        hd = cfg.resolved_head_dim
        dtype_bytes = 4 if cfg.dtype == "float32" else 2
        total = 0
        for i in range(cfg.n_layers):
            kind = cfg.block_kind(i)
            if kind == "attn":
                total += 2 * max_len * cfg.n_kv_heads * hd * dtype_bytes
            elif kind == "local":
                total += 2 * cfg.window_size * cfg.n_kv_heads * hd * dtype_bytes
            elif kind == "rglru":
                total += (cfg.lru_width or cfg.d_model) * 4
            elif kind == "rwkv":
                h = cfg.d_model // cfg.rnn_head_dim
                total += h * cfg.rnn_head_dim * cfg.rnn_head_dim * 4
        return total

    # ------------------------------------------------------------------
    # Decisions (each one a site=serve ledger row)
    # ------------------------------------------------------------------

    def prefill_chunk(self, prompt_len: int, *, active_decodes: int,
                      override: Optional[int] = None) -> Tuple[int, Decision]:
        """Prefill chunk length for a prompt, from the CostEngine sweep.
        Families without an exact chunked decode path are pinned to the
        chunk-1 replay fallback regardless of the sweep."""
        if not supports_chunked_prefill(self.cfg):
            candidates: Tuple[int, ...] = (1,)
        elif override is not None:
            candidates = (int(override),)
        else:
            candidates = self.chunk_candidates
        # drop chunk widths whose PADDED prompt (ceil(len/c)*c) overflows
        # max_len: the prefill program's vmapped dynamic_update_slice would
        # clamp the final chunk's start index and overwrite real cache rows
        # (chunk 8, prompt 13, max_len 14: chunk 2 start clamps 8 -> 6).
        # chunk 1 never pads, so the fallback is always safe. Prompts that
        # exceed max_len outright never reach the prefill program (rejected
        # at admission), so hypothetical cost queries skip the filter.
        if prompt_len <= self.max_len:
            candidates = tuple(
                c for c in candidates
                if c == 1 or -(-prompt_len // c) * c <= self.max_len) or (1,)
        dec = self.engine.decide_serve_prefill_chunk(
            prompt_len, flops_per_token=self.flops_per_token,
            weight_bytes=self.weight_bytes, active_decodes=active_decodes,
            dtype_bytes=self.dtype_bytes, candidates=candidates)
        return int(dec.value), dec

    def admission(self, *, active: int, waiting: int,
                  free_slots: int) -> Tuple[int, Decision]:
        """How many waiting requests to admit into free slots right now."""
        dec = self.engine.decide_serve_admission(
            active, waiting=waiting, free_slots=free_slots,
            flops_per_token=self.flops_per_token,
            weight_bytes=self.weight_bytes,
            kv_bytes_per_slot=self.kv_bytes_per_slot,
            dtype_bytes=self.dtype_bytes)
        return int(dec.value), dec

    def macro_horizon(self, remaining, *, override: Optional[int] = None,
                      record: bool = True) -> Tuple[int, Decision]:
        """Decode macro-step horizon K for the current composition.

        ``remaining`` holds the active slots' remaining token budgets; the
        CostQuery(kind=serve_macro) sweep trades the once-per-macro-step
        host sync against lockstep steps wasted when a slot finishes
        mid-macro-step.  Candidates are FILTERED to the fixed set (never
        clamped to arbitrary values) so every horizon a trace can pick is
        precompilable; K=1 is always a candidate and reproduces the
        one-sync-per-token loop exactly.
        """
        remaining = tuple(int(r) for r in remaining)
        max_r = max(remaining) if remaining else 1
        if override is not None:
            candidates: Tuple[int, ...] = (max(int(override), 1),)
        else:
            candidates = tuple(k for k in self.macro_candidates
                               if k <= max_r) or (1,)
        dec = self.engine.decide_serve_macro(
            len(remaining), remaining=remaining, candidates=candidates,
            flops_per_token=self.flops_per_token,
            weight_bytes=self.weight_bytes,
            kv_bytes_per_slot=self.kv_bytes_per_slot,
            dtype_bytes=self.dtype_bytes, record=record)
        return int(dec.value), dec

    def serve_admit(self, req: Request, *, now: float, active: int,
                    n_slots: int) -> Tuple[bool, Decision]:
        """Admission control for a deadlined request about to take a free
        slot — the ninth decision site (CostQuery kind=serve_admit).

        Queue delay already spent (``now - arrival``) has eaten into the
        request's budgets; the sweep compares the analytic residual service
        time (one prefill + the remaining decode steps at the post-admit
        occupancy) against the remaining TTFT / total-latency slack and
        SHEDS the request (typed REJECTED) when it cannot finish in time.
        It is the one serve site that compares an absolute predicted time
        with a budget, so the site's correction factor enters the
        comparison; that factor learns only from measured serve_admit
        rows, and the engine, like the reference's, records none.  Slacks
        are quantized to two significant figures so the decision cache
        stays bounded as a long-running server counts budgets down."""
        slack = None if req.deadline_s is None else \
            req.deadline_s - (now - req.arrival_s)
        ttft_slack = None if req.ttft_deadline_s is None else \
            req.ttft_deadline_s - (now - req.arrival_s)
        dec = self.engine.decide_serve_admit(
            active, n_slots=n_slots, prompt_len=req.prompt_len,
            new_tokens=req.max_new_tokens,
            slack_us=_quantize_us(slack), ttft_slack_us=_quantize_us(ttft_slack),
            flops_per_token=self.flops_per_token,
            weight_bytes=self.weight_bytes,
            kv_bytes_per_slot=self.kv_bytes_per_slot,
            dtype_bytes=self.dtype_bytes)
        return bool(dec.value), dec

    def serve_prefix(self, prompt_len: int, *, hit_tokens: int,
                     cow_blocks: int, block_size: int,
                     override: Optional[str] = None
                     ) -> Tuple[int, Decision]:
        """Prefix-cache reuse vs full prefill for one admitted prompt — the
        tenth decision site (CostQuery kind=serve_prefix).

        ``hit_tokens`` is the radix-trie match length the BlockPool found
        (full shared pages plus an optional partial tail served by one
        copy-on-write page duplication, ``cow_blocks``).  The sweep weighs
        the skipped prefill compute for those tokens against the host
        lookup walk and the page copy; the engine executes the verdict
        (suffix-only prefill, or dropping the pins) and attaches the
        admitted group's measured prefill wall time.  ``override``
        (``"use_prefix"`` / ``"full_prefill"``) pins the verdict, still
        priced and ledgered.  Returns the applied hit length (0 = full
        prefill)."""
        dec = self.engine.decide_serve_prefix(
            prompt_len, hit_tokens=hit_tokens, cow_blocks=cow_blocks,
            chunk=prompt_len, block_size=block_size,
            flops_per_token=self.flops_per_token,
            weight_bytes=self.weight_bytes,
            kv_bytes_per_token=self.kv_bytes_per_token,
            dtype_bytes=self.dtype_bytes, override=override)
        return int(dec.value), dec

    def serve_ipc_workers(self, n_requests: int, *, msg_bytes: int,
                          prompt_len: int,
                          candidates: Tuple[int, ...] = (1, 2, 4),
                          override: Optional[str] = None
                          ) -> Tuple[int, Decision]:
        """Intake worker count for the multi-process front end — the
        eleventh decision site (CostQuery kind=serve_ipc, op=workers).

        The sweep prices moving validation + pre-processing of
        ``n_requests`` submissions onto N pinned worker processes: each
        submission pays a queue round trip and two serializations at the
        calibrated ``ipc_round_trip_s`` / ``ipc_bytes_per_s``, against the
        inline baseline of validating on the engine thread (a per-token
        host walk, priced like the trie walk: ``prompt_len`` x
        ``prefix_lookup_s``).  ``override='frontend'`` pins a worker
        verdict when the caller explicitly deployed a front end; the
        inline alternative is still priced and ledgered.  Returns the
        worker count (0 = inline)."""
        validate_s = max(prompt_len, 1) * self.engine.hw.prefix_lookup_s
        dec = self.engine.decide_serve_ipc_workers(
            n_requests, msg_bytes=msg_bytes,
            validate_us=_quantize_us(validate_s) or 0,
            candidates=candidates, override=override)
        return int(dec.value), dec

    def serve_ipc_coalesce(self, n_streams: int, *, event_bytes: int,
                           candidates: Tuple[int, ...] = (1, 2, 4, 8, 16)
                           ) -> Tuple[int, Decision]:
        """Emission coalescing factor — serve_ipc, op=coalesce.  Amortizes
        the per-message queue round trip over bursts of token events
        against delivery staleness at the predicted decode-step interval
        (one batched step at occupancy ``n_streams``).  Returns how many
        events ride one IPC message to the emission worker."""
        step = self.engine.model.serve_decode_step_cost(
            max(n_streams, 1), flops_per_token=self.flops_per_token,
            weight_bytes=self.weight_bytes,
            kv_bytes_per_slot=self.kv_bytes_per_slot,
            dtype_bytes=self.dtype_bytes)
        dec = self.engine.decide_serve_ipc_coalesce(
            n_streams, event_bytes=event_bytes,
            token_interval_us=_quantize_us(step.total) or 0,
            candidates=candidates)
        return int(dec.value), dec

    def record_measured(self, decision: Decision, seconds: float,
                        note: str = ""):
        """Attach a measured wall time to ``decision``'s ledger row.
        Returns the LedgerEntry (the correction loop has already consumed
        it by then — the chaos harness reads it to assert what the loop
        saw)."""
        return self.engine.record_measured(decision, seconds, note=note)
