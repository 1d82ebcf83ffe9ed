"""Serving engines: static-batch baseline + slot-pooled continuous batching.

``ServeEngine`` is the fixed-batch baseline: one prompt matrix in, lockstep
greedy decode out, with EOS masking and deterministic padding.  It is the
token-for-token correctness anchor for the continuous engine.  Its prompt
priming is ONE batched prefill call (``make_batched_prefill``).

``ContinuousServeEngine`` is the serve stack, built so the host is
consulted once per MACRO-STEP, not once per token:

  * decode runs as K-token macro-steps (``make_decode_macro_step``) with
    on-device EOS masking, per-slot budget countdown and per-slot position
    advance; the horizon K is a ``CostQuery(kind=serve_macro)`` decision;
  * admitted requests prefill as a GROUP directly into the pooled state
    (one batched prefill per group, one host sync);
  * every host synchronization and device dispatch is counted, the way the
    reference counts them, and lands in ``ServeReport.as_dict()``.

Every admission / prefill-chunk / macro-horizon choice is a CostEngine
``CostQuery -> Decision`` ledgered with the measured wall time attached.
Deadlines, preemption, fault injection, paged KV, the prefix cache, meshes
and the multi-process front end come with later slices of the port.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.costs.engine import CostEngine
from repro_torch.models.model import Model
from repro_torch.serving.scheduler import (
    Request,
    RequestState,
    ServeScheduler,
    supports_chunked_prefill,
    validate_request,
)
from repro_torch.serving.slots import SlotPool
from repro_torch.training.step import (
    make_batched_prefill,
    make_decode_macro_step,
    make_serve_step,
)


def emitted_count(out: np.ndarray, eos_id: int) -> int:
    """Tokens actually generated in a (B, T) output matrix: everything up
    to and including the first EOS per row (the rest is padding)."""
    out = np.asarray(out)
    if out.size == 0:
        return 0
    hits = out == eos_id
    per_row = np.where(hits.any(axis=1), hits.argmax(axis=1) + 1, out.shape[1])
    return int(per_row.sum())


def _check_fits(prompt_len: int, max_new: int, max_len: int, who: str) -> None:
    """A request must fit its slot end to end."""
    need = prompt_len + max_new
    if need > max_len:
        raise ValueError(
            f"{who}: prompt_len {prompt_len} + max_new_tokens {max_new} "
            f"= {need} exceeds max_len {max_len}; raise max_len (it must "
            f"cover prompt + generated tokens) or shorten the request")


def _prefill_chunks(prompts: np.ndarray, chunk: int) -> np.ndarray:
    """(B, L) padded prompts -> (n_chunks, B, chunk), L padded up to a chunk
    multiple so every chunk is full-width."""
    b, length = prompts.shape
    pad = (-length) % chunk
    if pad:
        prompts = np.pad(prompts, ((0, 0), (0, pad)))
    n_chunks = prompts.shape[1] // chunk
    return np.ascontiguousarray(
        prompts.reshape(b, n_chunks, chunk).transpose(1, 0, 2))


def _to_device(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device)


# ---------------------------------------------------------------------------
# Static-batch baseline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeEngine:
    """Fixed-batch greedy decoding with EOS masking.

    All sequences decode in lockstep; a sequence that emits ``eos_id``
    keeps its EOS in the output, pads the rest with ``pad_id`` and is fed
    padding until the whole batch finishes — the loop stops early once
    every slot is done."""

    model: Model
    params: object
    max_len: int = 256
    eos_id: int = 0
    pad_id: Optional[int] = None

    def __post_init__(self):
        self._step = make_serve_step(self.model)
        self._prefill = make_batched_prefill(self.model)
        if self.pad_id is None:
            self.pad_id = self.eos_id

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32) -> np.ndarray:
        """prompts: (B, P) integers.  Returns (B, max_new_tokens) int32:
        generated tokens up to and including EOS, padded after it."""
        b, p = prompts.shape
        _check_fits(p, max_new_tokens, self.max_len, "ServeEngine.generate")
        dev = self.model.device
        state = self.model.init_decode_state(b, self.max_len, per_slot=True)
        chunk = p if supports_chunked_prefill(self.model.cfg) else 1
        chunks = _prefill_chunks(np.asarray(prompts, np.int64), chunk)
        tok, state = self._prefill(self.params, state,
                                   _to_device(chunks, dev),
                                   _to_device(np.full((b,), p, np.int64), dev))
        out = np.full((b, max_new_tokens), self.pad_id, np.int32)
        done = np.zeros((b,), bool)
        cur = tok.cpu().numpy()
        for i in range(max_new_tokens):
            out[:, i] = np.where(done, self.pad_id, cur)
            done |= cur == self.eos_id
            if done.all() or i == max_new_tokens - 1:
                break
            feed = np.where(done, self.pad_id, cur).astype(np.int64)
            nxt, state = self._step(self.params, state,
                                    {"tokens": _to_device(feed[:, None], dev)})
            cur = nxt.cpu().numpy()
        return out


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeReport:
    """Per-request latencies + aggregate throughput for one trace run,
    plus the trace's host-synchronization / device-dispatch counts (the
    overhead the macro-step hot path exists to amortize)."""

    requests: List[Request]
    wall_s: float
    pad_id: int
    host_syncs: int = 0
    device_dispatches: int = 0
    live_tokens: int = 0        # peak sum of per-slot cache positions
    prefilled_tokens: int = 0   # prompt tokens prefilled

    def state_counts(self) -> Dict[str, int]:
        """How many requests ended in each lifecycle state."""
        counts: Dict[str, int] = {}
        for r in self.requests:
            counts[r.state.value] = counts.get(r.state.value, 0) + 1
        return counts

    @property
    def all_terminal(self) -> bool:
        return all(r.state.terminal for r in self.requests)

    def output(self, rid: str, max_new_tokens: Optional[int] = None) -> np.ndarray:
        req = next(r for r in self.requests if r.rid == rid)
        n = max_new_tokens if max_new_tokens is not None else req.max_new_tokens
        out = np.full((n,), self.pad_id, np.int32)
        out[: len(req.tokens)] = req.tokens
        return out

    def outputs(self) -> Dict[str, np.ndarray]:
        return {r.rid: self.output(r.rid) for r in self.requests}

    @property
    def generated_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.requests)

    @property
    def tok_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def host_syncs_per_token(self) -> float:
        return self.host_syncs / max(self.generated_tokens, 1)

    def latency_percentiles(self, qs=(50, 95)) -> Dict[str, float]:
        lats = [r.latency_s for r in self.requests if r.latency_s is not None]
        if not lats:
            return {f"p{q}": float("nan") for q in qs}
        return {f"p{q}": float(np.percentile(lats, q)) for q in qs}

    def ttft_percentiles(self, qs=(50, 95, 99)) -> Dict[str, float]:
        ttfts = [r.ttft_s for r in self.requests if r.ttft_s is not None]
        if not ttfts:
            return {f"ttft_p{q}": float("nan") for q in qs}
        return {f"ttft_p{q}": float(np.percentile(ttfts, q)) for q in qs}

    def as_dict(self) -> dict:
        return {
            "wall_s": self.wall_s,
            "generated_tokens": self.generated_tokens,
            "tok_per_s": self.tok_per_s,
            "host_syncs": self.host_syncs,
            "device_dispatches": self.device_dispatches,
            "host_syncs_per_token": self.host_syncs_per_token,
            "states": self.state_counts(),
            "all_terminal": self.all_terminal,
            "live_tokens": self.live_tokens,
            "prefilled_tokens": self.prefilled_tokens,
            **self.latency_percentiles(),
            **self.ttft_percentiles(),
        }


class ContinuousServeEngine:
    """Slot-pooled continuous batching with CostEngine-driven scheduling.

    Token-for-token equivalent to ``ServeEngine`` on any fixed request set:
    the same greedy decode over the same caches, with slots admitted,
    retired and refilled independently instead of in lockstep, and the
    decode loop running as K-token macro-steps (``macro_step="auto"`` lets
    the scheduler pick K; an int pins it; K=1 is the per-token loop)."""

    def __init__(self, model: Model, params, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: int = 0,
                 pad_id: Optional[int] = None,
                 cost_engine: Optional[CostEngine] = None,
                 prefill_chunk: Union[str, int] = "auto",
                 macro_step: Union[str, int] = "auto"):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = eos_id if pad_id is None else pad_id
        if prefill_chunk != "auto":
            prefill_chunk = int(prefill_chunk)
        self.prefill_chunk = prefill_chunk
        if macro_step != "auto":
            macro_step = max(int(macro_step), 1)
        self.macro_step = macro_step
        self.scheduler = ServeScheduler(model.cfg, cost_engine, max_len=max_len)
        self.pool = SlotPool(model, n_slots, max_len)
        self._prefill = make_batched_prefill(model)
        self._macro_fns: Dict[int, Callable] = {}
        # host mirrors of per-slot last token / remaining token budget
        self._last_tok = np.full((n_slots,), self.pad_id, np.int64)
        self._budget = np.zeros((n_slots,), np.int64)
        self._last_macro_key = None
        # every admission group pads its prompts to the trace-wide max
        # prompt length (one prefill shape per trace, as in the reference)
        self._group_pad: Optional[int] = None
        # overhead accounting (engine-lifetime; ServeReport carries deltas)
        self.host_syncs = 0
        self.device_dispatches = 0
        self.prefilled_tokens = 0
        self._peak_live_tokens = 0

    def _macro(self, horizon: int) -> Callable:
        """K-token macro-step, cached per horizon (the candidate set is
        fixed, so this cache is bounded)."""
        fn = self._macro_fns.get(horizon)
        if fn is None:
            fn = make_decode_macro_step(self.model, horizon,
                                        eos_id=self.eos_id,
                                        pad_id=self.pad_id)
            self._macro_fns[horizon] = fn
        return fn

    def _release(self, slot: int) -> None:
        self.pool.release(slot)
        self._last_tok[slot] = self.pad_id
        self._budget[slot] = 0

    def _admit_group(self, reqs: List[Request], now) -> None:
        """Admit a group with ONE batched prefill lowered directly into
        their pooled slots (one host sync for the whole group).  First
        tokens are stamped after prefill returns, so TTFT includes it."""
        dev = self.model.device
        slots = [self.pool.acquire(r) for r in reqs]
        prompts = [np.asarray(r.prompt, np.int64) for r in reqs]
        self.prefilled_tokens += sum(int(p.shape[-1]) for p in prompts)
        lmax = max([int(p.shape[-1]) for p in prompts]
                   + [self._group_pad or 0])
        override = None if self.prefill_chunk == "auto" else self.prefill_chunk
        chunk, dec = self.scheduler.prefill_chunk(
            lmax, active_decodes=self.pool.active_count - len(reqs),
            override=override)
        tokens = np.zeros((self.pool.n_slots, lmax), np.int64)
        lengths = np.zeros((self.pool.n_slots,), np.int64)
        t_adm = now()
        for r, s, p in zip(reqs, slots, prompts):
            if r.admitted_s is None:
                r.admitted_s = t_adm
            r.mark(RequestState.PREFILLING, t_adm)
            tokens[s, : p.shape[-1]] = p
            lengths[s] = p.shape[-1]
        chunks = _to_device(_prefill_chunks(tokens, chunk), dev)
        lens = _to_device(lengths, dev)
        t0 = time.perf_counter()
        first, self.pool.state = self._prefill(self.params, self.pool.state,
                                               chunks, lens)
        first_np = first.cpu().numpy()  # THE host sync for the group
        dt = time.perf_counter() - t0
        self.device_dispatches += 1
        self.host_syncs += 1
        self.scheduler.record_measured(
            dec, dt, note=f"prefill group={len(reqs)} len={lmax} chunk={chunk}")
        t_first = now()
        for r, s, p in zip(reqs, slots, prompts):
            tk = int(first_np[s])
            r.tokens.append(tk)
            if r.first_token_s is None:
                r.first_token_s = t_first
            self.pool.set_pos(s, int(p.shape[-1]))
            if tk == self.eos_id or len(r.tokens) >= r.max_new_tokens:
                r.mark(RequestState.COMPLETED, t_first)
                self._release(s)
            else:
                r.mark(RequestState.DECODING, t_first)
                self._last_tok[s] = tk
                self._budget[s] = r.max_new_tokens - len(r.tokens)
        self._peak_live_tokens = max(self._peak_live_tokens,
                                     int(self.pool.positions().sum()))

    # ------------------------------------------------------------------

    def run(self, requests: List[Request],
            now_fn=time.perf_counter) -> ServeReport:
        """Run a request trace to completion: every request reaches a
        terminal state.  ``now_fn`` is injectable so tests can pin a virtual
        clock (arrivals then resolve instantly)."""
        for r in requests:
            validate_request(r, self.max_len)  # typed, names the rid
            r.reset_lifecycle()
        self._group_pad = max((r.prompt_len for r in requests), default=0)
        dev = self.model.device
        pending = deque(sorted(requests, key=lambda r: r.arrival_s))  # stable
        waiting: List[Request] = []
        active: Dict[int, Request] = {}
        sync0 = self.host_syncs
        disp0 = self.device_dispatches + self.pool.dispatch_count
        pf0 = self.prefilled_tokens
        self._peak_live_tokens = 0
        t0 = now_fn()
        offset = 0.0  # event-skip accumulator for frozen (virtual) clocks
        now = lambda: now_fn() - t0 + offset  # noqa: E731

        def intake(t: float) -> None:
            while pending and pending[0].arrival_s <= t:
                waiting.append(pending.popleft())

        while pending or waiting or active:
            intake(now())
            # --- admission (one batched prefill per admitted group) ---
            while (pending or waiting) and self.pool.free_count:
                intake(now())
                if not waiting:
                    break
                n_admit, _ = self.scheduler.admission(
                    active=self.pool.active_count, waiting=len(waiting),
                    free_slots=self.pool.free_count)
                if n_admit <= 0:
                    break
                want = min(n_admit, self.pool.free_count, len(waiting))
                group, waiting[:] = waiting[:want], waiting[want:]
                self._admit_group(group, now)
                active = {s: self.pool.owner(s)
                          for s in self.pool.active_slots()}

            if not active:
                if pending and not waiting:
                    # sleep straight to the next arrival; a pinned test
                    # clock (no progress over a 1 ms probe) jumps instead
                    wait = pending[0].arrival_s - now()
                    if wait > 0:
                        before = now()
                        time.sleep(min(wait, 0.001))
                        if now() <= before:
                            offset += wait
                        else:
                            rest = pending[0].arrival_s - now()
                            if rest > 0:
                                time.sleep(rest)
                continue

            # --- one K-token macro-step over the pool ---
            batch_size = len(active)
            remaining = tuple(sorted(int(self._budget[s]) for s in active))
            override = None if self.macro_step == "auto" else self.macro_step
            # key on the budget clipping the CostEngine applies, so repeat
            # compositions dedupe instead of re-recording
            cap = max(self.scheduler.macro_candidates) if override is None \
                else override
            key = (batch_size, tuple(min(r, cap) for r in remaining))
            horizon, dec = self.scheduler.macro_horizon(
                remaining, override=override,
                record=key != self._last_macro_key)
            self._last_macro_key = key
            t_step = time.perf_counter()
            emitted, self.pool.state = self._macro(horizon)(
                self.params, self.pool.state, _to_device(self._last_tok, dev),
                _to_device(self.pool.active_mask(), dev),
                _to_device(self._budget, dev))
            em = emitted.cpu().numpy()  # THE host sync for K tokens
            dt_step = time.perf_counter() - t_step
            self.device_dispatches += 1
            self.host_syncs += 1
            self.scheduler.record_measured(
                dec, dt_step, note=f"macro K={horizon} b={batch_size}")
            t_emit = now()
            for slot in list(active):
                req = active[slot]
                n_before = len(req.tokens)
                finished = False
                for j in range(horizon):
                    tk = int(em[slot, j])
                    req.tokens.append(tk)
                    if (tk == self.eos_id
                            or len(req.tokens) >= req.max_new_tokens):
                        finished = True
                        break
                n_emitted = len(req.tokens) - n_before
                self.pool.advance(slot, n_emitted)  # before release zeroes
                if finished:
                    req.mark(RequestState.COMPLETED, t_emit)
                    self._release(slot)
                    del active[slot]
                else:
                    self._last_tok[slot] = int(em[slot, horizon - 1])
                    self._budget[slot] -= n_emitted
            self._peak_live_tokens = max(self._peak_live_tokens,
                                         int(self.pool.positions().sum()))

        return ServeReport(
            requests=list(requests), wall_s=now(), pad_id=self.pad_id,
            host_syncs=self.host_syncs - sync0,
            device_dispatches=(self.device_dispatches
                               + self.pool.dispatch_count - disp0),
            live_tokens=self._peak_live_tokens,
            prefilled_tokens=self.prefilled_tokens - pf0)

    def warmup(self, prompt_len: int, max_new_tokens: int = 2) -> None:
        """Run one short dummy request through the normal machinery before
        a timed trace, so the kernels are built and loaded and the
        allocator is warm.  Eager execution compiles nothing per shape, so
        unlike the reference no horizon needs precompiling."""
        dummy_new = min(2, max(max_new_tokens, 1))
        self.run([Request("_warmup", np.ones((prompt_len,), np.int64),
                          dummy_new)])
        self._last_macro_key = None
