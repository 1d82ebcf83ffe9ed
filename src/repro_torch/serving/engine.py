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
    reference counts them, and lands in ``ServeReport.as_dict()``;
  * ``paged=True`` keeps full-attention KV in a shared pool of
    ``block_size``-token pages with per-slot block tables, and the radix
    prefix cache lets a prompt that opens with resident pages prefill only
    its suffix (the ``serve_prefix`` decision, the tenth cost site); an
    encoder-decoder model has no paged layout and raises the reference's
    ``ValueError``;
  * an attached ``TokenStream`` receives every request's tokens at the
    boundaries the engine already synchronizes on;
  * every request moves through the lifecycle state machine of
    ``scheduler.py``: a bounded waiting queue (``queue_full``), deadlines
    (expiry while queued, ``deadline_infeasible`` shedding through the
    ``serve_admit`` decision, ``TIMED_OUT`` at macro-step boundaries),
    priority order and priority preemption (the victim re-queues and
    re-prefills its prompt plus the tokens it has generated), injected
    faults under a watchdog with bounded retries (``faults.py``), and a
    graceful stop of intake.  An unperturbed trace (no deadline, one
    priority, no injector or watchdog) takes exactly the path it took
    without them: no thread, no extra query, no extra host sync.

Every admission / prefill-chunk / macro-horizon / prefix-reuse / admit
choice is a CostEngine ``CostQuery -> Decision`` ledgered with the
measured wall time attached.  The multi-process front end
(``frontend/workers.py``) sits in front of the engine, which only ever
sees its ``TokenStream``.

Given a mesh, the continuous engine serves tensor-parallel over its
``model`` axis when the ``serve_shard`` decision (the eighth cost site)
says so: the params and the pooled state are placed on the positions by
the serve specs (``distributed/sharding.py``), and every prefill and
macro-step runs the sharded stack, one CUDA stream a position.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.costs.engine import CostEngine
from repro_torch.distributed.sharding import (ShardingCtx, param_shardings,
                                              place_tree,
                                              validate_serve_mesh)
from repro_torch.kernels import tuning
from repro_torch.models.model import (ENCDEC_PAGED_REFUSAL, AnyModel,
                                     mrope_positions, tensor_parallel)
from repro_torch.serving.faults import FaultInjector, StepFailed, guarded_call
from repro_torch.serving.frontend.stream import StreamBroken, TokenStream
from repro_torch.serving.paging import default_kv_blocks
from repro_torch.serving.scheduler import (
    Request,
    RequestState,
    ServeScheduler,
    supports_chunked_prefill,
    validate_request,
)
from repro_torch.serving.slots import SlotPool, upload
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

    model: AnyModel
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
        mrope = self.model.cfg.pos_type == "mrope"
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
            batch = {"tokens": _to_device(feed[:, None], dev)}
            if mrope:
                batch["positions"] = mrope_positions(b, 1, p + i, dev)
            nxt, state = self._step(self.params, state, batch)
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
    # the mesh (None off a mesh), its positions, and the collective calls
    # the trace made on it (each psum or all_gather of a step counts one;
    # zero on a replicate verdict)
    mesh_shape: Optional[Dict[str, int]] = None
    device_count: int = 1
    collective_ops: int = 0
    # failure-path accounting (all zero on an unperturbed trace)
    step_retries: int = 0
    watchdog_fires: int = 0
    # paged-KV accounting (zero on a dense engine but for the first two),
    # all from host mirrors the engine keeps: reading them costs no sync
    live_tokens: int = 0        # peak sum of per-slot cache positions
    prefilled_tokens: int = 0   # prompt tokens prefilled
    reserved_blocks: int = 0    # peak BlockPool pages in use (slots + trie)
    prefix_hit_tokens: int = 0  # prompt tokens served from the prefix cache
    cow_count: int = 0          # copy-on-write page duplications
    # token stream and front-end accounting (zero without a stream or a
    # multi-process front end); Runtime.serve fills the IPC fields from
    # the ServingFrontend's counters: the engine never sees a queue
    streamed_tokens: int = 0    # tokens published to the attached stream
    stream_events: int = 0      # publish calls (bursts) on the stream
    ipc_messages: int = 0       # front-end queue messages (intake + emission)
    ipc_bytes: int = 0          # pickled payload bytes through those queues
    frontend_workers: int = 0   # intake worker processes (0 = in-process)
    frontend_respawns: int = 0  # crashed workers respawned mid-trace

    def state_counts(self) -> Dict[str, int]:
        """How many requests ended in each lifecycle state."""
        counts: Dict[str, int] = {}
        for r in self.requests:
            counts[r.state.value] = counts.get(r.state.value, 0) + 1
        return counts

    @property
    def all_terminal(self) -> bool:
        """The drain invariant: a finished run leaves NO request in a
        non-terminal state, whatever faults fired."""
        return all(r.state.terminal for r in self.requests)

    @property
    def preemptions(self) -> int:
        return sum(r.preemptions for r in self.requests)

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

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens served from the radix prefix cache
        instead of being prefilled (0.0 on a dense engine)."""
        total = self.prefix_hit_tokens + self.prefilled_tokens
        return self.prefix_hit_tokens / total if total else 0.0

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
            "mesh_shape": self.mesh_shape,
            "device_count": self.device_count,
            "collective_ops": self.collective_ops,
            "states": self.state_counts(),
            "all_terminal": self.all_terminal,
            "step_retries": self.step_retries,
            "watchdog_fires": self.watchdog_fires,
            "preemptions": self.preemptions,
            "live_tokens": self.live_tokens,
            "reserved_blocks": self.reserved_blocks,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefilled_tokens": self.prefilled_tokens,
            "prefix_hit_rate": self.prefix_hit_rate,
            "cow_count": self.cow_count,
            "streamed_tokens": self.streamed_tokens,
            "stream_events": self.stream_events,
            "ipc_messages": self.ipc_messages,
            "ipc_bytes": self.ipc_bytes,
            "frontend_workers": self.frontend_workers,
            "frontend_respawns": self.frontend_respawns,
            **self.latency_percentiles(),
            **self.ttft_percentiles(),
            "requests": [
                {
                    "rid": r.rid,
                    "prompt_len": r.prompt_len,
                    "generated": len(r.tokens),
                    "arrival_s": r.arrival_s,
                    "queue_wait_s": r.queue_wait_s,
                    "ttft_s": r.ttft_s,
                    "latency_s": r.latency_s,
                    "state": r.state.value,
                    "reason": r.reason,
                    "preemptions": r.preemptions,
                    "retries": r.retries,
                }
                for r in self.requests
            ],
        }


class ContinuousServeEngine:
    """Slot-pooled continuous batching with CostEngine-driven scheduling.

    Token-for-token equivalent to ``ServeEngine`` on any fixed request set:
    the same greedy decode over the same caches, with slots admitted,
    retired and refilled independently instead of in lockstep, and the
    decode loop running as K-token macro-steps (``macro_step="auto"`` lets
    the scheduler pick K; an int pins it; K=1 is the per-token loop).

    ``paged=True`` stores full-attention KV in a shared BlockPool of
    ``block_size``-token pages (``kv_blocks`` overrides the can-never-run-
    out default).  ``prefix_cache`` controls radix prefix reuse at
    admission: ``True``/``"auto"`` asks the ``serve_prefix`` CostQuery per
    prompt, ``"force"`` pins the verdict to reuse (still priced and
    ledgered), ``False`` keeps no trie.  Reuse skips prefilling the matched
    tokens, so it arms only when every layer is full attention: the rwkv
    state stays dense per slot, and such a model pages its attention (if
    any) but always prefills in full.  ``stream`` (assignable later) is a
    ``TokenStream`` fed at the prefill and macro-step boundaries.

    ``mesh`` puts the engine on a device mesh.  Whether it shards over the
    mesh's model axis or stays replicated is the ``serve_shard`` decision
    (``shard_params`` forces it): a shard verdict places the params by the
    serve specs (``param_shardings(data_axes=())``) and the pooled state
    by ``serve_state_sharding``, and runs every step tensor-parallel; a
    replicate verdict runs exactly the single-device path (the decision
    is still ledgered and the mesh still reported).  A mixture of experts
    is refused on a shard verdict (``model.MOE_MESH_REFUSAL``).

    Robustness knobs, all off by default (and all assignable later, as
    ``Runtime.serve`` arms the watchdog and injector after warmup):
    ``queue_limit`` bounds the waiting queue, ``watchdog_s`` bounds one
    device step (the step then runs on a worker thread), ``max_retries``
    and ``retry_backoff_s`` set the retry policy of a failed step, and
    ``injector`` fires ``FaultSpec`` faults around the steps.
    ``stop_event`` (anything with ``is_set()``) or ``request_stop()`` stops
    intake gracefully."""

    def __init__(self, model: AnyModel, params, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: int = 0,
                 pad_id: Optional[int] = None,
                 cost_engine: Optional[CostEngine] = None,
                 prefill_chunk: Union[str, int] = "auto",
                 macro_step: Union[str, int] = "auto",
                 mesh=None, shard_params: str = "auto",
                 queue_limit: Optional[int] = None,
                 watchdog_s: Optional[float] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.01,
                 injector: Optional[FaultInjector] = None,
                 paged: bool = False, block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefix_cache: Union[bool, str] = True,
                 stream: Optional[TokenStream] = None,
                 stop_event=None):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = eos_id if pad_id is None else pad_id
        # --- robustness knobs (all default OFF: the unperturbed hot path
        # stays thread-free with zero extra queries or host syncs) ---
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if watchdog_s is not None and watchdog_s <= 0:
            raise ValueError(f"watchdog_s must be > 0, got {watchdog_s}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.queue_limit = queue_limit
        self.watchdog_s = watchdog_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.injector = injector
        self.step_retries = 0  # engine-lifetime; reports carry deltas
        self.watchdog_fires = 0
        if prefill_chunk != "auto":
            prefill_chunk = int(prefill_chunk)
        self.prefill_chunk = prefill_chunk
        if macro_step != "auto":
            macro_step = max(int(macro_step), 1)
        self.macro_step = macro_step
        self.paged = bool(paged)
        self.block_size = int(block_size)
        self.kv_blocks: Optional[int] = None
        if self.paged:
            if model.cfg.is_encdec:
                raise ValueError(ENCDEC_PAGED_REFUSAL)
            if self.block_size < 1:
                raise ValueError(
                    f"block_size must be >= 1, got {block_size}")
            if kv_blocks is None:
                kv_blocks = default_kv_blocks(n_slots, max_len,
                                              self.block_size)
            self.kv_blocks = int(kv_blocks)
        if prefix_cache not in (True, False, "auto", "force"):
            raise ValueError(
                f"prefix_cache must be True/False/'auto'/'force', "
                f"got {prefix_cache!r}")
        all_attn = all(model.cfg.block_kind(i) == "attn"
                       for i in range(model.cfg.n_layers))
        self.prefix_cache = (prefix_cache is not False
                             and self.paged and all_attn)
        self._prefix_override = ("use_prefix" if prefix_cache == "force"
                                 else None)
        self.stream = stream
        self._stream_dead = False
        self._stream_reason = ""
        # graceful shutdown: either hook stops INTAKE only (queued and
        # unarrived requests end REJECTED "shutdown: intake stopped"),
        # active slots decode to completion, and run() returns its report
        self.stop_event = stop_event
        self._stop_requested = False
        self.scheduler = ServeScheduler(model.cfg, cost_engine, max_len=max_len)
        # --- mesh placement: shard-vs-replicate is a CostQuery, not a flag
        if shard_params not in ("auto", "shard", "replicate"):
            raise ValueError(
                f"shard_params must be 'auto', 'shard' or 'replicate', "
                f"got {shard_params!r}")
        self.mesh = mesh
        self.tp = 1
        self._ctx: Optional[ShardingCtx] = None
        self._shard_decision = None
        self._shard_pending = False
        if mesh is not None:
            validate_serve_mesh(model.cfg, mesh.shape)
            model_axis = "model" if "model" in mesh.shape else None
            tp_choice, self._shard_decision = self.scheduler.serve_shard(
                n_slots, tp=int(mesh.shape.get("model", 1)),
                override=None if shard_params == "auto" else shard_params,
                devices=mesh.distinct_devices(model_axis)
                if model_axis else None)
            if tp_choice > 1:
                # pure-TP context: no data axis on the serve hot path
                ctx = ShardingCtx(mesh=mesh, data_axes=(),
                                  cost_engine=self.scheduler.engine,
                                  infer_replicate_params=True)
                tensor_parallel(model.cfg, ctx)  # refuses MoE
                self.tp, self._ctx = tp_choice, ctx
                self.params = place_tree(mesh, params, param_shardings(
                    params, mesh, data_axes=(), cfg=model.cfg))
        self.pool = SlotPool(
            model, n_slots, max_len,
            block_size=self.block_size if self.paged else None,
            kv_blocks=self.kv_blocks, ctx=self._ctx)
        self._prefill = make_batched_prefill(model, ctx=self._ctx)
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
        self.prefix_hit_tokens = 0
        self.prefilled_tokens = 0
        self.cow_count = 0
        self._peak_live_tokens = 0
        self._peak_blocks = 0

    def _macro(self, horizon: int) -> Callable:
        """K-token macro-step, cached per horizon (the candidate set is
        fixed, so this cache is bounded)."""
        fn = self._macro_fns.get(horizon)
        if fn is None:
            fn = make_decode_macro_step(self.model, horizon,
                                        eos_id=self.eos_id,
                                        pad_id=self.pad_id, ctx=self._ctx)
            self._macro_fns[horizon] = fn
        return fn

    @property
    def collective_ops(self) -> int:
        """Collective calls made on the mesh so far (0 unsharded)."""
        return self._ctx.mesh.collectives if self._ctx is not None else 0

    def _release(self, slot: int) -> None:
        self.pool.release(slot)
        self._last_tok[slot] = self.pad_id
        self._budget[slot] = 0

    # ------------------------------------------------------------------

    def _thread_context(self) -> Callable[[], contextlib.ExitStack]:
        """The calling thread's grad mode, inference mode, kernel tuner
        and, on a card, CUDA device and stream, captured so a watchdog's
        worker thread can run the step under the same ones: torch keeps
        each per thread, as ``kernels.tuning`` keeps the tuner, and a worker
        left to its defaults could build an autograd graph, launch on
        another device or stream, or launch with another tuner's tiles."""
        grad = torch.is_grad_enabled()
        tuner = tuning.active()
        inference = torch.is_inference_mode_enabled()
        dev = self.model.device
        index = stream = None
        if dev.type == "cuda":
            # "cuda" without an index means this thread's current device
            index = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            stream = torch.cuda.current_stream(index)

        def enter() -> contextlib.ExitStack:
            stack = contextlib.ExitStack()
            stack.enter_context(torch.inference_mode(inference))
            stack.enter_context(torch.set_grad_enabled(grad))
            if tuner is not None:
                stack.enter_context(tuning.using(tuner))
            if stream is not None:
                stack.enter_context(torch.cuda.device(index))
                stack.enter_context(torch.cuda.stream(stream))
            return stack

        return enter

    def _dispatch(self, site: str, thunk, touched: List[Request]):
        """Execute one device-step thunk.  Without an injector or watchdog
        this is a DIRECT call — the unperturbed hot path stays thread-free.
        With either, the step runs under ``guarded_call``: injected faults
        fire, the watchdog bounds a stall (the step then runs on a worker
        thread under this thread's device, stream and grad mode), transient
        failures retry with backoff (counted onto the engine and the
        ``touched`` requests), and exhaustion or abandonment surfaces as
        ``StepFailed`` for ``run()`` to convert into per-request FAILED and
        a pool drain.  A failed step is never retried on the CPU or through
        a plain version: the retry runs the same kernels."""
        if self.injector is None and not self.watchdog_s:
            return thunk(None)
        context = self._thread_context()

        def before_thunk(cancel):
            with context():
                if self.injector is not None:
                    self.injector.before(site, cancel)
                return thunk(cancel)

        def on_retry(attempt, err):
            self.step_retries += 1
            for r in touched:
                r.retries += 1

        def on_watchdog(attempt):
            self.watchdog_fires += 1

        return guarded_call(
            before_thunk, watchdog_s=self.watchdog_s,
            retries=self.max_retries, backoff_s=self.retry_backoff_s,
            on_retry=on_retry, on_watchdog=on_watchdog)

    def _publish(self, req: Request, tokens, done: bool, t: float) -> None:
        """Publish a request's newly emitted tokens to the attached stream
        (no-op without one).  A broken stream flips ``_stream_dead``;
        ``run()`` then fails everything in flight, because tokens that
        cannot reach the client are not worth generating."""
        if self.stream is None or self._stream_dead:
            return
        try:
            self.stream.publish(req.rid, tokens, done=done, t=t)
        except StreamBroken as e:
            self._stream_dead = True
            self._stream_reason = f"frontend stream broken: {e}"

    def _fail_inflight(self, reqs: List[Request], t: float,
                       reason: str, fresh: bool = False) -> None:
        """Mark ``reqs`` FAILED and return the pool to empty (every slot
        released, every page reclaimed).  ``fresh`` (after an abandoned
        step) gives the pool new state tensors instead of zeroing the ones
        the abandoned worker may still write into."""
        for r in reqs:
            if not r.state.terminal:
                r.mark(RequestState.FAILED, t, reason=reason)
                self._publish(r, (), done=True, t=t)
        self.pool.drain(fresh=fresh)
        self._last_tok[:] = self.pad_id
        self._budget[:] = 0
        self._last_macro_key = None

    @staticmethod
    def _full_prompt(r: Request) -> np.ndarray:
        """What admission prefills: the prompt, plus, for a request
        re-admitted after preemption, the tokens it already generated."""
        p = np.asarray(r.prompt, np.int64)
        if r.tokens:
            p = np.concatenate([p, np.asarray(r.tokens, np.int64)])
        return p

    def _split_group(self, group: List[Request]):
        """Within-group prefix sharing.  The radix lookups all run before
        the group's one batched prefill, so members are blind to each
        other's pages.  A member whose block-aligned shared prefix with an
        earlier KEPT member is not yet resident is deferred to the next
        admission round, where the donor's published pages turn its
        prefill into an ordinary radix hit.  Deferral fires only when the
        serve_prefix cost model would APPLY that hit (the pricing the
        member meets at its own admission), and only behind a donor kept
        in this group, so every round admits at least one request."""
        bs = self.block_size
        sch = self.scheduler
        kept: List[Request] = []
        kept_prompts: List[List[int]] = []
        deferred: List[Request] = []
        for r in group:
            p = [int(t) for t in self._full_prompt(r)]
            plen = len(p)
            # lookup()'s cap: at most plen - 1 prompt tokens come from the
            # cache, and only in full blocks
            cap = ((plen - 1) // bs) * bs
            shared = 0
            for q in kept_prompts:
                n = 0
                for a, b in zip(p, q):
                    if a != b:
                        break
                    n += 1
                shared = max(shared, min((n // bs) * bs, cap))
            if (shared >= bs and self.pool.blocks.resident_prefix_tokens(
                    p[:shared]) < shared):
                kw = dict(flops_per_token=sch.flops_per_token,
                          weight_bytes=sch.weight_bytes, block_size=bs,
                          kv_bytes_per_token=sch.kv_bytes_per_token,
                          dtype_bytes=sch.dtype_bytes)
                reuse = sch.engine.model.serve_prefix_cost(
                    plen, shared, plen, **kw)
                base = sch.engine.model.serve_prefix_cost(plen, 0, plen, **kw)
                if (self._prefix_override == "use_prefix"
                        or reuse.total <= base.total):
                    deferred.append(r)
                    continue
            kept.append(r)
            kept_prompts.append(p)
        return kept, deferred

    def _lookup_prefix(self, slot: int, prompt: np.ndarray):
        """Paged admission of one prompt into ``slot``: the radix lookup,
        the ``serve_prefix`` verdict, then the matched pages pinned into
        the slot's table (a partial-tail match copied on write into one
        private page) or the pins dropped, and the table grown to cover
        the prompt.  Returns (applied hit length, decision)."""
        bs = self.block_size
        plen = int(prompt.shape[-1])
        match = (self.pool.blocks.lookup(tuple(int(t) for t in prompt))
                 if self.prefix_cache else None)
        hit = match.hit_tokens(bs) if match is not None else 0
        cow = int(match is not None and match.tail_donor is not None)
        applied, dec = self.scheduler.serve_prefix(
            plen, hit_tokens=hit, cow_blocks=cow, block_size=bs,
            override=self._prefix_override)
        if applied > 0:
            self.pool.assign_prefix(slot, match.block_ids)
            if match.tail_donor is not None:
                self.pool.cow_block(slot, match.tail_donor)
                self.cow_count += 1
        elif match is not None:  # full-prefill verdict: drop the pins
            self.pool.blocks.release(match.block_ids)
            if match.tail_donor is not None:
                self.pool.blocks.decref(match.tail_donor)
        self.pool.ensure_blocks(slot, plen)
        return applied, dec

    def _admit_group(self, reqs: List[Request], now) -> None:
        """Admit a group with ONE batched prefill lowered directly into
        their pooled slots (one host sync for the whole group).  First
        tokens are stamped after prefill returns, so TTFT includes it.

        A request re-admitted after preemption prefills its prompt plus
        the tokens it already generated: greedy decode is deterministic,
        so its continuation equals an uninterrupted run's (its first
        ``admitted_s`` / ``first_token_s`` stamps are kept).

        Paged admission adds the radix prefix cache: each prompt is looked
        up in the page trie, a ``use_prefix`` verdict pins the matched
        pages into the slot's table and prefills only the suffix, and the
        full prompt's pages go back into the trie after the prefill, so
        the next request sharing the prefix hits.  A preempted request
        re-pins its own prompt's pages the same way."""
        dev = self.model.device
        slots = [self.pool.acquire(r) for r in reqs]
        prompts = [self._full_prompt(r) for r in reqs]
        starts = np.zeros((self.pool.n_slots,), np.int64)
        prefix_decs = []  # (decision, prompt_len, applied) per request
        if self.paged:
            for s, p in zip(slots, prompts):
                applied, dec_p = self._lookup_prefix(s, p)
                starts[s] = applied
                self.prefix_hit_tokens += applied
                prefix_decs.append((dec_p, int(p.shape[-1]), applied))
        self.prefilled_tokens += sum(int(p.shape[-1]) for p in prompts) \
            - int(starts.sum())
        # hit rows prefill their SUFFIX only (never empty: lookup caps a hit
        # at prompt_len - 1); a group with a hit pads to its longest suffix
        # instead of the trace-wide prompt pad
        suffixes = [p[int(starts[s]):] for s, p in zip(slots, prompts)]
        any_hit = bool(starts.any())
        lmax = max([int(sfx.shape[-1]) for sfx in suffixes]
                   + ([] if any_hit else [self._group_pad or 0]))
        override = None if self.prefill_chunk == "auto" else self.prefill_chunk
        chunk, dec = self.scheduler.prefill_chunk(
            lmax, active_decodes=self.pool.active_count - len(reqs),
            override=override)
        tokens = np.zeros((self.pool.n_slots, lmax), np.int64)
        lengths = np.zeros((self.pool.n_slots,), np.int64)
        t_adm = now()
        for r, s, sfx in zip(reqs, slots, suffixes):
            if r.admitted_s is None:
                r.admitted_s = t_adm
            r.mark(RequestState.PREFILLING, t_adm)
            tokens[s, : sfx.shape[-1]] = sfx
            lengths[s] = sfx.shape[-1]
        chunks = _to_device(_prefill_chunks(tokens, chunk), dev)
        lens = _to_device(lengths, dev)
        # the paged inputs go up without a host sync: paging adds none
        extra = ((upload(starts, dev), self.pool.block_tables())
                 if self.paged else ())

        def thunk(cancel, _state=self.pool.state):
            # the state is bound here, on this thread: a worker the
            # watchdog abandons keeps these tensors, never a later pool's
            first, new_state = self._prefill(self.params, _state, chunks,
                                             lens, *extra)
            # THE host sync for the group, inside the guarded call, so the
            # watchdog covers the device's execution, not only the launches
            return first.cpu().numpy(), new_state

        t0 = time.perf_counter()
        first_np, self.pool.state = self._dispatch("prefill", thunk, reqs)
        dt = time.perf_counter() - t0
        self.device_dispatches += 1
        self.host_syncs += 1
        self.scheduler.record_measured(
            dec, dt, note=f"prefill group={len(reqs)} len={lmax} chunk={chunk}")
        for dec_p, plen, applied in prefix_decs:
            self.scheduler.record_measured(
                dec_p, dt, note=f"serve_prefix len={plen} hit={applied} "
                                f"group={len(reqs)}")
        t_first = now()
        for r, s, p in zip(reqs, slots, prompts):
            tk = int(first_np[s])
            r.tokens.append(tk)
            if r.first_token_s is None:
                r.first_token_s = t_first
            self.pool.set_pos(s, int(p.shape[-1]))
            if self.prefix_cache:
                # publish the prompt's full pages into the trie before any
                # release, so they survive slot turnover (dedupe swaps
                # repoint this slot at resident duplicates)
                swaps = self.pool.blocks.insert(
                    tuple(int(t) for t in p), self.pool.slot_table(s))
                self.pool.apply_swaps(s, swaps)
            done = tk == self.eos_id or len(r.tokens) >= r.max_new_tokens
            if done:
                r.mark(RequestState.COMPLETED, t_first)
                self._release(s)
            else:
                r.mark(RequestState.DECODING, t_first)
                self._last_tok[s] = tk
                self._budget[s] = r.max_new_tokens - len(r.tokens)
            self._publish(r, (tk,), done=done, t=t_first)
        self._peak_live_tokens = max(self._peak_live_tokens,
                                     int(self.pool.positions().sum()))
        if self.paged:
            self._peak_blocks = max(self._peak_blocks,
                                    self.pool.blocks.used_blocks)

    # ------------------------------------------------------------------

    def request_stop(self) -> None:
        """Ask a running trace to shut down gracefully: intake stops at the
        next loop boundary (queued requests -> typed REJECTED), in-flight
        slots decode to terminal states, run() returns its report.  Safe to
        call from a signal handler or another thread — it only sets a
        flag.  Sticky until ``reset_stop()``."""
        self._stop_requested = True

    def reset_stop(self) -> None:
        """Re-arm after a graceful shutdown so the engine can serve another
        trace (``stop_event`` holders must also clear their event)."""
        self._stop_requested = False

    def _should_stop(self) -> bool:
        return self._stop_requested or (
            self.stop_event is not None and self.stop_event.is_set())

    def run(self, requests: List[Request],
            now_fn=time.perf_counter) -> ServeReport:
        """Run a request trace to completion: every request reaches a
        terminal lifecycle state (the drain invariant), whatever deadlines,
        preemptions or injected faults fire along the way.  ``now_fn`` is
        injectable so tests can pin a virtual clock (arrivals then resolve
        instantly).

        An unperturbed trace — no deadlines, uniform priorities, no
        injector or watchdog — takes EXACTLY the path it takes without the
        lifecycle: the same CostQuery sequence, the same launches, no
        thread and no extra host sync, and therefore the same tokens."""
        for r in requests:
            validate_request(r, self.max_len)  # typed, names the rid
            r.reset_lifecycle()
        self._group_pad = max((r.prompt_len for r in requests), default=0)
        # deadline machinery only engages when a request asks for it
        any_deadlines = any(r.deadline_s is not None
                            or r.ttft_deadline_s is not None
                            for r in requests)
        dev = self.model.device
        pending = deque(sorted(requests, key=lambda r: r.arrival_s))  # stable
        waiting: List[Request] = []  # arrived, QUEUED (incl. re-queued)
        active: Dict[int, Request] = {}
        sync0 = self.host_syncs
        disp0 = self.device_dispatches + self.pool.dispatch_count
        col0 = self.collective_ops
        ret0, wd0 = self.step_retries, self.watchdog_fires
        hit0, pf0, cow0 = (self.prefix_hit_tokens, self.prefilled_tokens,
                           self.cow_count)
        ev0 = tok0 = 0
        if self.stream is not None:
            ev0 = self.stream.published_events
            tok0 = self.stream.published_tokens
        self._stream_dead = False
        self._stream_reason = ""
        self._peak_live_tokens = 0
        self._peak_blocks = 0
        # ONE measured wall time a run on the serve_shard row (the first
        # macro-step, a decode step's share of it)
        self._shard_pending = self._shard_decision is not None
        t0 = now_fn()
        offset = 0.0  # event-skip accumulator for frozen (virtual) clocks
        now = lambda: now_fn() - t0 + offset  # noqa: E731

        def intake(t: float) -> None:
            """Move arrived requests into the waiting queue, bouncing off a
            full bounded queue (backpressure -> typed REJECTED) and expiring
            deadlines that lapsed while QUEUED."""
            while pending and pending[0].arrival_s <= t:
                r = pending.popleft()
                if (self.queue_limit is not None
                        and len(waiting) >= self.queue_limit):
                    r.mark(RequestState.REJECTED, t, reason="queue_full")
                    continue
                waiting.append(r)
            if any_deadlines:
                still = []
                for r in waiting:
                    if (r.deadline_s is not None
                            and t - r.arrival_s > r.deadline_s):
                        r.mark(RequestState.TIMED_OUT, t,
                               reason="deadline expired while queued")
                    else:
                        still.append(r)
                waiting[:] = still

        try:
            while pending or waiting or active:
                if self._should_stop() and (pending or waiting):
                    # graceful shutdown: intake stops NOW — everything not
                    # yet holding a slot ends REJECTED (typed, so a client
                    # can tell "shed at shutdown" from a fault) — while
                    # active slots keep decoding to completion below
                    t_stop = now()
                    for r in list(pending) + waiting:
                        r.mark(RequestState.REJECTED, t_stop,
                               reason="shutdown: intake stopped")
                    pending.clear()
                    waiting.clear()
                if self._stream_dead:
                    # the stream's consumer is gone: fail everything not yet
                    # terminal (typed) and empty the pool
                    self._fail_inflight(
                        [r for r in requests if not r.state.terminal],
                        now(), reason=self._stream_reason)
                    pending.clear()
                    waiting.clear()
                    active = {}
                    break
                # intake runs even when the pool is full, so bounded-queue
                # backpressure and queued-deadline expiry act on arrival,
                # not on the next free slot
                intake(now())
                # --- admission (one batched prefill per admitted group) ---
                while (pending or waiting) and self.pool.free_count:
                    t = now()
                    intake(t)
                    if not waiting:
                        break
                    n_admit, _ = self.scheduler.admission(
                        active=self.pool.active_count, waiting=len(waiting),
                        free_slots=self.pool.free_count)
                    if n_admit <= 0:
                        break
                    # stable sort: priority first, then arrival order — at
                    # uniform priority this IS the FIFO order
                    waiting.sort(key=lambda r: (-r.priority, r.arrival_s))
                    group: List[Request] = []
                    want = min(n_admit, self.pool.free_count, len(waiting))
                    while len(group) < want and waiting:
                        r = waiting[0]
                        if (r.deadline_s is not None
                                or r.ttft_deadline_s is not None):
                            ok, _ = self.scheduler.serve_admit(
                                r, now=t,
                                active=self.pool.active_count + len(group),
                                n_slots=self.pool.n_slots)
                            if not ok:
                                waiting.pop(0)
                                r.mark(RequestState.REJECTED, t,
                                       reason="deadline_infeasible")
                                continue
                        group.append(waiting.pop(0))
                    if not group:
                        continue  # everything at the head was shed
                    if self.prefix_cache and len(group) > 1:
                        group, deferred = self._split_group(group)
                        # back to the queue head: next round, the donor's
                        # pages are published and these become radix hits
                        waiting[0:0] = deferred
                    try:
                        self._admit_group(group, now)
                    except StepFailed as e:
                        # prefill died (retries exhausted or abandoned):
                        # fail the group AND anything in flight, drain,
                        # keep serving
                        self._fail_inflight(
                            group + list(active.values()), now(),
                            reason=f"prefill step failed: {e}",
                            fresh=e.abandoned)
                        active = {}
                        continue
                    active = {s: self.pool.owner(s)
                              for s in self.pool.active_slots()}

                # --- priority preemption: a strictly-higher-priority
                # waiter evicts the lowest-priority active slot (the victim
                # re-queues and later re-prefills prompt + generated, so
                # its greedy output is unchanged).  Never fires at uniform
                # priority: the unperturbed path skips all of it.
                if (waiting and active and not self.pool.free_count
                        and max(r.priority for r in waiting)
                        > min(r.priority for r in active.values())):
                    t = now()
                    victim_slot = min(
                        active, key=lambda s: (active[s].priority, -s))
                    victim = active.pop(victim_slot)
                    self._release(victim_slot)
                    self._last_macro_key = None
                    victim.preemptions += 1
                    victim.mark(RequestState.PREEMPTED, t)
                    victim.mark(RequestState.QUEUED, t)
                    waiting.append(victim)
                    continue  # admission fills the freed slot

                if not active:
                    if waiting:
                        continue  # admission re-runs (sheds or admits)
                    if pending:
                        # sleep straight to the next arrival; a pinned test
                        # clock (no progress over a 1 ms probe) jumps
                        # instead
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
                override = None if self.macro_step == "auto" \
                    else self.macro_step
                # key on the budget clipping the CostEngine applies, so
                # repeat compositions dedupe instead of re-recording
                cap = max(self.scheduler.macro_candidates) \
                    if override is None else override
                key = (batch_size, tuple(min(r, cap) for r in remaining))
                horizon, dec = self.scheduler.macro_horizon(
                    remaining, override=override,
                    record=key != self._last_macro_key)
                self._last_macro_key = key
                mextra = ()
                if self.paged:
                    # grow each live slot's table to cover this macro-step's
                    # K cache writes, then upload the tables (no host sync)
                    pos = self.pool.positions()
                    for s in active:
                        self.pool.ensure_blocks(s, int(pos[s]) + horizon)
                    mextra = (self.pool.block_tables(),)
                    self._peak_live_tokens = max(self._peak_live_tokens,
                                                 int(pos.sum()))
                    self._peak_blocks = max(self._peak_blocks,
                                            self.pool.blocks.used_blocks)
                t_step = time.perf_counter()
                macro_args = (_to_device(self._last_tok, dev),
                              _to_device(self.pool.active_mask(), dev),
                              _to_device(self._budget, dev), *mextra)

                def thunk(cancel, _fn=self._macro(horizon),
                          _state=self.pool.state, _args=macro_args):
                    emitted, new_state = _fn(self.params, _state, *_args)
                    # THE host sync for K tokens, inside the guard so the
                    # watchdog covers device execution, not just launches
                    return emitted.cpu().numpy(), new_state

                try:
                    em, self.pool.state = self._dispatch(
                        "macro", thunk, list(active.values()))
                except StepFailed as e:
                    self._fail_inflight(list(active.values()), now(),
                                        reason=f"macro step failed: {e}",
                                        fresh=e.abandoned)
                    active = {}
                    continue
                dt_step = time.perf_counter() - t_step
                self.device_dispatches += 1
                self.host_syncs += 1
                self.scheduler.record_measured(
                    dec, dt_step, note=f"macro K={horizon} b={batch_size}")
                if self._shard_pending:
                    self.scheduler.record_measured(
                        self._shard_decision, dt_step / horizon,
                        note=f"serve_shard tp={self.tp} per-step from macro "
                             f"K={horizon} b={batch_size}")
                    self._shard_pending = False
                # the injected NaN fault class: NaN logits argmax to garbage
                # tokens; the injector corrupts the host copy and the
                # validation below (on the macro-step's host copy the engine
                # already synced: no extra sync) catches it
                bad_slots: set = set()
                if self.injector is not None:
                    em = self.injector.corrupt("macro", em, sorted(active))
                    vocab = self.model.cfg.vocab_size
                    bad = np.argwhere((em < 0) | (em >= vocab))
                    bad_slots = {int(s) for s in bad[:, 0]} & set(active)
                t_emit = now()
                for slot in list(active):
                    req = active[slot]
                    if slot in bad_slots:
                        # poison output fails THIS request; the other
                        # slots' device state advanced normally
                        req.mark(RequestState.FAILED, t_emit,
                                 reason="corrupt step output (NaN logits)")
                        self._release(slot)
                        self._last_macro_key = None
                        self._publish(req, (), done=True, t=t_emit)
                        del active[slot]
                        continue
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
                    # the macro-step's one host sync already happened:
                    # streaming this burst costs no extra device traffic
                    burst = tuple(req.tokens[n_before:])
                    if finished:
                        req.mark(RequestState.COMPLETED, t_emit)
                        self._release(slot)
                        del active[slot]
                    elif (any_deadlines and req.deadline_s is not None
                          and t_emit - req.arrival_s > req.deadline_s):
                        # deadlines are enforced at macro-step boundaries:
                        # evict to TIMED_OUT, free the slot at once
                        req.mark(RequestState.TIMED_OUT, t_emit,
                                 reason="total-latency deadline exceeded "
                                        "while decoding")
                        self._release(slot)
                        self._last_macro_key = None
                        del active[slot]
                        finished = True
                    else:
                        self._last_tok[slot] = int(em[slot, horizon - 1])
                        self._budget[slot] -= n_emitted
                    self._publish(req, burst, done=finished, t=t_emit)
                self._peak_live_tokens = max(self._peak_live_tokens,
                                             int(self.pool.positions().sum()))
        except BaseException:
            # abort safety net (fatal faults, KeyboardInterrupt, bugs):
            # leave the ENGINE reusable — in-flight requests FAILED, the
            # pool drained back to a valid empty state — then re-raise.
            # PREFILLING catches a group that died inside _admit_group.
            inflight = [r for r in requests
                        if r.state in (RequestState.PREFILLING,
                                       RequestState.DECODING)]
            self._fail_inflight(inflight, now(), reason="run aborted")
            raise

        return ServeReport(
            requests=list(requests), wall_s=now(), pad_id=self.pad_id,
            host_syncs=self.host_syncs - sync0,
            device_dispatches=(self.device_dispatches
                               + self.pool.dispatch_count - disp0),
            mesh_shape=(self.mesh.shape if self.mesh is not None else None),
            device_count=(self.mesh.size if self.mesh is not None else 1),
            collective_ops=self.collective_ops - col0,
            step_retries=self.step_retries - ret0,
            watchdog_fires=self.watchdog_fires - wd0,
            live_tokens=self._peak_live_tokens,
            reserved_blocks=self._peak_blocks,
            prefix_hit_tokens=self.prefix_hit_tokens - hit0,
            prefilled_tokens=self.prefilled_tokens - pf0,
            cow_count=self.cow_count - cow0,
            streamed_tokens=(self.stream.published_tokens - tok0
                             if self.stream is not None else 0),
            stream_events=(self.stream.published_events - ev0
                           if self.stream is not None else 0))

    def warmup(self, prompt_len: int, max_new_tokens: int = 2) -> None:
        """Run one short dummy request through the normal machinery before
        a timed trace, so the kernels are built and loaded and the
        allocator is warm.  Eager execution compiles nothing per shape, so
        unlike the reference no horizon needs precompiling."""
        dummy_new = min(2, max(max_new_tokens, 1))
        self.run([Request("_warmup", np.ones((prompt_len,), np.int64),
                          dummy_new)])
        self._last_macro_key = None
