"""CostEngine: the one authoritative cost oracle behind every fork-join
decision.

Layering (DESIGN.md §3):

    decision sites (dispatch / sort / planner / scan chunking / MoE)
        |        uniform CostQuery -> Decision
        v
    CostEngine ── decision cache (memoized sweeps for trace-time hot paths)
        |     \── overhead ledger (predicted breakdown + measured wall time)
        v
    OverheadModel (analytic; costs/model.py)
        |
        v
    HardwareSpec — H100 data-sheet constants, or a spec calibrated on the
                   running card (costs/calibration.py)

Call sites receive an engine explicitly — a ``repro_torch.Runtime`` owns
exactly one, so one session means one ledger and one decision cache.  Call
sites that pass nothing get a fresh engine (``resolve_engine``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.costs.calibration import (
    CalibrationResult,
    calibrate,
    run_probe_fields,
    save_calibration,
)
from repro_torch.core.costs.corrections import CorrectionState
from repro_torch.core.costs.ledger import LedgerEntry, OverheadLedger
from repro_torch.core.costs.model import (
    MATMUL_STRATEGIES,
    CostBreakdown,
    OverheadModel,
)
from repro_torch.hw import H100, SITE_FIELDS, HardwareSpec


@dataclasses.dataclass(frozen=True)
class CostQuery:
    """Hashable description of one fork-join decision problem.

    ``kind``: matmul | sort | scan_chunk | moe_dispatch | layer_shard |
    serve | serve_macro | serve_shard | serve_admit | serve_prefix |
    serve_ipc.
    ``shape``: the problem dims that kind cares about (documented per
    ``CostEngine._solve_*``).  ``params``: extra kwargs, sorted for hashing.
    """

    kind: str
    shape: Tuple[int, ...]
    chips: int = 1
    dtype_bytes: int = 2
    params: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def make(cls, kind: str, shape: Sequence[int], *, chips: int = 1,
             dtype_bytes: int = 2, **params) -> "CostQuery":
        return cls(kind, tuple(int(s) for s in shape), int(chips),
                   int(dtype_bytes), tuple(sorted(params.items())))

    def param(self, key: str, default: Any = None) -> Any:
        for k, v in self.params:
            if k == key:
                return v
        return default

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"shape": "x".join(map(str, self.shape)),
                             "chips": self.chips, "dtype_bytes": self.dtype_bytes}
        d.update(self.params)
        return d


@dataclasses.dataclass(frozen=True)
class Decision:
    """What the engine chose, with the evidence: the chosen predicted
    breakdown, the serial/replicated baseline, and every alternative the
    sweep considered."""

    query: CostQuery
    choice: str
    predicted: CostBreakdown
    baseline: Optional[CostBreakdown] = None
    alternatives: Tuple[CostBreakdown, ...] = ()
    value: Any = None  # python-native choice (e.g. int chunk size)
    # per-site correction factor baked into predicted/baseline/alternatives
    # at query time (1.0 when corrections are off) — ledgered with every
    # row so the raw analytic ratio stays recoverable
    correction: float = 1.0

    @property
    def predicted_s(self) -> float:
        return self.predicted.total

    @property
    def predicted_speedup(self) -> float:
        """Baseline total over chosen total (>= 1.0 when parallel wins)."""
        if self.baseline is None or self.predicted.total <= 0:
            return 1.0
        return self.baseline.total / self.predicted.total


class CostEngine:
    """Calibratable, caching, ledgered cost oracle.

    ``hw``: HardwareSpec to run the analytic model on (H100 data sheet by
    default); ``model`` overrides the whole analytic model (tests).
    """

    def __init__(self, hw: Optional[HardwareSpec] = None, *,
                 model: Optional[OverheadModel] = None,
                 ledger: Optional[OverheadLedger] = None,
                 calibration: Optional[CalibrationResult] = None,
                 corrections: Optional[CorrectionState] = None):
        self.model = model if model is not None else OverheadModel(hw=hw or H100)
        self.hw = self.model.hw
        self.ledger = ledger if ledger is not None else OverheadLedger()
        self.calibration = calibration
        self._cache: Dict[CostQuery, Decision] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        # --- closed-loop state (DESIGN.md §10; all inert when
        # corrections is None: the default engine behaves exactly as the
        # open-loop one did) ---
        self.corrections = corrections
        self._site_factor = 1.0  # factor live during the current solve
        self.cache_invalidations = 0
        self.perturbed_fields: Dict[str, float] = {}  # chaos hook bookkeeping
        self.recalibrated_fields: Dict[str, float] = {}
        # chaos fault hook: site -> multiplicative noise on measured seconds
        self.measurement_noise: Optional[Callable[[str], float]] = None
        if corrections is not None:
            # every measured row (record_measured AND ledger.measure blocks)
            # flows back through one observer
            self.ledger.on_measurement = self._on_measurement

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def calibrated(cls, base: HardwareSpec = H100, *,
                   cache_dir: Optional[Path] = None, force: bool = False,
                   matmul_order: int = 1024, device: str = "cuda",
                   **kw) -> "CostEngine":
        """Engine whose model runs on a spec microbenchmarked on the card
        ``device`` (cached by fingerprint).  When a ``corrections`` state is
        passed, factors persisted in the same fingerprint-keyed cache entry
        are restored into it — a new session inherits the healed state the
        previous one learned."""
        result = calibrate(base, cache_dir=cache_dir, force=force,
                           matmul_order=matmul_order, device=device)
        eng = cls(hw=result.spec, calibration=result, **kw)
        if eng.corrections is not None:
            eng.corrections.load(result.corrections)
        return eng

    # ------------------------------------------------------------------
    # The uniform interface
    # ------------------------------------------------------------------

    def query(self, q: CostQuery, *, record: bool = True) -> Decision:
        """CostQuery -> Decision, memoized.  Every call (hit or miss) is
        appended to the ledger unless ``record=False``.

        With a corrections state attached, the site's current factor is
        applied at solve time: every candidate breakdown is scaled
        uniformly (argmin verdicts unchanged — see corrections.py) and
        absolute-threshold solvers (serve_admit) read ``_site_factor``
        inside their comparison so deadline verdicts track the corrected
        scale.  Cached decisions keep the factor they were solved with;
        when the factor moves past the invalidation threshold the cache
        entries for that site are dropped, so staleness is bounded."""
        cached = q in self._cache
        if cached:
            self.cache_hits += 1
            dec = self._cache[q]
        else:
            self.cache_misses += 1
            solver = getattr(self, f"_solve_{q.kind}", None)
            if solver is None:
                raise ValueError(f"unknown cost query kind: {q.kind!r}")
            f = (self.corrections.factor(q.kind)
                 if self.corrections is not None else 1.0)
            self._site_factor = f
            try:
                dec = solver(q)
            finally:
                self._site_factor = 1.0
            if f != 1.0:
                dec = dataclasses.replace(
                    dec, correction=f, predicted=dec.predicted.scaled(f),
                    baseline=(dec.baseline.scaled(f)
                              if dec.baseline is not None else None),
                    alternatives=tuple(cb.scaled(f)
                                       for cb in dec.alternatives))
            self._cache[q] = dec
        if record:
            self.ledger.record(q.kind, q.as_dict(), dec.choice, dec.predicted,
                               cached=cached, correction=dec.correction)
        return dec

    def record_measured(self, decision: Decision, seconds: float,
                        note: str = "") -> LedgerEntry:
        """Attach a measured wall time for an executed decision (closing the
        predicted-vs-measured loop outside a ``ledger.measure`` block).
        The chaos harness's noise hook perturbs the measurement here —
        upstream of the ledger and the correction loop, exactly where a
        noisy clock would."""
        if self.measurement_noise is not None:
            seconds *= float(self.measurement_noise(decision.query.kind))
        entry = self.ledger.record(
            decision.query.kind, decision.query.as_dict(), decision.choice,
            decision.predicted, note=note or "measured",
            correction=decision.correction)
        self.ledger.attach_measurement(entry, seconds)
        return entry

    # ------------------------------------------------------------------
    # Solvers (one per decision-site family)
    # ------------------------------------------------------------------

    def _solve_matmul(self, q: CostQuery) -> Decision:
        """shape=(m, n, k); params: io_at_master."""
        m, n, k = q.shape
        io = bool(q.param("io_at_master", False))
        cands = tuple(
            self.model.matmul_cost(m, n, k, chips=q.chips, strategy=s,
                                   dtype_bytes=q.dtype_bytes, io_at_master=io,
                                   devices=q.param("devices"))
            for s in MATMUL_STRATEGIES
        )
        best = min(cands, key=lambda cb: cb.total)
        serial = cands[0]
        return Decision(q, best.strategy, best, baseline=serial,
                        alternatives=cands, value=best.strategy)

    def _solve_sort(self, q: CostQuery) -> Decision:
        """shape=(n,)."""
        (n,) = q.shape
        serial = self.model.sort_cost(n, dtype_bytes=q.dtype_bytes,
                                      strategy="serial")
        cands = [serial]
        if q.chips > 1:
            cands.append(self.model.sort_cost(
                n, chips=q.chips, dtype_bytes=q.dtype_bytes, strategy="parallel",
                devices=q.param("devices")))
        best = min(cands, key=lambda cb: cb.total)
        return Decision(q, best.strategy, best, baseline=serial,
                        alternatives=tuple(cands), value=best.strategy)

    def _solve_scan_chunk(self, q: CostQuery) -> Decision:
        """shape=(seq, batch, heads, head_dim); params: candidates."""
        seq, batch, heads, head_dim = q.shape
        candidates = q.param("candidates", (16, 32, 64, 128, 256))
        cands = tuple(
            CostBreakdown(f"chunk_{c}",
                          self.model.scan_chunk_cost(
                              seq, c, batch=batch, heads=heads,
                              head_dim=head_dim, dtype_bytes=q.dtype_bytes),
                          0.0, 0.0, 0.0)
            for c in candidates if c <= max(seq, min(candidates))
        )
        best = min(cands, key=lambda cb: cb.total)
        chunk = int(best.strategy.split("_")[1])
        return Decision(q, best.strategy, best, baseline=cands[0],
                        alternatives=cands, value=chunk)

    def _solve_moe_dispatch(self, q: CostQuery) -> Decision:
        """shape=(tokens_local, d); params: top_k; chips = ep_shards."""
        tokens_local, d = q.shape
        costs = self.model.moe_dispatch_cost(
            tokens_local, d, top_k=int(q.param("top_k", 1)),
            ep_shards=q.chips, dtype_bytes=q.dtype_bytes,
            devices=q.param("devices"))
        cands = tuple(CostBreakdown(name, 0.0, 0.0, sec, 0.0)
                      for name, sec in sorted(costs.items()))
        best = min(cands, key=lambda cb: cb.total)
        baseline = next(c for c in cands if c.strategy == "replicated_psum")
        return Decision(q, best.strategy, best, baseline=baseline,
                        alternatives=cands, value=best.strategy)

    def _solve_layer_shard(self, q: CostQuery) -> Decision:
        """Planner site: shape=(m, n, k) of the layer matmul; chips = TP
        degree.  Chooses tensor-parallel (with its collective) vs replicated
        serial execution.  Only WEIGHT-sharding strategies are TP candidates:
        shard_m splits tokens, which on the model axis is just more data
        parallelism, not a param-sharding plan."""
        m, n, k = q.shape
        tp = min(
            (self.model.matmul_cost(m, n, k, chips=q.chips, strategy=s,
                                    dtype_bytes=q.dtype_bytes,
                                    devices=q.param("devices"))
             for s in ("shard_n", "shard_k", "shard_mn")),
            key=lambda cb: cb.total,
        ) if q.chips > 1 else None
        rep = self.model.matmul_cost(m, n, k, strategy="serial",
                                     dtype_bytes=q.dtype_bytes)
        if tp is not None and tp.total < rep.total:
            return Decision(q, "shard_model", tp, baseline=rep,
                            alternatives=(tp, rep), value="shard_model")
        alts = (tp, rep) if tp is not None else (rep,)
        return Decision(q, "replicate", rep, baseline=rep,
                        alternatives=alts, value="replicate")

    def _solve_serve(self, q: CostQuery) -> Decision:
        """Serving decision site (site=serve ledger rows).  ``op`` selects:

        * ``prefill_chunk`` — shape=(prompt_len,); choose the prefill chunk
          length.  Cost = chunked prefill total + a latency-interference
          term: every active decode slot stalls for one chunk before it can
          interleave again, so big chunks win on empty pools and shrink as
          decode occupancy rises.  Baseline = chunk 1 (the per-token replay
          loop the continuous engine retires).
        * ``admission`` — shape=(active_decodes,); admit waiting requests
          into free slots vs decode-only.  Evidence: per-token decode cost
          at the new vs current occupancy (weight streaming amortizes).
        * ``decode_step`` — shape=(batch,); the predicted cost of one
          decode step at this batch composition.  Baseline = the same
          slots decoded sequentially (no batching); the engine attaches
          measured step wall times to these rows.
        """
        op = q.param("op")
        fpt = float(q.param("flops_per_token", 0.0))
        wb = float(q.param("weight_bytes", 0.0))
        kvb = float(q.param("kv_bytes_per_slot", 0.0))
        if op == "prefill_chunk":
            (prompt_len,) = q.shape
            active = int(q.param("active_decodes", 0))
            cands_in = q.param("candidates", (1, 8, 16, 32, 64, 128, 256))
            seen, cands = set(), []
            for c in cands_in:
                c = max(1, min(int(c), prompt_len))
                if c in seen:
                    continue
                seen.add(c)
                total, per_chunk = self.model.serve_prefill_cost(
                    prompt_len, c, flops_per_token=fpt, weight_bytes=wb,
                    dtype_bytes=q.dtype_bytes)
                cands.append(CostBreakdown(
                    f"chunk_{c}", total, 0.0, active * per_chunk, 0.0))
            baseline = next((cb for cb in cands if cb.strategy == "chunk_1"),
                            cands[0])
            best = min(cands, key=lambda cb: cb.total)
            return Decision(q, best.strategy, best, baseline=baseline,
                            alternatives=tuple(cands),
                            value=int(best.strategy.split("_")[1]))
        if op == "admission":
            (active,) = q.shape
            waiting = int(q.param("waiting", 0))
            free = int(q.param("free_slots", 0))
            admit_n = min(waiting, free)
            cur = self.model.serve_decode_step_cost(
                active, flops_per_token=fpt, weight_bytes=wb,
                kv_bytes_per_slot=kvb, dtype_bytes=q.dtype_bytes)
            new = self.model.serve_decode_step_cost(
                active + admit_n, flops_per_token=fpt, weight_bytes=wb,
                kv_bytes_per_slot=kvb, dtype_bytes=q.dtype_bytes)
            per_tok_cur = cur.total / max(active, 1)
            per_tok_new = new.total / max(active + admit_n, 1)
            admit = admit_n > 0 and (active == 0 or per_tok_new <= per_tok_cur)
            return Decision(
                q, f"admit_{admit_n}" if admit else "decode_only",
                new if admit else cur, baseline=cur, alternatives=(cur, new),
                value=admit_n if admit else 0)
        if op == "decode_step":
            (batch,) = q.shape
            step = self.model.serve_decode_step_cost(
                batch, flops_per_token=fpt, weight_bytes=wb,
                kv_bytes_per_slot=kvb, dtype_bytes=q.dtype_bytes)
            single = self.model.serve_decode_step_cost(
                1, flops_per_token=fpt, weight_bytes=wb,
                kv_bytes_per_slot=kvb, dtype_bytes=q.dtype_bytes)
            sequential = CostBreakdown(
                "sequential", batch * single.compute, batch * single.memory,
                0.0, batch * single.fixed)
            return Decision(q, step.strategy, step, baseline=sequential,
                            alternatives=(step, sequential), value=batch)
        raise ValueError(f"unknown serve op: {op!r}")

    def _solve_serve_macro(self, q: CostQuery) -> Decision:
        """Decode macro-step horizon (site=serve_macro ledger rows).

        shape=(batch,); params: remaining (sorted per-slot budget tuple),
        candidates, flops_per_token, weight_bytes, kv_bytes_per_slot.
        Chooses the K minimizing predicted seconds PER USEFUL TOKEN: one
        host sync per macro-step amortizes over K tokens, but slots that
        finish mid-macro-step waste lockstep steps (``serve_macro_cost``).
        Baseline = K=1, today's one-sync-per-token loop.  The engine
        attaches measured per-macro-step wall times to these rows.
        """
        (batch,) = q.shape
        remaining = tuple(q.param("remaining", ()))
        fpt = float(q.param("flops_per_token", 0.0))
        wb = float(q.param("weight_bytes", 0.0))
        kvb = float(q.param("kv_bytes_per_slot", 0.0))
        seen, cands = set(), []
        for k in q.param("candidates", (1, 2, 4, 8)):
            # candidates are taken as given: the scheduler filters the auto
            # set by max remaining, and a pinned override must stay pinned
            k = max(1, int(k))
            if k in seen:
                continue
            seen.add(k)
            cands.append(self.model.serve_macro_cost(
                k, remaining, flops_per_token=fpt, weight_bytes=wb,
                kv_bytes_per_slot=kvb, dtype_bytes=q.dtype_bytes))
        baseline = next((cb for cb in cands if cb.strategy == "K_1"), cands[0])
        best = min(cands, key=lambda cb: cb.total)
        return Decision(q, best.strategy, best, baseline=baseline,
                        alternatives=tuple(cands),
                        value=int(best.strategy.split("_")[1]))

    def _solve_serve_admit(self, q: CostQuery) -> Decision:
        """Deadline-aware load shedding — the ninth decision site
        (site=serve_admit ledger rows).

        shape=(active,); params: prompt_len, new_tokens, slack_us /
        ttft_slack_us (remaining budget in quantized microseconds, None =
        no deadline), n_slots, flops_per_token, weight_bytes,
        kv_bytes_per_slot.  The request is ADMITTED iff its predicted
        residual service time (``serve_admit_cost``: one prefill + its
        remaining decode steps at post-admit occupancy) fits the remaining
        total-latency slack AND the prefill alone fits the TTFT slack;
        otherwise SHED — rejecting before any device work is spent is the
        cheapest point to manage the overhead.  Baseline = the admit cost
        itself (shedding costs nothing), so ``predicted_speedup`` reads as
        the service time a shed verdict avoided."""
        (active,) = q.shape
        fpt = float(q.param("flops_per_token", 0.0))
        wb = float(q.param("weight_bytes", 0.0))
        kvb = float(q.param("kv_bytes_per_slot", 0.0))
        prompt_len = int(q.param("prompt_len", 1))
        new_tokens = int(q.param("new_tokens", 1))
        admit_cb = self.model.serve_admit_cost(
            active, prompt_len=prompt_len, new_tokens=new_tokens,
            flops_per_token=fpt, weight_bytes=wb, kv_bytes_per_slot=kvb,
            dtype_bytes=q.dtype_bytes)
        prefill_s, _ = self.model.serve_prefill_cost(
            prompt_len, prompt_len, flops_per_token=fpt, weight_bytes=wb,
            dtype_bytes=q.dtype_bytes)
        slack_us = q.param("slack_us")
        ttft_slack_us = q.param("ttft_slack_us")
        # serve_admit compares against an ABSOLUTE slack, not an argmin
        # sweep, so the per-site correction factor must enter the
        # comparison itself — it is the one solver a scale correction can
        # (and should) flip
        f = self._site_factor
        admit = True
        if slack_us is not None and admit_cb.total * f > float(slack_us) * 1e-6:
            admit = False
        if (ttft_slack_us is not None
                and prefill_s * f > float(ttft_slack_us) * 1e-6):
            admit = False
        shed = CostBreakdown("shed", 0.0, 0.0, 0.0, 0.0)
        return Decision(q, "admit" if admit else "shed",
                        admit_cb if admit else shed, baseline=admit_cb,
                        alternatives=(admit_cb, shed), value=admit)

    def _solve_serve_shard(self, q: CostQuery) -> Decision:
        """Serve-time shard-vs-replicate — the eighth decision site
        (site=serve_shard ledger rows).

        shape=(batch,); chips = the mesh's model-axis size; params:
        candidates (TP degrees to sweep — restricting the set is how a
        forced override stays honest on the ledger), flops_per_token,
        weight_bytes, kv_bytes_per_slot, n_layers, d_model.  Each TP
        candidate's communication term is ``2 * n_layers`` all-reduces of
        the (batch, d_model) residual per decode step at the calibrated
        interconnect bandwidth/latency (``serve_shard_cost``); the savings
        are per-device FLOPs and weight/KV bytes divided by TP.  Baseline =
        tp=1, the replicated single-device step.  The engine attaches
        measured sharded macro-step wall times to these rows.
        """
        (batch,) = q.shape
        kw = dict(
            flops_per_token=float(q.param("flops_per_token", 0.0)),
            weight_bytes=float(q.param("weight_bytes", 0.0)),
            kv_bytes_per_slot=float(q.param("kv_bytes_per_slot", 0.0)),
            n_layers=int(q.param("n_layers", 1)),
            d_model=int(q.param("d_model", 1)),
            dtype_bytes=q.dtype_bytes)
        baseline = self.model.serve_shard_cost(batch, tp=1, **kw)
        seen, cands = set(), []
        for tp in q.param("candidates", (1, q.chips)):
            tp = max(1, int(tp))
            if tp in seen:
                continue
            seen.add(tp)
            cands.append(self.model.serve_shard_cost(
                batch, tp=tp, devices=q.param("devices") if tp == q.chips
                else None, **kw))
        best = min(cands, key=lambda cb: cb.total)
        choice = "replicate" if best.strategy == "tp_1" or best.strategy.startswith("decode_") \
            else "shard_model"
        value = 1 if choice == "replicate" else int(best.strategy.split("_")[1])
        return Decision(q, choice, best, baseline=baseline,
                        alternatives=tuple(cands), value=value)

    def _solve_serve_prefix(self, q: CostQuery) -> Decision:
        """Prefix-cache reuse vs full prefill at admission — the tenth
        decision site (site=serve_prefix ledger rows).

        shape=(prompt_len,); params: hit_tokens (radix-trie match length),
        cow_blocks (partial-tail blocks duplicated copy-on-write), chunk
        (the group's prefill chunk), block_size, flops_per_token,
        weight_bytes, kv_bytes_per_token.  Reuse pays suffix-only prefill
        plus the host trie walk (``hw.prefix_lookup_s`` per block) and the
        CoW page copy; baseline = full prefill of the whole prompt.  The
        engine attaches the admitted group's measured prefill wall time."""
        (prompt_len,) = q.shape
        hit = int(q.param("hit_tokens", 0))
        kw = dict(
            chunk=int(q.param("chunk", prompt_len)),
            flops_per_token=float(q.param("flops_per_token", 0.0)),
            weight_bytes=float(q.param("weight_bytes", 0.0)),
            block_size=int(q.param("block_size", 1)),
            kv_bytes_per_token=float(q.param("kv_bytes_per_token", 0.0)),
            dtype_bytes=q.dtype_bytes)
        baseline = self.model.serve_prefix_cost(prompt_len, 0, **kw)
        reuse = self.model.serve_prefix_cost(
            prompt_len, hit, cow_blocks=int(q.param("cow_blocks", 0)), **kw)
        override = q.param("override", None)
        if override == "use_prefix":
            use = hit > 0
        elif override == "full_prefill":
            use = False
        else:
            use = hit > 0 and reuse.total <= baseline.total
        best = reuse if use else baseline
        return Decision(q, "use_prefix" if use else "full_prefill", best,
                        baseline=baseline, alternatives=(reuse, baseline),
                        value=hit if use else 0)

    def _solve_serve_ipc(self, q: CostQuery) -> Decision:
        """Front-end IPC sizing — the eleventh decision site
        (site=serve_ipc ledger rows).  ``op`` selects:

        * ``workers`` — shape=(n_requests,); choose the intake worker
          count.  Candidates are ``serve_ipc_workers_cost`` pipelines
          (parent serialization vs slowest worker, plus a per-worker queue
          management tax); baseline = ``inline``, validating every request
          on the engine thread (no IPC at all).  ``override='frontend'``
          pins a worker verdict (the user asked for a front end) and
          ``override='inline'`` pins the baseline — both still price the
          full sweep, same idiom as serve_shard/serve_prefix.
        * ``coalesce`` — shape=(n_streams,); choose how many token events
          ride one emission IPC message.  Candidates amortize the queue
          round trip + message header against per-token delivery staleness
          at the predicted decode interval (``serve_ipc_coalesce_cost``);
          baseline = flush-every-event (coalesce 1).

        The front end attaches measured per-message round trips (startup
        pings) and per-burst emission times to these rows.
        """
        op = q.param("op")
        if op == "workers":
            (n_requests,) = q.shape
            msg_bytes = float(q.param("msg_bytes", 0.0))
            validate_s = float(q.param("validate_us", 0)) * 1e-6
            inline = CostBreakdown(
                "inline", max(n_requests, 1) * validate_s, 0.0, 0.0, 0.0)
            cands = [inline]
            for w in q.param("candidates", (1, 2, 4)):
                cands.append(self.model.serve_ipc_workers_cost(
                    n_requests, int(w), msg_bytes=msg_bytes,
                    validate_s=validate_s))
            override = q.param("override", None)
            if override == "frontend":
                best = min(cands[1:], key=lambda cb: cb.total)
            elif override == "inline":
                best = inline
            else:
                best = min(cands, key=lambda cb: cb.total)
            value = 0 if best.strategy == "inline" else \
                int(best.strategy.split("_w")[1])
            return Decision(q, best.strategy, best, baseline=inline,
                            alternatives=tuple(cands), value=value)
        if op == "coalesce":
            event_bytes = float(q.param("event_bytes", 0.0))
            interval_s = float(q.param("token_interval_us", 0)) * 1e-6
            seen, cands = set(), []
            for c in q.param("candidates", (1, 2, 4, 8, 16)):
                c = max(1, int(c))
                if c in seen:
                    continue
                seen.add(c)
                cands.append(self.model.serve_ipc_coalesce_cost(
                    c, event_bytes=event_bytes, token_interval_s=interval_s))
            baseline = next((cb for cb in cands if cb.strategy == "ipc_c1"),
                            cands[0])
            best = min(cands, key=lambda cb: cb.total)
            return Decision(q, best.strategy, best, baseline=baseline,
                            alternatives=tuple(cands),
                            value=int(best.strategy.split("_c")[1]))
        raise ValueError(f"unknown serve_ipc op: {op!r}")

    # ------------------------------------------------------------------
    # Convenience wrappers (the decision sites)
    # ------------------------------------------------------------------

    def decide_matmul(self, m: int, n: int, k: int, *, chips: int,
                      dtype_bytes: int = 2, io_at_master: bool = False,
                      devices: Optional[int] = None) -> Decision:
        return self.query(CostQuery.make(
            "matmul", (m, n, k), chips=chips, dtype_bytes=dtype_bytes,
            io_at_master=io_at_master, **_devices_param(chips, devices)))

    def decide_sort(self, n: int, *, chips: int, dtype_bytes: int = 4,
                    devices: Optional[int] = None) -> Decision:
        return self.query(CostQuery.make(
            "sort", (n,), chips=chips, dtype_bytes=dtype_bytes,
            **_devices_param(chips, devices)))

    def decide_scan_chunk(self, seq: int, *, batch: int, heads: int,
                          head_dim: int, dtype_bytes: int = 4,
                          candidates: Sequence[int] = (16, 32, 64, 128, 256)
                          ) -> Decision:
        return self.query(CostQuery.make(
            "scan_chunk", (seq, batch, heads, head_dim),
            dtype_bytes=dtype_bytes, candidates=tuple(candidates)))

    def decide_moe_dispatch(self, tokens_local: int, d: int, *, top_k: int,
                            ep_shards: int, dtype_bytes: int = 2,
                            devices: Optional[int] = None) -> Decision:
        return self.query(CostQuery.make(
            "moe_dispatch", (tokens_local, d), chips=ep_shards,
            dtype_bytes=dtype_bytes, top_k=top_k,
            **_devices_param(ep_shards, devices)))

    def decide_layer_shard(self, m: int, n: int, k: int, *, tp: int,
                           dtype_bytes: int = 2,
                           devices: Optional[int] = None) -> Decision:
        return self.query(CostQuery.make(
            "layer_shard", (m, n, k), chips=tp, dtype_bytes=dtype_bytes,
            **_devices_param(tp, devices)))

    def decide_serve_prefill_chunk(
            self, prompt_len: int, *, flops_per_token: float,
            weight_bytes: float, active_decodes: int = 0,
            dtype_bytes: int = 2,
            candidates: Sequence[int] = (1, 8, 16, 32, 64, 128, 256)
    ) -> Decision:
        return self.query(CostQuery.make(
            "serve", (prompt_len,), dtype_bytes=dtype_bytes,
            op="prefill_chunk", flops_per_token=int(flops_per_token),
            weight_bytes=int(weight_bytes), active_decodes=int(active_decodes),
            candidates=tuple(candidates)))

    def decide_serve_admission(self, active: int, *, waiting: int,
                               free_slots: int, flops_per_token: float,
                               weight_bytes: float,
                               kv_bytes_per_slot: float = 0,
                               dtype_bytes: int = 2) -> Decision:
        return self.query(CostQuery.make(
            "serve", (active,), dtype_bytes=dtype_bytes, op="admission",
            waiting=int(waiting), free_slots=int(free_slots),
            flops_per_token=int(flops_per_token),
            weight_bytes=int(weight_bytes),
            kv_bytes_per_slot=int(kv_bytes_per_slot)))

    def decide_serve_decode_step(self, batch: int, *, flops_per_token: float,
                                 weight_bytes: float,
                                 kv_bytes_per_slot: float = 0,
                                 dtype_bytes: int = 2,
                                 record: bool = True) -> Decision:
        return self.query(CostQuery.make(
            "serve", (batch,), dtype_bytes=dtype_bytes, op="decode_step",
            flops_per_token=int(flops_per_token),
            weight_bytes=int(weight_bytes),
            kv_bytes_per_slot=int(kv_bytes_per_slot)), record=record)

    def decide_serve_macro(self, batch: int, *, remaining: Sequence[int],
                           flops_per_token: float, weight_bytes: float,
                           kv_bytes_per_slot: float = 0, dtype_bytes: int = 2,
                           candidates: Sequence[int] = (1, 2, 4, 8),
                           record: bool = True) -> Decision:
        # clip budgets at the largest candidate before building the query:
        # min(K, r) is identical for every candidate K once r >= max(K), so
        # this is lossless — and it keeps the memoized decision cache
        # bounded instead of growing with every distinct budget tuple a
        # long-running server decrements through
        cap = max(candidates)
        return self.query(CostQuery.make(
            "serve_macro", (batch,), dtype_bytes=dtype_bytes,
            remaining=tuple(sorted(min(int(r), cap) for r in remaining)),
            candidates=tuple(candidates),
            flops_per_token=int(flops_per_token),
            weight_bytes=int(weight_bytes),
            kv_bytes_per_slot=int(kv_bytes_per_slot)), record=record)

    def decide_serve_admit(self, active: int, *, n_slots: int,
                           prompt_len: int, new_tokens: int,
                           slack_us: Optional[int], ttft_slack_us: Optional[int],
                           flops_per_token: float, weight_bytes: float,
                           kv_bytes_per_slot: float = 0,
                           dtype_bytes: int = 2) -> Decision:
        """Admit-vs-shed for a deadlined request taking a free slot.  Slacks
        arrive pre-quantized (scheduler ``_quantize_us``) so the memoized
        cache stays bounded while budgets count down."""
        return self.query(CostQuery.make(
            "serve_admit", (active,), dtype_bytes=dtype_bytes,
            n_slots=int(n_slots), prompt_len=int(prompt_len),
            new_tokens=int(new_tokens),
            slack_us=None if slack_us is None else int(slack_us),
            ttft_slack_us=None if ttft_slack_us is None else int(ttft_slack_us),
            flops_per_token=int(flops_per_token),
            weight_bytes=int(weight_bytes),
            kv_bytes_per_slot=int(kv_bytes_per_slot)))

    def decide_serve_shard(self, batch: int, *, tp: int,
                           flops_per_token: float, weight_bytes: float,
                           kv_bytes_per_slot: float = 0, n_layers: int = 1,
                           d_model: int = 1, dtype_bytes: int = 2,
                           candidates: Optional[Sequence[int]] = None,
                           record: bool = True,
                           devices: Optional[int] = None) -> Decision:
        """Shard-vs-replicate the serve model over ``tp`` model-axis chips.
        ``candidates=None`` sweeps {1, tp}; a forced override passes a
        single-element set (the restriction, not a lie, lands on the
        ledger).  ``devices``: the distinct devices the ``tp`` positions
        share (``_devices_param``)."""
        if candidates is None:
            candidates = (1, tp)
        return self.query(CostQuery.make(
            "serve_shard", (batch,), chips=tp, dtype_bytes=dtype_bytes,
            candidates=tuple(int(c) for c in candidates),
            flops_per_token=int(flops_per_token),
            weight_bytes=int(weight_bytes),
            kv_bytes_per_slot=int(kv_bytes_per_slot),
            n_layers=int(n_layers), d_model=int(d_model),
            **_devices_param(tp, devices)), record=record)

    def decide_serve_prefix(self, prompt_len: int, *, hit_tokens: int,
                            cow_blocks: int, chunk: int, block_size: int,
                            flops_per_token: float, weight_bytes: float,
                            kv_bytes_per_token: float = 0,
                            dtype_bytes: int = 2,
                            override: Optional[str] = None) -> Decision:
        """Use the radix prefix cache (suffix-only prefill) vs full prefill
        for one admitted prompt.  ``value`` is the hit length actually
        applied (0 for full_prefill).  ``override`` pins the verdict
        ('use_prefix' / 'full_prefill') — the sweep is still priced and
        ledgered, same idiom as the serve_shard override."""
        return self.query(CostQuery.make(
            "serve_prefix", (prompt_len,), dtype_bytes=dtype_bytes,
            hit_tokens=int(hit_tokens), cow_blocks=int(cow_blocks),
            chunk=int(chunk), block_size=int(block_size),
            flops_per_token=int(flops_per_token),
            weight_bytes=int(weight_bytes),
            kv_bytes_per_token=int(kv_bytes_per_token),
            override=override))

    def decide_serve_ipc_workers(self, n_requests: int, *, msg_bytes: float,
                                 validate_us: int = 0,
                                 candidates: Sequence[int] = (1, 2, 4),
                                 override: Optional[str] = None,
                                 record: bool = True) -> Decision:
        """Intake worker count for one serve run.  ``value`` is the worker
        count (0 = inline on the engine thread).  ``validate_us`` arrives
        pre-quantized (scheduler ``_quantize_us``) to bound the cache."""
        return self.query(CostQuery.make(
            "serve_ipc", (max(int(n_requests), 1),), op="workers",
            msg_bytes=int(msg_bytes), validate_us=int(validate_us),
            candidates=tuple(int(c) for c in candidates),
            override=override), record=record)

    def decide_serve_ipc_coalesce(self, n_streams: int, *, event_bytes: float,
                                  token_interval_us: int = 0,
                                  candidates: Sequence[int] = (1, 2, 4, 8, 16),
                                  record: bool = True) -> Decision:
        """Emission coalescing factor (token events per IPC message).
        ``value`` is the chosen burst size; ``token_interval_us`` is the
        predicted decode-step interval, pre-quantized."""
        return self.query(CostQuery.make(
            "serve_ipc", (max(int(n_streams), 1),), op="coalesce",
            event_bytes=int(event_bytes),
            token_interval_us=int(token_interval_us),
            candidates=tuple(int(c) for c in candidates)), record=record)

    # ------------------------------------------------------------------
    # Crossover solvers (delegate to the analytic model on this hw)
    # ------------------------------------------------------------------

    def matmul_crossover_order(self, chips: int, dtype_bytes: int = 2) -> int:
        return self.model.matmul_crossover_order(chips, dtype_bytes)

    def sort_crossover_n(self, chips: int) -> int:
        return self.model.sort_crossover_n(chips)

    def cache_stats(self) -> Dict[str, int]:
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "size": len(self._cache)}

    def drift_report(self, *, window: Optional[int] = None,
                     threshold: Optional[float] = None
                     ) -> Dict[str, Dict[str, Any]]:
        """Per-site calibration drift over each site's trailing window of
        measured rows (per-site window/threshold from the ledger's
        RuntimeConfig-fed knobs; explicit args override).  ``drifting``
        flags the RAW analytic ratio leaving [1/threshold, threshold] — the
        calibrated HardwareSpec no longer describes the running backend
        there; ``resolved`` reports whether the site's current correction
        factor absorbs it.  Drifting sites are what ``maybe_recalibrate``
        acts on; unresolved ones are what the bench gates fail on."""
        return self.ledger.drift(window=window, threshold=threshold,
                                 corrections=self.corrections)

    def assert_drift_resolved(self, *, min_rows: int = 5) -> None:
        """Bench/CI gate behind ``drift_report``: raise AssertionError if
        any site's RAW trailing ratio is out of band with at least
        ``min_rows`` measured rows AND the correction loop has not absorbed
        it — the calibrated model is wrong somewhere and nothing is
        compensating.  Machine-normalized by construction (ratios of
        same-run measurements)."""
        bad = {s: d for s, d in self.drift_report().items()
               if d["drifting"] and not d["resolved"] and d["n"] >= min_rows}
        if bad:
            lines = "; ".join(
                f"{s}: raw x{d['raw_ratio']:.2f} over {d['n']} rows "
                f"(correction x{d['correction']:.2f}, "
                f"band 1/{d['threshold']:.3g}..{d['threshold']:.3g})"
                for s, d in sorted(bad.items()))
            raise AssertionError(f"unresolved calibration drift: {lines}")

    # ------------------------------------------------------------------
    # Closed-loop calibration (DESIGN.md §10): corrections feedback,
    # targeted recalibration, chaos fault hooks, persistence
    # ------------------------------------------------------------------

    def _on_measurement(self, entry: LedgerEntry) -> None:
        """Ledger observer: fold one measured row into the site's
        correction, then act on the guardrail events — an invalidation
        drops the site's cached verdicts, and any event checkpoints the
        corrections into the fingerprint-keyed calibration cache."""
        if self.corrections is None:
            return
        raw = entry.raw_ratio
        if raw is None or raw <= 0:
            return
        events = self.corrections.update(entry.site, raw, entry.correction)
        if "invalidate" in events:
            self.invalidate_site(entry.site)
        if events:
            self.save_state()

    def invalidate_site(self, site: str) -> int:
        """Drop every cached Decision for one CostQuery site (the model
        that priced them has moved); returns how many were dropped."""
        stale = [q for q in self._cache if q.kind == site]
        for q in stale:
            del self._cache[q]
        self.cache_invalidations += 1
        return len(stale)

    def _swap_spec(self, spec: HardwareSpec) -> None:
        self.model = dataclasses.replace(self.model, hw=spec)
        self.hw = spec
        self._cache.clear()  # every cached verdict priced the old spec

    def perturb_hw(self, **fields) -> HardwareSpec:
        """Chaos fault hook: replace HardwareSpec fields in place (e.g.
        ``perturb_hw(host_sync_s=4 * engine.hw.host_sync_s)``), rebuilding
        the model and dropping the decision cache.  The perturbation is
        remembered so the chaos harness can assert recalibration healed
        exactly what it broke.  Test/benchmark surface — nothing in the
        serving path calls this."""
        self._swap_spec(dataclasses.replace(self.hw, **fields))
        self.perturbed_fields.update(fields)
        return self.hw

    def recalibrate_fields(self, fields: Sequence[str], *,
                           matmul_order: int = 1024) -> Dict[str, float]:
        """Targeted recalibration: re-run only the probes for ``fields``,
        replace the fields a probe produced a value for, drop the decision
        cache, reset corrections for every site those fields feed (the new
        spec now explains the measurements — a stale factor would
        double-correct), and persist the healed spec.  Returns the applied
        updates."""
        device = (self.calibration.device if self.calibration is not None
                  else "cuda")
        probes = run_probe_fields(fields, self.hw, matmul_order=matmul_order,
                                  device=device)
        updates = {k: float(v) for k, v in probes.items() if v is not None}
        if not updates:
            return updates
        self._swap_spec(dataclasses.replace(self.hw, **updates))
        self.recalibrated_fields.update(updates)
        for name in updates:
            self.perturbed_fields.pop(name, None)
        if self.corrections is not None:
            for site, flds in SITE_FIELDS.items():
                if set(flds) & set(updates):
                    self.corrections.reset_site(site)
        self.save_state(measurements=probes)
        return updates

    def maybe_recalibrate(self, *, min_rows: int = 5,
                          force: bool = False,
                          matmul_order: int = 1024) -> Dict[str, Any]:
        """Drift -> action: for every site whose RAW trailing ratio is out
        of band (``drift_report``) with at least ``min_rows`` measured
        rows, re-run that site's field probes (``hw.SITE_FIELDS``).  Each
        field re-probes at most once per session unless ``force`` — drift
        statistics lag the heal (old rows stay in the window), and probing
        in a loop would measure nothing new."""
        drift = self.drift_report()
        sites = [s for s, d in drift.items()
                 if d["drifting"] and d["n"] >= min_rows]
        fields: list = []
        for s in sites:
            for name in SITE_FIELDS.get(s, ()):
                if name not in fields and (
                        force or name not in self.recalibrated_fields):
                    fields.append(name)
        updates = (self.recalibrate_fields(fields, matmul_order=matmul_order)
                   if fields else {})
        return {"sites": sites, "probed": fields, "updates": updates}

    def save_state(self, *, measurements: Optional[dict] = None
                   ) -> Optional[Path]:
        """Persist the CURRENT spec + correction state into the same
        fingerprint-keyed cache entry ``calibrate()`` reads, so the next
        session inherits the healed state.  No-op (returns None) on an
        uncalibrated engine — there is no cache entry to own."""
        cal = self.calibration
        if cal is None or cal.path is None:
            return None
        meas = dict(cal.measurements)
        if measurements:
            meas.update({k: v for k, v in measurements.items()
                         if v is not None})
        save_calibration(
            cal.path, self.hw, fingerprint=cal.fingerprint,
            measurements=meas,
            corrections=(self.corrections.to_dict()
                         if self.corrections is not None else {}))
        self.calibration = dataclasses.replace(cal, spec=self.hw,
                                               measurements=meas)
        return cal.path


def _devices_param(chips: int, devices: Optional[int]) -> Dict[str, int]:
    """The query parameter that prices ``chips`` positions on fewer
    distinct devices (the port's ``shards_per_device``; the reference has
    no such option): ``{"devices": d}`` where ``d < chips``, else nothing,
    so that at one position a device the query, its verdict and its
    ledger row are the reference's."""
    if devices is None or int(devices) >= int(chips):
        return {}
    return {"devices": max(int(devices), 1)}


def resolve_engine(engine: Optional[CostEngine] = None,
                   model: Optional[OverheadModel] = None) -> CostEngine:
    """Injection helper for the decision sites: an explicit engine wins; an
    explicit OverheadModel gets an ephemeral engine (its decisions still
    ledger to that engine); else a fresh engine on the H100 data sheet.
    The port keeps no process-wide default: a ``repro_torch.Runtime``
    passes its own engine to everything it drives."""
    if engine is not None:
        return engine
    return CostEngine(model=model)
