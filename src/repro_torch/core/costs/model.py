"""The analytic overhead model — the paper's contribution made quantitative.

The CostEngine layers calibration, caching and the ledger on top of it
without the analytic core knowing about any of them.

The paper's overhead taxonomy maps to three roofline terms plus two fixed
overheads (DESIGN.md §2):

  compute     T_c  = FLOPs / (chips x peak)          — the useful work
  memory      T_m  = bytes / (chips x HBM bw)        — "repetitive common
                                                        computations" pressure
  collective  T_x  = comm_bytes / link bw            — "inter-core
                                                        communication overhead"
  launch      T_l  = per-dispatch latency            — "thread creation"
  sync        T_s  = per-collective base latency     — "synchronization"

Estimated execution time for a strategy is max(T_c, T_m) + T_x + fixed —
compute and memory overlap on the device; collectives only partially
overlap (we model the worst case).  The model is the reference package's,
transliterated unchanged; on Hopper the hardware terms come from
``repro_torch.hw`` (H100 data sheet, or a spec calibrated on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Literal, Optional

from repro_torch.hw import H100, HardwareSpec

Strategy = Literal["serial", "shard_m", "shard_n", "shard_k", "shard_mn"]

MATMUL_STRATEGIES = ("serial", "shard_m", "shard_n", "shard_k", "shard_mn")


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Per-strategy predicted seconds, the paper's Table-1 rows made numeric."""

    strategy: str
    compute: float
    memory: float
    collective: float
    fixed: float

    @property
    def total(self) -> float:
        return max(self.compute, self.memory) + self.collective + self.fixed

    def dominant(self) -> str:
        terms = {
            "compute": self.compute,
            "memory": self.memory,
            "collective": self.collective,
            "fixed": self.fixed,
        }
        return max(terms, key=terms.get)

    def scaled(self, factor: float) -> "CostBreakdown":
        """This breakdown with every term multiplied by ``factor`` — the
        CostEngine's per-site correction (corrections.py).  ``total`` is
        max(compute, memory) + collective + fixed, which is homogeneous of
        degree 1, so the scaled total is exactly factor x total and the
        dominant term is unchanged: a uniform correction re-scales a
        strategy's cost without re-shaping its regime."""
        if factor == 1.0:
            return self
        return CostBreakdown(self.strategy, self.compute * factor,
                             self.memory * factor, self.collective * factor,
                             self.fixed * factor)

    def as_dict(self) -> dict:
        return {
            "strategy": self.strategy,
            "compute_s": self.compute,
            "memory_s": self.memory,
            "collective_s": self.collective,
            "fixed_s": self.fixed,
            "total_s": self.total,
        }


def shared(chips: int, devices: int) -> int:
    """Positions on the busiest device when ``chips`` positions share
    ``devices`` devices."""
    return -(-int(chips) // max(int(devices), 1))


@dataclasses.dataclass(frozen=True)
class OverheadModel:
    hw: HardwareSpec = H100
    # efficiency derates (matmul-unit utilization on well-tiled matmuls, ring
    # efficiency)
    mxu_eff: float = 0.8
    mem_eff: float = 0.8
    ici_eff: float = 0.85

    # ------------------------------------------------------------------
    # Collectives (ring algorithms)
    # ------------------------------------------------------------------

    def collective_time(self, nbytes: float, chips: int, kind: str = "all_reduce",
                        devices: Optional[int] = None) -> float:
        """A ring collective of ``nbytes`` a position over ``chips``
        positions.  ``devices`` (the port's own argument; None: one device a
        position, the reference's model): the positions share that many
        devices, ``shared(chips, devices)`` on each.  Traffic between
        positions on one device is a copy through its HBM (read and
        written) plus a fence a position, not a transfer at the
        interconnect's rate; only the ring over the distinct devices pays
        the links."""
        if chips <= 1 or nbytes == 0:
            return 0.0
        frac = (chips - 1) / chips
        factor = {
            "all_reduce": 2.0 * frac,
            "all_gather": frac,
            "reduce_scatter": frac,
            "all_to_all": frac / 2,
            "broadcast": frac,
        }[kind]
        if devices is None or devices >= chips:
            bw = self.hw.ici_bw_per_link * self.hw.ici_links / 2 * self.ici_eff
            return factor * nbytes / bw + self.hw.collective_base_s
        per = shared(chips, devices)
        copy = 2.0 * per * factor * nbytes / (self.hw.hbm_bw * self.mem_eff)
        return (copy + per * self.hw.kernel_launch_s
                + self.collective_time(per * nbytes, devices, kind))

    # ------------------------------------------------------------------
    # Matmul (the paper's Matrix Multiplication domain)
    # ------------------------------------------------------------------

    def matmul_cost(
        self,
        m: int,
        n: int,
        k: int,
        *,
        chips: int = 1,
        strategy: Strategy = "serial",
        dtype_bytes: int = 2,
        flops_per_mac: int = 2,
        io_at_master: bool = False,
        devices: Optional[int] = None,
    ) -> CostBreakdown:
        """Predicted cost of C[m,n] = A[m,k] @ B[k,n] under a strategy.

        serial   — one chip does everything (paper: single-core execution)
        shard_m  — rows of A over chips; no collective (master-slave row sets)
        shard_n  — cols of B over chips; all-gather of C if replication needed
        shard_k  — inner dim over chips; all-reduce of C (synchronization at
                   inter-product additions — the paper's matmul overhead)
        shard_mn — 2D block; all-gather of A rows + B cols inside the grid

        ``io_at_master=True`` models the paper's standalone setting: the
        inputs start on ONE core (master) and the result must end there, so
        a parallel strategy additionally pays input scatter/broadcast and
        output gather (the paper's "input management" overhead row).  Inside
        a model, weights/activations are already distributed -> False.

        ``devices`` (the port's own): the ``chips`` positions share that
        many devices, so the compute and the local bytes divide by
        ``split = min(devices, chips)``, the work the devices do; the
        collectives and the input management keep the position count,
        priced as copies within a device (``collective_time``); each device
        pays a launch a position on it.  ``devices=1`` prices every strategy
        at the serial one's compute and memory plus its collective and
        launches, so serial wins.
        """
        flops = flops_per_mac * m * n * k
        bytes_total = dtype_bytes * (m * k + k * n + m * n)
        peak = self.hw.peak_flops_bf16 if dtype_bytes == 2 else self.hw.peak_flops_f32
        eff_peak = peak * self.mxu_eff
        eff_bw = self.hw.hbm_bw * self.mem_eff

        if strategy == "serial" or chips == 1:
            return CostBreakdown(
                "serial", flops / eff_peak, bytes_total / eff_bw, 0.0,
                self.hw.kernel_launch_s,
            )
        c = chips
        split = c if devices is None else min(devices, c)
        if strategy == "shard_m":
            comm = 0.0
            comm_kind = "all_gather"
            local_bytes = dtype_bytes * (m * k / split + k * n + m * n / split)
        elif strategy == "shard_n":
            comm = dtype_bytes * m * n
            comm_kind = "all_gather"
            local_bytes = dtype_bytes * (m * k + k * n / split + m * n / split)
        elif strategy == "shard_k":
            comm = dtype_bytes * m * n
            comm_kind = "all_reduce"
            local_bytes = dtype_bytes * (m * k / split + k * n / split + m * n)
        elif strategy == "shard_mn":
            r, rs = int(math.sqrt(c)), int(math.sqrt(split))
            comm = dtype_bytes * (m * k / r + k * n / r)
            comm_kind = "all_gather"
            local_bytes = dtype_bytes * (m * k / rs + k * n / rs
                                         + m * n / split)
        else:
            raise ValueError(strategy)
        io = 0.0
        if io_at_master:
            # paper Table 1 "input management": scatter inputs from the
            # master, gather the result back (ring costs)
            io = (self.collective_time(dtype_bytes * (m * k + k * n), c,
                                       "broadcast", devices)
                  + self.collective_time(dtype_bytes * m * n, c,
                                         "all_gather", devices))
        return CostBreakdown(
            strategy,
            flops / split / eff_peak,
            local_bytes / eff_bw,
            self.collective_time(comm, c, comm_kind, devices) + io,
            shared(c, split) * self.hw.kernel_launch_s,
        )

    def best_matmul(self, m: int, n: int, k: int, *, chips: int,
                    dtype_bytes: int = 2, io_at_master: bool = False) -> CostBreakdown:
        cands = [
            self.matmul_cost(m, n, k, chips=chips, strategy=s, dtype_bytes=dtype_bytes,
                             io_at_master=io_at_master)
            for s in MATMUL_STRATEGIES
        ]
        return min(cands, key=lambda cb: cb.total)

    def matmul_crossover_order(self, chips: int, dtype_bytes: int = 2) -> int:
        """Smallest square order where ANY parallel strategy beats serial in
        the paper's standalone setting (inputs at the master) — the paper's
        'minimum 1000 and above' claim, re-derived for this hardware."""
        lo, hi = 1, 1 << 20
        def parallel_wins(n: int) -> bool:
            serial = self.matmul_cost(n, n, n, strategy="serial", dtype_bytes=dtype_bytes)
            best = self.best_matmul(n, n, n, chips=chips, dtype_bytes=dtype_bytes,
                                    io_at_master=True)
            return best.strategy != "serial" and best.total < serial.total
        while lo < hi:
            mid = (lo + hi) // 2
            if parallel_wins(mid):
                hi = mid
            else:
                lo = mid + 1
        return lo

    # ------------------------------------------------------------------
    # Sorting (the paper's quicksort domain)
    # ------------------------------------------------------------------

    def sort_cost(self, n: int, *, chips: int = 1, dtype_bytes: int = 4,
                  strategy: str = "serial",
                  devices: Optional[int] = None) -> CostBreakdown:
        """serial: one-chip bitonic network O(n log^2 n) VPU compare-exchange.
        parallel: sample sort = local sort + splitter broadcast + all-to-all
        + local merge (paper: pivot placement by master, then independent
        recursion per core).  ``devices`` (the port's own): the positions
        share that many devices, which do the local sorts and merges of
        ``n / min(devices, chips)`` elements each; the exchanges keep the
        position count, priced as copies within a device; each device pays
        the launches of every position on it."""
        log2n = max(math.log2(max(n, 2)), 1.0)
        vpu_ops_per_s = self.hw.peak_flops_f32  # compare-exchange ~ 1 vector op
        if strategy == "serial" or chips == 1:
            ops = n * log2n * (log2n + 1) / 2
            return CostBreakdown(
                "serial", ops / vpu_ops_per_s,
                dtype_bytes * n * log2n / (self.hw.hbm_bw * self.mem_eff),
                0.0, self.hw.kernel_launch_s,
            )
        split = chips if devices is None else min(devices, chips)
        nl = n / chips
        nd = n / split  # the elements each device sorts and merges
        log2nd = max(math.log2(max(nd, 2)), 1.0)
        local_ops = 2 * nd * log2nd * (log2nd + 1) / 2  # sort + merge after exchange
        exchange = self.collective_time(dtype_bytes * nl, chips, "all_to_all",
                                        devices)
        splitters = self.collective_time(dtype_bytes * chips, chips,
                                         "all_gather", devices)
        return CostBreakdown(
            "sample_sort", local_ops / vpu_ops_per_s,
            dtype_bytes * nd * log2nd / (self.hw.hbm_bw * self.mem_eff),
            exchange + splitters,
            self.hw.kernel_launch_s * 3 * shared(chips, split),
        )

    def sort_crossover_n(self, chips: int) -> int:
        lo, hi = 1, 1 << 34
        def parallel_wins(n: int) -> bool:
            return (self.sort_cost(n, chips=chips, strategy="parallel").total
                    < self.sort_cost(n, strategy="serial").total)
        while lo < hi:
            mid = (lo + hi) // 2
            if parallel_wins(mid):
                hi = mid
            else:
                lo = mid + 1
        return lo

    # ------------------------------------------------------------------
    # Sequential-recurrence chunking (WKV / RG-LRU fork-join)
    # ------------------------------------------------------------------

    def scan_chunk_cost(self, seq: int, chunk: int, *, batch: int, heads: int,
                        head_dim: int, dtype_bytes: int = 4) -> float:
        """Chunked linear-recurrence cost: n_chunks serial steps, each with an
        (L,L,N) pairwise intra-chunk tensor + state update matmuls."""
        n_chunks = math.ceil(seq / chunk)
        intra_flops = 2 * batch * heads * chunk * chunk * head_dim * 2
        state_flops = 2 * batch * heads * chunk * head_dim * head_dim * 2
        per_chunk = (intra_flops + state_flops) / (self.hw.peak_flops_f32 * self.mxu_eff)
        pairwise_bytes = batch * heads * chunk * chunk * head_dim * dtype_bytes
        per_chunk = max(per_chunk, pairwise_bytes / (self.hw.hbm_bw * self.mem_eff))
        return n_chunks * (per_chunk + self.hw.kernel_launch_s)

    def best_scan_chunk(self, seq: int, *, batch: int, heads: int, head_dim: int,
                        candidates=(16, 32, 64, 128, 256)) -> int:
        return min(
            (c for c in candidates if c <= max(seq, 16)),
            key=lambda c: self.scan_chunk_cost(seq, c, batch=batch, heads=heads,
                                               head_dim=head_dim),
        )

    # ------------------------------------------------------------------
    # Serving (continuous batching: decode occupancy + prefill chunking)
    # ------------------------------------------------------------------

    def serve_decode_step_cost(self, batch: int, *, flops_per_token: float,
                               weight_bytes: float, kv_bytes_per_slot: float = 0,
                               dtype_bytes: int = 2) -> CostBreakdown:
        """One batched greedy decode step at occupancy ``batch``.

        Compute scales with occupancy; the weight stream does NOT — every
        step reads all active parameters once regardless of batch, which is
        exactly why continuous batching pays: per-token cost falls as
        ``weight_bytes / (batch * bw)``.  Per-slot decode state (KV cache)
        re-reads do scale with occupancy."""
        peak = (self.hw.peak_flops_bf16 if dtype_bytes == 2
                else self.hw.peak_flops_f32)
        compute = max(batch, 1) * flops_per_token / (peak * self.mxu_eff)
        memory = (weight_bytes + max(batch, 1) * kv_bytes_per_slot) / (
            self.hw.hbm_bw * self.mem_eff)
        return CostBreakdown(f"decode_b{batch}", compute, memory, 0.0,
                             self.hw.kernel_launch_s)

    def serve_macro_cost(self, horizon: int, remaining, *,
                         flops_per_token: float, weight_bytes: float,
                         kv_bytes_per_slot: float = 0,
                         dtype_bytes: int = 2) -> CostBreakdown:
        """Per-useful-token cost of one K-token decode macro-step.

        A macro-step runs ``horizon`` lockstep decode steps inside ONE
        device program, then pays ONE host round trip (``hw.host_sync_s``)
        for scheduler bookkeeping.  ``remaining`` is the per-slot remaining
        token budget of the active slots: a slot that finishes (EOS or
        budget) after ``r < K`` steps rides the remaining ``K - r`` steps
        masked — wasted lockstep work the horizon sweep must charge for.
        Useful tokens = sum(min(K, r)); every cost term is normalized by it,
        so large K amortizes the sync until finish raggedness erodes it —
        the serve-path instance of the paper's sync-overhead-vs-parallelism
        tradeoff.
        """
        k = max(int(horizon), 1)
        batch = max(len(remaining), 1)
        useful = sum(min(k, max(int(r), 0)) for r in remaining)
        useful = max(useful, 1)
        step = self.serve_decode_step_cost(
            batch, flops_per_token=flops_per_token, weight_bytes=weight_bytes,
            kv_bytes_per_slot=kv_bytes_per_slot, dtype_bytes=dtype_bytes)
        return CostBreakdown(
            f"K_{k}",
            k * step.compute / useful,
            k * step.memory / useful,
            0.0,
            (k * step.fixed + self.hw.host_sync_s) / useful,
        )

    def serve_shard_cost(self, batch: int, *, tp: int, flops_per_token: float,
                         weight_bytes: float, kv_bytes_per_slot: float = 0,
                         n_layers: int = 1, d_model: int = 1,
                         dtype_bytes: int = 2,
                         devices: Optional[int] = None) -> CostBreakdown:
        """One batched decode step with the serve model TENSOR-SHARDED over
        ``tp`` chips of the model axis (tp=1 degenerates to the replicated
        ``serve_decode_step_cost``).

        Sharding divides the per-device FLOPs and — the real win at decode
        batch sizes, where every step is weight-stream-bound — the per-device
        weight and KV-cache bytes by ``tp``.  The price is communication:
        each layer's row-parallel output projections (attention wo + FFN
        w_out) end in an all-reduce of the (batch, d_model) residual
        partial-sums, so a decode step pays ``2 * n_layers`` all-reduces of
        ``batch * d_model * dtype_bytes`` bytes at the calibrated
        interconnect bandwidth plus ``collective_base_s`` latency each —
        the paper's inter-core communication + synchronization terms, which
        dominate for small models and make replicate the right verdict below
        the crossover.

        ``devices`` (the port's own): the ``tp`` positions share that many
        devices, so the FLOPs and bytes divide by ``devices``, not ``tp``;
        the all-reduces keep ``tp`` positions, priced as copies within a
        device, and each position pays its launch.  On one device the
        sharded step costs the replicated one plus its collectives."""
        if tp <= 1:
            return self.serve_decode_step_cost(
                batch, flops_per_token=flops_per_token,
                weight_bytes=weight_bytes, kv_bytes_per_slot=kv_bytes_per_slot,
                dtype_bytes=dtype_bytes)
        peak = (self.hw.peak_flops_bf16 if dtype_bytes == 2
                else self.hw.peak_flops_f32)
        b = max(batch, 1)
        split = tp if devices is None else min(devices, tp)
        compute = b * flops_per_token / (split * peak * self.mxu_eff)
        memory = (weight_bytes + b * kv_bytes_per_slot) / (
            split * self.hw.hbm_bw * self.mem_eff)
        per_layer = self.collective_time(
            b * d_model * dtype_bytes, tp, "all_reduce", devices)
        return CostBreakdown(f"tp_{tp}", compute, memory,
                             2 * max(n_layers, 1) * per_layer,
                             shared(tp, split) * self.hw.kernel_launch_s)

    def serve_admit_cost(self, active: int, *, prompt_len: int,
                         new_tokens: int, flops_per_token: float,
                         weight_bytes: float, kv_bytes_per_slot: float = 0,
                         dtype_bytes: int = 2) -> CostBreakdown:
        """Expected residual service time if this request is admitted NOW:
        one full prefill of its prompt plus ``new_tokens`` decode steps at
        the post-admission occupancy (``active + 1`` slots), amortized to
        this request's share of each batched step.

        This is the serve_admit term: admission control compares it against
        the request's remaining deadline slack and sheds work that cannot
        finish in time — spending the prefill + decode cost anyway would be
        pure overhead (the paper's thesis applied to load shedding)."""
        total_prefill, _ = self.serve_prefill_cost(
            prompt_len, prompt_len, flops_per_token=flops_per_token,
            weight_bytes=weight_bytes, dtype_bytes=dtype_bytes)
        occupancy = max(active, 0) + 1
        step = self.serve_decode_step_cost(
            occupancy, flops_per_token=flops_per_token,
            weight_bytes=weight_bytes, kv_bytes_per_slot=kv_bytes_per_slot,
            dtype_bytes=dtype_bytes)
        n = max(new_tokens, 1)
        return CostBreakdown(
            f"admit_b{occupancy}",
            total_prefill + n * step.compute,
            n * step.memory,
            0.0,
            n * step.fixed,
        )

    def serve_prefill_cost(self, prompt_len: int, chunk: int, *,
                           flops_per_token: float, weight_bytes: float,
                           dtype_bytes: int = 2):
        """Chunked prefill of one prompt: (total_s, per_chunk_s).

        Each chunk pays one weight stream and one launch, so tiny chunks
        (the per-token replay loop, chunk=1) re-stream the weights
        ``prompt_len`` times; one huge chunk is compute-optimal but holds
        the device for ``per_chunk_s``, stalling every concurrently
        decoding slot — the admission/chunking granularity tradeoff the
        scheduler resolves per decision."""
        peak = (self.hw.peak_flops_bf16 if dtype_bytes == 2
                else self.hw.peak_flops_f32)
        n_chunks = math.ceil(prompt_len / max(chunk, 1))
        compute = chunk * flops_per_token / (peak * self.mxu_eff)
        memory = weight_bytes / (self.hw.hbm_bw * self.mem_eff)
        per_chunk = max(compute, memory) + self.hw.kernel_launch_s
        return n_chunks * per_chunk, per_chunk

    def serve_prefix_cost(self, prompt_len: int, hit_tokens: int, chunk: int,
                          *, flops_per_token: float, weight_bytes: float,
                          block_size: int, cow_blocks: int = 0,
                          kv_bytes_per_token: float = 0.0,
                          dtype_bytes: int = 2) -> CostBreakdown:
        """Admission with ``hit_tokens`` of the prompt served from the
        radix prefix cache: prefill only the suffix, plus the host-side
        trie lookup/pin walk and any copy-on-write block duplication.

        The serve_prefix site compares this against the full-prefill
        baseline (``hit_tokens=0``): reuse wins whenever the skipped
        prefill compute exceeds the lookup + CoW overhead — the paper's
        redundant-work class, priced explicitly."""
        suffix = max(prompt_len - hit_tokens, 1)
        total, _ = self.serve_prefill_cost(
            suffix, chunk, flops_per_token=flops_per_token,
            weight_bytes=weight_bytes, dtype_bytes=dtype_bytes)
        # CoW: duplicate `cow_blocks` pages (read + write one block of KV)
        cow_bytes = 2 * cow_blocks * block_size * kv_bytes_per_token
        cow_s = cow_bytes / (self.hw.hbm_bw * self.mem_eff)
        if cow_blocks:
            cow_s += self.hw.kernel_launch_s  # one copy dispatch
        lookup_s = (hit_tokens / max(block_size, 1) + 1) * \
            self.hw.prefix_lookup_s
        # suffix prefill, CoW copy, and the host trie walk are sequential:
        # compute holds the prefill, fixed the serialized overheads, so
        # CostBreakdown.total = prefill + cow + lookup
        return CostBreakdown(
            f"prefix_h{hit_tokens}", total, 0.0, 0.0, cow_s + lookup_s)

    def serve_ipc_workers_cost(self, n_requests: int, workers: int, *,
                               msg_bytes: float,
                               validate_s: float = 0.0) -> CostBreakdown:
        """Intake cost of routing ``n_requests`` submissions through
        ``workers`` pinned worker processes (the serve_ipc site, worker-
        count op).

        The parent and the workers run CONCURRENTLY, so the breakdown
        reuses the compute/memory overlap semantics: ``compute`` holds the
        parent's serial share (it serializes every submission and verdict
        and pays half the queue round trip each), ``memory`` holds the
        slowest worker's share (deserialize + validate + reply for its
        ``ceil(R/w)`` requests), and ``total = max(parent, worker)`` is the
        pipeline bottleneck.  ``fixed`` charges one round trip per worker
        for queue management — the term that stops "more workers" from
        being free (the paper's thread-creation overhead, process-grade).

        With one worker this degenerates to the serialized front end; the
        in-process baseline (workers=0 at the call site) is simply
        ``n_requests * validate_s`` on the engine thread, which the
        scheduler prices as the site's baseline.
        """
        r = max(int(n_requests), 1)
        w = max(int(workers), 1)
        rt = self.hw.ipc_round_trip_s
        bw = self.hw.ipc_bytes_per_s
        per_msg = 2.0 * msg_bytes / bw  # submission out + verdict back
        parent = r * (rt / 2 + per_msg)
        worker = math.ceil(r / w) * (rt / 2 + per_msg + validate_s)
        return CostBreakdown(f"ipc_w{w}", parent, worker, 0.0, w * rt)

    def serve_ipc_coalesce_cost(self, coalesce: int, *,
                                event_bytes: float,
                                header_bytes: float = 64.0,
                                token_interval_s: float = 0.0
                                ) -> CostBreakdown:
        """Per-streamed-token cost of emitting token events to the emission
        worker in bursts of ``coalesce`` events per IPC message (the
        serve_ipc site, coalescing op).

        Amortized transport (``compute``): one queue round trip plus the
        serialized header is shared by the whole burst, so bigger bursts
        cost less per token.  Staleness (``fixed``): a token waits on
        average ``(c - 1) / 2`` further tokens before its burst flushes, at
        ``token_interval_s`` (the predicted decode-step interval) each —
        the latency side of the batching tradeoff, same shape as the
        macro-horizon site's raggedness term.  ``coalesce=1`` is the
        immediate-flush baseline.
        """
        c = max(int(coalesce), 1)
        rt = self.hw.ipc_round_trip_s
        bw = self.hw.ipc_bytes_per_s
        transport = (rt + (header_bytes + c * event_bytes) / bw) / c
        staleness = (c - 1) / 2.0 * max(token_interval_s, 0.0)
        return CostBreakdown(f"ipc_c{c}", transport, 0.0, 0.0, staleness)

    # ------------------------------------------------------------------
    # MoE dispatch strategy (EP overhead management)
    # ------------------------------------------------------------------

    def moe_dispatch_cost(self, tokens_local: int, d: int, *, top_k: int,
                          ep_shards: int, dtype_bytes: int = 2,
                          devices: Optional[int] = None
                          ) -> Dict[str, float]:
        """Compare replication-EP (psum of outputs over the model axis) vs
        all-to-all EP (route tokens to expert owners and back).
        ``devices`` (the port's own): the EP positions share that many
        devices, and their collectives are priced as copies within one."""
        psum = self.collective_time(tokens_local * d * dtype_bytes, ep_shards,
                                    "all_reduce", devices)
        a2a = 2 * self.collective_time(
            tokens_local * top_k * d * dtype_bytes, ep_shards, "all_to_all",
            devices)
        return {"replicated_psum": psum, "all_to_all": a2a}
