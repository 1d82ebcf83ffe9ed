"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one report line each (any failure exits non-zero):
  1. card + build: the card's name and power limit, torch/CUDA versions,
     and the build of every kernel from csrc/ (seconds), with matmul.cu's
     and flash_attention.cu's registers, spills and serialized-wgmma
     notices by path (ptxas -v); any spill or such notice in a flash
     tensor-core kernel, or any spill in a sort kernel, fails the run;
     wkv.cu's registers and spills by kernel (ptxas -v) and, for the
     training instantiations, threads, shared memory, registers, local
     bytes and CTAs an SM as the runtime reports them, written to
     chiprun_out/wkv_build.json; any spill in a WKV kernel fails the run;
  2. each kernel against its plain PyTorch version at the shapes the main
     path gives it (tinyllama-1.1b serving, bf16), with the matmul path it
     took, timed with CUDA events with a cold L2 beside the plain version,
     one PyTorch library call and the card's bound; then the
     batch-invariance gate: on every matmul path, row i of a product of M
     rows equals that row multiplied alone, bit for bit;
  3. the paper's matmul domain: adaptive_matmul(use_kernel=True) at orders
     1024, 4096 and 8192 (path and TFLOP/s), with the CostEngine's
     decision; matmul_chain in fp32 against a left-to-right torch.matmul
     product;
  4. the paper's sort domain: the bitonic sort kernel, its plain version
     and torch.sort, exactly equal, at the paper's Table 3 sizes, the
     bench's, 2^26 fp32, 2^24 int32, (4096, 4096) and (8, 100), each timed
     beside its bound and its schedule's bound (passes x one read and one
     write), and one 2^26 call's device time, launches and HBM rate by
     launch kind (torch.profiler); the kernel bit for bit its plain
     version on hard inputs (NaN, +-inf, -0.0 beside +0.0, int32 extremes,
     sorted and reversed rows) across the tile boundary, one launch a
     pass; then distributed_sort(local_sort="kernel",
     measure=True) at n = 2000 and 2^26 (the sort's main path, its launch
     count read), with the ledger's predicted and measured rows;
  5. serving: Runtime(device="cuda").serve of full-width tinyllama-1.1b
     (random weights, seed 0), static and continuous, token identity, the
     kernel's launch count (by path), tok/s, host syncs per token, ledger
     rows; one decode step's matmul calls, each checked to run the path
     its dtypes name, profiled (matmul device ms by path, no library GEMM
     kernel), captured and replayed through the kernel,
     through the plain version and, where one torch.matmul computes the
     call, through it (held against each other, timed with
     torch.profiler), and one calibration of the hardware spec;
  6. card against CPU in fp32: one batched prefill + 4 decode steps;
  7. flash: the flash-attention kernels, forward and backward, against
     their plain versions (and the forward against flash_attention_ref;
     bf16 outputs held against their own row's magnitude; kernel forward
     then kernel backward against the plain chain)
     at the training shape (2, 2048, 32, 4, 64) in bf16 and fp32, an
     awkward (3, 100, 8, 2, 64) in fp32, mistral-nemo's heads (32 / 8, hd
     128) in bf16 and a ragged MQA (3, 100, 8, 1, 64) in bf16; each call on
     the path its dtype and hd name (bf16: the wgmma kernels, no operand
     copied), the bf16 backward bit-identical on a second run, each timed
     (CUDA events, cold L2) beside the plain version,
     scaled_dot_product_attention and the bound;
  8. train-parity: one make_train_step of full-width tinyllama-1.1b cut to
     2 layers, fp32, batch 2 x 256, on the card and on the CPU from the
     same parameters and batch: the loss within 1e-4 relative, every
     parameter's gradient present and within 2e-3 x max|grad| leaf by leaf;
  9. train: every distinct matmul call (shapes, strides, dtypes,
     epilogue) of one full-width bf16 gradient at batch 2 x 2048, cut to
     1 layer, held against the plain version on its own operands (the
     backward's transposed reads and bf16 x fp32 products among them),
     its path checked and timed beside torch.matmul (bf16 x bf16 only, a
     yardstick);
     Runtime(device="cuda")
     .train of full-width tinyllama-1.1b (22 layers, bf16, random
     weights, seed 0) for 4 steps at batch 2 x 2048 with a checkpoint,
     every loss finite, the kernels' launches per step (every flash call
     on the tensor-core path, no operand copied), tokens/s, peak memory,
     the plan; a 4-step run on one fixed batch whose loss must fall, with
     one step profiled (device busy share, device ms by kernel, matmul
     path and flash kernel, no library GEMM or attention kernel);
 10. wkv: the WKV kernels, forward and backward (every gradient), against
     their plain versions (with the kernels' sub-chunk factorization) at
     rwkv6-3b's training shape (2, 2048, 40, 64) with bf16 r/k/v and fp32
     logw made as the time mix makes them, the same shape in fp32, an
     awkward (3, 100, 5, 64) in fp32, that shape at logw = -50 and at heavy
     mixed decays (every output finite); the backward called twice with
     the same bits, the CUDA launches of each call by kernel; each timed
     (CUDA events, cold L2) beside the plain version and the bound, and at
     the bf16 training shape one forward and one backward profiled by
     kernel (state pass against the per-chunk kernel);
 11. rwkv card against CPU in fp32 (2 layers, full width): prefill logits
     (the WKV kernel) and token-by-token decode_step logits;
 12. rwkv serving: Runtime.serve of full-width, full-depth rwkv6-3b in bf16
     (random weights, seed 0), static and continuous, token identity,
     tok/s, host syncs per token, the matmul kernel's launches by path,
     one decode step's routing checked and profiled by path;
 13. rwkv train-parity: one make_train_step of full-width rwkv6-3b cut to
     2 layers, fp32, batch 2 x 256, card against CPU: the loss within 1e-4
     relative, all 47 gradients present and within 2e-3 x max|grad|;
 14. rwkv train: Runtime.train of full-width, full-depth rwkv6-3b in bf16
     for 4 steps at batch 2 x 2048 (no checkpoint): every loss finite, the
     WKV kernels' calls per step (64 forward with the recomputation, 32
     backward; two CUDA launches each), step wall, tokens/s, peak memory,
     and one profiled step (device busy share, device ms by kernel, matmul
     path and WKV kernel, every call's routing checked, no library GEMM
     kernel);
 15. paged serving: Runtime.serve of full-width tinyllama-1.1b (bf16,
     seed 0) with paged=True, pages of 16 tokens: P1, phase 5's trace
     with K and the prefill chunk pinned, paged (default kv_blocks) beside
     dense and streamed: tokens equal phase 5's, host syncs equal the
     dense run's and the counts the engine made before it had the
     request lifecycle (10 host syncs, 54-55 synchronizing CUDA calls), the stream carries the outputs, the matmul kernel's
     launches counted from 0; the odd row, phase 5's trace at a max_len of
     101 (not a multiple of the page: 7 pages gather 112 positions),
     static, dense and paged token-identical; P2, 16 requests of 320 + 32
     tokens sharing a 264-token prefix, static, dense, paged with
     prefix_cache="force"
     and "auto": token-identical, the forced run prefilling at most half
     the dense run's 5,120 prompt tokens, the serve_prefix ledger rows;
     a trie dedupe swap's pages bit for bit the pages they replace; one
     paged and one dense decode step profiled (matmul against the
     indexing kernels, launches); rwkv6-3b (full width, 4 layers) paged
     == dense == static with prefix reuse off; examples/torch_quickstart.py
     on the card;
 16. the request lifecycle: full-width tinyllama-1.1b (bf16, seed 0, 4
     slots, phase 5's trace and max_len), dense and paged (pages of 16),
     on a virtual clock that advances per read: phase 5's serve again with
     its tokens and host syncs, no thread started and no serve_admit
     query; priority preemption (a late priority-5 request evicts one of
     four; every token, the victim's too, equal to phase 5's; paged: pages
     back to the trie's pins, the prefix re-pinned); deadlines (expiry
     while queued, TIMED_OUT while decoding with the slot freed,
     queue_full, deadline_infeasible with a serve_admit row); the fault
     classes (raise and stall under a 1 s watchdog retried to phase 5's
     tokens, raise at the prefill site, nan failing exactly the poisoned
     request, exhausted retries failing what is in flight, a fatal fault
     propagating with the paged BlockPool empty), each followed by phase
     5's trace on the same engine with equal tokens; the guarded step on
     a worker thread with the direct step's matmul launches by path, the
     caller's stream and no autograd graph; a step abandoned by the
     watchdog that later writes into the pools it captured, which the
     drained pool's new tensors escape; a stop mid-run; the launcher
     (python -m repro_torch.launch.serve ... --inject-fault raise) exits
     0; recorded, not gated: overload on the real clock (Poisson arrivals
     at 2x the unloaded service rate, a queue of 8, deadlines at 8x the
     unloaded latency), serve_admit with and without the correction loop
     on a calibrated runtime, rwkv6-3b (4 layers) raise (gated) and
     preemption drills; the serve, serve_macro and serve_admit ledger
     rows go to the JSON record;
 17. the multi-process front end: full-width tinyllama-1.1b (bf16, seed
     0, 4 slots, phase 5's trace and max_len) through Runtime(device=
     "cuda").serve(..., frontend=2, pin=True, stream=True), dense and
     paged (pages of 16): tokens equal phase 5's, texts the engine's
     tokens detokenized, the stream the outputs, host syncs phase 5's and
     (dense) the synchronizing CUDA calls of the same trace served in
     process and streamed, measured serve_ipc rows for both ops, the
     matmul kernel's launches counted from 0; the reference chaos bench's
     respawn drill (intake workers killed and healed, the emission worker
     killed and its transcript replayed) with nvidia-smi listing no
     worker among the processes holding a context on the card; with
     respawn=0 a killed emission worker fails what is in flight
     ("frontend stream broken"), then the same engine serves phase 5's
     trace again through an unpinned front end; the launcher (python -m
     repro_torch.launch.serve ... --workers 2 --pin --stream) exits 0;
     every worker joined at the end; recorded, not gated: the host's
     layout, the affinity plan, the card's PCI bus id and NUMA node,
     engine and workers pinned, spawn-to-first-pong and respawn seconds,
     IPC messages and bytes, phase 5's calibrated IPC constants,
     frontend="auto"'s verdict against the measured intake, tok/s in
     process, unpinned and pinned, and phase 16's overload recipe through
     the front end.  The calling thread's CPU mask is restored after it.
     Before each of phases 2-17, gc.collect(): a gen-2 collection of this
     script's heap took 0.2-0.75 s inside a timed step.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  The full record goes to
chiprun_out/chip_smoke.json.  Exits non-zero, printing no result, where
torch.cuda.is_available() is false or the repository is missing.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BF16_PEAK = 989e12   # H100 SXM data sheet, dense bf16 tensor cores
F32_PEAK = 67e12     # H100 SXM data sheet, fp32 outside the tensor cores
HBM_BW = 3.35e12     # H100 SXM data sheet, bytes/s
BF16_TOL = 8e-3      # x max|plain|: about one bf16 rounding
F32_TOL = 1e-5       # x max|plain|
CHAIN_TOL = 1e-4     # x max|left-to-right product|: fp32, another order
PROMPT, MAX_NEW, SLOTS, REQUESTS = 64, 32, 4, 8
# phase 15: pages of 16 tokens; P2 is system-prompt traffic, 16 requests of
# 320 prompt tokens opening with one 264-token prefix (16.5 pages, so a
# partial tail page is copied on write); P1 pins the horizon K and the
# prefill chunk, so its host syncs compare with the dense run's
PAGE = 16
P2_REQUESTS, P2_PROMPT, P2_PREFIX = 16, 320, 264
PIN = dict(macro_step=8, prefill_chunk=PROMPT)
# phase 15's odd row: a max_len that is not a multiple of the page, so a
# slot's gathered pages (7 x 16 = 112 positions) are longer than its row
ODD_MAX_LEN = PROMPT + MAX_NEW + 5
# the unperturbed counts measured before the engine had the request
# lifecycle, held again with it: phase 5's continuous host syncs,
# P1's host syncs and its synchronizing CUDA calls (torch's sync debug
# mode; 54 or 55 from run to run)
BASE_PHASE5_SYNCS, BASE_P1_SYNCS, BASE_P1_CUDA_SYNCS = 12, 10, (54, 55)
# phase 16 (the request lifecycle): the drills' trace is phase 5's first
# DRILL_REQUESTS requests with DRILL_NEW new tokens (eos -1: the tokens
# are the first DRILL_NEW of phase 5's); overload follows the reference's
# stress bench (benchmarks/stress_bench.py): Poisson arrivals at
# OVERLOAD_FACTOR x the unloaded service rate, a queue of 2 x slots,
# deadlines at DEADLINE_X x the unloaded mean latency
DRILL_REQUESTS, DRILL_NEW = 4, 16
STALL_WATCHDOG_S = 1.0
OVERLOAD_REQUESTS, OVERLOAD_FACTOR, DEADLINE_X = 16, 2.0, 8.0
# phase 17 (the multi-process front end): intake worker processes (the
# emission worker comes with them)
FE_WORKERS = 2
# the indexing kernels of a decode step: a paged step's page gathers and KV
# scatter, a dense step's cache write; the embedding lookup in both
INDEX_KERNELS = r"index|gather|scatter"
# (B, S, Hq, Hkv, hd, dtype) the flash kernels are held at: the training
# shape of tinyllama-1.1b at batch 2 x 2048 in both types, an awkward one
# (S not a multiple of the block, a GQA group of 4), mistral-nemo's heads
# (32 query, 8 kv, hd 128: the tensor-core path's other head dim) and a
# ragged MQA one on the tensor-core path
FLASH_SHAPES = [(2, 2048, 32, 4, 64, "bfloat16"),
                (2, 2048, 32, 4, 64, "float32"),
                (3, 100, 8, 2, 64, "float32"),
                (2, 1024, 32, 8, 128, "bfloat16"),
                (3, 100, 8, 1, 64, "bfloat16")]
FLASH_F32_TOL = 2e-3  # x max|plain|: tests/test_kernels.py's flash tolerance
# bf16 flash outputs, element by element: BF16_TOL x the largest |plain| in
# the element's row (the last axis), one bf16 rounding of that row, plus
# F32_TOL x max|plain| for fp32 summation noise.  A global BF16_TOL x max
# would pass a fault of a typical value: most rows average ~1000 positions,
# |o| ~ 0.05 against a max of 3.4.  Readings it was set from (H100, bf16
# training shape): o 9.8e-4 (|o| < 0.25), dk 1.6e-2 (|dk| in [2, 4)), each
# one bf16 step of its element.
# The chain as training runs it, kernel forward then kernel backward,
# against plain forward then plain backward: bf16 gradients within
# FLASH_CHAIN_TOL x max|plain| (the bf16 output the backward reads brings
# its own rounding), fp32 within FLASH_F32_TOL x max|plain|.
FLASH_CHAIN_TOL = 2e-2
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 2048  # TinyLlama's context
# (B, S, H, N, dtype, logw) the WKV kernels are held at: rwkv6-3b's
# training shape at batch 2 x 2048 (logw as the time mix makes it), in both
# types, an awkward one (S not a multiple of the 64-position chunk, 5
# heads), that one at the strongest decay the reference tests, and at
# heavy mixed decays (logw = -exp(3 + N(0, 1)): cumulative decays near
# -1000 a chunk, the CPU tests' log_offset=3)
WKV_SHAPES = [(2, 2048, 40, 64, "bfloat16", "model"),
              (2, 2048, 40, 64, "float32", "model"),
              (3, 100, 5, 64, "float32", "model"),
              (3, 100, 5, 64, "float32", -50.0),
              (3, 100, 5, 64, "float32", "heavy")]
WKV_CHUNK = 64
# the WKV kernels' device-side names (wkv.cu), by part: the state pass runs
# forward (template flag false) and in reverse for the backward (true)
WKV_KERNELS = {"wkv state forward": r"wkv_state<.*false>",
               "wkv output": r"wkv_fwd_out<",
               "wkv state backward": r"wkv_state<.*true>",
               "wkv backward chunk": r"wkv_bwd_chunk<"}
# WKV limits: fp32 outputs within 1e-4 x max|plain| (the reference's WKV
# tolerance, 1e-4 at unit scale, tests/test_kernels.py); bf16 gradients
# (dr, dk, dv) element by element within BF16_TOL x the largest |plain| of
# the element's row + F32_TOL x max|plain|, as flash's bf16 outputs.
# dlogw is a difference of reverse cumulative sums of terms the size of
# r dr and k dk, so its scale is the largest of those and of |dlogw|: at
# logw = -50 the terms cancel, the exact dlogw is ~e^-50, and both versions
# return rounding noise (H100 700 W: |plain dlogw| 2.1e-5, kernel 3.0e-5
# from it, against |r dr|, |k dk| of order 1 and more).
WKV_F32_TOL = 1e-4
# (shape, dtype name) the sort kernel is held at: the paper's Table 3
# sizes, the sort bench's, a realistic 256 MiB array, a row batch of the
# shape the Pallas grid is built for, an awkward one
SORT_SHAPES = [((1000,), "float32"), ((1100,), "float32"),
               ((1500,), "float32"), ((2000,), "float32"),
               ((100_000,), "float32"), ((1_000_000,), "float32"),
               ((1 << 26,), "float32"), ((1 << 24,), "int32"),
               ((4096, 4096), "float32"), ((8, 100), "float32")]
SORT_MAIN_NS = (2000, 1 << 26)  # distributed_sort's runs


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, flush, reps: int = 10, warm: int = 2) -> float:
    """Mean ms of ``fn()`` by CUDA events with a cold L2: ``flush``, larger
    than the card's 50 MB L2, is rewritten before every rep, outside the
    timed window, so every input comes from device memory, as the bound
    assumes."""
    for _ in range(warm):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def bound_terms(a, b, out_dtype) -> tuple:
    """(ops ms, bytes ms) for epilogue(a @ b): the FLOPs at the card's peak
    for the inputs' type, and each input read once plus the output written
    once at the memory rate.  The bound is the larger of the two."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    z = a.numel() // (m * k)
    flops = 2.0 * z * m * n * k
    peak = BF16_PEAK if (a.dtype == b.dtype == torch.bfloat16) else F32_PEAK
    nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
              + z * m * n * torch.empty((), dtype=out_dtype).element_size())
    return flops / peak * 1e3, nbytes / HBM_BW * 1e3


def rates(a, b, out_dtype, ms) -> tuple:
    """(TFLOP/s, GB/s) of epilogue(a @ b) done in ``ms``: its FLOPs, and
    each input read once plus the output written once."""
    t_ops, t_bytes = bound_terms(a, b, out_dtype)
    peak = BF16_PEAK if (a.dtype == b.dtype == torch.bfloat16) else F32_PEAK
    return t_ops * peak / 1e3 / ms / 1e9, t_bytes * HBM_BW / 1e3 / ms / 1e6


# the matmul kernel's device-side names, by path (matmul.cu); "matmul" in a
# profile's groups is their sum
MATMUL_KERNELS = {"matmul tensor_core": "matmul_wgmma_kernel",
                  "matmul split": "matmul_wgmma_split_kernel",
                  "matmul fma": "matmul_kernel"}
# names of library GEMM kernels (cuBLAS, cuBLASLt, CUTLASS device GEMMs);
# none may run on a main path
LIBRARY_GEMM = re.compile(r"gemm|xmma|cutlass|nvjet|cublas", re.IGNORECASE)
# the flash kernels' device-side names on the tensor-core path
# (flash_attention.cu); none is part of a PyTorch kernel's name
FLASH_KERNELS = {"flash forward": "repro_flash_tc_fwd",
                 "flash backward dq": "repro_flash_tc_dq",
                 "flash backward dk dv": "repro_flash_tc_dkv",
                 "flash group sum": "repro_flash_tc_group_sum"}
# names of library attention kernels (FlashAttention-2 in PyTorch, the
# memory-efficient CUTLASS kernels, cuDNN's SDPA); none may run on a main
# path
LIBRARY_ATTENTION = re.compile(
    r"fmha|flash_fwd_kernel|flash_fwd_splitkv|flash_bwd_dq_dk_dv|"
    r"flash_bwd_dot_do_o|flash_bwd_convert_dq|efficient_attention|sdpa|"
    r"attention_kernel", re.IGNORECASE)


def group_device_ms(by_name, groups) -> dict:
    """Device ms of a profile by group: each matmul path, the ``groups``
    given ({label: pattern a kernel's name matches}), everything else, and
    the matmul total."""
    split = {g: sum(v for k, v in by_name.items() if re.search(key, k))
             for g, key in {**MATMUL_KERNELS, **groups}.items()}
    split["other"] = sum(by_name.values()) - sum(split.values())
    split["matmul"] = sum(split[g] for g in MATMUL_KERNELS)
    return split


def library_gemms(phase, by_name) -> list:
    """Names of library GEMM kernels in a main path's profile, logged."""
    found = sorted(k for k in by_name if LIBRARY_GEMM.search(k))
    if found:
        log(phase, f"FAIL: library GEMM kernels on the main path: {found}")
    return found


def expected_path(a, b) -> str:
    """The routing rule by dtypes, stated apart from the wrapper's."""
    if a.dtype == b.dtype == torch.bfloat16:
        return "tensor_core"
    if a.dtype == b.dtype == torch.float32:
        return "fma"
    return "split"


class RouteAudit:
    """Inside the block every matmul kernel call (``ops.matmul_cuda``) is
    checked: the path it launched, read off ``LAUNCHES.by_path``, against
    the path its dtypes name.  ``counts`` tallies the calls by (a dtype, b
    dtype, path); ``wrong`` lists the misrouted."""

    def __init__(self, ops, mm):
        self.ops, self.mm = ops, mm
        self.counts, self.wrong = {}, []

    def __enter__(self):
        self.launch = self.ops.matmul_cuda

        def audited(a, b, **kw):
            before = dict(self.mm.LAUNCHES.by_path)
            out = self.launch(a, b, **kw)
            ran = [p for p, n in self.mm.LAUNCHES.by_path.items()
                   if n != before[p]]
            key = (f"{str(a.dtype)[6:]} x {str(b.dtype)[6:]} -> "
                   f"{'+'.join(ran)}")
            self.counts[key] = self.counts.get(key, 0) + 1
            if ran != [expected_path(a, b)]:
                self.wrong.append(key)
            return out

        self.ops.matmul_cuda = audited
        return self

    def __exit__(self, *exc):
        self.ops.matmul_cuda = self.launch

    def report(self, phase) -> bool:
        log(phase, f"routing: {self.counts}; misrouted {len(self.wrong)}")
        return not self.wrong and bool(self.counts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.configs import get_config
    from repro_torch.core.costs.calibration import calibrate
    from repro_torch.core.dispatch import adaptive_matmul, matmul_chain
    from repro_torch.core.sort import distributed_sort
    from repro_torch.hw import H100
    from repro_torch.kernels import bitonic_sort, build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import wkv as wkv_k
    from repro_torch.kernels.matmul import LAUNCHES
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.serving.scheduler import ServeScheduler
    from repro_torch.core.costs.engine import CostEngine
    from repro_torch.tree import tree_map

    # fp32 products in full fp32 (no TF32) on both sides of every check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record: dict = {}
    dev = torch.device("cuda")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)

    # ------------------------------------------------------------------ 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log("card", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    log("build", f"{', '.join(build.SOURCES)} built in {build_s:.2f} s "
        f"into {build.BUILD_DIR}")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    for name, text in build.LOGS.items():  # the ptxas -v reports, in full
        (ROOT / "chiprun_out" / f"ptxas_{name}.txt").write_text(text)
    ptxas = ptxas_summary(build.LOGS.get("matmul", ""))
    for kind, row in ptxas.items():
        log("build", f"matmul.cu {kind}: {row['kernels']} kernels, "
            f"{row['registers'][0]}-{row['registers'][1]} registers a "
            f"thread, spill stores/loads up to {row['spill_bytes']} bytes "
            f"(ptxas -v); shared memory {row['smem']}; wgmma serialized "
            f"(ptxas C7520) in {row['serialized_wgmma']}")
    flash_ptxas = ptxas_summary(build.LOGS.get("flash_attention", ""),
                                FLASH_PTXAS_KINDS)
    for kind, row in flash_ptxas.items():
        log("build", f"flash_attention.cu {kind}: {row['kernels']} kernels, "
            f"{row['registers'][0]}-{row['registers'][1]} registers a "
            f"thread at launch, spill stores/loads up to "
            f"{row['spill_bytes']} bytes (ptxas -v); ptxas C75xx notices "
            f"(wgmma serialized, setmaxnreg ignored) {row['notices']}")
    tc = flash_ptxas.get("tensor_core")
    notices = [x for x in build.LOGS.get("flash_attention", "").splitlines()
               if "(C75" in x]  # every wgmma of flash_attention.cu is tc
    if not tc or tc["kernels"] != 7 or tc["spill_bytes"] or notices:
        log("build", f"FAIL: the flash tensor-core kernels must build (7 "
            f"kernels) with no spill and no C75xx notice: {tc}; {notices}")
        return 1
    sort_ptxas = ptxas_summary(build.LOGS.get("bitonic_sort", ""),
                               SORT_PTXAS_KINDS)
    for kind, row in sort_ptxas.items():
        log("build", f"bitonic_sort.cu {kind}: {row['kernels']} kernels, "
            f"{row['registers'][0]}-{row['registers'][1]} registers a "
            f"thread, spill stores/loads up to {row['spill_bytes']} bytes "
            f"(ptxas -v)")
    sort_counts = {k: v["kernels"] for k, v in sort_ptxas.items()}
    if sort_counts != {"block": 4, "global": 2} or any(
            v["spill_bytes"] for v in sort_ptxas.values()):
        log("build", f"FAIL: the sort kernels (first and finishing block "
            f"passes, global pass; fp32 and int32) must build with no "
            f"spill: {sort_ptxas}")
        return 1
    wkv_build = wkv_build_report(wkv_k, build.LOGS.get("wkv", ""))
    (ROOT / "chiprun_out" / "wkv_build.json").write_text(
        json.dumps(wkv_build, indent=1))
    n_inst = len(wkv_k.CHUNKS) * len(wkv_k.HEAD_SIZES) * 2  # L x N x dtype
    counts = {kind: row["kernels"] for kind, row in wkv_build["ptxas"].items()}
    if wkv_build["spills"] or counts != {
            kind: n_inst for kind in ("state forward", "output",
                                      "state backward", "backward chunk")} \
            or wkv_k.design()["subchunk"] != wkv_k.SUBCHUNK:
        log("build", f"FAIL: the WKV kernels (state pass both ways, output, "
            f"backward chunk; {n_inst} instantiations each) must build with "
            f"no spill, on sub-chunks of wkv.SUBCHUNK rows: kernels {counts}, "
            f"spilling {wkv_build['spills']}, design {wkv_k.design()}")
        return 1
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s, matmul_ptxas=ptxas,
                  flash_ptxas=flash_ptxas, sort_ptxas=sort_ptxas,
                  wkv_build=wkv_build)

    # ------------------------------------------------------------------ 2
    gc.collect()  # now, not as a gen-2 pass inside a timed step
    cfg = get_config("tinyllama-1.1b")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    hq, hkv, g = cfg.n_heads, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    max_len = PROMPT + MAX_NEW
    chunk, _ = ServeScheduler(cfg, CostEngine(), max_len=max_len).prefill_chunk(
        PROMPT, active_decodes=0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    w = {n: rand(kk, nn, scale=kk ** -0.5) for n, (kk, nn) in {
        "wq": (d, hq * hd), "wk": (d, hkv * hd), "wo": (hq * hd, d),
        "w_gate": (d, f), "w_out": (f, d)}.items()}
    table = rand(cfg.vocab_size, d, scale=0.02)
    cache_k = rand(SLOTS, max_len, hkv, hd)
    cache_v = rand(SLOTS, max_len, hkv, hd)
    # (name, a, b, activation, out_dtype)
    cases = []
    for phase_rows, s_new in (("decode", 1), ("prefill", chunk)):
        m = SLOTS * s_new
        x = rand(m, d)
        x32 = rand(m, d, dtype=torch.float32)
        cases += [
            (f"{phase_rows} rmsnorm x*x.1", x32 * x32,
             torch.ones(d, 1, device=dev), None, torch.float32),
            (f"{phase_rows} wq/wo", x, w["wq"], None, torch.bfloat16),
            (f"{phase_rows} wk/wv", x, w["wk"], None, torch.bfloat16),
            (f"{phase_rows} w_gate silu", x, w["w_gate"], "silu",
             torch.bfloat16),
            (f"{phase_rows} w_in", x, w["w_gate"], None, torch.bfloat16),
            (f"{phase_rows} w_out", rand(m, f), w["w_out"], None,
             torch.bfloat16),
            (f"{phase_rows} attn q.k", rand(SLOTS, hkv, s_new * g, hd,
                                            dtype=torch.float32),
             cache_k.permute(0, 2, 3, 1), None, torch.float32),
            (f"{phase_rows} attn p.v", torch.softmax(rand(
                SLOTS, hkv, s_new * g, max_len, dtype=torch.float32), -1),
             cache_v.permute(0, 2, 1, 3), None, torch.float32),
            (f"{phase_rows} unembed", x, table.t(), None, torch.float32),
        ]
    extra = [("fp32 ragged 37x129x65", rand(37, 65, dtype=torch.float32),
              rand(65, 129, dtype=torch.float32), None, torch.float32)]
    for act in ("relu", "gelu", "silu", "tanh"):
        extra.append((f"bias+{act} 37x129x65", rand(37, 65), rand(65, 129),
                      act, torch.bfloat16))
    rows, worst = [], 0.0
    bias = rand(129, dtype=torch.float32)
    for name, a, b, act, out_dt in cases + extra:
        bb = bias if name.startswith("bias") else None
        kw = dict(bias=bb, activation=act, out_dtype=out_dt)
        err, tol = kernel_error(ops, ref, a, b, kw)
        if not err <= tol:
            log("kernel", f"FAIL {name}: max abs err {err:.3e} > {tol:.3e}")
            return 1
        worst = max(worst, err)
        path = mm.choose_path(a.dtype, b.dtype)
        k_ms = cuda_ms(lambda: ops.matmul(a, b, **kw), flush)
        p_ms = cuda_ms(lambda: ref.matmul_fused_ref(a, b, **kw), flush)
        # one library call computing the same function exists only for a
        # plain product whose output type is its inputs' type
        same_fn = (act is None and bb is None and a.dtype == b.dtype == out_dt)
        l_ms = cuda_ms(lambda: torch.matmul(a, b), flush) if same_fn else None
        t_ops, t_bytes = bound_terms(a, b, out_dt)
        tflops, gbs = rates(a, b, out_dt, k_ms)
        rows.append(dict(name=name, shape=f"{tuple(a.shape)}@{tuple(b.shape)}",
                         path=path, tflops=tflops, gb_per_s=gbs,
                         max_abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes"))
        log("kernel", f"{name:24s} {rows[-1]['shape']:42s} {path:11s} err "
            f"{err:.2e} (tol {tol:.2e})  kernel {k_ms:.4f} ms ({tflops:.2f} "
            f"TFLOP/s, {gbs:.1f} GB/s)  plain {p_ms:.4f} ms  "
            f"library {'-' if l_ms is None else f'{l_ms:.4f}'} ms  "
            f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}); "
            f"cold L2")
    record["kernel_rows"] = rows
    record["batch_invariance"] = invariance_gate(ops, mm, gen, d, f)
    if record["batch_invariance"] is None:
        return 1

    # ------------------------------------------------------------------ 3
    gc.collect()
    engine = CostEngine()
    paper = []
    for order in (1024, 4096, 8192):
        a = rand(order, order, scale=order ** -0.5)
        b = rand(order, order)
        out, rep = adaptive_matmul(a, b, engine=engine, use_kernel=True,
                                   return_report=True)
        want = ref.matmul_ref(a, b)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = BF16_TOL * want.float().abs().max().item()
        if not err <= tol:
            log("paper", f"FAIL order {order}: err {err:.3e} > {tol:.3e}")
            return 1
        row = engine.ledger.entries[-1]
        reps = 3 if order == 8192 else 10
        k_ms = cuda_ms(lambda: adaptive_matmul(a, b, engine=engine,
                                               use_kernel=True), flush, reps, 1)
        l_ms = cuda_ms(lambda: torch.matmul(a, b), flush, reps, 1)
        t_ops, t_bytes = bound_terms(a, b, a.dtype)
        paper.append(dict(order=order, path=mm.choose_path(a.dtype, b.dtype),
                          bound_ms=max(t_ops, t_bytes),
                          choice=rep.decision.choice,
                          predicted_s=rep.decision.predicted_s, err=err,
                          kernel_ms=k_ms, torch_matmul_ms=l_ms,
                          kernel_tflops=2 * order**3 / k_ms / 1e9))
        log("paper", f"order {order}: decision {rep.decision.choice} "
            f"(predicted {rep.decision.predicted_s:.3e} s; ledger "
            f"{row.site}/{row.choice} {row.query['shape']}), err {err:.2e} "
            f"(tol {tol:.2e}), {paper[-1]['path']} kernel {k_ms:.3f} ms "
            f"({paper[-1]['kernel_tflops']:.1f} TFLOP/s), torch.matmul "
            f"{l_ms:.3f} ms, bound {paper[-1]['bound_ms']:.3f} ms")
    record["paper"] = paper
    chain_shapes = [(1024, 4096), (4096, 256), (256, 4096), (4096, 1024)]
    mats = [rand(*s, dtype=torch.float32, scale=s[0] ** -0.5)
            for s in chain_shapes]
    chain_engine = CostEngine()
    got = matmul_chain(mats, engine=chain_engine)
    want = mats[0] @ mats[1] @ mats[2] @ mats[3]  # left to right
    torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    decisions = [e.choice for e in chain_engine.ledger.entries
                 if e.site == "matmul"]
    chain_ms = cuda_ms(lambda: matmul_chain(mats, engine=chain_engine), flush)
    ltr_ms = cuda_ms(lambda: mats[0] @ mats[1] @ mats[2] @ mats[3], flush)
    log("paper", f"matmul_chain {chain_shapes} fp32: {len(decisions)} "
        f"decisions {decisions}, rel err {rel:.2e} (limit {CHAIN_TOL:g}) "
        f"against a left-to-right torch.matmul product; chain "
        f"{chain_ms:.3f} ms, left to right {ltr_ms:.3f} ms; cold L2")
    if not (rel <= CHAIN_TOL and len(decisions) == len(mats) - 1):
        return 1
    record["matmul_chain"] = dict(shapes=chain_shapes, rel_err=rel,
                                  decisions=decisions, chain_ms=chain_ms,
                                  left_to_right_ms=ltr_ms)

    # ------------------------------------------------------------------ 4
    gc.collect()
    sort_rows = []
    for shape, dtype_name in SORT_SHAPES:
        row = sort_case(shape, getattr(torch, dtype_name), gen, ops, ref,
                        bitonic_sort, flush)
        if row is None:
            return 1
        sort_rows.append(row)
    record["sort_rows"] = sort_rows
    big = next(r for r in sort_rows
               if r["shape"] == [1 << 26] and r["dtype"] == "float32")
    record["sort_stages"] = sort_stages(gen, bitonic_sort.bitonic_sort_cuda)
    if not sort_hard_inputs(bitonic_sort, ref):
        return 1
    sort_engine = CostEngine()
    xs = [torch.randn(n, generator=gen, device=dev) for n in SORT_MAIN_NS]
    torch.cuda.synchronize()
    bitonic_sort.LAUNCHES.reset()
    outs = [distributed_sort(x, engine=sort_engine, local_sort="kernel",
                             measure=True) for x in xs]
    torch.cuda.synchronize()
    sort_launches = bitonic_sort.LAUNCHES.count
    sort_grids = bitonic_sort.LAUNCHES.grids
    for x, (out, rep) in zip(xs, outs):
        exact = torch.equal(out, torch.sort(x).values)
        log("sort", f"distributed_sort(local_sort='kernel') n={x.numel()}: "
            f"strategy {rep.strategy}, imbalance {rep.imbalance}, equal to "
            f"torch.sort: {exact}")
        if not exact or rep.strategy != "serial":
            return 1
    log("sort", f"bitonic sort kernel calls on the sort path: "
        f"{sort_launches} ({sort_grids} CUDA launches)")
    if sort_launches != len(SORT_MAIN_NS):  # one kernel call per sort
        return 1
    ledger_rows = []
    for e in sort_engine.ledger.entries:
        if e.site == "sort" and e.measured_s is not None:
            ledger_rows.append(dict(shape=e.query["shape"], choice=e.choice,
                                    predicted_s=e.predicted_s,
                                    measured_s=e.measured_s))
            log("ledger", f"  sort {e.choice} n={e.query['shape']}: "
                f"predicted {e.predicted_s:.3e} s, measured "
                f"{e.measured_s:.3e} s")
    record["sort_path"] = dict(launches=sort_launches, grids=sort_grids,
                               ledger=ledger_rows)

    # ------------------------------------------------------------------ 5
    gc.collect()
    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    LAUNCHES.reset()
    static = rt.serve(cfg, trace(), mode="static", model=model, params=params,
                      slots=SLOTS, eos_id=-1)
    cont = rt.serve(cfg, trace(), mode="continuous", model=model,
                    params=params, slots=SLOTS, eos_id=-1)
    torch.cuda.synchronize()
    launches = LAUNCHES.count
    same = all((static.outputs[r] == cont.outputs[r]).all()
               for r in static.outputs)
    ntok = sum(len(v) for v in cont.outputs.values())
    log("serve", f"tinyllama-1.1b full width bf16, {REQUESTS} requests x "
        f"{PROMPT}+{MAX_NEW} tokens, {SLOTS} slots: static "
        f"{static.tok_per_s:.1f} tok/s, continuous {cont.tok_per_s:.1f} tok/s, "
        f"host_syncs_per_token {cont.report.host_syncs_per_token:.4f} "
        f"({cont.report.host_syncs} syncs, {cont.report.device_dispatches} "
        f"dispatches, {ntok} tokens)")
    serve_paths = dict(LAUNCHES.by_path)
    log("serve", f"static == continuous tokens: {same}; matmul kernel "
        f"launches during serving: {launches} (by path {serve_paths})")
    if not same or launches <= 0:
        return 1
    for site in ("serve", "serve_macro"):
        rows_site = [e for e in rt.ledger.entries if e.site == site]
        meas = [e for e in rows_site if e.measured_s is not None]
        log("ledger", f"{site}: {len(rows_site)} rows, {len(meas)} measured")
        for e in meas[-3:]:
            log("ledger", f"  {site} {e.choice} {e.note}: predicted "
                f"{e.predicted_s:.3e} s, measured {e.measured_s:.3e} s")
    state = model.init_decode_state(SLOTS, max_len, per_slot=True)
    feed = {"tokens": torch.ones((SLOTS, 1), dtype=torch.int64, device=dev)}
    LAUNCHES.reset()
    with RouteAudit(ops, mm) as audit:
        calls = step_matmuls(model, params, state, feed, ops)
    per_step = LAUNCHES.count
    step_paths = dict(LAUNCHES.by_path)
    log("serve", f"matmul kernel launches per decode step: {per_step} (by "
        f"path {step_paths})")
    prof = profile_decode_step(model, params, state, feed)
    step = replay_step(calls, ops, ref, flush)
    if step is None or not audit.report("serve") or prof["library_gemms"]:
        return 1
    p1_want = {r: np.asarray(v) for r, v in cont.outputs.items()}
    worst = max(worst, step["max_abs_err"])
    if prof["matmul_ms"] > 0 and step["plain_device_ms"] > 0:
        step.update(ms=prof["matmul_ms"], plain_ms=step["plain_device_ms"],
                    timed_by="torch.profiler device time")
    else:
        step.update(ms=step["kernel_window_ms"],
                    plain_ms=step["plain_window_ms"],
                    timed_by="CUDA-event window of the replay (the profiler "
                    "saw no kernels)")
    log("step", f"one decode step's {len(calls)} matmuls ({SLOTS} slots, "
        f"{cfg.n_layers} layers): kernel {step['ms']:.3f} ms in the real "
        f"step, plain {step['plain_ms']:.3f} ms replayed, by "
        f"{step['timed_by']}; replay windows (cold L2) kernel "
        f"{step['kernel_window_ms']:.3f} ms, plain "
        f"{step['plain_window_ms']:.3f} ms; bound {step['bound_ms']:.3f} ms "
        f"({step['bound_by']}); all within tolerance of the plain version, "
        f"largest error {step['worst_call']}")
    log("step", f"the {step['library_calls']} of {len(calls)} calls that one "
        f"torch.matmul computes (no epilogue, one dtype): torch.matmul "
        f"{step['library_device_ms']:.3f} ms, the kernel "
        f"{step['kernel_device_ms_on_library_calls']:.3f} ms replayed, by "
        f"torch.profiler device time")
    record["decode_step_profile"] = prof
    record["decode_step"] = step
    cal = calibrate(H100, cache_dir=ROOT / "build" / "calibration",
                    force=True, device="cuda")
    fields = {k: v for k, v in cal.measurements.items() if v is not None}
    log("calibrate", " ".join(f"{k}={v:.4g}" for k, v in fields.items()))
    record["serve"] = dict(
        static_tok_per_s=static.tok_per_s, continuous_tok_per_s=cont.tok_per_s,
        host_syncs=cont.report.host_syncs,
        device_dispatches=cont.report.device_dispatches,
        host_syncs_per_token=cont.report.host_syncs_per_token,
        generated_tokens=ntok, launches=launches, launches_by_path=serve_paths,
        launches_per_decode_step=per_step,
        launches_per_decode_step_by_path=step_paths,
        routing=audit.counts, tokens_identical=same)
    record["calibration"] = cal.measurements

    # ------------------------------------------------------------------ 6
    gc.collect()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p_gpu = tree_map(lambda t: t.float(), params)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    prompts = torch.as_tensor(
        synthetic_trace(2, prompt_len=16, max_new=1, vocab_size=cfg.vocab_size,
                        arrival="all", seed=1)[0].prompt, dtype=torch.int64)
    prompts = torch.stack([prompts, prompts.flip(0)])
    logits = {}
    for where, p_dev in (("cuda", p_gpu), ("cpu", p_cpu)):
        m32 = build_model(cfg32, where)
        st = m32.init_decode_state(2, 32, per_slot=True)
        out, st = m32.decode_step(p_dev, st, {"tokens": prompts.to(where)})
        steps = [out[:, -1]]
        for _ in range(4):
            tok = steps[-1].argmax(-1)[:, None]
            out, st = m32.decode_step(p_dev, st, {"tokens": tok})
            steps.append(out[:, -1])
        logits[where] = [s.float().cpu() for s in steps]
    worst_rel = 0.0
    for i, (lg, lc) in enumerate(zip(logits["cuda"], logits["cpu"])):
        tol = 2e-3 * lc.abs().max().item()
        err = (lg - lc).abs().max().item()
        worst_rel = max(worst_rel, err / lc.abs().max().item())
        if not err <= tol:
            log("card-vs-cpu", f"FAIL step {i}: logits err {err:.3e} > "
                f"{tol:.3e}")
            return 1
        tg, tc = lg.argmax(-1), lc.argmax(-1)
        if not torch.equal(tg, tc):
            top2 = lc.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).min().item()
            log("card-vs-cpu", f"step {i}: tokens differ at a top-2 gap of "
                f"{gap:.3e} (tolerance {tol:.3e})")
            if gap >= tol:
                return 1
            break
    log("card-vs-cpu", f"fp32 prefill 2x16 + 4 decode steps: logits agree, "
        f"max err {worst_rel:.2e} x max|logit| (limit 2e-3); greedy tokens "
        f"equal")
    record["card_vs_cpu_rel_err"] = worst_rel

    del p_gpu, p_cpu, params, model, static, cont, calls, state
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 7
    gc.collect()
    flash_rows = []
    for shape in FLASH_SHAPES:
        row = flash_case(shape, gen, ref, fa, flush)
        if row is None:
            return 1
        flash_rows.append(row)
    record["flash_rows"] = flash_rows
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 8
    gc.collect()
    parity = train_parity(cfg)
    if parity is None:
        return 1
    record["train_parity"] = parity
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 9
    gc.collect()
    record["train_matmuls"] = train_matmuls(cfg, ops, ref, flush)
    if record["train_matmuls"] is None:
        return 1
    train = train_phase(cfg, fa, LAUNCHES)
    if train is None:
        return 1
    record["train"] = train
    flash_main = flash_rows[0]  # the bf16 training shape
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 10
    gc.collect()
    wkv_rows = []
    for shape in WKV_SHAPES:
        row = wkv_case(shape, gen, ref, wkv_k, flush)
        if row is None:
            return 1
        wkv_rows.append(row)
    record["wkv_rows"] = wkv_rows
    torch.cuda.empty_cache()
    rcfg = get_config("rwkv6-3b")

    # ----------------------------------------------------------------- 11
    gc.collect()
    record["rwkv_card_vs_cpu"] = rwkv_card_vs_cpu(rcfg, wkv_k)
    if record["rwkv_card_vs_cpu"] is None:
        return 1
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 12
    gc.collect()
    record["rwkv_serve"] = rwkv_serve(rcfg, LAUNCHES, wkv_k)
    if record["rwkv_serve"] is None:
        return 1
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 13
    gc.collect()
    record["rwkv_train_parity"] = train_parity(rcfg, leaves=47)
    if record["rwkv_train_parity"] is None:
        return 1
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 14
    gc.collect()
    rtrain = rwkv_train_phase(rcfg, wkv_k, LAUNCHES)
    if rtrain is None:
        return 1
    record["rwkv_train"] = rtrain
    wkv_main = wkv_rows[0]  # the bf16 training shape
    wd = wkv_k.design()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 15
    gc.collect()
    paged = paged_phase(cfg, rcfg, p1_want, LAUNCHES, card,
                        prof["device_events"])
    if paged is None:
        return 1
    record["paged"] = paged
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 16
    gc.collect()
    life = lifecycle_phase(cfg, rcfg, p1_want, record["serve"]["host_syncs"],
                           LAUNCHES, card)
    if life is None:
        return 1
    record["lifecycle"] = life
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 17
    gc.collect()
    front = frontend_phase(cfg, p1_want, record["serve"]["host_syncs"],
                           record["calibration"], LAUNCHES, card)
    if front is None:
        return 1
    record["frontend"] = front

    # ---------------------------------------------------------------- out
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    kernels = [{
        "name": "matmul", "route": "cuda",
        "design": "wgmma bf16 tensor cores fed by TMA (bf16 x bf16), the "
                  "same kernel on hi + lo bf16 halves (fp32 x bf16), the "
                  "FP32 FMA kernel (fp32 x fp32)",
        "source": "src/repro_torch/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:103",
        "launches": launches, "max_abs_err": worst,
        # phase 15's paged serving run (P1), counted from 0 just before it
        "launches_paged_serve": paged["p1"]["matmul_launches"],
        # phase 16's dense preemption drill, counted from 0 just before it
        "launches_lifecycle_serve": life["matmul_launches"],
        # phase 17's dense front-end serve, counted from 0 just before it
        "launches_frontend_serve": front["dense"]["matmul_launches"],
        # one decode step's matmul calls: the kernel in the real step, the
        # plain version on the same operands, the bound of the same work
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
        # no single library call computes a step's fused-epilogue and
        # fp32-output products; chiprun_out/chip_smoke.json has
        # torch.matmul beside every plain product of phase 2 and summed
        # over the step's calls that one torch.matmul computes
        "library_ms": None,
    }, {
        "name": "bitonic_sort", "route": "cuda",
        "design": f"block passes on tiles of "
                  f"2^{bitonic_sort.TILE.bit_length() - 1} in dynamic "
                  f"shared memory, {1 << bitonic_sort.LOG_E} elements a "
                  f"thread in registers, up to {bitonic_sort.LOG_E} stages "
                  f"a register window, one padded exchange between "
                  f"windows; global passes of up to {bitonic_sort.LOG_GROUP}"
                  f" stages, {1 << bitonic_sort.LOG_GROUP} elements a "
                  f"thread ({big['launches_per_call']} launches for "
                  f"2^{big['n_pad'].bit_length() - 1})",
        "source": "src/repro_torch/csrc/bitonic_sort.cu",
        "replaces": "src/repro/kernels/bitonic_sort.py:62",
        "launches": sort_launches,
        "max_abs_err": max(r["max_abs_err"] for r in sort_rows),
        # one 2^26 fp32 array (256 MiB), as distributed_sort's big run
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "design": "wgmma bf16 tensor cores fed by TMA, P and dS split into "
                  "bf16 hi + lo, dK/dV per query head summed per kv head "
                  "(bf16 at hd 64 and 128); the FP32 FMA kernels (fp32)",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        # wrapper calls per training step: forward (each layer, and again
        # in its recomputation) and backward (each layer)
        "launches": train["flash_calls_per_step"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        # the bf16 training shape, forward plus backward
        "ms": flash_main["fwd_ms"] + flash_main["bwd_ms"],
        "plain_ms": flash_main["fwd_plain_ms"] + flash_main["bwd_plain_ms"],
        "bound_ms": flash_main["bound_ms"],
        "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["fwd_library_ms"]
        + flash_main["bwd_library_ms"],
    }, {
        "name": "wkv", "route": "cuda",
        "design": f"state pass one CTA per (b, h, {wd['state_cols']} value "
                  f"columns), {wd['state_threads']} threads, sequential over "
                  f"the chunks, next chunk by cp.async; per-chunk kernels one "
                  f"CTA per (b, h, chunk), {wd['chunk_threads']} threads; "
                  f"pairwise decay factored by sub-chunks of "
                  f"{wd['subchunk']} rows; FP32 FMA register tiles "
                  f"({len(wkv_k.FORWARD_KERNELS)} launches forward, "
                  f"{len(wkv_k.BACKWARD_KERNELS)} backward)",
        "source": "src/repro_torch/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv.py:81",
        # wrapper calls per rwkv6-3b training step: forward (each layer,
        # and again in its recomputation) and backward (each layer)
        "launches": rtrain["wkv_calls_per_step"],
        "cuda_launches": rtrain["wkv_cuda_launches_per_step"],
        "max_abs_err": max(r["max_abs_err"] for r in wkv_rows),
        # the bf16 training shape, forward (keeping the chunk-start states,
        # as training does) plus backward
        "ms": wkv_main["fwd_ms"] + wkv_main["bwd_ms"],
        "plain_ms": wkv_main["fwd_plain_ms"] + wkv_main["bwd_plain_ms"],
        "bound_ms": wkv_main["bound_ms"], "bound_by": wkv_main["bound_by"],
        # no PyTorch call computes the WKV6 recurrence; the packages that
        # do are packages of finished kernels
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_error(ops, ref, a, b, kw) -> tuple:
    """(max abs error, tolerance) of the kernel against its plain version
    on the same operands."""
    return held(ops.matmul(a, b, **kw), ref.matmul_fused_ref(a, b, **kw))


def held(got, want) -> tuple:
    """(max abs error, tolerance) of a matmul result against the plain
    version's: BF16_TOL or F32_TOL x max|plain| by the output's dtype."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    return err, (BF16_TOL if want.dtype == torch.bfloat16 else F32_TOL) * top


INVARIANCE_ROWS = (1, 3, 4, 8, 16, 17, 64, 255, 4096)


def invariance_gate(ops, mm, gen, d, f):
    """The batch-invariance contract, bit for bit, on every path: row i of
    a product of M rows (M in INVARIANCE_ROWS; i the first, middle and last
    row) equals that row multiplied alone (torch.equal), for every
    epilogue, with transposed and 4-D operands, at tinyllama-1.1b's widths
    (K = d; N = d_ff, tile 128, and N = d, tile 64).  None on a mismatch."""
    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    bf = torch.bfloat16
    x = rand(4096, d, dtype=bf)
    xt = rand(d, 4096, dtype=bf).t()  # MN-major A, as aᵀ in dB = aᵀ dz
    x32 = rand(4096, d)
    w = {n: rand(d, n, dtype=bf, scale=d ** -0.5) for n in (d, f)}
    bias = rand(f)
    cases = [(f"tensor_core N={n}", x, w[n], {}) for n in (d, f)]
    cases += [(f"tensor_core {act}", x, w[f], dict(activation=act))
              for act in ("relu", "gelu", "silu", "tanh")]
    cases += [
        ("tensor_core bias+silu", x, w[f], dict(bias=bias,
                                                activation="silu")),
        ("tensor_core aᵀ", xt, w[f], {}),
        ("tensor_core bᵀ -> fp32", x, w[f].t().contiguous().t(),
         dict(out_dtype=torch.float32)),
        ("split A gelu -> bf16", x32, w[f], dict(activation="gelu",
                                                  out_dtype=bf)),
        ("split A N=d -> fp32", x32, w[d], dict(out_dtype=torch.float32)),
        ("split B aᵀ dz", xt, rand(d, f), dict(out_dtype=bf)),
        ("fma tanh", x32, w[f].float(), dict(activation="tanh")),
    ]
    checked = {}
    for name, a, b, kw in cases:
        path = mm.choose_path(a.dtype, b.dtype)
        for m in INVARIANCE_ROWS:
            whole = ops.matmul(a[:m], b, **kw)
            for i in sorted({0, m // 2, m - 1}):
                if not torch.equal(whole[i:i + 1],
                                   ops.matmul(a[i:i + 1], b, **kw)):
                    log("invariance", f"FAIL {name} ({path}): row {i} of "
                        f"{m} differs from the row alone")
                    return None
                checked[path] = checked.get(path, 0) + 1
    # 4-D: the decode-attention contractions, one query row alone
    cache = rand(4, 96, 4, 64, dtype=bf)
    for name, q, kv in (("q.k", rand(4, 4, 17, 64), cache.permute(0, 2, 3, 1)),
                        ("p.v", torch.softmax(rand(4, 4, 17, 96), -1),
                         cache.permute(0, 2, 1, 3))):
        for qq in (q, q.to(bf)):
            path = mm.choose_path(qq.dtype, kv.dtype)
            for m in (1, 4, 8, 17):
                whole = ops.matmul(qq[:, :, :m], kv, out_dtype=torch.float32)
                for i in sorted({0, m - 1}):
                    alone = ops.matmul(qq[:, :, i:i + 1], kv,
                                       out_dtype=torch.float32)
                    if not torch.equal(whole[:, :, i:i + 1], alone):
                        log("invariance", f"FAIL 4-D {name} ({path}): row "
                            f"{i} of {m} differs from the row alone")
                        return None
                    checked[path] = checked.get(path, 0) + 1
    log("invariance", f"rows bit-identical alone and in products of "
        f"{list(INVARIANCE_ROWS)} rows: {checked} comparisons by path "
        f"({len(cases)} 2-D cases, every epilogue, aᵀ, bᵀ, 4-D cache "
        f"views)")
    if set(checked) != set(mm.PATHS):
        return None
    return checked


# (path, part of the kernel name) of each source's kernels, the first
# match naming the path
MATMUL_PTXAS_KINDS = (("split", "matmul_wgmma_split"),
                      ("tensor_core", "matmul_wgmma"), ("fma", "matmul_kernel"))
FLASH_PTXAS_KINDS = (("tensor_core", "repro_flash_tc_"), ("fma", "flash_"))
# the sort kernel's device-side names (bitonic_sort.cu), by launch kind
SORT_KERNELS = ("first_block_pass", "global_pass", "finish_block_pass")
SORT_PTXAS_KINDS = (("block", "block_pass"), ("global", "global_pass"))


def ptxas_summary(text, kinds=MATMUL_PTXAS_KINDS) -> dict:
    """Registers, spills, static shared memory and serialized-wgmma notices
    of one source's kernels by path (``kinds``: matmul.cu's by default),
    from ``nvcc -Xptxas -v``: the C7520 notices (wgmma serialized on a
    path ptxas cannot prove uniform) counted, and every C75xx code (wgmma
    serialized for any reason, setmaxnreg ignored) listed."""
    out = {}

    def kind_of(line):
        return next((p for p, key in kinds if key in line), None)

    def row_of(kind):
        return out.setdefault(kind, dict(kernels=0, registers=[999, 0],
                                         spill_bytes=0, smem="none",
                                         serialized_wgmma=0, notices=[]))

    kind = None
    for line in text.splitlines():
        code = re.search(r"\((C75\d\d)\)", line)
        if code and kind_of(line):  # ptxas: this function's wgmma serialized
            row = row_of(kind_of(line))
            row["notices"].append(code.group(1))
            row["serialized_wgmma"] += code.group(1) == "C7520"
        elif "Compiling entry function" in line:
            kind = kind_of(line)
            if kind:
                row_of(kind)["kernels"] += 1
        elif kind and "spill" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes spill", line)]
            out[kind]["spill_bytes"] = max([out[kind]["spill_bytes"]] + nums)
        elif kind and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            r = out[kind]["registers"]
            r[0], r[1] = min(r[0], regs), max(r[1], regs)
            found = re.search(r"(\d+) bytes smem", line)
            if found:
                out[kind]["smem"] = f"{found.group(1)} bytes static"
            elif kind != "fma":
                out[kind]["smem"] = "dynamic (TcShape::kSmem)"
    return out


def sort_case(shape, dtype, gen, ops, ref, bitonic_sort, flush):
    """Hold the sort kernel at ``shape`` against its plain version and
    torch.sort (exactly equal), and time all three beside the bound.  None
    if they disagree."""
    x = torch.randn(shape, generator=gen, device="cuda") * 1e4
    x = x.to(dtype)
    n = shape[-1]
    padded = ops._sort_pad(x.view(-1, n))  # the kernel's input, as ops.sort
    rows, n_pad = padded.shape
    grids = bitonic_sort.LAUNCHES.grids
    got = ops.sort(x)
    grids = bitonic_sort.LAUNCHES.grids - grids
    plain = ref.bitonic_sort_ref(padded)[:, :n].reshape(shape)
    lib = torch.sort(x, dim=-1).values
    exact = torch.equal(got, plain) and torch.equal(got, lib)
    err = (got.double() - plain.double()).abs().max().item()
    name = f"{tuple(shape)} {dtype}".replace("torch.", "")
    if not exact or grids != bitonic_sort.grid_launches(n_pad):
        log("sort", f"FAIL {name}: kernel == plain == torch.sort is {exact}, "
            f"max abs err {err:.3e}; {grids} CUDA launches, expected "
            f"{bitonic_sort.grid_launches(n_pad)}")
        return None
    big = rows * n_pad >= 1 << 24
    reps, warm = (3, 1) if big else (10, 2)
    k_ms = cuda_ms(lambda: bitonic_sort.bitonic_sort_cuda(padded), flush,
                   reps, warm)
    p_ms = cuda_ms(lambda: ref.bitonic_sort_ref(padded), flush,
                   2 if big else reps, 1)
    l_ms = cuda_ms(lambda: torch.sort(x, dim=-1), flush, reps, warm)
    # each element read once and written once; the n log2 n comparisons
    # any comparison sort makes, at the fp32 rate
    t_bytes = 2 * rows * n_pad * x.element_size() / HBM_BW * 1e3
    t_ops = rows * n_pad * math.log2(n_pad) / F32_PEAK * 1e3
    # the schedule's own bound: every pass reads and writes the array once
    row = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
               n_pad=n_pad, launches_per_call=grids, max_abs_err=err,
               ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               schedule_bound_ms=grids * t_bytes)
    log("sort", f"{name:24s} n_pad {n_pad:>9d}: kernel == plain == "
        f"torch.sort; kernel {k_ms:.4g} ms ({grids} launches)  plain "
        f"{p_ms:.4g} ms  torch.sort {l_ms:.4g} ms  bound "
        f"{row['bound_ms']:.4g} ms ({row['bound_by']}), schedule bound "
        f"{row['schedule_bound_ms']:.4g} ms ({grids} passes); cold L2")
    return row


def sort_hard_inputs(bitonic_sort, ref) -> bool:
    """The sort kernel bit for bit (compared as int32: -0.0 is not +0.0,
    NaN is itself) its plain version on hard values, fp32 and int32: small
    integers (duplicates), -0.0 beside +0.0, +-inf and NaN, the int32
    extremes, sorted and reversed rows; at n = 2, T/2, T, 2T, the first n
    with a k whose global stages end in a group of 1 after a full one, and
    several rows below and above the tile, and a view not 16-byte
    aligned.  Every call's launches equal grid_launches; torch.sort beside
    them where every value is finite."""
    tile, ok = bitonic_sort.TILE, True
    short = tile << (bitonic_sort.LOG_GROUP + 1)
    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.int32):
        cases = []
        for rows, n in [(1, 2), (1, tile // 2), (1, tile), (1, 2 * tile),
                        (1, short), (3, tile // 4), (3, 2 * tile)]:
            x = torch.randint(-4, 5, (rows, n), generator=g, device="cuda")
            pick = torch.randint(0, 16, (rows, n), generator=g, device="cuda")
            if dtype == torch.int32:
                x = torch.where(pick == 0, -2**31, x)
                x = torch.where(pick == 1, 2**31 - 1, x).to(torch.int32)
            else:
                x = x.float()
                x = torch.where((x == 0) & (pick < 8), -0.0, x)
                for v, special in enumerate((float("nan"), float("inf"),
                                             -float("inf"))):
                    x = torch.where(pick == 8 + v, special, x)
            cases.append((f"hard ({rows}, {n})", x))
        ramp = torch.arange(1 << 16, device="cuda").to(dtype).view(1, -1)
        cases += [("sorted (1, 65536)", ramp),
                  ("reversed (1, 65536)", ramp.flip(1).contiguous()),
                  # 4 bytes past an allocation: the fill's element path
                  ("misaligned (1, 2T)", torch.cat(
                      [cases[3][1][0, :1], cases[3][1][0]])[1:].view(1, -1))]
        for name, x in cases:
            grids = bitonic_sort.LAUNCHES.grids
            got = bitonic_sort.bitonic_sort_cuda(x)
            grids = bitonic_sort.LAUNCHES.grids - grids
            want = ref.bitonic_sort_ref(x)
            bits = torch.equal(got.view(torch.int32), want.view(torch.int32))
            finite = dtype == torch.int32 or bool(torch.isfinite(x).all())
            lib = torch.equal(got, torch.sort(x, dim=-1).values) \
                if finite else None
            good = bits and lib is not False and \
                grids == bitonic_sort.grid_launches(x.shape[1])
            ok &= good
            log("sort", f"{'ok' if good else 'FAIL'} {name} "
                f"{str(dtype)[6:]}: bits equal to the plain network "
                f"{bits}, torch.sort {'-' if lib is None else lib}, "
                f"{grids} launches")
    return ok


def sort_stages(gen, sort) -> dict:
    """Where one 2^26 fp32 ``sort(x)``'s device time goes, by the kernel's
    launch kinds (torch.profiler): the first block pass, the global passes,
    the finishing block passes; each with its launches and HBM rate (one
    read and one write of the array a launch)."""
    x = torch.randn((1, 1 << 26), generator=gen, device="cuda")
    nbytes = 2 * x.numel() * x.element_size()
    sort(x)  # warm
    counts = {}
    by_name, events = device_ms_by_kernel(lambda: sort(x), counts)
    kinds = {}
    for name, ms in by_name.items():
        kind = next((k for k in SORT_KERNELS if k in name), name)
        row = kinds.setdefault(kind, dict(launches=0, ms=0.0))
        row["launches"] += counts[name]
        row["ms"] += ms
    for row in kinds.values():
        row["tb_per_s"] = row["launches"] * nbytes / row["ms"] / 1e9
    total = sum(by_name.values())
    if not events:
        log("sort", "one 2^26 fp32 call by launch kind: not measured (the "
            "profiler saw no kernels)")
    else:
        log("sort", f"one 2^26 fp32 call by torch.profiler, {events} "
            f"device events: " + "; ".join(
                f"{k} {v['launches']} launches {v['ms']:.3f} ms "
                f"({v['ms'] / v['launches']:.4f} ms, {v['tb_per_s']:.2f} "
                f"TB/s a launch)" for k, v in kinds.items())
            + f"; total {total:.3f} ms")
    return dict(events=events, kinds=kinds, total_ms=total)


def device_ms_by_kernel(run, counts=None) -> tuple:
    """({kernel name: device ms}, device events) of what ``run()``
    launches, from torch.profiler; ``counts``, where given, gets each
    name's number of launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name, n_kernels = {}, 0
    for ev in prof.events():  # device-side events only: each kernel once
        if ev.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3
            if counts is not None:
                counts[ev.name] = counts.get(ev.name, 0) + 1
    return by_name, n_kernels


def step_matmuls(model, params, state, feed, ops) -> list:
    """Run one decode step and return every ``ops.matmul`` call it made as
    (a, b, keyword arguments); the list keeps the operands alive."""
    calls, launch = [], ops.matmul

    def recording(a, b, **kw):
        calls.append((a, b, kw))
        return launch(a, b, **kw)

    ops.matmul = recording
    try:
        model.decode_step(params, state, feed)
    finally:
        ops.matmul = launch
    return calls


def replay_step(calls, ops, ref, flush):
    """Hold one decode step's matmul calls (the model's own weights for
    every layer, in the step's order) against the plain version, time both
    replays, and add up the bound of the same work.  None if a call
    disagrees."""
    worst, worst_call = 0.0, None
    for a, b, kw in calls:
        err, tol = kernel_error(ops, ref, a, b, kw)
        call = f"{tuple(a.shape)} @ {tuple(b.shape)} {kw}"
        if not err <= tol:
            log("step", f"FAIL {call}: max abs err {err:.3e} > {tol:.3e}")
            return None
        if err >= worst:
            worst, worst_call = err, f"{call}: {err:.3e} (tol {tol:.3e})"

    def run_kernel():
        for a, b, kw in calls:
            ops.matmul(a, b, **kw)

    def run_plain():
        for a, b, kw in calls:
            ref.matmul_fused_ref(a, b, **kw)

    # the calls one torch.matmul computes: no epilogue, one dtype in and out
    plain_calls = [(a, b, kw) for a, b, kw in calls
                   if kw.get("bias") is None and kw.get("activation") is None
                   and a.dtype == b.dtype == (kw.get("out_dtype") or a.dtype)]

    def run_library():
        for a, b, _ in plain_calls:
            torch.matmul(a, b)

    def run_kernel_on_those():
        for a, b, kw in plain_calls:
            ops.matmul(a, b, **kw)

    terms = [bound_terms(a, b, kw.get("out_dtype") or a.dtype)
             for a, b, _ in calls]
    t_ops, t_bytes = sum(t[0] for t in terms), sum(t[1] for t in terms)
    run_plain()  # warm the allocator before the profiled replay
    run_library()
    plain_by_name, _ = device_ms_by_kernel(run_plain)
    kernel_by_name, _ = device_ms_by_kernel(run_kernel)
    library_by_name, _ = device_ms_by_kernel(run_library)
    subset_by_name, _ = device_ms_by_kernel(run_kernel_on_those)
    return dict(max_abs_err=worst, worst_call=worst_call, calls=len(calls),
                plain_device_ms=sum(plain_by_name.values()),
                kernel_replay_device_ms=sum(kernel_by_name.values()),
                library_calls=len(plain_calls),
                library_device_ms=sum(library_by_name.values()),
                kernel_device_ms_on_library_calls=sum(
                    subset_by_name.values()),
                kernel_window_ms=cuda_ms(run_kernel, flush, reps=3, warm=1),
                plain_window_ms=cuda_ms(run_plain, flush, reps=3, warm=1),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def profile_decode_step(model, params, state, feed) -> dict:
    """Where one decode step's time goes: its wall time (host clock around
    synchronized steps, profiler off) against the device time of the
    kernels it launches (torch.profiler), split into the matmul kernel and
    everything else."""
    wall_ms = step_wall(model, params, state, feed)
    by_name, n_kernels = device_ms_by_kernel(
        lambda: model.decode_step(params, state, feed))
    device_ms = sum(by_name.values())
    groups = group_device_ms(by_name, {})
    matmul_ms = groups["matmul"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    if device_ms == 0:
        log("profile", f"one decode step ({SLOTS} slots): wall {wall_ms:.3f} "
            f"ms; device time not measured (the profiler saw no kernels)")
    else:
        log("profile", f"one decode step ({SLOTS} slots): wall {wall_ms:.3f} "
            f"ms, device busy {device_ms:.3f} ms "
            f"({100 * device_ms / wall_ms:.1f}% of wall), matmul kernel "
            f"{matmul_ms:.3f} ms, other kernels {device_ms - matmul_ms:.3f} ms; "
            f"{n_kernels} device events under {len(by_name)} kernel names")
        log("profile", "  matmul by path: " + ", ".join(
            f"{g[7:]} {groups[g]:.3f} ms" for g in MATMUL_KERNELS))
    for name, ms in top:
        log("profile", f"  {ms:8.3f} ms  {name[:90]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, matmul_ms=matmul_ms,
                matmul_ms_by_path={g[7:]: groups[g] for g in MATMUL_KERNELS},
                library_gemms=library_gemms("profile", by_name),
                device_events=n_kernels, top=top)


def flash_case(shape, gen, ref, fa, flush):
    """Hold the flash kernels at ``shape`` against their plain versions,
    forward and backward on the same inputs (the backward fed the plain
    forward's output and log-sum-exp), and the forward against
    flash_attention_ref; time each beside the plain version,
    scaled_dot_product_attention (and its backward) and the bound.  None
    if they disagree."""
    import torch.nn.functional as F

    b, s, hq, hkv, hd, dtype_name = shape
    dt = getattr(torch, dtype_name)
    q, k, v, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
                   .to(dt) for h in (hq, hkv, hkv, hq))
    # the routing rule, stated apart from the wrapper's choose_path
    path = "tensor_core" if dt == torch.bfloat16 and hd in (64, 128) \
        else "fma"
    before = (fa.LAUNCHES.forward, fa.LAUNCHES.backward, fa.LAUNCHES.grids,
              fa.LAUNCHES.by_path[path], fa.LAUNCHES.copied_operands)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v)
    o_p, lse_p = ref.flash_attention_fwd_plain(q, k, v)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do)
    grads_p = ref.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do)
    calls = (fa.LAUNCHES.forward - before[0], fa.LAUNCHES.backward - before[1],
             fa.LAUNCHES.grids - before[2], fa.LAUNCHES.by_path[path]
             - before[3], fa.LAUNCHES.copied_operands - before[4])
    # the backward again on the same inputs: the same bits (no atomics, a
    # fixed order for the group sums)
    again = fa.flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do)
    repeat = all(torch.equal(x, y) for x, y in zip(grads, again))
    # the chain as training runs it: the kernel backward fed the kernel
    # forward's o and lse, against the plain chain
    chained = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    del again
    g = hq // hkv
    fold = lambda t: t.repeat_interleave(  # noqa: E731
        hq // t.shape[2], dim=2).transpose(1, 2).reshape(b * hq, s, hd)
    oracle = ref.flash_attention_ref(fold(q), fold(k), fold(v))
    torch.cuda.synchronize()
    errs, worst = {}, 0.0
    for name, got, want in [("o", o, o_p), ("lse", lse, lse_p),
                            ("o vs flash_attention_ref", fold(o), oracle),
                            *zip(("dq", "dk", "dv"), grads, grads_p)]:
        diff = (got.float() - want.float()).abs()
        mag = want.float().abs()
        top = mag.max().item()
        if want.dtype == torch.bfloat16:
            limit = BF16_TOL * mag.amax(-1, keepdim=True) + F32_TOL * top
        else:
            limit = torch.full_like(mag, FLASH_F32_TOL * top)
        err, ratio = diff.max().item(), (diff / limit).max().item()
        errs[name] = dict(err=err, of_limit=ratio)
        worst = max(worst, err)
        if not ratio <= 1.0:
            log("flash", f"FAIL {shape} {name}: max abs err {err:.3e}, "
                f"{ratio:.2f} x its limit")
            return None
    grids = 4 if path == "tensor_core" else 3
    chain_tol = FLASH_F32_TOL if dt == torch.float32 else FLASH_CHAIN_TOL
    for name, got, want in zip(("dq", "dk", "dv"), chained, grads_p):
        err = (got.float() - want.float()).abs().max().item()
        ratio = err / (chain_tol * want.float().abs().max().item())
        errs[f"chained {name}"] = dict(err=err, of_limit=ratio)
        if not ratio <= 1.0:
            log("flash", f"FAIL {shape} chained {name}: max abs err "
                f"{err:.3e}, {ratio:.2f} x its limit")
            return None
    del chained
    if calls != (1, 1, grids, 2, 0):
        log("flash", f"FAIL {shape}: wrapper calls (forward, backward, CUDA "
            f"launches, on the {path} path, operands copied) {calls}, "
            f"expected (1, 1, {grids}, 2, 0)")
        return None
    if not repeat:
        log("flash", f"FAIL {shape}: a second backward on the same inputs "
            f"gave other bits")
        return None

    # SDPA on the same tensors, heads second, as a yardstick only
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                              enable_gqa=True)

    leaves = [t.detach().clone().requires_grad_(True) for t in (qt, kt, vt)]
    out_lib = sdpa(*leaves)
    do_t = do.transpose(1, 2)
    big = s >= 1024
    reps = 5 if big else 10
    times = dict(
        fwd_ms=cuda_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v), flush,
                       reps),
        fwd_plain_ms=cuda_ms(lambda: ref.flash_attention_fwd_plain(q, k, v),
                             flush, reps),
        fwd_library_ms=cuda_ms(lambda: sdpa(qt, kt, vt), flush, reps),
        bwd_ms=cuda_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o_p, lse_p, do), flush, reps),
        bwd_plain_ms=cuda_ms(lambda: ref.flash_attention_bwd_plain(
            q, k, v, o_p, lse_p, do), flush, reps),
        bwd_library_ms=cuda_ms(lambda: torch.autograd.grad(
            out_lib, leaves, do_t, retain_graph=True), flush, reps))
    # the causal pairs col <= row; the forward's two products, the
    # backward's at 2.5x; each input read once, each output written once
    pairs = b * hq * s * (s + 1) / 2
    flops_f = 4.0 * pairs * hd
    flops_b = 2.5 * flops_f
    peak = BF16_PEAK if dt == torch.bfloat16 else F32_PEAK
    esz = q.element_size()
    n_q, n_kv = q.numel(), k.numel()
    bytes_f = esz * (2 * n_q + 2 * n_kv) + 4 * b * hq * s  # q k v o, lse
    bytes_b = esz * (3 * n_q + 2 * n_kv) + 4 * b * hq * s \
        + esz * (n_q + 2 * n_kv)  # q k v o do lse in, dq dk dv out
    t_ops = (flops_f + flops_b) / peak * 1e3
    t_bytes = (bytes_f + bytes_b) / HBM_BW * 1e3
    row = dict(shape=list(shape[:5]), dtype=dtype_name, group=g, path=path,
               backward_bits_repeat=repeat,
               max_abs_err=worst, errors=errs, launches=dict(
                   forward_calls=1, backward_calls=1, cuda_launches=grids),
               fwd_bound_ms=max(flops_f / peak, bytes_f / HBM_BW) * 1e3,
               bwd_bound_ms=max(flops_b / peak, bytes_b / HBM_BW) * 1e3,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               fwd_tflops=flops_f / times["fwd_ms"] / 1e9,
               bwd_tflops=flops_b / times["bwd_ms"] / 1e9, **times)
    log("flash", f"{tuple(shape[:5])} {dtype_name} ({path} path; backward "
        f"bits repeat): kernel == plain within tol (worst {worst:.2e}; "
        + ", ".join(
            f"{k} {e['err']:.1e} = {e['of_limit']:.2f} x limit"
            for k, e in errs.items())
        + ")")
    log("flash", f"  forward: kernel {times['fwd_ms']:.4f} ms "
        f"({row['fwd_tflops']:.2f} TFLOP/s)  plain {times['fwd_plain_ms']:.4f}"
        f" ms  sdpa {times['fwd_library_ms']:.4f} ms  bound "
        f"{row['fwd_bound_ms']:.4f} ms; 1 launch; cold L2")
    log("flash", f"  backward: kernel {times['bwd_ms']:.4f} ms "
        f"({row['bwd_tflops']:.2f} TFLOP/s)  plain {times['bwd_plain_ms']:.4f}"
        f" ms  sdpa {times['bwd_library_ms']:.4f} ms  bound "
        f"{row['bwd_bound_ms']:.4f} ms; {grids - 1} launches; cold L2")
    return row


def train_parity(cfg, leaves=None):
    """One training step of the full-width model cut to 2 layers, in fp32,
    on the card and on the CPU from the same parameters and batch: the
    loss within 1e-4 relative and every gradient within 2e-3 x max|grad|
    of the CPU's, leaf by leaf (``leaves`` of them, where given).  None on
    a mismatch."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.training import (TrainLoopConfig, init_train_state,
                                      make_grad_fn, make_train_step)
    from repro_torch.tree import leaves_with_paths, tree_map

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    loop = TrainLoopConfig(warmup_steps=1, total_steps=4)
    batch = SyntheticLMData(cfg2, seq_len=256, global_batch=2,
                            seed=0).batch_at(0)
    out = {}
    state = None
    for where in ("cuda", "cpu"):
        model = build_model(cfg2, where)
        if state is None:
            state = init_train_state(model, 0, loop)
        else:
            state = tree_map(lambda t: t.cpu(), state)
        feed = {k: v.to(where) for k, v in batch.items()}
        t0 = time.perf_counter()
        _, metrics = make_train_step(model, loop)(state, feed)
        loss, _, grads = make_grad_fn(model)(state["params"], feed)
        if where == "cuda":
            torch.cuda.synchronize()
        out[where] = dict(step_loss=float(metrics["loss"]), loss=float(loss),
                          grads=dict(leaves_with_paths(grads)),
                          s=time.perf_counter() - t0)
    gpu, cpu = out["cuda"], out["cpu"]
    rel = abs(gpu["step_loss"] - cpu["step_loss"]) / abs(cpu["step_loss"])
    worst, worst_leaf = 0.0, None
    for path, gc in cpu["grads"].items():
        gg = gpu["grads"].get(path)
        if gg is None or not gg.is_cuda:
            log("train-parity", f"FAIL {path}: no gradient on the card")
            return None
        top = gc.abs().max().item()
        err = (gg.cpu() - gc).abs().max().item()
        if not err <= 2e-3 * top:
            log("train-parity", f"FAIL {path}: gradient err {err:.3e} > "
                f"{2e-3 * top:.3e}")
            return None
        if top > 0 and err / top >= worst:
            worst, worst_leaf = err / top, path
    log("train-parity", f"{cfg.name} full width, 2 layers, fp32, batch "
        f"2 x 256: loss card {gpu['step_loss']:.6f}, cpu "
        f"{cpu['step_loss']:.6f} (rel {rel:.2e}, limit 1e-4); "
        f"{len(cpu['grads'])} gradients on the card, worst leaf {worst_leaf}"
        f" at {worst:.2e} x max|grad| (limit 2e-3); card {gpu['s']:.2f} s, "
        f"cpu {cpu['s']:.2f} s (one step + one gradient each)")
    if not rel <= 1e-4 or (leaves is not None
                           and len(cpu["grads"]) != leaves):
        log("train-parity", f"FAIL: loss rel err {rel:.2e} (limit 1e-4) or "
            f"{len(cpu['grads'])} gradients where {leaves} were expected")
        return None
    return dict(loss_cuda=gpu["step_loss"], loss_cpu=cpu["step_loss"],
                rel_err=rel, leaves=len(cpu["grads"]), worst_leaf=worst_leaf,
                worst_rel=worst)


def train_matmuls(cfg, ops, ref, flush):
    """Every distinct matmul call of one training gradient of full-width
    tinyllama-1.1b in bf16 at batch 2 x 2048, cut to 1 layer (each layer
    makes the same calls), held against the plain version on the call's
    own operands, its path checked against its dtypes, and timed (CUDA
    events, cold L2) beside torch.matmul where both operands are bf16 (a
    yardstick only).  A call is its shapes, strides, dtypes and epilogue,
    so the backward's products through transposed strides and with fp32
    gradients against bf16 operands are among them.  None on a mismatch,
    or if no such product was seen."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import matmul as mm
    from repro_torch.models import build_model
    from repro_torch.training import TrainLoopConfig, make_grad_fn
    from repro_torch.training import init_train_state

    cfg1 = dataclasses.replace(cfg, n_layers=1)
    model = build_model(cfg1, "cuda")
    params = init_train_state(model, 0, TrainLoopConfig())["params"]
    batch = SyntheticLMData(cfg1, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            seed=0, device="cuda").batch_at(0)
    rows, failed, launch = {}, [], ops._matmul

    def checking(a, b, bias, activation, out_dtype):
        out = launch(a, b, bias, activation, out_dtype)
        key = (tuple(a.shape), a.stride(), str(a.dtype), tuple(b.shape),
               b.stride(), str(b.dtype), bias is not None, activation,
               str(out_dtype))
        if key not in rows:
            err, tol = held(out, ref.matmul_fused_ref(
                a, b, bias=bias, activation=activation, out_dtype=out_dtype))
            k_ms = cuda_ms(lambda: launch(a, b, bias, activation, out_dtype),
                           flush, reps=5, warm=1)
            lib = a.dtype == b.dtype == torch.bfloat16
            tflops, gbs = rates(a, b, out.dtype, k_ms)
            t_ops, t_bytes = bound_terms(a, b, out.dtype)
            rows[key] = dict(a=list(a.shape), a_stride=list(a.stride()),
                             a_dtype=str(a.dtype), b=list(b.shape),
                             b_stride=list(b.stride()), b_dtype=str(b.dtype),
                             bias=bias is not None, activation=activation,
                             out_dtype=str(out.dtype), err=err, tol=tol,
                             path=mm.choose_path(a.dtype, b.dtype), ms=k_ms,
                             tflops=tflops, gb_per_s=gbs,
                             bound_ms=max(t_ops, t_bytes),
                             torch_matmul_ms=cuda_ms(
                                 lambda: torch.matmul(a, b), flush, reps=5,
                                 warm=1) if lib else None)
            if not err <= tol:
                failed.append(rows[key])
        return out

    ops._matmul = checking
    try:
        with RouteAudit(ops, mm) as audit:
            make_grad_fn(model)(params, batch)
    finally:
        ops._matmul = launch
    calls = list(rows.values())
    transposed = [r for r in calls if any(
        r[x + "_stride"][1] != 1 and r[x][1] > 1 for x in "ab")]
    mixed = [r for r in calls if r["a_dtype"] != r["b_dtype"]]
    for r in calls:
        log("backward", f"{tuple(r['a'])}{tuple(r['a_stride'])} "
            f"{r['a_dtype'][6:]} @ {tuple(r['b'])}{tuple(r['b_stride'])} "
            f"{r['b_dtype'][6:]} -> {r['out_dtype'][6:]}"
            f"{' +bias' if r['bias'] else ''}"
            f"{' ' + r['activation'] if r['activation'] else ''}: "
            f"max abs err {r['err']:.3e} (limit {r['tol']:.3e}); "
            f"{r['path']} {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
            f"{r['gb_per_s']:.0f} GB/s), torch.matmul "
            + ("-" if r["torch_matmul_ms"] is None
               else f"{r['torch_matmul_ms']:.4f} ms") + "; cold L2")
    bf16 = [r for r in calls if r["torch_matmul_ms"] is not None]
    log("backward", f"{len(calls)} distinct matmul calls in one gradient "
        f"(batch {TRAIN_BATCH} x {TRAIN_SEQ}, 1 layer, bf16), "
        f"{len(transposed)} with a transposed operand, {len(mixed)} with "
        f"mixed dtypes; {len(failed)} outside the limit; the {len(bf16)} "
        f"bf16 x bf16 calls: kernel {sum(r['ms'] for r in bf16):.4f} ms, "
        f"torch.matmul {sum(r['torch_matmul_ms'] for r in bf16):.4f} ms, "
        f"bound {sum(r['bound_ms'] for r in bf16):.4f} ms")
    if failed or not transposed or not mixed or not audit.report("backward"):
        log("backward", "FAIL: a product disagrees with the plain version, "
            "or the backward's transposed or mixed-dtype products were not "
            "seen")
        return None
    del model, params
    torch.cuda.empty_cache()
    return calls


def train_phase(cfg, fa, mm_launches):
    """Runtime.train of full-width tinyllama-1.1b (random weights, bf16):
    every step finite, the kernels' launches per step, tokens/s, peak
    memory and the plan; then a 4-step run on one fixed batch whose loss
    must fall, with one step timed and one profiled.  None on a failure."""
    import re
    import shutil

    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Runtime
    from repro_torch.training import (TrainLoopConfig, init_train_state,
                                      make_train_step)

    rt = Runtime(device="cuda")
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    lines, plans = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mm_launches.reset()
    fa.LAUNCHES.reset()
    res = rt.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   seed=0, ckpt_dir=str(ckpt), ckpt_every=10 ** 6,
                   log_every=1, log=lines.append, on_plan=plans.append)
    torch.cuda.synchronize()
    counts = dict(matmul=mm_launches.count, flash_forward=fa.LAUNCHES.forward,
                  flash_backward=fa.LAUNCHES.backward,
                  flash_cuda_launches=fa.LAUNCHES.grids,
                  flash_copied_operands=fa.LAUNCHES.copied_operands,
                  **{f"matmul {p}": n for p, n in mm_launches.by_path.items()},
                  **{f"flash {p}": n for p, n in fa.LAUNCHES.by_path.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    saved = sorted(p.name for p in ckpt.iterdir()) if ckpt.exists() else []
    shutil.rmtree(ckpt, ignore_errors=True)
    steps = [dict(step=int(m.group(1)), loss=float(m.group(2)),
                  ms=float(m.group(3))) for m in
             (re.match(r"step\s+(\d+) loss (\S+) .* (\d+)ms$", x)
              for x in lines) if m]
    for line in lines:
        log("train", line)
    plan = plans[0]
    for line in plan.summary().splitlines():
        log("train", "plan " + line.strip())
    per_step = {k: v // TRAIN_STEPS for k, v in counts.items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = [x["ms"] for x in steps[1:]]
    tok_s = tokens * len(steady) / (sum(steady) / 1e3) if steady else 0.0
    log("train", f"tinyllama-1.1b full width ({cfg.n_layers} layers) bf16, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: {res.steps_run} steps in "
        f"{res.wall_s:.2f} s, final loss {res.final_loss:.4f}, diverged "
        f"{res.diverged}; {tok_s:.1f} tokens/s over steps 1-"
        f"{TRAIN_STEPS - 1}; peak memory {peak_gb:.2f} GB; checkpoint "
        f"{saved}; launches per step {per_step}")
    ok = (res.steps_run == TRAIN_STEPS and not res.diverged
          and math.isfinite(res.final_loss) and len(steps) == TRAIN_STEPS
          and all(math.isfinite(x["loss"]) for x in steps)
          and saved == [f"step_{TRAIN_STEPS:08d}"]
          and counts["matmul"] > 0 and counts["flash_forward"] > 0
          and counts["flash_backward"] > 0
          and all(v % TRAIN_STEPS == 0 for v in counts.values()))
    if not ok:
        log("train", "FAIL: a step was not finite, the run stopped early, "
            "the checkpoint is missing or a kernel never launched")
        return None
    # bf16 at hd 64: every flash call on the wgmma kernels, through tensor
    # maps (the producer's copy loader never needed)
    if counts["flash fma"] or counts["flash_copied_operands"] or \
            counts["flash tensor_core"] != counts["flash_forward"] + \
            counts["flash_backward"]:
        log("train", f"FAIL: a bf16 flash call left the tensor-core path or "
            f"copied an operand: {counts}")
        return None
    del res
    torch.cuda.empty_cache()

    # one fixed batch: the loss must fall (optimizer and gradients wired)
    model = build_model(cfg, "cuda")
    loop = TrainLoopConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=1,
                           total_steps=TRAIN_STEPS)
    state = init_train_state(model, 1, loop)
    batch = SyntheticLMData(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            seed=1, device="cuda").batch_at(0)
    step_fn = make_train_step(model, loop)
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        end_loss = float(model.loss(state["params"], batch)[0])
    launched = {}
    by_name, events = device_ms_by_kernel(lambda: step_fn(state, batch),
                                          launched)
    device_ms = sum(by_name.values())
    split = group_device_ms(by_name, FLASH_KERNELS)
    flash_ms = sum(split[g] for g in FLASH_KERNELS)
    wall = walls[-1]
    log("train", f"fixed batch, lr 1e-3: losses {losses}, after "
        f"{TRAIN_STEPS} steps {end_loss:.4f} (must be below {losses[0]:.4f});"
        f" step walls {[round(w, 1) for w in walls]} ms")
    if events == 0:
        log("train", "profiled step: device time not measured (the profiler "
            "saw no kernels)")
    else:
        log("train", f"profiled step: {events} device events, device busy "
            f"{device_ms:.1f} ms of a {wall:.1f} ms step "
            f"({100 * device_ms / wall:.1f}%); " + ", ".join(
                f"{g} {v:.1f} ms" for g, v in split.items()))
        log("train", f"flash device time {flash_ms:.2f} ms by kernel: " +
            ", ".join(f"{k} {v:.3f} ms ({n} launches)" for k, v, n in (
                (name, sum(ms for kn, ms in by_name.items() if key in kn),
                 sum(n for kn, n in launched.items() if key in kn))
                for name, key in FLASH_KERNELS.items())))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log("train", f"  {ms:9.2f} ms  {name[:90]}")
    if not (all(math.isfinite(x) for x in losses) and end_loss < losses[0]):
        log("train", "FAIL: the loss did not fall on a fixed batch")
        return None
    if library_gemms("train", by_name):
        return None
    library_attn = sorted(k for k in by_name if LIBRARY_ATTENTION.search(k))
    if library_attn or (events and not flash_ms):
        log("train", f"FAIL: library attention kernels on the main path "
            f"{library_attn}, or no repro_flash_tc kernel in the profile "
            f"(flash {flash_ms:.3f} ms)")
        return None
    return dict(steps=steps, final_loss=steps[-1]["loss"], tok_per_s=tok_s,
                peak_memory_gb=peak_gb, launches_per_step=per_step,
                flash_calls_per_step=per_step["flash_forward"]
                + per_step["flash_backward"],
                plan=dict(decisions=[dataclasses.asdict(d)
                                     for d in plan.decisions],
                          fits_hbm=plan.fits_hbm,
                          hbm_per_chip=plan.hbm_per_chip),
                fixed_batch_losses=losses, fixed_batch_end_loss=end_loss,
                fixed_batch_step_ms=walls, profile=dict(
                    events=events, device_ms=device_ms, wall_ms=wall,
                    by_group=split, flash_ms=flash_ms, top=sorted(by_name.items(),
                                               key=lambda kv: -kv[1])[:12]))


def wkv_inputs(shape, gen):
    """r, k, v (B, S, H, N) in the shape's dtype, logw fp32, u fp32 on the
    card: r, v ~ N(0, 1); logw as rwkv_time_mix makes it at its init,
    -exp(w0 + tanh(x W1) W2) with w0 = -2, x ~ N(0, 1) and fan-in scaled
    W1 (D, 64), W2 (64, D) ("heavy": -exp(3 + N(0, 1)); or the constant
    given); k ~ N(0, 1) scaled by
    1 - e^{logw}; u ~ 0.1 N(0, 1), as bonus_u's init."""
    b, s, h, n, dtype_name, decay = shape
    dt = getattr(torch, dtype_name)
    dev, d = "cuda", h * n
    r, k, v = (torch.randn((b, s, h, n), generator=gen, device=dev)
               for _ in range(3))
    if decay == "model":
        x = torch.randn((b * s, d), generator=gen, device=dev)
        w1 = torch.randn((d, 64), generator=gen, device=dev) / d ** 0.5
        w2 = torch.randn((64, d), generator=gen, device=dev) / 8.0
        logw = -torch.exp(-2.0 + torch.tanh(x @ w1) @ w2).reshape(b, s, h, n)
    elif decay == "heavy":
        logw = -torch.exp(3.0 + torch.randn((b, s, h, n), generator=gen,
                                            device=dev))
    else:
        logw = torch.full((b, s, h, n), float(decay), device=dev)
    k = k * (1.0 - torch.exp(logw))
    u = 0.1 * torch.randn((h, n), generator=gen, device=dev)
    return r.to(dt), k.to(dt), v.to(dt), logw, u


def wkv_held(got, want, scale=None) -> float:
    """|got - want| over its limit, the largest element's: fp32 outputs
    within WKV_F32_TOL x max|want| (or x ``scale``), bf16 ones within
    BF16_TOL x their row's max|want| + F32_TOL x max|want|."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    top = mag.max().item() if scale is None else scale
    if want.dtype == torch.bfloat16:
        limit = BF16_TOL * mag.amax(-1, keepdim=True) + F32_TOL * top
    else:
        limit = torch.full_like(mag, WKV_F32_TOL * top)
    return (diff / limit.clamp(min=1e-30)).max().item()


def wkv_exps(b, h, nc, L, n, sub) -> tuple:
    """(forward, backward) exponentials the WKV kernels take: the state
    pass's L x N a chunk in each of its N/16 column CTAs; per chunk, the
    diagonal blocks' pairs (A; and dr, dk together in the backward), the
    factors (qf, kf_i; r e^{cwe} in the forward, kd in the backward) and
    the backward's scalings and assembly."""
    nb = L // sub
    pairs = sub * (sub - 1) // 2 * nb * n
    kf = sub * nb * (nb - 1) // 2 * n
    qf = (L - sub) * n
    state = (n // 16) * L * n
    fwd = state + pairs + qf + kf + L * n
    bwd = state + 2 * pairs + 2 * (qf + kf) + L * n + 2 * L * n
    return b * h * nc * fwd, b * h * nc * bwd


def wkv_case(shape, gen, ref, wkv_k, flush):
    """Hold the WKV kernels at ``shape`` against their plain versions
    (``wkv_fwd_plain`` / ``wkv_bwd_plain`` with the kernels' sub-chunk
    factorization), forward (out, final state, chunk-start states) and
    backward (dr, dk, dv, dlogw, du; fed the plain forward's chunk-start
    states and a random dout), the backward twice with the same bits;
    check the wrapper calls and the CUDA launches by kernel; time both
    beside the plain versions and the bound, and at the training shape
    profile one forward and one backward by kernel.  None if they disagree
    or an output is not finite."""
    b, s, h, n, dtype_name, decay = shape
    r, k, v, logw, u = wkv_inputs(shape, gen)
    do = torch.randn((b, s, h, n), generator=gen, device="cuda")
    sub = wkv_k.SUBCHUNK
    before = (wkv_k.LAUNCHES.forward, wkv_k.LAUNCHES.backward)
    cuda_before = dict(wkv_k.LAUNCHES.cuda)
    out, state, starts = wkv_k.wkv_fwd_cuda(r, k, v, logw, u, WKV_CHUNK,
                                            keep_states=True)
    p_out, p_state, p_starts = ref.wkv_fwd_plain(r, k, v, logw, u, WKV_CHUNK,
                                                 sub)
    grads = wkv_k.wkv_bwd_cuda(r, k, v, logw, u, p_starts, do, None,
                               WKV_CHUNK)
    again = wkv_k.wkv_bwd_cuda(r, k, v, logw, u, p_starts, do, None,
                               WKV_CHUNK)
    p_grads = ref.wkv_bwd_plain(r, k, v, logw, u, p_starts, do, None,
                                WKV_CHUNK, sub)
    calls = (wkv_k.LAUNCHES.forward - before[0],
             wkv_k.LAUNCHES.backward - before[1])
    cuda_calls = {kk: vv - cuda_before.get(kk, 0)
                  for kk, vv in wkv_k.LAUNCHES.cuda.items()}
    torch.cuda.synchronize()
    name = f"{tuple(shape[:4])} {dtype_name} logw {decay}"
    dlogw_scale = max((p_grads[3].abs().max().item(),
                       (r.float() * p_grads[0].float()).abs().max().item(),
                       (k.float() * p_grads[1].float()).abs().max().item()))
    errs, worst = {}, 0.0
    for what, got, want in [("out", out, p_out), ("state", state, p_state),
                            ("chunk states", starts, p_starts),
                            *zip(("dr", "dk", "dv", "dlogw", "du"), grads,
                                 p_grads)]:
        finite = bool(torch.isfinite(got).all())
        err = (got.float() - want.float()).abs().max().item()
        ratio = wkv_held(got, want,
                         dlogw_scale if what == "dlogw" else None)
        errs[what] = dict(err=err, of_limit=ratio, finite=finite)
        worst = max(worst, err)
        if not (finite and ratio <= 1.0 and got.dtype == want.dtype):
            log("wkv", f"FAIL {name} {what}: finite {finite}, max abs err "
                f"{err:.3e}, {ratio:.2f} x its limit")
            return None
    same_bits = all(torch.equal(x, y) for x, y in zip(grads, again))
    if not same_bits:
        log("wkv", f"FAIL {name}: two backward calls gave other bits")
        return None
    want_cuda = {}
    for kern in wkv_k.FORWARD_KERNELS + 2 * wkv_k.BACKWARD_KERNELS:
        want_cuda[kern] = want_cuda.get(kern, 0) + 1
    if calls != (1, 2) or cuda_calls != want_cuda:
        log("wkv", f"FAIL {name}: wrapper calls {calls}, CUDA launches "
            f"{cuda_calls}; expected one forward and two backward calls, "
            f"{want_cuda}")
        return None
    big = s >= 1024
    reps = 5 if big else 10
    times = dict(
        fwd_ms=cuda_ms(lambda: wkv_k.wkv_fwd_cuda(
            r, k, v, logw, u, WKV_CHUNK, keep_states=True), flush, reps),
        fwd_plain_ms=cuda_ms(lambda: ref.wkv_fwd_plain(
            r, k, v, logw, u, WKV_CHUNK, sub), flush, 2 if big else reps, 1),
        bwd_ms=cuda_ms(lambda: wkv_k.wkv_bwd_cuda(
            r, k, v, logw, u, p_starts, do, None, WKV_CHUNK), flush, reps),
        bwd_plain_ms=cuda_ms(lambda: ref.wkv_bwd_plain(
            r, k, v, logw, u, p_starts, do, None, WKV_CHUNK, sub), flush,
            2 if big else reps, 1))
    # the chunked form over full L x L tiles: forward A and A v (2 L^2 N
    # FLOPs each), (r e^cwe) S and (k e^{cw_L - cw})^T v (2 L N^2 each);
    # the backward recomputes A and adds dA, A^T dO and the pairwise dr and
    # dk (5 x 2 L^2 N) and four N-wide products (4 x 2 L N^2); each input
    # read once, each output written once (the forward keeps its
    # chunk-start states, as in training; the backward reads them)
    L, nc = WKV_CHUNK, -(-s // WKV_CHUNK)
    tiles = b * h * nc
    flops_f = tiles * (4.0 * L * L * n + 4.0 * L * n * n)
    flops_b = tiles * (10.0 * L * L * n + 8.0 * L * n * n)
    peak = BF16_PEAK if r.dtype == torch.bfloat16 else F32_PEAK
    esz, elems = r.element_size(), b * s * h * n
    states = 4 * tiles * n * n
    bytes_f = (3 * esz + 4 + 4) * elems + 4 * h * n + 4 * b * h * n * n \
        + states
    bytes_b = (3 * esz + 4 + 4) * elems + 4 * h * n + states \
        + (3 * esz + 4) * elems + 4 * h * n
    t_ops = (flops_f + flops_b) / peak * 1e3
    t_bytes = (bytes_f + bytes_b) / HBM_BW * 1e3
    exps_f, exps_b = wkv_exps(b, h, nc, L, n, sub)
    row = dict(shape=list(shape[:4]), dtype=dtype_name, logw=decay,
               chunk=WKV_CHUNK, max_abs_err=worst, errors=errs,
               backward_bits_repeat=same_bits, cuda_launches=cuda_calls,
               exps_fwd=exps_f, exps_bwd=exps_b,
               fwd_bound_ms=max(flops_f / peak, bytes_f / HBM_BW) * 1e3,
               bwd_bound_ms=max(flops_b / peak, bytes_b / HBM_BW) * 1e3,
               fwd_bound_by="operations" if flops_f / peak > bytes_f / HBM_BW
               else "bytes",
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               fwd_gflop=flops_f / 1e9, bwd_gflop=flops_b / 1e9,
               fwd_mb=bytes_f / 1e6, bwd_mb=bytes_b / 1e6, **times)
    log("wkv", f"{name}: kernel == plain (sub-chunk {sub}) within limits, "
        f"all finite, backward bits repeat (" +
        ", ".join(f"{w} {e['err']:.1e} = {e['of_limit']:.2f} x limit"
                  for w, e in errs.items()) + ")")
    log("wkv", f"  forward: kernel {times['fwd_ms']:.4f} ms  plain "
        f"{times['fwd_plain_ms']:.4f} ms  bound {row['fwd_bound_ms']:.4f} ms "
        f"({row['fwd_mb']:.1f} MB, {row['fwd_gflop']:.2f} GFLOP, "
        f"{exps_f:.3g} exp); {len(wkv_k.FORWARD_KERNELS)} launches; cold L2")
    log("wkv", f"  backward: kernel {times['bwd_ms']:.4f} ms  plain "
        f"{times['bwd_plain_ms']:.4f} ms  bound {row['bwd_bound_ms']:.4f} ms "
        f"({row['bwd_mb']:.1f} MB, {row['bwd_gflop']:.2f} GFLOP, "
        f"{exps_b:.3g} exp); {len(wkv_k.BACKWARD_KERNELS)} launches; cold L2")
    if big and dtype_name == "bfloat16":
        prof, reps = {}, 5
        for part, run in (("forward", lambda: wkv_k.wkv_fwd_cuda(
                r, k, v, logw, u, WKV_CHUNK, keep_states=True)),
                          ("backward", lambda: wkv_k.wkv_bwd_cuda(
                              r, k, v, logw, u, p_starts, do, None,
                              WKV_CHUNK))):
            flush.zero_()
            by_name, events = device_ms_by_kernel(
                lambda: [run() for _ in range(reps)])
            prof[part] = {g: sum(ms for kk, ms in by_name.items()
                                 if re.search(key, kk)) / reps
                          for g, key in WKV_KERNELS.items()}
            prof[part] = {g: ms for g, ms in prof[part].items() if ms}
            log("wkv", f"  profiled {part} (torch.profiler device ms a call, "
                f"mean of {reps}): " + (", ".join(
                    f"{g} {ms:.4f}" for g, ms in prof[part].items())
                    if prof[part] else f"not measured ({events} device "
                    f"events)"))
        row["profile"] = prof
    return row


def wkv_build_report(wkv_k, text) -> dict:
    """The WKV kernels' ptxas -v report (registers and spill bytes of each
    compiled kernel, by part) and the CUDA runtime's view of the training
    instantiations (threads, shared memory, registers, local bytes, CTAs an
    SM), logged; ``spills`` lists every kernel that spills."""
    parts, kind = {}, None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            kind = ("state backward" if "wkv_state" in mangled and "Lb1E" in
                    mangled else "state forward" if "wkv_state" in mangled
                    else "output" if "wkv_fwd_out" in mangled
                    else "backward chunk" if "wkv_bwd_chunk" in mangled
                    else None)
            if kind:
                parts.setdefault(kind, dict(kernels=0, registers=[999, 0],
                                            spill_bytes=0))["kernels"] += 1
        elif kind and "spill" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            parts[kind]["spill_bytes"] = max([parts[kind]["spill_bytes"]] +
                                             nums)
        elif kind and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            reg = parts[kind]["registers"]
            reg[0], reg[1] = min(reg[0], regs), max(reg[1], regs)
    for kind, row in parts.items():
        log("build", f"wkv.cu {kind}: {row['kernels']} kernels, "
            f"{row['registers'][0]}-{row['registers'][1]} registers a "
            f"thread, spill stores/loads up to {row['spill_bytes']} bytes "
            f"(ptxas -v)")
    runtime = {}
    for dt in ("bfloat16", "float32"):
        info = wkv_k.kernel_info(getattr(torch, dt), WKV_CHUNK, 64)
        runtime[dt] = info
        for kern, x in info.items():
            log("build", f"wkv {dt} L {WKV_CHUNK} N 64 {kern}: "
                f"{x['threads']} threads, {x['smem_bytes']} bytes dynamic "
                f"shared memory, {x['registers']} registers, "
                f"{x['local_bytes']} local bytes a thread, "
                f"{x['ctas_per_sm']} CTAs an SM")
    spills = [k for k, row in parts.items() if row["spill_bytes"]] + [
        f"{dt} {kern}" for dt, info in runtime.items()
        for kern, x in info.items() if x["local_bytes"]]
    return dict(ptxas=parts, runtime=runtime, spills=spills)


def rwkv_card_vs_cpu(cfg, wkv_k):
    """Full-width rwkv6-3b cut to 2 layers, fp32, on the card and on the
    CPU from the same parameters: prefill logits of a 2 x 16 prompt (no
    decode state: the WKV kernel on the card), then the prompt fed token
    by token through decode_step (wkv_step) and 4 greedy steps, each
    step's logits within 2e-3 x max|logit| (phase 6's limit), and the
    card's prefill within it of the card's decode at the last prompt
    token.  None on a mismatch."""
    from repro_torch.models import build_model
    from repro_torch.runtime import synthetic_trace
    from repro_torch.tree import tree_map

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    p_gpu = build_model(cfg2, "cuda").init(0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    prompt = torch.as_tensor(synthetic_trace(
        1, prompt_len=16, max_new=1, vocab_size=cfg.vocab_size,
        arrival="all", seed=2)[0].prompt, dtype=torch.int64)
    prompts = torch.stack([prompt, prompt.flip(0)])
    logits, fwd_calls = {}, 0
    for where, p_dev in (("cuda", p_gpu), ("cpu", p_cpu)):
        model = build_model(cfg2, where)
        before = wkv_k.LAUNCHES.forward
        pre = model.prefill(p_dev, {"tokens": prompts.to(where)})[:, -1]
        if where == "cuda":
            fwd_calls = wkv_k.LAUNCHES.forward - before
        st = model.init_decode_state(2, 32, per_slot=True)
        for i in range(prompts.shape[1]):
            out, st = model.decode_step(
                p_dev, st, {"tokens": prompts[:, i:i + 1].to(where)})
        steps = [out[:, -1]]
        for _ in range(4):
            tok = steps[-1].argmax(-1)[:, None]
            out, st = model.decode_step(p_dev, st, {"tokens": tok})
            steps.append(out[:, -1])
        logits[where] = [t.float().cpu() for t in [pre] + steps]
    worst = 0.0
    pairs = list(zip(logits["cuda"], logits["cpu"])) + [
        (logits["cuda"][0], logits["cuda"][1])]
    for i, (lg, lc) in enumerate(pairs):
        top = lc.abs().max().item()
        err = (lg - lc).abs().max().item()
        worst = max(worst, err / top)
        if not err <= 2e-3 * top:
            log("rwkv-card-vs-cpu", f"FAIL comparison {i}: logits err "
                f"{err:.3e} > {2e-3 * top:.3e}")
            return None
    if fwd_calls != cfg2.n_layers:
        log("rwkv-card-vs-cpu", f"FAIL: the card's prefill made {fwd_calls} "
            f"WKV kernel calls, expected one per layer")
        return None
    log("rwkv-card-vs-cpu", f"rwkv6-3b full width, 2 layers, fp32: prefill "
        f"2x16 (WKV kernel, {fwd_calls} calls) and 16 + 4 decode steps "
        f"(wkv_step), card against CPU and the card's prefill against its "
        f"decode: logits agree, max err {worst:.2e} x max|logit| (limit "
        f"2e-3)")
    return dict(rel_err=worst, wkv_forward_calls=fwd_calls)


def rwkv_serve(cfg, mm_launches, wkv_k):
    """Runtime.serve of full-width, full-depth rwkv6-3b in bf16 (random
    weights, seed 0), static and continuous: identical tokens, the matmul
    kernel launched, no WKV kernel (serving decodes through wkv_step);
    tok/s, host syncs per token and one profiled decode step.  None on a
    failure."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace

    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    torch.cuda.synchronize()
    mm_launches.reset()
    wkv_k.LAUNCHES.reset()
    static = rt.serve(cfg, trace(), mode="static", model=model,
                      params=params, slots=SLOTS, eos_id=-1)
    cont = rt.serve(cfg, trace(), mode="continuous", model=model,
                    params=params, slots=SLOTS, eos_id=-1)
    torch.cuda.synchronize()
    launches, wkv_calls = mm_launches.count, wkv_k.LAUNCHES.forward
    same = all((static.outputs[r] == cont.outputs[r]).all()
               for r in static.outputs)
    ntok = sum(len(v) for v in cont.outputs.values())
    log("rwkv-serve", f"rwkv6-3b full width ({cfg.n_layers} layers) bf16, "
        f"{REQUESTS} requests x {PROMPT}+{MAX_NEW} tokens, {SLOTS} slots: "
        f"static {static.tok_per_s:.2f} tok/s, continuous "
        f"{cont.tok_per_s:.2f} tok/s, host_syncs_per_token "
        f"{cont.report.host_syncs_per_token:.4f} ({cont.report.host_syncs} "
        f"syncs, {cont.report.device_dispatches} dispatches, {ntok} tokens)")
    log("rwkv-serve", f"static == continuous tokens: {same}; matmul kernel "
        f"launches during serving: {launches}; WKV kernel calls: "
        f"{wkv_calls}")
    if not same or launches <= 0 or wkv_calls != 0 or ntok !=             REQUESTS * MAX_NEW:
        return None
    state = model.init_decode_state(SLOTS, PROMPT + MAX_NEW, per_slot=True)
    feed = {"tokens": torch.ones((SLOTS, 1), dtype=torch.int64,
                                 device="cuda")}
    serve_paths = dict(mm_launches.by_path)
    mm_launches.reset()
    with RouteAudit(ops, mm) as audit:
        model.decode_step(params, state, feed)
    per_step = mm_launches.count
    step_paths = dict(mm_launches.by_path)
    log("rwkv-serve", f"matmul kernel launches per decode step: {per_step} "
        f"(by path {step_paths}; during serving {serve_paths})")
    prof = profile_decode_step(model, params, state, feed)
    if not audit.report("rwkv-serve") or prof["library_gemms"]:
        return None
    return dict(static_tok_per_s=static.tok_per_s,
                continuous_tok_per_s=cont.tok_per_s,
                static_wall_s=static.wall_s, continuous_wall_s=cont.wall_s,
                host_syncs=cont.report.host_syncs,
                device_dispatches=cont.report.device_dispatches,
                host_syncs_per_token=cont.report.host_syncs_per_token,
                generated_tokens=ntok, launches=launches,
                launches_by_path=serve_paths,
                launches_per_decode_step=per_step,
                launches_per_decode_step_by_path=step_paths,
                routing=audit.counts, tokens_identical=same,
                decode_step_profile=prof)


def count_syncs(fn) -> tuple:
    """(fn(), the synchronizing CUDA calls it made), the calls counted by
    torch's sync debug mode, one warning each."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def step_wall(model, params, state, batch, reps: int = 5) -> float:
    """Mean wall ms of one decode step: host clock around synchronized
    steps, profiler off."""
    model.decode_step(params, state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        model.decode_step(params, state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def step_split(model, params, state, batch, wall_ms) -> dict:
    """One decode step's device time (torch.profiler), kernel launches,
    and the device ms of the matmul kernel and of the indexing kernels (the
    page gathers and the KV scatter of a paged step; the cache write and
    the embedding lookup of a dense one), beside its wall ``wall_ms``."""
    by_name, n_kernels = device_ms_by_kernel(
        lambda: model.decode_step(params, state, batch))
    groups = group_device_ms(by_name, {"indexing": INDEX_KERNELS})
    return dict(wall_ms=wall_ms, device_ms=sum(by_name.values()),
                matmul_ms=groups["matmul"], indexing_ms=groups["indexing"],
                other_ms=groups["other"], launches=n_kernels,
                library_gemms=library_gemms("paged", by_name),
                indexing_kernels=sorted(
                    (k, v) for k, v in by_name.items()
                    if re.search(INDEX_KERNELS, k)))


def dedupe_check(model, params, trace, card) -> dict:
    """Two of a shared-prefix trace's requests admitted as ONE group into a
    fresh paged engine (the split that would defer the second is bypassed),
    so the trie keeps the first's pages and swaps out the second's
    duplicates.  Each duplicate must hold the bits of the page it is
    swapped for, in every layer's pk and pv: the same tokens at the same
    positions, computed in another row of the batch.  None on a
    mismatch."""
    from repro_torch.serving import ContinuousServeEngine
    from repro_torch.tree import leaves_with_paths

    engine = ContinuousServeEngine(model, params, n_slots=2,
                                   max_len=P2_PROMPT + MAX_NEW, eos_id=-1,
                                   paged=True, block_size=PAGE,
                                   prefix_cache="force")
    swapped, unequal = [], []
    apply_swaps = engine.pool.apply_swaps

    def checked(slot, swaps):
        for _, old, new in swaps:
            for path, leaf in leaves_with_paths(engine.pool.state["layers"]):
                if path.endswith(("pk", "pv")) and not torch.equal(
                        leaf[old], leaf[new]):
                    unequal.append((path, old, new))
            swapped.append((old, new))
        apply_swaps(slot, swaps)

    engine.pool.apply_swaps = checked
    reqs = trace[:2]
    for r in reqs:
        r.reset_lifecycle()
    engine._group_pad = P2_PROMPT
    engine._admit_group(reqs, lambda: 0.0)
    n_pages = sum(1 for p, _ in leaves_with_paths(engine.pool.state["layers"])
                  if p.endswith(("pk", "pv")))
    # a page copy (copy-on-write) and a table upload make no host sync
    donor = int(engine.pool.slot_table(0)[0])
    engine.pool.blocks.incref(donor)  # the pin cow_block releases
    _, cow_syncs = count_syncs(lambda: engine.pool.cow_block(1, donor))
    _, table_syncs = count_syncs(engine.pool.block_tables)
    log("paged", f"dedupe: {len(swapped)} trie swaps, each page compared "
        f"bit for bit in {n_pages} pools: {len(unequal)} unequal; host "
        f"syncs of a copy-on-write {cow_syncs}, of a table upload "
        f"{table_syncs} ({card})")
    if not swapped or unequal or cow_syncs or table_syncs:
        log("paged", f"FAIL: a deduplicated page differs from the page that "
            f"replaces it (or none was swapped), or a page copy or table "
            f"upload synced: {unequal[:4]}")
        return None
    return dict(swaps=len(swapped), pools=n_pages, unequal=0,
                cow_syncs=cow_syncs, table_syncs=table_syncs)


def paged_phase(cfg, rcfg, p1_want, mm_launches, card, dense_step_launches):
    """Phase 15: paged KV and the radix prefix cache through Runtime.serve
    at full width and depth (tinyllama-1.1b bf16, random weights, seed 0),
    rwkv6-3b paged (full width, 4 layers), the token stream, one profiled
    paged decode step, and the quickstart on the card.  None on any
    failed gate."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.serving.paging import default_kv_blocks

    out: dict = {"card": card}
    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)

    def same(a, b) -> bool:
        return a.keys() == b.keys() and all(
            np.array_equal(np.asarray(a[r]), np.asarray(b[r])) for r in a)

    # --- P1: phase 5's trace, paged (default kv_blocks), K and chunk pinned
    trace1 = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    # each run also counts the synchronizing CUDA calls it really made
    # (torch's sync debug mode): paging and the stream may add none
    kw = dict(model=model, params=params, slots=SLOTS, eos_id=-1, **PIN)
    dense1, dense_syncs = count_syncs(lambda: rt.serve(cfg, trace1(), **kw))
    torch.cuda.synchronize()
    mm_launches.reset()
    paged1, paged_syncs = count_syncs(lambda: rt.serve(
        cfg, trace1(), paged=True, block_size=PAGE, **kw))
    torch.cuda.synchronize()
    launches = mm_launches.count
    streamed, stream_syncs = count_syncs(lambda: rt.serve(
        cfg, trace1(), paged=True, block_size=PAGE, stream=True, **kw))
    # dense again, so the paged runs sit between two dense ones: the
    # host's speed drifts, and a first run may pay a one-off sync, so the
    # syncs gate on this one
    dense1b, dense_syncs_b = count_syncs(lambda: rt.serve(cfg, trace1(),
                                                          **kw))
    dense_tps = (dense1.tok_per_s + dense1b.tok_per_s) / 2
    kv_blocks = paged1.engine.kv_blocks
    r1, d1, s1 = paged1.report, dense1.report, streamed.report
    stream_ok = all(streamed.stream.tokens(r) == list(streamed.outputs[r])
                    for r in streamed.outputs)
    p1 = dict(
        kv_blocks=kv_blocks, reserved_blocks=r1.reserved_blocks,
        live_tokens=r1.live_tokens, paged_tok_per_s=paged1.tok_per_s,
        dense_tok_per_s=[dense1.tok_per_s, dense1b.tok_per_s],
        paged_over_dense=paged1.tok_per_s / dense_tps,
        paged_host_syncs=r1.host_syncs, dense_host_syncs=d1.host_syncs,
        paged_host_syncs_per_token=r1.host_syncs_per_token,
        dense_host_syncs_per_token=d1.host_syncs_per_token,
        stream_host_syncs=s1.host_syncs, streamed_tokens=s1.streamed_tokens,
        cuda_syncs=dict(dense=[dense_syncs, dense_syncs_b],
                        paged=paged_syncs, streamed=stream_syncs),
        stream_events=s1.stream_events, stream_tok_per_s=streamed.tok_per_s,
        matmul_launches=launches,
        tokens_equal_phase5=same(paged1.outputs, p1_want),
        dense_equal_phase5=same(dense1.outputs, p1_want),
        stream_equal=same(streamed.outputs, p1_want) and stream_ok)
    out["p1"] = p1
    log("paged", f"P1 ({REQUESTS} x {PROMPT}+{MAX_NEW}, {SLOTS} slots, pages "
        f"of {PAGE}, kv_blocks {kv_blocks}, K {PIN['macro_step']}, chunk "
        f"{PIN['prefill_chunk']}): paged {paged1.tok_per_s:.2f} tok/s, dense "
        f"{dense1.tok_per_s:.2f} and {dense1b.tok_per_s:.2f} tok/s before "
        f"and after (x{p1['paged_over_dense']:.3f} their mean); "
        f"reserved_blocks {r1.reserved_blocks}, live_tokens "
        f"{r1.live_tokens}; host_syncs/token paged "
        f"{r1.host_syncs_per_token:.4f}, dense {d1.host_syncs_per_token:.4f}, "
        f"streamed {s1.host_syncs_per_token:.4f}; synchronizing CUDA calls "
        f"(sync debug mode, warmup included) dense {dense_syncs} and "
        f"{dense_syncs_b}, paged {paged_syncs}, streamed {stream_syncs}; "
        f"matmul kernel launches "
        f"{launches} ({card})")
    log("paged", f"P1 tokens == phase 5 static and continuous: paged "
        f"{p1['tokens_equal_phase5']}, dense {p1['dense_equal_phase5']}, "
        f"streamed {p1['stream_equal']} ({s1.streamed_tokens} tokens in "
        f"{s1.stream_events} events)")
    lo, hi = BASE_P1_CUDA_SYNCS
    if not (p1["tokens_equal_phase5"] and p1["dense_equal_phase5"]
            and p1["stream_equal"] and launches > 0
            and kv_blocks == default_kv_blocks(SLOTS, PROMPT + MAX_NEW, PAGE)
            and r1.host_syncs == d1.host_syncs == s1.host_syncs
            == BASE_P1_SYNCS
            and paged_syncs == stream_syncs == dense_syncs_b
            and lo <= paged_syncs <= hi
            and same(dense1b.outputs, p1_want)
            and s1.streamed_tokens == streamed.generated_tokens):
        log("paged", f"FAIL: P1 gate (tokens, stream, host syncs "
            f"{BASE_P1_SYNCS} and CUDA syncs {lo}-{hi} as before the "
            f"lifecycle, "
            f"launches)")
        return None

    # --- the odd row: max_len not a multiple of the page, so each slot's
    # gathered pages are longer than its dense row; paged == dense ==
    # static at that max_len (and, recorded, against phase 5's max_len)
    odd_pages = -(-ODD_MAX_LEN // PAGE)
    kw = dict(model=model, params=params, slots=SLOTS, eos_id=-1,
              max_len=ODD_MAX_LEN)
    odd_static = rt.serve(cfg, trace1(), mode="static", **kw)
    odd_dense = rt.serve(cfg, trace1(), **kw)
    odd_paged = rt.serve(cfg, trace1(), paged=True, block_size=PAGE, **kw)
    odd = dict(max_len=ODD_MAX_LEN, pages_per_slot=odd_pages,
               gathered_len=odd_pages * PAGE,
               paged_equal_dense=same(odd_paged.outputs, odd_dense.outputs),
               dense_equal_static=same(odd_dense.outputs, odd_static.outputs),
               equal_phase5=same(odd_paged.outputs, p1_want),
               paged_tok_per_s=odd_paged.tok_per_s,
               dense_tok_per_s=odd_dense.tok_per_s)
    out["odd_max_len"] = odd
    log("paged", f"odd row: max_len {ODD_MAX_LEN} ({odd_pages} pages of "
        f"{PAGE} = {odd_pages * PAGE} gathered positions): paged == dense "
        f"{odd['paged_equal_dense']}, dense == static "
        f"{odd['dense_equal_static']}; == phase 5 (max_len "
        f"{PROMPT + MAX_NEW}) {odd['equal_phase5']} ({card})")
    if not (odd["paged_equal_dense"] and odd["dense_equal_static"]):
        log("paged", "FAIL: the odd row's paged tokens differ from the "
            "dense and static runs' at the same max_len")
        return None
    del odd_static, odd_dense, odd_paged

    # --- P2: system-prompt traffic, four ways
    trace2 = lambda: synthetic_trace(  # noqa: E731
        P2_REQUESTS, prompt_len=P2_PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", prefix_share=1.0,
        prefix_len=P2_PREFIX, seed=0)
    kw = dict(model=model, params=params, slots=SLOTS, eos_id=-1)
    static2 = rt.serve(cfg, trace2(), mode="static", **kw)
    runs, rows, prefill_s = {}, {}, {}
    # dense before and after the paged runs (the host's speed drifts); the
    # prefill walls are the ledger's measured prefill rows of the timed run
    for how in ("dense", "force", "auto", "dense after"):
        n0 = len(rt.ledger.entries)
        paging = {} if how.startswith("dense") else dict(
            paged=True, block_size=PAGE, prefix_cache=how)
        runs[how] = rt.serve(cfg, trace2(), **paging, **kw)
        new = rt.ledger.entries[n0:]
        rows[how] = [dict(choice=e.choice, hit=e.query["hit_tokens"],
                          predicted_s=e.predicted_s, measured_s=e.measured_s,
                          note=e.note)
                     for e in new
                     if e.site == "serve_prefix" and e.measured_s is not None
                     and "hit=" in (e.note or "")]
        prefill = [e.measured_s for e in new if e.site == "serve"
                   and e.measured_s is not None
                   and (e.note or "").startswith("prefill")]
        prefill_s[how] = sum(prefill[1:])  # the warmup's prefill left out
    dense2 = runs.pop("dense")
    dense2b = runs.pop("dense after")
    dense2_tps = (dense2.tok_per_s + dense2b.tok_per_s) / 2
    want = static2.outputs
    p2 = dict(static_tok_per_s=static2.tok_per_s,
              dense_tok_per_s=[dense2.tok_per_s, dense2b.tok_per_s],
              dense_prefill_s=[prefill_s["dense"], prefill_s["dense after"]],
              dense_prefilled_tokens=dense2.report.prefilled_tokens,
              dense_host_syncs_per_token=dense2.report.host_syncs_per_token,
              dense_equal=same(dense2.outputs, want)
              and same(dense2b.outputs, want))
    for how, res in runs.items():
        rep = res.report
        chose = {}
        for r in rows[how]:
            chose[r["choice"]] = chose.get(r["choice"], 0) + 1
        p2[how] = dict(
            tok_per_s=res.tok_per_s,
            over_dense=res.tok_per_s / dense2_tps,
            prefill_s=prefill_s[how],
            prefilled_tokens=rep.prefilled_tokens,
            prefix_hit_tokens=rep.prefix_hit_tokens,
            prefix_hit_rate=rep.prefix_hit_rate, cow_count=rep.cow_count,
            reserved_blocks=rep.reserved_blocks, host_syncs=rep.host_syncs,
            host_syncs_per_token=rep.host_syncs_per_token,
            device_dispatches=rep.device_dispatches, verdicts=chose,
            serve_prefix_rows=rows[how], equal=same(res.outputs, want))
        log("paged", f"P2 {how}: {res.tok_per_s:.2f} tok/s "
            f"(x{p2[how]['over_dense']:.3f} dense), prefill walls "
            f"{prefill_s[how]:.3f} s, prefilled "
            f"{rep.prefilled_tokens} of {P2_REQUESTS * P2_PROMPT} prompt "
            f"tokens, prefix_hit_tokens {rep.prefix_hit_tokens}, hit rate "
            f"{rep.prefix_hit_rate:.4f}, CoW {rep.cow_count}, reserved_blocks "
            f"{rep.reserved_blocks}, host_syncs/token "
            f"{rep.host_syncs_per_token:.4f}; serve_prefix verdicts {chose} "
            f"({card})")
        for r in rows[how][:3]:
            log("ledger", f"  serve_prefix {r['choice']} {r['note']}: "
                f"predicted {r['predicted_s']:.3e} s, measured "
                f"{r['measured_s']:.3e} s")
    log("paged", f"P2 ({P2_REQUESTS} x {P2_PROMPT}+{MAX_NEW}, prefix "
        f"{P2_PREFIX}, {SLOTS} slots): static {static2.tok_per_s:.2f} tok/s, "
        f"dense {dense2.tok_per_s:.2f} and {dense2b.tok_per_s:.2f} tok/s "
        f"before and after (prefill walls {prefill_s['dense']:.3f} and "
        f"{prefill_s['dense after']:.3f} s, prefilled "
        f"{dense2.report.prefilled_tokens}); tokens equal to static: dense "
        f"{p2['dense_equal']}, force {p2['force']['equal']}, auto "
        f"{p2['auto']['equal']}")
    out["p2"] = p2
    if not (p2["dense_equal"] and p2["force"]["equal"] and p2["auto"]["equal"]
            and p2["dense_prefilled_tokens"] == P2_REQUESTS * P2_PROMPT
            and 2 * p2["force"]["prefilled_tokens"]
            <= p2["dense_prefilled_tokens"]):
        log("paged", "FAIL: P2 gate (four runs token-identical, the forced "
            "run prefilling at most half the dense run's tokens)")
        return None
    out["dedupe"] = dedupe_check(model, params, trace2(), card)
    if out["dedupe"] is None:
        return None
    del static2, dense2, dense2b, runs

    # --- one decode step, paged against dense (P1's shape)
    max_len = PROMPT + MAX_NEW
    feed = torch.ones((SLOTS, 1), dtype=torch.int64, device="cuda")
    dense_state = model.init_decode_state(SLOTS, max_len, per_slot=True)
    per_slot = -(-max_len // PAGE)
    paged_state = model.init_decode_state(
        SLOTS, max_len, per_slot=True,
        paging=(SLOTS * per_slot + 1, PAGE))
    tables = torch.arange(1, SLOTS * per_slot + 1, device="cuda").reshape(
        SLOTS, per_slot)
    batch = {"tokens": feed, "block_tables": tables}
    mm_launches.reset()
    with RouteAudit(ops, mm) as audit:
        model.decode_step(params, paged_state, batch)
    step_matmul_launches = mm_launches.count
    # walls in turns (dense, paged, paged, dense): the host's speed drifts
    args = {"dense": (dense_state, {"tokens": feed}),
            "paged": (paged_state, batch)}
    walls = {"dense": [], "paged": []}
    for how in ("dense", "paged", "paged", "dense"):
        walls[how].append(step_wall(model, params, *args[how]))
    steps = {how: step_split(model, params, *args[how],
                             sum(walls[how]) / len(walls[how]))
             for how in args}
    for how, st in steps.items():
        log("paged", f"one {how} decode step ({SLOTS} slots, max_len "
            f"{max_len}): wall {st['wall_ms']:.3f} ms, device "
            f"{st['device_ms']:.3f} ms, matmul {st['matmul_ms']:.3f} ms, "
            f"indexing kernels {st['indexing_ms']:.3f} ms, other "
            f"{st['other_ms']:.3f} ms; {st['launches']} kernel launches "
            f"(phase 5's dense step: {dense_step_launches}) ({card})")
    log("paged", f"  paged indexing kernels: {steps['paged']['indexing_kernels']}")
    out["decode_step"] = dict(steps, matmul_launches=step_matmul_launches,
                              routing=audit.counts)
    if not audit.report("paged") or any(
            st["library_gemms"] for st in steps.values()):
        return None
    del dense_state, paged_state, model, params
    torch.cuda.empty_cache()

    # --- rwkv6-3b paged: full width, depth cut to 4 layers
    rcfg4 = dataclasses.replace(rcfg, n_layers=4)
    rmodel = build_model(rcfg4, rt.device)
    rparams = rmodel.init(0)
    kw = dict(model=rmodel, params=rparams, slots=SLOTS, eos_id=-1)
    rstatic = rt.serve(rcfg4, trace1(), mode="static", **kw)
    rdense = rt.serve(rcfg4, trace1(), **kw)
    rpaged = rt.serve(rcfg4, trace1(), paged=True, block_size=PAGE,
                      prefix_cache="force", **kw)
    rw = dict(layers=rcfg4.n_layers, static_tok_per_s=rstatic.tok_per_s,
              dense_tok_per_s=rdense.tok_per_s,
              paged_tok_per_s=rpaged.tok_per_s,
              prefix_reuse=rpaged.engine.prefix_cache,
              prefix_hit_tokens=rpaged.report.prefix_hit_tokens,
              equal=same(rpaged.outputs, rdense.outputs)
              and same(rdense.outputs, rstatic.outputs))
    out["rwkv"] = rw
    log("paged", f"rwkv6-3b full width, 4 of {rcfg.n_layers} layers, bf16: "
        f"paged == dense == static tokens {rw['equal']}; prefix reuse "
        f"{rw['prefix_reuse']}; paged {rpaged.tok_per_s:.2f} tok/s, dense "
        f"{rdense.tok_per_s:.2f} ({card})")
    if not rw["equal"] or rw["prefix_reuse"] or rw["prefix_hit_tokens"]:
        log("paged", "FAIL: rwkv6-3b paged gate")
        return None
    del rmodel, rparams, rstatic, rdense, rpaged
    torch.cuda.empty_cache()

    # --- the quickstart on the card (reduced config)
    t0 = time.perf_counter()
    qs = subprocess.run([sys.executable,
                         str(ROOT / "examples" / "torch_quickstart.py")],
                        capture_output=True, text=True, timeout=600,
                        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    out["quickstart"] = dict(rc=qs.returncode,
                             wall_s=time.perf_counter() - t0,
                             tail=qs.stdout[-1500:])
    log("paged", f"examples/torch_quickstart.py on the card: exit "
        f"{qs.returncode} in {out['quickstart']['wall_s']:.1f} s; "
        + " / ".join(line for line in qs.stdout.splitlines()
                     if "matched" in line))
    if qs.returncode != 0:
        log("paged", f"FAIL: quickstart: {qs.stderr[-2000:]}")
        return None
    return out


def rwkv_train_phase(cfg, wkv_k, mm_launches):
    """Runtime.train of full-width, full-depth rwkv6-3b (random weights,
    bf16) for TRAIN_STEPS steps at TRAIN_BATCH x TRAIN_SEQ without a
    checkpoint (it would write ~37 GB): every loss finite, the kernels'
    calls per step (WKV: a forward per layer and per recomputation, a
    backward per layer), step wall, tokens/s and peak memory; then one more
    step timed and one profiled (device busy share, device ms by kernel).
    None on a failure."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime
    from repro_torch.training import TrainLoopConfig, make_train_step

    rt = Runtime(device="cuda")
    lines, plans = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mm_launches.reset()
    wkv_k.LAUNCHES.reset()
    res = rt.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   seed=0, log_every=1, log=lines.append,
                   on_plan=plans.append)
    torch.cuda.synchronize()
    counts = dict(matmul=mm_launches.count, wkv_forward=wkv_k.LAUNCHES.forward,
                  wkv_backward=wkv_k.LAUNCHES.backward,
                  wkv_cuda=sum(wkv_k.LAUNCHES.cuda.values()),
                  **{f"matmul {p}": n for p, n in mm_launches.by_path.items()},
                  **{f"wkv {kk}": n for kk, n in wkv_k.LAUNCHES.cuda.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = [dict(step=int(m.group(1)), loss=float(m.group(2)),
                  ms=float(m.group(3))) for m in
             (re.match(r"step\s+(\d+) loss (\S+) .* (\d+)ms$", x)
              for x in lines) if m]
    for line in lines:
        log("rwkv-train", line)
    for line in plans[0].summary().splitlines():
        log("rwkv-train", "plan " + line.strip())
    per_step = {k: v // TRAIN_STEPS for k, v in counts.items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = [x["ms"] for x in steps[1:]]
    tok_s = tokens * len(steady) / (sum(steady) / 1e3) if steady else 0.0
    log("rwkv-train", f"rwkv6-3b full width ({cfg.n_layers} layers) bf16, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: {res.steps_run} steps in "
        f"{res.wall_s:.2f} s, final loss {res.final_loss:.4f}, diverged "
        f"{res.diverged}; {tok_s:.1f} tokens/s over steps 1-"
        f"{TRAIN_STEPS - 1}; peak memory {peak_gb:.2f} GB; launches per "
        f"step {per_step}")
    ok = (res.steps_run == TRAIN_STEPS and not res.diverged
          and math.isfinite(res.final_loss) and len(steps) == TRAIN_STEPS
          and all(math.isfinite(x["loss"]) for x in steps)
          and counts["matmul"] > 0
          and per_step["wkv_forward"] == 2 * cfg.n_layers
          and per_step["wkv_backward"] == cfg.n_layers
          and per_step["wkv_cuda"] == 2 * cfg.n_layers * len(
              wkv_k.FORWARD_KERNELS) + cfg.n_layers * len(
              wkv_k.BACKWARD_KERNELS)
          and all(v % TRAIN_STEPS == 0 for v in counts.values()))
    if not ok:
        log("rwkv-train", "FAIL: a step was not finite, the run stopped "
            "early, or the WKV kernels did not run once forward per layer "
            "and recomputation and once backward per layer (each call its "
            "kernels once)")
        return None

    # one more step timed, and one profiled, from the trained state, each
    # written into it as Runtime.train's steps are
    model = build_model(cfg, "cuda")
    step_fn = make_train_step(model, TrainLoopConfig(
        warmup_steps=max(TRAIN_STEPS // 20, 1), total_steps=TRAIN_STEPS),
        donate=True)
    batch = SyntheticLMData(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            seed=0, device="cuda").batch_at(TRAIN_STEPS)
    state = res.state
    del res
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    extra_loss = float(metrics["loss"])
    wall = (time.perf_counter() - t0) * 1e3
    del metrics
    with RouteAudit(ops, mm) as audit:
        by_name, events = device_ms_by_kernel(lambda: step_fn(state, batch))
    device_ms = sum(by_name.values())
    split = group_device_ms(by_name, {
        "wkv forward": "|".join((WKV_KERNELS["wkv state forward"],
                                 WKV_KERNELS["wkv output"])),
        "wkv backward": "|".join((WKV_KERNELS["wkv state backward"],
                                  WKV_KERNELS["wkv backward chunk"]))})
    wkv_parts = {g: sum(ms for kk, ms in by_name.items()
                        if re.search(key, kk))
                 for g, key in WKV_KERNELS.items()}
    if events == 0:
        log("rwkv-train", f"one more step: wall {wall:.1f} ms, loss "
            f"{extra_loss:.4f}; device time not measured (the profiler saw "
            f"no kernels)")
    else:
        log("rwkv-train", f"one more step: wall {wall:.1f} ms, loss "
            f"{extra_loss:.4f}; profiled: {events} device events, device "
            f"busy {device_ms:.1f} ms ({100 * device_ms / wall:.1f}% of the "
            f"timed step); " + ", ".join(f"{g} {v:.1f} ms"
                                         for g, v in split.items()))
        log("rwkv-train", "  wkv by kernel: " + ", ".join(
            f"{g} {v:.1f} ms" for g, v in wkv_parts.items()))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log("rwkv-train", f"  {ms:9.2f} ms  {name[:90]}")
    if not math.isfinite(extra_loss) or not audit.report("rwkv-train") \
            or library_gemms("rwkv-train", by_name):
        return None
    plan = plans[0]
    return dict(steps=steps, final_loss=steps[-1]["loss"], tok_per_s=tok_s,
                peak_memory_gb=peak_gb, launches_per_step=per_step,
                wkv_calls_per_step=per_step["wkv_forward"]
                + per_step["wkv_backward"],
                plan=dict(decisions=[dataclasses.asdict(d)
                                     for d in plan.decisions],
                          rnn_chunk=plan.rnn_chunk, fits_hbm=plan.fits_hbm,
                          hbm_per_chip=plan.hbm_per_chip),
                extra_step_ms=wall, extra_step_loss=extra_loss,
                wkv_cuda_launches_per_step=per_step["wkv_cuda"],
                profile=dict(events=events, device_ms=device_ms,
                             wall_ms=wall, by_group=split,
                             wkv_by_kernel=wkv_parts,
                             top=sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:12]))


class StartedThreads:
    """Counts the threads started inside the block (threading.Thread.start
    wrapped): the unperturbed path must start none, the watchdog one a
    guarded step."""

    def __enter__(self):
        import threading

        self.names = []
        self._start = start = threading.Thread.start
        names = self.names

        def counting(thread, *a, **kw):
            names.append(thread.name)
            return start(thread, *a, **kw)

        threading.Thread.start = counting
        return self

    def __exit__(self, *exc):
        import threading

        threading.Thread.start = self._start
        return False


class TripAfter:
    """A stop event that 'fires' once the engine has polled it ``polls``
    times: a shutdown in the middle of a run, on no clock."""

    def __init__(self, polls):
        self.left = polls

    def is_set(self):
        self.left -= 1
        return self.left < 0


def tick_clock(dt=1e-3):
    """A clock that advances ``dt`` on every read: deadlines and arrivals
    resolve the same on a fast host and a slow one."""
    t = [0.0]

    def now():
        t[0] += dt
        return t[0]

    return now


def ledger_rows(ledger, sites=("serve", "serve_macro", "serve_admit")):
    """The serve ledger's rows, predicted beside measured (None where the
    row was not measured), for the JSON record."""
    return [dict(site=e.site, choice=e.choice, predicted_s=e.predicted_s,
                 measured_s=e.measured_s, correction=e.correction,
                 note=e.note, query={k: v for k, v in e.query.items()
                                     if isinstance(v, (int, float, str))})
            for e in ledger.entries if e.site in sites]


def lifecycle_phase(cfg, rcfg, p1_want, phase5_syncs, mm_launches, card):
    """Phase 16: the serving request lifecycle on full-width tinyllama-1.1b
    (bf16, seed 0, 4 slots, phase 5's trace and max_len), dense and paged
    (pages of 16): the unperturbed path untouched, priority preemption,
    deadlines, the fault classes under the watchdog and retries,
    abandonment, graceful stops and the launcher; overload on the real
    clock and serve_admit with and without the correction loop recorded;
    rwkv6-3b (4 layers) raise and preemption drills.  None on any failed
    gate."""
    import threading

    from repro_torch.models import build_model
    from repro_torch.models.model import is_page_pool
    from repro_torch.runtime import Runtime, RuntimeConfig, synthetic_trace
    from repro_torch.serving import (ContinuousServeEngine, FatalFault,
                                     FaultInjector, FaultSpec, Request)
    from repro_torch.serving.scheduler import ServeScheduler
    from repro_torch.tree import leaves_with_paths

    t_phase = time.perf_counter()
    out: dict = {"card": card}
    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)
    max_len = PROMPT + MAX_NEW
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    prompts = {r.rid: np.asarray(r.prompt) for r in trace()}
    fails = []

    def gate(ok: bool, what: str) -> bool:
        if not ok:
            fails.append(what)
            log("lifecycle", f"FAIL: {what}")
        return ok

    def want(rid, n=MAX_NEW):
        return [int(t) for t in p1_want[rid][:n]]

    def toks(r):
        return [int(t) for t in r.tokens]

    def reqs(n, new, extra=None):
        """phase 5's first ``n`` requests with ``new`` tokens each;
        ``extra`` maps a rid to Request keywords."""
        extra = extra or {}
        return [Request(f"r{i}", prompts[f"r{i}"], new,
                        **extra.get(f"r{i}", {})) for i in range(n)]

    def engine(**kw):
        kw.setdefault("n_slots", SLOTS)
        kw.setdefault("max_len", max_len)
        kw.setdefault("eos_id", -1)
        return ContinuousServeEngine(model, params, cost_engine=rt.engine,
                                     **kw)

    def drill_clean(rep, n=DRILL_REQUESTS, new=DRILL_NEW):
        return all(toks(r) == want(r.rid, new) for r in rep.requests
                   if r.state.value == "COMPLETED")

    def serve_again(eng, label):
        """After a drill, the same engine serves phase 5's trace again."""
        eng.injector, eng.watchdog_s, eng.max_retries = None, None, 2
        rep = eng.run(trace(), now_fn=lambda: 0.0)
        ok = (rep.state_counts() == {"COMPLETED": REQUESTS}
              and all(toks(r) == want(r.rid) for r in rep.requests))
        gate(ok, f"{label}: the engine serves phase 5's trace again with "
             f"equal tokens")
        return ok

    # --- the unperturbed path: phase 5's continuous serve, untouched
    n0 = len(rt.ledger.entries)
    with StartedThreads() as threads:
        base, base_cuda_syncs = count_syncs(lambda: rt.serve(
            cfg, trace(), model=model, params=params, slots=SLOTS,
            eos_id=-1))
    admits = [e for e in rt.ledger.entries[n0:] if e.site == "serve_admit"]
    out["unperturbed"] = dict(
        host_syncs=base.report.host_syncs, phase5_host_syncs=phase5_syncs,
        cuda_syncs=base_cuda_syncs, threads_started=len(threads.names),
        serve_admit_rows=len(admits), tok_per_s=base.tok_per_s,
        tokens_equal_phase5=all([int(t) for t in v] == want(r)
                                for r, v in base.outputs.items()))
    log("lifecycle", f"unperturbed phase 5 trace: tokens == phase 5 "
        f"{out['unperturbed']['tokens_equal_phase5']}, host syncs "
        f"{base.report.host_syncs} (phase 5 {phase5_syncs}, before the "
        f"lifecycle "
        f"{BASE_PHASE5_SYNCS}), synchronizing CUDA calls {base_cuda_syncs}, "
        f"threads started {len(threads.names)}, serve_admit queries "
        f"{len(admits)} ({card})")
    gate(out["unperturbed"]["tokens_equal_phase5"]
         and base.report.host_syncs == phase5_syncs == BASE_PHASE5_SYNCS
         and not threads.names and not admits,
         "unperturbed: phase 5's tokens and host syncs, no thread, no "
         "serve_admit query")
    del base

    # --- priority preemption, dense and paged: 4 low-priority requests fill
    # the slots, a late priority-5 request evicts one; the victim
    # re-prefills prompt + generated (paged: re-pinning its prompt's pages)
    for how in ("dense", "paged"):
        paging = dict(paged=True, block_size=PAGE, prefix_cache="force",
                      kv_blocks=2 * (SLOTS * -(-max_len // PAGE)) + 1) \
            if how == "paged" else {}
        eng = engine(**paging)
        # the late request arrives after the first macro-step (every clock
        # read is 1 ms), while the others still have tokens to make
        rs = reqs(SLOTS + 1, MAX_NEW,
                  {f"r{SLOTS}": dict(arrival_s=0.003, priority=5)})
        if how == "dense":
            mm_launches.reset()
        rep = eng.run(rs, now_fn=tick_clock())
        if how == "dense":
            torch.cuda.synchronize()
            out["matmul_launches"] = mm_launches.count
        victims = [r for r in rep.requests if r.preemptions]
        row = dict(states=rep.state_counts(), preemptions=rep.preemptions,
                   victims=[r.rid for r in victims],
                   tokens_equal={r.rid: toks(r) == want(r.rid)
                                 for r in rep.requests},
                   first_token_s={r.rid: r.first_token_s
                                  for r in rep.requests},
                   prefix_hit_tokens=rep.prefix_hit_tokens,
                   host_syncs=rep.host_syncs)
        if how == "paged":
            blocks = eng.pool.blocks
            row.update(used_blocks=blocks.used_blocks,
                       trie_blocks=blocks.trie_blocks)
        out[f"preempt_{how}"] = row
        log("lifecycle", f"preemption {how}: states {row['states']}, "
            f"victims {row['victims']} ({rep.preemptions} preemptions), "
            f"tokens == phase 5 {row['tokens_equal']}, prefix hits "
            f"{rep.prefix_hit_tokens}"
            + (f", used_blocks {row['used_blocks']} == trie pins "
               f"{row['trie_blocks']}" if how == "paged" else "")
            + f" ({card})")
        gate(row["states"] == {"COMPLETED": SLOTS + 1} and victims
             and all(row["tokens_equal"].values())
             and (how == "dense" or (row["used_blocks"] == row["trie_blocks"]
                                     and rep.prefix_hit_tokens > 0)),
             f"preemption {how}: a victim, every token equal to phase 5's"
             + (", pages back to the trie's pins, the prefix re-pinned"
                if how == "paged" else ""))
        del eng
    gate(out.get("matmul_launches", 0) > 0,
         "the matmul kernel launched on the lifecycle path")

    # --- deadlines on the tick clock
    dl = {}
    eng = engine(n_slots=1)
    rep = eng.run(reqs(2, 8, {"r1": dict(deadline_s=0.002)}),
                  now_fn=tick_clock())
    late = rep.requests[1]
    dl["queued"] = dict(states=rep.state_counts(), reason=late.reason)
    gate(late.state.value == "TIMED_OUT"
         and late.reason == "deadline expired while queued"
         and toks(rep.requests[0]) == want("r0", 8),
         "a deadline expiring while queued ends TIMED_OUT")
    eng = engine(n_slots=1, macro_step=1)
    rep = eng.run(reqs(1, MAX_NEW, {"r0": dict(deadline_s=0.1)}),
                  now_fn=tick_clock(5e-3))
    r0 = rep.requests[0]
    dl["decoding"] = dict(state=r0.state.value, reason=r0.reason,
                          tokens=len(r0.tokens),
                          free_slots=eng.pool.free_count)
    gate(r0.state.value == "TIMED_OUT" and "decoding" in (r0.reason or "")
         and 0 < len(r0.tokens) < MAX_NEW and eng.pool.free_count == 1
         and toks(r0) == want("r0", len(r0.tokens)),
         "a deadline passing while decoding ends TIMED_OUT and frees the "
         "slot")
    eng = engine(n_slots=1, queue_limit=1)
    rep = eng.run(reqs(4, 4), now_fn=lambda: 0.0)
    dl["queue_full"] = dict(states=rep.state_counts(),
                            reasons=[r.reason for r in rep.requests])
    gate(rep.state_counts() == {"COMPLETED": 1, "REJECTED": 3}
         and all(r.reason == "queue_full" for r in rep.requests
                 if r.state.value == "REJECTED"),
         "queue_limit rejects the overflow as queue_full")
    n0 = len(rt.ledger.entries)
    eng = engine(n_slots=2)
    rep = eng.run(reqs(2, 4, {"r1": dict(deadline_s=1e-12)}),
                  now_fn=lambda: 0.0)
    shed = [e for e in rt.ledger.entries[n0:] if e.site == "serve_admit"]
    dl["infeasible"] = dict(states=rep.state_counts(),
                            reason=rep.requests[1].reason,
                            serve_admit=[(e.choice, e.predicted_s)
                                         for e in shed])
    gate(rep.requests[1].reason == "deadline_infeasible"
         and rep.requests[1].state.value == "REJECTED"
         and any(e.choice == "shed" for e in shed)
         and rep.requests[0].state.value == "COMPLETED",
         "an infeasible deadline is shed as deadline_infeasible with a "
         "serve_admit row")
    out["deadlines"] = dl
    log("lifecycle", f"deadlines: {dl} ({card})")
    del eng

    # --- the fault classes on one dense engine, each followed by phase 5's
    # trace on the same engine
    eng = engine()
    drills = [("raise macro", FaultSpec("raise", site="macro", after=1),
               None, 2),
              ("stall macro", FaultSpec("stall", site="macro", after=1,
                                        stall_s=30.0), STALL_WATCHDOG_S, 2),
              ("raise prefill", FaultSpec("raise", site="prefill", after=0),
               None, 2),
              ("nan macro", FaultSpec("nan", site="macro", after=0), None,
               2),
              ("exhausted", FaultSpec("raise", site="macro", after=0,
                                      count=100), None, 1)]
    faults = {}
    for label, spec, watchdog, retries in drills:
        eng.injector = FaultInjector((spec,))
        eng.watchdog_s, eng.max_retries = watchdog, retries
        t0 = time.perf_counter()
        with StartedThreads() as threads:
            rep = eng.run(reqs(DRILL_REQUESTS, DRILL_NEW),
                          now_fn=lambda: 0.0)
        wall = time.perf_counter() - t0
        states = rep.state_counts()
        faults[label] = dict(states=states, retries=rep.step_retries,
                             watchdog_fires=rep.watchdog_fires,
                             threads_started=len(threads.names),
                             reasons=sorted({r.reason for r in rep.requests
                                             if r.reason}),
                             injected=eng.injector.injected, wall_s=wall)
        if label == "nan macro":
            ok = (states == {"COMPLETED": DRILL_REQUESTS - 1, "FAILED": 1}
                  and drill_clean(rep)
                  and all("corrupt" in (r.reason or "") for r in
                          rep.requests if r.state.value == "FAILED"))
        elif label == "exhausted":
            ok = (states == {"FAILED": DRILL_REQUESTS}
                  and all("macro step failed" in r.reason
                          for r in rep.requests)
                  and eng.pool.free_count == SLOTS)
        else:
            ok = (states == {"COMPLETED": DRILL_REQUESTS}
                  and rep.step_retries >= 1 and drill_clean(rep)
                  and (watchdog is None or (rep.watchdog_fires >= 1
                                            and threads.names)))
        log("lifecycle", f"fault {label}: states {states}, retries "
            f"{rep.step_retries}, watchdog fires {rep.watchdog_fires}, "
            f"threads {len(threads.names)}, {wall:.2f} s ({card})")
        gate(ok, f"fault {label} behaves as its class says")
        serve_again(eng, f"fault {label}")
    del eng
    eng = engine(paged=True, block_size=PAGE)
    eng.injector = FaultInjector((FaultSpec("raise", site="macro", after=0,
                                            fatal=True),))
    rs = reqs(DRILL_REQUESTS, DRILL_NEW)
    try:
        eng.run(rs, now_fn=lambda: 0.0)
        raised = False
    except FatalFault:
        raised = True
    blocks = eng.pool.blocks
    faults["fatal paged"] = dict(
        raised=raised, states=sorted({r.state.value for r in rs}),
        used_blocks=blocks.used_blocks, trie_blocks=blocks.trie_blocks,
        free_slots=eng.pool.free_count)
    log("lifecycle", f"fault fatal (paged): {faults['fatal paged']}")
    gate(raised and all(r.state.terminal for r in rs)
         and blocks.used_blocks == 0 and blocks.trie_blocks == 0
         and eng.pool.free_count == SLOTS,
         "a fatal fault propagates and leaves the BlockPool empty")
    serve_again(eng, "fault fatal paged")
    out["faults"] = faults
    del eng

    # --- the guarded call runs the same kernels as the direct call, on a
    # worker thread under the caller's device, stream and grad mode (a
    # parameter that needs a gradient, served under no_grad)
    guarded = {}
    leaf = params["unembed"]
    for how in ("dense", "paged"):
        paging = dict(paged=True, block_size=PAGE) if how == "paged" else {}
        eng = engine(**PIN, **paging)
        seen = []
        main_stream = torch.cuda.current_stream().cuda_stream
        real_prefill, real_macro = eng._prefill, eng._macro(PIN["macro_step"])

        def spy(fn):
            def wrapped(*a):
                first, st = fn(*a)
                seen.append(dict(
                    thread=threading.current_thread().name,
                    grad=torch.is_grad_enabled(),
                    requires_grad=first.requires_grad,
                    device=torch.cuda.current_device(),
                    stream=torch.cuda.current_stream().cuda_stream))
                return first, st
            return wrapped

        eng._prefill = spy(real_prefill)
        eng._macro_fns[PIN["macro_step"]] = spy(real_macro)
        runs = {}
        leaf.requires_grad_(True)
        try:
            for mode, wd in (("direct", None), ("guarded", 5.0)):
                eng.watchdog_s = wd
                seen.clear()
                torch.cuda.synchronize()
                mm_launches.reset()
                with torch.no_grad(), StartedThreads() as threads:
                    rep = eng.run(reqs(DRILL_REQUESTS, DRILL_NEW),
                                  now_fn=lambda: 0.0)
                torch.cuda.synchronize()
                runs[mode] = dict(
                    by_path=dict(mm_launches.by_path),
                    launches=mm_launches.count,
                    threads_started=len(threads.names),
                    workers=sorted({s["thread"] for s in seen}),
                    grad=any(s["grad"] for s in seen),
                    requires_grad=any(s["requires_grad"] for s in seen),
                    same_stream=all(s["stream"] == main_stream
                                    for s in seen),
                    same_device=all(s["device"] == torch.cuda.current_device()
                                    for s in seen),
                    tokens_equal=drill_clean(rep)
                    and rep.state_counts() == {"COMPLETED": DRILL_REQUESTS})
        finally:
            leaf.requires_grad_(False)
        guarded[how] = runs
        d, g = runs["direct"], runs["guarded"]
        log("lifecycle", f"guarded vs direct ({how}): matmul launches by "
            f"path {g['by_path']} vs {d['by_path']}; threads started "
            f"{g['threads_started']} vs {d['threads_started']}; on the "
            f"worker: grad {g['grad']}, output requires grad "
            f"{g['requires_grad']}, same stream {g['same_stream']}, same "
            f"device {g['same_device']}; tokens equal {g['tokens_equal']}, "
            f"{d['tokens_equal']}")
        gate(g["by_path"] == d["by_path"] and g["launches"] > 0
             and g["threads_started"] > 0 and d["threads_started"] == 0
             and "MainThread" not in g["workers"]
             and not g["grad"] and not g["requires_grad"]
             and g["same_stream"] and g["same_device"]
             and g["tokens_equal"] and d["tokens_equal"],
             f"the guarded step ({how}) runs the direct step's kernels on "
             f"a worker under the caller's stream and grad mode")
        del eng
    out["guarded"] = guarded

    # --- abandonment: a step that ignores cancellation outlives the grace
    # join, then writes into the pools it captured
    eng = engine(paged=True, block_size=PAGE, **PIN)
    k = PIN["macro_step"]
    real = eng._macro(k)
    woke, checked = threading.Event(), threading.Event()
    worker = []

    def pools(state):
        return [leaf_ for path, leaf_ in leaves_with_paths(state["layers"])
                if is_page_pool(path)]

    def hung(params_, state, *args):
        worker.append(threading.current_thread())
        time.sleep(1.5)
        for p_ in pools(state):
            p_.fill_(7.0)
        torch.cuda.synchronize()
        woke.set()
        checked.wait(30.0)
        return real(params_, state, *args)

    eng._macro_fns[k] = hung
    eng.watchdog_s = 0.5
    before = pools(eng.pool.state)
    rep = eng.run(reqs(DRILL_REQUESTS, DRILL_NEW), now_fn=lambda: 0.0)
    after = pools(eng.pool.state)
    woke.wait(30.0)
    try:
        torch.cuda.synchronize()
        old_written = all(bool((b == 7).all()) for b in before)
        new_untouched = all(not bool(a.any()) for a in after)
    finally:
        checked.set()
        if worker:
            worker[0].join(60.0)
    torch.cuda.synchronize()
    ab = dict(states=rep.state_counts(), reasons=sorted(
        {r.reason for r in rep.requests}), watchdog_fires=rep.watchdog_fires,
        new_tensors=all(a.data_ptr() != b.data_ptr()
                        for a, b in zip(after, before)),
        old_pools_written=old_written, new_pools_untouched=new_untouched,
        used_blocks=eng.pool.blocks.used_blocks)
    eng._macro_fns[k] = real
    eng.watchdog_s = None
    again = eng.run(reqs(DRILL_REQUESTS, DRILL_NEW), now_fn=lambda: 0.0)
    ab["next_trace_equal"] = drill_clean(again) and \
        again.state_counts() == {"COMPLETED": DRILL_REQUESTS}
    out["abandoned"] = ab
    log("lifecycle", f"abandonment: {ab} ({card})")
    gate(ab["states"] == {"FAILED": DRILL_REQUESTS}
         and all("abandon" in r for r in ab["reasons"])
         and ab["new_tensors"] and ab["old_pools_written"]
         and ab["new_pools_untouched"] and ab["used_blocks"] == 0
         and ab["next_trace_equal"],
         "an abandoned step fails what is in flight and cannot reach the "
         "drained pool")
    del eng, before, after

    # --- stopping: a stop mid-run drains the active slots, rejects the queue
    eng = engine()
    eng.stop_event = TripAfter(1)
    rep = eng.run(reqs(SLOTS + 2, DRILL_NEW), now_fn=lambda: 0.0)
    stop = dict(states=rep.state_counts(),
                reasons={r.rid: r.reason for r in rep.requests})
    out["stop"] = stop
    log("lifecycle", f"stop mid-run: {stop}")
    gate(rep.state_counts() == {"COMPLETED": SLOTS, "REJECTED": 2}
         and drill_clean(rep)
         and all(r.reason == "shutdown: intake stopped"
                 for r in rep.requests if r.state.value == "REJECTED"),
         "a stop mid-run completes the active slots and rejects the queue")
    del eng
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "tinyllama-1.1b", "--requests", "8", "--max-new", "16",
           "--slots", "4", "--engine", "continuous", "--deadline-ms",
           "60000", "--inject-fault", "raise", "--watchdog-ms", "5000"]
    t0 = time.perf_counter()
    ls = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                        cwd=ROOT, env=dict(os.environ,
                                           PYTHONPATH=str(ROOT / "src")))
    states_line = [ln.strip() for ln in ls.stdout.splitlines()
                   if ln.strip().startswith("states ")]
    out["launcher"] = dict(cmd=" ".join(cmd[1:]), rc=ls.returncode,
                           wall_s=time.perf_counter() - t0,
                           states=states_line, stdout=ls.stdout[-3000:],
                           stderr=ls.stderr[-2000:])
    log("lifecycle", f"launcher: exit {ls.returncode} in "
        f"{out['launcher']['wall_s']:.1f} s; {states_line}")
    gate(ls.returncode == 0 and states_line
         and "retries 1" in states_line[0]
         and "'COMPLETED': 8" in states_line[0],
         "the launcher exits 0 and prints the lifecycle report")

    # --- recorded: overload on the real clock (the reference stress
    # bench's recipe, without its front end)
    kw = dict(model=model, params=params, slots=SLOTS, eos_id=-1,
              max_len=max_len)
    unloaded = rt.serve(cfg, trace(), **kw)
    rep_u = unloaded.report
    lat = [r.latency_s for r in rep_u.requests if r.latency_s is not None]
    mean_latency = float(np.mean(lat))
    service_rate = REQUESTS / rep_u.wall_s
    deadline_ms = DEADLINE_X * mean_latency * 1e3
    rate = OVERLOAD_FACTOR * service_rate
    over = rt.serve(cfg, synthetic_trace(
        OVERLOAD_REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="poisson", rate=rate, seed=1),
        queue_limit=2 * SLOTS, deadline_ms=deadline_ms,
        watchdog_ms=max(5000.0, 10 * deadline_ms), **kw)
    rep_o = over.report
    done = [r for r in rep_o.requests if r.state.value == "COMPLETED"]
    goodput = sum(len(r.tokens) for r in done) / rep_o.wall_s
    ttft = rep_o.ttft_percentiles()
    out["overload"] = dict(
        unloaded_tok_per_s=rep_u.tok_per_s, unloaded_mean_latency_s=mean_latency,
        service_rate_rps=service_rate, rate_rps=rate, deadline_ms=deadline_ms,
        queue_limit=2 * SLOTS, states=rep_o.state_counts(),
        completed_frac=len(done) / OVERLOAD_REQUESTS,
        goodput_tok_per_s=goodput,
        goodput_over_unloaded=goodput / rep_u.tok_per_s,
        ttft_p99_s=ttft["ttft_p99"],
        ttft_p99_over_unloaded_latency=ttft["ttft_p99"] / mean_latency,
        watchdog_fires=rep_o.watchdog_fires, wall_s=rep_o.wall_s,
        all_terminal=rep_o.all_terminal)
    log("lifecycle", f"overload (recorded): {out['overload']} ({card})")
    gate(rep_o.all_terminal and done,
         "overload: every request terminal, at least one completed")
    del unloaded, over

    # --- recorded: serve_admit with and without the correction loop, on a
    # calibrated runtime (phase 5's calibration cache), one warm trace first
    cache = ROOT / "build" / "calibration"
    probe_rt = Runtime(RuntimeConfig(device="cuda", calibrate=True,
                                     cache_dir=cache))
    sched = ServeScheduler(cfg, probe_rt.engine, max_len=max_len)
    _, raw = sched.serve_admit(Request("d0", prompts["r0"], MAX_NEW,
                                       deadline_s=1.0),
                               now=0.0, active=0, n_slots=SLOTS)
    deadline_s = 3.0 * raw.baseline.total  # admits unless corrected > 3x
    admit = {"raw_predicted_s": raw.baseline.total,
             "deadline_s": deadline_s}
    for corr in (False, True):
        crt = Runtime(RuntimeConfig(device="cuda", calibrate=True,
                                    corrections=corr, cache_dir=cache))
        crt.serve(cfg, trace(), **kw)  # the warm trace
        n0 = len(crt.ledger.entries)
        res = crt.serve(cfg, [Request("d0", prompts["r0"], MAX_NEW,
                                      deadline_s=deadline_s)], **kw)
        rows = [e for e in crt.ledger.entries[n0:]
                if e.site == "serve_admit"]
        d0 = res.report.requests[0]
        factors = ({s: crt.engine.corrections.factor(s)
                    for s in crt.engine.corrections.sites()}
                   if crt.engine.corrections is not None else {})
        admit["on" if corr else "off"] = dict(
            verdicts=[e.choice for e in rows],
            predicted_s=[e.predicted_s for e in rows],
            corrections=[e.correction for e in rows],
            measured_latency_s=d0.latency_s, state=d0.state.value,
            reason=d0.reason, site_factors=factors)
    admit["flipped"] = admit["off"]["verdicts"][-1:] != \
        admit["on"]["verdicts"][-1:]
    out["serve_admit"] = admit
    log("lifecycle", f"serve_admit (recorded): {admit} ({card})")

    out["ledger"] = ledger_rows(rt.ledger)
    del model, params
    torch.cuda.empty_cache()

    # --- rwkv6-3b, full width, 4 layers: a raise drill (gated) and a
    # preemption drill (recorded: re-prefill runs the chunked WKV kernel
    # over the generated tokens where decode ran wkv_step)
    rcfg4 = dataclasses.replace(rcfg, n_layers=4)
    rmodel = build_model(rcfg4, rt.device)
    rparams = rmodel.init(0)
    rkw = dict(n_slots=SLOTS, max_len=max_len, eos_id=-1,
               cost_engine=rt.engine)

    def rreqs(n, new, extra=None):
        extra = extra or {}
        return [Request(f"r{i}", prompts[f"r{i}"], new,
                        **extra.get(f"r{i}", {})) for i in range(n)]

    clean_eng = ContinuousServeEngine(rmodel, rparams, **rkw)
    clean = {r.rid: toks(r) for r in clean_eng.run(
        rreqs(SLOTS + 1, MAX_NEW), now_fn=lambda: 0.0).requests}
    reng = ContinuousServeEngine(rmodel, rparams, **rkw, injector=FaultInjector(
        (FaultSpec("raise", site="macro", after=1),)))
    rep = reng.run(rreqs(SLOTS, MAX_NEW), now_fn=lambda: 0.0)
    rw = dict(raise_states=rep.state_counts(), raise_retries=rep.step_retries,
              raise_equal=all(toks(r) == clean[r.rid] for r in rep.requests))
    gate(rep.state_counts() == {"COMPLETED": SLOTS} and rep.step_retries >= 1
         and rw["raise_equal"],
         "rwkv6-3b: a raise retries to the clean tokens")
    peng = ContinuousServeEngine(rmodel, rparams, **rkw)
    rep = peng.run(rreqs(SLOTS + 1, MAX_NEW,
                         {f"r{SLOTS}": dict(arrival_s=0.003, priority=5)}),
                   now_fn=tick_clock())
    first_diff = {}
    for r in rep.requests:
        got = toks(r)
        diff = next((i for i, (a, b) in enumerate(zip(got, clean[r.rid]))
                     if a != b), None)
        first_diff[r.rid] = diff
    rw.update(preempt_states=rep.state_counts(),
              preempt_victims=[r.rid for r in rep.requests if r.preemptions],
              preempt_first_diff=first_diff,
              preempt_equal={r.rid: first_diff[r.rid] is None
                             for r in rep.requests})
    out["rwkv"] = rw
    log("lifecycle", f"rwkv6-3b, 4 layers: {rw} ({card})")
    gate(rep.all_terminal, "rwkv6-3b preemption: every request terminal")
    del rmodel, rparams, clean_eng, reng, peng
    torch.cuda.empty_cache()

    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    log("lifecycle", f"phase 16 wall {out['wall_s']:.1f} s; "
        f"{len(fails)} failed gates ({card})")
    return None if fails else out


def compute_pids() -> list:
    """Pids nvidia-smi lists as holding a CUDA context on the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [int(x) for x in smi.stdout.split()]


def card_pci() -> tuple:
    """(the card's PCI address as torch reads it, as nvidia-smi prints it,
    the NUMA node sysfs gives that PCI function; None where sysfs has no
    such file)."""
    props = torch.cuda.get_device_properties(0)
    addr = (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
            f"{props.pci_device_id:02x}.0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    path = Path(f"/sys/bus/pci/devices/{addr}/numa_node")
    try:
        node = int(path.read_text())
    except (OSError, ValueError):
        node = None
    return addr, smi.stdout.strip(), node


def frontend_phase(cfg, p1_want, phase5_syncs, calibration, mm_launches,
                   card):
    """Phase 17: the multi-process front end on full-width tinyllama-1.1b
    (bf16, seed 0, 4 slots, phase 5's trace and max_len) through
    Runtime.serve(frontend=2, pin=True, stream=True), dense and paged, the
    respawn drills, the launcher with --workers/--pin; the host's layout,
    spawn and respawn times, IPC counts, tok/s in-process, unpinned and
    pinned, serve_ipc's "auto" verdict and overload through the front end
    recorded.  The calling thread's CPU mask is restored on the way out.
    None on any failed gate."""
    import multiprocessing as mp

    saved_mask = os.sched_getaffinity(0)
    try:
        return _frontend_phase(cfg, p1_want, phase5_syncs, calibration,
                               mm_launches, card, mp)
    finally:
        os.sched_setaffinity(0, saved_mask)


def _frontend_phase(cfg, p1_want, phase5_syncs, calibration, mm_launches,
                    card, mp):
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.serving import Request
    from repro_torch.serving.frontend import (FrontendConfig,
                                              ServingFrontend, discover,
                                              plan_affinity)

    t_phase = time.perf_counter()
    out: dict = {"card": card}
    fails = []

    def gate(ok: bool, what: str) -> bool:
        if not ok:
            fails.append(what)
            log("frontend", f"FAIL: {what}")
        return ok

    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)
    max_len = PROMPT + MAX_NEW
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    kw = dict(model=model, params=params, slots=SLOTS, eos_id=-1)
    want = {r: [int(t) for t in v] for r, v in p1_want.items()}
    subs = [dict(rid=r.rid, prompt=[int(t) for t in r.prompt],
                 max_new_tokens=r.max_new_tokens) for r in trace()]

    def toks(rep):
        return {r.rid: [int(t) for t in r.tokens] for r in rep.requests}

    def served(res) -> dict:
        rep = res.report
        t = toks(rep)
        return dict(
            tok_per_s=res.tok_per_s, host_syncs=rep.host_syncs,
            states=rep.state_counts(), tokens_equal_phase5=t == want,
            texts_equal=res.texts == {r: " ".join(map(str, v))
                                      for r, v in t.items()},
            stream_equal=res.stream is not None and all(
                res.stream.tokens(r) == v for r, v in t.items()),
            ipc_messages=rep.ipc_messages, ipc_bytes=rep.ipc_bytes,
            frontend_workers=rep.frontend_workers,
            frontend_respawns=rep.frontend_respawns,
            streamed_tokens=rep.streamed_tokens,
            stream_events=rep.stream_events)

    # --- the host: its layout, the plan, the card's PCI function and node
    topo = discover()
    plan = plan_affinity(topo, FE_WORKERS + 1)
    bus, smi_bus, node = card_pci()
    node_of = {c.cpu: c.node for c in topo.cpus}
    out["host"] = dict(
        topology=topo.describe(), source=topo.source,
        cpu_mask=sorted(os.sched_getaffinity(0)),
        plan_engine_cpus=sorted(plan.engine_cpus),
        plan_worker_cpus=[sorted(m) for m in plan.worker_cpus],
        plan_nodes=sorted({node_of[c] for c in plan.engine_cpus}),
        pci_address=bus, pci_bus_id_smi=smi_bus, card_numa_node=node,
        ipc_round_trip_s=calibration.get("ipc_round_trip_s"),
        ipc_bytes_per_s=calibration.get("ipc_bytes_per_s"))
    log("frontend", f"host {topo.describe()}, mask {len(out['host']['cpu_mask'])}"
        f" cpus; plan: engine {out['host']['plan_engine_cpus']} (node "
        f"{out['host']['plan_nodes']}), workers "
        f"{out['host']['plan_worker_cpus']}; card {bus} on NUMA node {node}; "
        f"calibrated ipc_round_trip_s {out['host']['ipc_round_trip_s']}, "
        f"ipc_bytes_per_s {out['host']['ipc_bytes_per_s']} ({card})")

    # --- in process, streamed, twice: the first run of a phase may pay a
    # one-off synchronizing call (phase 15), so the front end is held to
    # the second run's syncs
    first, first_cuda = count_syncs(lambda: rt.serve(
        cfg, trace(), stream=True, **kw))
    inproc, in_cuda = count_syncs(lambda: rt.serve(cfg, trace(), stream=True,
                                                   **kw))
    out["in_process"] = {**served(inproc), "cuda_syncs": in_cuda,
                         "first_run": dict(tok_per_s=first.tok_per_s,
                                           cuda_syncs=first_cuda)}
    del first

    # --- the front end, pinned, dense; the kernel's launches from 0
    torch.cuda.synchronize()
    mm_launches.reset()
    n0 = len(rt.ledger.entries)
    dense, fe_cuda = count_syncs(lambda: rt.serve(
        cfg, trace(), frontend=FE_WORKERS, pin=True, stream=True, **kw))
    torch.cuda.synchronize()
    launches = mm_launches.count
    ipc = [e for e in rt.ledger.entries[n0:] if e.site == "serve_ipc"]
    out["dense"] = {**served(dense), "cuda_syncs": fe_cuda,
                    "matmul_launches": launches,
                    "mask_after": sorted(os.sched_getaffinity(0)),
                    "serve_ipc": ledger_rows(rt.ledger, ("serve_ipc",))[
                        -len(ipc):] if ipc else []}
    d = out["dense"]
    log("frontend", f"dense, frontend={FE_WORKERS} pinned, streamed: "
        f"{d['tok_per_s']:.2f} tok/s (in process {inproc.tok_per_s:.2f}, "
        f"first run {out['in_process']['first_run']['tok_per_s']:.2f} with "
        f"{first_cuda} synchronizing CUDA calls); "
        f"tokens == phase 5 {d['tokens_equal_phase5']}, texts "
        f"{d['texts_equal']}, stream {d['stream_equal']}; host syncs "
        f"{d['host_syncs']} (phase 5 {phase5_syncs}); synchronizing CUDA "
        f"calls {fe_cuda} (in process, streamed {in_cuda}); IPC "
        f"{d['ipc_messages']} messages, {d['ipc_bytes']} bytes; matmul "
        f"launches {launches}; serve_ipc rows "
        f"{[(e.query.get('op'), e.choice, e.predicted_s, e.measured_s, e.note) for e in ipc]} ({card})")
    gate(d["tokens_equal_phase5"] and d["texts_equal"] and d["stream_equal"]
         and d["frontend_workers"] == FE_WORKERS and launches > 0,
         "dense front end: phase 5's tokens, texts and stream")
    gate(d["host_syncs"] == phase5_syncs and fe_cuda == in_cuda,
         "dense front end: phase 5's host syncs, the in-process run's CUDA "
         "syncs")
    gate({e.query.get("op") for e in ipc if e.measured_s is not None}
         == {"workers", "coalesce"},
         "both serve_ipc ops have predicted and measured rows")
    gate(out["in_process"]["tokens_equal_phase5"],
         "in process, streamed: phase 5's tokens")

    # --- the front end, pinned, paged
    paged, paged_cuda = count_syncs(lambda: rt.serve(
        cfg, trace(), frontend=FE_WORKERS, pin=True, stream=True, paged=True,
        block_size=PAGE, **kw))
    out["paged"] = {**served(paged), "cuda_syncs": paged_cuda}
    p = out["paged"]
    log("frontend", f"paged (pages of {PAGE}), frontend={FE_WORKERS} pinned,"
        f" streamed: {p['tok_per_s']:.2f} tok/s; tokens == phase 5 "
        f"{p['tokens_equal_phase5']}, texts {p['texts_equal']}, stream "
        f"{p['stream_equal']}; host syncs {p['host_syncs']}; synchronizing "
        f"CUDA calls {paged_cuda}; IPC {p['ipc_messages']} messages, "
        f"{p['ipc_bytes']} bytes ({card})")
    gate(p["tokens_equal_phase5"] and p["texts_equal"] and p["stream_equal"]
         and p["host_syncs"] == phase5_syncs,
         "paged front end: phase 5's tokens, texts, stream and host syncs")

    # --- frontend="auto": the verdict, against the intake measured above
    sched = dense.engine.scheduler
    rows = [e for e in ipc if e.query.get("op") == "workers"]
    w, dec = sched.serve_ipc_workers(
        REQUESTS, msg_bytes=rows[0].query["msg_bytes"] if rows else 0,
        prompt_len=PROMPT)
    out["auto"] = dict(
        workers=w, choice=dec.choice, predicted_s=dec.predicted_s,
        alternatives={a.strategy: a.total for a in dec.alternatives},
        measured_intake_s=[e.measured_s for e in rows],
        measured_workers=FE_WORKERS)
    log("frontend", f'frontend="auto" verdict (recorded): {out["auto"]} '
        f"({card})")

    # --- the respawn drill (the reference chaos bench's): intake workers
    # killed and healed, the emission worker killed and its log replayed;
    # no worker may hold a CUDA context
    pids_before = compute_pids()
    fe = ServingFrontend(FrontendConfig(workers=FE_WORKERS, pin=True,
                                        respawn=2), max_len=max_len)
    fe.start()
    try:
        kids = {p.pid for p in fe._intake_procs} | {fe._emit_proc.pid}
        pids_during = compute_pids()
        drill = dict(spawn_s=fe.spawn_s, ping_round_trips_s=list(
            fe.ping_round_trips_s), engine_pinned=fe.engine_pinned,
            workers_pinned=fe.workers_pinned,
            engine_mask=sorted(os.sched_getaffinity(0)))
        ok, bad = fe.submit(subs)
        fe.kill_intake_workers()
        ok2, bad2 = fe.submit(subs)
        intake_respawns = fe.respawns
        stream = fe.stream()
        stream.publish("b0", (11, 12), False, 0.0)
        stream.publish("b1", (21,), False, 0.0)
        fe.kill_emission_worker()
        stream.publish("b0", (13,), True, 0.1)  # respawn + replay here
        stream.publish("b1", (22,), True, 0.1)
        kids |= {p.pid for p in fe._intake_procs} | {fe._emit_proc.pid}
        pids_respawned = compute_pids()
        transcript = fe.finish()
        drill.update(
            validated=[len(ok), len(ok2)], failures=[bad, bad2],
            intake_respawns=intake_respawns, respawns=fe.respawns,
            respawn_s=list(fe.respawn_s), workers_pinned_after=fe.workers_pinned,
            transcript={r: v["tokens"] for r, v in transcript.items()},
            ipc_messages=fe.ipc_messages, ipc_bytes=fe.ipc_bytes,
            compute_pids=dict(before=pids_before, during=pids_during,
                              respawned=pids_respawned, parent=os.getpid(),
                              workers=sorted(kids)))
    finally:
        fe.close()
    out["drill"] = drill
    log("frontend", f"respawn drill: spawn to first pong {drill['spawn_s']:.3f}"
        f" s, respawns {drill['respawns']} in "
        f"{[round(s, 3) for s in drill['respawn_s']]} s, engine pinned "
        f"{drill['engine_pinned']} to {drill['engine_mask']}, workers pinned "
        f"{drill['workers_pinned']}; nvidia-smi compute pids "
        f"{drill['compute_pids']} ({card})")
    gate(drill["validated"] == [REQUESTS, REQUESTS]
         and not any(drill["failures"])
         and intake_respawns == FE_WORKERS
         and drill["respawns"] == FE_WORKERS + 1
         and drill["transcript"] == {"b0": [11, 12, 13], "b1": [21, 22]},
         "respawn drill: intake healed, the emission transcript replayed")
    gate(not kids & set(pids_during + pids_respawned)
         and len(pids_during) == len(pids_respawned) == len(pids_before),
         "while the workers live, only the parent holds a CUDA context")

    # --- respawn=0: a killed emission worker fails what is in flight; the
    # same engine then serves phase 5's trace again, through an unpinned
    # front end (its tok/s: the front end unpinned)
    eng = dense.engine
    coalesce = max((int(e.choice.rsplit("c", 1)[1]) for e in ipc
                    if e.query.get("op") == "coalesce"), default=1)
    fe0 = ServingFrontend(FrontendConfig(workers=FE_WORKERS, respawn=0),
                          max_len=max_len)
    fe0.start()
    try:
        eng.stream = fe0.stream()
        fe0.kill_emission_worker()
        rep0 = eng.run([Request(r.rid, r.prompt, DRILL_NEW)
                        for r in trace()[:DRILL_REQUESTS]],
                       now_fn=lambda: 0.0)
    finally:
        eng.stream = None
        fe0.close()
    fe1 = ServingFrontend(FrontendConfig(workers=FE_WORKERS,
                                         coalesce=coalesce),
                          max_len=max_len)
    fe1.start()
    try:
        ok, bad = fe1.submit(subs)
        eng.stream = fe1.stream()
        rep1 = eng.run(trace())
        eng.stream.close()
        transcript = fe1.finish()
    finally:
        eng.stream = None
        fe1.close()
    out["no_respawn"] = dict(
        states=rep0.state_counts(),
        reasons=sorted({r.reason for r in rep0.requests}),
        again_states=rep1.state_counts(),
        again_tokens_equal_phase5=toks(rep1) == want,
        again_transcript_equal={r: v["tokens"] for r, v in
                                transcript.items()} == toks(rep1),
        unpinned_tok_per_s=rep1.tok_per_s, coalesce=coalesce,
        validated=len(ok), failures=bad)
    n = out["no_respawn"]
    log("frontend", f"respawn=0, emission worker killed: {n['states']} "
        f"{n['reasons']}; the same engine again through an unpinned front "
        f"end: {n['again_states']}, tokens == phase 5 "
        f"{n['again_tokens_equal_phase5']}, transcript "
        f"{n['again_transcript_equal']}, {n['unpinned_tok_per_s']:.2f} tok/s "
        f"({card})")
    gate(n["states"] == {"FAILED": DRILL_REQUESTS}
         and all("frontend stream broken" in (r or "") for r in n["reasons"]),
         "respawn=0: a dead emission worker fails what is in flight")
    gate(n["again_tokens_equal_phase5"] and n["again_transcript_equal"]
         and n["validated"] == REQUESTS and not n["failures"],
         "respawn=0: the same engine then serves phase 5's trace")
    out["tok_per_s"] = dict(in_process=inproc.tok_per_s,
                            unpinned=rep1.tok_per_s, pinned=dense.tok_per_s)
    del eng, paged, dense

    # --- the launcher: --workers 2 --pin --stream
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "tinyllama-1.1b", "--requests", "4", "--max-new", "8", "--slots",
           "4", "--engine", "continuous", "--eos-id", "-1", "--workers",
           str(FE_WORKERS), "--pin", "--stream"]
    t0 = time.perf_counter()
    ls = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                        cwd=ROOT, env=dict(os.environ,
                                           PYTHONPATH=str(ROOT / "src")))
    lines = [ln.strip() for ln in ls.stdout.splitlines()
             if ln.strip().startswith(("states ", "frontend: "))]
    out["launcher"] = dict(cmd=" ".join(cmd[1:]), rc=ls.returncode,
                           wall_s=time.perf_counter() - t0, lines=lines,
                           stdout=ls.stdout[-3000:], stderr=ls.stderr[-2000:])
    log("frontend", f"launcher: exit {ls.returncode} in "
        f"{out['launcher']['wall_s']:.1f} s; {lines}")
    gate(ls.returncode == 0 and "states {'COMPLETED': 4}" in lines
         and any(ln.startswith(f"frontend: {FE_WORKERS} intake")
                 for ln in lines),
         "the launcher with --workers --pin --stream exits 0")

    # --- recorded: phase 16's overload recipe through the front end (the
    # reference stress bench's own), unloaded = the in-process run above
    base_rep = inproc.report
    lat = [r.latency_s for r in base_rep.requests if r.latency_s is not None]
    del inproc
    mean_latency = float(np.mean(lat))
    service_rate = REQUESTS / base_rep.wall_s
    deadline_ms = DEADLINE_X * mean_latency * 1e3
    rate = OVERLOAD_FACTOR * service_rate
    over = rt.serve(cfg, synthetic_trace(
        OVERLOAD_REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="poisson", rate=rate, seed=1),
        queue_limit=2 * SLOTS, deadline_ms=deadline_ms,
        watchdog_ms=max(5000.0, 10 * deadline_ms), frontend=FE_WORKERS,
        stream=True, max_len=max_len, **kw)
    rep_o = over.report
    done = [r for r in rep_o.requests if r.state.value == "COMPLETED"]
    goodput = sum(len(r.tokens) for r in done) / rep_o.wall_s
    ttft = rep_o.ttft_percentiles()
    out["overload"] = dict(
        unloaded_tok_per_s=base_rep.tok_per_s,
        unloaded_mean_latency_s=mean_latency, service_rate_rps=service_rate,
        rate_rps=rate, deadline_ms=deadline_ms, queue_limit=2 * SLOTS,
        states=rep_o.state_counts(), completed_frac=len(done) /
        OVERLOAD_REQUESTS, goodput_tok_per_s=goodput,
        goodput_over_unloaded=goodput / base_rep.tok_per_s,
        ttft_p99_s=ttft["ttft_p99"],
        ttft_p99_over_unloaded_latency=ttft["ttft_p99"] / mean_latency,
        ipc_messages=rep_o.ipc_messages, ipc_bytes=rep_o.ipc_bytes,
        wall_s=rep_o.wall_s, all_terminal=rep_o.all_terminal)
    log("frontend", f"overload through the front end (recorded): "
        f"{out['overload']} ({card})")
    gate(rep_o.all_terminal and done,
         "overload: every request terminal, at least one completed")
    del over, model, params
    torch.cuda.empty_cache()

    alive = mp.active_children()
    gate(not alive, f"every front end closed, its workers joined: {alive}")
    out["wall_s"] = time.perf_counter() - t_phase
    out["fails"] = fails
    log("frontend", f"phase 17 wall {out['wall_s']:.1f} s; "
        f"{len(fails)} failed gates ({card})")
    return None if fails else out


if __name__ == "__main__":
    # torch is imported here, not with the module: the front end's spawned
    # workers (phase 17) re-import this file, and need none of it
    import torch

    sys.exit(main())
