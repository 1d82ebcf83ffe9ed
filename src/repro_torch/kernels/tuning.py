"""Per-kernel-family tuning on Hopper: pruned candidate spaces and the
tuned-config lookup behind ``kernels/ops.py``.

One section per kernel family the tuner searches (matmul, bitonic sort,
WKV).  Each builds the space the autotuner (``core/costs/autotune.py``)
measures:

  * every candidate is a build the kernel has: a tile width its entry
    point takes, a chunk it is instantiated for, a sort tile and group its
    static_asserts admit;
  * every candidate passes the shared-memory filter: the dynamic shared
    memory of a CTA, from the formula its kernel module exports, within
    ``hw.vmem_bytes`` (227 KB on an H100);
  * every candidate carries an analytic cost (the prior) used to order
    the search and as the ledger's "predicted" value: a roofline time on
    the Runtime's ``HardwareSpec``, divided by how well its CTAs fill the
    132 SMs in waves.

Each family's prior config is the kernel's fixed choice: ``matmul.tile_n(n)``,
the sort's 2^14 tile and group of 6, WKV's chunk of 64.  With measurement
off (the default) the tuner answers with exactly these, so a default
Runtime launches every kernel as the kernels did before the tuner.  Flash
attention has one instantiation per (dtype, hd), so it has no family: a
second instantiation would bring one.

A config is keyed by what each row of a call has, never by how many rows
the call has: the matmul by (path, out dtype, N, K), WKV by (H, N, dtype,
needs a gradient).  So a row's bits do not depend on the rows batched
with it, and static and continuous serving agree.  The sort's rows are
independent arrays, and its config never changes their bits.

Each runner holds its candidate's output against the prior's before it is
timed: the sort bit for bit, the matmul within ``MATMUL_TOL`` (bf16 8e-3,
fp32 1e-5 x max|prior|), WKV within ``WKV_F32_TOL`` x max|prior| (bf16
gradients within 8e-3 x their row's max + 1e-5 x max); a candidate
outside them raises, which the tuner records as failed.

The kernel entry points find a tuner through ``resolve``: the one passed,
else the one this thread runs under (``using``: a Runtime's ``serve`` and
``train``), else ``FIXED``, which answers every lookup with its family's
prior and reads no cache.  A repeat lookup is one dict hit on a tuple key
(``Autotuner.alias``), built before any string is formatted.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from repro_torch.core.costs.autotune import (
    Autotuner,
    Candidate,
    TuneResult,
    TuneSpec,
    cuda_event_bench,
)
from repro_torch.hw import H100, HardwareSpec
from repro_torch.kernels import build

N_SM = 132  # streaming multiprocessors of an H100 SXM
SM_SMEM = 233_472  # bytes of shared memory an SM holds (228 KB)
SM_REGS = 65_536  # 32-bit registers an SM holds
MATMUL_TUNE_M = 2048  # the prefill and training rows a tile is timed at
MATMUL_DECODE_M = 4  # the decode rows a tile is timed at as well
MATMUL_TOL = {torch.bfloat16: 8e-3, torch.float32: 1e-5}  # x max|prior|
WKV_F32_TOL = 1e-4  # x max|prior|
WKV_TUNE_B, WKV_TUNE_S = 2, 2048  # the batch and tokens a chunk is timed at
SORT_TILES = (13, 14, 15)  # log2 of the sort tiles searched
SORT_GROUPS = (5, 6)  # global-pass groups searched
SORT_MAX_CANDIDATES = 4


class _FixedPriors(Autotuner):
    """Answers every spec with its prior, from no cache and with no
    measurement: the kernels' fixed choices, for a call made with no tuner
    in scope."""

    def tune(self, spec: TuneSpec) -> TuneResult:
        memo = self._memo.get(spec.key)
        if memo is None:
            memo = self._memo[spec.key] = self._prior_result(spec)
        return memo


FIXED = _FixedPriors()
_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


@contextlib.contextmanager
def using(tuner: Autotuner):
    """Route this thread's kernel lookups to ``tuner`` inside the block (a
    Runtime's ``serve`` and ``train`` run under their own; a serving
    engine's watchdog worker is handed its caller's)."""
    stack = _stack()
    stack.append(tuner)
    try:
        yield tuner
    finally:  # this block's own entry, whatever was pushed after it
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is tuner:
                del stack[i]
                break


def active() -> Optional[Autotuner]:
    """The tuner this thread runs under, if any."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None


def recompute_contexts():
    """``context_fn`` for ``torch.utils.checkpoint`` (non-reentrant): the
    recomputation runs on autograd's worker thread, which has no tuner of
    its own, so it runs under the one the forward ran under, and launches
    with the forward's configs."""
    tuner = active()
    return contextlib.nullcontext(), (
        using(tuner) if tuner is not None else contextlib.nullcontext())


def resolve(tuner: Optional[Autotuner] = None) -> Autotuner:
    """Injected tuner wins; else this thread's innermost ``using``; else
    ``FIXED`` (never a Runtime: calibration's probes launch kernels while
    the default Runtime is being built)."""
    if tuner is not None:
        return tuner
    tuner = active()
    return tuner if tuner is not None else FIXED


def _hw(tuner: Autotuner) -> HardwareSpec:
    return getattr(tuner, "hw", None) or H100


def vmem_budget(hw: HardwareSpec = H100) -> int:
    """Shared memory one CTA may have (the filter's bound)."""
    return int(hw.vmem_bytes)


@functools.lru_cache(maxsize=None)
def library_hash(name: str) -> str:
    """The hash in the name of ``csrc/<name>.cu``'s library: a tuned config
    is kept for this build of the kernel only."""
    return build.library_path(name).stem.rsplit("-", 1)[1]


def _fill(ctas: int, per_sm: int) -> float:
    """The share of the card's CTA slots a launch of ``ctas`` keeps busy
    over its waves (one CTA an SM or more where ``per_sm`` fit): below one
    wave the idle SMs, above it the last wave's empty slots."""
    ctas = max(1, ctas)
    if ctas < N_SM:
        return ctas / N_SM
    slots = N_SM * max(1, per_sm)
    return ctas / (math.ceil(ctas / slots) * slots)


def _per_sm(threads: int, smem: int, regs_per_thread: int = 0) -> int:
    """Resident CTAs an SM by threads, shared memory and registers."""
    by_regs = SM_REGS // (threads * regs_per_thread) if regs_per_thread \
        else 32
    return max(1, min(2048 // threads, SM_SMEM // (smem + 1024), by_regs))


def _spec_key(family: str, parts, lib: str, hw: HardwareSpec) -> str:
    return f"{family}/{'/'.join(map(str, parts))}/lib-{library_hash(lib)}" \
        f"/hw-{hw.name}"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _tune(t: Autotuner, alias, spec_fn) -> TuneResult:
    """The memo under ``alias`` (a tuple), else ``spec_fn()``'s tune,
    memoized under the alias as well."""
    hit = t.peek(alias)
    if hit is not None:
        return hit
    return t.alias(alias, t.tune(spec_fn()))


# ---------------------------------------------------------------------------
# Matmul
# ---------------------------------------------------------------------------


def _matmul_prior_s(m: int, n: int, k: int, path: str, tile: int,
                    a_bytes: int, b_bytes: int, out_bytes: int,
                    hw: HardwareSpec) -> float:
    """Roofline of one product at tile width ``tile``: the tensor cores'
    operations (twice on the split path, hi and lo), A read once per
    column of tiles and B once per row of 128-row tiles, over the share of
    the SMs the CTAs fill (two CTAs an SM on the tensor-core path, one on
    the split path; the FMA kernel's own tiling)."""
    from repro_torch.kernels import matmul as mm

    if path == "fma":
        compute = 2.0 * m * n * k / hw.peak_flops_f32
        memory = (4 * (m * k + k * n) + out_bytes * m * n) / hw.hbm_bw
        return max(compute, memory) + hw.kernel_launch_s
    passes = 2 if path == "split" else 1
    compute = 2.0 * m * n * k * passes / hw.peak_flops_bf16
    memory = (a_bytes * m * k * math.ceil(n / tile)
              + b_bytes * k * n * math.ceil(m / 128)
              + out_bytes * m * n) / hw.hbm_bw
    ctas = math.ceil(m / 128) * math.ceil(n / tile)
    per_sm = _per_sm(288, mm.tc_smem_bytes(tile, path == "split"))
    return max(compute, memory) / _fill(ctas, per_sm) + hw.kernel_launch_s


def matmul_candidates(path: str, n: int, k: int, a_dtype: torch.dtype,
                      b_dtype: torch.dtype, out_dtype: torch.dtype,
                      *, hw: HardwareSpec = H100
                      ) -> Tuple[dict, Tuple[Candidate, ...]]:
    """(prior, candidates): ``{"tile_n": t}`` for every tile width the
    tensor-core kernel is built for whose CTA fits, one candidate (the
    prior) on the FMA path, which has no tile to choose.  A candidate's
    cost is what its runner times: one product at ``MATMUL_TUNE_M`` rows
    plus as many at ``MATMUL_DECODE_M`` as the prior takes for one at
    ``MATMUL_TUNE_M``."""
    from repro_torch.kernels import matmul as mm

    sizes = [torch.empty((), dtype=d).element_size()
             for d in (a_dtype, b_dtype, out_dtype)]
    prior = {"tile_n": mm.tile_n(n)}
    tiles = mm.TILES if path != "fma" else (prior["tile_n"],)

    def cost(m, tile):
        return _matmul_prior_s(m, n, k, path, tile, *sizes, hw)

    weight = cost(MATMUL_TUNE_M, prior["tile_n"]) / cost(MATMUL_DECODE_M,
                                                          prior["tile_n"])
    cands = []
    for tile in tiles:
        smem = mm.tc_smem_bytes(tile, path == "split") if path != "fma" \
            else 0
        if smem > vmem_budget(hw):
            continue
        cands.append(Candidate({"tile_n": tile}, cost(MATMUL_TUNE_M, tile)
                               + weight * cost(MATMUL_DECODE_M, tile), smem))
    return prior, tuple(cands)


def _matmul_runner(n, k, a_dtype, b_dtype, out_dtype, prior, state, config):
    """Time ``matmul_cuda`` with this tile at ``MATMUL_TUNE_M`` rows once
    and at ``MATMUL_DECODE_M`` rows ``w`` times, ``w`` the prior tile's
    time at the first over its time at the second: each counts by its
    time relative to the prior's, so a tile that wins at prefill and
    training rows and loses at decode rows is not taken for free.  Each
    output is held against the prior tile's on the same operands first."""
    from repro_torch.kernels import matmul as mm

    def launch(a, tile):
        return mm.matmul_cuda(a, state["b"], out_dtype=out_dtype, tile=tile)

    if "a" not in state:
        gen = torch.Generator(device="cuda").manual_seed(0)
        state["a"] = torch.randn((MATMUL_TUNE_M, k), generator=gen,
                                 device="cuda").to(a_dtype)
        state["a_decode"] = state["a"][:MATMUL_DECODE_M]
        state["b"] = (torch.randn((k, n), generator=gen, device="cuda")
                      * k ** -0.5).to(b_dtype)
        tile = prior["tile_n"]
        state["want"] = [launch(state[x], tile).float()
                         for x in ("a", "a_decode")]
        state["w"] = max(1, round(
            cuda_event_bench(lambda: launch(state["a"], tile), 5)
            / cuda_event_bench(lambda: launch(state["a_decode"], tile), 5)))
    a, a_decode, w, tile = state["a"], state["a_decode"], state["w"], \
        config["tile_n"]
    for x, want in zip((a, a_decode), state["want"]):
        err = (launch(x, tile).float() - want).abs().max().item()
        limit = MATMUL_TOL[out_dtype] * want.abs().max().item()
        if not err <= limit:
            raise ValueError(f"tile {tile} at {x.shape[0]} rows: max abs "
                             f"err {err:.3e} from the prior tile's output, "
                             f"limit {limit:.3e}")

    def run():
        launch(a, tile)
        for _ in range(w):
            launch(a_decode, tile)

    return run


def tune_matmul(a_dtype: torch.dtype, b_dtype: torch.dtype,
                out_dtype: torch.dtype, n: int, k: int, *,
                tuner: Optional[Autotuner] = None) -> TuneResult:
    """The tile for a product of (M, K) ``a_dtype`` by (K, N) ``b_dtype``
    into ``out_dtype``, whatever M: keyed by (path, out dtype, N, K), never
    by M, so a row's tile (and bits) do not depend on the rows beside it."""
    from repro_torch.kernels import matmul as mm

    t = resolve(tuner)
    path = mm.choose_path(a_dtype, b_dtype)

    def spec():
        hw = _hw(t)
        prior, cands = matmul_candidates(path, n, k, a_dtype, b_dtype,
                                         out_dtype, hw=hw)
        runner = None if path == "fma" else functools.partial(
            _matmul_runner, n, k, a_dtype, b_dtype, out_dtype, prior, {})
        return TuneSpec(
            "matmul", _spec_key("matmul", (path, _dtype_name(out_dtype),
                                           f"n{n}", f"k{k}"), "matmul", hw),
            prior, cands, make_runner=runner,
            query=(("path", path), ("shape", f"{MATMUL_TUNE_M}x{n}x{k}"),
                   ("decode_rows", MATMUL_DECODE_M),
                   ("dtypes", f"{_dtype_name(a_dtype)}x"
                              f"{_dtype_name(b_dtype)}->"
                              f"{_dtype_name(out_dtype)}")))

    return _tune(t, ("matmul", path, out_dtype, n, k), spec)


def matmul_tile(a_dtype: torch.dtype, b_dtype: torch.dtype,
                out_dtype: torch.dtype, n: int, k: int,
                tuner: Optional[Autotuner] = None) -> int:
    """The tile width ``ops.matmul`` launches this product with: on a
    repeat, one dict hit on a tuple of the call's dtypes, N and K."""
    t = resolve(tuner)
    key = ("matmul", a_dtype, b_dtype, out_dtype, n, k)
    hit = t.peek(key)
    if hit is None:
        hit = t.alias(key, tune_matmul(a_dtype, b_dtype, out_dtype, n, k,
                                       tuner=t))
    return hit.config["tile_n"]


# ---------------------------------------------------------------------------
# Bitonic sort
# ---------------------------------------------------------------------------


def _sort_prior_s(rows: int, n: int, log_tile: int, log_group: int,
                  dtype_bytes: int, hw: HardwareSpec) -> float:
    """One read and one write of the array a pass, over the share of the
    SMs the pass's blocks fill, plus a launch a pass: the block passes'
    tiles (resident blocks an SM by threads, registers at 64 a thread, and
    shared memory), the global passes' 256-thread blocks of 2^group
    elements a thread."""
    from repro_torch.kernels import bitonic_sort as bs

    total = rows * n
    tile = 1 << log_tile
    sweep = 2.0 * total * dtype_bytes / hw.hbm_bw
    threads = tile >> bs.LOG_E
    block_per_sm = _per_sm(threads, bs.smem_bytes(log_tile, dtype_bytes), 64)
    block_fill = _fill(math.ceil(total / min(tile, total)), block_per_sm)
    global_fill = _fill(math.ceil(total / (256 << log_group)),
                        _per_sm(256, 0, 2 << log_group))
    t = 0.0
    for kind, _ in bs.passes(n, tile, log_group):
        fill = block_fill if kind == "block" else global_fill
        t += sweep / fill + hw.kernel_launch_s
    log2n = max(math.log2(max(n, 2)), 1.0)
    compute = total * log2n * (log2n + 1) / 2 / hw.peak_flops_f32
    return max(t, compute)


def sort_candidates(rows: int, n: int, dtype_bytes: int,
                    *, hw: HardwareSpec = H100
                    ) -> Tuple[dict, Tuple[Candidate, ...]]:
    """``n`` is the padded (power-of-two) row length the kernel sees.
    Tiles 2^13 to 2^15 and groups 5 and 6 that the kernel's static_asserts
    and shared memory admit, ``SORT_MAX_CANDIDATES`` of them: the prior
    (the port's own 2^14 and 6), then for each other tile its best group
    by analytic cost (so every tile is timed), then the best of the rest."""
    from repro_torch.kernels import bitonic_sort as bs

    prior = {"log_tile": bs.LOG_TILE, "log_group": bs.LOG_GROUP}
    cands = []
    for lt in SORT_TILES:
        for lg in SORT_GROUPS:
            smem = bs.smem_bytes(lt, dtype_bytes)
            if not bs.config_ok(lt, lg) or smem > vmem_budget(hw):
                continue
            cands.append(Candidate({"log_tile": lt, "log_group": lg},
                                   _sort_prior_s(rows, n, lt, lg,
                                                 dtype_bytes, hw), smem))
    ranked = sorted(cands, key=lambda c: c.prior_s)
    chosen = [c for c in cands if c.config == prior]
    for lt in SORT_TILES:
        chosen += [c for c in ranked if c.config["log_tile"] == lt
                   and all(o.config["log_tile"] != lt for o in chosen)][:1]
    chosen += [c for c in ranked if c not in chosen]
    return prior, tuple(chosen[:SORT_MAX_CANDIDATES])


def _sort_runner(rows, n, dtype, configs, prior, state, config):
    """Time the sort built with this tile and group, after building every
    candidate's library together and holding this one's output bit for bit
    against the prior build's on the same input."""
    from repro_torch.kernels import bitonic_sort as bs

    if "x" not in state:
        build.build_jobs([("bitonic_sort", bs.defines(**c))
                          for c in configs])
        gen = torch.Generator(device="cuda").manual_seed(0)
        state["x"] = (torch.randn((rows, n), generator=gen, device="cuda")
                      * 1e4).to(dtype)
        state["want"] = bs.bitonic_sort_cuda(state["x"], prior["log_tile"],
                                             prior["log_group"])
    x, lt, lg = state["x"], config["log_tile"], config["log_group"]
    if not torch.equal(bs.bitonic_sort_cuda(x, lt, lg), state["want"]):
        raise ValueError(f"tile 2^{lt}, group {lg}: output differs from the "
                         f"prior build's")
    return lambda: bs.bitonic_sort_cuda(x, lt, lg)


def tune_sort(rows: int, n: int, dtype: torch.dtype, *,
              tuner: Optional[Autotuner] = None) -> TuneResult:
    """The sort's (tile, group) for ``rows`` rows of padded length ``n``;
    the candidates' libraries are built only when measuring."""
    t = resolve(tuner)

    def spec():
        hw = _hw(t)
        size = torch.empty((), dtype=dtype).element_size()
        prior, cands = sort_candidates(rows, n, size, hw=hw)
        return TuneSpec(
            "sort", _spec_key("sort", (f"{rows}x{n}", _dtype_name(dtype)),
                              "bitonic_sort", hw),
            prior, cands, make_runner=functools.partial(
                _sort_runner, rows, n, dtype, [c.config for c in cands],
                prior, {}),
            query=(("shape", f"{rows}x{n}"), ("dtype", _dtype_name(dtype))))

    return _tune(t, ("sort", rows, n, dtype), spec)


def sort_config(rows: int, n: int, dtype: torch.dtype,
                tuner: Optional[Autotuner] = None) -> Tuple[int, int]:
    """(log2 of the tile, group) ``ops.sort`` launches with."""
    c = tune_sort(rows, n, dtype, tuner=tuner).config
    return c["log_tile"], c["log_group"]


# ---------------------------------------------------------------------------
# WKV (chunked linear recurrence)
# ---------------------------------------------------------------------------


def _wkv_prior_s(bh: int, s: int, n: int, chunk: int, x_bytes: int,
                 grad: bool, hw: HardwareSpec) -> float:
    """The forward's two passes (the backward's take about twice as long):
    the state pass, one CTA per (b h, 16 value columns) walking its
    ceil(S / chunk) chunks in order, each a rank-``chunk`` update read from
    the chunk's rows at an SM's share of the card, in waves; then the per-chunk
    pass, one CTA per (b h, chunk), the pairwise chunk x chunk x N and the
    state read chunk x N x N on the FP32 pipe, its chunk-start states
    written and read once, over the share of the SMs its CTAs fill."""
    from repro_torch.kernels import wkv as wkv_k

    dtype = torch.bfloat16 if x_bytes == 2 else torch.float32
    smem = wkv_k.smem_bytes(dtype, chunk, n)
    nc = math.ceil(s / chunk)
    sm_flops, sm_bw = hw.peak_flops_f32 / N_SM, hw.hbm_bw / N_SM
    step = max(4.0 * chunk * n * 16 / sm_flops,
               chunk * (n * (x_bytes + 4) + 16 * x_bytes) / sm_bw)
    state_per_sm = _per_sm(128, smem["wkv_state forward"])
    state = nc * step * math.ceil(bh * (n // 16) / (N_SM * state_per_sm))
    flops = bh * nc * (2.0 * chunk * chunk * n + 4.0 * chunk * n * n)
    bytes_ = bh * s * n * (3 * x_bytes + 8) + 2.0 * bh * nc * n * n * 4
    chunk_pass = max(flops / hw.peak_flops_f32, bytes_ / hw.hbm_bw) / _fill(
        bh * nc, 2)
    fwd = state + chunk_pass + 2 * hw.kernel_launch_s
    return fwd * (3.0 if grad else 1.0)


def wkv_candidates(h: int, n: int, dtype: torch.dtype, grad: bool,
                   *, hw: HardwareSpec = H100
                   ) -> Tuple[dict, Tuple[Candidate, ...]]:
    """Every chunk the kernels are instantiated for (``wkv.CHUNKS``) whose
    kernels' shared memory fits a CTA, costed at ``WKV_TUNE_B`` x ``h``
    heads of ``WKV_TUNE_S`` tokens; the prior is 64."""
    from repro_torch.kernels import wkv as wkv_k

    size = torch.empty((), dtype=dtype).element_size()
    cands = []
    for chunk in wkv_k.CHUNKS:
        smem = max(wkv_k.smem_bytes(dtype, chunk, n).values())
        if smem > vmem_budget(hw):
            continue
        cands.append(Candidate({"chunk": chunk}, _wkv_prior_s(
            WKV_TUNE_B * h, WKV_TUNE_S, n, chunk, size, grad, hw), smem))
    return {"chunk": 64}, tuple(cands)


def _wkv_held(got, want, scale=None) -> float:
    """|got - want| over its limit, the largest element's (fp32 within
    ``WKV_F32_TOL`` x max|want| or x ``scale``; bf16 within 8e-3 x the
    row's max|want| + 1e-5 x max|want|)."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    top = mag.max().item() if scale is None else scale
    if want.dtype == torch.bfloat16:
        limit = MATMUL_TOL[torch.bfloat16] * mag.amax(-1, keepdim=True) \
            + MATMUL_TOL[torch.float32] * top
    else:
        limit = torch.full_like(mag, WKV_F32_TOL * top)
    return (diff / limit.clamp(min=1e-30)).max().item()


def _wkv_runner(h, n, dtype, grad, state, config):
    """Time the WKV forward (and, for a call that needs a gradient, the
    forward keeping its chunk-start states and the backward) at this chunk
    on (1, ``WKV_TUNE_S``, ``WKV_TUNE_B`` x ``h``, N) inputs, after holding
    every output against the prior chunk's."""
    from repro_torch.kernels import wkv as wkv_k

    def run(chunk):
        r, k, v, logw, u, do = state["inputs"]
        out, final, starts = wkv_k.wkv_fwd_cuda(r, k, v, logw, u, chunk,
                                                keep_states=grad)
        if not grad:
            return out, final
        return (out, final) + wkv_k.wkv_bwd_cuda(r, k, v, logw, u, starts,
                                                 do, None, chunk)

    if "inputs" not in state:
        gen = torch.Generator(device="cuda").manual_seed(0)
        bh, shape = WKV_TUNE_B * h, (1, WKV_TUNE_S, WKV_TUNE_B * h, n)

        def randn(*shp):
            return torch.randn(shp, generator=gen, device="cuda")

        logw = -torch.exp(-2.0 + 0.5 * randn(*shape))
        k = randn(*shape) * (1.0 - torch.exp(logw))
        state["inputs"] = (randn(*shape).to(dtype), k.to(dtype),
                           randn(*shape).to(dtype), logw, 0.1 * randn(bh, n),
                           randn(*shape))
        state["want"] = run(64)
    got, want = run(config["chunk"]), state["want"]
    r, k = state["inputs"][:2]
    scale = None
    if grad:  # dlogw: a difference of sums of terms the size of r dr, k dk
        scale = max(want[5].abs().max().item(),
                    (r.float() * want[2].float()).abs().max().item(),
                    (k.float() * want[3].float()).abs().max().item())
    for i, (g, w) in enumerate(zip(got, want)):
        ratio = _wkv_held(g, w, scale if i == 5 else None)
        if not (torch.isfinite(g).all() and ratio <= 1.0):
            raise ValueError(f"chunk {config['chunk']}: output {i} at "
                             f"{ratio:.2f} x its limit from the prior's")
    chunk = config["chunk"]
    return lambda: run(chunk)


def tune_wkv(h: int, n: int, dtype: torch.dtype, grad: bool, *,
             tuner: Optional[Autotuner] = None) -> TuneResult:
    """WKV's chunk for H heads of head size N, whatever the batch and the
    tokens: keyed by what each row has, so a row's bits do not depend on
    the rows batched with it or on their lengths.  ``grad`` when the call
    keeps its chunk-start states for a backward (four times the memory at
    chunk 16 as at 64)."""
    t = resolve(tuner)

    def spec():
        hw = _hw(t)
        prior, cands = wkv_candidates(h, n, dtype, grad, hw=hw)
        return TuneSpec(
            "wkv", _spec_key("wkv", (f"h{h}", f"n{n}", _dtype_name(dtype),
                                     f"g{int(grad)}"), "wkv", hw),
            prior, cands, make_runner=functools.partial(
                _wkv_runner, h, n, dtype, grad, {}),
            query=(("shape", f"{WKV_TUNE_B}x{WKV_TUNE_S}x{h}x{n}"),
                   ("dtype", _dtype_name(dtype)), ("grad", grad)))

    return _tune(t, ("wkv", h, n, dtype, grad), spec)


def wkv_chunk(h: int, n: int, dtype: torch.dtype, grad: bool,
              tuner: Optional[Autotuner] = None) -> int:
    """The chunk ``ops.wkv`` launches with."""
    return tune_wkv(h, n, dtype, grad, tuner=tuner).config["chunk"]
