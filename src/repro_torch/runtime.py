"""The public Runtime: one explicit session object owning the device, the
CostEngine (hardware spec, calibration cache, decision cache) and the
overhead ledger.

    import repro_torch

    rt = repro_torch.Runtime()                    # on the GPU (the default)
    rt = repro_torch.Runtime(device="cpu")        # plain PyTorch on the CPU
    rt = repro_torch.Runtime(repro_torch.RuntimeConfig(calibrate=True))

    plan   = rt.plan(cfg, shape)              # overhead-driven layer plan
    result = rt.train(cfg, loop, steps=100)   # training loop + checkpoints
    served = rt.serve(cfg, trace)             # continuous batching
    print(rt.ledger.report())                 # every decision, pred-vs-meas

Two Runtimes are fully isolated: separate engines, decision caches and
ledgers.  The entry points run on ``cuda`` unless the caller asks for the
CPU; a Runtime asked for a card that is not there raises, it does not fall
back to the CPU.  ``default_runtime()`` is a lazily built session
configured from the environment (``RuntimeConfig.from_env()``); the port's
decision sites never fall back to it, a Runtime passes its own engine to
everything it drives.  Meshes (planning, training or serving over several
GPUs), ``Runtime.bench`` and the robustness and multi-process front-end
options of the reference's ``Runtime.serve`` come with later slices of the
port.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.costs.engine import CostEngine
from repro_torch.core.costs.ledger import OverheadLedger
from repro_torch.hw import H100, HardwareSpec


# ---------------------------------------------------------------------------
# RuntimeConfig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Typed construction parameters for a :class:`Runtime`.

    ``device``     — where the session runs: ``"cuda"`` (default, an NVIDIA
                     GPU) or ``"cpu"``.
    ``calibrate``  — microbenchmark the card into the hardware spec on
                     construction (needs ``device`` on CUDA).
    ``cache_dir``  — home of the calibration JSON cache (default
                     ``build/calibration`` in the repository).
    ``hardware``   — base :class:`HardwareSpec` for the analytic model
                     (default: the H100 data sheet).  Calibration replaces
                     measured fields on top of it.

    The reference's autotune, mesh, correction-loop and drift knobs come
    with the slices that port those subsystems.
    """

    device: Optional[str] = None
    calibrate: bool = False
    cache_dir: Optional[Path] = None
    hardware: Optional[HardwareSpec] = None

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None,
                 **overrides: Any) -> "RuntimeConfig":
        """The one place the ``REPRO_*`` environment variables are read,
        for the fields the port has: ``REPRO_CALIBRATE=1`` -> calibrate,
        ``REPRO_COST_CACHE`` -> cache_dir.  ``env`` defaults to
        ``os.environ``; keyword overrides win over it."""
        env = os.environ if env is None else env
        cache = env.get("REPRO_COST_CACHE")
        fields: Dict[str, Any] = {
            "calibrate": env.get("REPRO_CALIBRATE") == "1",
            "cache_dir": Path(cache) if cache else None,
        }
        fields.update(overrides)
        return cls(**fields)


# ---------------------------------------------------------------------------
# Result records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainResult:
    """What :meth:`Runtime.train` ran and produced."""

    state: Any  # final {"params", "opt", "step", ...} tree
    start_step: int
    steps_run: int
    wall_s: float
    final_loss: float
    plan: Any  # core.planner.Plan for the launch shape
    diverged: bool = False  # loss went non-finite; loop aborted
    interrupted: bool = False  # should_stop() fired; checkpointed + exited


@dataclasses.dataclass
class ServeResult:
    """One trace run through :meth:`Runtime.serve` (either mode)."""

    mode: str  # "static" | "continuous"
    wall_s: float
    generated_tokens: int
    tok_per_s: float
    p50_s: float
    p95_s: float
    outputs: Dict[str, np.ndarray]  # rid -> generated tokens
    report: Any = None  # serving.ServeReport (continuous mode)
    engine: Any = None  # the serve engine, reusable for follow-up traces
    stream: Any = None  # serving.frontend.TokenStream (when streaming)


def synthetic_trace(n_requests: int, *, prompt_len: int, max_new: int,
                    vocab_size: int, arrival: str = "staggered",
                    gap_ms: float = 20.0, rate: float = 50.0,
                    seed: int = 0, prefix_share: float = 0.0,
                    prefix_len: int = 0) -> List[Any]:
    """Deterministic request trace: random prompts from numpy's generator
    and an arrival process (``all`` at t=0, ``staggered`` every
    ``gap_ms``, or ``poisson`` at ``rate``/s) — the same prompts and
    arrivals as the reference's builder for the same arguments.

    ``prefix_share`` > 0 makes that fraction of the requests (the first
    ``round(prefix_share * n)``) open with ONE fixed random prefix of
    ``prefix_len`` tokens followed by private random suffixes: the
    system-prompt traffic the radix prefix cache exists for."""
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    prompts = rng.integers(
        1, vocab_size, (n_requests, prompt_len)).astype(np.int32)
    if prefix_share:
        if not 0.0 < prefix_share <= 1.0:
            raise ValueError(
                f"prefix_share must be in (0, 1], got {prefix_share}")
        if not 0 < prefix_len < prompt_len:
            raise ValueError(
                f"prefix_len must be in (0, prompt_len={prompt_len}), "
                f"got {prefix_len}")
        shared = rng.integers(1, vocab_size, (prefix_len,)).astype(np.int32)
        prompts[: int(round(prefix_share * n_requests)), :prefix_len] = shared
    if arrival == "all":
        arrivals = np.zeros(n_requests)
    elif arrival == "staggered":
        arrivals = np.arange(n_requests) * (gap_ms / 1e3)
    elif arrival == "poisson":
        gaps = rng.exponential(1.0 / rate, n_requests)
        arrivals = np.cumsum(gaps) - gaps[0]
    else:
        raise ValueError(f"unknown arrival process: {arrival!r}")
    return [Request(f"r{i}", prompts[i], max_new, arrival_s=float(arrivals[i]))
            for i in range(n_requests)]


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` means the GPU.  Asking for a GPU that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs an NVIDIA GPU (CUDA) and found none: "
            "torch.cuda.is_available() is False.  Pass device='cpu' to run "
            "the plain PyTorch path on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------


class Runtime:
    """An explicit repro_torch session: device + engine + caches + ledger.

    ``device`` (or ``config.device``) picks the device, the GPU by default.
    Construction is cheap unless ``config.calibrate`` is set (then the card
    is microbenchmarked once, cached under ``config.cache_dir``).
    ``engine`` injects a prebuilt CostEngine (tests)."""

    def __init__(self, config: Optional[RuntimeConfig] = None, *,
                 device: Optional[str] = None,
                 engine: Optional[CostEngine] = None):
        self.config = config if config is not None else RuntimeConfig()
        self.device = resolve_device(
            device if device is not None else self.config.device)
        if self.device.type == "cuda":
            # fp32 products in full fp32: the port's fp32 numbers are checked
            # against the reference and the CPU at fp32 tolerance, and TF32
            # keeps only about three decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if engine is None:
            base = self.config.hardware if self.config.hardware is not None \
                else H100
            if self.config.calibrate:
                engine = CostEngine.calibrated(
                    base, cache_dir=self.config.cache_dir,
                    device=str(self.device))
            else:
                engine = CostEngine(hw=base)
        self.engine = engine

    @property
    def hw(self) -> HardwareSpec:
        """The hardware spec the analytic model runs on."""
        return self.engine.hw

    @property
    def ledger(self) -> OverheadLedger:
        """THE overhead ledger of this session."""
        return self.engine.ledger

    def plan(self, cfg, shape, mesh_shape: Optional[Dict[str, int]] = None):
        """Overhead-driven layer plan for ``cfg`` at ``shape`` on this
        runtime's engine (every decision ledgered).  The port runs on one
        device, so the default mesh is ``{"data": 1, "model": 1}``."""
        from repro_torch.core.planner import plan_model

        return plan_model(cfg, shape, mesh_shape or {"data": 1, "model": 1},
                          engine=self.engine)

    def train(self, cfg, loop=None, *, steps: int = 200, batch: int = 8,
              seq: int = 64, seed: int = 0, ckpt_dir: Optional[str] = None,
              ckpt_every: int = 50, resume: bool = False,
              step_timeout: float = 0.0, log_every: int = 10,
              log: Callable[[str], None] = print,
              should_stop: Optional[Callable[[], bool]] = None,
              on_plan: Optional[Callable[[Any], None]] = None) -> TrainResult:
        """Run the training loop for ``cfg`` on this runtime's device.

        ``seed`` drives both parameter init and the synthetic data stream
        (step-indexed, so ``resume`` replays deterministically).
        ``should_stop`` is polled once per step; when it fires, the loop
        checkpoints (if ``ckpt_dir``) and returns with ``interrupted=True``
        (the hook launchers attach SIGTERM to).  ``on_plan`` sees the
        overhead plan before the first step.  The host waits for the
        device once per step, on the loss.  Each step writes its update
        into the state it was given (``make_train_step(donate=True)``,
        the same values as the functional update): the loop keeps only
        the newest state, and the functional update's second copy of
        parameters and moments (30.7 GB for rwkv6-3b) would take a
        full-width step to the edge of an 80 GB card.
        """
        from repro_torch.checkpoint import latest_step, restore, save
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.data import SyntheticLMData
        from repro_torch.models import build_model
        from repro_torch.training import (TrainLoopConfig, init_train_state,
                                          make_train_step)

        if loop is None:
            loop = TrainLoopConfig(warmup_steps=max(steps // 20, 1),
                                   total_steps=steps)
        model = build_model(cfg, self.device)
        plan = self.plan(cfg, ShapeSpec("cli_train", seq, batch, "train"))
        if on_plan is not None:
            on_plan(plan)

        ds = SyntheticLMData(cfg, seq_len=seq, global_batch=batch, seed=seed,
                             device=str(self.device))
        state = init_train_state(model, seed, loop)
        start = 0
        if resume and ckpt_dir:
            last = latest_step(ckpt_dir)
            if last is not None:
                state = restore(ckpt_dir, last, state)
                start = int(state["step"])
                log(f"resumed from step {start}")

        step_fn = make_train_step(model, loop, donate=True)
        t_start = time.time()
        loss = float("nan")
        for i in range(start, steps):
            t0 = time.time()
            state, metrics = step_fn(state, ds.batch_at(i))
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            if step_timeout and dt > step_timeout:
                log(f"[straggler] step {i} took {dt:.2f}s "
                    f"(> {step_timeout}s); continuing")
            if log_every and (i % log_every == 0 or i == steps - 1):
                log(f"step {i:5d} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            if not np.isfinite(loss):
                log("loss is not finite; aborting")
                return TrainResult(state, start, i + 1 - start,
                                   time.time() - t_start, loss, plan,
                                   diverged=True)
            stop = bool(should_stop is not None and should_stop())
            if ckpt_dir and (stop or (i + 1) % ckpt_every == 0
                             or i == steps - 1):
                save(ckpt_dir, i + 1, state)
            if stop:
                log(f"interrupted{': checkpointed' if ckpt_dir else ''} "
                    f"step {i + 1}, exiting")
                return TrainResult(state, start, i + 1 - start,
                                   time.time() - t_start, loss, plan,
                                   interrupted=True)
        # a resume past the requested step count runs zero steps, not -N
        return TrainResult(state, start, max(steps - start, 0),
                           time.time() - t_start, loss, plan)

    def serve(self, cfg, trace, *, mode: str = "continuous", model=None,
              params=None, seed: int = 0, slots: int = 4,
              max_len: Optional[int] = None, eos_id: int = 0,
              pad_id: Optional[int] = None, prefill_chunk="auto",
              macro_step="auto", warmup: bool = True, paged: bool = False,
              block_size: int = 16, kv_blocks: Optional[int] = None,
              prefix_cache="auto", stream="auto",
              now_fn=time.perf_counter) -> ServeResult:
        """Run a request ``trace`` (a list of ``repro_torch.Request``).

        ``continuous`` is the slot-pooled engine scheduled by this
        runtime's CostEngine (admission / prefill-chunk / macro-horizon
        decisions land as ``site=serve``/``site=serve_macro`` ledger rows
        with measured step times).  ``macro_step``: ``"auto"`` lets the
        CostEngine pick K per composition, an int pins it.

        Paged KV (continuous mode only): ``paged=True`` stores
        full-attention KV in a shared BlockPool of ``block_size``-token
        pages (``kv_blocks`` overrides the can-never-run-out default) with
        per-slot block tables, and ``prefix_cache`` controls radix prefix
        reuse at admission (``"auto"``: the serve_prefix CostQuery decides
        per prompt; ``"force"`` pins reuse on; ``False`` keeps no trie).
        ``stream`` attaches a per-request incremental token stream fed at
        the macro-step boundaries the engine already synchronizes on (no
        added device syncs): ``True`` makes a ``TokenStream``, an instance
        is used as it is, ``"auto"`` is off (the port has no front end to
        turn it on); ``ServeResult.stream`` holds it.

        ``static`` is the lockstep baseline: the batch forms at the last
        arrival and every request's latency includes that wait; it requires
        equal-length prompts.  ``params=None`` initializes parameters from
        ``seed``; ``max_len=None`` sizes slots to the largest
        prompt+generation in the trace.
        """
        from repro_torch.models import build_model
        from repro_torch.serving import ContinuousServeEngine, ServeEngine
        from repro_torch.serving.engine import emitted_count
        from repro_torch.serving.frontend import TokenStream

        if not trace:
            raise ValueError("serve() needs a non-empty trace of Requests")
        if mode not in ("static", "continuous"):
            raise ValueError(f"unknown serve mode: {mode!r}")
        if mode == "static" and paged:
            raise ValueError(
                "paged KV needs the slot pool of mode='continuous'; the "
                "static lockstep baseline keeps dense per-row caches")
        if mode == "static" and stream not in ("auto", False, None):
            raise ValueError(
                "token streaming needs the macro-step boundaries of "
                "mode='continuous'; the static baseline emits one matrix")
        if paged and block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if model is None:
            model = build_model(cfg, self.device)
        if params is None:
            params = model.init(seed)
        if max_len is None:
            max_len = max(r.prompt_len + r.max_new_tokens for r in trace)

        if mode == "static":
            engine = ServeEngine(model, params, max_len=max_len,
                                 eos_id=eos_id, pad_id=pad_id)
            prompts = np.stack([np.asarray(r.prompt, np.int64) for r in trace])
            max_new = max(r.max_new_tokens for r in trace)
            if warmup:
                engine.generate(prompts, max_new_tokens=min(2, max_new))
            start = max(r.arrival_s for r in trace)
            t0 = time.perf_counter()
            out = engine.generate(prompts, max_new_tokens=max_new)
            wall = time.perf_counter() - t0
            outputs = {r.rid: out[i, :r.max_new_tokens]
                       for i, r in enumerate(trace)}
            gen = sum(emitted_count(row[None], engine.eos_id)
                      for row in outputs.values())
            lats = [start + wall - r.arrival_s for r in trace]
            return ServeResult(
                "static", wall, gen, gen / wall if wall > 0 else 0.0,
                float(np.percentile(lats, 50)), float(np.percentile(lats, 95)),
                outputs, engine=engine)

        engine = ContinuousServeEngine(
            model, params, n_slots=slots, max_len=max_len, eos_id=eos_id,
            pad_id=pad_id, cost_engine=self.engine,
            prefill_chunk=prefill_chunk, macro_step=macro_step,
            paged=paged, block_size=block_size, kv_blocks=kv_blocks,
            prefix_cache=True if prefix_cache == "auto" else prefix_cache)
        if warmup:
            engine.warmup(max(r.prompt_len for r in trace),
                          max_new_tokens=max(r.max_new_tokens for r in trace))
        stream_obj = None
        if stream is True:
            stream_obj = TokenStream()
        elif isinstance(stream, TokenStream):
            stream_obj = stream
        # attached after warmup, so the dummy request streams nothing
        engine.stream = stream_obj
        try:
            report = engine.run(list(trace), now_fn=now_fn)
        finally:
            engine.stream = None  # the engine stays reusable stream-free
        if stream_obj is not None:
            stream_obj.close()
        pct = report.latency_percentiles()
        return ServeResult(
            "continuous", report.wall_s, report.generated_tokens,
            report.tok_per_s, pct["p50"], pct["p95"], report.outputs(),
            report=report, engine=engine, stream=stream_obj)


# ---------------------------------------------------------------------------
# The default Runtime
# ---------------------------------------------------------------------------

_default_runtime: Optional[Runtime] = None


def default_runtime() -> Runtime:
    """The process-default Runtime, built lazily from the environment
    (``RuntimeConfig.from_env()``): on the card, like every Runtime that
    is not asked for the CPU."""
    global _default_runtime
    if _default_runtime is None:
        _default_runtime = Runtime(RuntimeConfig.from_env())
    return _default_runtime


def set_default_runtime(runtime: Optional[Runtime]) -> None:
    """Replace (or, with None, reset) the process-default Runtime."""
    global _default_runtime
    _default_runtime = runtime
