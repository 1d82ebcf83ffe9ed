"""The public Runtime: one explicit session object owning the device, the
CostEngine (hardware spec, calibration cache, decision cache) and the
overhead ledger.

    import repro_torch

    rt = repro_torch.Runtime()                    # on the GPU (the default)
    rt = repro_torch.Runtime(device="cpu")        # plain PyTorch on the CPU
    rt = repro_torch.Runtime(repro_torch.RuntimeConfig(calibrate=True))
    rt = repro_torch.Runtime(repro_torch.RuntimeConfig(autotune=True))

    plan   = rt.plan(cfg, shape)              # overhead-driven layer plan
    result = rt.train(cfg, loop, steps=100)   # training loop + checkpoints
    served = rt.serve(cfg, trace)             # continuous batching
    print(rt.ledger.report())                 # every decision, pred-vs-meas

Two Runtimes are fully isolated: separate engines, decision caches,
tuners and ledgers.  The entry points run on ``cuda`` unless the caller
asks for the CPU; a Runtime asked for a card that is not there raises, it
does not fall back to the CPU.  ``default_runtime()`` is a lazily built session
configured from the environment (``RuntimeConfig.from_env()``); the port's
decision sites never fall back to it, a Runtime passes its own engine to
everything it drives.  ``RuntimeConfig(corrections=True)`` closes the
ledger loop (per-site correction factors learned from measured rows,
persisted with the calibration), and ``Runtime.serve`` takes the
reference's robustness options (bounded queue, deadlines, injected faults
under a watchdog, graceful stop) and its multi-process front end (pinned
intake and emission worker processes, the ``serve_ipc`` decisions).
``RuntimeConfig(autotune=True)`` lets the session's kernel autotuner
(``Runtime.tuner``) time the candidate tiles of each kernel call it meets
and cache the winners; ``train`` and ``serve`` run their kernels under it
(on the calling thread, and on a serving watchdog's worker).  A kernel
called outside them, with no ``tuner=``, launches with its fixed choice.
``Runtime.mesh`` is the session's device mesh (``RuntimeConfig.mesh_shape``)
and ``Runtime.plan`` plans over it; ``serve(mesh_shape=)`` serves
tensor-parallel, and training on a mesh goes through
``training.make_train_step(ctx=)`` (the reference's ``Runtime.train``
takes no mesh either).  ``Runtime.dryrun(arch, shape)`` runs one
production-mesh cell of the dry run on this session's engine
(``launch/dryrun.py``: the real step on 256 or 512 meta positions, no
device touched, so a ``Runtime(device="cpu")`` runs it too).
``Runtime.bench()`` runs the benchmark suites (``repro_torch.benches``)
on this session's device.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.costs.autotune import Autotuner
from repro_torch.core.costs.corrections import CorrectionState
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
    ``autotune``   — let the kernel autotuner measure tile candidates on
                     the card (the matmul's tile width, the sort's tile
                     and group, WKV's chunk) and cache the winners; off,
                     it answers with each kernel's fixed choice (or a
                     config an earlier measured tune cached).  A matmul
                     tile is timed at 2048 rows and at a 4-row decode
                     step, each counted relative to the fixed tile's
                     time, since one tile serves every M.
    ``cache_dir``  — home of the calibration and autotune JSON caches
                     (default ``build/calibration`` in the repository).
    ``hardware``   — base :class:`HardwareSpec` for the analytic model
                     (default: the H100 data sheet).  Calibration replaces
                     measured fields on top of it.
    ``corrections`` — close the ledger loop: learn per-site multiplicative
                     corrections from measured ledger rows and apply them
                     at query time (clamped, rollback- and
                     invalidation-guarded; persisted in the calibration
                     cache).  Off by default: an open-loop session prices
                     decisions exactly as the analytic model does.
    ``auto_recalibrate`` — let ``Runtime.serve`` act on sustained raw
                     drift after a trace drains: targeted re-runs of only
                     the drifting sites' calibration probes
                     (``engine.maybe_recalibrate``, on the card).
                     Requires ``calibrate`` to persist the healed spec.
    ``drift_window`` / ``drift_threshold`` — session defaults for the
                     ledger's per-site drift statistic; ``drift_overrides``
                     maps a site name to ``{"window": ..., "threshold":
                     ...}``.  One knob set, shared by the warning path
                     (``ledger.report()``), the correction loop and the
                     recalibration trigger.
    ``mesh_shape`` — mesh topology as ``{axis: size}`` (e.g. ``{"data": 8,
                     "model": 2}``); ``None`` means one data axis over
                     every visible GPU (one position on the CPU).
    """

    device: Optional[str] = None
    calibrate: bool = False
    autotune: bool = False
    cache_dir: Optional[Path] = None
    hardware: Optional[HardwareSpec] = None
    corrections: bool = False
    auto_recalibrate: bool = False
    drift_window: int = 20
    drift_threshold: float = 3.0
    drift_overrides: Optional[Mapping[str, Mapping[str, Any]]] = None
    mesh_shape: Optional[Dict[str, int]] = None

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None,
                 **overrides: Any) -> "RuntimeConfig":
        """The one place the ``REPRO_*`` environment variables are read,
        for the fields the port has: ``REPRO_CALIBRATE=1`` -> calibrate,
        ``REPRO_AUTOTUNE=1`` -> autotune, ``REPRO_CORRECTIONS=1`` ->
        corrections, ``REPRO_COST_CACHE`` -> cache_dir.  ``env`` defaults
        to ``os.environ``; keyword overrides win over it."""
        env = os.environ if env is None else env
        cache = env.get("REPRO_COST_CACHE")
        fields: Dict[str, Any] = {
            "calibrate": env.get("REPRO_CALIBRATE") == "1",
            "autotune": env.get("REPRO_AUTOTUNE") == "1",
            "corrections": env.get("REPRO_CORRECTIONS") == "1",
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
    texts: Optional[Dict[str, str]] = None  # rid -> detok text (front end)


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


def _under_tuner(method):
    """Run a Runtime method with its kernels' lookups on ``self.tuner``."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        from repro_torch.kernels import tuning

        with tuning.using(self.tuner):
            return method(self, *args, **kwargs)
    return run


class Runtime:
    """An explicit repro_torch session: device + engine + tuner + caches +
    ledger.

    ``device`` (or ``config.device``) picks the device, the GPU by default.
    Construction is cheap unless ``config.calibrate`` is set (then the card
    is microbenchmarked once, cached under ``config.cache_dir``).
    ``engine`` and ``tuner`` inject prebuilt components (tests)."""

    def __init__(self, config: Optional[RuntimeConfig] = None, *,
                 device: Optional[str] = None,
                 engine: Optional[CostEngine] = None,
                 tuner: Optional[Autotuner] = None):
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
            ledger = OverheadLedger(
                drift_window=self.config.drift_window,
                drift_threshold=self.config.drift_threshold,
                drift_overrides=self.config.drift_overrides)
            base = self.config.hardware if self.config.hardware is not None \
                else H100
            corrections = (CorrectionState()
                           if self.config.corrections else None)
            if self.config.calibrate:
                engine = CostEngine.calibrated(
                    base, cache_dir=self.config.cache_dir,
                    device=str(self.device), ledger=ledger,
                    corrections=corrections)
            else:
                engine = CostEngine(hw=base, ledger=ledger,
                                    corrections=corrections)
        self.engine = engine
        self.tuner = tuner if tuner is not None else self.make_tuner()
        self._mesh = None

    def make_tuner(self) -> Autotuner:
        """A new tuner for this session: measuring when
        ``config.autotune``, its cache under ``config.cache_dir``, its
        rows in this session's ledger, its priors on this session's
        hardware spec, its fingerprint that of this session's device."""
        return Autotuner(cache_dir=self.config.cache_dir,
                         measure=self.config.autotune, ledger=self.ledger,
                         device=str(self.device), hw=self.engine.hw)

    @property
    def hw(self) -> HardwareSpec:
        """The hardware spec the analytic model runs on."""
        return self.engine.hw

    @property
    def ledger(self) -> OverheadLedger:
        """THE overhead ledger of this session."""
        return self.engine.ledger

    def mesh_shape(self) -> Dict[str, int]:
        """The configured mesh topology, or one data axis over every
        visible GPU (one position on the CPU)."""
        if self.config.mesh_shape:
            return dict(self.config.mesh_shape)
        n = torch.cuda.device_count() if self.device.type == "cuda" else 1
        return {"data": n, "model": 1}

    @property
    def mesh(self):
        """The ``repro_torch.distributed.Mesh`` for :meth:`mesh_shape` on
        this runtime's device type, one position a device (built lazily).
        A shape that needs more devices than exist raises; several
        positions on one device take ``distributed.make_mesh(...,
        shards_per_device=n)``."""
        if self._mesh is None:
            from repro_torch.distributed import make_mesh

            self._mesh = make_mesh(self.mesh_shape(),
                                   device=self.device.type)
        return self._mesh

    def plan(self, cfg, shape, mesh_shape: Optional[Dict[str, int]] = None):
        """Overhead-driven layer plan for ``cfg`` at ``shape`` on this
        runtime's engine (every decision ledgered), over ``mesh_shape`` or
        this runtime's."""
        from repro_torch.core.planner import plan_model

        return plan_model(cfg, shape, mesh_shape or self.mesh_shape(),
                          engine=self.engine)

    @_under_tuner
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

    @_under_tuner
    def serve(self, cfg, trace, *, mode: str = "continuous", model=None,
              params=None, seed: int = 0, slots: int = 4,
              max_len: Optional[int] = None, eos_id: int = 0,
              pad_id: Optional[int] = None, prefill_chunk="auto",
              macro_step="auto", warmup: bool = True,
              mesh_shape: Optional[Dict[str, int]] = None,
              shard_params: str = "auto", shards_per_device: int = 1,
              queue_limit: Optional[int] = None,
              deadline_ms: Optional[float] = None,
              ttft_deadline_ms: Optional[float] = None,
              inject_fault: Optional[str] = None,
              watchdog_ms: Optional[float] = None, max_retries: int = 2,
              paged: bool = False, block_size: int = 16,
              kv_blocks: Optional[int] = None, prefix_cache="auto",
              frontend=None, stream="auto", pin: bool = False,
              stop_event=None, now_fn=time.perf_counter) -> ServeResult:
        """Run a request ``trace`` (a list of ``repro_torch.Request``).

        ``continuous`` is the slot-pooled engine scheduled by this
        runtime's CostEngine (admission / prefill-chunk / macro-horizon
        decisions land as ``site=serve``/``site=serve_macro`` ledger rows
        with measured step times).  ``macro_step``: ``"auto"`` lets the
        CostEngine pick K per composition, an int pins it.

        Robustness (continuous mode only): ``queue_limit`` bounds the
        waiting queue (overflow -> typed REJECTED backpressure);
        ``deadline_ms``/``ttft_deadline_ms`` apply a default per-request
        latency budget to requests that don't carry their own (enforced at
        admission via the ``serve_admit`` CostQuery and at macro-step
        boundaries -> TIMED_OUT); ``inject_fault`` arms one injected device
        fault of the named class (``raise`` | ``nan`` | ``stall``) for
        failure drills; ``watchdog_ms`` bounds any single device step
        (required for ``stall``), with up to ``max_retries`` backoff
        retries before in-flight requests FAIL.  The watchdog and the
        injector are armed after warmup.  ``stop_event`` (anything with
        ``is_set()``, e.g. a ``threading.Event`` set from a signal
        handler) stops intake: queued requests end REJECTED, active ones
        decode to the end, and the report is still returned.  With
        ``RuntimeConfig(auto_recalibrate=True)`` the drifting sites'
        probes re-run once the trace has drained.

        Paged KV (continuous mode only): ``paged=True`` stores
        full-attention KV in a shared BlockPool of ``block_size``-token
        pages (``kv_blocks`` overrides the can-never-run-out default) with
        per-slot block tables, and ``prefix_cache`` controls radix prefix
        reuse at admission (``"auto"``: the serve_prefix CostQuery decides
        per prompt; ``"force"`` pins reuse on; ``False`` keeps no trie).

        Front end + streaming (continuous mode only): ``frontend`` moves
        request intake (validation + pre-processing) and token emission
        (detokenization) into worker PROCESSES off the engine thread,
        spawned after warmup and stopped before this returns.
        ``frontend="auto"`` lets the ``serve_ipc`` CostQuery (the eleventh
        decision site) choose between inline intake and 1/2/4 workers; an
        int pins the worker count (still priced and ledgered); a
        ``FrontendConfig`` pins every knob.  ``pin`` requests
        topology-aware CPU affinity (the calling thread on a reserved
        physical core for the run, workers on the other cores; hosts
        without ``sched_setaffinity`` run unpinned).  ``stream`` attaches
        a per-request incremental token stream fed at the macro-step
        boundaries the engine already synchronizes on (no added device
        syncs): ``True`` makes one, an instance is used as it is,
        ``"auto"`` is on exactly when a front end is on;
        ``ServeResult.stream`` holds it.  Token generation never leaves
        the engine process, so front-end output is token-identical by
        construction, and the emission worker's transcript is checked
        against the engine's tokens (``FrontendError`` on any difference);
        ``ServeResult.texts`` holds its detokenized texts.

        Tensor parallelism (continuous mode only): ``mesh_shape``
        (``{"data": 1, "model": 8}``; axes ``data`` and ``model`` only)
        puts the engine on a mesh of this runtime's devices, with
        ``shards_per_device`` positions on each (eight shards on one card:
        ``shards_per_device=8``, where the reference forces host devices
        through ``XLA_FLAGS``), and ``shard_params`` forces the
        ``serve_shard`` verdict (``"shard"``/``"replicate"``) or leaves it
        to the CostEngine (``"auto"``).  The arch's divisibility is checked
        before the device count, so a bad mesh fails on any host.

        ``static`` is the lockstep baseline: the batch forms at the last
        arrival and every request's latency includes that wait; it requires
        equal-length prompts.  ``params=None`` initializes parameters from
        ``seed``; ``max_len=None`` sizes slots to the largest
        prompt+generation in the trace.
        """
        from repro_torch.distributed.mesh import available_devices, make_mesh
        from repro_torch.distributed.sharding import validate_serve_mesh
        from repro_torch.models import build_model
        from repro_torch.serving import ContinuousServeEngine, ServeEngine
        from repro_torch.serving.engine import emitted_count
        from repro_torch.serving.faults import FaultInjector, FaultSpec
        from repro_torch.serving.frontend import (FrontendConfig,
                                                  FrontendError,
                                                  ServingFrontend,
                                                  StreamBroken, TokenStream)
        from repro_torch.serving.frontend.workers import _pickled_size
        from repro_torch.serving.scheduler import RequestState

        if not trace:
            raise ValueError("serve() needs a non-empty trace of Requests")
        if mode not in ("static", "continuous"):
            raise ValueError(f"unknown serve mode: {mode!r}")
        # fail-fast robustness-flag validation (before any model build)
        if inject_fault is not None and inject_fault not in ("raise", "nan",
                                                             "stall"):
            raise ValueError(
                f"inject_fault must be 'raise', 'nan' or 'stall', got "
                f"{inject_fault!r}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if ttft_deadline_ms is not None and ttft_deadline_ms <= 0:
            raise ValueError(
                f"ttft_deadline_ms must be > 0, got {ttft_deadline_ms}")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if watchdog_ms is not None and watchdog_ms <= 0:
            raise ValueError(f"watchdog_ms must be > 0, got {watchdog_ms}")
        if inject_fault == "stall" and watchdog_ms is None:
            raise ValueError(
                "inject_fault='stall' without watchdog_ms would hang the "
                "trace for the stall duration; pass watchdog_ms")
        robustness = any(v is not None for v in (
            queue_limit, deadline_ms, ttft_deadline_ms, inject_fault,
            watchdog_ms))
        if mode == "static" and robustness:
            raise ValueError(
                "queue_limit/deadline/fault/watchdog options need the "
                "request lifecycle of mode='continuous'; the static "
                "lockstep baseline has no per-request scheduling")
        if mode == "static" and paged:
            raise ValueError(
                "paged KV needs the slot pool of mode='continuous'; the "
                "static lockstep baseline keeps dense per-row caches")
        if mode == "static" and frontend is not None:
            raise ValueError(
                "the multi-process front end feeds the continuous engine's "
                "request lifecycle; mode='static' has no admission to take "
                "off the engine thread")
        if mode == "static" and stream not in ("auto", False, None):
            raise ValueError(
                "token streaming needs the macro-step boundaries of "
                "mode='continuous'; the static baseline emits one matrix")
        if frontend is not None and not (
                frontend == "auto" or isinstance(frontend, int)
                or isinstance(frontend, FrontendConfig)):
            raise ValueError(
                f"frontend must be None, 'auto', an int worker count or a "
                f"FrontendConfig, got {frontend!r}")
        if isinstance(frontend, int) and frontend < 1:
            raise ValueError(f"frontend worker count must be >= 1, "
                             f"got {frontend}")
        if paged and block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        mesh = None
        if mesh_shape is not None:
            shape = {"data": 1, "model": 1}
            unknown = set(mesh_shape) - set(shape)
            if unknown:
                raise ValueError(
                    f"serve mesh_shape axes must be 'data'/'model', got "
                    f"{sorted(unknown)}")
            shape.update({k: int(v) for k, v in mesh_shape.items()})
            # arch divisibility first: checkable on any host, independent
            # of how many devices this process has
            validate_serve_mesh(cfg, shape)
            if mode == "static" and shape["model"] > 1:
                raise ValueError(
                    "mode='static' is the single-device lockstep baseline; "
                    "model-axis sharding needs mode='continuous'")
            if shard_params not in ("auto", "shard", "replicate"):
                raise ValueError(
                    f"shard_params must be 'auto', 'shard' or 'replicate', "
                    f"got {shard_params!r}")
            size = shape["data"] * shape["model"]
            if shards_per_device < 1 or size % shards_per_device:
                raise ValueError(
                    f"shards_per_device={shards_per_device} must divide the "
                    f"serve mesh's {size} positions")
            need = size // shards_per_device
            have = available_devices(self.device)
            if need > have:
                raise ValueError(
                    f"serve mesh {shape} needs {need} devices at "
                    f"shards_per_device={shards_per_device}, and this "
                    f"process has {have} {torch.device(self.device).type} "
                    f"device(s); put several positions on a device with "
                    f"shards_per_device=n")
            mesh = make_mesh(shape, device=self.device,
                             shards_per_device=shards_per_device)
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

        # default deadlines apply to requests that don't carry their own
        if deadline_ms is not None or ttft_deadline_ms is not None:
            for r in trace:
                if deadline_ms is not None and r.deadline_s is None:
                    r.deadline_s = deadline_ms / 1e3
                if ttft_deadline_ms is not None and r.ttft_deadline_s is None:
                    r.ttft_deadline_s = ttft_deadline_ms / 1e3
        injector = None
        if inject_fault is not None:
            # one fault partway into the trace (the third macro-step), a
            # stall long enough to need the watchdog
            stall_s = (watchdog_ms or 0) / 1e3 * 20 + 1.0
            injector = FaultInjector((FaultSpec(
                inject_fault, site="macro", after=2, stall_s=stall_s),))
        engine = ContinuousServeEngine(
            model, params, n_slots=slots, max_len=max_len, eos_id=eos_id,
            pad_id=pad_id, cost_engine=self.engine,
            prefill_chunk=prefill_chunk, macro_step=macro_step,
            mesh=mesh, shard_params=shard_params,
            queue_limit=queue_limit, max_retries=max_retries,
            paged=paged, block_size=block_size, kv_blocks=kv_blocks,
            prefix_cache=True if prefix_cache == "auto" else prefix_cache)
        if warmup:
            engine.warmup(max(r.prompt_len for r in trace),
                          max_new_tokens=max(r.max_new_tokens for r in trace))
        # arm the watchdog and the injector only AFTER warmup: the first
        # call builds and loads the kernels and must not trip either
        engine.watchdog_s = None if watchdog_ms is None else watchdog_ms / 1e3
        engine.injector = injector
        engine.stop_event = stop_event

        # --- the multi-process front end: the serve_ipc decisions (workers,
        # coalesce) are made here, at the layer that owns the processes;
        # the engine only ever sees a TokenStream
        fe_cfg = None
        dec_w = dec_c = None
        if frontend is not None:
            submissions = [{
                "rid": r.rid,
                "prompt": [int(t) for t in np.asarray(r.prompt).tolist()],
                "max_new_tokens": int(r.max_new_tokens),
                "arrival_s": float(r.arrival_s),
                "priority": int(r.priority),
                "deadline_s": r.deadline_s,
                "ttft_deadline_s": r.ttft_deadline_s,
            } for r in trace]
            msg_bytes = max(_pickled_size(("req", s)) for s in submissions)
            plen = max(r.prompt_len for r in trace)
            if isinstance(frontend, FrontendConfig):
                fe_cfg = frontend
                _, dec_w = engine.scheduler.serve_ipc_workers(
                    len(trace), msg_bytes=msg_bytes, prompt_len=plen,
                    candidates=(fe_cfg.workers,), override="frontend")
            else:
                w, dec_w = engine.scheduler.serve_ipc_workers(
                    len(trace), msg_bytes=msg_bytes, prompt_len=plen,
                    candidates=((1, 2, 4) if frontend == "auto"
                                else (int(frontend),)),
                    override=None if frontend == "auto" else "frontend")
                if w > 0:
                    fe_cfg = FrontendConfig(workers=w, pin=pin)
                # an 'auto' inline verdict serves without a front end: the
                # ledgered decision is the cost site doing its job
        want_stream = (stream is True or isinstance(stream, TokenStream)
                       or (stream == "auto" and fe_cfg is not None))
        if fe_cfg is not None and want_stream:
            event_bytes = _pickled_size((trace[0].rid, (0,), False, 0.0))
            pinned = isinstance(frontend, FrontendConfig)
            c, dec_c = engine.scheduler.serve_ipc_coalesce(
                slots, event_bytes=event_bytes,
                candidates=((fe_cfg.coalesce,) if pinned
                            else (1, 2, 4, 8, 16)))
            if not pinned:
                fe_cfg = dataclasses.replace(fe_cfg, coalesce=max(c, 1))

        fe = None
        texts = None
        stream_obj = None
        run_trace = list(trace)
        failed_intake: List[Any] = []
        try:
            if fe_cfg is not None:
                fe = ServingFrontend(fe_cfg, max_len=max_len)
                fe.start()
                t_sub = time.perf_counter()
                _, failures = fe.submit(submissions)
                engine.scheduler.record_measured(
                    dec_w, time.perf_counter() - t_sub,
                    note=f"serve_ipc intake n={len(trace)} "
                         f"workers={fe_cfg.workers} "
                         f"pinned={fe.workers_pinned}")
                if failures:
                    # intake shed these BEFORE the engine: invalid -> typed
                    # REJECTED, worker death -> typed FAILED; both terminal
                    run_trace = []
                    for r in trace:
                        why = failures.get(r.rid)
                        if why is None:
                            run_trace.append(r)
                            continue
                        r.mark(RequestState.FAILED
                               if why.startswith("frontend:")
                               else RequestState.REJECTED, 0.0, reason=why)
                        failed_intake.append(r)
            if want_stream:
                if isinstance(stream, TokenStream):
                    stream_obj = stream
                elif fe is not None:
                    stream_obj = fe.stream()
                else:
                    stream_obj = TokenStream()
                # attached after warmup, so the dummy request streams nothing
                engine.stream = stream_obj

            report = engine.run(run_trace, now_fn=now_fn)

            if stream_obj is not None:
                stream_obj.close()  # flush any coalesced tail burst
            if fe is not None:
                if stream_obj is not None:
                    try:
                        transcript = fe.finish()
                    except StreamBroken:
                        transcript = None  # the engine already failed typed
                    if transcript is not None:
                        texts = {rid: rec["text"]
                                 for rid, rec in transcript.items()}
                        for r in run_trace:
                            rec = transcript.get(r.rid)
                            if rec is not None and rec["tokens"] != [
                                    int(t) for t in r.tokens]:
                                raise FrontendError(
                                    f"emission transcript diverged from "
                                    f"engine for {r.rid!r}: token identity "
                                    f"violated")
                if dec_c is not None and fe.ping_round_trips_s:
                    engine.scheduler.record_measured(
                        dec_c, float(np.mean(fe.ping_round_trips_s)),
                        note=f"serve_ipc coalesce={fe_cfg.coalesce} "
                             f"per-message ping round trip")
                report.ipc_messages = fe.ipc_messages
                report.ipc_bytes = fe.ipc_bytes
                report.frontend_workers = fe_cfg.workers
                report.frontend_respawns = fe.respawns
                report.requests.extend(failed_intake)
        finally:
            if fe is not None:
                fe.close()
            engine.stream = None  # the engine stays reusable stream-free
        if self.config.auto_recalibrate:
            # drift -> action at the drain boundary: the trace's measured
            # rows are in, the device is idle, and a healed spec is what
            # the NEXT trace should be scheduled on
            self.engine.maybe_recalibrate()
        pct = report.latency_percentiles()
        return ServeResult(
            "continuous", report.wall_s, report.generated_tokens,
            report.tok_per_s, pct["p50"], pct["p95"], report.outputs(),
            report=report, engine=engine, stream=stream_obj, texts=texts)


    def bench(self, only: Optional[str] = None,
              out: Optional[str] = None) -> List[str]:
        """Run the benchmark suites against this runtime (all of them, or
        just ``only``), on its device, writing under ``out``
        (``results/torch/`` by default).  Returns the names of failed
        suites.  The suites are in the package (``repro_torch.benches``),
        so no path needs the repository root, where the reference's
        ``Runtime.bench`` imports the repo-root ``benchmarks/``."""
        from repro_torch.benches.run import run_suites

        return run_suites(self, only=only, out=out)

    def dryrun(self, arch: str, shape: str, *, multi_pod: bool = False,
               probe: bool = True, verbose: bool = True) -> Dict[str, Any]:
        """One production-mesh cell of the dry run on this session's
        engine: the real step on meta positions, the memory a position
        holds, the plan, the roofline terms from the per-layer probes
        (``probe``) and the ledger rows the cell made
        (``launch.dryrun.dryrun_cell``).  Nothing is allocated or launched
        on this session's device."""
        from repro_torch.launch.dryrun import dryrun_cell

        return dryrun_cell(arch, shape, multi_pod=multi_pod, probe=probe,
                           verbose=verbose, runtime=self)


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
