"""The public Runtime: one explicit session object owning the device, the
CostEngine (hardware spec, calibration cache, decision cache) and the
overhead ledger.

    import repro_torch

    rt = repro_torch.Runtime()                    # on the GPU (the default)
    rt = repro_torch.Runtime(device="cpu")        # plain PyTorch on the CPU
    rt = repro_torch.Runtime(repro_torch.RuntimeConfig(calibrate=True))

    served = rt.serve(cfg, trace)                 # continuous batching
    print(rt.ledger.report())                     # every decision, pred-vs-meas

Two Runtimes are fully isolated: separate engines, decision caches and
ledgers.  The entry points run on ``cuda`` unless the caller asks for the
CPU; a Runtime asked for a card that is not there raises, it does not fall
back to the CPU.  Training, planning, meshes and the robustness, paging and
front-end options of the reference's ``Runtime.serve`` come with later
slices of the port.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

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


# ---------------------------------------------------------------------------
# Result records
# ---------------------------------------------------------------------------


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


def synthetic_trace(n_requests: int, *, prompt_len: int, max_new: int,
                    vocab_size: int, arrival: str = "staggered",
                    gap_ms: float = 20.0, rate: float = 50.0,
                    seed: int = 0) -> List[Any]:
    """Deterministic request trace: random prompts from numpy's generator
    and an arrival process (``all`` at t=0, ``staggered`` every
    ``gap_ms``, or ``poisson`` at ``rate``/s) — the same prompts and
    arrivals as the reference's builder for the same arguments."""
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    prompts = rng.integers(
        1, vocab_size, (n_requests, prompt_len)).astype(np.int32)
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

    def serve(self, cfg, trace, *, mode: str = "continuous", model=None,
              params=None, seed: int = 0, slots: int = 4,
              max_len: Optional[int] = None, eos_id: int = 0,
              pad_id: Optional[int] = None, prefill_chunk="auto",
              macro_step="auto", warmup: bool = True,
              now_fn=time.perf_counter) -> ServeResult:
        """Run a request ``trace`` (a list of ``repro_torch.Request``).

        ``continuous`` is the slot-pooled engine scheduled by this
        runtime's CostEngine (admission / prefill-chunk / macro-horizon
        decisions land as ``site=serve``/``site=serve_macro`` ledger rows
        with measured step times).  ``macro_step``: ``"auto"`` lets the
        CostEngine pick K per composition, an int pins it.

        ``static`` is the lockstep baseline: the batch forms at the last
        arrival and every request's latency includes that wait; it requires
        equal-length prompts.  ``params=None`` initializes parameters from
        ``seed``; ``max_len=None`` sizes slots to the largest
        prompt+generation in the trace.
        """
        from repro_torch.models import build_model
        from repro_torch.serving import ContinuousServeEngine, ServeEngine
        from repro_torch.serving.engine import emitted_count

        if not trace:
            raise ValueError("serve() needs a non-empty trace of Requests")
        if mode not in ("static", "continuous"):
            raise ValueError(f"unknown serve mode: {mode!r}")
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
            prefill_chunk=prefill_chunk, macro_step=macro_step)
        if warmup:
            engine.warmup(max(r.prompt_len for r in trace),
                          max_new_tokens=max(r.max_new_tokens for r in trace))
        report = engine.run(list(trace), now_fn=now_fn)
        pct = report.latency_percentiles()
        return ServeResult(
            "continuous", report.wall_s, report.generated_tokens,
            report.tok_per_s, pct["p50"], pct["p95"], report.outputs(),
            report=report, engine=engine)
