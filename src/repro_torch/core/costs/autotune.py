"""Empirical kernel autotuner: measured tile search with the analytic model
as the zero-measurement prior.

The paper's program parameters — granularity, level of parallelism, resource
sharing — must be *determined*, not assumed (Haque, Moreno Maza, Xie 2014):
a tile frozen at authoring time surfaces later as memory-hierarchy and
launch overhead.  The CostEngine ledger closes the loop for *whether* to
fork; this layer closes it for *how* each kernel tiles.

Pipeline (the reference's, on the card):

    prior      — the analytic model proposes a config without measuring
                 (kernels/tuning.py builds the candidate space per family;
                 each family's prior is the kernel's fixed choice)
    pruning    — candidates the kernel accepts, filtered by the shared
                 memory a CTA may have, ordered by analytic cost
    measure    — each surviving candidate is timed on the card with CUDA
                 events: one warmup call, then the median of ``reps``,
                 its launches queued behind a spin so that the host's
                 enqueue stays outside the window
    cache      — winners persist to a JSON cache keyed by the same card
                 fingerprint the calibration layer uses, so a tuned config
                 survives across processes and is dropped when the card,
                 torch or CUDA changes; a family's key also carries the
                 hash of its kernel's library, so an edited source misses

Measurement never runs implicitly: a tuner measures only when constructed
with ``measure=True`` — which ``repro_torch.Runtime`` does when
``RuntimeConfig.autotune`` is set (``RuntimeConfig.from_env()`` maps
``REPRO_AUTOTUNE=1`` onto it); otherwise the tuner returns the prior (or a
config an earlier measured tune cached).  Every measured tuning decision
lands in the overhead ledger twice — the prior config and the tuned
config, each with its analytic prediction and measured seconds.

torch is imported where a measurement runs, not with the module: a spawned
front-end worker reaches ``core.costs`` without loading torch.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Hashable, Mapping, Optional, Tuple

from repro_torch.core.costs.calibration import (
    backend_fingerprint,
    default_cache_dir,
)
from repro_torch.core.costs.ledger import OverheadLedger
from repro_torch.core.costs.model import CostBreakdown

_SCHEMA_VERSION = 1

Config = Dict[str, int]


def fmt_config(config: Mapping[str, Any]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(config.items()))


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of a kernel family's pruned search space."""

    config: Config
    prior_s: float  # analytic predicted seconds for this config
    vmem_bytes: int  # shared memory a CTA, which the filter admitted


@dataclasses.dataclass(frozen=True)
class TuneSpec:
    """A tuning problem: family + cache key + pruned candidates + runner.

    ``prior`` is the zero-measurement choice (the kernel's fixed choice);
    it must appear in ``candidates``.  ``make_runner(config)`` returns a
    zero-arg callable that launches the kernel once with that config;
    ``None`` means the family cannot be measured (the tuner then always
    answers with the prior).  A ``make_runner`` that raises marks the
    candidate failed.
    """

    family: str
    key: str
    prior: Config
    candidates: Tuple[Candidate, ...]
    make_runner: Optional[Callable[[Config], Callable[[], Any]]] = None
    query: Tuple[Tuple[str, Any], ...] = ()


@dataclasses.dataclass(frozen=True)
class TuneResult:
    key: str
    family: str
    config: Config
    source: str  # "cache" | "measured" | "prior"
    measured_s: Optional[float]
    prior_config: Config
    prior_predicted_s: Optional[float]
    prior_measured_s: Optional[float]
    trials: Tuple[dict, ...] = ()

    @property
    def speedup_vs_prior(self) -> Optional[float]:
        """Measured prior time over measured tuned time (>= 1.0: tuning paid;
        == 1.0: the prior already was the optimum — a zero delta)."""
        if self.prior_measured_s is None or not self.measured_s:
            return None
        return self.prior_measured_s / self.measured_s


SLEEP_HZ = 2.0e9  # cycles a second the spin is counted at: above the
# H100 SXM's 1.98 GHz SM clock, so the spin lasts at least as long as meant
SLEEP_MAX_S = 0.02


def cuda_event_bench(runner: Callable[[], Any], reps: int) -> float:
    """Device seconds of one ``runner()``: one warmup call, then the median
    of ``reps`` calls, each between two CUDA events on the current stream.
    Before each, the stream spins (``torch.cuda._sleep``) for twice the
    host time the last call took to enqueue, so every launch of the call
    is queued before the start event is reached: the window holds the
    kernels' time, not the host's gaps between them."""
    import torch

    t0 = time.perf_counter()
    runner()  # warmup: first-use builds, shared-memory attributes
    host = min(time.perf_counter() - t0, SLEEP_MAX_S)
    times = []
    for _ in range(max(1, reps)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2 * host * SLEEP_HZ))
        start.record()
        t0 = time.perf_counter()
        runner()
        host = min(time.perf_counter() - t0, SLEEP_MAX_S)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


class Autotuner:
    """Measured tile search with a fingerprint-keyed persistent cache.

    ``measure`` defaults to False (prior-only, so importing code paths
    never pay measurement cost); ``repro_torch.Runtime`` passes
    ``RuntimeConfig.autotune``.  ``bench`` overrides the timing hook (tests
    inject deterministic costs); it receives ``(runner, reps)`` and returns
    seconds.  ``ledger=None`` records into the default Runtime's ledger.
    ``device`` is what the fingerprint describes (the card, unless a
    Runtime on the CPU says otherwise); ``hw`` the spec the families'
    priors are computed on (None: the H100 data sheet).
    """

    def __init__(self, *, cache_dir: Optional[Path] = None,
                 measure: Optional[bool] = None, reps: int = 3,
                 max_trials: int = 8,
                 ledger: Optional[OverheadLedger] = None,
                 fingerprint: Optional[str] = None,
                 bench: Optional[Callable[[Callable[[], Any], int], float]] = None,
                 device: str = "cuda", hw=None):
        self.measure = bool(measure)
        self.reps = reps
        self.max_trials = max_trials
        self.ledger = ledger
        self.cache_dir = Path(cache_dir) if cache_dir is not None else default_cache_dir()
        self.device = device
        self.hw = hw
        self._fingerprint = fingerprint
        self._bench = bench or cuda_event_bench
        self.bench_calls = 0
        self._memo: Dict[Hashable, TuneResult] = {}
        self._store: Optional[Dict[str, dict]] = None

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    @property
    def fingerprint(self) -> str:
        if self._fingerprint is None:
            self._fingerprint = backend_fingerprint(self.device)
        return self._fingerprint

    @property
    def cache_path(self) -> Path:
        return self.cache_dir / f"autotune-{self.fingerprint}.json"

    def _load_store(self) -> Dict[str, dict]:
        if self._store is None:
            self._store = {}
            try:
                payload = json.loads(self.cache_path.read_text())
            except (OSError, ValueError):
                return self._store
            if (payload.get("schema") == _SCHEMA_VERSION
                    and payload.get("fingerprint") == self.fingerprint):
                self._store = dict(payload.get("entries", {}))
        return self._store

    def _save_store(self) -> None:
        payload = {
            "schema": _SCHEMA_VERSION,
            "fingerprint": self.fingerprint,
            "entries": self._load_store(),
        }
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        tmp = self.cache_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=1))
        tmp.replace(self.cache_path)

    # ------------------------------------------------------------------
    # Tuning
    # ------------------------------------------------------------------

    def peek(self, key: Hashable) -> Optional[TuneResult]:
        """Memoized result for ``key`` (a spec's key, or an alias), if any —
        lets hot call sites skip candidate-space construction entirely on
        repeat lookups."""
        return self._memo.get(key)

    def alias(self, key: Hashable, result: TuneResult) -> TuneResult:
        """Memoize ``result`` under a second key as well: the kernel entry
        points look up a tuple they build without formatting a string."""
        self._memo[key] = result
        return result

    def results(self) -> Dict[str, TuneResult]:
        """Every result this tuner resolved, by spec key."""
        return {k: r for k, r in self._memo.items() if k == r.key}

    def tune(self, spec: TuneSpec) -> TuneResult:
        """Resolve a config: in-memory memo -> persistent cache -> measured
        search -> analytic prior (in that order of preference)."""
        memo = self._memo.get(spec.key)
        if memo is not None:
            return memo
        result = self._from_cache(spec)
        if result is None:
            if self.measure and spec.make_runner is not None and spec.candidates:
                result = self._measure(spec)
            else:
                result = self._prior_result(spec)
        self._memo[spec.key] = result
        return result

    def _prior_result(self, spec: TuneSpec) -> TuneResult:
        prior_s = next((c.prior_s for c in spec.candidates
                        if c.config == spec.prior), None)
        return TuneResult(spec.key, spec.family, dict(spec.prior), "prior",
                          None, dict(spec.prior), prior_s, None)

    def _from_cache(self, spec: TuneSpec) -> Optional[TuneResult]:
        rec = self._load_store().get(spec.key)
        if rec is None:
            return None
        config = rec.get("config")
        # a cached config must still be a member of the (possibly re-pruned)
        # candidate space for this exact problem
        if not any(c.config == config for c in spec.candidates):
            return None
        return TuneResult(
            spec.key, spec.family, dict(config), "cache",
            rec.get("measured_s"), dict(rec.get("prior_config") or spec.prior),
            rec.get("prior_predicted_s"), rec.get("prior_measured_s"))

    def _measure(self, spec: TuneSpec) -> TuneResult:
        ranked = sorted(spec.candidates, key=lambda c: c.prior_s)
        trials_cands = list(ranked[: self.max_trials])
        if not any(c.config == spec.prior for c in trials_cands):
            prior_cand = next((c for c in spec.candidates
                               if c.config == spec.prior), None)
            if prior_cand is not None:
                trials_cands.append(prior_cand)

        trials = []
        for cand in trials_cands:
            try:
                runner = spec.make_runner(cand.config)
                seconds = self._bench(runner, self.reps)
                self.bench_calls += 1
            except Exception as exc:  # a candidate that fails is just skipped
                trials.append({"config": dict(cand.config), "seconds": None,
                               "prior_s": cand.prior_s, "error": repr(exc)})
                continue
            trials.append({"config": dict(cand.config), "seconds": seconds,
                           "prior_s": cand.prior_s})

        ok = [t for t in trials if t["seconds"] is not None
              and math.isfinite(t["seconds"])]
        if not ok:
            return self._prior_result(spec)
        best = min(ok, key=lambda t: t["seconds"])
        prior_trial = next((t for t in ok if t["config"] == spec.prior), None)
        result = TuneResult(
            spec.key, spec.family, dict(best["config"]), "measured",
            best["seconds"], dict(spec.prior),
            prior_trial["prior_s"] if prior_trial else None,
            prior_trial["seconds"] if prior_trial else None,
            tuple(trials))
        store = self._load_store()
        store[spec.key] = {
            "config": result.config,
            "measured_s": result.measured_s,
            "prior_config": result.prior_config,
            "prior_predicted_s": result.prior_predicted_s,
            "prior_measured_s": result.prior_measured_s,
        }
        self._save_store()
        self._record_ledger(spec, result, best, prior_trial)
        return result

    def _record_ledger(self, spec: TuneSpec, result: TuneResult, best: dict,
                       prior_trial: Optional[dict]) -> None:
        """Two ledger rows per measured tuning: the analytic prior and the
        tuned winner, each predicted-vs-measured — the delta between them is
        how far the analytic model sat from the measured optimum."""
        ledger = self.ledger
        if ledger is None:
            from repro_torch.runtime import default_runtime

            ledger = default_runtime().ledger
        query = {"family": spec.family, **dict(spec.query)}
        rows = [("prior", prior_trial)] if prior_trial else []
        rows.append(("tuned", best))
        for note, trial in rows:
            entry = ledger.record(
                "autotune", query, fmt_config(trial["config"]),
                CostBreakdown(fmt_config(trial["config"]),
                              trial["prior_s"], 0.0, 0.0, 0.0),
                note=note)
            ledger.attach_measurement(entry, trial["seconds"])


# ---------------------------------------------------------------------------
# Deprecated shims over the default Runtime (as the reference keeps them)
# ---------------------------------------------------------------------------


def get_tuner() -> Autotuner:
    """Deprecated: the process-default tuner lives on the default
    ``repro_torch.Runtime`` (which measures when ``RuntimeConfig.autotune``
    — ``REPRO_AUTOTUNE=1`` via ``from_env`` — is set).  Construct a
    Runtime and pass ``runtime.tuner`` explicitly instead."""
    warnings.warn(
        "get_tuner() is deprecated; construct a repro_torch.Runtime (or use "
        "repro_torch.default_runtime().tuner) and inject the tuner "
        "explicitly", DeprecationWarning, stacklevel=2)
    from repro_torch.runtime import default_runtime

    return default_runtime().tuner


def set_tuner(tuner: Optional[Autotuner]) -> None:
    """Deprecated: installs ``tuner`` into the default Runtime (None
    rebuilds one from the Runtime's config).  Use
    ``repro_torch.set_default_runtime(Runtime(...))`` instead."""
    warnings.warn(
        "set_tuner() is deprecated; use repro_torch.set_default_runtime()",
        DeprecationWarning, stacklevel=2)
    from repro_torch.runtime import default_runtime

    rt = default_runtime()
    rt.tuner = tuner if tuner is not None else rt.make_tuner()
