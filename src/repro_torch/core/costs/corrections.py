"""Per-site multiplicative corrections learned online from the ledger.

The predicted-vs-measured ledger (ledger.py) records one row per costed
decision; until this layer existed nothing consumed the error.  A
``CorrectionState`` closes that loop (DESIGN.md §10): for every CostQuery
site it maintains a multiplicative correction factor — an EWMA in *log
space* (ratios are multiplicative, matching the ledger's geometric-mean
drift statistic) over the trailing measured/predicted ratios — which the
CostEngine applies to its analytic predictions at query time.

Guardrails, in the order they bind:

* **Warmup** — a site's factor stays exactly 1.0 until ``min_measurements``
  ratios have arrived; one noisy row never steers decisions.
* **Clamp** — factors live in the band ``[1/max_correction,
  max_correction]``.  Drift beyond the band is a *model or spec* problem
  (recalibration territory), not a scale problem, and an unbounded factor
  could hide it.
* **Rollback** — each update remembers the factor that was actually applied
  to its row.  When a full trailing window shows the corrected predictions
  with *worse* log-error than the uncorrected ones would have had, the
  correction is harming regret: the site resets to factor 1.0 and re-warms.
* **Invalidation** — whenever the factor moves past ``invalidate_ratio``
  relative to the value the decision cache last saw, the update reports an
  ``"invalidate"`` event so the engine can drop that site's cached verdicts
  (stale decisions must not outlive the model that produced them).

Corrections scale every candidate of a site's sweep equally, so they can
never flip an argmin-style verdict — they restore *absolute* accuracy
(deadline-slack admission, drift resolution, regret).  Verdict-level
healing of a drifted ``HardwareSpec`` is targeted recalibration
(``CostEngine.recalibrate_fields``), which this layer triggers via the
ledger's raw-ratio drift statistic.  Corrections never change tokens, only
decisions.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

__all__ = ["CorrectionState", "SiteCorrection"]

_EPS = 1e-12


class SiteCorrection:
    """Correction state for one CostQuery site (owned by CorrectionState)."""

    __slots__ = ("log_ewma", "n", "applied", "rollbacks", "history")

    def __init__(self, regret_window: int):
        self.log_ewma = 0.0
        self.n = 0              # ratios absorbed since the last (re)warmup
        self.applied = 1.0      # factor the decision cache last saw
        self.rollbacks = 0
        # (log raw ratio, log factor applied to that row) pairs
        self.history: Deque[Tuple[float, float]] = deque(maxlen=regret_window)


class CorrectionState:
    """Per-site multiplicative corrections with clamp/rollback/invalidation
    guardrails.  Thread-compatible with the engine's single-threaded use;
    all methods are cheap (O(window) at worst)."""

    def __init__(self, *, alpha: float = 0.3, max_correction: float = 8.0,
                 min_measurements: int = 3, invalidate_ratio: float = 1.5,
                 regret_window: int = 12):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if max_correction <= 1.0:
            raise ValueError(
                f"max_correction must be > 1, got {max_correction}")
        if min_measurements < 1:
            raise ValueError(
                f"min_measurements must be >= 1, got {min_measurements}")
        if invalidate_ratio <= 1.0:
            raise ValueError(
                f"invalidate_ratio must be > 1, got {invalidate_ratio}")
        if regret_window < 2:
            raise ValueError(f"regret_window must be >= 2, got {regret_window}")
        self.alpha = float(alpha)
        self.max_correction = float(max_correction)
        self.min_measurements = int(min_measurements)
        self.invalidate_ratio = float(invalidate_ratio)
        self.regret_window = int(regret_window)
        self._sites: Dict[str, SiteCorrection] = {}

    # ------------------------------------------------------------------
    # query side
    # ------------------------------------------------------------------
    def factor(self, site: str) -> float:
        """The multiplicative correction the engine should apply to
        ``site``'s predictions right now (1.0 while warming up)."""
        s = self._sites.get(site)
        if s is None or s.n < self.min_measurements:
            return 1.0
        return self._clamp(math.exp(s.log_ewma))

    def _clamp(self, f: float) -> float:
        lo = 1.0 / self.max_correction
        return min(max(f, lo), self.max_correction)

    def site(self, name: str) -> Optional[SiteCorrection]:
        return self._sites.get(name)

    def sites(self) -> Dict[str, Dict[str, float]]:
        """Snapshot for reports: {site: {factor, n, applied, rollbacks}}."""
        return {name: {"factor": self.factor(name), "n": s.n,
                       "applied": s.applied, "rollbacks": s.rollbacks}
                for name, s in sorted(self._sites.items())}

    # ------------------------------------------------------------------
    # update side
    # ------------------------------------------------------------------
    def update(self, site: str, raw_ratio: float,
               applied_factor: float = 1.0) -> List[str]:
        """Absorb one measured row.  ``raw_ratio`` is measured over the
        UNCORRECTED prediction; ``applied_factor`` is the correction that
        was live when the row's decision was priced.  Returns the guardrail
        events this row triggered: any of ``"rollback"``, ``"invalidate"``
        (in that order), usually ``[]``."""
        if not (raw_ratio > 0.0 and math.isfinite(raw_ratio)
                and applied_factor > 0.0 and math.isfinite(applied_factor)):
            return []
        s = self._sites.setdefault(site, SiteCorrection(self.regret_window))
        lr = math.log(raw_ratio)
        s.log_ewma = lr if s.n == 0 else (
            (1.0 - self.alpha) * s.log_ewma + self.alpha * lr)
        s.n += 1
        s.history.append((lr, math.log(applied_factor)))
        events: List[str] = []
        if self._regret_worsened(s):
            s.log_ewma = 0.0
            s.n = 0
            s.history.clear()
            s.rollbacks += 1
            events.append("rollback")
        f = self.factor(site)
        if abs(math.log(f / s.applied)) >= math.log(
                self.invalidate_ratio) - _EPS:
            s.applied = f
            events.append("invalidate")
        return events

    def _regret_worsened(self, s: SiteCorrection) -> bool:
        """True when a FULL trailing window of corrected predictions carries
        more log-error than the uncorrected predictions would have — the
        rollback rule.  Only fires when a correction was actually applied
        to at least one row in the window."""
        if len(s.history) < self.regret_window:
            return False
        if all(abs(lf) < _EPS for _, lf in s.history):
            return False
        corrected = sum(abs(lr - lf) for lr, lf in s.history)
        uncorrected = sum(abs(lr) for lr, _ in s.history)
        return corrected > uncorrected + _EPS

    def reset_site(self, site: str) -> None:
        """Forget a site's correction (targeted recalibration just replaced
        the spec fields that explain its measurements — keeping the old
        factor would double-correct)."""
        self._sites.pop(site, None)

    # ------------------------------------------------------------------
    # persistence (rides in the fingerprint-keyed calibration cache)
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"log_ewma": s.log_ewma, "n": s.n,
                       "applied": s.applied, "rollbacks": s.rollbacks}
                for name, s in sorted(self._sites.items())}

    def load(self, payload: Optional[Dict[str, Dict[str, float]]]) -> None:
        """Restore persisted factors (trailing rollback history is not
        persisted — a fresh session re-earns its rollback evidence)."""
        if not payload:
            return
        for name, d in payload.items():
            try:
                s = SiteCorrection(self.regret_window)
                s.log_ewma = float(d["log_ewma"])
                s.n = int(d["n"])
                s.applied = float(d.get("applied", 1.0))
                s.rollbacks = int(d.get("rollbacks", 0))
            except (KeyError, TypeError, ValueError):
                continue  # malformed site entry: skip, keep the rest
            self._sites[name] = s
