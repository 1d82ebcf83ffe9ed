"""Overhead ledger: every fork-join decision, predicted — and, when timing
hooks run, measured.

The paper's comparative-analysis tables put predicted overhead regimes next
to measured wall times; open-loop prediction is exactly what this refactor
retires.  The ledger closes the loop: each CostEngine decision appends an
entry with its full predicted breakdown, and execution sites that can time
themselves (benchmarks, eager sort/matmul paths) attach the measured
seconds to the same entry.  ``table()`` renders the predicted-vs-measured
comparison; ``to_json()`` exports it for offline analysis.

Since corrections landed (corrections.py, DESIGN.md §10) every measured row
also feeds back: ``attach_measurement`` notifies the owning engine's
observer hook, and ``drift()`` separates what the *analytic model* got
wrong (``raw_ratio``, correction factored back out) from what the
*corrected* engine still gets wrong (``resolved``), so the warning path and
the correction loop share one statistic.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Mapping, Optional

from repro_torch.core.costs.model import CostBreakdown

DEFAULT_DRIFT_WINDOW = 20
DEFAULT_DRIFT_THRESHOLD = 3.0


@dataclasses.dataclass
class LedgerEntry:
    seq: int
    site: str  # matmul | sort | scan_chunk | moe_dispatch | layer_shard | autotune | serve*
    query: Dict[str, Any]
    choice: str
    predicted_s: float
    breakdown: Dict[str, float]
    cached: bool = False
    measured_s: Optional[float] = None
    note: str = ""
    # multiplicative correction that was applied to predicted_s at decision
    # time (1.0 when corrections are off) — lets drift() recover the raw
    # analytic-model ratio from the corrected one
    correction: float = 1.0

    @property
    def ratio(self) -> Optional[float]:
        """measured / predicted — 1.0 means the (corrected) engine was
        exactly right."""
        if self.measured_s is None or self.predicted_s <= 0:
            return None
        return self.measured_s / self.predicted_s

    @property
    def raw_ratio(self) -> Optional[float]:
        """measured / UNCORRECTED prediction — 1.0 means the analytic model
        on its calibrated spec was exactly right, whatever correction the
        engine had layered on top."""
        r = self.ratio
        if r is None:
            return None
        return r * self.correction

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ratio"] = self.ratio
        d["raw_ratio"] = self.raw_ratio
        return d


class OverheadLedger:
    """Append-only record of decisions; bounded so trace-time hot loops
    cannot grow it without limit (drops are counted, never silent).

    ``drift_window``/``drift_threshold`` are the session defaults for the
    drift statistic; ``drift_overrides`` maps a site name to
    ``{"window": int, "threshold": float}`` overrides so high-rate sites
    can use tighter windows than slow ones — the correction loop and the
    warning path both read the same per-site knobs."""

    def __init__(self, max_entries: int = 10_000, *,
                 drift_window: int = DEFAULT_DRIFT_WINDOW,
                 drift_threshold: float = DEFAULT_DRIFT_THRESHOLD,
                 drift_overrides: Optional[
                     Mapping[str, Mapping[str, Any]]] = None):
        if drift_window < 1:
            raise ValueError(f"drift_window must be >= 1, got {drift_window}")
        if drift_threshold <= 1.0:
            raise ValueError(
                f"drift_threshold must be > 1, got {drift_threshold}")
        self.entries: List[LedgerEntry] = []
        self.max_entries = max_entries
        self.dropped = 0
        self._seq = 0
        self.drift_window = int(drift_window)
        self.drift_threshold = float(drift_threshold)
        self.drift_overrides: Dict[str, Dict[str, Any]] = {
            site: dict(knobs)
            for site, knobs in (drift_overrides or {}).items()}
        # observer fired on every attach_measurement (the CostEngine's
        # correction loop registers here); exceptions propagate — a broken
        # observer is a bug, not a condition to swallow
        self.on_measurement: Optional[Callable[[LedgerEntry], None]] = None

    def __len__(self) -> int:
        return len(self.entries)

    def drift_config(self, site: str) -> Dict[str, Any]:
        """Effective (window, threshold) for one site: the session defaults
        with any per-site override applied."""
        o = self.drift_overrides.get(site, {})
        return {"window": int(o.get("window", self.drift_window)),
                "threshold": float(o.get("threshold", self.drift_threshold))}

    def record(self, site: str, query: Dict[str, Any], choice: str,
               breakdown: CostBreakdown, *, cached: bool = False,
               note: str = "", correction: float = 1.0) -> LedgerEntry:
        entry = LedgerEntry(
            seq=self._seq, site=site, query=dict(query), choice=choice,
            predicted_s=breakdown.total, breakdown=breakdown.as_dict(),
            cached=cached, note=note, correction=correction,
        )
        self._seq += 1
        if len(self.entries) >= self.max_entries:
            self.dropped += 1
            entry._appended = False
        else:
            self.entries.append(entry)
            entry._appended = True
        return entry

    def attach_measurement(self, entry: LedgerEntry, seconds: float) -> None:
        entry.measured_s = seconds
        # measured entries are the scarce closed-loop signal: re-admit one
        # the cap dropped rather than losing the measurement silently
        if not getattr(entry, "_appended", True):
            self.entries.append(entry)
            entry._appended = True
            self.dropped -= 1
        if self.on_measurement is not None:
            self.on_measurement(entry)

    @contextmanager
    def measure(self, entry: LedgerEntry):
        """Time a block and attach the wall time to ``entry``.  The caller
        must make the block synchronous (block_until_ready) for the
        measurement to mean anything."""
        t0 = time.perf_counter()
        try:
            yield entry
        finally:
            self.attach_measurement(entry, time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # Export / rendering
    # ------------------------------------------------------------------

    def measured_entries(self) -> List[LedgerEntry]:
        return [e for e in self.entries if e.measured_s is not None]

    def to_dicts(self) -> List[dict]:
        return [e.as_dict() for e in self.entries]

    def to_json(self, path: Optional[str] = None) -> str:
        payload = json.dumps(
            {"entries": self.to_dicts(), "dropped": self.dropped}, indent=1)
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "w") as f:
                f.write(payload)
        return payload

    def summary(self) -> Dict[str, Any]:
        measured = self.measured_entries()
        ratios = [e.ratio for e in measured if e.ratio is not None]
        return {
            "decisions": self._seq,
            "recorded": len(self.entries),
            "dropped": self.dropped,
            "measured": len(measured),
            "mean_measured_over_predicted":
                sum(ratios) / len(ratios) if ratios else None,
        }

    @staticmethod
    def _gmean(ratios: List[float]) -> float:
        return math.exp(sum(math.log(r) for r in ratios) / len(ratios))

    def drift(self, *, window: Optional[int] = None,
              threshold: Optional[float] = None,
              corrections=None) -> Dict[str, Dict[str, Any]]:
        """Per-site calibration drift: geometric-mean measured/predicted
        ratio over each site's trailing window of measured rows.

        ``window``/``threshold`` override the per-site configuration when
        given; when None each site uses ``drift_config(site)`` — the same
        knobs the correction loop reads.  A site is flagged ``drifting``
        when the geometric mean of its trailing RAW ratios (corrections
        factored back out) leaves [1/threshold, threshold] — the analytic
        model on its calibrated HardwareSpec no longer predicts what the
        backend actually does there.  With a ``corrections`` state
        supplied, ``resolved`` reports whether the site's CURRENT
        correction factor brings that residual back inside the band (drift
        the correction layer already absorbs needs no recalibration; drift
        it cannot absorb does).  Only the trailing window counts, so
        compile-inflated warmup rows age out instead of flagging a healthy
        steady state.  Geometric mean because ratios are multiplicative:
        4x-over and 4x-under should cancel, not average to 2x-over."""
        by_site: Dict[str, List[LedgerEntry]] = {}
        for e in self.measured_entries():
            if e.ratio is not None and e.ratio > 0:
                by_site.setdefault(e.site, []).append(e)
        out: Dict[str, Dict[str, Any]] = {}
        for site, rows in sorted(by_site.items()):
            cfg = self.drift_config(site)
            w = int(window) if window is not None else cfg["window"]
            th = float(threshold) if threshold is not None else cfg["threshold"]
            tail = rows[-w:]
            gmean = self._gmean([e.ratio for e in tail])
            raw = self._gmean([e.raw_ratio for e in tail])
            factor = corrections.factor(site) if corrections is not None \
                else 1.0
            residual = raw / factor
            in_band = lambda v: 1.0 / th <= v <= th  # noqa: E731
            out[site] = {
                "n": len(tail),
                "window": w,
                "geomean_ratio": gmean,
                "raw_ratio": raw,
                "correction": factor,
                "residual_ratio": residual,
                "drifting": not in_band(raw),
                "resolved": in_band(residual),
                "threshold": th,
            }
        return out

    def report(self, *, max_rows: int = 40,
               drift_window: Optional[int] = None,
               drift_threshold: Optional[float] = None,
               corrections=None) -> str:
        """One human-readable report: the summary counts, the
        predicted-vs-measured table, and per-site drift warnings — what
        ``runtime.ledger.report()`` prints at the end of a session.
        Surfaces each site's effective drift window/threshold (per-site
        overrides included) so the knob the warning used is visible."""
        s = self.summary()
        head = (f"overhead ledger: {s['decisions']} decisions "
                f"({s['recorded']} recorded, {s['dropped']} dropped), "
                f"{s['measured']} with measured wall time")
        out = head + "\n" + self.table(max_rows=max_rows)
        drift = self.drift(window=drift_window, threshold=drift_threshold,
                           corrections=corrections)
        drifting = {k: v for k, v in drift.items() if v["drifting"]}
        if drifting:
            lines = ["", "!! calibration drift (per-site trailing measured "
                         "rows; window/threshold from RuntimeConfig):"]
            for site, d in drifting.items():
                verdict = (f"absorbed by correction x{d['correction']:.2f}"
                           if d["resolved"] else "re-calibration warranted")
                lines.append(
                    f"!!   {site}: measured/predicted geomean "
                    f"{d['raw_ratio']:.2f}x over {d['n']} rows "
                    f"(window {d['window']}, threshold "
                    f"{d['threshold']:g}x) — {verdict}")
            out += "\n".join(lines)
        return out

    def table(self, *, measured_only: bool = False, max_rows: int = 40) -> str:
        """Predicted-vs-measured table (the paper's comparative tables,
        closed-loop).  One row per decision."""
        rows = self.measured_entries() if measured_only else self.entries
        header = (f"{'site':12s} {'choice':16s} {'query':34s} "
                  f"{'predicted':>11s} {'measured':>11s} {'meas/pred':>9s}")
        lines = [header, "-" * len(header)]
        for e in rows[:max_rows]:
            q = ",".join(f"{k}={v}" for k, v in e.query.items())
            meas = f"{e.measured_s:.3e}s" if e.measured_s is not None else "-"
            ratio = f"{e.ratio:8.2f}x" if e.ratio is not None else "-"
            lines.append(f"{e.site:12s} {e.choice:16s} {q[:34]:34s} "
                         f"{e.predicted_s:.3e}s {meas:>11s} {ratio:>9s}")
        if len(rows) > max_rows:
            lines.append(f"... {len(rows) - max_rows} more rows "
                         f"(to_json() for the full ledger)")
        if self.dropped:
            lines.append(f"!! {self.dropped} decisions dropped "
                         f"(ledger cap {self.max_entries})")
        s = self.summary()
        if s["mean_measured_over_predicted"] is not None:
            lines.append(f"mean measured/predicted over {s['measured']} timed "
                         f"decisions: {s['mean_measured_over_predicted']:.2f}x")
        return "\n".join(lines)
