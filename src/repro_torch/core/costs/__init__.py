"""Calibrated cost oracle for every fork-join decision.

model.py       — the analytic overhead model
calibration.py — microbenchmark the running card -> calibrated HardwareSpec
                 (JSON cache keyed by the card's fingerprint)
engine.py      — CostEngine: uniform CostQuery -> Decision interface with a
                 decision cache; owned by a repro_torch.Runtime
ledger.py      — predicted-vs-measured overhead ledger (JSON export + table)
corrections.py — per-site multiplicative corrections learned online from
                 measured ledger rows, applied at query time behind
                 clamp / rollback / cache-invalidation guardrails
"""

from repro_torch.core.costs.calibration import (  # noqa: F401
    CalibrationResult,
    backend_fingerprint,
    calibrate,
    load_calibration,
    save_calibration,
)
from repro_torch.core.costs.corrections import (  # noqa: F401
    CorrectionState,
    SiteCorrection,
)
from repro_torch.core.costs.engine import (  # noqa: F401
    CostEngine,
    CostQuery,
    Decision,
    resolve_engine,
)
from repro_torch.core.costs.ledger import LedgerEntry, OverheadLedger  # noqa: F401
from repro_torch.core.costs.model import (  # noqa: F401
    MATMUL_STRATEGIES,
    CostBreakdown,
    OverheadModel,
    Strategy,
)
