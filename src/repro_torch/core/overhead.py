"""Compatibility shim — the analytic model lives in ``core/costs``.

The paper's overhead taxonomy maps to three roofline terms plus two fixed
overheads; the analytic model implementing it is
``repro_torch.core.costs.model``, under the CostEngine
(``repro_torch.core.costs.engine``), which layers calibration, a decision
cache and the predicted-vs-measured ledger on top.  Every fork-join
decision of the port (adaptive matmul dispatch, the sort's serial/parallel
switch, scan chunk sizes, the layer planner, the serving decisions)
consults the CostEngine.

Import from ``repro_torch.core.costs`` in new code; this module keeps the
reference's ``core.overhead`` surface.
"""

from __future__ import annotations

from repro_torch.core.costs.model import (  # noqa: F401
    MATMUL_STRATEGIES,
    CostBreakdown,
    OverheadModel,
    Strategy,
)
