"""The paper's contribution: overhead-managed parallel execution.

costs/        — CostEngine: calibrated cost oracle + decision cache +
                predicted-vs-measured overhead ledger
dispatch.py   — fork-join adaptive matmul dispatch (the serial path, on the
                port's matmul kernel)
"""

from repro_torch.core.costs import (  # noqa: F401
    CostBreakdown,
    CostEngine,
    CostQuery,
    Decision,
    OverheadLedger,
    OverheadModel,
    resolve_engine,
)
from repro_torch.core.dispatch import adaptive_matmul, decide_matmul  # noqa: F401
