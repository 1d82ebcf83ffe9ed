"""The paper's contribution: overhead-managed parallel execution.

costs/        — CostEngine: calibrated cost oracle + decision cache +
                predicted-vs-measured overhead ledger
dispatch.py   — fork-join adaptive matmul dispatch (the serial path, on the
                port's matmul kernel) and matrix-chain multiplication
sort.py       — the paper's sort domain (the serial path, on torch.sort or
                the port's bitonic sort kernel)
dependency.py — torch.fx dependency analysis (available parallelism)
planner.py    — per-layer shard-or-replicate plan and HBM check (one GPU)
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
from repro_torch.core.dispatch import (  # noqa: F401
    adaptive_matmul,
    decide_matmul,
    fork_join,
    matmul_chain,
)
from repro_torch.core.sort import distributed_sort  # noqa: F401
from repro_torch.core.dependency import analyze_dependencies  # noqa: F401
from repro_torch.core.planner import Plan, plan_model  # noqa: F401
