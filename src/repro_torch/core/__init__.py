"""The paper's contribution: overhead-managed parallel execution.

costs/        — CostEngine: calibrated cost oracle + decision cache +
                predicted-vs-measured overhead ledger
dispatch.py   — fork-join adaptive matmul dispatch (serial or sharded over
                a mesh, on the port's matmul kernel) and matrix-chain
                multiplication
sort.py       — the paper's sort domain: serial, or sample sort over a
                mesh with the paper's pivot strategies (torch.sort or the
                port's bitonic sort kernel)
dependency.py — torch.fx dependency analysis (available parallelism)
planner.py    — per-layer shard-or-replicate plan and HBM check over a
                mesh shape

Names resolve lazily, as in ``repro_torch``: the serving scheduler (which
a spawned front-end worker imports to validate requests) reaches
``core.costs`` without loading the torch-backed modules beside it.
"""

_EXPORTS = {
    "Autotuner": "repro_torch.core.costs",
    "CostBreakdown": "repro_torch.core.costs",
    "CostEngine": "repro_torch.core.costs",
    "CostQuery": "repro_torch.core.costs",
    "Decision": "repro_torch.core.costs",
    "OverheadLedger": "repro_torch.core.costs",
    "OverheadModel": "repro_torch.core.costs",
    "resolve_engine": "repro_torch.core.costs",
    "adaptive_matmul": "repro_torch.core.dispatch",
    "decide_matmul": "repro_torch.core.dispatch",
    "fork_join": "repro_torch.core.dispatch",
    "matmul_chain": "repro_torch.core.dispatch",
    "distributed_sort": "repro_torch.core.sort",
    "analyze_dependencies": "repro_torch.core.dependency",
    "Plan": "repro_torch.core.planner",
    "plan_model": "repro_torch.core.planner",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # cache: subsequent lookups skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
