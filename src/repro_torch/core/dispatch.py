"""Fork-join adaptive dispatch (the paper's central mechanism).

``adaptive_matmul`` asks the CostEngine whether a matmul should run
serially (the paper's single-core path) or under one of the sharded
strategies, and runs that choice.  Below the crossover order, parallel
execution *is* overhead (paper Fig. 2).  Every decision lands in the
engine's ledger; the engine's decision cache makes repeated same-shape
dispatches (e.g. the products of ``matmul_chain``) free.

The port runs on one GPU: the serial path is complete (on the port's
matmul kernel with ``use_kernel=True``), and the sharded strategies and a
mesh raise until the multi-GPU work lands.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.costs import (
    CostBreakdown,
    CostEngine,
    Decision,
    OverheadModel,
    resolve_engine,
)

_MULTI_GPU = ("sharded matmul strategies need several GPUs; they are on the "
              "port's multi-GPU queue (ROADMAP.md), not in this slice")


@dataclasses.dataclass(frozen=True)
class DispatchReport:
    chosen: CostBreakdown
    serial: CostBreakdown
    chips: int
    decision: Optional[Decision] = None

    @property
    def predicted_speedup(self) -> float:
        return self.serial.total / self.chosen.total


def decide_matmul(m: int, n: int, k: int, *, chips: int,
                  model: Optional[OverheadModel] = None,
                  engine: Optional[CostEngine] = None,
                  dtype_bytes: int = 2, io_at_master: bool = True) -> DispatchReport:
    """Standalone dispatch defaults to the paper's setting: inputs live at a
    master and the result must be gathered back (io_at_master=True).  Inside
    a model — operands already distributed — pass False."""
    eng = resolve_engine(engine, model)
    dec = eng.decide_matmul(m, n, k, chips=chips, dtype_bytes=dtype_bytes,
                            io_at_master=io_at_master)
    serial = dec.baseline if dec.baseline is not None else dec.predicted
    return DispatchReport(chosen=dec.predicted, serial=serial, chips=chips,
                          decision=dec)


def adaptive_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh=None,
    axis: str = "data",
    model: Optional[OverheadModel] = None,
    return_report: bool = False,
    force_strategy: Optional[str] = None,
    engine: Optional[CostEngine] = None,
    io_at_master: bool = True,
    use_kernel: bool = False,
):
    """C = A @ B with overhead-managed serial/parallel dispatch.

    A: (m, k); B: (k, n).  With no mesh this is the serial path, decided
    and ledgered like the reference's.  ``use_kernel=True`` runs it through
    the port's matmul kernel (``kernels.ops.matmul``: the Hopper kernel on
    a CUDA tensor, its plain version on a CPU tensor); otherwise
    ``torch.matmul``.  ``mesh`` and the sharded ``force_strategy`` values
    raise ``NotImplementedError`` in this single-GPU slice.
    """
    if mesh is not None:
        raise NotImplementedError(_MULTI_GPU)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    report = decide_matmul(m, n, k, chips=1, model=model, engine=engine,
                           dtype_bytes=a.element_size(),
                           io_at_master=io_at_master)
    strategy = force_strategy or report.chosen.strategy
    if strategy != "serial":
        raise NotImplementedError(_MULTI_GPU)
    if use_kernel:
        from repro_torch.kernels import ops

        out = ops.matmul(a, b)
    else:
        out = a @ b
    return (out, report) if return_report else out


def fork_join(serial_fn: Callable, parallel_fn: Callable, *,
              parallel_wins: bool) -> Callable:
    """The paper's fork-join switch as a generic combinator: the branch
    not chosen is never called."""
    return parallel_fn if parallel_wins else serial_fn


def matmul_chain(matrices, mesh=None, axis="data", model=None, engine=None):
    """Matrix-chain multiplication with per-product adaptive dispatch (the
    paper's 'matrix chain multiplication' case): association order by the
    classic dynamic program on FLOP counts, each product dispatched
    adaptively.  All products share one engine, so repeated shapes hit its
    decision cache."""
    if mesh is not None:
        raise NotImplementedError(_MULTI_GPU)
    eng = resolve_engine(engine, model)
    dims = [m.shape[0] for m in matrices] + [matrices[-1].shape[1]]
    nmat = len(matrices)
    cost = [[0.0] * nmat for _ in range(nmat)]
    split = [[0] * nmat for _ in range(nmat)]
    for span in range(1, nmat):
        for i in range(nmat - span):
            j = i + span
            best, arg = float("inf"), i
            for s in range(i, j):
                c = (cost[i][s] + cost[s + 1][j]
                     + dims[i] * dims[s + 1] * dims[j + 1])
                if c < best:
                    best, arg = c, s
            cost[i][j], split[i][j] = best, arg

    def mult(i, j):
        if i == j:
            return matrices[i]
        s = split[i][j]
        # chain intermediates are already where they are used
        return adaptive_matmul(mult(i, s), mult(s + 1, j), engine=eng,
                               io_at_master=False)

    return mult(0, nmat - 1)
