"""Distributed sorting: the paper's quicksort domain.

The reference answers the paper's questions with a master-slave SAMPLE
SORT across devices (each device sorts its shard, splitters are agreed by
one of the paper's pivot strategies, one all-to-all exchanges the buckets)
and a serial path on one device.  The CostEngine decides between them, and
``SortReport.imbalance`` measures what bad pivots cost.

This slice of the port runs on one GPU: the serial path is complete, on
``torch.sort`` or on the port's bitonic sort kernel, and a mesh (sample
sort) raises until the multi-GPU work lands.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from repro_torch.core.costs import CostEngine, OverheadModel, resolve_engine

PIVOT_STRATEGIES = ("left", "right", "mean", "random", "sampled")
# the port's local sorts and the reference's names for them
LOCAL_SORTS = {"torch": "xla", "kernel": "pallas"}

_MULTI_GPU = ("sample sort over a mesh needs several GPUs; it is on the "
              "port's multi-GPU queue (ROADMAP.md), not in this slice")


@dataclasses.dataclass
class SortReport:
    strategy: str
    pivot: str
    n: int
    chips: int
    counts: Optional[torch.Tensor] = None  # elements landing on each device

    @property
    def imbalance(self) -> float:
        """max bucket load / ideal load: 1.0 is perfect."""
        if self.counts is None or self.chips == 1:
            return 1.0
        return float(self.counts.max()) * self.chips / max(self.n, 1)


def distributed_sort(
    x: torch.Tensor,
    mesh=None,
    axis: str = "data",
    pivot: str = "sampled",
    model: Optional[OverheadModel] = None,
    force_parallel: bool = False,
    engine: Optional[CostEngine] = None,
    measure: bool = False,
    local_sort: str = "torch",
) -> Tuple[torch.Tensor, SortReport]:
    """Sort a 1-D tensor with overhead-managed serial/parallel dispatch.

    Returns (sorted tensor (n,), report).  The decision comes from the
    CostEngine and lands in its ledger; ``measure=True`` also times the
    executed path (the device synchronised before each clock reading) and
    attaches the time to the ledger: the predicted-vs-measured hook.

    ``local_sort`` picks the serial sort: ``"torch"`` (``torch.sort``; the
    reference's ``"xla"``) or ``"kernel"`` (``kernels.ops.sort``: the
    bitonic sort kernel on a CUDA tensor, its plain version on a CPU one;
    the reference's ``"pallas"``).  A ``mesh`` raises
    ``NotImplementedError`` in this single-GPU slice; without one,
    ``force_parallel`` changes nothing, as in the reference.
    """
    if local_sort not in LOCAL_SORTS:
        raise ValueError(f"local_sort must be one of {tuple(LOCAL_SORTS)}, "
                         f"got {local_sort!r}")
    if mesh is not None:
        raise NotImplementedError(_MULTI_GPU)
    eng = resolve_engine(engine, model)
    n = x.shape[0]
    chips = 1
    decision = eng.decide_sort(n, chips=chips, dtype_bytes=x.element_size())
    if measure:
        _sync(x)
    t0 = time.perf_counter() if measure else 0.0
    if local_sort == "kernel":
        from repro_torch.kernels import ops

        out = ops.sort(x)
    else:
        out = torch.sort(x).values
    if measure:
        _sync(x)
        eng.record_measured(decision, time.perf_counter() - t0)
    return out, SortReport("serial", pivot, n, chips)


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
