"""Distributed sorting: the paper's quicksort domain.

Quicksort's data-dependent recursion is answered, as in the reference,
with a master-slave SAMPLE SORT over a mesh axis:

  1. each position sorts its local shard,
  2. splitters are chosen by one of the paper's pivot strategies and
     agreed on by every position (the master thread's pivot placement),
  3. elements are binned by splitter and exchanged with one all-to-all,
  4. each position sorts what it received, so position i holds the i-th
     contiguous segment of the global order.

Splitter strategies transplant the paper's pivot strategies (Table 3):
``left`` / ``right`` / ``mean`` / ``random`` take one candidate a shard,
``sampled`` regular sampling (chips - 1 a shard).  Bad splitters do not
break correctness (the send buffer is worst-case safe); they show as
BUCKET IMBALANCE (``SortReport.imbalance``).  The CostEngine decides
between this and the serial path on one device.

The mesh is the port's (``repro_torch.distributed.mesh``): every
position's work runs under its own device and stream, so on one GPU with
eight positions the shards fork and join across the card.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

import torch

from repro_torch.core.costs import CostEngine, OverheadModel, resolve_engine
from repro_torch.distributed import mesh as mesh_lib

PIVOT_STRATEGIES = ("left", "right", "mean", "random", "sampled")
# the port's local sorts and the reference's names for them
LOCAL_SORTS = {"torch": "xla", "kernel": "pallas"}

# the ``random`` pivot's generator is seeded by (RANDOM_PIVOT_SEED, rank)
RANDOM_PIVOT_SEED = 17


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


def _random_generator(rank: int) -> torch.Generator:
    """The ``random`` pivot's host generator for one rank, seeded by
    (RANDOM_PIVOT_SEED, rank).  The reference folds the rank into
    ``PRNGKey(17)``; the draws differ (a kept difference)."""
    return torch.Generator().manual_seed(RANDOM_PIVOT_SEED * 2 ** 32 + rank)


def _regular(chips: int, n: int, device) -> torch.Tensor:
    """Indices (r * n) // chips for r in 1 .. chips - 1."""
    return torch.arange(1, chips, device=device) * n // chips


def _select_splitters(mesh, axis: str, xs_local: List[torch.Tensor],
                      pivot: str, chips: int,
                      n_local: int) -> List[torch.Tensor]:
    """The (chips - 1) ascending splitters, the same on every position of
    a group: each position's candidates, all-gathered and sorted."""
    if pivot not in PIVOT_STRATEGIES:
        raise ValueError(pivot)
    rank = mesh_lib.axis_index(mesh, axis)
    if pivot == "sampled":  # regular sampling: chips - 1 candidates a shard
        cands = mesh.map(lambda xs: xs[_regular(chips, n_local, xs.device)],
                         xs_local)
    elif pivot == "left":
        cands = mesh.map(lambda xs: xs[0], xs_local)
    elif pivot == "right":
        cands = mesh.map(lambda xs: xs[-1], xs_local)
    elif pivot == "mean":
        cands = mesh.map(lambda xs: xs.mean(), xs_local)
    else:  # random
        cands = mesh.map(lambda xs, r: xs[int(torch.randint(
            0, n_local, (), generator=_random_generator(r)))], xs_local, rank)
    gathered = mesh_lib.all_gather(mesh, axis, cands)
    if pivot == "sampled":
        def agree(allc):
            allc = torch.sort(allc.reshape(-1)).values
            return allc[_regular(chips, allc.numel(), allc.device)]
    else:
        def agree(allc):
            return torch.sort(allc).values[:-1]  # chips - 1 boundaries
    return mesh.map(agree, gathered)


def _local_sort(v: torch.Tensor, local_sort: str) -> torch.Tensor:
    """Ascending sort of a 1-D shard or bucket whose tail may be +inf.
    The kernel's wrapper pads a row to a power of 2 with the dtype's
    largest finite value and would strip a +inf; so the row is padded with
    +inf to that length here, which the wrapper then leaves alone."""
    if local_sort == "torch":
        return torch.sort(v).values
    from repro_torch.kernels import ops

    n = v.numel()
    n_pad = ops._sort_npad(n)
    if n_pad != n:
        v = torch.cat([v, v.new_full((n_pad - n,), math.inf)])
    return ops.sort(v)[:n]


def _sample_sort(x: torch.Tensor, mesh, axis: str, pivot: str, chips: int,
                 local_sort: str):
    """Sample sort of ``x`` over ``mesh``'s ``axis``: (sorted x, counts)."""
    if not x.dtype.is_floating_point:
        raise TypeError(f"sample sort pads with +inf and takes a floating "
                        f"tensor, got {x.dtype}")
    n = x.shape[0]
    pad = (-n) % chips
    xp = torch.cat([x, x.new_full((pad,), math.inf)]) if pad else x
    n_local = xp.shape[0] // chips
    shards = mesh_lib.shard(mesh, axis, xp, 0)
    xs_local = mesh.map(lambda v: _local_sort(v, local_sort), shards)
    splitters = _select_splitters(mesh, axis, xs_local, pivot, chips,
                                  n_local)

    def binned(xs, spl):
        """The fixed (chips, n_local) send buffer, +inf padded: row b holds
        this shard's elements of bucket b (contiguous, as xs is sorted)."""
        bucket = torch.searchsorted(spl, xs, right=True)  # in [0, chips)
        counts = torch.zeros(chips, dtype=torch.int64,
                             device=xs.device).scatter_add_(
            0, bucket, torch.ones_like(bucket))
        starts = torch.cumsum(counts, 0) - counts
        within = torch.arange(n_local, device=xs.device) - starts[bucket]
        send = torch.full((chips, n_local), math.inf, dtype=xs.dtype,
                          device=xs.device)
        send[bucket, within] = xs
        return send

    sends = mesh.map(binned, xs_local, splitters)
    recvs = mesh_lib.all_to_all(mesh, axis, sends)  # all of MY bucket

    def bucket_sort(recv):
        # counted on the exchanged buffer, whose +inf entries are the
        # padding (inputs must be finite), never after the sort
        count = (recv < math.inf).sum().reshape(1)
        return _local_sort(recv.reshape(-1), local_sort), count

    mine, counts = zip(*mesh.map(bucket_sort, recvs))
    counts = mesh_lib.unshard(mesh, axis, counts, 0, device="cpu")
    group = mesh.groups(axis)[0]
    out = torch.cat([mesh_lib.take(mesh, mine, i, x.device)[:int(c)]
                     for i, c in zip(group, counts)])[:n]
    return out, counts


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

    Returns (sorted tensor (n,) on ``x``'s device, report).  The decision
    comes from the CostEngine at ``chips = mesh.shape[axis]`` and lands in
    its ledger; it, or ``force_parallel``, picks the sample sort over the
    mesh (a ``repro_torch.distributed.Mesh``), else the serial path.
    ``measure=True`` also times the executed path (every device the mesh
    uses synchronised before each clock reading) and attaches the time to
    the ledger: the predicted-vs-measured hook.

    ``local_sort`` picks the sorts: ``"torch"`` (``torch.sort``; the
    reference's ``"xla"``) or ``"kernel"`` (``kernels.ops.sort``: the
    bitonic sort kernel on a CUDA tensor, its plain version on a CPU one;
    the reference's ``"pallas"``), on the serial path and for every
    shard's local and bucket sort of the sample sort.  The sample sort
    takes a floating tensor of finite values (its padding is +inf).
    """
    if local_sort not in LOCAL_SORTS:
        raise ValueError(f"local_sort must be one of {tuple(LOCAL_SORTS)}, "
                         f"got {local_sort!r}")
    if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
        raise TypeError(f"mesh must be a repro_torch.distributed.Mesh, got "
                        f"{type(mesh).__name__}")
    eng = resolve_engine(engine, model)
    n = x.shape[0]
    chips = int(mesh.shape[axis]) if mesh is not None else 1
    decision = eng.decide_sort(
        n, chips=chips, dtype_bytes=x.element_size(),
        devices=mesh.distinct_devices(axis) if mesh is not None else None)
    parallel = force_parallel or decision.choice != "serial"
    devices = {x.device} | (set(mesh.devices) if mesh is not None else set())
    if measure:
        _sync(devices)
    t0 = time.perf_counter() if measure else 0.0
    if not parallel or chips == 1:
        if local_sort == "kernel":
            from repro_torch.kernels import ops

            out = ops.sort(x)
        else:
            out = torch.sort(x).values
        report = SortReport("serial", pivot, n, chips)
    else:
        out, counts = _sample_sort(x, mesh, axis, pivot, chips, local_sort)
        report = SortReport("sample_sort", pivot, n, chips, counts=counts)
    if measure:
        _sync(devices)
        eng.record_measured(decision, time.perf_counter() - t0)
    return out, report


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
