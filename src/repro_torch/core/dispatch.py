"""Fork-join adaptive dispatch (the paper's central mechanism).

``adaptive_matmul`` asks the CostEngine whether a matmul should run
serially (the paper's single-core path) or under one of the sharded
strategies, and runs that choice.  Below the crossover order, parallel
execution *is* overhead (paper Fig. 2).  Every decision lands in the
engine's ledger; the engine's decision cache makes repeated same-shape
dispatches (e.g. the products of ``matmul_chain``) free.

Over a mesh (``repro_torch.distributed.Mesh``) the sharded strategies
run each position's product under its own device and stream, on the
port's matmul kernel with ``use_kernel=True``: ``shard_m`` splits A's
rows, ``shard_n`` B's columns, ``shard_k`` the contraction (the partial
products summed with ``psum``); ``shard_mn`` needs two axes and falls back
to ``shard_m`` on one, as in the reference.
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
from repro_torch.distributed import mesh as mesh_lib

STRATEGIES = ("serial", "shard_m", "shard_n", "shard_k", "shard_mn")


@dataclasses.dataclass(frozen=True)
class DispatchReport:
    chosen: CostBreakdown
    serial: CostBreakdown
    chips: int
    decision: Optional[Decision] = None

    @property
    def predicted_speedup(self) -> float:
        return self.serial.total / self.chosen.total


def _pad_to(x: torch.Tensor, dim: int, mult: int):
    """``x`` zero-padded along ``dim`` to a multiple of ``mult``, and the
    padding's length."""
    r = (-x.shape[dim]) % mult
    if r == 0:
        return x, 0
    pad = list(x.shape)
    pad[dim] = r
    return torch.cat([x, x.new_zeros(pad)], dim), r


def decide_matmul(m: int, n: int, k: int, *, chips: int,
                  model: Optional[OverheadModel] = None,
                  engine: Optional[CostEngine] = None,
                  dtype_bytes: int = 2, io_at_master: bool = True,
                  devices: Optional[int] = None) -> DispatchReport:
    """Standalone dispatch defaults to the paper's setting: inputs live at a
    master and the result must be gathered back (io_at_master=True).  Inside
    a model — operands already distributed — pass False.  ``devices``: the
    distinct devices the ``chips`` positions share (fewer where positions
    share a card; the engine then prices them as one device's)."""
    eng = resolve_engine(engine, model)
    dec = eng.decide_matmul(m, n, k, chips=chips, dtype_bytes=dtype_bytes,
                            io_at_master=io_at_master, devices=devices)
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

    A: (m, k); B: (k, n).  With no mesh (or a 1-position axis) this is the
    serial path.  The strategy is the CostEngine's at ``chips =
    mesh.shape[axis]`` (decided and ledgered like the reference's), or
    ``force_strategy``.  ``io_at_master`` as in :func:`decide_matmul`:
    in-model callers whose operands are already distributed pass False.
    ``use_kernel=True`` runs every product (each shard's on the mesh)
    through the port's matmul kernel (``kernels.ops.matmul``: the Hopper
    kernel on a CUDA tensor, its plain version on a CPU tensor); otherwise
    ``torch.matmul``.  ``shard_k``'s kernel products come out in fp32 and
    are summed in fp32, then rounded to A's dtype once.  The result lands
    on A's device.
    """
    if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
        raise TypeError(f"mesh must be a repro_torch.distributed.Mesh, got "
                        f"{type(mesh).__name__}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    chips = int(mesh.shape[axis]) if mesh is not None else 1
    report = decide_matmul(
        m, n, k, chips=chips, model=model, engine=engine,
        dtype_bytes=a.element_size(), io_at_master=io_at_master,
        devices=mesh.distinct_devices(axis) if mesh is not None else None)
    strategy = force_strategy or report.chosen.strategy
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got "
                         f"{strategy!r}")
    if use_kernel:
        from repro_torch.kernels import ops

        mm = ops.matmul
    else:
        mm = torch.matmul

    if strategy == "serial" or chips == 1:
        out = mm(a, b)
    elif strategy in ("shard_m", "shard_mn"):  # shard_mn: one axis -> rows
        ap, _ = _pad_to(a, 0, chips)
        outs = mesh.map(mm, mesh_lib.shard(mesh, axis, ap, 0),
                        mesh_lib.replicate(mesh, b))
        out = mesh_lib.unshard(mesh, axis, outs, 0, a.device)[:m]
    elif strategy == "shard_n":
        bp, _ = _pad_to(b, 1, chips)
        outs = mesh.map(mm, mesh_lib.replicate(mesh, a),
                        mesh_lib.shard(mesh, axis, bp, 1))
        out = mesh_lib.unshard(mesh, axis, outs, 1, a.device)[:, :n]
    else:  # shard_k
        ap, _ = _pad_to(a, 1, chips)
        bp, _ = _pad_to(b, 0, chips)
        if use_kernel:
            def partial(al, bl):
                return ops.matmul(al, bl, out_dtype=torch.float32)
        else:
            partial = torch.matmul
        parts = mesh.map(partial, mesh_lib.shard(mesh, axis, ap, 1),
                         mesh_lib.shard(mesh, axis, bp, 0))
        out = mesh_lib.take(mesh, mesh_lib.psum(mesh, axis, parts), 0,
                            a.device).to(a.dtype)
    return (out, report) if return_report else out


def fork_join(serial_fn: Callable, parallel_fn: Callable, *,
              parallel_wins: bool) -> Callable:
    """The paper's fork-join switch as a generic combinator: the branch
    not chosen is never called."""
    return parallel_fn if parallel_wins else serial_fn


def matmul_chain(matrices, mesh=None, axis="data", model=None, engine=None,
                 use_kernel: bool = False):
    """Matrix-chain multiplication with per-product adaptive dispatch (the
    paper's 'matrix chain multiplication' case): association order by the
    classic dynamic program on FLOP counts, each product dispatched
    adaptively, over ``mesh`` where one is given.  All products share one
    engine, so repeated shapes hit its decision cache.  ``use_kernel`` as
    in :func:`adaptive_matmul` (the reference's chain takes the XLA dot)."""
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
        # chain intermediates are already distributed: io_at_master=False
        return adaptive_matmul(mult(i, s), mult(s + 1, j), mesh, axis,
                               engine=eng, io_at_master=False,
                               use_kernel=use_kernel)

    return mult(0, nmat - 1)
