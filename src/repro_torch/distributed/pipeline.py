"""Pipeline parallelism (GPipe) over a mesh axis.

The layer stack is split into S contiguous stages laid out along one mesh
axis: stage s's parameters live on the position at index s.  Microbatches
stream through, hopping stage to stage with ``ppermute``; the bubble is
the standard (S-1)/(M+S-1) fraction.

Under the paper's lens, PP is the *dependency-pattern* case: layer k
depends on layer k-1, so the parallelism across stages comes only from
pipelining independent microbatches, managed by choosing M
(``pipeline_bubble_fraction``).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import mesh as mesh_lib
from repro_torch.distributed.mesh import Mesh
from repro_torch.tree import tree_map


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def best_microbatch_count(n_stages: int, tokens: int, max_micro: int = 64,
                          bubble_budget: float = 0.1) -> int:
    """Smallest M whose bubble is under budget (fewer, fatter microbatches
    amortize per-dispatch overhead: the paper's launch-overhead row)."""
    for m in range(1, max_micro + 1):
        if pipeline_bubble_fraction(n_stages, m) <= bubble_budget:
            return m
    return max_micro


def gpipe(stage_fn: Callable, stage_params, x: torch.Tensor, mesh: Mesh,
          axis: str = "pod") -> torch.Tensor:
    """Run ``x`` (M, mb, ...) through S = ``mesh.shape[axis]`` stages;
    returns the (M, mb, ...) outputs on ``x``'s device.

    ``stage_fn(params, h) -> h``; ``stage_params`` is a tree whose leaves
    are stage-major (S, ...).  Schedule (the reference's): at tick t
    (0 <= t < M+S-1) the stage at index r runs microbatch t - r if
    0 <= t - r < M, stage 0 reading it from ``x`` and the others from the
    activation that hopped in after the last tick.  An idle stage
    computes nothing (the reference computes and masks it to zeros, which
    is what it sends on).  Replicas along the mesh's other axes run the
    same schedule; the result is the last stage's buffer of the replica
    at index 0 of every other axis, where the reference sums the
    zero-filled buffers of all stages."""
    n_stages = mesh.shape[axis]
    m = x.shape[0]
    rank = mesh_lib.axis_index(mesh, axis)
    params = [tree_map(lambda leaf, i=i: mesh_lib.place(mesh, i,
                                                        leaf[rank[i]]),
                       stage_params) for i in range(mesh.size)]
    xs = [mesh_lib.place(mesh, i, x) if rank[i] == 0 else None
          for i in range(mesh.size)]
    fwd_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    outs = [None] * mesh.size
    carry = [None] * mesh.size
    for t in range(m + n_stages - 1):
        ys = []
        for i in range(mesh.size):
            mb = t - rank[i]
            with mesh.on(i):
                if 0 <= mb < m:
                    inp = xs[i][mb] if rank[i] == 0 else carry[i]
                    y = stage_fn(params[i], inp)
                    if rank[i] == n_stages - 1:
                        if outs[i] is None:
                            outs[i] = torch.zeros((m,) + tuple(y.shape),
                                                  dtype=y.dtype,
                                                  device=y.device)
                        outs[i][mb] = y
                else:
                    y = torch.zeros(x.shape[1:], dtype=x.dtype,
                                    device=mesh.devices[i])
                ys.append(y)
        if t < m + n_stages - 2:  # the last tick's activations go nowhere
            carry = mesh_lib.ppermute(mesh, axis, ys, fwd_perm)
    last = next(i for i in mesh.groups(axis)[0] if rank[i] == n_stages - 1)
    return mesh_lib.take(mesh, outs, last, x.device)
