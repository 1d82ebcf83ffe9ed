"""Dependency analysis: the paper's precondition for parallelization.

The paper insists each problem needs "detailed and independent analysis of
its level of parallelism" before parallelizing.  Here that analysis runs on
the ``torch.fx`` graph of a PyTorch function or module: cost each node
(shapes from ``ShapeProp`` on the example arguments) and compute

    available parallelism = total cost / critical-path cost

(a work/span analysis).  A parallelism degree below the chip count is the
paper's "sub tasks not independent enough" warning.  A Python loop unrolls
in the traced graph, so its work is counted once per iteration.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from collections import defaultdict
from typing import Dict

import torch
import torch.fx
from torch.fx.passes.shape_prop import ShapeProp, TensorMetadata

_MATMULS = {"matmul", "mm", "bmm", "linear"}
_REDUCTIONS = {"sum", "amax", "amin", "argmax", "argmin"}
# projections of a node's tuple or structseq output: no work
_FREE = {operator.getitem, getattr}


@dataclasses.dataclass
class DependencyReport:
    total_flops: float
    critical_flops: float
    n_eqns: int
    by_primitive: Dict[str, float]

    @property
    def parallelism(self) -> float:
        return self.total_flops / max(self.critical_flops, 1.0)

    def sufficient_for(self, chips: int) -> bool:
        return self.parallelism >= chips

    def summary(self) -> str:
        top = sorted(self.by_primitive.items(), key=lambda kv: -kv[1])[:5]
        tops = ", ".join(f"{k}={v:.3g}" for k, v in top)
        return (
            f"eqns={self.n_eqns} work={self.total_flops:.3g} "
            f"span={self.critical_flops:.3g} parallelism={self.parallelism:.1f} "
            f"[{tops}]"
        )


def _size(meta) -> float:
    """Elements of a node's value: a tensor's numel, summed over a tuple;
    0 for a value that is not a tensor (a Python scalar or size)."""
    if isinstance(meta, TensorMetadata):
        return float(math.prod(meta.shape))
    if isinstance(meta, (tuple, list)):
        return sum(_size(m) for m in meta)
    return 0.0


def _meta(arg):
    return arg.meta.get("tensor_meta") if isinstance(arg, torch.fx.Node) else None


def _op_name(gm: torch.fx.GraphModule, node: torch.fx.Node) -> str:
    if node.op == "call_method":
        return node.target
    if node.op == "call_module":
        return type(gm.get_submodule(node.target)).__name__.lower()
    return getattr(node.target, "__name__", str(node.target))


def _node_cost(name: str, node: torch.fx.Node) -> float:
    """Rough FLOP estimate of one node, as the reference's ``_eqn_cost``:
    a product 2 * batch * m * n * k, a sort n log2 n, a reduction its
    input's size, any other operation its output's size."""
    if node.target in _FREE:
        return 0.0
    out = _size(node.meta.get("tensor_meta"))
    a = _meta(node.args[0]) if node.args else None
    if name in _MATMULS and isinstance(a, TensorMetadata):
        return 2.0 * out * a.shape[-1]  # out = batch * m * n, k contracted
    if name in _REDUCTIONS and a is not None:
        return _size(a)
    if name == "sort" and a is not None:
        n = _size(a)
        return n * max(math.log2(max(n, 2.0)), 1.0)
    return out


def analyze_dependencies(fn, *example_args, **kwargs) -> DependencyReport:
    """Work/span of ``fn`` (a function or ``nn.Module``) traced by
    ``torch.fx.symbolic_trace`` and run once on ``example_args`` for the
    shapes; keyword arguments are traced as constants."""
    gm = torch.fx.symbolic_trace(fn, concrete_args=kwargs or None)
    ShapeProp(gm).propagate(*example_args)
    finish: Dict[torch.fx.Node, float] = defaultdict(float)
    total, n_eqns = 0.0, 0
    by_prim: Dict[str, float] = defaultdict(float)
    for node in gm.graph.nodes:
        if node.op not in ("call_function", "call_method", "call_module"):
            continue  # placeholders, constants and the output: no work
        name = _op_name(gm, node)
        c = _node_cost(name, node)
        total += c
        n_eqns += 1
        by_prim[name] += c
        start = max((finish[v] for v in node.all_input_nodes), default=0.0)
        finish[node] = start + c
    return DependencyReport(
        total_flops=total,
        critical_flops=max(finish.values(), default=0.0),
        n_eqns=n_eqns,
        by_primitive=dict(by_prim),
    )
