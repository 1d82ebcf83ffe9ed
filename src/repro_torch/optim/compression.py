"""Gradient compression for a cross-host all-reduce: top-k sparsification
with error feedback, then int8 quantization, on the gradient tree.  The
round trip models what the receiving end sees; the metric is the fraction
of bytes on the wire.  Off by default (``TrainLoopConfig.compression``).

On a mesh (``compress_gradients_mesh``) each position holds its blocks of
the logical gradient and of the residual, and the result is the logical
tensor's, bit for bit: k, the threshold and the int8 scale are those of
the whole leaf, each distinct block counted once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import (leaves, leaves_with_paths, tree_map,
                              tree_map_with_path, tree_unzip)


@dataclasses.dataclass(frozen=True)
class CompressionState:
    residual: Any  # error-feedback accumulator (a tree like the grads)


def init_compression(params) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _kept(numel: int, keep_frac: float) -> Optional[int]:
    """The entries a tensor of ``numel`` keeps: None (all of them) up to
    16, else k = max(int(numel * keep_frac), 1)."""
    return None if numel <= 16 else max(int(numel * keep_frac), 1)


def _topk_mask(g: torch.Tensor, keep_frac: float) -> torch.Tensor:
    k = None if g.dim() == 0 else _kept(g.numel(), keep_frac)
    if k is None:
        return torch.ones_like(g, dtype=torch.bool)
    thresh = torch.topk(g.abs().reshape(-1), k).values[-1]
    return g.abs() >= thresh


def _quantize_int8(g: torch.Tensor, top: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and the scale, one a tensor: ``top`` (default
    max|g|, the whole tensor's on a mesh) over 127."""
    top = g.abs().max() if top is None else top
    scale = torch.clamp(top, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_gradients(grads, state: Optional[CompressionState], *,
                       keep_frac: float = 0.1, quantize: bool = True):
    """Returns (compressed-then-decompressed grads, new state, metrics)."""
    if state is None:
        state = init_compression(grads)

    def one(_, g, r):
        g32 = g.float() + r  # error feedback
        kept = torch.where(_topk_mask(g32, keep_frac), g32, 0.0)
        if quantize:
            kept = _dequantize(*_quantize_int8(kept))
        return kept.to(g.dtype), g32 - kept

    out, res = tree_unzip(one, 2, grads, state.residual)
    ratio = wire_bytes_ratio([g.numel() for g in leaves(grads)], keep_frac,
                             quantize)
    return out, CompressionState(residual=res), {"wire_bytes_ratio": ratio}


def wire_bytes_ratio(sizes: Sequence[int], keep_frac: float,
                     quantize: bool) -> float:
    """The bytes sent over the fp32 gradient's, from the leaves' (logical)
    sizes: k values a leaf (every one up to 16), one byte each quantized,
    four otherwise."""
    sent = sum(n if _kept(n, keep_frac) is None else _kept(n, keep_frac)
               for n in sizes)
    return (sent * (1 if quantize else 4)) / (sum(sizes) * 4)


def compress_gradients_mesh(ctx, grads: List[Any],
                            states: Optional[List[CompressionState]],
                            specs: Any, *, keep_frac: float = 0.1,
                            quantize: bool = True):
    """``compress_gradients`` of the logical gradient on a mesh: ``grads``
    one tree a position, each leaf that position's block of the logical
    gradient (a replicated piece the same bits on every replica, as
    ``ShardingCtx.replica_sum`` leaves it), ``states`` the residuals
    placed by the same ``specs`` (None: zeros).  Returns (grads, states,
    metrics), lists with one entry a position.

    Each leaf keeps what the whole leaf would: k from the logical size;
    the threshold the k-th largest |g| of the whole leaf, which is the
    k-th largest of the union of every distinct block's own top min(k,
    block size) (each block counted once, on the first position holding
    it: ``is_representative``); the int8 scale the maximum over the whole
    kept tensor.  Both come from one ``all_gather`` over the whole mesh
    each (a leaf's candidates, then every leaf's maximum at once), so
    every position holds the same threshold and scale bits and compresses
    its own block.  ``wire_bytes_ratio`` is computed from the logical
    sizes."""
    from repro_torch.distributed.mesh import all_gather
    from repro_torch.distributed.sharding import blocks, is_representative

    mesh = ctx.mesh
    n = mesh.size
    axes = tuple(mesh.axis_names)
    if states is None:
        states = ctx.map(init_compression, grads)
    order: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda path, _, sp: order.append((path, sp)),
                       grads[0], specs)
    flat = [dict(leaves_with_paths(g)) for g in grads]
    res = [dict(leaves_with_paths(st.residual)) for st in states]
    g32 = [dict() for _ in range(n)]
    kept = [dict() for _ in range(n)]
    sizes = []
    for path, spec in order:
        block = flat[0][path]
        numel = block.numel() * blocks(spec, mesh)
        sizes.append(numel)
        gs = ctx.map(lambda f, r: f[path].float() + r[path], flat, res)
        k = _kept(numel, keep_frac)
        if k is None:
            thresh = [None] * n
        else:
            m = min(k, block.numel())
            tops = all_gather(mesh, axes, ctx.map(
                lambda g: torch.topk(g.abs().reshape(-1), m).values, gs))
            reps = [i for i in range(n) if is_representative(spec, mesh, i)]
            thresh = ctx.map(lambda t: torch.topk(
                t[reps].reshape(-1), k).values[-1], tops)
        for i in range(n):
            g32[i][path] = gs[i]
            with mesh.on(i):
                kept[i][path] = gs[i] if thresh[i] is None else torch.where(
                    gs[i].abs() >= thresh[i], gs[i], 0.0)
    if quantize:
        tops = all_gather(mesh, axes, ctx.map(lambda kp: torch.stack(
            [kp[p].abs().max() for p, _ in order]), kept))
        for i in range(n):
            with mesh.on(i):
                top = tops[i].amax(0)
                for j, (path, _) in enumerate(order):
                    kept[i][path] = _dequantize(*_quantize_int8(
                        kept[i][path], top[j]))
    out, new = [], []
    for i in range(n):
        with mesh.on(i):
            out.append(tree_map_with_path(
                lambda path, g: kept[i][path].to(g.dtype), grads[i]))
            new.append(CompressionState(residual=tree_map_with_path(
                lambda path, _: g32[i][path] - kept[i][path], grads[i])))
    ratio = wire_bytes_ratio(sizes, keep_frac, quantize)
    return out, new, [{"wire_bytes_ratio": ratio} for _ in range(n)]
