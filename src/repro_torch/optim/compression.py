"""Gradient compression for a cross-host all-reduce: top-k sparsification
with error feedback, then int8 quantization, on the gradient tree.  The
round trip models what the receiving end sees; the metric is the fraction
of bytes on the wire.  Off by default (``TrainLoopConfig.compression``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map, tree_unzip


@dataclasses.dataclass(frozen=True)
class CompressionState:
    residual: Any  # error-feedback accumulator (a tree like the grads)


def init_compression(params) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _topk_mask(g: torch.Tensor, keep_frac: float) -> torch.Tensor:
    if g.dim() == 0 or g.numel() <= 16:
        return torch.ones_like(g, dtype=torch.bool)
    k = max(int(g.numel() * keep_frac), 1)
    thresh = torch.topk(g.abs().reshape(-1), k).values[-1]
    return g.abs() >= thresh


def _quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
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
    sizes = [g.numel() for g in leaves(grads)]
    sent = sum(max(int(n * keep_frac), 1) if n > 16 else n for n in sizes)
    ratio = (sent * (1 if quantize else 4)) / (sum(sizes) * 4)
    return out, CompressionState(residual=res), {"wire_bytes_ratio": ratio}
