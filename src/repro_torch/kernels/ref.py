"""Plain PyTorch versions of the port's kernels: the CPU path, and the
oracle each kernel is held against on the card."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

EPILOGUES = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh form; torch's default is the exact one
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """fp32-accumulated matmul."""
    out = torch.matmul(a.float(), b.float())
    return out.to(out_dtype or a.dtype)


def matmul_fused_ref(a: torch.Tensor, b: torch.Tensor, bias=None,
                     activation: Optional[str] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Matmul + epilogue (bias add, activation, cast) as separate ops in
    fp32: the oracle for the kernel's fused epilogue."""
    out = torch.matmul(a.float(), b.float())
    if bias is not None:
        out = out + bias.reshape(-1).float()
    if activation is not None:
        out = EPILOGUES[activation](out)
    return out.to(out_dtype or a.dtype)


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    """Row-wise ascending sort: the test oracle."""
    return torch.sort(x, dim=-1).values


def bitonic_sort_ref(x: torch.Tensor) -> torch.Tensor:
    """The bitonic network of the sort kernel, stage by stage, on each row
    of ``x`` (rows, n), n a power of 2: for k = 2, ..., n and j = k/2, ...,
    1, element i meets its partner i ^ j (a flip of the middle axis of
    (n / 2j, 2, j)) and the pair is ordered ascending where i & k == 0.
    Min and max by comparison, as the kernel takes them."""
    rows, n = x.shape
    if n & (n - 1):
        raise ValueError(f"row length {n} must be a power of 2")
    idx = torch.arange(n, device=x.device)
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            partner = x.reshape(rows, n // (2 * j), 2, j).flip(2).reshape(
                rows, n)
            less = partner < x
            lo = torch.where(less, partner, x)
            hi = torch.where(less, x, partner)
            keep_lo = ((idx & k) == 0) == ((idx & j) == 0)
            x = torch.where(keep_lo, lo, hi)
            j //= 2
        k *= 2
    return x
