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
