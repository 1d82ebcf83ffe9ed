"""Public entry to the port's kernels.

A tensor on the CPU takes the kernel's plain PyTorch version
(``kernels/ref.py``); a CUDA tensor launches the Hopper kernel, or the call
raises.  There is no padding to tile multiples: the kernel masks its ragged
edges, so a decode step with 4 rows pays for 4 rows, not 128.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.matmul import EPILOGUE_ACTIVATIONS, matmul_cuda
from repro_torch.kernels.ref import matmul_fused_ref


def matmul(a: torch.Tensor, b: torch.Tensor, *, bias=None,
           activation: Optional[str] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``epilogue(a @ b + bias)`` with fp32 accumulation, cast to
    ``out_dtype`` (default ``a.dtype``).

    ``a`` (M, K) and ``b`` (K, N), or 4-D batches ``(Z1, Z2, M, K)`` and
    ``(Z1, Z2, K, N)`` of them; ``bias`` (N,); ``activation`` one of
    ``relu | gelu | silu | tanh`` (gelu in its tanh form) or None."""
    if activation is not None and activation not in EPILOGUE_ACTIVATIONS:
        raise ValueError(f"activation must be one of {EPILOGUE_ACTIVATIONS}, "
                         f"got {activation!r}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_fused_ref(a, b, bias=bias, activation=activation,
                                out_dtype=out_dtype)
    return matmul_cuda(a, b, bias=bias, activation=activation,
                       out_dtype=out_dtype)
