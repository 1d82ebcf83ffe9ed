"""Public entry to the port's kernels.

A tensor on the CPU takes the kernel's plain PyTorch version
(``kernels/ref.py``); a CUDA tensor launches the Hopper kernel, or the call
raises.  The matmul has no padding to tile multiples: the kernel masks its
ragged edges, so a decode step with 4 rows pays for 4 rows, not 128.  The
sort pads rows to a power of 2, which the network needs.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bitonic_sort import bitonic_sort_cuda
from repro_torch.kernels.matmul import EPILOGUE_ACTIVATIONS, matmul_cuda
from repro_torch.kernels.ref import bitonic_sort_ref, matmul_fused_ref


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


def _sort_npad(n: int) -> int:
    """Power-of-two padded row length the bitonic network runs on."""
    return 1 << max((n - 1).bit_length(), 3)


def _sort_pad(x: torch.Tensor) -> torch.Tensor:
    """(rows, n) -> contiguous (rows, _sort_npad(n)), padded with the
    dtype's largest finite value."""
    rows, n = x.shape
    n_pad = _sort_npad(n)
    x = x.contiguous()
    if n_pad == n:
        return x
    info = torch.finfo if x.dtype.is_floating_point else torch.iinfo
    return torch.cat([x, x.new_full((rows, n_pad - n), info(x.dtype).max)],
                     dim=1)


def sort(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a 1-D tensor or of each row of a 2-D one.

    Rows are padded to ``_sort_npad(n)`` with the dtype's largest finite
    value and the padding is stripped after, as the reference does.  So the
    input must be finite: with n not a power of 2, a ``+inf`` sorts after
    the padding and is stripped, and the result holds the dtype's maximum
    in its place (the reference's behaviour, kept)."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    xp = _sort_pad(x)
    if xp.device.type == "cpu":
        out = bitonic_sort_ref(xp)
    else:
        out = bitonic_sort_cuda(xp)
    out = out[:, :x.shape[1]]
    return out[0] if squeeze else out
