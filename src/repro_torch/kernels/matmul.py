"""Python side of the Hopper matmul kernel (``csrc/matmul.cu``).

The kernel replaces ``src/repro/kernels/matmul.py::matmul_pallas``: it
computes ``epilogue(A @ B + bias)`` with an fp32 accumulator and one cast,
for 2-D operands or 4-D batches of them read through their strides.  The
source note in ``matmul.cu`` says what bounds it on an H100 and why every
output element is summed in a fixed k order (batch invariance).

``matmul_cuda`` is the only place the kernel is launched.  It checks what
the kernel takes and raises on anything else, allocates the output with
``torch.empty``, launches on the current stream, raises if the launch
reports an error, and counts the launch in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

EPILOGUE_ACTIVATIONS = ("relu", "gelu", "silu", "tanh")
_ACT_CODE = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_LARGE_TILE_ROWS = 64  # rows per block above 16 rows and columns (by_shape)


class LaunchCounter:
    """Kernel launches since the last ``reset`` (a plain integer)."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0


LAUNCHES = LaunchCounter()


def _function():
    fn = build.load("matmul").repro_matmul
    if fn.argtypes is None:
        # every pointer as c_void_p: ctypes would otherwise pass a Python
        # int as a 32-bit int and cut the address
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [p, s, i, p, s, i, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _strides4(t: torch.Tensor):
    st = t.stride()
    return (ctypes.c_longlong * 4)(*((0, 0) + st if t.dim() == 2 else st))


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the kernel: ``a`` (M, K) and ``b`` (K, N), or ``a`` (Z1, Z2, M,
    K) and ``b`` (Z1, Z2, K, N) with any strides; ``bias`` (N,) is added in
    fp32; the result is contiguous in ``out_dtype`` (default ``a.dtype``)."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(f"matmul_cuda needs CUDA tensors, got {a.device} "
                         f"and {b.device}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, "
                         f"{b.device}")
    out_dtype = out_dtype or a.dtype
    for name, dt in (("a", a.dtype), ("b", b.dtype), ("out", out_dtype)):
        if dt not in _DTYPE_CODE:
            raise TypeError(f"matmul kernel takes float32 or bfloat16; "
                            f"{name} is {dt}")
    if activation not in _ACT_CODE:
        raise ValueError(f"activation must be None or one of "
                         f"{EPILOGUE_ACTIVATIONS}, got {activation!r}")
    if a.dim() not in (2, 4) or b.dim() != a.dim():
        raise ValueError(f"matmul kernel takes 2-D or 4-D operands of equal "
                         f"rank, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    z1, z2 = (1, 1) if a.dim() == 2 else a.shape[:2]
    rows_per_block = 16 if min(m, n) <= 16 else _LARGE_TILE_ROWS
    if z1 * z2 > _MAX_GRID_YZ or -(-m // rows_per_block) > _MAX_GRID_YZ:
        raise ValueError(f"matmul kernel grid too large for shape "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if max(m, n, k) >= 2**31:
        raise ValueError("matmul kernel dimensions must fit in int32")
    bias_f32 = None
    if bias is not None:
        if bias.numel() != n or bias.device != a.device:
            raise ValueError(f"bias must hold {n} values on {a.device}, got "
                             f"{tuple(bias.shape)} on {bias.device}")
        bias_f32 = bias.reshape(n).to(torch.float32).contiguous()
    out = torch.empty(a.shape[:-1] + (n,), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    fn = _function()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), _strides4(a), _DTYPE_CODE[a.dtype],
                 b.data_ptr(), _strides4(b), _DTYPE_CODE[b.dtype],
                 None if bias_f32 is None else bias_f32.data_ptr(),
                 out.data_ptr(), _DTYPE_CODE[out_dtype], z1, z2, m, n, k,
                 _ACT_CODE[activation], stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: cudaError {err} "
                           f"for {tuple(a.shape)} @ {tuple(b.shape)}")
    LAUNCHES.count += 1
    return out
