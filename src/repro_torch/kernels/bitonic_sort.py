"""Python side of the Hopper bitonic sort kernel (``csrc/bitonic_sort.cu``).

The kernel replaces ``src/repro/kernels/bitonic_sort.py::
bitonic_sort_pallas``: the same bitonic network on every row of a (rows, n)
array, n a power of 2.  Its plain PyTorch version, step by step, is
``kernels/ref.py::bitonic_sort_ref``.  The source note in
``bitonic_sort.cu`` says what bounds it on an H100 and how its launches
split the network between shared and device memory.

``bitonic_sort_cuda`` is the only place the kernel is launched.  It checks
what the kernel takes and raises on anything else, allocates the output
with ``torch.empty``, launches on the current stream, raises if a launch
reports an error, and counts the call in ``LAUNCHES`` (``count``: calls;
``grids``: the CUDA kernel launches they made, 120 for a 2^26 row).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}
TILE = 4096  # elements one block sorts in shared memory (kTile)


class LaunchCounter:
    """Kernel calls (``count``) and their CUDA launches (``grids``) since
    the last ``reset``."""

    def __init__(self):
        self.count = 0
        self.grids = 0

    def reset(self) -> None:
        self.count = 0
        self.grids = 0


LAUNCHES = LaunchCounter()


def grid_launches(n: int) -> int:
    """CUDA launches the kernel makes for rows of length ``n``: one tile
    sort, then for each k > TILE one launch per j >= TILE and one to finish
    the tiles."""
    s, t = n.bit_length() - 1, min(n, TILE).bit_length() - 1
    return 1 + sum(m - t + 1 for m in range(t + 1, s + 1))


def _function():
    fn = build.load("bitonic_sort").repro_bitonic_sort
    if fn.argtypes is None:
        # every pointer and the stream as c_void_p: ctypes would otherwise
        # pass a Python int as a 32-bit int and cut the address
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, ctypes.c_int, ll, ll, p,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return fn


def bitonic_sort_cuda(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of the contiguous CUDA tensor ``x`` (rows, n) ascending,
    n a power of 2 (at least 2), float32 or int32; returns a new tensor."""
    if not x.is_cuda:
        raise ValueError(f"bitonic_sort_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"bitonic sort kernel takes float32 or int32, got "
                        f"{x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"bitonic sort kernel takes (rows, n), got "
                         f"{tuple(x.shape)}")
    rows, n = x.shape
    if n < 2 or n & (n - 1):
        raise ValueError(f"row length {n} must be a power of 2, at least 2")
    if not x.is_contiguous():
        raise ValueError("bitonic sort kernel takes a contiguous tensor")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    fn = _function()
    grids = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], rows, n,
                 stream, ctypes.byref(grids))
    if err != 0:
        raise RuntimeError(f"bitonic sort kernel launch failed: cudaError "
                           f"{err} for {tuple(x.shape)} {x.dtype}")
    LAUNCHES.count += 1
    LAUNCHES.grids += grids.value
    return out
