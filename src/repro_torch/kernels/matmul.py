"""Python side of the Hopper matmul kernel (``csrc/matmul.cu``).

The kernel replaces ``src/repro/kernels/matmul.py::matmul_pallas``: it
computes ``epilogue(A @ B + bias)`` with an fp32 accumulator and one cast,
for 2-D operands or 4-D batches of them read through their strides.  The
source note in ``matmul.cu`` says what bounds it on an H100 and why a
row's bits do not depend on how many rows it is multiplied with (batch
invariance).

Three paths, picked by ``choose_path`` from the operands' dtypes alone:
bf16 x bf16 runs on the tensor cores (wgmma fed by TMA), fp32 x bf16 on
the same kernel with the fp32 operand split into two bf16 halves
(``split_hi_lo``), fp32 x fp32 on the FP32-pipe FMA kernel.  Neither the
path nor the tile (``tile_n``, from N alone) depends on M or the batch.

``matmul_cuda`` is the only place the kernel is launched.  It checks what
the kernel takes and raises on anything else, allocates the output with
``torch.empty``, launches on the current stream, raises if the launch
reports an error, and counts the launch in ``LAUNCHES`` (in total, by
path, and the tensor-core operands no tensor map loads, which the
producer's threads copy) and in any open ``calls.CallLog``.  Meta
operands (the dry run) take the same checks and allocations, the split
halves included, and are recorded in the log where the card would launch;
nothing launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, calls

EPILOGUE_ACTIVATIONS = ("relu", "gelu", "silu", "tanh")
PATHS = ("tensor_core", "split", "fma")
_PATH_CODE = {"fma": 0, "tensor_core": 1, "split": 2}
_ACT_CODE = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_TC_TILE_M = 128  # rows per CTA on the tensor-core paths (FMA: by_shape)
_TC_TILE_K = 64  # k per stage (matmul.cu kBK)
_TMA_ALIGN = 16  # bytes: a tensor map's base and every stride it steps
TILES = (64, 128)  # the tile widths N the tensor-core kernel is built for


class LaunchCounter:
    """Kernel launches since the last ``reset`` (a plain integer), the same
    launches by path and by CUDA stream (the stream's handle: a mesh
    position's work runs on its own), the 4-D batched launches by stream
    (the experts' products among them), and the tensor-core operands that
    no tensor map could load (a split operand counts once: its halves
    share strides)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.by_path = dict.fromkeys(PATHS, 0)
        self.by_stream: dict = {}
        self.batched_by_stream: dict = {}
        self.copied_operands = 0


LAUNCHES = LaunchCounter()


def choose_path(a_dtype: torch.dtype, b_dtype: torch.dtype) -> str:
    """The kernel path for operands of these dtypes: ``tensor_core`` for
    bf16 x bf16, ``split`` for fp32 x bf16 either way round, ``fma`` for
    fp32 x fp32.  A function of the dtypes alone: never of M, N, K or the
    batch, so a row takes the same path whatever it is multiplied with."""
    pair = {a_dtype, b_dtype}
    if not pair <= set(_DTYPE_CODE):
        raise TypeError(f"matmul kernel takes float32 or bfloat16 operands, "
                        f"got {a_dtype} and {b_dtype}")
    if pair == {torch.bfloat16}:
        return "tensor_core"
    if pair == {torch.float32}:
        return "fma"
    return "split"


def tile_n(n: int) -> int:
    """Output columns per CTA on the tensor-core paths, from N alone: 128
    for N >= 4096, else 64 (twice the CTAs, for bytes in flight at
    decode)."""
    return 128 if n >= 4096 else 64


def tc_smem_bytes(tile: int, split: bool) -> int:
    """Dynamic shared memory of a tensor-core CTA at tile width ``tile``
    (``matmul.cu`` ``TcShape``): a ring of stages, each an A tile of 128 x
    64 bf16 and a B tile of ``tile`` x 64 (on the split path one of them
    twice), as many as fit 96 KB (tensor core) or 200 KB (split), at most
    8; plus 1024 bytes to align the ring and two mbarriers a stage."""
    budget = (200 if split else 96) * 1024
    a = _TC_TILE_M * _TC_TILE_K * 2
    stage = a + tile * _TC_TILE_K * 2 + (a if split else 0)
    stages = min(8, budget // stage)
    return 1024 + stages * stage + 2 * stages * 8


def kernel_info(tile: int, split: bool) -> dict:
    """The tensor-core kernel at tile width ``tile`` (A split on the split
    path): dynamic shared memory, stages, registers a thread, local (spill)
    bytes a thread and resident CTAs an SM, as the CUDA runtime reports
    them on the current card."""
    fn = build.load("matmul").repro_matmul_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(tile, int(split), out)
    if err != 0:
        raise RuntimeError(f"matmul kernel info failed: cudaError {err}")
    return dict(zip(("smem_bytes", "stages", "registers", "local_bytes",
                     "ctas_per_sm"), out))


def split_hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` as two bf16 tensors of its strides, ``hi = bf16(x)`` and
    ``lo = bf16(x - hi)``: ``hi + lo`` is ``x`` to within 2^-17 |x| (for
    normal values).  Zeros stay zeros; where ``hi`` is not finite (±inf,
    NaN) ``lo`` is 0, so the product passes them through."""
    hi = x.to(torch.bfloat16)
    rest = x - hi  # NaN or -inf only where hi is not finite
    rest.nan_to_num_(0.0, 0.0, 0.0)
    return hi, torch.empty_like(hi).copy_(rest)


def operand_mode(t: torch.Tensor, operand: str) -> Tuple[bool, bool]:
    """(mn_major, tma) of a bf16 operand of the tensor-core kernel; ``t`` is
    ``a`` (rows m, k last) or ``b`` (k, then columns n), 2-D or 4-D.

    K-major where the stride along k is 1, else MN-major where the stride
    along m (for ``a``) or n (for ``b``) is 1, else K-major copied by the
    producer's threads.  A tensor map can load it where the base is 16-byte
    aligned and every other dimension longer than 1 steps a positive
    multiple of 16 bytes; an extent of 1 is never stepped along."""
    if operand not in ("a", "b"):
        raise ValueError(f"operand must be 'a' or 'b', got {operand!r}")
    shape, strides = tuple(t.shape), tuple(t.stride())
    k_axis, mn_axis = (t.dim() - 1, t.dim() - 2) if operand == "a" else \
        (t.dim() - 2, t.dim() - 1)

    def unit(axis):
        return strides[axis] == 1 or shape[axis] == 1

    mn_major = not unit(k_axis) and unit(mn_axis)
    fast = mn_axis if mn_major else k_axis
    size = t.element_size()
    tma = unit(fast) and t.data_ptr() % _TMA_ALIGN == 0 and all(
        shape[i] == 1 or (strides[i] > 0 and strides[i] * size % _TMA_ALIGN
                          == 0 and strides[i] * size < 2 ** 40)
        for i in range(t.dim()) if i != fast) and max(shape) < 2 ** 32
    return mn_major, tma


def _mode_code(t: torch.Tensor, operand: str) -> int:
    mn_major, tma = operand_mode(t, operand)
    return int(mn_major) | (int(tma) << 1)


def _function():
    fn = build.load("matmul").repro_matmul
    if fn.argtypes is None:
        # every pointer as c_void_p: ctypes would otherwise pass a Python
        # int as a 32-bit int and cut the address
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [i, p, p, s, i, i, p, p, s, i, i, p, p, i, i, i, i, i,
                       i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _strides4(t: torch.Tensor):
    st = t.stride()
    return (ctypes.c_longlong * 4)(*((0, 0) + st if t.dim() == 2 else st))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def call_mode(ndim: int, out_dtype: torch.dtype,
              activation: Optional[str]) -> str:
    """What a call log tells apart besides the path: the operands' rank,
    the output's dtype and the epilogue (``"2-D bfloat16 silu"``)."""
    mode = f"{ndim}-D {str(out_dtype).replace('torch.', '')}"
    return mode if activation is None else f"{mode} {activation}"


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None,
                out_dtype: Optional[torch.dtype] = None,
                tile: Optional[int] = None,
                halves: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Launch the kernel: ``a`` (M, K) and ``b`` (K, N), or ``a`` (Z1, Z2, M,
    K) and ``b`` (Z1, Z2, K, N) with any strides; ``bias`` (N,) is added in
    fp32; the result is contiguous in ``out_dtype`` (default ``a.dtype``).
    The path is ``choose_path(a.dtype, b.dtype)``; ``tile`` (in ``TILES``)
    is the tensor-core paths' tile width, ``tile_n(n)`` when None (the FMA
    path has none).  ``halves`` on the split path: the fp32 operand's
    ``split_hi_lo`` halves, made by the caller (``ops.k_blocked`` splits
    a whole operand once for all its K blocks); None splits here."""
    if not ((a.is_cuda and b.is_cuda) or (a.is_meta and b.is_meta)):
        raise ValueError(f"matmul_cuda needs CUDA tensors, got {a.device} "
                         f"and {b.device}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, "
                         f"{b.device}")
    out_dtype = out_dtype or a.dtype
    path = choose_path(a.dtype, b.dtype)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul kernel writes float32 or bfloat16; out is "
                        f"{out_dtype}")
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
    if tile is None:
        tile = tile_n(n)
    elif tile not in TILES:
        raise ValueError(f"matmul tile must be one of {TILES}, got {tile}")
    z1, z2 = (1, 1) if a.dim() == 2 else a.shape[:2]
    if path == "fma":  # grid (N tiles, M tiles, batch)
        grid = (1, -(-m // (16 if min(m, n) <= 16 else 64)), z1 * z2)
    else:  # grid (tiles, 1, batch)
        grid = (-(-m // _TC_TILE_M) * -(-n // tile), 1, z1 * z2)
    if grid[0] >= 2**31 or max(grid[1:]) > _MAX_GRID_YZ:
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
    cost = calls.matmul_cost(a, b, out_dtype, bias)
    mode = call_mode(a.dim(), out_dtype, activation)
    a_lo = b_lo = None
    if path == "split":
        if halves is not None and (
                halves[0].shape != (a if a.dtype == torch.float32 else
                                    b).shape
                or {h.dtype for h in halves} != {torch.bfloat16}):
            raise ValueError("halves must be the fp32 operand's bf16 hi and "
                             "lo, of its shape")
        if a.dtype == torch.float32:
            a, a_lo = halves if halves is not None else split_hi_lo(a)
        else:
            b, b_lo = halves if halves is not None else split_hi_lo(b)
    if a.is_meta:  # the dry run: the card path's allocations, no launch
        calls.record("matmul", path, mode, cost)
        return out
    tc = path != "fma"  # the FMA kernel reads any strides, no modes
    a_mode, b_mode = (_mode_code(a, "a"), _mode_code(b, "b")) if tc else (0, 0)
    fn = _function()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(_PATH_CODE[path], a.data_ptr(), _ptr(a_lo), _strides4(a),
                 _DTYPE_CODE[a.dtype], a_mode,
                 b.data_ptr(), _ptr(b_lo), _strides4(b), _DTYPE_CODE[b.dtype],
                 b_mode,
                 None if bias_f32 is None else bias_f32.data_ptr(),
                 out.data_ptr(), _DTYPE_CODE[out_dtype], z1, z2, m, n, k,
                 _ACT_CODE[activation], tile, stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel ({path} path) launch failed: "
                           f"code {err} for {tuple(a.shape)} @ "
                           f"{tuple(b.shape)}")
    calls.record("matmul", path, mode, cost)
    LAUNCHES.count += 1
    LAUNCHES.by_path[path] += 1
    LAUNCHES.by_stream[stream] = LAUNCHES.by_stream.get(stream, 0) + 1
    if a.dim() == 4:
        LAUNCHES.batched_by_stream[stream] = \
            LAUNCHES.batched_by_stream.get(stream, 0) + 1
    if tc:  # bit 1 of a mode: a tensor map loads the operand
        LAUNCHES.copied_operands += sum(not mode & 2 for mode in (a_mode,
                                                                 b_mode))
    return out
