"""Python side of the Hopper flash-attention kernels
(``csrc/flash_attention.cu``), forward and backward.

The kernels replace ``src/repro/kernels/flash_attention.py::
flash_attention_pallas``: causal online-softmax attention, (m, l, acc) in
fp32, on q (B, S, Hq, hd) and k, v (B, Skv, Hkv, hd) read through their
strides, kv head ``h // (Hq / Hkv)`` for query head ``h``.  The TPU kernel
has no backward; the port trains through this one, so the gradient is a
pair of kernels too.  Their plain PyTorch versions are
``kernels/ref.py::flash_attention_fwd_plain`` and
``flash_attention_bwd_plain``; the source note in ``flash_attention.cu``
says what bounds them on an H100.

``flash_attention_fwd_cuda`` and ``flash_attention_bwd_cuda`` are the only
places the kernels are launched.  Each checks what the kernels take and
raises on anything else, allocates its outputs with ``torch.empty``,
launches on the current stream, raises if a launch reports an error, and
counts the call in ``LAUNCHES`` (``forward``, ``backward``; ``grids``: the
CUDA launches, one forward and two backward).  ``FlashAttentionFn`` is the
autograd Function around them; on CPU tensors it runs the plain versions
in their place, so its plumbing is tested without a card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)  # hd the kernels are instantiated for
BLOCK = 64  # query and kv rows per CTA (kBQ, kBKV)
_MAX_GRID_YZ = 65535


class LaunchCounter:
    """Forward and backward calls, and the CUDA launches they made (one
    per forward, two per backward), since the last ``reset``."""

    def __init__(self):
        self.forward = 0
        self.backward = 0
        self.grids = 0

    def reset(self) -> None:
        self.forward = 0
        self.backward = 0
        self.grids = 0


LAUNCHES = LaunchCounter()


def _functions():
    lib = build.load("flash_attention")
    fwd, bwd = lib.repro_flash_fwd, lib.repro_flash_bwd
    if fwd.argtypes is None:
        # every pointer and the stream as c_void_p: ctypes would otherwise
        # pass a Python int as a 32-bit int and cut the address
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        s = ctypes.POINTER(ctypes.c_longlong)
        fwd.argtypes = [p, s, p, s, p, s, p, p, i, i, i, i, i, i, i, f, i, p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [p, s, p, s, p, s, p, s, p, s, p, p, p, p, p,
                        i, i, i, i, i, i, i, f, i, p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> None:
    """Raise unless q (B, S, Hq, hd) and k, v (B, Skv, Hkv, hd) are
    attention operands; causal attention needs S == Skv (the mask is
    aligned top-left, as the TPU kernel's)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention takes q (B, S, Hq, hd) and k, v "
                         f"(B, Skv, Hkv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or hq % k.shape[2]:
        raise ValueError(f"flash attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, head dim, or "
                         f"Hq not a multiple of Hkv)")
    if causal and s != k.shape[1]:
        raise ValueError(f"causal flash attention needs S == Skv (the mask "
                         f"is aligned top-left), got S={s}, Skv={k.shape[1]}")


def _check_cuda(tensors, hd: int) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"flash attention kernel needs CUDA tensors on "
                             f"one device, got {t.device}")
        if t.dtype != tensors[0].dtype or t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash attention kernel takes float32 or "
                            f"bfloat16 operands of one dtype, got {t.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dim in "
                         f"{HEAD_DIMS}, got {hd}")


def _grid_check(b: int, h: int) -> None:
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"flash attention grid too large: batch {b}, "
                         f"heads {h}")


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             sm_scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward: the output (B, S, Hq, hd) in q's dtype and the
    log-sum-exp (B, Hq, S) fp32."""
    check_shapes(q, k, v, causal)
    b, s, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _check_cuda((q, k, v), hd)
    _grid_check(b, hq)
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    o = torch.empty((b, s, hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fwd, _ = _functions()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), _strides(q), k.data_ptr(), _strides(k),
                  v.data_ptr(), _strides(v), o.data_ptr(), lse.data_ptr(),
                  _DTYPE_CODE[q.dtype], b, s, skv, hq, hkv, hd, scale,
                  int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed: "
                           f"cudaError {err} for q {tuple(q.shape)} k "
                           f"{tuple(k.shape)} {q.dtype}")
    LAUNCHES.forward += 1
    LAUNCHES.grids += 1
    return o, lse


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool = True,
                             sm_scale: Optional[float] = None):
    """Launch the backward (two kernels): (dq, dk, dv) in the inputs'
    dtype, dk and dv summed over each kv head's group of query heads."""
    check_shapes(q, k, v, causal)
    b, s, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _check_cuda((q, k, v, o, do), hd)
    _grid_check(b, hq)
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (b, hq, s) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash attention backward: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} must match q {tuple(q.shape)} "
                         f"and lse must be contiguous fp32 (B, Hq, S)")
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    dq = torch.empty((b, s, hq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, hkv, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, skv, hkv, hd), dtype=v.dtype, device=q.device)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    _, bwd = _functions()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = bwd(q.data_ptr(), _strides(q), k.data_ptr(), _strides(k),
                  v.data_ptr(), _strides(v), o.data_ptr(), _strides(o),
                  do.data_ptr(), _strides(do), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), _DTYPE_CODE[q.dtype], b, s, skv, hq, hkv,
                  hd, scale, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: "
                           f"cudaError {err} for q {tuple(q.shape)} k "
                           f"{tuple(k.shape)} {q.dtype}")
    LAUNCHES.backward += 1
    LAUNCHES.grids += 2
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Causal (or full) attention with the flash kernels as forward and
    backward; CPU tensors take the plain versions in the kernels' place."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True,
                sm_scale: Optional[float] = None):
        fwd = flash_attention_fwd_plain if q.device.type == "cpu" \
            else flash_attention_fwd_cuda
        o, lse = fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" \
            else flash_attention_bwd_cuda
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None
