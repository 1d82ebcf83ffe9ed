"""Python side of the Hopper flash-attention kernels
(``csrc/flash_attention.cu``), forward and backward.

The kernels replace ``src/repro/kernels/flash_attention.py::
flash_attention_pallas``: causal online-softmax attention, (m, l, acc) in
fp32, on q (B, S, Hq, hd) and k, v (B, Skv, Hkv, hd) read through their
strides, kv head ``h // (Hq / Hkv)`` for query head ``h``.  The TPU kernel
has no backward; the port trains through this one, so the gradient is
kernels too.  Their plain PyTorch versions are
``kernels/ref.py::flash_attention_fwd_plain`` and
``flash_attention_bwd_plain``; the source note in ``flash_attention.cu``
says what bounds them on an H100.

Two paths, picked by ``choose_path`` from the dtype and head dim alone
(never B, S or the heads): bf16 at hd 64, 96, 128 and 256 runs the
tensor-core kernels (wgmma fed by TMA; the backward's dK/dV per query
head, summed per kv head in a fixed order; hd 96 on the hd-128 tiles with
32 zero columns, hd 256 on 64-row kv stages in the forward, 32-row ones in
dQ, and dK/dV split by hd halves between the two consumer warpgroups),
fp32 and bf16 at hd 16 and 32 the FMA kernels.  Both directions take every
head dim (``BWD_HEAD_DIMS`` is ``HEAD_DIMS``); at hd 256 the FMA (fp32)
backward works on 32-row kv tiles, so that its shared memory fits a CTA.

``flash_attention_fwd_cuda`` and ``flash_attention_bwd_cuda`` are the only
places the kernels are launched.  Each checks what the kernels take and
raises on anything else, allocates its outputs and scratch with
``torch.empty``, launches on the current stream, raises if a launch
reports an error, and counts the call in any open ``calls.CallLog`` (meta
tensors, the dry run, take the same checks and allocations and are
recorded there where the card would launch, launching nothing) and in
``LAUNCHES`` (``forward``,
``backward``; ``by_path``: the same calls by path; ``grids``: the CUDA
launches, one a forward, two a backward on the FMA path and three on the
tensor-core path; ``copied_operands``: tensor-core operands the producer
copied because no tensor map describes them).  ``FlashAttentionFn`` is the
autograd Function around them; on CPU tensors it runs the plain versions
in their place, so its plumbing is tested without a card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, calls
from repro_torch.kernels.ref import (
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128, 256)  # hd the forward is instantiated for
BWD_HEAD_DIMS = HEAD_DIMS  # hd the backward is instantiated for
TC_HEAD_DIMS = (64, 96, 128, 256)  # hd of the tensor-core kernels (bf16)
PATHS = ("tensor_core", "fma")
_BWD_GRIDS = {"fma": 2, "tensor_core": 3}
_MAX_GRID_YZ = 65535
_TMA_ALIGN = 16  # bytes: a tensor map's base and every stride it steps


class LaunchCounter:
    """Forward and backward calls (in total, by path, and by direction,
    mode and path: ``by_mode["forward non-causal tensor_core"]``, and by
    direction and CUDA stream: ``by_stream[("backward", stream)]``, one
    stream a mesh position), the CUDA launches they made and the
    tensor-core operands copied by the producer warp, since the last
    ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.forward = 0
        self.backward = 0
        self.grids = 0
        self.by_path = dict.fromkeys(PATHS, 0)
        self.by_mode = dict.fromkeys(
            (f"{d} {m} {p}" for d in ("forward", "backward")
             for m in ("causal", "non-causal") for p in PATHS), 0)
        self.copied_operands = 0
        self.by_stream: dict = {}

    def on_stream(self, direction: str, stream: int) -> None:
        key = (direction, stream)
        self.by_stream[key] = self.by_stream.get(key, 0) + 1


LAUNCHES = LaunchCounter()


def choose_path(dtype: torch.dtype, hd: int) -> str:
    """The kernel path for operands of this dtype and head dim:
    ``tensor_core`` for bf16 at hd 64, 96, 128 and 256, ``fma`` for fp32
    and for bf16 at hd 16 and 32.  A function of these two alone: never
    of B, S or the number of heads.  The kernels' entry points apply the
    same rule themselves (``tensor_core_path`` in ``flash_attention.cu``);
    here it counts the calls by path and sizes the backward's scratch."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16 "
                        f"operands, got {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "tensor_core"
    return "fma"


def _pad64(hd: int) -> int:
    return -(-hd // 64) * 64


def tc_smem_bytes(hd: int) -> dict:
    """Dynamic shared memory of each tensor-core kernel at head dim ``hd``
    (by ``TC_INFO_KERNELS`` name), as ``flash_attention.cu`` sizes it:
    the forward's 128 query rows and its kv stages (64 rows above hd 128,
    else 128; 3 stages at hd 64, else 2), dQ's and dK/dV's tiles and
    stages, each + 1024 to align and 8 bytes a barrier."""
    def tile(rows):
        return rows * _pad64(hd) * 2

    fwd_kv, fwd_st = (64 if hd > 128 else 128), (3 if hd == 64 else 2)
    dq_kv, dq_st = (32 if hd > 128 else 64), (4 if hd == 64 else 3)
    dkv_kv, dkv_q, dkv_st = (64 if hd > 128 else 128), \
        (64 if hd == 64 else 32), 4
    return {
        "forward": 1024 + tile(128) + fwd_st * 2 * tile(fwd_kv)
        + (2 * fwd_st + 1) * 8,
        "dq": 1024 + 2 * tile(128) + dq_st * 2 * tile(dq_kv) + 128 * 4
        + (2 * dq_st + 1) * 8,
        "dkv": 1024 + 2 * tile(dkv_kv) + dkv_st * 2 * tile(dkv_q)
        + dkv_st * 2 * dkv_q * 4 + (2 * dkv_st + 1) * 8}


def tma_ok(t: torch.Tensor) -> bool:
    """Whether a tensor map can load the (B, rows, heads, hd) operand
    ``t``: hd contiguous, the base 16-byte aligned, and every other
    dimension longer than 1 stepping a positive multiple of 16 bytes
    (an extent of 1 is never stepped along)."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % _TMA_ALIGN == 0
            and max(t.shape) < 2 ** 32 and all(
                t.shape[i] == 1 or (0 < t.stride(i) and t.stride(i) * size
                                    % _TMA_ALIGN == 0 and t.stride(i) * size
                                    < 2 ** 40) for i in range(3)))


def _tma_mask(tensors) -> int:
    return sum(1 << i for i, t in enumerate(tensors) if tma_ok(t))


def _count(direction: str, causal: bool, path: str, mask: int,
           n_operands: int) -> None:
    LAUNCHES.by_path[path] += 1
    LAUNCHES.by_mode[f"{direction} {'causal' if causal else 'non-causal'} "
                     f"{path}"] += 1
    if path == "tensor_core":
        LAUNCHES.copied_operands += n_operands - bin(mask).count("1")


def _functions():
    lib = build.load("flash_attention")
    fwd, bwd = lib.repro_flash_fwd, lib.repro_flash_bwd
    if fwd.argtypes is None:
        # every pointer and the stream as c_void_p: ctypes would otherwise
        # pass a Python int as a 32-bit int and cut the address
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        s = ctypes.POINTER(ctypes.c_longlong)
        fwd.argtypes = [p, s, p, s, p, s, p, p, i, i, i, i, i, i, i, f, i, i,
                        p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [p, s, p, s, p, s, p, s, p, s, p, p, p, p, p, p, i,
                        i, i, i, i, i, i, f, i, i, p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


TC_INFO_KERNELS = ("forward", "dq", "dkv")
TC_INFO_KEYS = ("smem_bytes", "cta_rows", "stage_rows", "stages",
                "registers", "local_bytes", "ctas_per_sm")


def tc_kernel_info(hd: int) -> dict:
    """The tensor-core kernels at head dim ``hd`` (``TC_HEAD_DIMS``), by
    kernel: dynamic shared memory, the rows a CTA owns (query rows; kv rows
    for dK/dV) and a stage brings, stages, registers a thread at launch,
    local (spill) bytes a thread and resident CTAs an SM, as the CUDA
    runtime reports them on the current card."""
    if hd not in TC_HEAD_DIMS:
        raise ValueError(f"no tensor-core flash kernel at head dim {hd}")
    out = (ctypes.c_int * (len(TC_INFO_KERNELS) * len(TC_INFO_KEYS)))()
    err = build.load("flash_attention").repro_flash_tc_info(hd, out)
    if err != 0:
        raise RuntimeError(f"flash kernel info failed: cudaError {err}")
    n = len(TC_INFO_KEYS)
    return {name: dict(zip(TC_INFO_KEYS, out[n * i:n * i + n]))
            for i, name in enumerate(TC_INFO_KERNELS)}


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


def _check_cuda(tensors, hd: int) -> str:
    """Raise unless ``tensors`` are CUDA tensors of one device and one
    dtype the kernels take; return the path they take."""
    dev = tensors[0].device
    for t in tensors:
        if not (t.is_cuda or t.is_meta) or t.device != dev:
            raise ValueError(f"flash attention kernel needs CUDA tensors on "
                             f"one device, got {t.device}")
        if t.dtype != tensors[0].dtype:
            raise TypeError(f"flash attention kernel takes operands of one "
                            f"dtype, got {t.dtype} and {tensors[0].dtype}")
    return choose_path(tensors[0].dtype, hd)


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
    path = _check_cuda((q, k, v), hd)
    _grid_check(b, hq)
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    o = torch.empty((b, s, hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    mode = "forward causal" if causal else "forward non-causal"
    if q.is_meta:  # the dry run: the card path's allocations, no launch
        calls.record("flash_attention", path, mode,
                     calls.flash_cost(q, k, "forward"))
        return o, lse
    mask = _tma_mask((q, k, v)) if path == "tensor_core" else 0
    fwd, _ = _functions()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), _strides(q), k.data_ptr(), _strides(k),
                  v.data_ptr(), _strides(v), o.data_ptr(), lse.data_ptr(),
                  _DTYPE_CODE[q.dtype], b, s, skv, hq, hkv, hd, scale,
                  int(causal), mask, stream)
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed: "
                           f"error {err} on the {path} path for q "
                           f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    calls.record("flash_attention", path, mode,
                 calls.flash_cost(q, k, "forward"))
    LAUNCHES.forward += 1
    LAUNCHES.on_stream("forward", stream)
    LAUNCHES.grids += 1
    _count("forward", causal, path, mask, 3)
    return o, lse


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool = True,
                             sm_scale: Optional[float] = None):
    """Launch the backward (two kernels on the FMA path, three on the
    tensor-core path): (dq, dk, dv) in the inputs' dtype, dk and dv summed
    over each kv head's group of query heads in head order."""
    check_shapes(q, k, v, causal)
    b, s, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    path = _check_cuda((q, k, v, o, do), hd)
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
    mask, part = 0, None
    if path == "tensor_core":
        # dK and dV of each query head, fp32, summed per kv head after
        part = torch.empty((2, b, skv, hq, hd), dtype=torch.float32,
                           device=q.device)
    mode = "backward causal" if causal else "backward non-causal"
    if q.is_meta:  # the dry run: the card path's allocations, no launch
        calls.record("flash_attention", path, mode,
                     calls.flash_cost(q, k, "backward"))
        return dq, dk, dv
    if path == "tensor_core":
        mask = _tma_mask((q, k, v, do))
    _, bwd = _functions()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = bwd(q.data_ptr(), _strides(q), k.data_ptr(), _strides(k),
                  v.data_ptr(), _strides(v), o.data_ptr(),
                  _strides(o), do.data_ptr(), _strides(do), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), None if part is None else part.data_ptr(),
                  _DTYPE_CODE[q.dtype], b, s, skv, hq, hkv, hd, scale,
                  int(causal), mask, stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: "
                           f"error {err} on the {path} path for q "
                           f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    calls.record("flash_attention", path, mode,
                 calls.flash_cost(q, k, "backward"))
    LAUNCHES.backward += 1
    LAUNCHES.on_stream("backward", stream)
    LAUNCHES.grids += _BWD_GRIDS[path]
    _count("backward", causal, path, mask, 4)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Causal (or full) attention with the flash kernels as forward and
    backward; CPU tensors take the plain versions in the kernels' place."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True,
                sm_scale: Optional[float] = None):
        if q.device.type == "cpu":
            o, lse = calls.plain_call(flash_attention_fwd_plain,
                                      flash_attention_fwd_cuda, q, k, v,
                                      causal, sm_scale)
        else:
            o, lse = flash_attention_fwd_cuda(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.position = calls.position()
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with calls.at_position(ctx.position):
            if q.device.type == "cpu":
                dq, dk, dv = calls.plain_call(
                    flash_attention_bwd_plain, flash_attention_bwd_cuda, q,
                    k, v, o, lse, do, ctx.causal, ctx.sm_scale)
            else:
                dq, dk, dv = flash_attention_bwd_cuda(
                    q, k, v, o, lse, do, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None
