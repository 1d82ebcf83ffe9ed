"""Public entry to the port's kernels.

A tensor on the CPU takes the kernel's plain PyTorch version
(``kernels/ref.py``); a CUDA tensor launches the Hopper kernel, or the call
raises.  The matmul has no padding to tile multiples: the kernel masks its
ragged edges, so a decode step with 4 rows pays for 4 rows, not 128.  The
sort pads rows to a power of 2, which the network needs.

An fp32 product on the tensor cores with K above ``TC_K_BLOCK`` runs as
consecutive K blocks added in fp32 (``_matmul``): the kernel's fp32 sum
drifts over a long k walk.

A meta tensor (the dry run, ``launch/dryrun.py``) takes the card's
branch wherever the port chooses by device (``on_card``), and in the
kernel wrappers the card path's checks and allocations, recorded in any
open ``calls.CallLog`` where the card would launch: neither a kernel nor
a plain version runs.

Each kernel's tile (the matmul's width, the sort's tile and group, WKV's
chunk) comes from the autotuner (``kernels/tuning.py``) on a CUDA tensor:
the ``tuner`` passed, else the one this thread's Runtime is serving or
training under, else the kernel's fixed choice.  Without measurement a
tuner answers with the fixed choice too.  CPU tensors take the plain
versions, with no lookup.  Flash attention has one instantiation per
(dtype, hd) and no lookup.

Gradients run on the kernels too.  ``matmul`` goes through ``MatmulFn``
whenever an operand needs a gradient: its backward recomputes the product
without the epilogue, applies the activation's derivative elementwise and
takes both operand gradients as two more products on the matmul kernel.
``flash_attention`` always goes through ``FlashAttentionFn``, whose
backward is the flash backward kernels, and ``wkv``, where an input needs a
gradient, through ``WkvFn``, whose backward is the WKV backward kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import calls, tuning
from repro_torch.kernels.bitonic_sort import bitonic_sort_cuda
from repro_torch.kernels.flash_attention import FlashAttentionFn, check_shapes
from repro_torch.kernels.matmul import (
    _TMA_ALIGN,
    EPILOGUE_ACTIVATIONS,
    choose_path,
    matmul_cuda,
    split_hi_lo,
)
from repro_torch.kernels.ref import (
    EPILOGUES,
    bitonic_sort_ref,
    matmul_fused_ref,
    wkv_fwd_plain,
)
from repro_torch.kernels.wkv import WkvFn, wkv_fwd_cuda
from repro_torch.kernels.wkv import check_shapes as wkv_check_shapes

_GELU_C = math.sqrt(2.0 / math.pi)


def _silu_grad(z):
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


def _gelu_grad(z):
    """Derivative of GELU in its tanh form (the epilogue's)."""
    t = torch.tanh(_GELU_C * (z + 0.044715 * z * z * z))
    return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * _GELU_C * (
        1.0 + 3 * 0.044715 * z * z)


# d activation(z) / dz, elementwise on the fp32 pre-activation
ACTIVATION_GRADS = {
    "relu": lambda z: (z > 0).to(z.dtype),
    "gelu": _gelu_grad,
    "silu": _silu_grad,
    "tanh": lambda z: 1.0 - torch.tanh(z) ** 2,
}


# rows one 2-D launch of the FMA path takes at most: its grid counts tiles
# of 16 rows (64 above 16 columns) in the y dimension, 65535 at most, so a
# taller product (rwkv's group norm at train_4k: B·S·H = 2,621,440 rows of
# a position) runs as row blocks, each row's bits its own
FMA_MAX_ROWS = 16 * 65535
# K per launch of an fp32-output product on the tensor cores.  The kernel's
# fp32 sum drifts over a long k walk (at K 8192, qwen2-vl's unembedding,
# it read 1.25e-5 x max|plain| from the plain fp32 product, past phase 2's
# 1e-5; chip_smoke.py phase 19 on an H100), so a longer K runs as launches
# of TC_K_BLOCK, added in fp32 in k order
TC_K_BLOCK = 4096


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's branch of the port's code: a CUDA
    tensor, or a meta tensor standing for one (the dry run)."""
    return t.is_cuda or t.is_meta


def tile_for(a, b, out_dtype=None, tuner=None) -> int:
    """The tile width of ``a @ b``: the tuner's for the operands' dtypes,
    the output's, N and K, never M or the batch."""
    return tuning.matmul_tile(a.dtype, b.dtype, out_dtype or a.dtype,
                              b.shape[-1], a.shape[-1], tuner)


def _launch(a, b, bias=None, activation=None, out_dtype=None, tuner=None,
            halves=None):
    """One kernel launch, at ``tile_for``'s tile on a CUDA operand; the
    wrapper refuses any other.  ``halves``: the split path's bf16 halves
    of the fp32 operand, made by the caller."""
    kw = {} if halves is None else {"halves": halves}
    if not a.is_cuda:
        return matmul_cuda(a, b, bias=bias, activation=activation,
                           out_dtype=out_dtype, **kw)
    return matmul_cuda(a, b, bias=bias, activation=activation,
                       out_dtype=out_dtype,
                       tile=tile_for(a, b, out_dtype, tuner), **kw)


def _matmul(a, b, bias, activation, out_dtype, tuner=None):
    """One product: the plain version for CPU operands, else the kernel.
    An fp32 result on a tensor-core path with K above ``TC_K_BLOCK`` is
    ``k_blocked``'s (the split depends on K alone, so a row's bits still do
    not depend on the other rows); an FMA product of more than
    ``FMA_MAX_ROWS`` rows runs as row blocks."""
    if a.dim() == 2 and a.shape[0] > FMA_MAX_ROWS and \
            a.device.type != "cpu" and \
            choose_path(a.dtype, b.dtype) == "fma":
        return torch.cat([_matmul(a[r:r + FMA_MAX_ROWS], b, bias,
                                  activation, out_dtype, tuner)
                          for r in range(0, a.shape[0], FMA_MAX_ROWS)])
    if a.device.type == "cpu" and b.device.type == "cpu":
        return calls.plain_call(
            lambda x, y, z: matmul_fused_ref(x, y, bias=z,
                                             activation=activation,
                                             out_dtype=out_dtype),
            lambda x, y, z: _matmul(x, y, z, activation, out_dtype, tuner),
            a, b, bias)
    if (out_dtype or a.dtype) != torch.float32 or \
            a.shape[-1] <= TC_K_BLOCK or choose_path(a.dtype, b.dtype) == "fma":
        return _launch(a, b, bias, activation, out_dtype, tuner)
    return k_blocked(a, b, bias, activation, tuner)


def k_blocked(a, b, bias=None, activation=None, tuner=None) -> torch.Tensor:
    """fp32 ``a @ b + bias`` as the kernel's fp32 products over consecutive
    K blocks of ``TC_K_BLOCK``, added in k order, the bias in the first
    block's epilogue.  An activation raises: the sum of the blocks has no
    epilogue to run it in, and no such product on a path has one (the
    unembeddings and the backward's recomputed products)."""
    if activation is not None:
        raise NotImplementedError(
            f"an fp32 result with activation {activation!r} at K "
            f"{a.shape[-1]} > TC_K_BLOCK ({TC_K_BLOCK}) on the tensor cores "
            f"is not ported: it runs as K blocks, whose sum has no fused "
            f"epilogue")
    # on the split path the fp32 operand's bf16 halves are made once for
    # every block (the same values: the split is elementwise) where each
    # block of them is one a tensor map loads; else each launch splits
    # its own block, as a lone product does
    halves = None
    if choose_path(a.dtype, b.dtype) == "split":
        x = a if a.dtype == torch.float32 else b
        if x.is_contiguous() and all(
                (st * 2) % _TMA_ALIGN == 0 for st in x.stride()[:-1]):
            halves = split_hi_lo(x)
    out = None
    for k0 in range(0, a.shape[-1], TC_K_BLOCK):
        cols = slice(k0, k0 + TC_K_BLOCK)
        block = None
        if halves is not None:
            block = tuple(h[..., cols] if a.dtype == torch.float32
                          else h[..., cols, :] for h in halves)
        part = _launch(a[..., cols], b[..., cols, :],
                       bias=bias if k0 == 0 else None,
                       out_dtype=torch.float32, tuner=tuner, halves=block)
        out = part if out is None else out.add_(part)
    return out


class MatmulFn(torch.autograd.Function):
    """``epilogue(a @ b + bias)`` for 2-D operands or 4-D batches of them,
    with a backward on the same kernel: ``dZ = dOut * activation'(a @ b +
    bias)`` (the product recomputed in fp32 without the epilogue), ``dA =
    dZ @ bᵀ`` and ``dB = aᵀ @ dZ`` with the last two axes transposed as
    views the kernel reads through their strides, each accumulated in fp32
    and cast once to its operand's dtype, ``dbias`` the sum of dZ over
    every row of every batch."""

    @staticmethod
    def forward(ctx, a, b, bias, activation, out_dtype, tuner=None):
        ctx.save_for_backward(a, b, bias)
        ctx.activation = activation
        # the backward runs on autograd's worker thread, outside this
        # thread's tuner: it is handed the one the forward resolved
        ctx.tuner = tuner if tuner is not None else tuning.active()
        ctx.position = calls.position()
        return _matmul(a, b, bias, activation, out_dtype, tuner)

    @staticmethod
    def backward(ctx, dout):
        with calls.at_position(ctx.position):
            return MatmulFn._backward(ctx, dout)

    @staticmethod
    def _backward(ctx, dout):
        a, b, bias = ctx.saved_tensors
        t = ctx.tuner
        dz = dout
        if ctx.activation is not None:
            z = _matmul(a, b, bias, None, torch.float32, t)
            dz = dout.float() * ACTIVATION_GRADS[ctx.activation](z)
        da = db = dbias = None
        if ctx.needs_input_grad[0]:
            da = _matmul(dz, b.transpose(-2, -1), None, None, a.dtype, t)
        if ctx.needs_input_grad[1]:
            db = _matmul(a.transpose(-2, -1), dz, None, None, b.dtype, t)
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = dz.float().reshape(-1, dz.shape[-1]).sum(0).to(bias.dtype)
        return da, db, dbias, None, None, None


def matmul(a: torch.Tensor, b: torch.Tensor, *, bias=None,
           activation: Optional[str] = None,
           out_dtype: Optional[torch.dtype] = None,
           tuner=None) -> torch.Tensor:
    """``epilogue(a @ b + bias)`` with fp32 accumulation, cast to
    ``out_dtype`` (default ``a.dtype``).

    ``a`` (M, K) and ``b`` (K, N), or 4-D batches ``(Z1, Z2, M, K)`` and
    ``(Z1, Z2, K, N)`` of them; ``bias`` (N,); ``activation`` one of
    ``relu | gelu | silu | tanh`` (gelu in its tanh form) or None.  Where an
    operand needs a gradient the call goes through ``MatmulFn``, whose
    backward runs on the same kernel in either rank (the windowed
    attention forms train through the 4-D one).  ``tuner`` picks the
    tile width (``kernels/tuning.py``; never from M)."""
    if activation is not None and activation not in EPILOGUE_ACTIVATIONS:
        raise ValueError(f"activation must be one of {EPILOGUE_ACTIVATIONS}, "
                         f"got {activation!r}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, bias))
    if not needs_grad:
        return _matmul(a, b, bias, activation, out_dtype, tuner)
    return MatmulFn.apply(a, b, bias, activation, out_dtype, tuner)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, S, Hq, hd) attention against k, v (B, Skv, Hkv, hd), Hq a
    multiple of Hkv, through the flash kernels (forward and backward); the
    plain versions for CPU tensors.  ``sm_scale`` is hd^-0.5.  Causal
    attention needs S == Skv: the kernel aligns its mask top-left and the
    reference's oracle bottom-right, which agree only there."""
    check_shapes(q, k, v, causal)
    return FlashAttentionFn.apply(q, k, v, causal, None)


def wkv_chunk_for(r, needs_grad: bool, tuner=None) -> int:
    """WKV's chunk for (B, S, H, N) ``r``: the tuner's for H, N, the dtype
    and the gradient, never B or S."""
    return tuning.wkv_chunk(r.shape[2], r.shape[3], r.dtype, needs_grad,
                            tuner)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: torch.Tensor, *, chunk: Optional[int] = None,
        tuner=None):
    """Chunked WKV6 from a zero state (the reference's ``ops.wkv``, which
    takes no carried state either): r, k, v, logw (B, S, H, N), logw <= 0,
    u (H, N).  Returns (out (B, S, H, N) fp32, final state (B, H, N, N)
    fp32).  On CUDA tensors the WKV kernel runs, and where an input needs a
    gradient the call goes through ``WkvFn``, whose forward keeps the
    chunk-start states for its backward kernel; CPU tensors take the
    plain versions.  ``chunk=None`` is the tuner's for (H, N, dtype, needs
    a gradient) on a CUDA tensor, never from B or S, else 64."""
    wkv_check_shapes(r, k, v, logw, u)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, logw, u))
    if chunk is None:
        chunk = wkv_chunk_for(r, needs_grad, tuner) if on_card(r) else 64
    if needs_grad:
        return WkvFn.apply(r, k, v, logw, u, chunk)
    if r.device.type == "cpu":
        out, state, _ = calls.plain_call(wkv_fwd_plain, wkv_fwd_cuda, r, k,
                                         v, logw, u, chunk)
    else:
        out, state, _ = wkv_fwd_cuda(r, k, v, logw, u, chunk)
    return out, state


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


def sort(x: torch.Tensor, tuner=None) -> torch.Tensor:
    """Ascending sort of a 1-D tensor or of each row of a 2-D one.

    Rows are padded to ``_sort_npad(n)`` with the dtype's largest finite
    value and the padding is stripped after, as the reference does.  So the
    input must be finite: with n not a power of 2, a ``+inf`` sorts after
    the padding and is stripped, and the result holds the dtype's maximum
    in its place (the reference's behaviour, kept).  On a CUDA tensor the
    tuner picks the build's tile and group for (rows, padded n, dtype)."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    xp = _sort_pad(x)
    if xp.device.type == "cpu":
        out = calls.plain_call(bitonic_sort_ref, bitonic_sort_cuda, xp)
    else:
        config = tuning.sort_config(xp.shape[0], xp.shape[1], xp.dtype,
                                    tuner) if on_card(xp) else ()
        out = bitonic_sort_cuda(xp, *config)
    out = out[:, :x.shape[1]]
    return out[0] if squeeze else out
