"""Shared model building blocks: norms, embeddings, RoPE and M-RoPE,
activations and the dense projection.

Parameters are plain dictionaries of tensors with the reference package's
names and layouts (a projection's weight is one (in, out) matrix), so the
parity tests compare like with like.  Initialisers draw from an explicit
``torch.Generator`` on the parameter's device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """Scaled normal (fan-in) init for an (in_dim, out_dim) projection."""
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device)
            * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """gemma-style RMSNorm: x * rsqrt(mean(x^2) + eps) * (1 + scale).

    The sum of squares is a product with a column of ones on the matmul
    kernel, which sums each row in one fixed order whatever the number of
    rows in the call.  PyTorch's reduction kernels pick their thread layout
    from the tensor's shape, and with it the order of the sum: a row would
    round differently alone than beside seven others, and greedy decoding
    could then differ between the static and the continuous serving
    engines."""
    dt = x.dtype
    xf = x.float()
    d = xf.shape[-1]
    ones = torch.ones((d, 1), dtype=torch.float32, device=xf.device)
    sq = ops.matmul((xf * xf).reshape(-1, d), ones)
    var = sq.reshape(xf.shape[:-1] + (1,)) / d
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + params["scale"].float())).to(dt)


# ---------------------------------------------------------------------------
# Activations and the dense projection
# ---------------------------------------------------------------------------

# model activation name -> the matmul kernel's fused epilogue (gelu is the
# tanh form in both packages)
_EPILOGUE = {"swiglu": "silu", "silu": "silu", "geglu": "gelu", "gelu": "gelu"}


def epilogue_of(name: str) -> str:
    """The kernel epilogue that computes the model activation ``name``."""
    if name not in _EPILOGUE:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet (other model families)")
    return _EPILOGUE[name]


def is_glu(name: str) -> bool:
    return name in ("swiglu", "geglu")


def project(x: torch.Tensor, w: torch.Tensor,
            activation: Optional[str] = None,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``activation(x @ w)`` over the last axis of ``x``, through the matmul
    kernel (its plain version for CPU tensors), in ``out_dtype`` (default
    ``x.dtype``)."""
    lead = x.shape[:-1]
    out = ops.matmul(x.reshape(-1, x.shape[-1]).contiguous(), w,
                     activation=activation, out_dtype=out_dtype)
    return out.reshape(lead + (w.shape[-1],))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _sin_cos(angles: torch.Tensor) -> tuple:
    angles = angles[..., None, :]  # broadcast over heads
    return torch.sin(angles), torch.cos(angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor, sin_cos=None
            ) -> torch.Tensor:
    """Rotate the two halves of each head of ``x`` (..., S, H, hd) by
    ``angles`` (..., S, hd/2), in fp32, cast back to ``x``'s dtype;
    ``sin_cos``: their sines and cosines, where made already."""
    sin, cos = _sin_cos(angles) if sin_cos is None else sin_cos
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope_angles(head_dim: int, positions: torch.Tensor,
                 theta: float) -> torch.Tensor:
    return positions[..., None].float() * rope_freqs(head_dim, theta,
                                                     positions.device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers.  Rotates the two
    halves of each head (not interleaved pairs)."""
    return _rotate(x, _rope_angles(x.shape[-1], positions, theta))


MROPE_SECTIONS = (16, 24, 24)


def mrope_sections(head_dim: int, sections=MROPE_SECTIONS) -> tuple:
    """Frequency pairs per (t, h, w) axis: ``sections`` scaled to hd/2 by
    integer floor, the last taking the remainder, as the reference does
    (hd 128: (16, 24, 24); hd 16: (2, 3, 3))."""
    half = head_dim // 2
    total = sum(sections)
    secs = [s * half // total for s in sections]
    secs[-1] = half - sum(secs[:-1])
    return tuple(secs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=MROPE_SECTIONS) -> torch.Tensor:
    """Qwen2-VL M-RoPE: x (..., S, H, hd); positions (..., S, 3) integer
    (t, h, w) ids.  Frequency pair j rotates by the position of the axis
    whose section holds j (``mrope_sections``).  When the three planes
    carry the same index the angles are RoPE's, bit for bit."""
    return _rotate(x, _mrope_angles(x.shape[-1], positions, theta,
                                    sections))


def _mrope_angles(hd: int, positions: torch.Tensor, theta: float,
                  sections=MROPE_SECTIONS) -> torch.Tensor:
    pos = positions.float()
    pos = torch.cat([pos[..., i:i + 1].expand(pos.shape[:-1] + (n,))
                     for i, n in enumerate(mrope_sections(hd, sections))],
                    dim=-1)  # (..., S, hd/2)
    return pos * rope_freqs(hd, theta, positions.device)


def positional_pair(q: torch.Tensor, k: torch.Tensor,
                    positions: torch.Tensor, pos_type: str, theta: float):
    """``positional`` of q and of k (one head dim), their angles' sines and
    cosines made once for both: the same values as two calls."""
    if pos_type not in ("rope", "mrope"):
        return (positional(q, positions, pos_type, theta),
                positional(k, positions, pos_type, theta))
    angles = (_rope_angles if pos_type == "rope" else _mrope_angles)(
        q.shape[-1], positions, theta)
    sc = _sin_cos(angles)
    return _rotate(q, angles, sc), _rotate(k, angles, sc)


def positional(x: torch.Tensor, positions: torch.Tensor, pos_type: str,
               theta: float) -> torch.Tensor:
    """The model's position encoding of q or k: RoPE, M-RoPE or none."""
    if pos_type == "rope":
        return apply_rope(x, positions, theta)
    if pos_type == "mrope":
        return apply_mrope(x, positions, theta)
    if pos_type == "none":
        return x
    raise ValueError(f"unknown pos_type {pos_type!r}")


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 scale: Optional[float] = None, *, first_row: int = 0,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """Rows of ``table``; a negative id counts from the end, as in numpy
    and the reference's ``jnp.take`` (serving feeds masked slots the pad
    id, which may be -1).  ``scale`` multiplies the rows after it is
    rounded to the table's dtype, as the reference's ``jnp.asarray(scale,
    out.dtype)`` rounds it: in bf16, sqrt(2560) becomes 50.5.  The
    rounding happens on the host; the product of two bf16 values is exact
    in the fp32 the multiply computes in, so one rounding follows, as in
    the reference.

    On a serve mesh ``table`` is one position's block of a ``vocab``-row
    table, rows ``first_row`` on: an id outside the block gives a row of
    zeros, so the sum over the positions (exactly one of which holds each
    id) is the whole table's row, exactly."""
    vocab = table.shape[0] if vocab is None else vocab
    ids = torch.where(ids < 0, ids + vocab, ids)
    if first_row == 0 and table.shape[0] == vocab:
        out = F.embedding(ids, table)
    else:
        local = ids - first_row
        hit = (local >= 0) & (local < table.shape[0])
        out = F.embedding(torch.where(hit, local, 0), table)
        out = torch.where(hit[..., None], out, 0)
    if scale is not None:
        out = out * float(torch.tensor(scale, dtype=out.dtype))
    return out


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``x @ table.T`` for a (vocab, d) table.  Runs on the
    matmul kernel: bf16 products are exact in fp32, so accumulating them
    in fp32 equals the reference's upcast-then-multiply, and the kernel
    reads the table transposed through its strides, with no copy."""
    lead = x.shape[:-1]
    out = ops.matmul(x.reshape(-1, x.shape[-1]).contiguous(), table.t(),
                     out_dtype=torch.float32)
    return out.reshape(lead + (table.shape[0],))
