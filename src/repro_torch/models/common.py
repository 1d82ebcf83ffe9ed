"""Shared model building blocks: norms, embeddings, RoPE, activations and
the dense projection.

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
            activation: Optional[str] = None) -> torch.Tensor:
    """``activation(x @ w)`` over the last axis of ``x``, through the matmul
    kernel (its plain version for CPU tensors)."""
    lead = x.shape[:-1]
    out = ops.matmul(x.reshape(-1, x.shape[-1]).contiguous(), w,
                     activation=activation)
    return out.reshape(lead + (w.shape[-1],))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers.  Rotates the two
    halves of each head (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]  # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table``; a negative id counts from the end, as in numpy
    and the reference's ``jnp.take`` (serving feeds masked slots the pad
    id, which may be -1)."""
    return F.embedding(torch.where(ids < 0, ids + table.shape[0], ids), table)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``x @ table.T`` for a (vocab, d) table.  Runs on the
    matmul kernel: bf16 products are exact in fp32, so accumulating them
    in fp32 equals the reference's upcast-then-multiply, and the kernel
    reads the table transposed through its strides, with no copy."""
    lead = x.shape[:-1]
    out = ops.matmul(x.reshape(-1, x.shape[-1]).contiguous(), table.t(),
                     out_dtype=torch.float32)
    return out.reshape(lead + (table.shape[0],))
