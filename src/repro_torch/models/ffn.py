"""Dense feed-forward block (GLU or plain), on the matmul kernel.

The activation runs fused into the kernel's epilogue (SwiGLU:
``silu(x @ w_gate)`` in one launch); ``w_in`` of a GLU and ``w_out`` are
plain projections.  Mixture-of-experts blocks are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import dense_init, epilogue_of, is_glu, project


def ffn_init(gen: torch.Generator, d: int, f: int, activation: str,
             dtype=torch.float32) -> dict:
    p = {"w_in": dense_init(gen, d, f, dtype),
         "w_out": dense_init(gen, f, d, dtype)}
    if is_glu(activation):
        p["w_gate"] = dense_init(gen, d, f, dtype)
    return p


def ffn_apply(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    act = epilogue_of(activation)
    if is_glu(activation):
        h = project(x, params["w_gate"], activation=act) * project(
            x, params["w_in"])
    else:
        h = project(x, params["w_in"], activation=act)
    return project(h, params["w_out"])
