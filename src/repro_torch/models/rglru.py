"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Recurrence (per channel):
    r_t = sigmoid(w_r * x_t + b_r)          # recurrence gate (diagonal)
    i_t = sigmoid(w_i * x_t + b_i)          # input gate (diagonal)
    a_t = exp(-c * softplus(lam) * r_t)     # data-dependent decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A width-4 causal depthwise conv precedes the LRU, as in Griffin and the
reference.  The three projections (``w_x``, ``w_gate``, ``w_out``) run on
the matmul kernel in the weights' dtype; the gate branch's tanh-form GELU
(in fp32, on the product rounded to that dtype, as the reference does),
the gates, the conv and the recurrence are elementwise PyTorch.

The serial dependency chain is evaluated two ways, as in the reference:
with a decode state, step by step (its ``lax.scan``); without one, in
parallel.  The reference's parallel form is ``jax.lax.associative_scan``.
The port's is a Hillis-Steele inclusive scan: log2(S) passes, each
combining every position with the one ``2^j`` before it,
``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)``, all in fp32.  It keeps the
reference's fork-join between the serial chain and parallel evaluation
(11 elementwise passes at S = 2048 instead of 2048 launches of a step
loop) and applies the reference's own combine, so it needs no pairwise
decay matrix: a chunked scan through cumulative log-decays holds one of
C x C per channel and chunk.  The two trees combine in different orders,
so the outputs agree within fp32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, project

C_FACTOR = 8.0
CONV_WIDTH = 4
# the decay a^c of the recurrence at init: uniform in [0.9, 0.999]
DECAY_RANGE = (0.9, 0.999)


def rglru_init(gen: torch.Generator, d: int, width: int,
               dtype=torch.float32) -> dict:
    """The reference's distributions, drawn from ``gen``: ``lam`` the
    softplus inverse of -log(u)/c for u uniform in DECAY_RANGE; the gates'
    weights N(0, 0.5^2) and their biases 0, in fp32; the conv N(0, 0.1^2);
    the projections fan-in scaled normals."""
    dev = gen.device
    lo, hi = DECAY_RANGE
    u = lo + (hi - lo) * torch.rand((width,), generator=gen, device=dev)
    lam = torch.log(torch.expm1(-torch.log(u) / C_FACTOR))
    return {
        "w_x": dense_init(gen, d, width, dtype),
        "w_gate": dense_init(gen, d, width, dtype),
        "conv_w": (torch.randn((CONV_WIDTH, width), generator=gen, device=dev)
                   * 0.1).to(dtype),
        "w_rec_gate": torch.randn((width,), generator=gen, device=dev) * 0.5,
        "b_rec_gate": torch.zeros((width,), device=dev),
        "w_in_gate": torch.randn((width,), generator=gen, device=dev) * 0.5,
        "b_in_gate": torch.zeros((width,), device=dev),
        "lam": lam.float(),
        "w_out": dense_init(gen, width, d, dtype),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width CONV_WIDTH in ``x``'s dtype.  x (B, S,
    W), w (CONV_WIDTH, W), state (B, CONV_WIDTH - 1, W): the inputs before
    ``x`` (zeros without one).  Returns (out (B, S, W), the new state: the
    last CONV_WIDTH - 1 inputs)."""
    b, s, width = x.shape
    if state is None:
        hist = x.new_zeros((b, CONV_WIDTH - 1, width))
    else:
        hist = state.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)
    w = w.to(x.dtype)
    out = xp[:, 0:s] * w[0]
    for i in range(1, CONV_WIDTH):
        out = out + xp[:, i:i + s] * w[i]
    return out, xp[:, -(CONV_WIDTH - 1):]


def gates(params, u: torch.Tensor):
    """u (..., W), the conv's output -> the decay a and the gated input b,
    both fp32; log a <= 0 and 1 - a^2 floored at 1e-12."""
    uf = u.float()
    r = torch.sigmoid(uf * params["w_rec_gate"] + params["b_rec_gate"])
    i = torch.sigmoid(uf * params["w_in_gate"] + params["b_in_gate"])
    log_a = -C_FACTOR * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1 of (B, S, W)
    fp32 tensors, by the Hillis-Steele scan (module docstring).  Each pass
    builds new tensors rather than writing into the old ones: autograd
    keeps the old ones for the backward, and under the per-layer
    ``checkpoint`` a write into them is not caught, it silently changes
    the recomputed values the gradient reads."""
    h = b
    s = a.shape[1]
    step = 1
    while step < s:
        # the combine reads the pre-pass values: compute both from them
        h = torch.cat([h[:, :step], a[:, step:] * h[:, :-step] + h[:, step:]],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return h


def rglru_apply(params, x: torch.Tensor, state=None):
    """x (B, S, D).  Returns (out (B, S, D) in x's dtype, new state or None).

    The decode state is {"h": (B, W) fp32, "conv": (B, CONV_WIDTH - 1, W)}:
    with one, the recurrence runs step by step from ``h``; without, in
    parallel from zero."""
    u_in = project(x, params["w_x"])
    gate = F.gelu(project(x, params["w_gate"]).float(), approximate="tanh")
    u, new_conv = causal_conv(u_in, params["conv_w"],
                              state["conv"] if state is not None else None)
    a, b = gates(params, u)
    if state is not None:
        h = state["h"].float()
        hs = []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        h_seq = torch.stack(hs, dim=1)
        new_state = {"h": h, "conv": new_conv}
    else:
        h_seq = linear_scan(a, b)
        new_state = None
    return project((h_seq * gate).to(x.dtype), params["w_out"]), new_state


def rglru_init_state(batch: int, width: int, dtype, device) -> dict:
    return {
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, width), dtype=dtype,
                            device=device),
    }

