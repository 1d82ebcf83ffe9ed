"""RWKV-6 (Finch, arXiv:2404.05892): attention-free time mix with a
data-dependent per-channel decay, and the channel mix.

Recurrence per head (head size N), per batch row:
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t           # S: (N, N), w_t in (0, 1)
    o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

Three forms, as in the reference (``src/repro/models/rwkv.py``):
  * no decode state (training, ``forward_logits``, ``prefill``): the
    chunked form from a zero state through ``ops.wkv`` — on a CUDA tensor
    the WKV kernels, forward and backward;
  * a decode state and one new token (serving): ``wkv_step``;
  * a decode state and several tokens: ``wkv_chunked``, ``ops.wkv`` from
    zero plus the carried state's decayed share (no entry point reaches
    it: serving prefills recurrent families one token at a time).

Every projection runs on the matmul kernel (``common.project``), the decay
LoRA's ``tanh`` and the gate's ``silu`` fused into its epilogue.  The
decode step's reductions go through it too (``wkv_step``'s row-by-state
product, ``_group_norm``'s moments): the kernel sums each output in one
fixed order whatever the batch, so a row decodes the same alone as beside
others, and static and continuous serving give the same tokens in bf16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, project

LORA_DIM = 64
GROUP_NORM_EPS = 1e-5


def rwkv_time_mix_init(gen: torch.Generator, d: int, head_dim: int,
                       dtype=torch.float32) -> dict:
    n_heads = d // head_dim
    dev = gen.device
    half = lambda: torch.full((d,), 0.5, dtype=dtype, device=dev)  # noqa: E731
    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_g": half(),
        "mu_w": half(),
        "w_r": dense_init(gen, d, d, dtype),
        "w_k": dense_init(gen, d, d, dtype),
        "w_v": dense_init(gen, d, d, dtype),
        "w_g": dense_init(gen, d, d, dtype),
        "w_o": dense_init(gen, d, d, dtype),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x W1) W2))
        "decay_w0": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
        "decay_w1": dense_init(gen, d, LORA_DIM, torch.float32),
        "decay_w2": dense_init(gen, LORA_DIM, d, torch.float32),
        "bonus_u": torch.randn((n_heads, head_dim), generator=gen,
                               device=dev) * 0.1,
        "ln_x_scale": torch.ones((d,), dtype=torch.float32, device=dev),
    }


def _token_shift(x: torch.Tensor, mu: torch.Tensor,
                 last: Optional[torch.Tensor]) -> torch.Tensor:
    """lerp(x_t, x_{t-1}, mu); ``last``: (B, 1, D) previous token (decode),
    else zero before the first."""
    if last is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)
    return x + mu * (prev - x)


def wkv_chunked(r, k, v, logw, u, state: torch.Tensor,
                chunk: Optional[int] = None):
    """Chunked WKV6 from a carried state (B, H, N, N): r, k, v, logw (B, S,
    H, N), u (H, N).  Returns (out (B, S, H, N) fp32, final state).  The
    recurrence is linear in the state, so this is ``ops.wkv`` from zero
    plus what the carried state adds: ``(r_t e^{cwe_t}) S`` to each output
    and ``e^{cw_S} S`` to the final state, cw the cumulative sum of logw
    over the sequence (every exponent <= 0)."""
    out, final = ops.wkv(r, k, v, logw, u, chunk=chunk)
    state = state.float()
    cw = torch.cumsum(logw.float(), dim=1)
    rd = (r.float() * torch.exp(cw - logw.float())).transpose(1, 2)
    carried = ops.matmul(rd.contiguous(), state)  # (B, H, S, N)
    return out + carried.transpose(1, 2), \
        final + torch.exp(cw[:, -1])[..., None] * state


def wkv_step(r, k, v, logw, u, state: torch.Tensor):
    """One token: r, k, v, logw (B, 1, H, N), state (B, H, N, N).  Returns
    (o (B, 1, H, N) fp32, new state).  ``o = r (S + diag(u) kᵀ v)`` is one
    (1, N) @ (N, N) product per (batch, head) on the matmul kernel, with
    the bonus folded into the state it reads; the state update is
    elementwise."""
    r1, k1, v1, w1 = (x[:, 0].float() for x in (r, k, v, logw))  # (B, H, N)
    kv = k1[..., :, None] * v1[..., None, :]  # (B, H, N, N)
    read = state + u.float()[None, :, :, None] * kv
    o = ops.matmul(r1[:, :, None, :].contiguous(), read)  # (B, H, 1, N)
    new_state = torch.exp(w1)[..., None] * state + kv
    return o.transpose(1, 2), new_state


def _group_norm(x: torch.Tensor, scale: torch.Tensor, n_heads: int,
                eps: float = GROUP_NORM_EPS) -> torch.Tensor:
    """Per-head LayerNorm (population variance, fp32) of (B, S, D) viewed
    as (B, S, H, N), times ``scale``.  Both moments are products with a
    column of ones on the matmul kernel (a fixed order of summation,
    whatever the number of rows)."""
    b, s, d = x.shape
    n = d // n_heads
    xh = x.float().reshape(-1, n)
    ones = torch.ones((n, 1), dtype=torch.float32, device=x.device)
    xc = xh - ops.matmul(xh, ones) / n
    var = ops.matmul(xc * xc, ones) / n
    xh = xc * torch.rsqrt(var + eps)
    return (xh.reshape(b, s, d) * scale).to(x.dtype)


def time_mix_k(params, x: torch.Tensor, state=None) -> torch.Tensor:
    """The time mix's k projection (B, S, D_out): on a serve mesh one
    position's column block of it, gathered before ``rwkv_time_mix``."""
    last = state["shift"] if state is not None else None
    return project(_token_shift(x, params["mu_k"], last), params["w_k"])


def rwkv_time_mix(params, x: torch.Tensor, head_dim: int, state=None,
                  chunk: Optional[int] = None,
                  k: Optional[torch.Tensor] = None):
    """x: (B, S, D).  ``state`` (decode): {"S": (B, H, N, N), "shift":
    (B, 1, D)}.  ``k`` (B, S, D): the k projection where it was made
    outside (``time_mix_k`` over a serve mesh's positions, gathered).
    Returns (out (B, S, D), new state or None)."""
    b, s, d = x.shape
    h = d // head_dim
    last = state["shift"] if state is not None else None
    if k is None:
        k = time_mix_k(params, x, state)
    xr, xv, xg, xw = (_token_shift(x, params[f"mu_{c}"], last)
                      for c in "rvgw")
    r = project(xr, params["w_r"]).reshape(b, s, h, head_dim)
    k = k.reshape(b, s, h, head_dim)
    v = project(xv, params["w_v"]).reshape(b, s, h, head_dim)
    g = project(xg, params["w_g"], activation="silu", out_dtype=torch.float32)

    lora = project(project(xw.float(), params["decay_w1"], activation="tanh"),
                   params["decay_w2"])
    logw = -torch.exp(params["decay_w0"] + lora)  # (B, S, D), <= 0
    logw = logw.reshape(b, s, h, head_dim)

    # scale k as in RWKV6 to keep the state bounded: k *= (1 - w)
    k = k * (1.0 - torch.exp(logw)).to(k.dtype)

    u = params["bonus_u"]
    if state is not None and s == 1:
        o, s_new = wkv_step(r, k, v, logw, u, state["S"])
        new_state = {"S": s_new, "shift": x[:, -1:]}
    elif state is not None:
        o, s_new = wkv_chunked(r, k, v, logw, u, state["S"], chunk)
        new_state = {"S": s_new, "shift": x[:, -1:]}
    else:
        o, _ = ops.wkv(r, k, v, logw, u, chunk=chunk)
        new_state = None

    o = _group_norm(o.reshape(b, s, d), params["ln_x_scale"], h)
    out = project((o.float() * g).to(x.dtype), params["w_o"])
    return out, new_state


# ---------------------------------------------------------------------------
# Channel mix
# ---------------------------------------------------------------------------


def rwkv_channel_mix_init(gen: torch.Generator, d: int, f: int,
                          dtype=torch.float32) -> dict:
    dev = gen.device
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "w_k": dense_init(gen, d, f, dtype),
        "w_v": dense_init(gen, f, d, dtype),
        "w_r": dense_init(gen, d, d, dtype),
    }


def channel_mix_k(params, x: torch.Tensor, state=None) -> torch.Tensor:
    """The channel mix's ``relu(xk W_k)`` (B, S, F): on a serve mesh one
    position's column block of it, gathered before ``rwkv_channel_mix``."""
    last = state["shift"] if state is not None else None
    return project(_token_shift(x, params["mu_k"], last), params["w_k"],
                   activation="relu")


def rwkv_channel_mix(params, x: torch.Tensor, state=None,
                     k: Optional[torch.Tensor] = None):
    """``relu(xk W_k)² W_v`` gated by ``sigmoid(xr W_r)``; ``state``
    (decode): {"shift": (B, 1, D)}; ``k`` the ``relu(xk W_k)`` made
    outside (``channel_mix_k`` over a serve mesh's positions, gathered)."""
    last = state["shift"] if state is not None else None
    xr = _token_shift(x, params["mu_r"], last)
    if k is None:
        k = channel_mix_k(params, x, state)
    k = k * k
    r = torch.sigmoid(project(xr, params["w_r"]).float()).to(x.dtype)
    out = r * project(k, params["w_v"])
    new_state = {"shift": x[:, -1:]} if state is not None else None
    return out, new_state


def rwkv_init_state(batch: int, d: int, head_dim: int, dtype,
                    device) -> dict:
    h = d // head_dim
    return {
        "time": {
            "S": torch.zeros((batch, h, head_dim, head_dim),
                             dtype=torch.float32, device=device),
            "shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        },
        "channel": {"shift": torch.zeros((batch, 1, d), dtype=dtype,
                                         device=device)},
    }
