"""Plain PyTorch versions of the port's kernels: the CPU path, and the
oracle each kernel is held against on the card.

The flash-attention functions take the wrapper's layout, q (B, S, Hq, hd)
and k, v (B, Skv, Hkv, hd) with Hq a multiple of Hkv (query head h reads kv
head h // (Hq / Hkv)), except ``flash_attention_ref``, which mirrors the
reference's oracle on heads folded into the batch."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
FLASH_BLOCK = 64  # kv positions per step of the online softmax (the kernel's)

EPILOGUES = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh form; torch's default is the exact one
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """fp32-accumulated matmul."""
    out = torch.matmul(a.float(), b.float())
    return out.to(out_dtype or a.dtype)


def matmul_fused_ref(a: torch.Tensor, b: torch.Tensor, bias=None,
                     activation: Optional[str] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Matmul + epilogue (bias add, activation, cast) as separate ops in
    fp32: the oracle for the kernel's fused epilogue."""
    out = torch.matmul(a.float(), b.float())
    if bias is not None:
        out = out + bias.reshape(-1).float()
    if activation is not None:
        out = EPILOGUES[activation](out)
    return out.to(out_dtype or a.dtype)


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    """Row-wise ascending sort: the test oracle."""
    return torch.sort(x, dim=-1).values


def bitonic_sort_ref(x: torch.Tensor) -> torch.Tensor:
    """The bitonic network of the sort kernel, stage by stage, on each row
    of ``x`` (rows, n), n a power of 2: for k = 2, ..., n and j = k/2, ...,
    1, element i meets its partner i ^ j (a flip of the middle axis of
    (n / 2j, 2, j)) and the pair is ordered ascending where i & k == 0.
    Min and max by comparison, as the kernel takes them."""
    rows, n = x.shape
    if n & (n - 1):
        raise ValueError(f"row length {n} must be a power of 2")
    idx = torch.arange(n, device=x.device)
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            partner = x.reshape(rows, n // (2 * j), 2, j).flip(2).reshape(
                rows, n)
            less = partner < x
            lo = torch.where(less, partner, x)
            hi = torch.where(less, x, partner)
            keep_lo = ((idx & k) == 0) == ((idx & j) == 0)
            x = torch.where(keep_lo, lo, hi)
            j //= 2
        k *= 2
    return x


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """(BH, S, hd) dense softmax attention in fp32: the test oracle,
    as ``src/repro/kernels/ref.py::flash_attention_ref``.  Its causal mask
    is aligned bottom-right (``tril(k=Skv-S)``) while the kernel's is
    aligned top-left, so the two agree only when S == Skv."""
    s, hd = q.shape[1], q.shape[2]
    skv = k.shape[1]
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    sc = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    if causal:
        mask = torch.tril(torch.ones((s, skv), dtype=torch.bool,
                                     device=q.device), diagonal=skv - s)
        sc = torch.where(mask[None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _heads_first(q, k, v):
    """fp32 (B, Hq, S, hd) views with every kv head repeated over its
    group of query heads."""
    g = q.shape[2] // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    return qf, kf, vf


def _causal_keep(rows: int, cols: torch.Tensor) -> torch.Tensor:
    """(rows, len(cols)) mask of the kernel's causal rule ``col <= row``
    (aligned top-left)."""
    return cols[None, :] <= torch.arange(rows, device=cols.device)[:, None]


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              sm_scale: Optional[float] = None):
    """The flash kernel's forward: the online softmax over blocks of
    ``FLASH_BLOCK`` kv positions, ``(m, l, acc)`` in fp32, ``l`` floored at
    1e-30, masked scores at -1e30.  Returns the output (B, S, Hq, hd) in
    q's dtype and the log-sum-exp ``m + log(l)`` (B, Hq, S) in fp32, which
    the backward reads."""
    b, s, hq, hd = q.shape
    skv = k.shape[1]
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    qf, kf, vf = _heads_first(q, k, v)
    qf = qf * scale
    m = torch.full((b, hq, s, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, s, 1), device=q.device)
    acc = torch.zeros((b, hq, s, hd), device=q.device)
    end = min(skv, s) if causal else skv  # blocks past the last row's diagonal
    for start in range(0, end, FLASH_BLOCK):
        kj = kf[:, :, start:start + FLASH_BLOCK]
        vj = vf[:, :, start:start + FLASH_BLOCK]
        sc = qf @ kj.transpose(-1, -2)
        if causal:
            cols = start + torch.arange(kj.shape[2], device=q.device)
            sc = torch.where(_causal_keep(s, cols), sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ vj
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l).permute(0, 2, 1, 3).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              sm_scale: Optional[float] = None):
    """The flash kernels' backward in closed form from the forward's
    log-sum-exp: ``P = exp(S·scale - lse)``, ``D = rowsum(dO * O)``,
    ``dV = Pᵀ dO``, ``dS = P * (dO Vᵀ - D)``, ``dQ = scale · dS K``,
    ``dK = scale · dSᵀ Q``; dK and dV summed over each kv head's group of
    query heads.  Returns (dq, dk, dv) in the inputs' dtypes."""
    b, s, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    qf, kf, vf = _heads_first(q, k, v)
    of = o.float().permute(0, 2, 1, 3)
    dof = do.float().permute(0, 2, 1, 3)
    sc = (qf * scale) @ kf.transpose(-1, -2)
    if causal:
        sc = torch.where(
            _causal_keep(s, torch.arange(skv, device=q.device)), sc, NEG_INF)
    p = torch.exp(sc - lse[..., None])
    big_d = (dof * of).sum(dim=-1, keepdim=True)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - big_d)
    dq = scale * (ds @ kf)
    dk = scale * (ds.transpose(-1, -2) @ qf)
    fold = lambda t: t.reshape(b, hkv, hq // hkv, skv, hd).sum(dim=2)  # noqa: E731
    return (dq.permute(0, 2, 1, 3).to(q.dtype),
            fold(dk).permute(0, 2, 1, 3).to(k.dtype),
            fold(dv).permute(0, 2, 1, 3).to(v.dtype))
