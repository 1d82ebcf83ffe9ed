"""Attention: GQA/MQA, dense and chunked (online-softmax) causal attention,
and KV-cache decode.

Shapes: q (B, S, Hq, hd); k, v (B, Skv, Hkv, hd); Hq % Hkv == 0.

``dense_attention`` and ``chunked_attention`` serve ``forward_logits`` and
are plain PyTorch, as they are XLA in the reference.  ``decode_attention``
serves every step of the serving path; its two contractions (q·k and p·v)
run on the matmul kernel, read straight out of the cache through strides.
That keeps the serving path batch-invariant: a slot's scores and outputs do
not depend on how many other slots share the step (a library batched
matmul may choose its algorithm from the batch count).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _group_query(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,Hq,hd) -> (B,S,Hkv,G,hd)."""
    b, s, hq, hd = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


# ---------------------------------------------------------------------------
# Dense (reference) attention
# ---------------------------------------------------------------------------


def _causal_mask(sq: int, kpos: torch.Tensor) -> torch.Tensor:
    """(S, len(kpos)) mask: query i sees the keys at positions <= i."""
    return kpos[None, :] <= torch.arange(sq, device=kpos.device)[:, None]


def dense_attention(q, k, v) -> torch.Tensor:
    """Full-materialization causal attention."""
    b, sq, hq, hd = q.shape
    n_kv = k.shape[2]
    qg = _group_query(q, n_kv).float()
    scores = torch.einsum("bsngd,btnd->bngst", qg * hd ** -0.5, k.float())
    mask = _causal_mask(sq, torch.arange(k.shape[1], device=q.device))
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnd->bsngd", probs, v.float())
    return out.reshape(b, sq, hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (memory-bounded)
# ---------------------------------------------------------------------------


def chunked_attention(q, k, v, *, chunk: int = 1024) -> torch.Tensor:
    """Online-softmax causal attention looping over KV chunks: peak live
    memory O(B*H*S*chunk), masked like ``dense_attention``."""
    b, sq, hq, hd = q.shape
    skv = k.shape[1]
    n_kv = k.shape[2]
    g = hq // n_kv
    dev = q.device
    qg = _group_query(q, n_kv).float() * hd ** -0.5
    m = torch.full((b, n_kv, sq, g), NEG_INF, device=dev)
    l = torch.zeros((b, n_kv, sq, g), device=dev)
    acc = torch.zeros((b, n_kv, sq, g, hd), device=dev)
    for start in range(0, skv, chunk):
        kj = k[:, start:start + chunk].float()
        vj = v[:, start:start + chunk].float()
        kpos = start + torch.arange(kj.shape[1], device=dev)
        s = torch.einsum("bsngd,btnd->bnsgt", qg, kj)
        mask = _causal_mask(sq, kpos)
        s = torch.where(mask[:, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bnsgt,btnd->bnsgd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(b, sq, hq, hd).to(q.dtype)


def attention(q, k, v, *, chunk: int = 1024) -> torch.Tensor:
    """Causal attention without a cache: dense up to ``2 * chunk`` query
    positions, chunked above (the reference's static crossover rule)."""
    if q.shape[1] <= 2 * chunk:
        return dense_attention(q, k, v)
    return chunked_attention(q, k, v, chunk=chunk)


# ---------------------------------------------------------------------------
# Decode-step attention against a KV cache
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_pos: torch.Tensor) -> torch.Tensor:
    """Attention of q (B, S_new, Hq, hd) against a (B, Smax, Hkv, hd) cache.

    ``cache_pos`` (a 0-d or (B,) integer tensor) counts valid cache entries
    including the ``S_new`` just inserted; a (B,) vector gives each slot
    its own fill level.  Queries are causal within the chunk: query ``i``
    attends to ``kpos < cache_pos - (S_new - 1) + i``.
    """
    b, sq, hq, hd = q.shape
    skv, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = hq // n_kv
    dev = q.device
    # (B, Hkv, S_new*G, hd) fp32, pre-scaled like the reference
    qg = (_group_query(q, n_kv).float() * hd ** -0.5).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(b, n_kv, sq * g, hd)
    scores = ops.matmul(qg, k_cache.permute(0, 2, 3, 1),
                        out_dtype=torch.float32)  # (B, Hkv, S_new*G, Smax)
    kpos = torch.arange(skv, device=dev)
    limit = (cache_pos.reshape(-1, 1) - (sq - 1)
             + torch.arange(sq, device=dev)[None])  # (1 or B, S_new)
    mask = (kpos[None, None, :] < limit[:, :, None]).expand(b, sq, skv)
    scores = torch.where(mask[:, None, :, None, :],
                         scores.reshape(b, n_kv, sq, g, skv), NEG_INF)
    probs = torch.softmax(scores, dim=-1).view(b, n_kv, sq * g, skv)
    out = ops.matmul(probs, v_cache.permute(0, 2, 1, 3),
                     out_dtype=torch.float32)  # (B, Hkv, S_new*G, hd)
    out = out.view(b, n_kv, sq, g, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Return caches with (B, S_new, Hkv, hd) inserted at ``pos`` along the
    sequence axis; ``pos`` is a 0-d (whole batch) or (B,) (per slot) integer
    tensor.  Functional, like the reference: the inputs are left as they
    were, so a masked slot's step can be discarded exactly.  The start is
    clamped to ``[0, Smax - S_new]``, as ``dynamic_update_slice`` clamps it."""
    b, smax = k_cache.shape[:2]
    s = k_new.shape[1]
    dev = k_cache.device
    start = pos.clamp(0, smax - s)
    cols = start.reshape(-1, 1) + torch.arange(s, device=dev)[None]
    rows = torch.arange(b, device=dev)[:, None]
    cols = cols.expand(b, s)
    k_cache = k_cache.clone()
    v_cache = v_cache.clone()
    k_cache[rows, cols] = k_new.to(k_cache.dtype)
    v_cache[rows, cols] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
