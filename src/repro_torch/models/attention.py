"""Attention: GQA/MQA, dense and chunked (online-softmax) causal or
bidirectional attention, encoder-decoder cross attention, and KV-cache
decode.

Shapes: q (B, S, Hq, hd); k, v (B, Skv, Hkv, hd); Hq % Hkv == 0.

``attention`` serves every self-attention without a cache
(``forward_logits``, ``prefill``, the training loss; causal, or
bidirectional in an encoder), and ``cross_attention`` a decoder's
attention to its encoder's output.  On a CUDA tensor both
run the hand-written flash kernels, forward and backward (the reference
reaches its Pallas flash kernel only through ``impl="flash"``; the port
takes it for the whole path, an implementation choice that leaves the
outputs the reference's).  On the CPU ``impl="auto"`` keeps the
reference's rule, ``dense_attention`` up to ``2 * chunk`` query positions
and ``chunked_attention`` above (plain PyTorch, as they are XLA in the
reference), and ``impl="flash"`` takes the flash kernels' plain versions.
A sliding window (``window > 0``, recurrentgemma's local layers) never runs
on flash, as the reference's flash refuses windows: ``attention`` keeps
the reference's dispatch, the banded ``local_attention`` above
``2 * window`` query positions and the masked dense or chunked form below.
The dense, chunked and banded forms share one body each, window or not,
and run their two contractions through ``ops.matmul`` as
``decode_attention`` does: the matmul kernel on the card (4-D, forward
and, through ``ops.MatmulFn``, backward, so the windowed forms train
there), its plain version on the CPU.  ``decode_attention`` serves every step of the serving path; its two contractions (q·k and p·v)
run on the matmul kernel, read straight out of the cache through strides.
That keeps the serving path batch-invariant: a slot's scores and outputs do
not depend on how many other slots share the step (a library batched
matmul may choose its algorithm from the batch count).  A paged cache
(``paged_update_kv_cache``, ``paged_gather_kv``) keeps the KV of every
slot in one shared pool of pages; the gather hands ``decode_attention``
the same (B, S, Hkv, hd) view a dense cache gives it, so both
contractions stay on the matmul kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul_fused_ref

NEG_INF = -1e30


def _group_query(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,Hq,hd) -> (B,S,Hkv,G,hd)."""
    b, s, hq, hd = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


# ---------------------------------------------------------------------------
# Dense (reference) attention
# ---------------------------------------------------------------------------


def _mask(sq: int, kpos: torch.Tensor, causal: bool,
          window: int) -> Optional[torch.Tensor]:
    """(S, len(kpos)) mask, None where every key is seen: query i sees the
    keys at positions <= i (``causal``) and > i - ``window`` (window > 0)."""
    qpos = torch.arange(sq, device=kpos.device)[:, None]
    kpos = kpos[None, :]
    if causal and window:
        return (kpos <= qpos) & (kpos > qpos - window)
    if causal:
        return kpos <= qpos
    if window:
        return kpos > qpos - window
    return None


def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, Hq, hd) -> (B, Hkv, S*G, hd) fp32 queries scaled by hd^-0.5,
    the rows ordered by query position, then by the group's heads."""
    b, s, hq, hd = q.shape
    qg = (_group_query(q, n_kv).float() * hd ** -0.5).permute(0, 2, 1, 3, 4)
    return qg.reshape(b, n_kv, s * (hq // n_kv), hd)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 for 4-D batches, on the matmul kernel (its plain
    version on the CPU).  On the card a gradient goes through
    ``ops.MatmulFn``, whose backward is two more 4-D products on the
    kernel.  Where a CPU operand needs a gradient (training on the CPU,
    the autograd oracle of the flash and matmul tests) the plain fp32
    product runs under PyTorch's own autograd instead, so the CPU keeps an
    oracle independent of ``MatmulFn``."""
    if a.device.type == "cpu" and torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad):
        return matmul_fused_ref(a, b, out_dtype=torch.float32)
    return ops.matmul(a, b, out_dtype=torch.float32)


def _scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B', Hkv, R, hd) fp32 queries against keys (B', T, Hkv, hd): (B',
    Hkv, R, T) fp32, on the matmul kernel reading k through its strides."""
    return _product(qg, k.permute(0, 2, 3, 1))


def _mix(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B', Hkv, R, T) fp32 probabilities times values (B', T, Hkv, hd):
    (B', Hkv, R, hd) fp32, on the matmul kernel."""
    return _product(probs, v.permute(0, 2, 1, 3))


def _ungroup(out: torch.Tensor, sq: int, hq: int, dtype) -> torch.Tensor:
    """(B, Hkv, S*G, hd) -> (B, S, Hq, hd) in ``dtype``."""
    b, n_kv, _, hd = out.shape
    out = out.view(b, n_kv, sq, hq // n_kv, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(b, sq, hq, hd).to(dtype)


def dense_attention(q, k, v, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Full-materialization attention; ``window`` > 0 masks each query to
    the ``window`` keys ending at its own position."""
    b, sq, hq, _ = q.shape
    n_kv = k.shape[2]
    g = hq // n_kv
    scores = _scores(_grouped(q, n_kv), k).view(b, n_kv, sq, g, -1)
    mask = _mask(sq, torch.arange(k.shape[1], device=q.device), causal,
                 window)
    if mask is not None:
        scores = torch.where(mask[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).view(b, n_kv, sq * g, -1)
    return _ungroup(_mix(probs, v), sq, hq, q.dtype)


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (memory-bounded)
# ---------------------------------------------------------------------------


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention looping over KV chunks: peak live memory
    O(B*H*S*chunk), masked like ``dense_attention``."""
    b, sq, hq, hd = q.shape
    n_kv = k.shape[2]
    g = hq // n_kv
    dev = q.device
    qg = _grouped(q, n_kv)  # (B, Hkv, S*G, hd)
    m = torch.full((b, n_kv, sq, g), NEG_INF, device=dev)
    l = torch.zeros((b, n_kv, sq, g), device=dev)
    acc = torch.zeros((b, n_kv, sq * g, hd), device=dev)
    for start in range(0, k.shape[1], chunk):
        kj, vj = k[:, start:start + chunk], v[:, start:start + chunk]
        s = _scores(qg, kj).view(b, n_kv, sq, g, -1)
        mask = _mask(sq, start + torch.arange(kj.shape[1], device=dev),
                     causal, window)
        if mask is not None:
            s = torch.where(mask[:, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.reshape(b, n_kv, sq * g, 1) + _mix(
            p.view(b, n_kv, sq * g, -1), vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).reshape(b, n_kv, sq * g, 1)
    return _ungroup(out, sq, hq, q.dtype)


# ---------------------------------------------------------------------------
# Local (sliding-window) attention: the exact banded form, O(S * W)
# ---------------------------------------------------------------------------


def local_attention(q, k, v, *, window: int) -> torch.Tensor:
    """Causal sliding-window attention: each token attends to the
    ``window`` tokens ending at itself.  Block form: each block of
    ``window`` queries attends to [previous block | own block], both
    contractions on the matmul kernel with the blocks folded into the
    batch."""
    b, s, hq, hd = q.shape
    n_kv = k.shape[2]
    g = hq // n_kv
    w = window
    pad = (-s) % w
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    nb = q.shape[1] // w
    kb = k.reshape(b, nb, w, n_kv, hd)
    vb = v.reshape(b, nb, w, n_kv, hd)
    # block 0's "previous" block is zeros, fully masked
    k2 = torch.cat([F.pad(kb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1], kb], dim=2)
    v2 = torch.cat([F.pad(vb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1], vb], dim=2)
    qg = _grouped(q.reshape(b * nb, w, hq, hd), n_kv)  # (B*nb, Hkv, w*G, hd)
    scores = _scores(qg, k2.reshape(b * nb, 2 * w, n_kv, hd))
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None]
    kpos = torch.arange(2 * w, device=dev)[None, :] - w  # from block start
    band = (kpos <= qpos) & (kpos > qpos - w)  # (w, 2w)
    valid_prev = ((torch.arange(nb, device=dev) > 0)[:, None, None]
                  | (kpos >= 0)[None])  # (nb, 1, 2w)
    mask = (band[None] & valid_prev).repeat(b, 1, 1)  # (B*nb, w, 2w)
    scores = scores.view(b * nb, n_kv, w, g, 2 * w)
    scores = torch.where(mask[:, None, :, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).view(b * nb, n_kv, w * g, 2 * w)
    out = _ungroup(_mix(probs, v2.reshape(b * nb, 2 * w, n_kv, hd)), w, hq,
                   q.dtype)
    return out.reshape(b, nb * w, hq, hd)[:, :s]


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """The flash kernels (their plain versions for CPU tensors)."""
    return ops.flash_attention(q, k, v, causal=causal)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              chunk: int = 1024, impl: str = "auto") -> torch.Tensor:
    """Attention without a cache.  Without a window a CUDA tensor runs the
    flash kernels whatever ``impl`` says.  On the CPU ``"auto"`` is dense up
    to ``2 * chunk`` query positions and chunked above (the reference's
    static crossover rule) and ``"flash"`` the flash kernels' plain
    versions.  A window keeps the reference's dispatch on both devices:
    ``local_attention`` above ``2 * window`` query positions, else the
    masked dense or chunked form; ``impl="flash"`` refuses it."""
    if impl not in ("auto", "flash"):
        raise ValueError(f"impl must be 'auto' or 'flash', got {impl!r}")
    if window:
        if impl == "flash":
            raise ValueError("impl='flash' does not support sliding windows; "
                             "use the local_attention path")
        if q.shape[1] > 2 * window:
            return local_attention(q, k, v, window=window)
        if q.shape[1] <= 2 * chunk:
            return dense_attention(q, k, v, causal=causal, window=window)
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=chunk)
    if impl == "flash" or ops.on_card(q):
        return flash_attention(q, k, v, causal=causal)
    if q.shape[1] <= 2 * chunk:
        return dense_attention(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal, chunk=chunk)


def cross_attention(q, k, v, *, cached: bool = False) -> torch.Tensor:
    """Unmasked attention of decoder queries q (B, S, Hq, hd) to encoder
    keys and values (B, S_enc, Hkv, hd), S and S_enc free.  Without a
    cache (``loss``, ``prefill``) a CUDA tensor runs the flash kernels with
    ``causal=False``, forward and backward; the CPU keeps the reference's
    ``dense_attention``.  From a decode cache (``cached``) both devices run
    ``dense_attention``: its two contractions on the matmul kernel over
    every cached row, as ``decode_attention`` runs them, so a slot's
    result does not depend on the other slots of the step."""
    if ops.on_card(q) and not cached:
        return flash_attention(q, k, v, causal=False)
    return dense_attention(q, k, v, causal=False)


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
    b, sq, hq, _ = q.shape
    skv, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = hq // n_kv
    dev = q.device
    # fp32 queries pre-scaled like the reference's
    scores = _scores(_grouped(q, n_kv), k_cache)  # (B, Hkv, S_new*G, Smax)
    kpos = torch.arange(skv, device=dev)
    limit = (cache_pos.reshape(-1, 1) - (sq - 1)
             + torch.arange(sq, device=dev)[None])  # (1 or B, S_new)
    mask = (kpos[None, None, :] < limit[:, :, None]).expand(b, sq, skv)
    scores = torch.where(mask[:, None, :, None, :],
                         scores.reshape(b, n_kv, sq, g, skv), NEG_INF)
    probs = torch.softmax(scores, dim=-1).view(b, n_kv, sq * g, skv)
    return _ungroup(_mix(probs, v_cache), sq, hq, q.dtype)


def decode_attention_partial(q: torch.Tensor, k_blk: torch.Tensor,
                             v_blk: torch.Tensor, cache_pos: torch.Tensor,
                             first: int) -> torch.Tensor:
    """``decode_attention``'s softmax over one block of a cache split
    along its length, the block's rows at positions ``first`` on, kept as
    fp32 partials: (B, Hkv, S_new*G, hd + 2) holding the unnormalised P·V,
    then the running max and the sum of exponentials of each query row
    (0 and -1e30 for a row that sees no key of the block).
    ``rescale_partials`` and ``finish_partials`` join the blocks'
    partials."""
    b, sq, hq, _ = q.shape
    skv, n_kv = k_blk.shape[1], k_blk.shape[2]
    g = hq // n_kv
    dev = q.device
    scores = _scores(_grouped(q, n_kv), k_blk).reshape(b, n_kv, sq, g, skv)
    kpos = first + torch.arange(skv, device=dev)
    limit = (cache_pos.reshape(-1, 1) - (sq - 1)
             + torch.arange(sq, device=dev)[None])
    mask = (kpos[None, None, :] < limit[:, :, None]).expand(b, sq, skv)
    mask = mask[:, None, :, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = _mix(p.view(b, n_kv, sq * g, skv), v_blk)
    return torch.cat([o, m.view(b, n_kv, sq * g, 1),
                      l.view(b, n_kv, sq * g, 1)], dim=-1)


def rescale_partials(part: torch.Tensor, m_max: torch.Tensor
                     ) -> torch.Tensor:
    """A block's ``decode_attention_partial`` result scaled by
    exp(its running max - ``m_max``), the maximum over every block: summed
    over the blocks it gives the whole cache's unnormalised P·V and sum of
    exponentials (its max column is then unused)."""
    return torch.exp(part[..., -2:-1] - m_max) * part


def finish_partials(total: torch.Tensor, sq: int, hq: int,
                    dtype) -> torch.Tensor:
    """The sum over the blocks of ``rescale_partials`` (B, Hkv, S_new*G,
    hd + 2) normalised and rounded once: (B, S_new, Hq, hd) in
    ``dtype``."""
    return _ungroup(total[..., :-2] / total[..., -1:], sq, hq, dtype)


def update_kv_block(k_blk, v_blk, k_new, v_new, pos, first: int,
                    total: int):
    """``update_kv_cache`` on one block of a cache of ``total`` rows split
    along its length, the block's rows at positions ``first`` on: the new
    (B, S_new, Hkv, hd) rows at ``pos`` (clamped to ``[0, total - S_new]``)
    land where they fall inside the block, each slot masked on its own, and
    the block's other rows keep their values.  Functional: new tensors."""
    b, rows = k_blk.shape[:2]
    s = k_new.shape[1]
    dev = k_blk.device
    start = pos.clamp(0, total - s).reshape(-1, 1)
    j = first + torch.arange(rows, device=dev)[None] - start  # (1|B, rows)
    hit = ((j >= 0) & (j < s)).expand(b, rows)[..., None, None]
    idx = j.clamp(0, s - 1).expand(b, rows)
    slot = torch.arange(b, device=dev)[:, None]
    return (torch.where(hit, k_new[slot, idx].to(k_blk.dtype), k_blk),
            torch.where(hit, v_new[slot, idx].to(v_blk.dtype), v_blk))


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


# ---------------------------------------------------------------------------
# Paged KV cache: shared page pool + per-slot block tables
# ---------------------------------------------------------------------------


def paged_update_kv_cache(pk, pv, k_new, v_new, pos, block_tables,
                          block_size: int):
    """Scatter (B, S_new, Hkv, hd) new KV into the shared page pools, IN
    PLACE, and return them.

    ``pk``/``pv`` are (n_blocks, block_size, Hkv, hd) pools shared by all
    slots; ``block_tables`` is (B, max_blocks) mapping each slot's logical
    block index to a physical page; ``pos`` is a 0-d or (B,) tensor of
    logical write offsets.  Writes at logical positions past the table (or
    rows whose table entry is unallocated) land in block 0, the reserved
    null page, so masked slots and clamped indices never touch live pages.
    Several writes to one row of block 0 leave any one of them there; that
    page is only ever read where the attention length limit masks it.
    The reference writes a donated buffer; here the pools are written in
    place, never copied per layer and step."""
    b, sq = k_new.shape[:2]
    dev = k_new.device
    max_blocks = block_tables.shape[1]
    pos = pos.reshape(-1).expand(b)  # 0-d or (B,) -> (B,)
    logical = pos[:, None] + torch.arange(sq, device=dev)[None]  # (B, S_new)
    valid = logical < max_blocks * block_size
    bidx = torch.clamp(torch.div(logical, block_size, rounding_mode="floor"),
                       0, max_blocks - 1)
    table = torch.gather(block_tables.to(torch.int64), 1, bidx)
    table = torch.where(valid, table, 0)  # out of range -> null block
    flat = (table * block_size + logical % block_size).reshape(-1)
    rows = pk.shape[2:]
    pk.view((-1,) + rows)[flat] = k_new.reshape((b * sq,) + rows).to(pk.dtype)
    pv.view((-1,) + rows)[flat] = v_new.reshape((b * sq,) + rows).to(pv.dtype)
    return pk, pv


def paged_gather_kv(pk, pv, block_tables, block_size: int):
    """Each slot's logical KV view gathered from the page pools:
    (n_blocks, bs, Hkv, hd) x (B, max_blocks) -> (B, max_blocks*bs, Hkv, hd).

    The result feeds ``decode_attention`` unchanged: its length limit masks
    every position past the slot's fill level, so whatever stale or null
    data the unwritten page tails hold gets exactly zero probability."""
    b, max_blocks = block_tables.shape
    kc = pk[block_tables]  # (B, max_blocks, bs, Hkv, hd)
    vc = pv[block_tables]
    kc = kc.reshape((b, max_blocks * block_size) + pk.shape[2:])
    vc = vc.reshape((b, max_blocks * block_size) + pv.shape[2:])
    return kc, vc
