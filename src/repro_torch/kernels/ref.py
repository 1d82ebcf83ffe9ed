"""Plain PyTorch versions of the port's kernels: the CPU path, and the
oracle each kernel is held against on the card.

The flash-attention functions take the wrapper's layout, q (B, S, Hq, hd)
and k, v (B, Skv, Hkv, hd) with Hq a multiple of Hkv (query head h reads kv
head h // (Hq / Hkv)), except ``flash_attention_ref``, which mirrors the
reference's oracle on heads folded into the batch.  The WKV functions take
r, k, v, logw (B, S, H, N) and u (H, N), as ``ops.wkv`` does."""

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


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor):
    """Sequential WKV6 recurrence oracle, as
    ``src/repro/kernels/ref.py::wkv_ref``: from a zero state,
    ``o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)`` and
    ``S_t = diag(e^{logw_t}) S_{t-1} + k_tᵀ v_t`` per (batch, head).
    Returns (out (B, S, H, N), final state (B, H, N, N)), both fp32
    (float64 for float64 inputs)."""
    b, s, h, n = r.shape
    acc = _wkv_acc_dtype(r)
    r, k, v, logw, u = (x.to(acc) for x in (r, k, v, logw, u))
    state = torch.zeros((b, h, n, n), dtype=acc, device=r.device)
    outs = []
    for t in range(s):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        o = torch.einsum("bhn,bhnm->bhm", rt, state) + torch.einsum(
            "bhn,hn,bhn,bhm->bhm", rt, u, kt, vt)
        state = torch.exp(logw[:, t])[..., None] * state + torch.einsum(
            "bhn,bhm->bhnm", kt, vt)
        outs.append(o)
    out = torch.stack(outs, dim=1) if outs else r.new_zeros((b, 0, h, n))
    return out, state


def _wkv_acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32, the kernels' arithmetic; float64 inputs keep float64 (for
    gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _wkv_chunks(x: torch.Tensor, chunk: int, acc: torch.dtype) -> torch.Tensor:
    """(B, S, H, N) -> (B, H, nc, L, N) in ``acc``, S padded with zeros to a
    multiple of L (zero logw and k make the padding a no-op)."""
    b, s, h, n = x.shape
    pad = (-s) % chunk
    xf = x.to(acc).permute(0, 2, 1, 3)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    return xf.reshape(b, h, -1, chunk, n)


def _wkv_unchunk(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, nc, L, N) -> contiguous (B, S, H, N), padding dropped."""
    b, h, nc, chunk, n = x.shape
    return x.reshape(b, h, nc * chunk, n)[:, :, :s].permute(
        0, 2, 1, 3).contiguous()


def _wkv_decay(cw, cwe, tri):
    """The strictly-lower pairwise decay ``exp(cwe_t - cw_s)`` (B, H, L, L,
    N), zero on and above the diagonal; every exponent kept is <= 0."""
    diff = cwe[:, :, :, None, :] - cw[:, :, None, :, :]
    return torch.exp(torch.where(tri[:, :, None], diff, float("-inf")))


def _wkv_cumsums(wj: torch.Tensor, subchunk: Optional[int]):
    """(cw, cwe) of one chunk's logw (B, H, L, N): cw its cumulative sum
    over the rows, cwe the exclusive one.  With ``subchunk`` None cwe is
    ``cw - logw`` (the arithmetic of the first kernels); with the sub-chunk
    factorization it is cw shifted down a row (0 at the first), which never
    exceeds the cw of an earlier row, so every exponent the factors take
    is <= 0 in fp32 too (``cw - logw`` can round an ulp above it)."""
    cw = torch.cumsum(wj, dim=2)
    if subchunk is None:
        return cw, cw - wj
    return cw, F.pad(cw[:, :, :-1], (0, 0, 1, 0))


def wkv_factor_exponents(cw: torch.Tensor, cwe: torch.Tensor,
                         subchunk: int):
    """The exponents of the pairwise decay factored by sub-chunk, for one
    chunk's cw, cwe (B, H, L, N) cut into sub-chunks of ``subchunk`` rows,
    with c_i = cwe at sub-chunk i's first row (= cw at the row before):

    * query (B, H, L, N): ``cwe_t - c_i`` for t in sub-chunk i;
    * key (B, H, nb, L, N): ``c_i - cw_s`` for s before sub-chunk i, -inf
      from it on;
    * diag (B, H, nb, sc, sc, N): ``cwe_t - cw_s`` for s < t within one
      sub-chunk, -inf elsewhere.

    For s in sub-chunk j < i and t in sub-chunk i, e^{cwe_t - cw_s} =
    e^{cwe_t - c_i} e^{c_i - cw_s}; cw never increases (logw <= 0), so every
    finite exponent here is <= 0 and no factor overflows."""
    b, h, L, n = cw.shape
    if L % subchunk:
        raise ValueError(f"chunk {L} is not a multiple of the sub-chunk "
                         f"{subchunk}")
    nb = L // subchunk
    c = cwe[:, :, ::subchunk]  # (B, H, nb, N)
    query = cwe - c.repeat_interleave(subchunk, dim=2)
    rows = torch.arange(L, device=cw.device)
    before = rows[None, :] < torch.arange(nb, device=cw.device)[:, None] \
        * subchunk  # (nb, L)
    key = torch.where(before[:, :, None],
                      c[:, :, :, None, :] - cw[:, :, None, :, :],
                      float("-inf"))
    cwb = cw.reshape(b, h, nb, subchunk, n)
    cweb = cwe.reshape(b, h, nb, subchunk, n)
    tri = torch.tril(torch.ones((subchunk, subchunk), dtype=torch.bool,
                                device=cw.device), diagonal=-1)
    diag = torch.where(tri[:, :, None],
                       cweb[..., :, None, :] - cwb[..., None, :, :],
                       float("-inf"))
    return query, key, diag


def wkv_max_exponent(logw: torch.Tensor, chunk: int = 64,
                     subchunk: int = 16) -> float:
    """The largest exponent the factored WKV takes for logw (B, S, H, N):
    the state factors (cwe, cw_L - cw, cw_L) and the three of
    ``wkv_factor_exponents``, over every chunk.  <= 0 for any logw <= 0."""
    wc = _wkv_chunks(logw, chunk, _wkv_acc_dtype(logw))  # (B, H, nc, L, N)
    b, h, nc, L, n = wc.shape
    cw, cwe = _wkv_cumsums(wc.reshape(b, h * nc, L, n), subchunk)
    wl = cw[:, :, -1:]
    found = [cwe.max(), (wl - cw).max(), wl.max()]
    for e in wkv_factor_exponents(cw, cwe, subchunk):
        e = e[torch.isfinite(e)]
        if e.numel():
            found.append(e.max())
    return max(float(x) for x in found)


def _block_diag(x: torch.Tensor) -> torch.Tensor:
    """(B, H, nb, sc, sc) blocks -> (B, H, L, L) with them on the diagonal,
    zero elsewhere."""
    b, h, nb, sc, _ = x.shape
    return torch.diag_embed(x.permute(0, 1, 3, 4, 2)).permute(
        0, 1, 4, 2, 5, 3).reshape(b, h, nb * sc, nb * sc)


def _diag_blocks(x: torch.Tensor, sc: int) -> torch.Tensor:
    """(B, H, L, L) -> its diagonal (B, H, nb, sc, sc) blocks."""
    b, h, L, _ = x.shape
    return x.reshape(b, h, L // sc, sc, L // sc, sc).diagonal(
        dim1=2, dim2=4).permute(0, 1, 4, 2, 3)


def _wkv_factors(rj, kj, cw, cwe, subchunk: int) -> dict:
    """The factored decay's tiles for one chunk (see
    ``wkv_factor_exponents``): qe = e^{query} (B, H, nb, sc, N) and
    qf = r qe; ke = e^{key} (B, H, nb, L, N), zero from sub-chunk i on, and
    kf = k ke; de = e^{diag} (B, H, nb, sc, sc, N); r and k by sub-chunk."""
    b, h, L, n = rj.shape
    nb = L // subchunk
    query, key, diag = wkv_factor_exponents(cw, cwe, subchunk)
    rb = rj.reshape(b, h, nb, subchunk, n)
    kb = kj.reshape(b, h, nb, subchunk, n)
    qe = torch.exp(query).reshape(b, h, nb, subchunk, n)
    ke = torch.exp(key)
    return dict(qe=qe, qf=rb * qe, ke=ke, kf=kj[:, :, None] * ke,
                de=torch.exp(diag), rb=rb, kb=kb)


def _wkv_a(rj, kj, cw, cwe, uf, subchunk: Optional[int]):
    """A (B, H, L, L) of one chunk: ``sum_n r[t, n] k[s, n] e^{cwe[t, n] -
    cw[s, n]}`` below the diagonal, ``sum_n r[t, n] u[n] k[t, n]`` on it.
    ``subchunk`` None takes the decay per (t, s, n); otherwise it is
    factored by sub-chunk: elementwise within the diagonal blocks, the
    product ``(r e^{cwe - c_i}) (k e^{c_i - cw})ᵀ`` below them."""
    L = rj.shape[2]
    if subchunk is None:
        tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                    device=rj.device), diagonal=-1)
        a = torch.einsum("bhtn,bhtsn,bhsn->bhts", rj,
                         _wkv_decay(cw, cwe, tri), kj)
    else:
        a = _wkv_a_factored(_wkv_factors(rj, kj, cw, cwe, subchunk))
    return a + torch.diag_embed((rj * uf * kj).sum(-1))


def _wkv_a_factored(f: dict) -> torch.Tensor:
    b, h, nb, sc, _ = f["qf"].shape
    off = torch.einsum("bhisn,bhizn->bhisz", f["qf"], f["kf"])
    blk = torch.einsum("bhitn,bhitsn,bhisn->bhits", f["rb"], f["de"],
                       f["kb"])
    return off.reshape(b, h, nb * sc, nb * sc) + _block_diag(blk)


def wkv_states_plain(k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                     chunk: int = 64, subchunk: Optional[int] = None):
    """The forward's state pass alone: from a zero state, chunk by chunk,
    ``S <- e^{cw_L} S + (k e^{cw_L - cw})ᵀ v``.  Returns (the state at each
    chunk's start (B, H, nc, N, N), the final state (B, H, N, N)), fp32
    (float64 for float64 inputs).  ``subchunk`` changes only cwe, which
    this pass does not read."""
    b, s, h, n = k.shape
    acc = _wkv_acc_dtype(k)
    kc, vc, wc = (_wkv_chunks(x, chunk, acc) for x in (k, v, logw))
    nc = kc.shape[2]
    state = torch.zeros((b, h, n, n), dtype=acc, device=k.device)
    starts = []
    for c in range(nc):
        starts.append(state)
        cw, _ = _wkv_cumsums(wc[:, :, c], subchunk)
        wl = cw[:, :, -1:]
        kd = kc[:, :, c] * torch.exp(wl - cw)
        state = torch.exp(wl[:, :, 0, :, None]) * state + kd.transpose(
            -1, -2) @ vc[:, :, c]
    if not nc:
        return torch.zeros((b, h, 0, n, n), dtype=acc, device=k.device), \
            state
    return torch.stack(starts, dim=2), state


def wkv_out_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor,
                  chunk_states: torch.Tensor, chunk: int = 64,
                  subchunk: Optional[int] = None) -> torch.Tensor:
    """The forward's output pass alone: each chunk's output from its start
    state (``chunk_states`` (B, H, nc, N, N)) and nothing carried,
    ``o = A v + (r e^{cwe}) S_c``.  Returns out (B, S, H, N) fp32 (float64
    for float64 inputs)."""
    b, s, h, n = r.shape
    acc = _wkv_acc_dtype(r)
    rc, kc, vc, wc = (_wkv_chunks(x, chunk, acc) for x in (r, k, v, logw))
    uf = u.to(acc)[None, :, None, :]  # (1, H, 1, N)
    outs = []
    for c in range(rc.shape[2]):
        rj, kj, vj = rc[:, :, c], kc[:, :, c], vc[:, :, c]
        cw, cwe = _wkv_cumsums(wc[:, :, c], subchunk)
        a = _wkv_a(rj, kj, cw, cwe, uf, subchunk)
        outs.append(a @ vj + (rj * torch.exp(cwe)) @
                    chunk_states[:, :, c].to(acc))
    if not outs:
        return torch.zeros((b, 0, h, n), dtype=acc, device=r.device)
    return _wkv_unchunk(torch.stack(outs, dim=2), s)


def wkv_fwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, chunk: int = 64,
                  subchunk: Optional[int] = None):
    """The WKV forward kernels' computation: the chunked form in fp32 from
    a zero state, as the state pass (``wkv_states_plain``) and the output
    pass (``wkv_out_plain``).  Per chunk of L positions
    ``cw = cumsum(logw)``, cwe its exclusive form,
    ``A[t, s] = sum_n r[t, n] k[s, n] exp(cwe[t, n] - cw[s, n])`` for s < t
    and ``sum_n r[t, n] u[n] k[t, n]`` on the diagonal,
    ``o = A v + (r e^{cwe}) S`` and
    ``S <- e^{cw_L} S + (k e^{cw_L - cw})ᵀ v``.  ``subchunk`` (the kernels'
    16) factors the pairwise decay by sub-chunk (``wkv_factor_exponents``)
    and takes cwe as cw shifted a row; None keeps the first kernels'
    arithmetic.  Returns (out (B, S, H, N), final state (B, H, N, N), the
    state at each chunk's start (B, H, nc, N, N)), all fp32 (float64 for
    float64 inputs); the backward reads the last."""
    starts, state = wkv_states_plain(k, v, logw, chunk, subchunk)
    out = wkv_out_plain(r, k, v, logw, u, starts, chunk, subchunk)
    return out, state, starts


def wkv_dstates_plain(r: torch.Tensor, logw: torch.Tensor,
                      dout: torch.Tensor,
                      dstate: Optional[torch.Tensor] = None,
                      chunk: int = 64,
                      subchunk: Optional[int] = None) -> torch.Tensor:
    """The backward's reverse state pass alone: from ``dS = dstate`` (zero
    if None) at the last chunk's end, chunk by chunk in reverse, record dS
    (the gradient of that chunk's end state), then
    ``dS <- (r e^{cwe})ᵀ dO + e^{cw_L} dS``.  Returns (B, H, nc, N, N)."""
    b, s, h, n = r.shape
    acc = _wkv_acc_dtype(r)
    rc, wc, dc = (_wkv_chunks(x, chunk, acc) for x in (r, logw, dout))
    nc = rc.shape[2]
    ds = torch.zeros((b, h, n, n), dtype=acc, device=r.device) \
        if dstate is None else dstate.to(acc)
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = ds
        cw, cwe = _wkv_cumsums(wc[:, :, c], subchunk)
        ds = (rc[:, :, c] * torch.exp(cwe)).transpose(-1, -2) @ \
            dc[:, :, c] + torch.exp(cw[:, :, -1, :, None]) * ds
    if not nc:
        return torch.zeros((b, h, 0, n, n), dtype=acc, device=r.device)
    return torch.stack(ends, dim=2)


def _wkv_intra_factored(rj, kj, cw, cwe, da, subchunk: int):
    """(A without its diagonal, dr_intra, dk_intra) of one chunk through
    the factored decay: ``dr_intra = [dA k e^{cwe_t - cw_s}]``,
    ``dk_intra = [dAᵀ r e^{cwe_t - cw_s}]`` (s < t), from dA (B, H, L, L).
    Below the diagonal blocks, dr takes ``qe (dA kf)`` for each query
    sub-chunk and dk ``ke (dAᵀ qf)`` summed over the query sub-chunks
    after it; within them the decay is elementwise."""
    b, h, L, n = rj.shape
    f = _wkv_factors(rj, kj, cw, cwe, subchunk)
    a = _wkv_a_factored(f)
    rows = da.reshape(b, h, L // subchunk, subchunk, L)  # query sub-chunks
    blocks = _diag_blocks(da, subchunk)  # de is 0 on and above the diagonal
    dr = torch.einsum("bhisz,bhizn->bhisn", rows, f["kf"]) * f["qe"] + \
        torch.einsum("bhits,bhitsn,bhisn->bhitn", blocks, f["de"], f["kb"])
    dk = (torch.einsum("bhitz,bhitn->bhizn", rows, f["qf"]) * f["ke"]).sum(2)
    dk = dk + torch.einsum("bhits,bhitsn,bhitn->bhisn", blocks, f["de"],
                           f["rb"]).reshape(b, h, L, n)
    return a, dr.reshape(b, h, L, n), dk


def wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor,
                  chunk_states: torch.Tensor, dout: torch.Tensor,
                  dstate: Optional[torch.Tensor] = None, chunk: int = 64,
                  subchunk: Optional[int] = None):
    """The WKV backward kernels' computation, in closed form: the reverse
    state pass (``wkv_dstates_plain``) gives ``dS``, the gradient of each
    chunk's end state (``dstate`` for the last, zero if None); then each
    chunk on its own, from its start state ``S0`` and the forward's A, cw,
    cwe: ``dA = dO vᵀ`` (s <= t), ``dv = Aᵀ dO + kd dS``,
    ``dr = [dA k e^{cwe_t - cw_s}] + dA_tt u k + (dO S0ᵀ) e^{cwe}``,
    ``dk = [dAᵀ r e^{cwe_t - cw_s}] + dA_ss u r + (v dSᵀ) e^{cw_L - cw}``,
    ``du = sum dA_tt r k``; the exponents' gradients ``dcwe = r [..]_r``,
    ``dcw = -k [..]_k - (v dSᵀ) kd`` plus
    ``dcw_L = sum (v dSᵀ) kd + e^{cw_L} rowsum(S0 dS)`` at the last row,
    and ``dlogw`` their reverse cumulative sums.  ``subchunk`` as in
    ``wkv_fwd_plain`` (the bracketed pairwise terms through the factored
    decay).  Returns (dr, dk, dv, dlogw, du) in the dtypes of (r, k, v,
    logw, u)."""
    b, s, h, n = r.shape
    acc = _wkv_acc_dtype(r)
    rc, kc, vc, wc, dc = (_wkv_chunks(x, chunk, acc)
                          for x in (r, k, v, logw, dout))
    ends = wkv_dstates_plain(r, logw, dout, dstate, chunk, subchunk)
    uf = u.to(acc)[None, :, None, :]
    nc = rc.shape[2]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    lower = torch.tril(torch.ones((chunk, chunk), dtype=acc,
                                  device=r.device))
    grads = [[None] * nc for _ in range(4)]
    du = torch.zeros((h, n), dtype=acc, device=r.device)
    for c in reversed(range(nc)):
        rj, kj, vj, wj, doj = (x[:, :, c] for x in (rc, kc, vc, wc, dc))
        s0 = chunk_states[:, :, c].to(acc)
        ds = ends[:, :, c]
        cw, cwe = _wkv_cumsums(wj, subchunk)
        wl = cw[:, :, -1:]
        ecwe = torch.exp(cwe)
        edk = torch.exp(wl - cw)
        kd = kj * edk
        da = (doj @ vj.transpose(-1, -2)) * lower
        dda = torch.diagonal(da, dim1=-2, dim2=-1)[..., None]  # (B,H,L,1)
        if subchunk is None:
            dec = _wkv_decay(cw, cwe, tri)
            a = torch.einsum("bhtn,bhtsn,bhsn->bhts", rj, dec, kj)
            da_l = da * tri
            dr_intra = torch.einsum("bhts,bhtsn,bhsn->bhtn", da_l, dec, kj)
            dk_intra = torch.einsum("bhts,bhtsn,bhtn->bhsn", da_l, dec, rj)
        else:
            a, dr_intra, dk_intra = _wkv_intra_factored(rj, kj, cw, cwe, da,
                                                        subchunk)
        a = a + torch.diag_embed((rj * uf * kj).sum(-1))
        dv = a.transpose(-1, -2) @ doj + kd @ ds
        drd = doj @ s0.transpose(-1, -2)
        dkd = vj @ ds.transpose(-1, -2)
        dr = dr_intra + dda * uf * kj + drd * ecwe
        dk = dk_intra + dda * uf * rj + dkd * edk
        du = du + (dda * rj * kj).sum(dim=(0, 2))
        dcwe = rj * (dr_intra + drd * ecwe)
        dcw = -kj * dk_intra - dkd * kd
        dcw_l = (dkd * kd).sum(2) + torch.exp(wl[:, :, 0]) * (s0 * ds).sum(-1)
        dcw[:, :, -1] += dcw_l
        tot = dcw + dcwe
        dw = torch.flip(torch.cumsum(torch.flip(tot, [2]), 2), [2]) - dcwe
        for i, g in enumerate((dr, dk, dv, dw)):
            grads[i][c] = g
    outs = []
    for g, like in zip(grads, (r, k, v, logw)):
        full = _wkv_unchunk(torch.stack(g, dim=2), s) if nc else \
            torch.zeros(like.shape, dtype=acc, device=r.device)
        outs.append(full.to(like.dtype))
    return (*outs, du.to(u.dtype))
