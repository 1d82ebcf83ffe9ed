"""Decoder-only transformer assembly: the layers are a plain Python list,
applied in a loop (the reference scans stacked parameters; the port's
``convert.params_from_jax`` unstacks them).  Without a decode state each
layer is recomputed in the backward pass (``remat``), as the reference
wraps its scan body in ``jax.checkpoint``.  The port has the reference's
decoder layer kinds: full attention (``attn``), sliding-window attention
over a ring buffer (``local``), the RG-LRU (``rglru``) and rwkv.  An
attention or RG-LRU layer's FFN is dense or, in a mixture-of-experts
config, ``ffn.moe_apply``, whose load-balance loss is the layer's
auxiliary loss.  Queries and keys rotate by the config's position encoding
(RoPE, M-RoPE or none).  Every kind exposes the same (x, state) -> (x,
state, aux) interface.

On a mesh (a ``ShardingCtx``) every argument is a list with one entry a
position: ``layer_apply_tp``/``stack_apply_tp`` serve on a model axis,
``stack_train_tp`` trains on a (pod?, data, model) mesh.  A training
layer gathers its FSDP-split weights over the data axes first, inside its
recomputed body, so a position holds one layer's gathered weights at a
time; the residual stream stays replicated over the model axis.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import psum
from repro_torch.kernels.tuning import recompute_contexts
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.common import (
    dense_init,
    dtype_of,
    positional_pair,
    project,
    rmsnorm,
    rmsnorm_init,
)


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"layer kind {kind!r} is not ported yet (other model families)")


# ---------------------------------------------------------------------------
# Per-layer init
# ---------------------------------------------------------------------------


def _attn_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """Projection weights as (in, out) matrices: wq (d, Hq*hd), wk and wv
    (d, Hkv*hd), wo (Hq*hd, d)."""
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype),
    }


def _ffn_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    if cfg.is_moe:
        return ffn_lib.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                cfg.activation, dtype)
    return ffn_lib.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                            dtype)


def layer_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": rmsnorm_init(cfg.d_model, gen.device),
                         "ln2": rmsnorm_init(cfg.d_model, gen.device)}
    if kind in ("attn", "local"):
        p["attn"] = _attn_init(gen, cfg, dtype)
        p["ffn"] = _ffn_init(gen, cfg, dtype)
    elif kind == "rglru":
        p["rglru"] = rglru_lib.rglru_init(gen, cfg.d_model,
                                          cfg.lru_width or cfg.d_model, dtype)
        p["ffn"] = _ffn_init(gen, cfg, dtype)
    elif kind == "rwkv":
        p["time"] = rwkv_lib.rwkv_time_mix_init(gen, cfg.d_model,
                                                cfg.rnn_head_dim, dtype)
        p["channel"] = rwkv_lib.rwkv_channel_mix_init(gen, cfg.d_model,
                                                      cfg.d_ff, dtype)
    else:
        raise _unported(kind)
    return p


# ---------------------------------------------------------------------------
# Per-layer apply
# ---------------------------------------------------------------------------


def _kv_heads_used(cfg: ModelConfig, nq: int, nkv: int, rank: int):
    """The kv heads, counted in the ``nkv`` a position stores, that its
    ``nq`` query heads (from ``rank * nq`` on) attend to; None where it
    uses every one it stores (unsharded, or kv heads split with the
    queries).  Where the kv heads do not divide the model axis a position
    stores them all and its queries use one contiguous run of them, each
    kv head for as many query heads as the group size."""
    h, h_kv = cfg.n_heads, cfg.n_kv_heads
    if nq == h or nkv < h_kv:
        return None
    g = h // h_kv
    q_lo = rank * nq
    lo, hi = q_lo // g, (q_lo + nq - 1) // g + 1
    if nq % (hi - lo) or (nq >= g and q_lo % g):
        raise NotImplementedError(
            f"{cfg.name}: {nq} query heads a position from head {q_lo} do "
            f"not cover whole groups of {g}")
    return lo, hi


def _qkv(params, cfg: ModelConfig, x, positions):
    """The query, key and value heads this position projects, (B, S, n,
    hd) each, the queries and keys rotated by ``positions``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = project(x, params["wq"]).reshape(b, s, -1, hd)
    k = project(x, params["wk"]).reshape(b, s, -1, hd)
    v = project(x, params["wv"]).reshape(b, s, -1, hd)
    q, k = positional_pair(q, k, positions, cfg.pos_type, cfg.rope_theta)
    return q, k, v


def _attn_apply(params, cfg: ModelConfig, x, positions, *, window: int = 0,
                cache=None, cache_pos=None, block_tables=None,
                rank: int = 0, chunk: int = 1024):
    """Returns (out, new_cache).  A cache with ``pk``/``pv`` is a paged
    pool: the new KV is written into it in place through ``block_tables``
    and each slot's view is gathered back for the attention.  With a
    ``window`` the cache is a ring buffer of that many positions: the new
    KV goes to ``cache_pos % W`` and the queries attend to the
    ``min(cache_pos + S_new, W)`` entries written, in any order (RoPE has
    already placed them).

    On a serve mesh ``params`` are one position's blocks and ``rank`` its
    index along the model axis (``transformer.layer_apply_tp``): wq holds
    its query heads (all of them where the heads do not divide the axis),
    wk/wv and the cache its kv heads or, where those do not divide, all of
    them, of which its queries read the ones they use (``_kv_heads_used``).
    A row block of ``wo`` gives an fp32 partial of the output, from the
    attention output's matching columns, for the caller's row sum.
    ``chunk``: the CPU's dense/chunked crossover without a cache (the
    reference's ``ctx.attn_chunk``)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    nq, nkv = q.shape[2], k.shape[2]
    used = _kv_heads_used(cfg, nq, nkv, rank)

    def heads(t):  # the kv heads this position's queries read
        return t if used is None else t[:, :, used[0]:used[1]]

    if cache is not None and window:
        w = cache["k"].shape[1]
        kc, vc = attn_lib.update_kv_cache(cache["k"], cache["v"], k, v,
                                          cache_pos % w)
        out = attn_lib.decode_attention(q, heads(kc), heads(vc),
                                        torch.clamp(cache_pos + s, max=w))
        new_cache = {"k": kc, "v": vc}
    elif cache is not None and "pk" in cache:
        bs = cache["pk"].shape[1]
        pk, pv = attn_lib.paged_update_kv_cache(
            cache["pk"], cache["pv"], k, v, cache_pos, block_tables, bs)
        kc, vc = attn_lib.paged_gather_kv(pk, pv, block_tables, bs)
        out = attn_lib.decode_attention(q, heads(kc), heads(vc),
                                        cache_pos + s)
        new_cache = {"pk": pk, "pv": pv}
    elif cache is not None:
        kc, vc = attn_lib.update_kv_cache(cache["k"], cache["v"], k, v,
                                          cache_pos)
        out = attn_lib.decode_attention(q, heads(kc), heads(vc),
                                        cache_pos + s)
        new_cache = {"k": kc, "v": vc}
    else:
        if used is not None:
            k, v = heads(k).contiguous(), heads(v).contiguous()
        out = attn_lib.attention(q, k, v, window=window, chunk=chunk)
        new_cache = None
    return out_projection(out.reshape(b, s, -1), params["wo"], cfg, nq,
                          rank), new_cache


def out_projection(out, wo, cfg: ModelConfig, nq: int, rank: int = 0):
    """An attention output (B, S, nq*hd) through ``wo`` on one position:
    whole, in the activations' dtype, where ``wo`` is whole; else an fp32
    partial from the output's columns that match ``wo``'s row block, for
    the caller's sum over the model axis (``wo_sum``)."""
    hd = cfg.resolved_head_dim
    rows = wo.shape[0]
    if nq < cfg.n_heads and rows != nq * hd:
        raise NotImplementedError(
            f"{cfg.name}: query heads split over the model axis need wo's "
            f"rows split with them")
    if rows == cfg.n_heads * hd:
        return project(out, wo)
    if nq == cfg.n_heads:  # every head here: this row block's columns
        out = out[..., rank * rows:(rank + 1) * rows]
    return project(out, wo, out_dtype=torch.float32)


def wo_sum(ctx, wos: List[torch.Tensor], cfg: ModelConfig, outs,
           dtype: torch.dtype) -> list:
    """``out_projection``'s results on every position: the fp32 partials
    summed over the model axis and rounded once to ``dtype`` where ``wo``
    is split by rows, else as they are."""
    if wos[0].shape[0] < cfg.n_heads * cfg.resolved_head_dim:
        return ctx.row_sum(outs, dtype)
    return outs


def ffn_tp(ctx, ffns: List[dict], cfg: ModelConfig, hs,
           dtype: torch.dtype) -> list:
    """The dense FFN on every position: each its column block of
    ``w_in``/``w_gate`` and the matching rows of ``w_out``, whose fp32
    partials are summed over the model axis and rounded once to ``dtype``
    (``ctx.row_sum``); whole where the width does not split."""
    split = ffns[0]["w_out"].shape[0] < cfg.d_ff
    outs = ctx.map(lambda p, h: ffn_lib.ffn_apply(
        p, h, cfg.activation, out_dtype=torch.float32 if split else None),
        ffns, hs)
    return ctx.row_sum(outs, dtype) if split else outs


def _ffn_apply(params, cfg: ModelConfig, x, want_aux: bool):
    """The layer's FFN and its auxiliary loss: a mixture of experts' 0-d
    fp32 load-balance loss (when ``want_aux``), else the float 0.0 (no
    launch)."""
    if not cfg.is_moe:
        return ffn_lib.ffn_apply(params, x, cfg.activation), 0.0
    y, aux = ffn_lib.moe_apply(params, x, top_k=cfg.experts_per_token,
                               activation=cfg.activation, aux=want_aux)
    return y, 0.0 if aux is None else aux


def layer_apply(params, cfg: ModelConfig, kind: str, x, positions, *,
                state=None, cache_pos=None, rnn_chunk: Optional[int] = None,
                block_tables=None, want_aux: bool = True
                ) -> Tuple[torch.Tensor, Any, Any]:
    """Pre-norm residual block: norm, mixer (attention, the RG-LRU or the
    rwkv time mix), residual; norm, FFN (or the rwkv channel mix),
    residual.  Returns (x, new_state, aux_loss): a mixture of experts'
    load-balance loss as a 0-d fp32 tensor, else the float 0.0 (no launch);
    ``want_aux=False`` skips computing it (decode returns none).
    ``rnn_chunk`` is the WKV chunk length (the reference's
    ``ctx.rnn_chunk``); None lets ``ops.wkv`` resolve it through the
    autotuner on the card (64 on the CPU and without measurement)."""
    if kind not in ("attn", "local", "rglru", "rwkv"):
        raise _unported(kind)
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind in ("attn", "local"):
        out, new_state = _attn_apply(
            params["attn"], cfg, h, positions,
            window=cfg.window_size if kind == "local" else 0, cache=state,
            cache_pos=cache_pos, block_tables=block_tables)
    elif kind == "rglru":
        out, new_state = rglru_lib.rglru_apply(params["rglru"], h, state)
    else:
        out, new_time = rwkv_lib.rwkv_time_mix(
            params["time"], h, cfg.rnn_head_dim,
            state["time"] if state is not None else None, chunk=rnn_chunk)
    x = x + out
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if kind != "rwkv":
        out2, aux = _ffn_apply(params["ffn"], cfg, h2, want_aux)
        return x + out2, new_state, aux
    out2, new_channel = rwkv_lib.rwkv_channel_mix(
        params["channel"], h2, state["channel"] if state is not None else None)
    new_state = {"time": new_time, "channel": new_channel} \
        if state is not None else None
    return x + out2, new_state, 0.0


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------


def layer_init_state(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, paging=None) -> Dict[str, Any]:
    """A layer's decode state: the KV cache {"k", "v"} (B, max_len, Hkv,
    hd); a local layer's ring buffer {"k", "v"} (B, window, Hkv, hd); the
    RG-LRU state {"h" (B, W) fp32, "conv" (B, 3, W)}; or the rwkv state
    {"time": {"S", "shift"}, "channel": {"shift"}}; slot axis first on
    every leaf.  ``paging=(n_blocks, block_size)`` turns an attention
    layer's cache into a page pool shared by all slots, {"pk", "pv"}
    (n_blocks, block_size, Hkv, hd) with no slot axis, zero-filled so that
    every page only ever holds finite values (a masked position's
    probability is exactly 0, and 0 x NaN would be NaN).  Ring buffers and
    recurrent states stay dense per slot, as in the reference."""
    hd = cfg.resolved_head_dim
    if kind == "rwkv":
        return rwkv_lib.rwkv_init_state(batch, cfg.d_model, cfg.rnn_head_dim,
                                        dtype, device)
    if kind == "rglru":
        return rglru_lib.rglru_init_state(batch, cfg.lru_width or cfg.d_model,
                                          dtype, device)
    if kind == "local":
        shape = (batch, cfg.window_size, cfg.n_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind != "attn":
        raise _unported(kind)
    if paging is not None:
        n_blocks, block_size = paging
        shape = (n_blocks, block_size, cfg.n_kv_heads, hd)
        return {"pk": torch.zeros(shape, dtype=dtype, device=device),
                "pv": torch.zeros(shape, dtype=dtype, device=device)}
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Whole decoder stack
# ---------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg: ModelConfig) -> List[dict]:
    dtype = dtype_of(cfg.dtype)
    return [layer_init(gen, cfg, cfg.block_kind(i), dtype)
            for i in range(cfg.n_layers)]


def stack_init_state(cfg: ModelConfig, batch: int, max_len: int,
                     device, paging=None) -> List[dict]:
    dtype = dtype_of(cfg.dtype)
    return [layer_init_state(cfg, cfg.block_kind(i), batch, max_len, dtype,
                             device, paging)
            for i in range(cfg.n_layers)]


def stack_apply(layers: List[dict], cfg: ModelConfig, x, positions, *,
                states: Optional[List[dict]] = None, cache_pos=None,
                remat: bool = True, rnn_chunk: Optional[int] = None,
                block_tables=None):
    """Run all layers.  Returns (x, new_states, aux_total): the sum of the
    layers' auxiliary losses, a 0-d fp32 tensor for a mixture of experts
    (the float 0.0 for other stacks, and with a decode state, which skips
    it).

    With ``remat`` and no decode state, each layer keeps only its input for
    the backward pass and runs again there
    (``torch.utils.checkpoint``, non-reentrant).  ``block_tables`` (B,
    max_blocks) addresses paged attention caches."""
    decode = states is not None
    aux_total = 0.0
    new_states = [] if decode else None
    for i, lp in enumerate(layers):
        kind = cfg.block_kind(i)
        if remat and not decode:
            x, _, aux = checkpoint(layer_apply, lp, cfg, kind, x, positions,
                                   rnn_chunk=rnn_chunk, use_reentrant=False,
                                   context_fn=recompute_contexts)
        else:
            x, new_st, aux = layer_apply(
                lp, cfg, kind, x, positions,
                state=states[i] if decode else None, cache_pos=cache_pos,
                rnn_chunk=rnn_chunk, block_tables=block_tables,
                want_aux=not decode)
            if decode:
                new_states.append(new_st)
        aux_total = aux_total + aux
    return x, new_states, aux_total


# ---------------------------------------------------------------------------
# Tensor parallelism over a serve mesh
# ---------------------------------------------------------------------------


def layer_apply_tp(ctx, lps: List[dict], cfg: ModelConfig, kind: str, xs,
                   positions, *, states, cache_pos, block_tables,
                   rnn_chunk: Optional[int] = None):
    """``layer_apply`` on every position of ``ctx``'s model axis (the
    auxiliary loss dropped: a serve mesh runs no mixture of experts): each
    argument a list with one entry a position, ``lps`` each position's
    blocks of the layer (``place_tree`` by the serve specs), the
    activations replicated.  Returns (xs, new states), a list each.

    The norms, residuals, RG-LRU and what rwkv computes from replicated
    weights run whole on every position.  Attention runs each position's
    heads (``_attn_apply(rank=)``) and the FFN its column block of
    ``w_in``/``w_gate``; the row-parallel ``wo`` and ``w_out`` give fp32
    partials summed over the model axis in fp32 and rounded once
    (``ctx.row_sum``).  rwkv's column-parallel ``w_k`` projections (time
    and channel mix) are gathered over the axis before the rest of the
    mix, whose other weights are replicated."""
    xs, new_states, _ = _layer_tp(
        ctx, lps, cfg, kind, xs, positions, states=states,
        cache_pos=cache_pos, block_tables=block_tables, rnn_chunk=rnn_chunk)
    return xs, new_states


def _layer_tp(ctx, lps: List[dict], cfg: ModelConfig, kind: str, xs,
              positions, *, states, cache_pos, block_tables,
              rnn_chunk: Optional[int] = None):
    """``layer_apply_tp`` returning the auxiliary losses too (one a
    position; a mixture of experts' through ``ffn.moe_apply`` on the
    context: expert parallelism over the model axis, the load balance
    over the global tokens)."""
    n = ctx.mesh.size
    ranks = [ctx.rank(i) for i in range(n)]
    dtype = xs[0].dtype
    none = [None] * n
    hs = ctx.map(lambda lp, x: rmsnorm(lp["ln1"], x, cfg.norm_eps), lps, xs)
    if kind == "attn" and _seq_split(ctx, states):
        outs, new_states = _attn_seq_tp(ctx, lps, cfg, hs, positions,
                                        states, cache_pos, ranks)
        outs = wo_sum(ctx, [lp["attn"]["wo"] for lp in lps], cfg, outs,
                      dtype)
    elif kind in ("attn", "local"):
        window = cfg.window_size if kind == "local" else 0
        outs, new_states = ctx.map(
            lambda r, lp, h, pos, st, cp, bt: _attn_apply(
                lp["attn"], cfg, h, pos, window=window, cache=st,
                cache_pos=cp, block_tables=bt, rank=r,
                chunk=ctx.attn_chunk),
            ranks, lps, hs, positions, states, cache_pos, block_tables)
        outs = wo_sum(ctx, [lp["attn"]["wo"] for lp in lps], cfg, outs,
                      dtype)
    elif kind == "rglru":
        outs, new_states = ctx.map(
            lambda lp, h, st: rglru_lib.rglru_apply(lp["rglru"], h, st),
            lps, hs, states)
    elif kind == "rwkv":
        t_states = [None if st is None else st["time"] for st in states]
        ks = none
        if lps[0]["time"]["w_k"].shape[1] < cfg.d_model:
            ks = ctx.gather(ctx.map(
                lambda lp, h, st: rwkv_lib.time_mix_k(lp["time"], h, st),
                lps, hs, t_states))
        outs, new_time = ctx.map(
            lambda lp, h, st, k: rwkv_lib.rwkv_time_mix(
                lp["time"], h, cfg.rnn_head_dim, st, chunk=rnn_chunk, k=k),
            lps, hs, t_states, ks)
    else:
        raise _unported(kind)
    xs = ctx.map(torch.add, xs, outs)
    h2s = ctx.map(lambda lp, x: rmsnorm(lp["ln2"], x, cfg.norm_eps), lps, xs)
    if kind != "rwkv" and cfg.is_moe:
        outs, auxs = ffn_lib.moe_apply(
            [lp["ffn"] for lp in lps], h2s, top_k=cfg.experts_per_token,
            activation=cfg.activation, ctx=ctx)
        return ctx.map(torch.add, xs, outs), new_states, auxs
    if kind != "rwkv":
        outs = ffn_tp(ctx, [lp["ffn"] for lp in lps], cfg, h2s, dtype)
        return ctx.map(torch.add, xs, outs), new_states, [0.0] * n
    c_states = [None if st is None else st["channel"] for st in states]
    ks = none
    if lps[0]["channel"]["w_k"].shape[1] < cfg.d_ff:
        ks = ctx.gather(ctx.map(
            lambda lp, h, st: rwkv_lib.channel_mix_k(lp["channel"], h, st),
            lps, h2s, c_states))
    outs, new_channel = ctx.map(
        lambda lp, h, st, k: rwkv_lib.rwkv_channel_mix(lp["channel"], h, st,
                                                       k=k),
        lps, h2s, c_states, ks)
    new_states = [None if st is None else {"time": t, "channel": c}
                  for st, t, c in zip(states, new_time, new_channel)]
    return ctx.map(torch.add, xs, outs), new_states, [0.0] * n


def _seq_split(ctx, states) -> bool:
    """Whether the positions' dense caches are blocks of ``ctx.kv_len``
    along the length (``serve_state_sharding``'s or ``state_sharding``'s
    length split)."""
    st = states[0]
    return (ctx.kv_len is not None and st is not None and "k" in st
            and st["k"].shape[1] < ctx.kv_len)


def _attn_seq_tp(ctx, lps: List[dict], cfg: ModelConfig, hs, positions,
                 states, cache_pos, ranks):
    """Sequence-parallel decode attention over a cache split along its
    length: position ``r`` holds rows ``[r*S/tp, (r+1)*S/tp)`` of every kv
    head (S = ``ctx.kv_len``).  The new tokens' K and V of every kv head
    reach every position (gathered over the model axis where each projects
    only its own heads), and so does every query head's q.  Each slot's
    new rows are written by the position whose block holds them, a masked
    write per slot (``attention.update_kv_block``, no host sync).  Each
    position computes its block's fp32 partials for all heads (running
    max, sum of exponentials, unnormalised P·V, both products on the
    matmul kernel).  A log-sum-exp over the model axis joins them: the
    maximum of the running maxes (``ctx.model_max``), each block's
    partials rescaled to it, summed by ``psum`` in rank order in fp32,
    normalised and rounded once (``attention.rescale_partials``,
    ``finish_partials``).  Each position keeps its own heads'
    columns for the row-parallel ``wo`` (``out_projection``).  Dense
    ``attn`` caches only: ring buffers, page pools and the
    encoder-decoder's caches keep their whole-length forms.  Returns
    (fp32 ``wo`` partials or whole outputs, new states), lists."""
    mesh, axis = ctx.mesh, ctx.model_axis
    dtype = hs[0].dtype
    b, s, _ = hs[0].shape
    qs, ks, vs = ctx.map(lambda lp, h, pos: _qkv(lp["attn"], cfg, h, pos),
                         lps, hs, positions)
    if qs[0].shape[2] < cfg.n_heads:
        qs = ctx.gather(qs, dim=2)
    if ks[0].shape[2] < cfg.n_kv_heads:
        ks, vs = ctx.gather(ks, dim=2), ctx.gather(vs, dim=2)
    rows = states[0]["k"].shape[1]

    def local(r, q, k, v, st, cp):
        kc, vc = attn_lib.update_kv_block(st["k"], st["v"], k, v, cp,
                                          r * rows, ctx.kv_len)
        part = attn_lib.decode_attention_partial(q, kc, vc, cp + s, r * rows)
        return part, {"k": kc, "v": vc}

    parts, new_states = ctx.map(local, ranks, qs, ks, vs, states, cache_pos)
    maxes = ctx.model_max([p[..., -2:-1] for p in parts])
    totals = psum(mesh, axis, ctx.map(attn_lib.rescale_partials, parts,
                                      maxes))
    outs = ctx.map(lambda t: attn_lib.finish_partials(t, s, cfg.n_heads,
                                                      dtype), totals)
    outs = ctx.map(lambda r, lp, o: out_projection(
        o.reshape(b, s, -1), lp["attn"]["wo"], cfg, cfg.n_heads, r),
        ranks, lps, outs)
    return outs, new_states


def stack_apply_tp(ctx, layers: List[List[dict]], cfg: ModelConfig, xs,
                   positions, *, states=None, cache_pos=None,
                   block_tables=None, rnn_chunk: Optional[int] = None):
    """``stack_apply`` on a serve mesh (``layer_apply_tp`` layer by layer):
    ``layers``, ``states`` and the rest lists with one entry a position.
    Returns (xs, new states or None), lists."""
    n = ctx.mesh.size
    none = [None] * n
    decode = states is not None
    new_states = [[] for _ in range(n)] if decode else None
    for j in range(cfg.n_layers):
        xs, new_st = layer_apply_tp(
            ctx, [layers[i][j] for i in range(n)], cfg, cfg.block_kind(j),
            xs, positions,
            states=[states[i][j] for i in range(n)] if decode else none,
            cache_pos=cache_pos or none, block_tables=block_tables or none,
            rnn_chunk=rnn_chunk)
        if decode:
            for i in range(n):
                new_states[i].append(new_st[i])
    return xs, new_states


# ---------------------------------------------------------------------------
# Training on a (pod?, data, model) mesh
# ---------------------------------------------------------------------------


def layer_train_tp(ctx, lps: List[dict], specs: dict, cfg: ModelConfig,
                   kind: str, xs, positions, rnn_chunk: Optional[int] = None):
    """One layer on a training mesh, without a cache: the layer's
    FSDP-split weights gathered over the data axes (``ctx.gather_tree`` by
    the layer's ``specs``), then ``layer_apply_tp``'s tensor-parallel body.
    Returns (xs, auxiliary losses), lists."""
    n = ctx.mesh.size
    none = [None] * n
    full = ctx.gather_tree(lps, specs)
    xs, _, auxs = _layer_tp(ctx, full, cfg, kind, xs, positions,
                            states=none, cache_pos=none, block_tables=none,
                            rnn_chunk=rnn_chunk)
    return xs, auxs


def stack_train_tp(ctx, layers: List[List[dict]], specs: List[dict],
                   cfg: ModelConfig, xs, positions, *, remat: bool = True,
                   rnn_chunk: Optional[int] = None):
    """``stack_apply`` on a training mesh (``layer_train_tp`` layer by
    layer): ``layers`` one list of layers a position, ``specs`` the layers'
    param specs.  With ``remat`` under autograd each layer keeps only its
    inputs for the backward pass and runs again there, its FSDP gathers
    included (``torch.utils.checkpoint``, non-reentrant).  Returns (xs,
    the sum of the layers' auxiliary losses), lists."""
    n = ctx.mesh.size
    aux_total = [0.0] * n
    for j in range(cfg.n_layers):
        lps = [layers[i][j] for i in range(n)]
        args = (ctx, lps, specs[j], cfg, cfg.block_kind(j), xs, positions,
                rnn_chunk)
        if remat and torch.is_grad_enabled():
            xs, auxs = checkpoint(layer_train_tp, *args, use_reentrant=False,
                                  context_fn=recompute_contexts)
        else:
            xs, auxs = layer_train_tp(*args)
        aux_total = [t + a for t, a in zip(aux_total, auxs)]
    return xs, aux_total
