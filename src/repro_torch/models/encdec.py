"""Encoder-decoder backbone (seamless-m4t-medium).

Encoder: bidirectional self-attention blocks over precomputed
modality-frontend frame embeddings (the frontend is a stub: training
batches carry (B, S_enc, d) embeddings, ``data/pipeline.py``).

Decoder: causal self-attention, then cross-attention to the encoder output,
then the FFN.  Decode mode caches the decoder's self-attention KV and the
projected encoder KV.

Every projection runs on the matmul kernel (``project``); the FFN is the
dense one (GELU fused into the kernel's epilogue, the tanh form).  RoPE
rotates self-attention queries and keys; cross-attention keys carry no
position (the encoder output is already encoded).  Without a cache the
encoder's self-attention is ``attention(causal=False)`` and the cross
attention ``cross_attention``: the flash kernels on a CUDA tensor, forward
and backward, the reference's XLA forms on the CPU.  With a cache (decode)
the cross attention runs ``dense_attention``'s two matmul-kernel
contractions over every cached encoder row, with no mask.

On a mesh (a ``ShardingCtx``) every argument is a list with one entry a
position: ``encoder_layer_tp``/``decoder_layer_tp`` run a layer
tensor-parallel over the model axis (a position's query heads and the kv
heads they read, for self- and cross-attention; the row-parallel ``wo``
and FFN ``w_out`` as fp32 partials summed over the axis and rounded
once), the residual stream replicated over it.  The ``_train_`` forms
gather a layer's FSDP-split weights over the data axes first, inside the
recomputed body; ``cross_kv_tp`` projects the whole encoder output onto a
position's kv heads outside it, as the single-device model does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.common import (positional_pair, project, rmsnorm,
                                      rmsnorm_init)
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import _attn_init, _ffn_init


def encdec_layer_init(gen: torch.Generator, cfg: ModelConfig, cross: bool,
                      dtype) -> dict:
    """An encoder layer (``cross=False``) or a decoder layer, which adds
    ``ln_cross`` and the cross-attention projections ``cross``."""
    p = {
        "ln1": rmsnorm_init(cfg.d_model, gen.device),
        "ln2": rmsnorm_init(cfg.d_model, gen.device),
        "attn": _attn_init(gen, cfg, dtype),
        "ffn": _ffn_init(gen, cfg, dtype),
    }
    if cross:
        p["ln_cross"] = rmsnorm_init(cfg.d_model, gen.device)
        p["cross"] = _attn_init(gen, cfg, dtype)
    return p


def _proj_qkv(params, cfg: ModelConfig, x, positions=None):
    """q (B, S, Hq, hd), k and v (B, S, Hkv, hd), the head counts those of
    the weights (a position's on a mesh); q and k rotated by
    ``positions`` where given."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = project(x, params["wq"]).reshape(b, s, -1, hd)
    k = project(x, params["wk"]).reshape(b, s, -1, hd)
    v = project(x, params["wv"]).reshape(b, s, -1, hd)
    if positions is not None:
        q, k = positional_pair(q, k, positions, cfg.pos_type, cfg.rope_theta)
    return q, k, v


def _kv_heads(cfg: ModelConfig, nq: int, k, v, rank: int):
    """The kv heads of k and v (B, S, H, hd) that ``nq`` query heads of
    the position at ``rank`` read (``transformer._kv_heads_used``)."""
    used = tfm._kv_heads_used(cfg, nq, k.shape[2], rank)
    if used is None:
        return k, v
    return (k[:, :, used[0]:used[1]].contiguous(),
            v[:, :, used[0]:used[1]].contiguous())


def self_attention(params, cfg: ModelConfig, x, positions, *, causal: bool,
                   cache=None, cache_pos=None, rank: int = 0,
                   chunk: int = 1024):
    """Self-attention through ``wo``: (out, the new cache {"k", "v"} or
    None without one).  With a ``cache`` (decode) the new keys and values
    go in at ``cache_pos`` and the queries attend causally to the filled
    entries.  On a mesh ``params`` are a position's blocks and ``rank`` its
    index on the model axis: ``out`` is then an fp32 partial where ``wo``
    is split by rows (``transformer.out_projection``)."""
    b, s, _ = x.shape
    q, k, v = _proj_qkv(params, cfg, x, positions)
    nq = q.shape[2]
    if cache is not None:
        kc, vc = attn_lib.update_kv_cache(cache["k"], cache["v"], k, v,
                                          cache_pos)
        out = attn_lib.decode_attention(q, *_kv_heads(cfg, nq, kc, vc, rank),
                                        cache_pos + s)
        new_cache = {"k": kc, "v": vc}
    else:
        k, v = _kv_heads(cfg, nq, k, v, rank)
        out = attn_lib.attention(q, k, v, causal=causal, chunk=chunk)
        new_cache = None
    return tfm.out_projection(out.reshape(b, s, -1), params["wo"], cfg, nq,
                              rank), new_cache


def cross_attend(params, cfg: ModelConfig, x, enc_kv, *, cached: bool,
                 rank: int = 0):
    """The decoder's cross-attention through ``wo``: queries from ``x``,
    keys and values ``enc_kv`` (this layer's projected encoder output, or
    the cross cache when ``cached``), unmasked.  On a mesh as
    ``self_attention``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    qc = project(x, params["wq"]).reshape(b, s, -1, hd)
    nq = qc.shape[2]
    ek, ev = _kv_heads(cfg, nq, *enc_kv, rank)
    outc = attn_lib.cross_attention(qc, ek, ev, cached=cached)
    return tfm.out_projection(outc.reshape(b, s, -1), params["wo"], cfg, nq,
                              rank)


def encoder_layer_apply(params, cfg: ModelConfig, x, positions,
                        chunk: int = 1024):
    """ln1 -> bidirectional self-attention -> wo, residual; ln2 -> FFN,
    residual."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    x = x + self_attention(params["attn"], cfg, h, positions, causal=False,
                           chunk=chunk)[0]
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + ffn_lib.ffn_apply(params["ffn"], h2, cfg.activation)


def decoder_layer_apply(params, cfg: ModelConfig, x, positions,
                        enc_kv: Tuple[torch.Tensor, torch.Tensor], *,
                        self_cache=None, cache_pos=None, chunk: int = 1024):
    """ln1 -> causal self-attention (against ``self_cache`` {"k", "v"} at
    ``cache_pos`` where given) -> wo, residual; ln_cross -> attention to
    ``enc_kv`` (this layer's projected encoder keys and values) -> wo,
    residual; ln2 -> FFN, residual.  Returns (x, the new self-attention
    cache {"k", "v"}, or None without one)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    out, new_cache = self_attention(params["attn"], cfg, h, positions,
                                    causal=True, cache=self_cache,
                                    cache_pos=cache_pos, chunk=chunk)
    x = x + out
    hc = rmsnorm(params["ln_cross"], x, cfg.norm_eps)
    x = x + cross_attend(params["cross"], cfg, hc, enc_kv,
                         cached=self_cache is not None)
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + ffn_lib.ffn_apply(params["ffn"], h2, cfg.activation), new_cache


def cross_kv(params, cfg: ModelConfig, enc_out: torch.Tensor):
    """The encoder output (B, S_enc, d) projected to this decoder layer's
    cross-attention keys and values, (B, S_enc, Hkv, hd) each (a
    position's kv heads on a mesh)."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = project(enc_out, params["cross"]["wk"]).reshape(b, s, -1, hd)
    v = project(enc_out, params["cross"]["wv"]).reshape(b, s, -1, hd)
    return k, v


# ---------------------------------------------------------------------------
# Tensor parallelism over a mesh's model axis
# ---------------------------------------------------------------------------


def encoder_layer_tp(ctx, lps: List[dict], cfg: ModelConfig, xs,
                     positions) -> list:
    """``encoder_layer_apply`` on every position of ``ctx`` (lists with one
    entry a position; ``lps`` each position's blocks of the layer, the
    activations replicated over the model axis)."""
    ranks = [ctx.rank(i) for i in range(ctx.mesh.size)]
    dtype = xs[0].dtype
    hs = ctx.map(lambda lp, x: rmsnorm(lp["ln1"], x, cfg.norm_eps), lps, xs)
    outs = ctx.map(lambda r, lp, h, pos: self_attention(
        lp["attn"], cfg, h, pos, causal=False, rank=r,
        chunk=ctx.attn_chunk)[0], ranks, lps, hs, positions)
    xs = ctx.map(torch.add, xs, tfm.wo_sum(
        ctx, [lp["attn"]["wo"] for lp in lps], cfg, outs, dtype))
    h2s = ctx.map(lambda lp, x: rmsnorm(lp["ln2"], x, cfg.norm_eps), lps, xs)
    return ctx.map(torch.add, xs, tfm.ffn_tp(
        ctx, [lp["ffn"] for lp in lps], cfg, h2s, dtype))


def decoder_layer_tp(ctx, lps: List[dict], cfg: ModelConfig, xs, positions,
                     enc_kvs, *, states=None, cache_pos=None):
    """``decoder_layer_apply`` on every position of ``ctx``: ``enc_kvs``
    each position's (k, v) of the encoder output on its kv heads
    (``cross_kv_tp``, or the cross caches), ``states`` each position's
    self-attention cache and ``cache_pos`` its position (decode), or
    None.  Returns (xs, the new self-attention caches or Nones), lists."""
    n = ctx.mesh.size
    ranks = [ctx.rank(i) for i in range(n)]
    dtype = xs[0].dtype
    states = states or [None] * n
    cache_pos = cache_pos or [None] * n
    hs = ctx.map(lambda lp, x: rmsnorm(lp["ln1"], x, cfg.norm_eps), lps, xs)
    outs, caches = ctx.map(lambda r, lp, h, pos, st, cp: self_attention(
        lp["attn"], cfg, h, pos, causal=True, cache=st, cache_pos=cp,
        rank=r, chunk=ctx.attn_chunk), ranks, lps, hs, positions, states,
        cache_pos)
    xs = ctx.map(torch.add, xs, tfm.wo_sum(
        ctx, [lp["attn"]["wo"] for lp in lps], cfg, outs, dtype))
    hcs = ctx.map(lambda lp, x: rmsnorm(lp["ln_cross"], x, cfg.norm_eps),
                  lps, xs)
    outs = ctx.map(lambda r, lp, h, kv, st: cross_attend(
        lp["cross"], cfg, h, kv, cached=st is not None, rank=r),
        ranks, lps, hcs, enc_kvs, states)
    xs = ctx.map(torch.add, xs, tfm.wo_sum(
        ctx, [lp["cross"]["wo"] for lp in lps], cfg, outs, dtype))
    h2s = ctx.map(lambda lp, x: rmsnorm(lp["ln2"], x, cfg.norm_eps), lps, xs)
    return ctx.map(torch.add, xs, tfm.ffn_tp(
        ctx, [lp["ffn"] for lp in lps], cfg, h2s, dtype)), caches


def _body(tree: dict) -> dict:
    """A decoder layer's tree without the cross K/V projections, which
    ``cross_kv_tp`` uses outside the recomputed body."""
    out = dict(tree)
    out["cross"] = {k: v for k, v in tree["cross"].items()
                    if k not in ("wk", "wv")}
    return out


def encoder_layer_train_tp(ctx, lps: List[dict], specs: dict,
                           cfg: ModelConfig, xs, positions) -> list:
    """One encoder layer on a training mesh: its FSDP-split weights
    gathered over the data axes (``ctx.gather_tree`` by ``specs``), then
    ``encoder_layer_tp``."""
    return encoder_layer_tp(ctx, ctx.gather_tree(lps, specs), cfg, xs,
                            positions)


def decoder_layer_train_tp(ctx, lps: List[dict], specs: dict,
                           cfg: ModelConfig, xs, positions, enc_kvs) -> list:
    """One decoder layer on a training mesh, without a cache: the weights
    its body uses gathered over the data axes, then ``decoder_layer_tp``."""
    full = ctx.gather_tree([_body(lp) for lp in lps], _body(specs))
    return decoder_layer_tp(ctx, full, cfg, xs, positions, enc_kvs)[0]


def cross_kv_tp(ctx, lps: List[dict], specs: dict, cfg: ModelConfig,
                enc_outs) -> list:
    """``cross_kv`` on every position: the whole encoder output (each
    position's rows of the batch) projected onto the position's kv heads,
    ``cross/wk`` and ``cross/wv`` gathered over the data axes first."""
    kv = ctx.gather_tree(
        [{k: lp["cross"][k] for k in ("wk", "wv")} for lp in lps],
        {k: specs["cross"][k] for k in ("wk", "wv")})
    ks, vs = ctx.map(lambda w, e: cross_kv({"cross": w}, cfg, e), kv,
                     enc_outs)
    return list(zip(ks, vs))
