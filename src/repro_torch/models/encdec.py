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
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.common import positional, project, rmsnorm, rmsnorm_init
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
    """q (B, S, Hq, hd), k and v (B, S, Hkv, hd); q and k rotated by
    ``positions`` where given."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = project(x, params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = project(x, params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = project(x, params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if positions is not None:
        q = positional(q, positions, cfg.pos_type, cfg.rope_theta)
        k = positional(k, positions, cfg.pos_type, cfg.rope_theta)
    return q, k, v


def encoder_layer_apply(params, cfg: ModelConfig, x, positions,
                        chunk: int = 1024):
    """ln1 -> bidirectional self-attention -> wo, residual; ln2 -> FFN,
    residual."""
    b, s, _ = x.shape
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    q, k, v = _proj_qkv(params["attn"], cfg, h, positions)
    out = attn_lib.attention(q, k, v, causal=False, chunk=chunk)
    x = x + project(out.reshape(b, s, -1), params["attn"]["wo"])
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
    b, s, _ = x.shape
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    q, k, v = _proj_qkv(params["attn"], cfg, h, positions)
    if self_cache is not None:
        kc, vc = attn_lib.update_kv_cache(self_cache["k"], self_cache["v"],
                                          k, v, cache_pos)
        out = attn_lib.decode_attention(q, kc, vc, cache_pos + s)
        new_cache = {"k": kc, "v": vc}
    else:
        out = attn_lib.attention(q, k, v, causal=True, chunk=chunk)
        new_cache = None
    x = x + project(out.reshape(b, s, -1), params["attn"]["wo"])
    hc = rmsnorm(params["ln_cross"], x, cfg.norm_eps)
    qc = project(hc, params["cross"]["wq"]).reshape(
        b, s, cfg.n_heads, cfg.resolved_head_dim)
    ek, ev = enc_kv
    outc = attn_lib.cross_attention(qc, ek, ev, cached=self_cache is not None)
    x = x + project(outc.reshape(b, s, -1), params["cross"]["wo"])
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + ffn_lib.ffn_apply(params["ffn"], h2, cfg.activation), new_cache


def cross_kv(params, cfg: ModelConfig, enc_out: torch.Tensor):
    """The encoder output (B, S_enc, d) projected to this decoder layer's
    cross-attention keys and values, (B, S_enc, Hkv, hd) each."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = project(enc_out, params["cross"]["wk"]).reshape(b, s, cfg.n_kv_heads,
                                                        hd)
    v = project(enc_out, params["cross"]["wv"]).reshape(b, s, cfg.n_kv_heads,
                                                        hd)
    return k, v
