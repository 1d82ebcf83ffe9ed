"""Decoder-only transformer assembly: the layers are a plain Python list,
applied in a loop (the reference scans stacked parameters; the port's
``convert.params_from_jax`` unstacks them).  This slice ports the
full-attention layer kind; the other kinds raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.common import (
    apply_rope,
    dense_init,
    dtype_of,
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


def layer_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype) -> Dict[str, Any]:
    if kind != "attn" or cfg.is_moe:
        raise _unported("moe" if cfg.is_moe else kind)
    return {
        "ln1": rmsnorm_init(cfg.d_model, gen.device),
        "ln2": rmsnorm_init(cfg.d_model, gen.device),
        "attn": _attn_init(gen, cfg, dtype),
        "ffn": ffn_lib.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                dtype),
    }


# ---------------------------------------------------------------------------
# Per-layer apply
# ---------------------------------------------------------------------------


def _attn_apply(params, cfg: ModelConfig, x, positions, *, cache=None,
                cache_pos=None):
    """Returns (out, new_cache)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = project(x, params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = project(x, params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = project(x, params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        kc, vc = attn_lib.update_kv_cache(cache["k"], cache["v"], k, v,
                                          cache_pos)
        out = attn_lib.decode_attention(q, kc, vc, cache_pos + s)
        new_cache = {"k": kc, "v": vc}
    else:
        out = attn_lib.attention(q, k, v)
        new_cache = None
    return project(out.reshape(b, s, -1), params["wo"]), new_cache


def layer_apply(params, cfg: ModelConfig, kind: str, x, positions, *,
                state=None, cache_pos=None) -> Tuple[torch.Tensor, Any, float]:
    """Pre-norm residual block.  Returns (x, new_state, aux_loss); dense
    layers have no auxiliary loss, so it is the float 0.0 (no launch)."""
    if kind != "attn":
        raise _unported(kind)
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    out, new_state = _attn_apply(params["attn"], cfg, h, positions,
                                 cache=state, cache_pos=cache_pos)
    x = x + out
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    x = x + ffn_lib.ffn_apply(params["ffn"], h2, cfg.activation)
    return x, new_state, 0.0


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------


def layer_init_state(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device) -> Dict[str, torch.Tensor]:
    if kind != "attn":
        raise _unported(kind)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
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
                     device) -> List[dict]:
    dtype = dtype_of(cfg.dtype)
    return [layer_init_state(cfg, cfg.block_kind(i), batch, max_len, dtype,
                             device)
            for i in range(cfg.n_layers)]


def stack_apply(layers: List[dict], cfg: ModelConfig, x, positions, *,
                states: Optional[List[dict]] = None, cache_pos=None):
    """Run all layers.  Returns (x, new_states, aux_total)."""
    aux_total = 0.0
    new_states = [] if states is not None else None
    for i, lp in enumerate(layers):
        st = states[i] if states is not None else None
        x, new_st, aux = layer_apply(lp, cfg, cfg.block_kind(i), x, positions,
                                     state=st, cache_pos=cache_pos)
        if states is not None:
            new_states.append(new_st)
        aux_total = aux_total + aux
    return x, new_states, aux_total
