"""Bridge the reference package's parameters into the port's.

``params_from_jax`` takes the pytree the reference's ``model.init`` returns,
with its leaves already turned into numpy arrays (the caller does that; this
package never imports jax), and returns the port's parameter dict on
``device``.  It reads both of the reference's layer layouts:

  * unrolled, ``layers/layer_{i}/...`` — stacks of fewer than 4 layers;
  * scan-stacked, every layer leaf with a leading (n_layers,) axis — any
    uniform stack of 4 or more layers, full-size tinyllama included;
  * period-scan, a hybrid pattern of P kinds with at least two periods
    (recurrentgemma's ``(rglru, rglru, local)``): ``groups/{p}`` stacked
    over the n_groups periods holds layer ``g * P + p`` at index g, and
    ``rest_{j}`` is layer ``n_groups * P + j``.

Layouts change where the port keeps a projection as one (in, out) matrix:
``wq`` (d, Hq, hd) becomes (d, Hq*hd), ``wk``/``wv`` likewise, and ``wo``
(Hq, hd, d) or (Hq*hd, d) becomes (Hq*hd, d).  A mixture of experts'
``ffn`` lays its experts side by side (``models/ffn.py``): ``w_in`` and
``w_gate`` (E, d, F) become (d, E*F), expert e in columns [e*F, (e+1)*F),
``w_out`` (E, F, d) becomes (E*F, d), and the ``router`` (d, E) stays
fp32.  An rwkv layer's ``time`` and ``channel`` leaves and an RG-LRU
layer's ``rglru`` leaves keep their shapes.  A tree with tied embeddings
has no ``unembed``, and neither has the result.  An encoder-decoder tree
(``enc_{i}``, ``dec_{i}``, ``enc_final_norm``) becomes the port's
``encoder`` and ``decoder`` lists, each decoder layer with its
``ln_cross`` and ``cross`` projections; ``encdec_state_from_jax`` carries
its decode state across.  Values are unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dtype_of


def _tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    # float32 first: exact for bf16/fp16 leaves, which numpy cannot hand
    # to torch directly
    host = np.array(a, dtype=np.float32)  # a writable copy
    return torch.from_numpy(host).to(device=device, dtype=dtype)


def _layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i`` of a scan-stacked layer tree."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


# rwkv leaves in the port's init order; the decay LoRA, the bonus and the
# group-norm scale stay fp32, as the reference keeps them
_TIME_KEYS = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w_r", "w_k", "w_v",
              "w_g", "w_o", "decay_w0", "decay_w1", "decay_w2", "bonus_u",
              "ln_x_scale")
_CHANNEL_KEYS = ("mu_k", "mu_r", "w_k", "w_v", "w_r")
# RG-LRU leaves in the port's init order; the gates and the decay stay fp32
_RGLRU_KEYS = ("w_x", "w_gate", "conv_w", "w_rec_gate", "b_rec_gate",
               "w_in_gate", "b_in_gate", "lam", "w_out")
_FP32_KEYS = ("decay_w0", "decay_w1", "decay_w2", "bonus_u", "ln_x_scale",
              "w_rec_gate", "b_rec_gate", "w_in_gate", "b_in_gate", "lam")


def _named_tensors(tree: Dict[str, Any], keys, device,
            wdtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {k: _tensor(tree[k], device,
                       torch.float32 if k in _FP32_KEYS else wdtype)
            for k in keys}


def _ffn(tree: Dict[str, Any], device,
         wdtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A dense FFN's leaves as they are; a mixture of experts' in the
    port's side-by-side layout, the router fp32."""
    if "router" not in tree:
        return {k: _tensor(v, device, wdtype) for k, v in tree.items()}
    out = {"router": _tensor(tree["router"], device, torch.float32)}
    for k in ("w_in", "w_gate"):
        if k in tree:
            e, d, f = np.shape(tree[k])
            out[k] = _tensor(np.reshape(np.transpose(tree[k], (1, 0, 2)),
                                        (d, e * f)), device, wdtype)
    e, f, d = np.shape(tree["w_out"])
    out["w_out"] = _tensor(np.reshape(tree["w_out"], (e * f, d)), device,
                           wdtype)
    return out


def _layer(lp: Dict[str, Any], cfg: ModelConfig, device,
           wdtype: torch.dtype) -> Dict[str, Any]:
    norms = {
        "ln1": {"scale": _tensor(lp["ln1"]["scale"], device, torch.float32)},
        "ln2": {"scale": _tensor(lp["ln2"]["scale"], device, torch.float32)},
    }
    if "time" in lp and "channel" in lp:
        return {**norms,
                "time": _named_tensors(lp["time"], _TIME_KEYS, device,
                                       wdtype),
                "channel": _named_tensors(lp["channel"], _CHANNEL_KEYS,
                                          device, wdtype)}
    if "ffn" not in lp or not ("attn" in lp or "rglru" in lp):
        raise NotImplementedError(
            f"{cfg.name}: only attention or RG-LRU layers with an FFN and "
            f"rwkv layers are ported")
    ffn = _ffn(lp["ffn"], device, wdtype)
    if "rglru" in lp:
        return {**norms,
                "rglru": _named_tensors(lp["rglru"], _RGLRU_KEYS, device,
                                        wdtype),
                "ffn": ffn}
    out = {**norms, "attn": _attn(lp["attn"], cfg.d_model, device, wdtype),
           "ffn": ffn}
    if "cross" in lp:  # an encoder-decoder's decoder layer
        out["ln_cross"] = {"scale": _tensor(lp["ln_cross"]["scale"], device,
                                            torch.float32)}
        out["cross"] = _attn(lp["cross"], cfg.d_model, device, wdtype)
    return out


def _attn(attn: Dict[str, Any], d: int, device,
          wdtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Attention projections as (in, out) matrices."""
    return {
        "wq": _tensor(np.reshape(attn["wq"], (d, -1)), device, wdtype),
        "wk": _tensor(np.reshape(attn["wk"], (d, -1)), device, wdtype),
        "wv": _tensor(np.reshape(attn["wv"], (d, -1)), device, wdtype),
        "wo": _tensor(np.reshape(attn["wo"], (-1, d)), device, wdtype),
    }


def _per_layer(layers_tree: Dict[str, Any], cfg: ModelConfig) -> list:
    """The reference's layer tree as one tree per layer, in layer order,
    whichever of its three layouts it has."""
    if "groups" in layers_tree:
        period = len(cfg.block_pattern)
        n_groups, rest = divmod(cfg.n_layers, period)
        groups = layers_tree["groups"]
        return [_layer_slice(groups[str(i % period)], i // period)
                for i in range(n_groups * period)] + \
            [layers_tree[f"rest_{j}"] for j in range(rest)]
    if "layer_0" in layers_tree:
        return [layers_tree[f"layer_{i}"] for i in range(cfg.n_layers)]
    return [_layer_slice(layers_tree, i) for i in range(cfg.n_layers)]


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The port's parameters from the reference's ``model.init`` pytree
    (numpy leaves).  ``dtype`` overrides the weights' dtype (default: the
    config's); norm scales stay fp32, as the reference keeps them."""
    wdtype = dtype or dtype_of(cfg.dtype)
    if cfg.is_encdec:
        return _encdec_params(tree, cfg, device, wdtype)
    per_layer = _per_layer(tree["layers"], cfg)
    params = {
        "embed": _tensor(tree["embed"], device, wdtype),
        "layers": [_layer(lp, cfg, device, wdtype) for lp in per_layer],
        "final_norm": {"scale": _tensor(tree["final_norm"]["scale"], device,
                                        torch.float32)},
    }
    if "unembed" in tree:
        params["unembed"] = _tensor(tree["unembed"], device, wdtype)
    return params


def _norm(tree: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {"scale": _tensor(tree["scale"], device, torch.float32)}


def _encdec_params(tree: Dict[str, Any], cfg: ModelConfig, device,
                   wdtype: torch.dtype) -> Dict[str, Any]:
    """An encoder-decoder tree: ``enc_{i}`` and ``dec_{i}`` (with
    ``ln_cross`` and ``cross``) become the lists ``encoder`` and
    ``decoder``; ``embed``, the untied ``unembed`` and both final norms
    carry over."""
    return {
        "embed": _tensor(tree["embed"], device, wdtype),
        "unembed": _tensor(tree["unembed"], device, wdtype),
        "enc_final_norm": _norm(tree["enc_final_norm"], device),
        "final_norm": _norm(tree["final_norm"], device),
        "encoder": [_layer(tree[f"enc_{i}"], cfg, device, wdtype)
                    for i in range(cfg.encoder_layers)],
        "decoder": [_layer(tree[f"dec_{i}"], cfg, device, wdtype)
                    for i in range(cfg.n_layers)],
    }


def encdec_state_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                          device="cuda",
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, Any]:
    """The port's encoder-decoder decode state from the reference's
    (numpy leaves): ``dec_{i}`` {"k", "v"} and ``cross_{i}`` {"k", "v"}
    become ``layers[i]`` {"k", "v", "cross": {"k", "v"}}, and ``pos``
    (int32, 0-d or per slot) an int64 tensor."""
    wdtype = dtype or dtype_of(cfg.dtype)

    def kv(t):
        return {"k": _tensor(t["k"], device, wdtype),
                "v": _tensor(t["v"], device, wdtype)}

    return {
        "layers": [{**kv(tree[f"dec_{i}"]), "cross": kv(tree[f"cross_{i}"])}
                   for i in range(cfg.n_layers)],
        "pos": torch.from_numpy(np.array(tree["pos"], dtype=np.int64)).to(
            device),
    }
