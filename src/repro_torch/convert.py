"""Bridge the reference package's parameters into the port's.

``params_from_jax`` takes the pytree the reference's ``model.init`` returns,
with its leaves already turned into numpy arrays (the caller does that; this
package never imports jax), and returns the port's parameter dict on
``device``.  It reads both of the reference's layer layouts:

  * unrolled, ``layers/layer_{i}/...`` — stacks of fewer than 4 layers;
  * scan-stacked, every layer leaf with a leading (n_layers,) axis — any
    uniform stack of 4 or more layers, full-size tinyllama included.

Layouts change where the port keeps a projection as one (in, out) matrix:
``wq`` (d, Hq, hd) becomes (d, Hq*hd), ``wk``/``wv`` likewise, and ``wo``
(Hq, hd, d) or (Hq*hd, d) becomes (Hq*hd, d).  Values are unchanged.
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


def _layer(lp: Dict[str, Any], cfg: ModelConfig, device,
           wdtype: torch.dtype) -> Dict[str, Any]:
    if "attn" not in lp or "ffn" not in lp or "router" in lp["ffn"]:
        raise NotImplementedError(
            f"{cfg.name}: only dense attention + dense FFN layers are ported")
    d = cfg.d_model
    attn = lp["attn"]
    return {
        "ln1": {"scale": _tensor(lp["ln1"]["scale"], device, torch.float32)},
        "ln2": {"scale": _tensor(lp["ln2"]["scale"], device, torch.float32)},
        "attn": {
            "wq": _tensor(np.reshape(attn["wq"], (d, -1)), device, wdtype),
            "wk": _tensor(np.reshape(attn["wk"], (d, -1)), device, wdtype),
            "wv": _tensor(np.reshape(attn["wv"], (d, -1)), device, wdtype),
            "wo": _tensor(np.reshape(attn["wo"], (-1, d)), device, wdtype),
        },
        "ffn": {k: _tensor(v, device, wdtype) for k, v in lp["ffn"].items()},
    }


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The port's parameters from the reference's ``model.init`` pytree
    (numpy leaves).  ``dtype`` overrides the weights' dtype (default: the
    config's); norm scales stay fp32, as the reference keeps them."""
    wdtype = dtype or dtype_of(cfg.dtype)
    layers_tree = tree["layers"]
    if "groups" in layers_tree:
        raise NotImplementedError(
            f"{cfg.name}: period-scan (hybrid) layouts are not ported yet")
    if "layer_0" in layers_tree:
        per_layer = [layers_tree[f"layer_{i}"] for i in range(cfg.n_layers)]
    else:
        per_layer = [_layer_slice(layers_tree, i) for i in range(cfg.n_layers)]
    params = {
        "embed": _tensor(tree["embed"], device, wdtype),
        "layers": [_layer(lp, cfg, device, wdtype) for lp in per_layer],
        "final_norm": {"scale": _tensor(tree["final_norm"]["scale"], device,
                                        torch.float32)},
    }
    if "unembed" in tree:
        params["unembed"] = _tensor(tree["unembed"], device, wdtype)
    return params
