"""AdamW with decoupled weight decay and global-norm clipping.

Plain tree implementation: the moments live in fp32 beside parameters of
any dtype, and the update is computed in fp32 and cast once to the
parameter's dtype (bf16 at full width), as the reference does.  Every step
quantity (count, bias corrections, the clip scale) stays a device tensor:
nothing here calls ``.item()``.

The update runs leaf by leaf, clipping included, so besides the state it
holds one leaf's new values at a time.  It is functional by default;
``inplace=True`` copies each leaf's new values into the tensors passed in
(the port's stand-in for donating their buffers to the step), the same
values bit for bit, without a second copy of parameters and moments, and
runs a large leaf a block of rows at a time (``INPLACE_BLOCK``): the
arithmetic is elementwise, so the values are the same, and the fp32
temporaries are a block's, not a (152064, 8192) embedding's 5 GB each.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.tree import leaves, tree_map, tree_unzip


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _device(params) -> torch.device:
    first = leaves(params)
    return first[0].device if first else torch.device("cpu")


# elements of a leaf updated at once in place (64 MiB of fp32)
INPLACE_BLOCK = 1 << 24


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_device(params))}


def _global_norm_scale(grads, max_norm: float):
    """(the global fp32 norm of ``grads``, ``min(1, max_norm / norm)``)."""
    sq = [torch.sum(g.float() * g.float()) for g in leaves(grads)]
    gn = torch.sqrt(sum(sq[1:], sq[0]))
    return gn, clip_scale(gn, max_norm)


def _clipped(g, scale):
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / ||grads||)``, the norm
    over all leaves in fp32.  Returns (clipped grads, the norm)."""
    gn, scale = _global_norm_scale(grads, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), gn


def _decay_mask(path: str) -> bool:
    """No weight decay on norms, biases, scalars, gates."""
    return not any(t in path for t in ("ln", "norm", "scale", "bias", "mu_",
                                       "lam", "decay_w0", "bonus_u", "b_rec",
                                       "b_in"))


def leaf_update(cfg: AdamWConfig, count: torch.Tensor, lr, scale,
                inplace: bool):
    """``upd(path, p, g, mu, nu) -> (new p, new mu, new nu)``: one leaf's
    AdamW step at ``count`` (the step's new count), rate ``lr`` and clip
    ``scale``; in place into ``p``, ``mu`` and ``nu`` (by row blocks) when
    ``inplace``."""
    lr_t = cfg.lr if lr is None else lr
    cf = count.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** cf
    b2c = 1.0 - cfg.b2 ** cf

    def new_values(path, p, g, mu, nu):
        g32 = _clipped(g, scale).float()
        new_mu = cfg.b1 * mu + (1 - cfg.b1) * g32
        new_nu = cfg.b2 * nu + (1 - cfg.b2) * (g32 * g32)
        step = (new_mu / b1c) / (torch.sqrt(new_nu / b2c) + cfg.eps)
        if cfg.weight_decay and _decay_mask(path):
            step = step + cfg.weight_decay * p.float()
        return (p.float() - lr_t * step).to(p.dtype), new_mu, new_nu

    def upd(path, p, g, mu, nu):
        if not inplace:
            return new_values(path, p, g, mu, nu)
        rows = max(1, INPLACE_BLOCK * p.shape[0] // max(p.numel(), 1)) \
            if p.dim() else 1
        for r in range(0, p.shape[0] if p.dim() else 1, rows):
            part = (slice(r, r + rows),) if p.dim() else ()
            block = [t[part] for t in (p, g, mu, nu)]
            for dst, new in zip((block[0], block[2], block[3]),
                                new_values(path, *block)):
                dst.copy_(new)
        return p, mu, nu

    return upd


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / norm)`` of a global gradient norm."""
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None, inplace: bool = False):
    """Returns (new_params, new_state, {"grad_norm"}), the gradients clipped
    by their global norm first.  The inputs are left as they were, unless
    ``inplace``: then the new values are copied into ``params`` and the
    moments of ``state``, whose tensors the results are."""
    gn, scale = _global_norm_scale(grads, cfg.grad_clip)
    count = state["count"] + 1
    upd = leaf_update(cfg, count, lr, scale, inplace)
    new_params, mu, nu = tree_unzip(upd, 3, params, grads, state["mu"],
                                    state["nu"])
    return new_params, {"mu": mu, "nu": nu, "count": count}, \
        {"grad_norm": gn}
