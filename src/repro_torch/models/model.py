"""``build_model(cfg, device) -> Model``: the decoder-only model behind the
serving path, with the reference package's functional interface.

Batch conventions: ``{"tokens": (B, S) int64}``.  Parameters are a dict
``{"embed", "layers": [per-layer dict, ...], "final_norm", "unembed"}``;
the decode state is ``{"layers": [{"k", "v"}, ...], "pos"}`` with every
per-slot leaf's slot axis first.  This slice ports the dense decoder-only
family (full attention, RoPE, dense GLU FFN); the others raise
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    dtype_of,
    embed_init,
    embed_lookup,
    rmsnorm,
    rmsnorm_init,
    unembed,
)


def _offset_positions(b: int, s: int, offset: torch.Tensor) -> torch.Tensor:
    """(B, S) absolute positions from a 0-d or per-slot (B,) offset."""
    off = offset.reshape(-1, 1)
    return (off + torch.arange(s, device=offset.device)[None]).expand(b, s)


class Model:
    """A decoder-only model on ``device``: the reference's ``Model`` record
    as methods.  Decode-state surgery on single slots
    (``reset_decode_slots``, ``insert_decode_slot``) writes in place, which
    is the port's stand-in for the reference's buffer donation."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        unported = []
        if cfg.is_encdec:
            unported.append("encoder-decoder")
        if cfg.is_moe:
            unported.append("mixture of experts")
        if any(k != "attn" for k in cfg.block_pattern):
            unported.append(f"block pattern {cfg.block_pattern}")
        if cfg.pos_type != "rope":
            unported.append(f"pos_type {cfg.pos_type!r}")
        if cfg.frontend != "none":
            unported.append(f"frontend {cfg.frontend!r}")
        if cfg.tie_embeddings:
            unported.append("tied embeddings")
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unported)} not ported yet "
                f"(other model families)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype_of(cfg.dtype)

    # ------------------------------------------------------------------

    def init(self, seed: int = 0) -> dict:
        """Fresh parameters with the reference's distributions, drawn from a
        ``torch.Generator`` seeded with ``seed`` on the model's device."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, self.dtype),
            "layers": tfm.stack_init(gen, cfg),
            "final_norm": rmsnorm_init(cfg.d_model, self.device),
            "unembed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                  self.dtype),
        }

    def _embed(self, params, batch, decode_offset=None):
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_lookup(params["embed"], tokens)
        if decode_offset is None:
            decode_offset = torch.zeros((), dtype=torch.int64,
                                        device=tokens.device)
        return x, _offset_positions(b, s, decode_offset)

    def forward_logits(self, params, batch):
        """(B, S, V) fp32 logits of a full causal forward, and the
        auxiliary loss."""
        x, positions = self._embed(params, batch)
        x, _, aux = tfm.stack_apply(params["layers"], self.cfg, x, positions)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return unembed(params["unembed"], x), torch.tensor(float(aux))

    def prefill(self, params, batch):
        """Inference prefill: full forward, logits only at the last position."""
        x, positions = self._embed(params, batch)
        x, _, _ = tfm.stack_apply(params["layers"], self.cfg, x, positions)
        x = rmsnorm(params["final_norm"], x[:, -1:], self.cfg.norm_eps)
        return unembed(params["unembed"], x)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def init_decode_state(self, batch_size: int, max_len: int,
                          per_slot: bool = False) -> dict:
        """``per_slot=True`` gives every batch row its own cache position
        (continuous batching); the default 0-d position is lockstep decode."""
        pos_shape = (batch_size,) if per_slot else ()
        return {
            "layers": tfm.stack_init_state(self.cfg, batch_size, max_len,
                                           self.device),
            "pos": torch.zeros(pos_shape, dtype=torch.int64,
                               device=self.device),
        }

    def decode_step(self, params, state, batch):
        """Feed ``batch["tokens"]`` (B, S_new) at each row's cache position.
        Returns ((B, S_new, V) fp32 logits, new state); ``state`` is left
        as it was."""
        pos = state["pos"]
        x, positions = self._embed(params, batch, decode_offset=pos)
        x, new_layers, _ = tfm.stack_apply(params["layers"], self.cfg, x,
                                           positions, states=state["layers"],
                                           cache_pos=pos)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return unembed(params["unembed"], x), {
            "layers": new_layers, "pos": pos + batch["tokens"].shape[1]}

    # ------------------------------------------------------------------
    # Slot-indexed decode-state surgery (continuous batching)
    # ------------------------------------------------------------------

    def reset_decode_slots(self, state, slot_mask) -> dict:
        """Zero, in place, the decode state of every slot where the host
        mask ``slot_mask`` is True (per-slot state only)."""
        for slot in np.flatnonzero(np.asarray(slot_mask, bool)):
            for layer in state["layers"]:
                for leaf in layer.values():
                    leaf[int(slot)].zero_()
            state["pos"][int(slot)] = 0
        return state

    def insert_decode_slot(self, state, src, slot: int) -> dict:
        """Copy, in place, the single slot of ``src`` (batch 1, per-slot)
        into slot ``slot`` of a pooled state."""
        for dst_layer, src_layer in zip(state["layers"], src["layers"]):
            for key, leaf in dst_layer.items():
                leaf[slot].copy_(src_layer[key][0])
        state["pos"][slot] = src["pos"][0]
        return state

    def merge_decode_state(self, new_state, old_state, active) -> dict:
        """Per-slot select: slots where the device mask ``active`` is True
        take the stepped state, the rest stay exactly frozen (positions and
        caches)."""
        keep = active.reshape(-1, 1, 1, 1)
        layers = [{key: torch.where(keep, new[key], old[key]) for key in new}
                  for new, old in zip(new_state["layers"],
                                      old_state["layers"])]
        return {"layers": layers,
                "pos": torch.where(active, new_state["pos"],
                                   old_state["pos"])}


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
