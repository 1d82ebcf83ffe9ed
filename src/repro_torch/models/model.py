"""``build_model(cfg, device) -> Model``: the decoder-only model behind the
serving path, with the reference package's functional interface.

Batch conventions: ``{"tokens": (B, S) int64}``; a vision (VLM) config
adds ``"vision_embeds"`` (B, P, d), spliced over the first P positions,
and an ``mrope`` config ``"positions"`` (B, S, 3), the (t, h, w) ids, on
every call (decode included: ``mrope_positions`` builds the text-only
ones).  Parameters are a dict
``{"embed", "layers": [per-layer dict, ...], "final_norm", "unembed"}``;
the decode state is ``{"layers": [per-layer tree, ...], "pos"}`` — a
layer's tree is ``{"k", "v"}`` for attention (``{"pk", "pv"}``, a page
pool shared by the slots, when paged), ``{"k", "v"}`` ring buffers of the
window's length for local attention, ``{"h", "conv"}`` for the RG-LRU and
``{"time": {"S", "shift"}, "channel": {"shift"}}`` for rwkv — with every
per-slot leaf's slot axis first.  With tied embeddings (gemma's) there is
no ``unembed``: the logits read ``embed``, and the embedded tokens are
scaled by sqrt(d_model) rounded to the weights' dtype.  ``loss`` is the
training objective: next-token cross-entropy (the vision patches'
positions masked) plus the weighted auxiliary (the mixture of experts'
load-balance) and z losses, through ``xent_auto`` (direct up to 2048
positions, chunked and recomputed above).  The port has every family
of the reference: dense (RoPE, GLU FFN, tied or untied embeddings),
mixture of experts, the hybrid family (RG-LRU and local attention), rwkv6,
the VLM backbone (M-RoPE, the vision stub) and, in ``EncDecModel``,
encoder-decoder (the audio stub: ``batch["frames"]`` (B, S_enc, d) feeds
the encoder in ``loss`` and ``prefill``).  An encoder-decoder model's
parameters are ``{"embed", "unembed", "enc_final_norm", "final_norm",
"encoder": [...], "decoder": [...]}`` and its decode state ``{"layers":
[{"k", "v", "cross": {"k", "v"}}, ...], "pos"}``: each decoder layer's
self-attention cache beside its cross-attention cache of
``min(ENCDEC_DECODE_ENC_LEN, max_len)`` encoder rows, slot axis first on
every leaf, so the serving stack handles it as any other state.

On a mesh (a ``ShardingCtx``) ``forward_logits``, ``loss``, ``prefill``
and ``decode_step`` take lists with one entry a position.  A training
context (``data_axes`` non-empty) splits the batch over the data axes and
FSDP-splits the weights there (gathered just before use), shards heads,
FFN columns, experts and the vocabulary over the model axis, and runs a
vocab-parallel cross-entropy whose full (B, S, V) logits never exist on
one position.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import join
from repro_torch.distributed.sharding import (batch_sharding,
                                              param_shardings, place_tree)
from repro_torch.kernels.tuning import recompute_contexts
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    dtype_of,
    embed_init,
    embed_lookup,
    rmsnorm,
    rmsnorm_init,
    unembed,
)
from repro_torch.tree import leaves_with_paths, tree_map, tree_map_with_path


AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4
XENT_CHUNK = 1024
# the vision stub: one position in VLM_PATCH_FRACTION holds a patch
# embedding in training batches, at most 1024 (the reference's)
VLM_PATCH_FRACTION = 8
# the audio stub: encoder frames a decode state's cross cache holds, at
# most (the reference's; ``min(ENCDEC_DECODE_ENC_LEN, max_len)`` rows)
ENCDEC_DECODE_ENC_LEN = 4096
ENCDEC_PAGED_REFUSAL = ("paged=True supports decoder-only models (enc-dec "
                        "decode state has no paged layout)")
# the reference builds its serve mesh's context with data_axes=() and
# expert parallelism on, and its moe_ep then reads data_axes[0]
# (src/repro/models/ffn.py:201): an IndexError, so it serves no mixture of
# experts on a mesh, and neither does the port
MOE_MESH_REFUSAL = (
    "a mixture of experts on a serve mesh's model axis is not served: the "
    "reference's serve context (data_axes=()) makes moe_ep read "
    "data_axes[0] and fail with an IndexError, so there is no reference "
    "path to port; expert parallelism (moe_ep, the moe_dispatch query) "
    "comes with the FSDP training slice")


def tensor_parallel(cfg: ModelConfig, ctx) -> bool:
    """Whether ``ctx`` runs ``cfg`` tensor-parallel (a model axis of more
    than one position); raises for a mixture of experts under a serve
    context (``data_axes=()``, where the reference's ``moe_ep`` fails)."""
    if ctx is None or ctx.tp <= 1:
        return False
    if cfg.is_moe and not ctx.data_axes:
        raise ValueError(MOE_MESH_REFUSAL)
    return True


def is_page_pool(path: str) -> bool:
    """Whether the decode-state leaf at ``path`` is a paged page pool
    (``pk``/``pv``): shared storage with no slot axis, addressed by block
    tables."""
    return path.rsplit("/", 1)[-1] in ("pk", "pv")


def _slot_leaves(layers) -> list:
    """Every per-slot leaf of a decode state's layers (page pools left
    out)."""
    return [leaf for path, leaf in leaves_with_paths(layers)
            if not is_page_pool(path)]


def _offset_positions(b: int, s: int, offset: torch.Tensor) -> torch.Tensor:
    """(B, S) absolute positions from a 0-d or per-slot (B,) offset."""
    off = offset.reshape(-1, 1)
    return (off + torch.arange(s, device=offset.device)[None]).expand(b, s)


def mrope_positions(b: int, s: int, offset, device=None) -> torch.Tensor:
    """(B, S, 3) text-only M-RoPE positions: the three planes share the
    sequential index from ``offset``: an int (filled on ``device``, no
    copy from the host) or a 0-d or per-slot (B,) tensor, whose device
    they take.  The one helper the prefill and decode serving paths use."""
    if isinstance(offset, int):
        offset = torch.full((), offset, dtype=torch.int64, device=device)
    return _offset_positions(b, s, offset)[..., None].expand(b, s, 3)


def _vlm_patches(cfg: ModelConfig, s: int) -> int:
    """Vision patch positions at the head of a training sequence of ``s``
    tokens: s // VLM_PATCH_FRACTION up to 1024, none for s <= 8 or a
    config without the vision frontend."""
    if cfg.frontend != "vision" or s <= 8:
        return 0
    return min(1024, s // VLM_PATCH_FRACTION)


class _DecodeSlots:
    """Slot-indexed surgery on a decode state ``{"layers": [per-layer
    tree, ...], "pos"}`` whose per-slot leaves have their slot axis first
    (continuous batching).  Surgery on single slots
    (``reset_decode_slots``, ``insert_decode_slot``) writes in place, which
    is the port's stand-in for the reference's buffer donation."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype_of(cfg.dtype)

    # Page pools (``pk``/``pv``) have no slot axis: a slot's pages are its
    # block-table row, which the SlotPool owns.  All three surgeries below
    # pass the pools through untouched, as the reference's stack_state_map
    # does (a pool's row ``slot`` is a page of some other request).

    def reset_decode_slots(self, state, slot_mask) -> dict:
        """Zero, in place, the decode state of every slot where the host
        mask ``slot_mask`` is True (per-slot state only), every per-slot
        leaf of every layer's tree on its slot axis (0)."""
        for slot in np.flatnonzero(np.asarray(slot_mask, bool)):
            for leaf in _slot_leaves(state["layers"]):
                leaf[int(slot)].zero_()
            state["pos"][int(slot)] = 0
        return state

    def insert_decode_slot(self, state, src, slot: int) -> dict:
        """Copy, in place, the single slot of ``src`` (batch 1, per-slot)
        into slot ``slot`` of a pooled state, leaf by leaf (the
        destination's page pools are kept)."""
        for dst, one in zip(_slot_leaves(state["layers"]),
                            _slot_leaves(src["layers"])):
            dst[slot].copy_(one[0])
        state["pos"][slot] = src["pos"][0]
        return state

    def merge_decode_state(self, new_state, old_state, active) -> dict:
        """Per-slot select: slots where the device mask ``active`` (B,) is
        True take the stepped state, the rest stay exactly frozen
        (positions, caches and recurrent state).  The mask is shaped to
        each leaf's rank, slot axis first.  Page pools come from
        ``new_state``: a masked slot's writes went to the null page."""
        def select(path, new, old):
            if is_page_pool(path):
                return new
            keep = active.reshape((-1,) + (1,) * (new.dim() - 1))
            return torch.where(keep, new, old)

        return {"layers": tree_map_with_path(select, new_state["layers"],
                                             old_state["layers"]),
                "pos": torch.where(active, new_state["pos"],
                                   old_state["pos"])}


class _MeshFamily(_DecodeSlots):
    """What both model classes run on a mesh: the spec rules' view of the
    parameters, the check of placed inputs, and the vocab-parallel token
    embedding and logits."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__(cfg, device)
        # the mesh's spec rules read these (param_shapes, mesh_specs)
        self._shapes = None
        self._specs: dict = {}

    def param_shapes(self) -> dict:
        """The parameter tree with every leaf a meta tensor of its shape
        and dtype (no memory, no draws): what the spec rules read."""
        if self._shapes is None:
            from torch._subclasses.fake_tensor import FakeTensorMode

            with FakeTensorMode():
                fake = type(self)(self.cfg, "cpu").init(0)
            self._shapes = tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device="meta"), fake)
        return self._shapes

    def mesh_specs(self, ctx) -> dict:
        """The params' specs on ``ctx``'s mesh: ``param_shardings`` with
        the context's axes and the planner's overrides it carries, the
        tree ``place_tree`` places params by (the ``params`` subtree of a
        train state's)."""
        overrides = ctx.overrides or {}
        key = (tuple(ctx.mesh.shape.items()), tuple(ctx.data_axes),
               ctx.model_axis, tuple(sorted(overrides.items())))
        if key not in self._specs:
            self._specs[key] = param_shardings(
                self.param_shapes(), ctx.mesh, data_axes=ctx.data_axes,
                model_axis=ctx.model_axis, overrides=overrides or None,
                cfg=self.cfg)
        return self._specs[key]

    def _mesh_inputs(self, params, batch, ctx):
        """``params`` checked against the blocks the specs give, and the
        batch one dict a position (a global dict split by
        ``batch_sharding``)."""
        tensor_parallel(self.cfg, ctx)  # the refusals
        specs = self.mesh_specs(ctx)
        mesh = ctx.mesh
        if not isinstance(params, (list, tuple)) or len(params) != mesh.size:
            raise ValueError(f"params on a mesh of {mesh.size} positions "
                             f"must be a list of {mesh.size} trees "
                             f"(place_tree)")

        def check(path, shape, spec, *local):
            want = list(shape.shape)
            for k, axes in enumerate(spec):
                if axes is not None:
                    want[k] //= _axes_size(axes, mesh)
            for leaf in local:
                if list(leaf.shape) != want:
                    raise ValueError(
                        f"{path}: a position holds {tuple(leaf.shape)}, the "
                        f"spec {spec} on mesh {mesh.shape} gives "
                        f"{tuple(want)}; place the params by "
                        f"param_shardings(..., data_axes="
                        f"{tuple(ctx.data_axes)}, cfg=cfg)")

        tree_map_with_path(check, self.param_shapes(), specs, *params)
        if isinstance(batch, dict):
            batch = place_tree(mesh, batch, batch_sharding(
                batch, mesh, ctx.data_axes) if ctx.data_axes else
                tree_map(lambda t: (None,) * t.dim(), batch))
        return specs, batch

    def _tokens_tp(self, ctx, tables, batch) -> list:
        """The token embeddings on every position of ``ctx``: where
        ``tables`` (each position's tree holding ``embed``) are vocab
        blocks, each position looks up its block's rows (zeros elsewhere)
        and the rows are summed over the model axis, exactly."""
        ranks = [ctx.rank(i) for i in range(ctx.mesh.size)]
        split = tables[0]["embed"].shape[0] < self.cfg.vocab_size
        xs = ctx.map(lambda t, b, r: self._lookup(t, b, r if split else 0),
                     tables, batch, ranks)
        return ctx.row_sum(xs, xs[0].dtype) if split else xs

    def _logits_tp(self, ctx, tables, xs) -> list:
        """fp32 logits on every position: each position's vocab block of
        ``tables``, gathered along the vocab where split, so every
        position holds the whole (B, S, V)."""
        logits = ctx.map(unembed, tables, xs)
        if tables[0].shape[0] < self.cfg.vocab_size:
            logits = ctx.gather(logits, dim=-1)
        return logits


class Model(_MeshFamily):
    """A decoder-only model on ``device``: the reference's ``Model`` record
    as methods."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        unported = []
        if cfg.is_encdec:
            unported.append("encoder-decoder (build_model gives an "
                            "EncDecModel)")
        if any(k not in ("attn", "local", "rglru", "rwkv")
               for k in cfg.block_pattern):
            unported.append(f"block pattern {cfg.block_pattern}")
        if cfg.pos_type not in ("rope", "mrope", "none"):
            unported.append(f"pos_type {cfg.pos_type!r}")
        if cfg.frontend not in ("none", "vision"):
            unported.append(f"frontend {cfg.frontend!r}")
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unported)} not ported yet "
                f"(other model families)")
        super().__init__(cfg, device)

    # ------------------------------------------------------------------

    def init(self, seed: int = 0) -> dict:
        """Fresh parameters with the reference's distributions, drawn from a
        ``torch.Generator`` seeded with ``seed`` on the model's device."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, self.dtype),
            "layers": tfm.stack_init(gen, cfg),
            "final_norm": rmsnorm_init(cfg.d_model, self.device),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                           self.dtype)
        return params

    def _table(self, params) -> torch.Tensor:
        """The (vocab, d) table the logits read: ``embed`` when tied."""
        return params["embed" if self.cfg.tie_embeddings else "unembed"]

    def _lookup(self, params, batch, rank: int = 0):
        """The token embeddings, scaled where tied; on a serve mesh the
        rows of position ``rank``'s block of the table (zeros elsewhere)."""
        cfg = self.cfg
        table = params["embed"]
        scale = float(cfg.d_model) ** 0.5 if cfg.tie_embeddings else None
        return embed_lookup(table, batch["tokens"], scale,
                            first_row=rank * table.shape[0],
                            vocab=cfg.vocab_size)

    def _embed(self, params, batch, decode_offset=None, x=None):
        """Embedded tokens (the vision embeddings over the first P
        positions, where the batch has them) and the positions the
        attention rotates by: ``batch["positions"]`` (B, S, 3) for M-RoPE,
        which is never inferred, else (B, S) from ``decode_offset``.  ``x``:
        the token embeddings, where made outside (on a serve mesh)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        cfg = self.cfg
        if x is None:
            x = self._lookup(params, batch)
        if cfg.frontend == "vision" and "vision_embeds" in batch:
            vis = batch["vision_embeds"]
            x = torch.cat([vis.to(x.dtype), x[:, vis.shape[1]:]], dim=1)
        if cfg.pos_type == "mrope":
            if "positions" not in batch:
                raise ValueError(
                    f"{cfg.name}: an mrope model needs batch['positions'] "
                    f"(B, S, 3) on every call; mrope_positions builds the "
                    f"text-only ones")
            return x, batch["positions"]
        if decode_offset is None:
            decode_offset = torch.zeros((), dtype=torch.int64,
                                        device=tokens.device)
        return x, _offset_positions(b, s, decode_offset)

    def _aux(self, aux) -> torch.Tensor:
        """The stack's auxiliary loss as a 0-d fp32 tensor on the model's
        device.  A dense stack's is the Python float 0.0: one fill on the
        device, with no host round trip."""
        if torch.is_tensor(aux):
            return aux.to(dtype=torch.float32, device=self.device)
        return torch.full((), float(aux), dtype=torch.float32,
                          device=self.device)

    def forward_logits(self, params, batch, ctx=None, remat: bool = False):
        """(B, S, V) fp32 logits of a full causal forward, and the
        auxiliary loss (a 0-d fp32 tensor on the model's device).  On a
        mesh (``ctx``) ``params`` and ``batch`` are lists with one entry a
        position (``batch`` may be the global batch, which is split by
        ``batch_sharding``), and so are the results: each position's
        (B/dp, S, V) logits, the vocab blocks gathered, and the
        auxiliary loss."""
        if ctx is not None:
            xs, tables, auxs, _ = self._forward_mesh(params, batch, ctx,
                                                     remat)
            return (join(ctx.mesh, self._logits_tp(ctx, tables, xs)),
                    join(ctx.mesh, auxs))
        x, positions = self._embed(params, batch)
        x, _, aux = tfm.stack_apply(params["layers"], self.cfg, x, positions,
                                    remat=remat)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return unembed(self._table(params), x), self._aux(aux)

    def prefill(self, params, batch, ctx=None):
        """Inference prefill: full forward, logits only at the last
        position.  On a serve mesh (``ctx``, tensor-parallel) ``params``
        and ``batch`` are lists with one entry a position and so are the
        logits, each the whole (B, 1, V).  On a context with data axes
        (the dry run's production meshes) the params are FSDP blocks,
        gathered just before their use as in ``loss``, unless the context
        replicates them over the data axes (``infer_replicate_params``);
        each position's rows of the batch give their logits."""
        if ctx is not None and ctx.data_axes and \
                not ctx.infer_replicate_params:
            xs, tables, _, _ = self._forward_mesh(params, batch, ctx,
                                                  remat=False, last=True)
            return join(ctx.mesh, self._logits_tp(ctx, tables, xs))
        if tensor_parallel(self.cfg, ctx):
            return self._forward_tp(params, batch, ctx, None, last=True)[0]
        x, positions = self._embed(params, batch)
        x, _, _ = tfm.stack_apply(params["layers"], self.cfg, x, positions,
                                  remat=False)
        x = rmsnorm(params["final_norm"], x[:, -1:], self.cfg.norm_eps)
        return unembed(self._table(params), x)

    def loss(self, params, batch, ctx=None, remat: bool = True):
        """Next-token training loss on ``batch["tokens"]`` (B, S): targets
        are the tokens shifted by one, masked where they fall on the first
        ``_vlm_patches(cfg, S)`` positions (vision configs; none otherwise).
        Returns ``(ce + AUX_LOSS_WEIGHT * aux + Z_LOSS_WEIGHT * z, {"ce",
        "aux", "z"})``, all 0-d tensors on the model's device.  ``remat``
        recomputes each layer in the backward pass, as the reference's loss
        does.

        On a mesh (``ctx``) ``params`` and ``batch`` are lists with one
        entry a position (``place_tree`` by ``param_shardings`` and
        ``batch_sharding``; a global batch dict is split here), and so are
        the results, every position holding the same values: the means are
        over the global batch (the sums and the mask count added over the
        data axes), the cross-entropy vocab-parallel over the model
        axis."""
        if ctx is not None:
            return self._loss_mesh(params, batch, ctx, remat)
        tokens = batch["tokens"]
        x, positions = self._embed(params, batch)
        x, _, aux = tfm.stack_apply(params["layers"], self.cfg, x, positions,
                                    remat=remat)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        targets = tokens[:, 1:]
        patches = _vlm_patches(self.cfg, tokens.shape[1])
        mask = (torch.arange(targets.shape[1], device=tokens.device)
                >= patches).float().expand(targets.shape)
        ce, z = xent_auto(self._table(params), x[:, :-1], targets, mask)
        aux = self._aux(aux)
        total = ce + AUX_LOSS_WEIGHT * aux + Z_LOSS_WEIGHT * z
        return total, {"ce": ce, "aux": aux, "z": z}

    # ------------------------------------------------------------------
    # On a training mesh
    # ------------------------------------------------------------------

    def _forward_mesh(self, params, batch, ctx, remat: bool,
                      last: bool = False):
        """The forward on a mesh up to the final norm (``last``: of the
        last position only): (xs, each position's logits table (its vocab
        block, FSDP-gathered), auxiliary losses, the batch one dict a
        position), lists with one entry a position."""
        cfg = self.cfg
        specs, batch = self._mesh_inputs(params, batch, ctx)
        keys = [k for k in ("embed", "unembed", "final_norm") if k in specs]
        tops = ctx.gather_tree([{k: p[k] for k in keys} for p in params],
                               {k: specs[k] for k in keys})
        xs = self._tokens_tp(ctx, tops, batch)
        xs, positions = ctx.map(lambda t, b, x: self._embed(t, b, x=x),
                                tops, batch, xs)
        xs, auxs = tfm.stack_train_tp(
            ctx, [p["layers"] for p in params], specs["layers"], cfg, xs,
            positions, remat=remat, rnn_chunk=ctx.rnn_chunk)
        if last:
            xs = ctx.map(lambda x: x[:, -1:], xs)
        xs = ctx.map(lambda t, x: rmsnorm(t["final_norm"], x, cfg.norm_eps),
                     tops, xs)
        tables = [self._table(t) for t in tops]
        auxs = ctx.map(lambda a, x: a.float() if torch.is_tensor(a) else
                       torch.zeros((), dtype=torch.float32, device=x.device),
                       auxs, xs)
        return xs, tables, auxs, batch

    def _loss_mesh(self, params, batch, ctx, remat: bool):
        """``loss`` on a mesh: each position's CE and z sums from its
        vocab block (``xent_mesh``), added over the data axes with the
        mask count, then the global means."""
        cfg = self.cfg
        xs, tables, auxs, batch = self._forward_mesh(params, batch, ctx,
                                                     remat)

        def targets(b):
            tokens = b["tokens"]
            t = tokens[:, 1:]
            patches = _vlm_patches(cfg, tokens.shape[1])
            mask = (torch.arange(t.shape[1], device=tokens.device)
                    >= patches).float().expand(t.shape)
            return t, mask

        tgt, masks = ctx.map(targets, batch)
        ces, zs = _xent_mesh_means(ctx, tables, xs, tgt, masks,
                                   cfg.vocab_size)

        def total(ce, z, a):
            return (ce + AUX_LOSS_WEIGHT * a + Z_LOSS_WEIGHT * z,
                    {"ce": ce, "aux": a, "z": z})

        totals, metrics = ctx.map(total, ces, zs, auxs)
        return join(ctx.mesh, totals), join(ctx.mesh, metrics)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def init_decode_state(self, batch_size: int, max_len: int,
                          per_slot: bool = False, paging=None) -> dict:
        """``per_slot=True`` gives every batch row its own cache position
        (continuous batching); the default 0-d position is lockstep decode.
        ``paging=(n_blocks, block_size)`` swaps full-attention KV for a
        page pool shared by the slots, addressed by per-row block tables
        (``batch["block_tables"]`` of each ``decode_step``)."""
        pos_shape = (batch_size,) if per_slot else ()
        return {
            "layers": tfm.stack_init_state(self.cfg, batch_size, max_len,
                                           self.device, paging),
            "pos": torch.zeros(pos_shape, dtype=torch.int64,
                               device=self.device),
        }

    def decode_step(self, params, state, batch, ctx=None):
        """Feed ``batch["tokens"]`` (B, S_new) at each row's cache position.
        Returns ((B, S_new, V) fp32 logits, new state); ``state`` is left
        as it was, but for its page pools: a paged state's pools are
        written in place through ``batch["block_tables"]`` (B,
        max_blocks), and the new state holds the same pool tensors.

        On a serve mesh (``ctx`` with a model axis of more than one
        position) ``params``, ``state`` and ``batch`` are lists with one
        entry a position (``sharding.place_tree`` by the serve specs), and
        so are the logits (each the whole (B, S_new, V), the vocab blocks
        gathered) and the new state: the tensor-parallel stack
        (``transformer.stack_apply_tp``)."""
        if tensor_parallel(self.cfg, ctx):
            return self._forward_tp(params, batch, ctx, state)
        pos = state["pos"]
        x, positions = self._embed(params, batch, decode_offset=pos)
        x, new_layers, _ = tfm.stack_apply(
            params["layers"], self.cfg, x, positions, states=state["layers"],
            cache_pos=pos, block_tables=batch.get("block_tables"))
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return unembed(self._table(params), x), {
            "layers": new_layers, "pos": pos + batch["tokens"].shape[1]}


    def _forward_tp(self, params, batch, ctx, state, last: bool = False):
        """The tensor-parallel forward of ``decode_step`` (with a ``state``)
        or ``prefill`` (without; ``last`` keeps the last position).  The
        embedding's vocab blocks are looked up on their positions and
        summed over the model axis; the unembedding's are gathered along
        the vocab before every position's argmax."""
        cfg = self.cfg
        n = ctx.mesh.size
        xs = self._tokens_tp(ctx, params, batch)
        pos = [None] * n if state is None else [st["pos"] for st in state]
        xs, positions = ctx.map(lambda p, b, x, o: self._embed(p, b, o, x=x),
                                params, batch, xs, pos)
        xs, new_layers = tfm.stack_apply_tp(
            ctx, [p["layers"] for p in params], cfg, xs, positions,
            states=None if state is None else [st["layers"] for st in state],
            cache_pos=pos if state is not None else None,
            block_tables=[b.get("block_tables") for b in batch])
        if last:
            xs = ctx.map(lambda x: x[:, -1:], xs)
        xs = ctx.map(lambda p, x: rmsnorm(p["final_norm"], x, cfg.norm_eps),
                     params, xs)
        logits = self._logits_tp(ctx, [self._table(p) for p in params], xs)
        if state is None:
            return logits, None
        s = batch[0]["tokens"].shape[1]
        return logits, ctx.map(lambda ly, p: {"layers": ly, "pos": p + s},
                               new_layers, pos)


class EncDecModel(_MeshFamily):
    """The encoder-decoder model (seamless-m4t-medium) on ``device``: the
    reference's ``_build_encdec`` record as methods, the same ones as
    ``Model`` but ``forward_logits``.  The encoder runs in ``loss`` and
    ``prefill`` only; serving decodes through ``decode_step`` against the
    state's cross caches, which ``init_decode_state`` fills with zeros and
    nothing in serving writes (as in the reference: the cross term of a
    served token is then exactly 0).

    On a mesh ``loss``, ``prefill`` and ``decode_step`` take lists with
    one entry a position, as ``Model``'s do: the encoder and the decoder
    tensor-parallel over the model axis (``encdec.encoder_layer_tp``,
    ``decoder_layer_tp``), FSDP over the data axes in training, the
    cross-entropy vocab-parallel (``xent_mesh``)."""

    def _lookup(self, params, batch, rank: int = 0):
        """The token embeddings; on a mesh the rows of position ``rank``'s
        vocab block of the table (zeros elsewhere)."""
        table = params["embed"]
        return embed_lookup(table, batch["tokens"],
                            first_row=rank * table.shape[0],
                            vocab=self.cfg.vocab_size)

    def init(self, seed: int = 0) -> dict:
        """Fresh parameters with the reference's distributions, drawn from a
        ``torch.Generator`` seeded with ``seed`` on the model's device."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, self.dtype),
            "unembed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                  self.dtype),
            "enc_final_norm": rmsnorm_init(cfg.d_model, self.device),
            "final_norm": rmsnorm_init(cfg.d_model, self.device),
            "encoder": [encdec_lib.encdec_layer_init(gen, cfg, False,
                                                     self.dtype)
                        for _ in range(cfg.encoder_layers)],
            "decoder": [encdec_lib.encdec_layer_init(gen, cfg, True,
                                                     self.dtype)
                        for _ in range(cfg.n_layers)],
        }

    def encode(self, params, frames: torch.Tensor,
               remat: bool = True) -> torch.Tensor:
        """The encoder over ``frames`` (B, S_enc, d), cast to the weights'
        dtype: (B, S_enc, d) after the final norm.  With ``remat`` and
        gradients on, each layer keeps only its input for the backward
        pass and runs again there."""
        x = frames.to(self.dtype)
        positions = _offset_positions(
            x.shape[0], x.shape[1],
            torch.zeros((), dtype=torch.int64, device=x.device))
        remat = remat and torch.is_grad_enabled()
        for lp in params["encoder"]:
            if remat:
                x = checkpoint(encdec_lib.encoder_layer_apply, lp, self.cfg,
                               x, positions, use_reentrant=False,
                               context_fn=recompute_contexts)
            else:
                x = encdec_lib.encoder_layer_apply(lp, self.cfg, x, positions)
        return rmsnorm(params["enc_final_norm"], x, self.cfg.norm_eps)

    def _decode_stack(self, params, tokens, enc_out, remat: bool):
        """The decoder, teacher-forced over ``tokens`` (B, S) against the
        encoder output: (B, S, d) before the final norm.  Each layer's cross
        K/V is projected outside its recomputed body, as the reference
        does."""
        cfg = self.cfg
        b, s = tokens.shape
        x = embed_lookup(params["embed"], tokens)
        positions = _offset_positions(
            b, s, torch.zeros((), dtype=torch.int64, device=tokens.device))
        remat = remat and torch.is_grad_enabled()
        for lp in params["decoder"]:
            enc_kv = encdec_lib.cross_kv(lp, cfg, enc_out)
            if remat:
                x = checkpoint(_decoder_body, lp, cfg, x, positions, enc_kv,
                               use_reentrant=False,
                               context_fn=recompute_contexts)
            else:
                x = _decoder_body(lp, cfg, x, positions, enc_kv)
        return x

    def prefill(self, params, batch, ctx=None):
        """Encode ``batch["frames"]``, run the decoder teacher-forced over
        ``batch["tokens"]``, return the last position's logits (B, 1, V)
        fp32; no decode state is filled (the reference's).  On a mesh
        (``ctx``, tensor-parallel) ``params`` and ``batch`` are lists with
        one entry a position (a global batch dict is placed here) and so
        are the logits, each position's rows of the batch, the vocab
        gathered."""
        if tensor_parallel(self.cfg, ctx):
            xs, tables, _ = self._forward_mesh(params, batch, ctx,
                                               remat=False, last=True)
            return self._logits_tp(ctx, tables, xs)
        enc_out = self.encode(params, batch["frames"], remat=False)
        x = self._decode_stack(params, batch["tokens"], enc_out, remat=False)
        x = rmsnorm(params["final_norm"], x[:, -1:], self.cfg.norm_eps)
        return unembed(params["unembed"], x)

    def loss(self, params, batch, ctx=None, remat: bool = True):
        """Next-token cross-entropy of the decoder over ``batch["tokens"]``
        (B, S), conditioned on the encoded ``batch["frames"]``, plus the
        weighted z loss.  Returns ``(ce + Z_LOSS_WEIGHT * z, {"ce", "z"})``,
        0-d tensors on the model's device.

        On a mesh (``ctx``) ``params`` and ``batch`` are lists with one
        entry a position (``place_tree`` by ``param_shardings`` and
        ``batch_sharding``; a global batch dict is split here), and so are
        the results, every position holding the same values: the means
        over the global batch, the cross-entropy vocab-parallel over the
        model axis."""
        if ctx is not None:
            xs, tables, batch = self._forward_mesh(params, batch, ctx, remat)
            tgt, masks = ctx.map(lambda b: (b["tokens"][:, 1:], torch.ones(
                b["tokens"][:, 1:].shape, dtype=torch.float32,
                device=b["tokens"].device)), batch)
            ces, zs = _xent_mesh_means(ctx, tables, xs, tgt, masks,
                                       self.cfg.vocab_size)
            totals, metrics = ctx.map(lambda ce, z: (
                ce + Z_LOSS_WEIGHT * z, {"ce": ce, "z": z}), ces, zs)
            return join(ctx.mesh, totals), join(ctx.mesh, metrics)
        tokens = batch["tokens"]
        enc_out = self.encode(params, batch["frames"], remat)
        x = self._decode_stack(params, tokens, enc_out, remat)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        targets = tokens[:, 1:]
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=tokens.device)
        ce, z = xent_auto(params["unembed"], x[:, :-1], targets, mask)
        return ce + Z_LOSS_WEIGHT * z, {"ce": ce, "z": z}

    def _forward_mesh(self, params, batch, ctx, remat: bool,
                      last: bool = False):
        """The encoder, then the decoder teacher-forced, on a mesh, up to
        the final norm (``last``: the last position only): (xs, each
        position's unembedding vocab block, the batch one dict a
        position), lists.  Each layer FSDP-gathers its weights over the
        data axes (none on a serve context) inside its recomputed body;
        each decoder layer's cross K/V is projected outside it."""
        cfg = self.cfg
        specs, batch = self._mesh_inputs(params, batch, ctx)
        keys = ("embed", "unembed", "enc_final_norm", "final_norm")
        tops = ctx.gather_tree([{k: p[k] for k in keys} for p in params],
                               {k: specs[k] for k in keys})
        remat = remat and torch.is_grad_enabled()

        def run(fn, *args):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False,
                                  context_fn=recompute_contexts)
            return fn(*args)

        def positions(x):
            return _offset_positions(x.shape[0], x.shape[1], torch.zeros(
                (), dtype=torch.int64, device=x.device))

        xs = ctx.map(lambda b: b["frames"].to(self.dtype), batch)
        pos = ctx.map(positions, xs)
        for j in range(cfg.encoder_layers):
            xs = run(encdec_lib.encoder_layer_train_tp, ctx,
                     [p["encoder"][j] for p in params], specs["encoder"][j],
                     cfg, xs, pos)
        enc = ctx.map(lambda t, x: rmsnorm(t["enc_final_norm"], x,
                                           cfg.norm_eps), tops, xs)
        xs = self._tokens_tp(ctx, tops, batch)
        pos = ctx.map(lambda b: positions(b["tokens"]), batch)
        for j in range(cfg.n_layers):
            lps = [p["decoder"][j] for p in params]
            kv = encdec_lib.cross_kv_tp(ctx, lps, specs["decoder"][j], cfg,
                                        enc)
            xs = run(encdec_lib.decoder_layer_train_tp, ctx, lps,
                     specs["decoder"][j], cfg, xs, pos, kv)
        if last:
            xs = ctx.map(lambda x: x[:, -1:], xs)
        xs = ctx.map(lambda t, x: rmsnorm(t["final_norm"], x, cfg.norm_eps),
                     tops, xs)
        return xs, [t["unembed"] for t in tops], batch

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def init_decode_state(self, batch_size: int, max_len: int,
                          per_slot: bool = False, paging=None) -> dict:
        """Each decoder layer's self-attention cache {"k", "v"} (B, max_len,
        Hkv, hd) and cross cache {"cross": {"k", "v"}} (B,
        min(ENCDEC_DECODE_ENC_LEN, max_len), Hkv, hd), zero-filled, and the
        position: (B,) with ``per_slot``, else 0-d.  There is no paged
        layout (``paging`` raises the reference's ``ValueError``)."""
        if paging is not None:
            raise ValueError(ENCDEC_PAGED_REFUSAL)
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        enc_len = min(ENCDEC_DECODE_ENC_LEN, max_len)

        def zeros(rows):
            return torch.zeros((batch_size, rows, cfg.n_kv_heads, hd),
                               dtype=self.dtype, device=self.device)

        pos_shape = (batch_size,) if per_slot else ()
        return {
            "layers": [{"k": zeros(max_len), "v": zeros(max_len),
                        "cross": {"k": zeros(enc_len), "v": zeros(enc_len)}}
                       for _ in range(cfg.n_layers)],
            "pos": torch.zeros(pos_shape, dtype=torch.int64,
                               device=self.device),
        }

    def decode_step(self, params, state, batch, ctx=None):
        """Feed ``batch["tokens"]`` (B, S_new) at each row's cache position
        through the decoder, attending to the state's cross caches.
        Returns ((B, S_new, V) fp32 logits, new state); ``state`` is left as
        it was, and the new state holds the same cross-cache tensors.

        On a serve mesh (``ctx`` with a model axis of more than one
        position) ``params``, ``state`` and ``batch`` are lists with one
        entry a position (the state placed by ``serve_state_sharding``:
        the self-attention and cross caches split by kv heads where they
        divide), and so are the logits (each the whole (B, S_new, V)) and
        the new state."""
        if tensor_parallel(self.cfg, ctx):
            return self._decode_tp(params, state, batch, ctx)
        cfg = self.cfg
        pos = state["pos"]
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_lookup(params["embed"], tokens)
        positions = _offset_positions(b, s, pos)
        layers = []
        for lp, st in zip(params["decoder"], state["layers"]):
            cross = st["cross"]
            x, cache = encdec_lib.decoder_layer_apply(
                lp, cfg, x, positions, (cross["k"], cross["v"]),
                self_cache=st, cache_pos=pos)
            layers.append({**cache, "cross": cross})
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["unembed"], x), {"layers": layers,
                                               "pos": pos + s}

    def _decode_tp(self, params, state, batch, ctx):
        """``decode_step`` on a serve mesh: the decoder tensor-parallel
        (``encdec.decoder_layer_tp``) against each position's blocks of
        the caches, the logits' vocab blocks gathered."""
        cfg = self.cfg
        n = ctx.mesh.size
        s = batch[0]["tokens"].shape[1]
        pos = [st["pos"] for st in state]
        xs = self._tokens_tp(ctx, params, batch)
        positions = ctx.map(lambda b, p: _offset_positions(
            b["tokens"].shape[0], s, p), batch, pos)
        layers = [[] for _ in range(n)]
        for j in range(cfg.n_layers):
            sts = [st["layers"][j] for st in state]
            xs, caches = encdec_lib.decoder_layer_tp(
                ctx, [p["decoder"][j] for p in params], cfg, xs, positions,
                [(st["cross"]["k"], st["cross"]["v"]) for st in sts],
                states=sts, cache_pos=pos)
            for i in range(n):
                layers[i].append({**caches[i], "cross": sts[i]["cross"]})
        xs = ctx.map(lambda p, x: rmsnorm(p["final_norm"], x, cfg.norm_eps),
                     params, xs)
        logits = self._logits_tp(ctx, [p["unembed"] for p in params], xs)
        return logits, ctx.map(lambda ly, p: {"layers": ly, "pos": p + s},
                               layers, pos)


# what build_model returns, and what the trainer, the serve steps, the
# slot pool and the engines take
AnyModel = Union[Model, EncDecModel]


def _decoder_body(lp, cfg, x, positions, enc_kv):
    return encdec_lib.decoder_layer_apply(lp, cfg, x, positions, enc_kv)[0]


def build_model(cfg: ModelConfig, device="cuda") -> AnyModel:
    """``EncDecModel`` for an encoder-decoder config, else ``Model``."""
    if cfg.is_encdec:
        return EncDecModel(cfg, device)
    return Model(cfg, device)


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------


def _xent_sums(table, x, targets, mask):
    """(sum of masked CE, sum of masked logz^2) of one stretch of
    positions, from fp32 logits on the matmul kernel."""
    logits = unembed(table, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), (logz * logz * mask).sum()


def _xent_chunked_sums(table, x, targets, mask, chunk: int):
    """``_xent_sums`` over chunks of ``chunk`` positions, each wrapped in a
    checkpoint, so its (B, chunk, V) fp32 logits are made, consumed and
    made again in the backward pass: the full (B, S, V) logits never
    exist.  The padding has mask 0."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    ce_sum = z_sum = 0.0
    for start in range(0, s + pad, chunk):
        ce, z = checkpoint(_xent_sums, table, x[:, start:start + chunk],
                           targets[:, start:start + chunk],
                           mask[:, start:start + chunk], use_reentrant=False,
                           context_fn=recompute_contexts)
        ce_sum, z_sum = ce_sum + ce, z_sum + z
    return ce_sum, z_sum


def xent_auto(table, x, targets, mask, chunk: int = XENT_CHUNK):
    """Mean CE and mean logz^2 of ``x`` (B, S, D) against ``targets`` (B,
    S) under ``mask``: direct for S <= 2 * chunk, chunked above (the
    reference's size crossover)."""
    if x.shape[1] <= 2 * chunk:
        ce_sum, z_sum = _xent_sums(table, x, targets, mask)
    else:
        ce_sum, z_sum = _xent_chunked_sums(table, x, targets, mask, chunk)
    denom = torch.clamp(mask.sum(), min=1.0)
    return ce_sum / denom, z_sum / denom


def _axes_size(axes, mesh) -> int:
    names = axes if isinstance(axes, tuple) else (axes,)
    return int(np.prod([mesh.shape[a] for a in names]))


def _xent_mesh_sums(ctx, tables, xs, targets, masks, vocab: int):
    """(CE sum, z sum, mask count) of one stretch of positions, an fp32
    (3,) tensor a position, every position of a data group the same bits.
    Where ``tables`` are vocab blocks (``vocab`` rows in all), each model
    rank makes the fp32 logits of its block only; the maximum (outside
    autograd), the sum of exponentials and the gold logit are combined
    over the model axis in fp32 (``row_sum``)."""
    logits = ctx.map(unembed, tables, xs)
    rows = tables[0].shape[0]
    if rows < vocab:
        ranks = [ctx.rank(i) for i in range(ctx.mesh.size)]
        top = ctx.model_max(ctx.map(lambda lg: lg.amax(-1), logits))
        sumexp = ctx.row_sum(ctx.map(
            lambda lg, m: torch.exp(lg - m[..., None]).sum(-1), logits, top),
            torch.float32)

        def gold_of(lg, t, r):
            local = t - r * rows
            hit = (local >= 0) & (local < rows)
            g = torch.gather(lg, -1, torch.where(hit, local, 0)[..., None])
            return torch.where(hit, g[..., 0], 0.0)

        gold = ctx.row_sum(ctx.map(gold_of, logits, targets, ranks),
                           torch.float32)
        logz = ctx.map(lambda m, e: m + torch.log(e), top, sumexp)
    else:
        logz = ctx.map(lambda lg: torch.logsumexp(lg, dim=-1), logits)
        gold = ctx.map(lambda lg, t: torch.gather(lg, -1, t[..., None])[
            ..., 0], logits, targets)
    return ctx.map(lambda lz, g, mk: torch.stack([
        ((lz - g) * mk).sum(), (lz * lz * mk).sum(), mk.sum()]),
        logz, gold, masks)


def xent_mesh(ctx, tables, xs, targets, masks, vocab: int,
              chunk: int = XENT_CHUNK):
    """``xent_auto``'s sums on a mesh, before the means: (CE sum, z sum,
    mask count) a position.  Direct for S <= 2 * chunk; above, chunks of
    ``chunk`` positions, each recomputed in the backward pass, so no
    position ever holds more than a (B, chunk, V/tp) block of logits."""
    s = xs[0].shape[1]
    if s <= 2 * chunk:
        return _xent_mesh_sums(ctx, tables, xs, targets, masks, vocab)
    pad = (-s) % chunk
    if pad:
        xs, targets, masks = ctx.map(lambda x, t, m: (
            F.pad(x, (0, 0, 0, pad)), F.pad(t, (0, pad)),
            F.pad(m, (0, pad))), xs, targets, masks)
    acc = None
    for a in range(0, s + pad, chunk):
        part = checkpoint(
            _xent_mesh_sums, ctx, tables, [x[:, a:a + chunk] for x in xs],
            [t[:, a:a + chunk] for t in targets],
            [m[:, a:a + chunk] for m in masks], vocab, use_reentrant=False,
            context_fn=recompute_contexts)
        acc = part if acc is None else ctx.map(torch.add, acc, part)
    return acc


def _xent_mesh_means(ctx, tables, xs, targets, masks, vocab: int) -> tuple:
    """(mean CEs, mean logz^2s), a list each with one entry a position, of
    ``xs`` (B, S, D) against the
    next tokens ``targets`` (B, S-1) under ``masks``: the sums of
    ``xent_mesh`` over the last position dropped, added over the data axes
    with the mask count, then divided; every position the same values."""
    sums = ctx.data_psum(xent_mesh(ctx, tables, ctx.map(
        lambda x: x[:, :-1], xs), targets, masks, vocab))
    return ctx.map(lambda sm: (sm[0] / torch.clamp(sm[2], min=1.0),
                               sm[1] / torch.clamp(sm[2], min=1.0)), sums)
