"""Step factories: the training step, and the serving steps (one greedy
decode step, the K-token macro-step and the batched group prefill).

``make_train_step`` builds the reference's step: loss -> gradients (each
layer recomputed in the backward pass) -> optional gradient compression ->
global-norm clip -> AdamW with the warmup-cosine rate.  With microbatches
a Python loop accumulates fp32 gradients divided by their count, as the
reference's ``lax.scan`` does.

The reference runs each step as one jitted program.  Here they are eager
with the same semantics, and everything the host does not need stays on
the device: in training the loss, metrics, rate and step count; in serving
argmax, EOS masking, the budget countdown, the ``merge_decode_state``
freeze of masked slots, per-row true-length position advance and
first-token capture.  No ``.item()``, ``.cpu()`` or ``.tolist()`` runs
inside a step; the caller syncs once on the result.

Given a tensor-parallel ``ctx`` (a serve mesh) the two serving steps of
the continuous engine run on every position: the params and the state
are lists with one entry a position, the host's inputs are replicated to
the positions, each position's bookkeeping runs as its own work
(``_Positions``), and the step hands back position 0's tokens.

Given a training ``ctx`` (a (pod?, data, model) mesh), ``make_train_step``
trains FSDP with tensor and expert parallelism: the state is one tree a
position (``place_tree`` by ``param_shardings`` of the whole state), the
batch one dict a position (``batch_sharding``) or the global dict.  The
autograd leaves are each position's own blocks; a replicated piece's
gradient is summed over the positions that hold it in a fixed order
(``ShardingCtx.replica_sum``), so every replica updates to the same bits;
``grad_norm`` is the norm of the logical gradient, each distinct block
counted once.  Gradient compression, where on, compresses that logical
gradient before the norm, as the reference's eager step does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.distributed.mesh import (all_gather_cat, join, psum,
                                          replicate, take)
from repro_torch.distributed.sharding import is_representative
from repro_torch.models.model import (AnyModel, mrope_positions,
                                      tensor_parallel)
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_scale, leaf_update)
from repro_torch.optim.compression import (compress_gradients,
                                           compress_gradients_mesh,
                                           init_compression)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.tree import (leaves_with_paths, tree_map,
                              tree_map_with_path, tree_unzip)


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    optimizer: AdamWConfig = AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 10000
    microbatches: int = 1  # grad-accumulation factor
    compression: bool = False
    compression_keep_frac: float = 0.1


def init_train_state(model: AnyModel, seed: int, loop: TrainLoopConfig) -> dict:
    """``{"params", "opt", "step"}`` (and ``"compress"`` with compression)
    on the model's device, parameters drawn from ``seed``."""
    params = model.init(seed)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if loop.compression:
        state["compress"] = init_compression(params)
    return state


def train_state_shapes(model: AnyModel, loop: TrainLoopConfig) -> dict:
    """``init_train_state``'s tree with every leaf a meta tensor of its
    shape and dtype, built from ``model.param_shapes()``: nothing drawn or
    allocated (the dry run's state; qwen3-moe-235b's parameters alone
    would be about 470 GB in bf16)."""
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"),
                      model.param_shapes())
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    if loop.compression:
        state["compress"] = init_compression(params)
    return state


def make_grad_fn(model: AnyModel, *, remat: bool = True,
                 ctx=None) -> Callable:
    """``grad_fn(params, batch) -> (loss, metrics, grads)``: the loss and
    the gradient of every parameter (a tree like ``params``), by autograd
    through the kernels' backward passes.  Raises if a parameter gets no
    gradient, which is what a kernel call outside autograd would cause.

    On a mesh (``ctx``) ``params`` and ``batch`` are lists with one entry
    a position and so are the results.  Every position's copy of the loss
    seeds the backward with 1/n (their mean is the loss), and each
    position's gradient of a replicated piece is then summed over the
    positions holding it (``replica_sum``): every position holds its
    block of the logical gradient."""
    if ctx is not None:
        return _mesh_grad_fn(model, remat, ctx)

    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, metrics = model.loss(live, batch, remat=remat)
            paths, leaves = zip(*leaves_with_paths(live))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        missing = [p for p, g in zip(paths, grads) if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {len(missing)} "
                               f"parameters, e.g. {missing[:3]}")
        by_path = dict(zip(paths, grads))
        grads = tree_map_with_path(lambda path, _: by_path[path], params)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    return grad_fn


def make_train_step(model: AnyModel, loop: TrainLoopConfig, *, ctx=None,
                    donate: bool = False) -> Callable:
    """``step_fn(state, batch) -> (new_state, metrics)``; ``state`` is left
    as it was, unless ``donate``: then the update is written into the
    parameters and moments of ``state`` (``adamw_update(inplace=True)``,
    the same values), which the caller hands over to the new state.
    Metrics: ``loss``, ``lr``, ``grad_norm`` and, without microbatches,
    ``ce``/``aux``/``z`` (and ``wire_bytes_ratio`` with compression), all
    on the device but the last.

    On a training mesh (``ctx``; see the module docstring) ``state`` is
    one tree a position and so are the new state and the metrics.
    Microbatch i is rows [i·B/n, (i+1)·B/n) of the global batch, split
    over the data axes.  Under ``donate`` place the state with
    ``place_tree(..., copy=True)`` (storage of its own on every position),
    or the update writes into the tensors the state was placed from; a
    block that several positions share is updated once.  With compression
    the logical gradient is compressed once, after the replica sums (and
    the microbatches' accumulation), on each position's blocks
    (``compress_gradients_mesh``): the logical tensor's result, the
    residual ``state["compress"]`` placed by the params' specs."""
    if ctx is not None:
        return _mesh_train_step(model, loop, ctx, donate)
    grad_fn = make_grad_fn(model)

    def step_fn(state, batch):
        params = state["params"]
        if loop.microbatches > 1:
            n = loop.microbatches
            acc, loss = None, 0.0
            for i in range(n):
                mb = {k: v.reshape((n, -1) + v.shape[1:])[i]
                      for k, v in batch.items()}
                mb_loss, _, grads = grad_fn(params, mb)
                part = tree_map(lambda g: g.float() / n, grads)
                acc = part if acc is None else tree_map(torch.add, acc, part)
                loss = loss + mb_loss / n
            grads, metrics = acc, {}
        else:
            loss, metrics, grads = grad_fn(params, batch)

        new_compress = None
        if loop.compression:
            grads, new_compress, cmetrics = compress_gradients(
                grads, state.get("compress"),
                keep_frac=loop.compression_keep_frac)
            metrics = {**metrics, **cmetrics}

        lr = warmup_cosine(state["step"], peak_lr=loop.optimizer.lr,
                           warmup_steps=loop.warmup_steps,
                           total_steps=loop.total_steps)
        new_params, new_opt, ometrics = adamw_update(
            params, grads, state["opt"], loop.optimizer, lr=lr,
            inplace=donate)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if new_compress is not None:
            new_state["compress"] = new_compress
        return new_state, {"loss": loss, "lr": lr, **metrics, **ometrics}

    return step_fn


def _mesh_grad_fn(model: AnyModel, remat: bool, ctx) -> Callable:
    mesh = ctx.mesh
    n = mesh.size

    def grad_fn(params, batch):
        specs = model.mesh_specs(ctx)
        with torch.enable_grad():
            live = [tree_map(lambda p: p.detach().requires_grad_(True), p)
                    for p in params]
            losses, metrics = model.loss(live, batch, ctx, remat=remat)
            flat = [leaves_with_paths(t) for t in live]
            seeds = ctx.map(lambda t: torch.full_like(t, 1.0 / n), losses)
            grads = torch.autograd.grad(
                losses, [leaf for f in flat for _, leaf in f],
                grad_outputs=seeds, allow_unused=True)
        trees, k = [], 0
        for i, f in enumerate(flat):
            got = grads[k:k + len(f)]
            k += len(f)
            missing = [p for (p, _), g in zip(f, got) if g is None]
            if missing:
                raise RuntimeError(
                    f"no gradient reached {len(missing)} parameters of "
                    f"position {i}, e.g. {missing[:3]}")
            by_path = {p: g for (p, _), g in zip(f, got)}
            trees.append(tree_map_with_path(lambda path, _: by_path[path],
                                            params[i]))
        return ([t.detach() for t in losses],
                [{k_: v.detach() for k_, v in m.items()} for m in metrics],
                join(mesh, ctx.replica_sum(trees, specs)))

    return grad_fn


def _data_index(ctx, i: int) -> int:
    """Position ``i``'s index over the data axes (row-major)."""
    idx = 0
    for a in ctx.data_axes:
        idx = idx * ctx.mesh.shape[a] + ctx.mesh.axis_index(a, i)
    return idx


def _microbatch(ctx, batch, k: int, n_mb: int):
    """Microbatch ``k`` of ``n_mb``, one dict a position: rows [k·B/n,
    (k+1)·B/n) of the global batch, split over the data axes (a placed
    batch is gathered over them first)."""
    if isinstance(batch, dict):
        return {key: v.reshape((n_mb, -1) + v.shape[1:])[k]
                for key, v in batch.items()}
    mesh = ctx.mesh
    out = [dict() for _ in range(mesh.size)]
    for key in batch[0]:
        xs = [b[key] for b in batch]
        if ctx.dp > 1:
            xs = all_gather_cat(mesh, ctx.data_axes, xs, 0)
        for i, x in enumerate(xs):
            rows = x.shape[0] // n_mb
            mine = rows // ctx.dp
            lo = k * rows + _data_index(ctx, i) * mine
            out[i][key] = x[lo:lo + mine]
    return out


def _mesh_train_step(model: AnyModel, loop: TrainLoopConfig, ctx,
                     donate: bool) -> Callable:
    mesh = ctx.mesh
    n = mesh.size
    grad_fn = make_grad_fn(model, ctx=ctx)
    axes = tuple(mesh.axis_names)

    def step_fn(state, batch):
        params = [st["params"] for st in state]
        specs = model.mesh_specs(ctx)
        if loop.microbatches > 1:
            n_mb = loop.microbatches
            acc = loss = None
            for k in range(n_mb):
                mb_loss, _, grads = grad_fn(params,
                                            _microbatch(ctx, batch, k, n_mb))
                part = ctx.map(lambda g: tree_map(
                    lambda t: t.float() / n_mb, g), grads)
                mb_loss = ctx.map(lambda t: t / n_mb, mb_loss)
                acc = part if acc is None else ctx.map(
                    lambda a, b: tree_map(torch.add, a, b), acc, part)
                loss = mb_loss if loss is None else ctx.map(torch.add, loss,
                                                            mb_loss)
            grads, metrics = acc, [{} for _ in range(n)]
        else:
            loss, metrics, grads = grad_fn(params, batch)
        new_compress = None
        if loop.compression:
            residuals = [st.get("compress") for st in state]
            grads, new_compress, cmetrics = compress_gradients_mesh(
                ctx, grads, None if None in residuals else residuals,
                specs, keep_frac=loop.compression_keep_frac)
            metrics = ctx.map(lambda m, c: {**m, **c}, metrics, cmetrics)

        # the logical gradient's norm: each distinct block once, the
        # positions' sums added over the whole mesh in a fixed order
        order = []
        tree_map_with_path(lambda path, _, sp: order.append((path, sp)),
                           params[0], specs)

        def sq_norm(i, g):
            flat = dict(leaves_with_paths(g))
            terms = [torch.sum(flat[p].float() ** 2) for p, sp in order
                     if is_representative(sp, mesh, i)]
            return torch.stack(terms).sum() if terms else \
                torch.zeros((), device=flat[order[0][0]].device)

        gn = ctx.map(torch.sqrt, psum(mesh, axes, ctx.map(
            sq_norm, list(range(n)), grads)))
        lr = ctx.map(lambda st: warmup_cosine(
            st["step"], peak_lr=loop.optimizer.lr,
            warmup_steps=loop.warmup_steps, total_steps=loop.total_steps),
            state)
        done: dict = {}  # a block several positions share: updated once

        def update(st, g, norm, rate):
            count = st["opt"]["count"] + 1
            upd = leaf_update(loop.optimizer, count, rate,
                              clip_scale(norm, loop.optimizer.grad_clip),
                              donate)

            def leaf(path, p, gr, mu, nu):
                # the storage itself, not its address: every meta
                # tensor's data_ptr() is 0
                key = (p.device, p.untyped_storage()._cdata,
                       p.storage_offset(), tuple(p.shape), p.stride(), path)
                if key not in done:
                    done[key] = upd(path, p, gr, mu, nu)
                return done[key]

            new_p, mu, nu = tree_unzip(leaf, 3, st["params"], g,
                                       st["opt"]["mu"], st["opt"]["nu"])
            return ({"params": new_p,
                     "opt": {"mu": mu, "nu": nu, "count": count},
                     "step": st["step"] + 1},
                    {"lr": rate, "grad_norm": norm})

        new_state, extra = ctx.map(update, state, grads, gn, lr)
        if new_compress is not None:
            for st, c in zip(new_state, new_compress):
                st["compress"] = c
        return join(mesh, new_state), join(mesh, ctx.map(
            lambda lo, m, e: {"loss": lo, **e, **m}, loss, metrics, extra))

    return step_fn


def make_serve_step(model: AnyModel, ctx=None) -> Callable:
    """One decode step: greedy next token + updated caches.

    When ``batch`` carries an ``active`` (B,) bool mask (continuous
    batching), inactive slots keep their whole decode state frozen
    (``model.merge_decode_state``): positions, caches and recurrent states
    see no trace of the masked step, as the reference's ``serve_fn``.

    On a mesh (``ctx``) ``params``, ``decode_state`` and ``batch`` are
    lists with one entry a position, and so are the tokens and the new
    state: tensor-parallel over the model axis where it has more than one
    position (``model.decode_step(..., ctx)``; the dry run's production
    contexts also split the batch over the data axes, with the params
    replicated there), else each position's own step."""
    def finish(logits, new_state, state, active):
        if active is not None:
            new_state = model.merge_decode_state(new_state, state, active)
        return torch.argmax(logits[:, -1], dim=-1), new_state

    def split(b):
        return {k: v for k, v in b.items() if k != "active"}, b.get("active")

    def serve_fn(params, decode_state, batch):
        if ctx is None:
            feed, active = split(batch)
            logits, new_state = model.decode_step(params, decode_state, feed)
            return finish(logits, new_state, decode_state, active)
        feeds, actives = ctx.map(split, batch)
        if tensor_parallel(model.cfg, ctx):
            logits, new_states = model.decode_step(params, decode_state,
                                                   feeds, ctx)
            return ctx.map(finish, logits, new_states, decode_state, actives)
        return ctx.map(lambda p, st, b, a: finish(
            *model.decode_step(p, st, b), st, a), params, decode_state,
            feeds, actives)

    return serve_fn


class _Positions:
    """Where a serving step runs: in the caller's order (``ctx`` None or
    without a model axis) or on every position of a serve mesh, where an
    argument is a list with one entry a position."""

    def __init__(self, ctx):
        self.ctx = ctx if ctx is not None and ctx.tp > 1 else None

    def spread(self, x):
        """A host input made in the caller's order, for every position."""
        if self.ctx is None:
            return x
        if x is None:
            return [None] * self.ctx.mesh.size
        return replicate(self.ctx.mesh, x)

    def map(self, fn, *args):
        return fn(*args) if self.ctx is None else self.ctx.map(fn, *args)

    def collect(self, xs):
        """Position 0's result, for the caller."""
        return xs if self.ctx is None else take(self.ctx.mesh, xs, 0)


def make_decode_macro_step(model: AnyModel, horizon: int, *, eos_id: int,
                           pad_id: int, ctx=None) -> Callable:
    """K lockstep greedy decode steps per host consultation.

    Returns ``macro_fn(params, state, tok, active, budget,
    block_tables=None) -> (emitted (B, K), new_state)``: ``tok`` is each
    slot's last token, ``active`` the live slot mask and ``budget`` the
    per-slot remaining token allowance, all device tensors.  A slot that
    emits ``eos_id`` or exhausts its budget is masked for the rest of the
    macro-step (state frozen, emissions padded with ``pad_id``); an active
    slot's EOS is emitted, then it goes quiet.  ``block_tables`` (B,
    max_blocks) addresses a paged state's pools; a masked row's table is
    zeroed for the step, so its writes land in the null page (its pages
    may already belong to another request).  An mrope model's positions
    come from each slot's device position (``mrope_positions``), with no
    host-built tensor.  On a serve mesh (``ctx``) ``params`` and ``state``
    are per-position lists and the emitted tokens are position 0's.
    """
    k_steps = max(int(horizon), 1)
    mrope = model.cfg.pos_type == "mrope"

    def feed_batch(st, tk, act, bt):
        feed = torch.where(act, tk, pad_id)[:, None]
        batch = {"tokens": feed}
        if bt is not None:
            batch["block_tables"] = torch.where(act[:, None], bt, 0)
        if mrope:
            batch["positions"] = mrope_positions(feed.shape[0], 1, st["pos"])
        return batch

    def advance(logits, new_st, st, tk, act, bud):
        new_st = model.merge_decode_state(new_st, st, act)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        emit = torch.where(act, nxt, pad_id)
        bud = bud - act.long()
        new_act = act & (nxt != eos_id) & (bud > 0)
        return new_st, torch.where(act, nxt, tk), new_act, bud, emit

    def macro_fn(params, state, tok, active, budget, block_tables=None):
        on = _Positions(ctx)
        tk, act, bud, bt = (on.spread(t) for t in (tok, active, budget,
                                                   block_tables))
        st = state
        emitted = []
        for _ in range(k_steps):
            batch = on.map(feed_batch, st, tk, act, bt)
            logits, new_st = model.decode_step(params, st, batch,
                                               ctx=on.ctx)
            st, tk, act, bud, emit = on.map(advance, logits, new_st, st, tk,
                                            act, bud)
            emitted.append(emit)
        return on.collect(on.map(lambda *e: torch.stack(e, dim=1),
                                 *emitted)), st

    return macro_fn


def make_batched_prefill(model: AnyModel, ctx=None) -> Callable:
    """Lower a whole padded prompt group into a per-slot decode state:
    a loop over fixed-width chunks through the same ``decode_step`` forward
    the decode path runs, with per-slot activity masks (slots not being
    prefilled stay frozen), per-row TRUE-length position advance for ragged
    groups, and on-device capture of each row's first generated token at
    its own last prompt position.  Pad garbage lands only at cache
    positions beyond each row's advance limit, where the causal
    ``decode_attention`` mask never reads it before a real write.

    ``prefill_fn(params, state, chunks, lengths, starts=None,
    block_tables=None) -> (first_tok (B,), state)`` with ``chunks``
    (n_chunks, B, c) padded prompt chunks and ``lengths`` (B,) true prompt
    lengths (0 marks a slot not prefilled).

    After a radix prefix-cache hit, ``chunks``/``lengths`` carry only the
    SUFFIX tokens and ``starts`` (B,) gives each prefilled row's first
    logical position (its hit length): positions, cache writes and the
    length limit all continue from the reused prefix.  ``block_tables``
    routes paged cache writes; rows not being prefilled get their table
    row zeroed, so their masked writes land in the null page.  An mrope
    model's positions for each chunk come from each row's position.  On a
    serve mesh (``ctx``) ``params`` and ``state`` are per-position lists
    and the first tokens are position 0's.
    """
    mrope = model.cfg.pos_type == "mrope"

    def start_at(st, lengths, starts):
        st = dict(st)
        st["pos"] = torch.where(lengths > 0, starts, st["pos"])
        return st

    def chunk_batch(off, st, chunks, lengths, bt):
        b, c = chunks.shape[1:]
        valid = torch.clamp(lengths - off, 0, c)  # true tokens this chunk
        act = valid > 0
        batch = {"tokens": chunks[off // c]}
        if bt is not None:
            batch["block_tables"] = torch.where(act[:, None], bt, 0)
        if mrope:
            batch["positions"] = mrope_positions(b, c, st["pos"])
        return valid, act, batch

    def chunk_done(off, logits, new_st, st, valid, act, lengths, first):
        b, c = logits.shape[:2]
        new_st = model.merge_decode_state(new_st, st, act)
        # decode_step advanced active rows by the full chunk width;
        # ragged rows only consumed ``valid`` prompt tokens
        new_st["pos"] = torch.where(act, st["pos"] + valid, st["pos"])
        done_now = act & (lengths <= off + c)
        at = torch.clamp(valid - 1, min=0)[:, None, None]
        last = torch.gather(logits, 1,
                            at.expand(b, 1, logits.shape[-1]))[:, 0]
        return new_st, torch.where(done_now, torch.argmax(last, dim=-1),
                                   first)

    def prefill_fn(params, state, chunks, lengths, starts=None,
                   block_tables=None):
        on = _Positions(ctx)
        n_chunks, b, c = chunks.shape
        chs, lens, bt = (on.spread(t) for t in (chunks, lengths,
                                                block_tables))
        st = state
        if starts is not None:
            st = on.map(start_at, st, lens, on.spread(starts))
        first = on.map(lambda ln: torch.zeros((b,), dtype=torch.int64,
                                              device=ln.device), lens)
        for i in range(n_chunks):
            off = i * c
            valid, act, batch = on.map(
                lambda *a, _off=off: chunk_batch(_off, *a), st, chs, lens,
                bt)
            logits, new_st = model.decode_step(params, st, batch,
                                               ctx=on.ctx)
            st, first = on.map(
                lambda *a, _off=off: chunk_done(_off, *a), logits, new_st,
                st, valid, act, lens, first)
        return on.collect(first), st

    return prefill_fn
