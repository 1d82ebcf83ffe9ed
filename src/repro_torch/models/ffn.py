"""Feed-forward blocks: the dense FFN (GLU or plain) and the mixture of
experts, on the matmul kernel.

The dense FFN's activation runs fused into the kernel's epilogue (SwiGLU:
``silu(x @ w_gate)`` in one launch); ``w_in`` of a GLU and ``w_out`` are
plain projections.

The mixture of experts is the reference's ``moe_dense`` (every expert for
every token, combined by the renormalised top-k router weights), in the
form that keeps every product a 2-D launch of the matmul kernel: the
experts lie side by side.  ``w_in`` and ``w_gate`` are (D, E*F), expert e
in columns [e*F, (e+1)*F); ``w_out`` is (E*F, D), expert e in rows [e*F,
(e+1)*F).  So ``x @ w_gate`` (SiLU fused) and ``x @ w_in`` are each
``einsum("td,edf->tef")`` in one launch, with N = E*F.  The routing weights
are folded in before the down projection: ``(h * w_te) @ w_out`` is one
launch with K = E*F, and the sum over the experts runs in the kernel's
fp32 accumulator, in one fixed k order, together with the sum over F.
The reference instead rounds each expert's output ``y_all`` (T, E, D) to
the weights' dtype and then sums ``y_all * w`` over E.  In fp32 the two
differ only in the order of the sums.  In bf16 the port rounds ``h * w``
where the reference rounds ``y_all``, and the SiLU runs on the fp32
accumulator where the reference's runs on the rounded product; each
rounds the output once.  Unselected experts have weight 0 in both.

Batch invariance (static and continuous serving give the same tokens in
bf16): every product is the matmul kernel's, whose path and tile depend
on the dtypes and N alone.  The router's softmax and the renormalisation
sum with a column of ones on the kernel's FMA path (one fixed order per
row), as ``rmsnorm`` does; top-k and the scatter of the weights are exact.

Expert parallelism on a training mesh is the reference's ``moe_ep``
(``moe_ep`` here, over a ``ShardingCtx``'s lists of per-position
tensors): tokens split over the data axes and replicated over the model
axis, each model rank holding a contiguous block of ``E / tp`` experts.  A
rank gathers the (token, k) assignments that hit its experts into a fixed
``(E_loc, capacity, D)`` slot buffer, filled in flattened (token, k) order;
assignments past an expert's capacity are dropped, exactly as the
reference drops them.  The expert products are the matmul kernel's 4-D
batched form on ``(E_loc, D, F)`` views of the side-by-side leaves (no
copy: a batch stride of F, a row stride of E_loc*F); each rank's fp32
partial output is summed over the model axis in fp32 (``row_sum``) and
rounded once.  The load-balance loss replays the router over the global
tokens (its statistics summed over the data axes).  ``moe_ep_plain`` is
the same function on one device, for the tests and the card's check.
``moe_apply`` asks the cost engine's ``moe_dispatch`` site first and
records the reference's advisory row when the engine prefers all-to-all.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, epilogue_of, is_glu, project


def ffn_init(gen: torch.Generator, d: int, f: int, activation: str,
             dtype=torch.float32) -> dict:
    p = {"w_in": dense_init(gen, d, f, dtype),
         "w_out": dense_init(gen, f, d, dtype)}
    if is_glu(activation):
        p["w_gate"] = dense_init(gen, d, f, dtype)
    return p


def ffn_apply(params, x: torch.Tensor, activation: str,
              out_dtype=None) -> torch.Tensor:
    """The dense FFN, its output in ``out_dtype`` (default ``x.dtype``): on
    a serve mesh one position's column block of ``w_in``/``w_gate`` and
    row block of ``w_out`` give an fp32 partial of the output."""
    act = epilogue_of(activation)
    if is_glu(activation):
        h = project(x, params["w_gate"], activation=act) * project(
            x, params["w_in"])
    else:
        h = project(x, params["w_in"], activation=act)
    return project(h, params["w_out"], out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


def _experts_init(gen: torch.Generator, fan_in: int, fan_out: int,
                  n_experts: int, dtype, side_by_side: bool) -> torch.Tensor:
    """E fan-in scaled (fan_in, fan_out) experts, drawn one at a time (a
    qwen3-moe tensor of all experts is 805 M values, 3.2 GB in fp32): side
    by side in columns, (fan_in, E*fan_out), or stacked in rows, (E*fan_in,
    fan_out)."""
    shape = (fan_in, n_experts * fan_out) if side_by_side else \
        (n_experts * fan_in, fan_out)
    w = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(n_experts):
        part = w[:, e * fan_out:(e + 1) * fan_out] if side_by_side else \
            w[e * fan_in:(e + 1) * fan_in]
        part.copy_(dense_init(gen, fan_in, fan_out, dtype))
    return w


def moe_init(gen: torch.Generator, d: int, f: int, n_experts: int,
             activation: str, dtype=torch.float32) -> dict:
    """The router (d, E), always fp32; ``w_in`` and ``w_gate`` (d, E*f) and
    ``w_out`` (E*f, d) in ``dtype``, each expert drawn as the reference
    draws it (normal, scaled by 1/sqrt(fan-in))."""
    p = {"router": dense_init(gen, d, n_experts, torch.float32),
         "w_in": _experts_init(gen, d, f, n_experts, dtype, True),
         "w_out": _experts_init(gen, f, d, n_experts, dtype, False)}
    if is_glu(activation):
        p["w_gate"] = _experts_init(gen, d, f, n_experts, dtype, True)
    return p


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of fp32 ``t``, keeping it: a product with a
    column of ones on the matmul kernel, in one fixed order per row."""
    ones = torch.ones((t.shape[-1], 1), dtype=torch.float32, device=t.device)
    lead = t.shape[:-1]
    return ops.matmul(t.reshape(-1, t.shape[-1]), ones).reshape(lead + (1,))


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in fp32: exp(l - max) / sum."""
    z = logits.float()
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    return e / _row_sum(e)


def _router_topk(logits: torch.Tensor, k: int):
    """(weights, ids) of the top ``k`` router probabilities, renormalised
    by ``max(sum, 1e-9)``.  Ties go to either index: ``torch.topk`` does
    not promise the lower one, as ``lax.top_k`` does."""
    w, ids = torch.topk(_softmax(logits), k, dim=-1)
    return w / torch.clamp(_row_sum(w), min=1e-9), ids


def _picks(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(E,) fp32 count of each expert's top-k picks (exact in fp32;
    bincount would read its maximum on the host)."""
    picks = ids.reshape(-1)
    return torch.zeros((n_experts,), dtype=torch.float32,
                       device=ids.device).index_add_(
        0, picks, torch.ones(picks.shape, dtype=torch.float32,
                             device=ids.device))


def _balance(p_mean: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    n_experts = counts.shape[0]
    f = counts / torch.clamp(counts.sum(), min=1.0)
    return n_experts * torch.sum(f * p_mean)


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss, E * sum_e f_e * p_e: p_e the mean
    router probability of expert e, f_e its share of the top-k picks.  A
    0-d fp32 tensor."""
    p_mean = _softmax(logits).reshape(-1, n_experts).mean(dim=0)
    return _balance(p_mean, _picks(ids, n_experts))


def moe_dense(params, x: torch.Tensor, *, top_k: int, activation: str,
              aux: bool = True):
    """Every expert for every token, combined by the renormalised top-k
    router weights (the module docstring gives the layout and the order of
    the sums).  Returns (y like ``x``, the load-balance loss, or None when
    ``aux`` is False)."""
    y, logits, ids = _moe_dense(params, x, top_k=top_k,
                                activation=activation)
    n_experts = params["router"].shape[1]
    return y, load_balance_loss(logits, ids, n_experts) if aux else None


def _moe_dense(params, x: torch.Tensor, *, top_k: int, activation: str):
    """``moe_dense``'s output, router logits (T, E) fp32 and top-k ids."""
    b, s, d = x.shape
    t = x.reshape(-1, d)
    router = params["router"]
    n_experts = router.shape[1]
    logits = ops.matmul(t.float(), router)  # (T, E) fp32
    w, ids = _router_topk(logits, top_k)
    act = epilogue_of(activation)
    if is_glu(activation):
        h = project(t, params["w_gate"], activation=act) * project(
            t, params["w_in"])
    else:
        h = project(t, params["w_in"], activation=act)
    combine = torch.zeros((t.shape[0], n_experts), dtype=h.dtype,
                          device=h.device).scatter(1, ids, w.to(h.dtype))
    h = (h.reshape(t.shape[0], n_experts, -1) * combine[..., None]).reshape(
        t.shape[0], -1)
    y = project(h, params["w_out"])
    return y.reshape(b, s, d), logits, ids


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def moe_capacity(t_local: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots per expert of the EP path (the reference's ``moe_ep``):
    ``capacity_factor`` times the balanced load of ``t_local`` tokens,
    rounded up to 8, or to 128 from 128 on."""
    raw = int(t_local * top_k / n_experts * capacity_factor)
    return _round_up(max(raw, 8), 128 if raw >= 128 else 8)


def _expert_block(params, rank: int, e_loc: int):
    """Rank ``rank``'s block of ``e_loc`` experts of whole side-by-side
    leaves (for ``moe_ep_plain``): column blocks of w_in/w_gate, a row
    block of w_out."""
    f = params["w_in"].shape[1] // params["router"].shape[1]
    cols = slice(rank * e_loc * f, (rank + 1) * e_loc * f)
    block = {"router": params["router"], "w_in": params["w_in"][:, cols],
             "w_out": params["w_out"][cols]}
    if "w_gate" in params:
        block["w_gate"] = params["w_gate"][:, cols]
    return block


def _moe_local(t: torch.Tensor, params, rank: int, *, e_loc: int,
               top_k: int, capacity: int, activation: str):
    """One model rank's body of the EP path (the reference's
    ``_moe_local``): ``t`` (T, D) its data shard's tokens, ``params`` its
    experts ``rank * e_loc`` on (w_in/w_gate (D, e_loc*F), w_out
    (e_loc*F, D)) and the whole router.  Returns (its fp32 partial of the
    output (T, D), the router logits (T, E) fp32, the top-k ids, the count
    of its assignments dropped past capacity)."""
    n_tok, d = t.shape
    lo = rank * e_loc
    logits = ops.matmul(t.float(), params["router"])  # (T, E) fp32
    w, ids = _router_topk(logits, top_k)
    flat_ids = ids.reshape(-1)
    flat_w = w.reshape(-1).to(t.dtype)  # the reference rounds to t's dtype
    local = (flat_ids >= lo) & (flat_ids < lo + e_loc)
    e_idx = torch.where(local, flat_ids - lo, e_loc)  # e_loc: overflow bin
    # each assignment's slot in its expert's buffer, in (token, k) order
    one_hot = F.one_hot(e_idx, e_loc + 1)
    within = one_hot.cumsum(0).gather(1, e_idx[:, None])[:, 0] - 1
    keep = local & (within < capacity)
    slot_e = torch.where(keep, e_idx, e_loc)  # dropped -> the overflow row
    slot_c = torch.where(keep, within, 0)
    tok = torch.arange(flat_ids.shape[0], device=t.device) // top_k
    buf = torch.zeros((e_loc + 1, capacity, d), dtype=t.dtype,
                      device=t.device)
    buf = torch.index_put(buf, (slot_e, slot_c), t[tok])[:e_loc]
    # (E_loc, D, F) and (E_loc, F, D) views of the side-by-side leaves, no
    # copy: the 4-D kernel reads them through their strides
    f = params["w_in"].shape[1] // e_loc

    def experts_in(w_):
        return w_.reshape(d, e_loc, f).permute(1, 0, 2)[None]

    act = epilogue_of(activation)
    xs = buf[None]
    if is_glu(activation):
        h = ops.matmul(xs, experts_in(params["w_gate"]), activation=act) \
            * ops.matmul(xs, experts_in(params["w_in"]))
    else:
        h = ops.matmul(xs, experts_in(params["w_in"]), activation=act)
    out = ops.matmul(h, params["w_out"].reshape(e_loc, f, d)[None],
                     out_dtype=torch.float32)[0]  # (E_loc, C, D) fp32
    # combine: each kept assignment's row, weighted, summed over its
    # token's k in order (a token's assignments are contiguous)
    gate = torch.where(keep, flat_w, 0).float()
    rows = out[torch.where(keep, slot_e, 0), slot_c]
    y = (rows * gate[:, None]).reshape(n_tok, top_k, d).sum(1)
    return y, logits, ids, (local & ~keep).sum()


def _router_stats(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(2E + 1,) fp32: the router probabilities summed over the tokens,
    each expert's pick count and the token count, which add up over data
    shards to the global tokens' (the reference's router replay)."""
    n_tok, n_experts = logits.shape
    return torch.cat([_softmax(logits).sum(0), _picks(ids, n_experts),
                      torch.full((1,), float(n_tok), device=logits.device)])


def _aux_of(stats: torch.Tensor) -> torch.Tensor:
    e = (stats.shape[0] - 1) // 2
    return _balance(stats[:e] / torch.clamp(stats[-1], min=1.0),
                    stats[e:2 * e])


def moe_ep(ctx, params: List[dict], xs: List[torch.Tensor], *, top_k: int,
           activation: str, capacity_factor: Optional[float] = None):
    """Expert parallelism over ``ctx``'s model axis (the reference's
    ``moe_ep``): ``params`` each position's leaves (its expert block, the
    whole router), ``xs`` each position's (B_loc, S, D) tokens (its data
    shard, replicated over the model axis).  Returns (y like each x, the
    load-balance loss over the global tokens, each position's count of
    dropped assignments), lists with one entry a position."""
    n_experts = params[0]["router"].shape[1]
    ep = ctx.tp
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts do not split over a model "
                         f"axis of {ep}")
    e_loc = n_experts // ep
    b, s, d = xs[0].shape
    capacity = moe_capacity(b * s, top_k, n_experts,
                            ctx.moe_capacity_factor if capacity_factor is None
                            else capacity_factor)
    ranks = [ctx.rank(i) for i in range(ctx.mesh.size)]
    ys, logits, ids, dropped = ctx.map(
        lambda p, x, r: _moe_local(x.reshape(-1, d), p, r, e_loc=e_loc,
                                   top_k=top_k, capacity=capacity,
                                   activation=activation),
        params, xs, ranks)
    ys = ctx.row_sum(ys, xs[0].dtype) if ep > 1 else \
        ctx.map(lambda y: y.to(xs[0].dtype), ys)
    auxs = ctx.map(_aux_of, ctx.data_psum(ctx.map(_router_stats, logits,
                                                  ids)))
    return ctx.map(lambda y: y.reshape(b, s, d), ys), auxs, dropped


def moe_ep_plain(params, x: torch.Tensor, *, top_k: int, activation: str,
                 ep: int, dp: int = 1, capacity_factor: float = 1.25):
    """``moe_ep`` on one device, for the tests and the card's check: the
    rows of ``x`` (B, S, D) split into ``dp`` data shards, each through the
    ``ep`` ranks' expert blocks of the whole leaves with the same capacity
    rule, the ranks' fp32 partials added in rank order.  Returns (y, the
    load-balance loss, the count of dropped assignments)."""
    n_experts = params["router"].shape[1]
    e_loc = n_experts // ep
    b, s, d = x.shape
    capacity = moe_capacity(max(b // dp, 1) * s, top_k, n_experts,
                            capacity_factor)
    ys, stats, dropped = [], 0.0, 0
    for shard in x.chunk(dp, 0):
        t = shard.reshape(-1, d)
        acc = None
        for r in range(ep):
            y, logits, ids, drop = _moe_local(
                t, _expert_block(params, r, e_loc), r, e_loc=e_loc,
                top_k=top_k, capacity=capacity, activation=activation)
            acc = y if acc is None else acc + y
            dropped = dropped + drop
        stats = stats + _router_stats(logits, ids)
        ys.append(acc.to(x.dtype).reshape(shard.shape))
    return torch.cat(ys, 0), _aux_of(stats), dropped


def moe_apply(params, x, *, top_k: int, activation: str, ctx=None,
              aux: bool = True):
    """The reference's dispatch: expert parallelism under a context whose
    mesh has more than one position on its model axis (``params`` and
    ``x`` then lists with one entry a position), ``moe_dense`` otherwise.

    The EP collective (replicated psum or all-to-all) is the cost engine's
    ``moe_dispatch`` site, asked at the mesh's distinct devices along the
    model axis; only the psum is implemented, so an all-to-all verdict is
    advisory and ledgered as such, as in the reference.  On a mesh without
    a model axis each position runs ``moe_dense`` on its tokens and the
    load-balance loss is the global tokens' (``aux`` is always computed
    there); a single tensor under such a context is ``moe_dense``'s, as in
    the reference.  Turning expert parallelism off (``use_ep=False``) on a
    model axis raises: the specs split the experts over it."""
    tp = 1 if ctx is None else ctx.mesh.shape.get(ctx.model_axis, 1)
    if ctx is None or (tp <= 1 and torch.is_tensor(x)):
        return moe_dense(params, x, top_k=top_k, activation=activation,
                         aux=aux)
    if ctx.use_ep and tp > 1:
        from repro_torch.core.costs.engine import resolve_engine

        b, s, d = x[0].shape
        engine = resolve_engine(ctx.cost_engine)
        dec = engine.decide_moe_dispatch(
            b * s, d, top_k=top_k, ep_shards=ctx.tp,
            dtype_bytes=x[0].element_size(),
            devices=ctx.mesh.distinct_devices(ctx.model_axis))
        if dec.choice != "replicated_psum":
            engine.ledger.record(
                "moe_dispatch", dec.query.as_dict(), "replicated_psum",
                dec.baseline, note=f"engine prefers {dec.choice}; psum is "
                f"the implemented EP path")
        ys, auxs, _ = moe_ep(ctx, params, x, top_k=top_k,
                             activation=activation)
        return ys, auxs
    if tp > 1:
        raise NotImplementedError(
            "a mixture of experts on a model axis without expert "
            "parallelism (use_ep=False) is not ported: the specs split the "
            "experts over the model axis")

    def dense(p, t):
        y, logits, ids = _moe_dense(p, t, top_k=top_k, activation=activation)
        return y, _router_stats(logits, ids)

    ys, stats = ctx.map(dense, params, x)
    return ys, ctx.map(_aux_of, ctx.data_psum(stats))
