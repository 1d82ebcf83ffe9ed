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

``moe_apply`` runs ``moe_dense``; expert parallelism over several devices
(the reference's ``moe_ep`` and its ``moe_dispatch`` query) needs several
GPUs and raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, epilogue_of, is_glu, project

_MULTI_GPU = ("expert parallelism over several devices (moe_ep, the "
              "moe_dispatch query) needs several GPUs; it is on the port's "
              "multi-GPU queue (ROADMAP.md), not in this slice")


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


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss, E * sum_e f_e * p_e: p_e the mean
    router probability of expert e, f_e its share of the top-k picks.  A
    0-d fp32 tensor."""
    p_mean = _softmax(logits).reshape(-1, n_experts).mean(dim=0)
    picks = ids.reshape(-1)
    # counts are exact in fp32; bincount would read its maximum on the host
    f = torch.zeros((n_experts,), dtype=torch.float32,
                    device=ids.device).index_add_(
        0, picks, torch.ones(picks.shape, dtype=torch.float32,
                             device=ids.device))
    f = f / torch.clamp(f.sum(), min=1.0)
    return n_experts * torch.sum(f * p_mean)


def moe_dense(params, x: torch.Tensor, *, top_k: int, activation: str,
              aux: bool = True):
    """Every expert for every token, combined by the renormalised top-k
    router weights (the module docstring gives the layout and the order of
    the sums).  Returns (y like ``x``, the load-balance loss, or None when
    ``aux`` is False)."""
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
    loss = load_balance_loss(logits, ids, n_experts) if aux else None
    return y.reshape(b, s, d), loss


def moe_apply(params, x: torch.Tensor, *, top_k: int, activation: str,
              ctx=None, aux: bool = True):
    """The reference's dispatch: expert parallelism under a context whose
    mesh has more than one device on its model axis (raises here: it needs
    several GPUs), ``moe_dense`` otherwise."""
    if ctx is not None and getattr(ctx, "use_ep", False) and \
            ctx.mesh.shape.get(ctx.model_axis, 1) > 1:
        raise NotImplementedError(_MULTI_GPU)
    return moe_dense(params, x, top_k=top_k, activation=activation, aux=aux)
