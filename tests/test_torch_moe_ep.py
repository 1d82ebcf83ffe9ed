"""Expert parallelism (``models/ffn.py``: ``moe_ep``, ``_moe_local``,
``moe_capacity``, ``moe_ep_plain``, ``moe_apply`` under a context) against
the reference's ``moe_ep`` on a ``{"data": 2, "model": 4}`` mesh, on the
CPU (``make_mesh(..., device="cpu", shards_per_device=8)``).

* the reference's ``moe_ep`` runs once, in a subprocess on an
  ``AxisType.Auto`` mesh of 8 forced host devices
  (``torch_mesh_reference.run_reference``), on the reference test's
  setup (``tests/test_distributed.py::test_moe_ep_matches_dense_oracle``:
  d 32, F 64, 8 experts, top 2, SwiGLU, x (4, 16, 32)) at capacity factor
  8.0, where nothing drops, and at 1.0, where it drops; the subprocess
  counts the drops from the reference's own routing (``_router_topk``)
  and capacity rule (``_round_up``), slots filled in flattened (token, k)
  order;
* the port's ``moe_ep`` on the CPU mesh: output within 1e-5 x max|y| and
  the load-balance loss within rtol 1e-5 of the reference's (fp32, other
  orders of sums; the reference test's 1e-4), the same drop count;
* ``moe_ep_plain`` (one device, the same capacity rule) against the
  reference's ``moe_ep`` the same way;
* the capacity rule at every size class, autograd through ``moe_ep``
  against autograd through ``moe_ep_plain``, and ``moe_apply`` asking the
  engine's ``moe_dispatch`` site (the reference's advisory row where the
  engine prefers all-to-all);
* on a card only (``cuda`` marker): ``moe_ep`` on 8 positions of GPU 0
  against ``moe_ep_plain`` on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_reference import needs_reference, run_reference  # noqa: E402

from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.distributed import make_mesh, take  # noqa: E402
from repro_torch.hw import H100  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ShardingCtx,
    place_tree,
    unplace_tree,
)
from repro_torch.models import ffn  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

D, F_, E, TOPK = 32, 64, 8, 2
XSHAPE = (4, 16, D)
CFS = (8.0, 1.0)
Y_RTOL = 1e-5  # x max|y|: fp32, other orders of sums
SPECS = {"router": (None, None), "w_in": (None, "model"),
         "w_gate": (None, "model"), "w_out": ("model", None)}
XSPEC = {"x": ("data", None, None)}

_REFERENCE = """
from repro.models import ffn as ffn_lib

mesh = auto_mesh((2, 4), ("data", "model"))
params = ffn_lib.moe_init(jax.random.PRNGKey(1), %d, %d, %d, "swiglu")
x = jax.random.normal(jax.random.PRNGKey(2), %r)
for k, v in params.items():
    OUT[f"p/{k}"] = v
OUT["x"] = x
b, s, d = x.shape
for cf in %r:
    y, aux = ffn_lib.moe_ep(params, x, top_k=%d, activation="swiglu",
                            mesh=mesh, data_axes=("data",),
                            capacity_factor=cf)
    OUT[f"y/{cf}"], OUT[f"aux/{cf}"] = y, aux
    # the drops, from the reference's routing and capacity rule
    t_local = max(b // 2, 1) * s
    raw = int(t_local * %d / %d * cf)
    cap = ffn_lib._round_up(max(raw, 8), 128 if raw >= 128 else 8)
    dropped = 0
    for shard in np.split(np.asarray(x), 2, axis=0):
        t = jnp.asarray(shard.reshape(-1, d))
        logits = t.astype(jnp.float32) @ params["router"]
        _, ids = ffn_lib._router_topk(logits, %d)
        counts = {}
        for e in np.asarray(ids).reshape(-1):
            counts[int(e)] = counts.get(int(e), 0) + 1
        dropped += sum(max(c - cap, 0) for c in counts.values())
    OUT[f"dropped/{cf}"] = np.array(dropped)
    OUT[f"capacity/{cf}"] = np.array(cap)
""" % (D, F_, E, XSHAPE, CFS, TOPK, TOPK, E, TOPK)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep_ref") / "out.npz"
    return run_reference(_REFERENCE, out)


def _port_params(reference):
    """The reference's (E, D, F) / (E, F, D) experts side by side, as
    ``convert.py`` lays them out: (D, E*F) and (E*F, D)."""
    w = {k[2:]: torch.from_numpy(np.asarray(v)) for k, v in
         reference.items() if k.startswith("p/")}
    e, d, f = w["w_in"].shape
    return {"router": w["router"],
            "w_in": w["w_in"].permute(1, 0, 2).reshape(d, e * f),
            "w_gate": w["w_gate"].permute(1, 0, 2).reshape(d, e * f),
            "w_out": w["w_out"].reshape(e * f, d)}


def _ctx(engine=None):
    mesh = make_mesh({"data": 2, "model": 4}, device="cpu",
                     shards_per_device=8)
    return ShardingCtx(mesh=mesh, data_axes=("data",), cost_engine=engine)


def _on_mesh(ctx, params, x):
    return (place_tree(ctx.mesh, params, SPECS),
            [t["x"] for t in place_tree(ctx.mesh, {"x": x}, XSPEC)])


def _joined(ctx, ys):
    return unplace_tree(ctx.mesh, [{"x": y} for y in ys], XSPEC)["x"]


def _drops(ctx, dropped):
    return sum(int(take(ctx.mesh, dropped, i)) for i in range(ctx.mesh.size))


@needs_reference
@pytest.mark.parametrize("cf", CFS)
def test_moe_ep_matches_reference(reference, cf):
    params = _port_params(reference)
    x = torch.from_numpy(np.asarray(reference["x"]))
    ctx = _ctx()
    pp, xs = _on_mesh(ctx, params, x)
    ys, auxs, dropped = ffn.moe_ep(ctx, pp, xs, top_k=TOPK,
                                   activation="swiglu", capacity_factor=cf)
    want = reference[f"y/{cf}"]
    y = _joined(ctx, ys)
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=Y_RTOL * np.abs(want).max())
    for a in auxs:
        np.testing.assert_allclose(float(a), float(reference[f"aux/{cf}"]),
                                   rtol=1e-5)
    n_drop = int(reference[f"dropped/{cf}"])
    assert _drops(ctx, dropped) == n_drop
    assert (n_drop == 0) == (cf == 8.0), "8.0 drops nothing, 1.0 drops"
    assert ffn.moe_capacity(XSHAPE[0] // 2 * XSHAPE[1], TOPK, E, cf) == \
        int(reference[f"capacity/{cf}"])


@needs_reference
@pytest.mark.parametrize("cf", CFS)
def test_moe_ep_plain_matches_reference(reference, cf):
    params = _port_params(reference)
    x = torch.from_numpy(np.asarray(reference["x"]))
    y, aux, dropped = ffn.moe_ep_plain(params, x, top_k=TOPK,
                                       activation="swiglu", ep=4, dp=2,
                                       capacity_factor=cf)
    want = reference[f"y/{cf}"]
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=Y_RTOL * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(reference[f"aux/{cf}"]),
                               rtol=1e-5)
    assert int(dropped) == int(reference[f"dropped/{cf}"])


@pytest.mark.parametrize("t_local,cf,want", [
    (32, 8.0, 64), (32, 1.0, 8), (1, 1.25, 8), (100, 1.25, 32),
    (512, 1.25, 256), (4096, 1.25, 1280), (96, 10.0, 256), (410, 2.5, 256)])
def test_capacity_rule(t_local, cf, want):
    """cf x the balanced load, at least 8, rounded up to 8, or to 128 from
    128 on (the reference's ``moe_ep``)."""
    assert ffn.moe_capacity(t_local, TOPK, E, cf) == want
    raw = int(t_local * TOPK / E * cf)
    step = 128 if raw >= 128 else 8
    assert want % step == 0 and want >= max(raw, 8) > want - step


def test_moe_ep_gradients_equal_the_plain_version():
    """Autograd through the mesh (the model axis's fp32 row sum, the
    experts' 4-D products, the global router replay) against autograd
    through moe_ep_plain on one device, at a capacity that drops."""
    gen = torch.Generator().manual_seed(0)
    params = ffn.moe_init(gen, D, F_, E, "swiglu")
    x = torch.randn(XSHAPE, generator=gen)

    def loss_of(y, aux):
        return (y * y).sum() + aux

    live = tree_map(lambda t: t.clone().requires_grad_(True), params)
    xl = x.clone().requires_grad_(True)
    y, aux, dropped = ffn.moe_ep_plain(live, xl, top_k=TOPK,
                                       activation="swiglu", ep=4, dp=2,
                                       capacity_factor=1.0)
    assert int(dropped) > 0
    want = torch.autograd.grad(loss_of(y, aux), [xl] + [live[k] for k in
                                                         sorted(live)])
    ctx = _ctx()
    pp, xs = _on_mesh(ctx, params, x)
    pp = [tree_map(lambda t: t.detach().requires_grad_(True), p) for p in pp]
    xs = [t.detach().requires_grad_(True) for t in xs]
    ys, auxs, _ = ffn.moe_ep(ctx, pp, xs, top_k=TOPK, activation="swiglu",
                             capacity_factor=1.0)
    # the mean of every position's copy is the loss (model ranks hold the
    # same data shard: count each once)
    total = sum(loss_of(y_, a) for y_, a in zip(ys, auxs)) / ctx.tp
    grads = torch.autograd.grad(total - sum(auxs) * (1 - 1 / ctx.dp) / ctx.tp,
                                xs + [p[k] for p in pp for k in sorted(p)],
                                allow_unused=True)
    # a position's tokens are its data shard's, replicated over the model
    # axis: their gradient is the sum over the model axis
    gx = unplace_tree(ctx.mesh, ctx.replica_sum(
        [{"x": g} for g in grads[:ctx.mesh.size]], XSPEC), XSPEC)["x"]
    np.testing.assert_allclose(gx.numpy(), want[0].numpy(), rtol=0,
                               atol=1e-5 * want[0].abs().max())
    per = grads[ctx.mesh.size:]
    keys = sorted(params)
    blocks = [{k: per[i * len(keys) + j] for j, k in enumerate(keys)}
              for i in range(ctx.mesh.size)]
    blocks = ctx.replica_sum(blocks, SPECS)
    whole = unplace_tree(ctx.mesh, blocks, SPECS)
    for j, k in enumerate(keys):
        w = want[1 + j]
        np.testing.assert_allclose(whole[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max(), err_msg=k)


@pytest.mark.parametrize("top_k,advisory", [(2, False), (1, True)])
def test_moe_apply_asks_the_engine(top_k, advisory):
    """``moe_apply`` under a context with a model axis asks the
    ``moe_dispatch`` site at the local token count; where the engine
    prefers all-to-all (top 1, on a spec whose collectives cost their
    bytes alone) it records the reference's advisory row, and runs the
    psum path either way."""
    eng = CostEngine(hw=dataclasses.replace(H100, collective_base_s=0.0)
                     if advisory else H100)
    ctx = _ctx(eng)
    gen = torch.Generator().manual_seed(1)
    params = ffn.moe_init(gen, D, F_, E, "swiglu")
    x = torch.randn((4, 512, D), generator=gen)
    pp, xs = _on_mesh(ctx, params, x)
    ys, auxs = ffn.moe_apply(pp, xs, top_k=top_k, activation="swiglu",
                             ctx=ctx)
    rows = [e for e in eng.ledger.entries if e.site == "moe_dispatch"]
    assert rows[0].query["shape"] == f"{2 * 512}x{D}"
    assert rows[0].query["chips"] == 4 and "devices" not in rows[0].query
    notes = [e for e in rows if "psum is the implemented EP path" in
             (e.note or "")]
    assert bool(notes) == advisory
    if advisory:
        assert notes[0].choice == "replicated_psum"
        assert rows[0].choice == "all_to_all"
    want, _, _ = ffn.moe_ep_plain(params, x, top_k=top_k,
                                  activation="swiglu", ep=4, dp=2,
                                  capacity_factor=ctx.moe_capacity_factor)
    np.testing.assert_allclose(_joined(ctx, ys).numpy(), want.numpy(),
                               rtol=0, atol=1e-6 * want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("cf", CFS)
def test_moe_ep_on_card(cf):
    """moe_ep on 8 positions of GPU 0 (the experts' products on the 4-D
    matmul kernel, fp32) against moe_ep_plain on the CPU: the same drops,
    the output within 1e-5 x max|y|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_moe_ep.py`")
    gen = torch.Generator().manual_seed(0)
    params = ffn.moe_init(gen, D, F_, E, "swiglu")
    x = torch.randn(XSHAPE, generator=gen)
    want, waux, wdrop = ffn.moe_ep_plain(params, x, top_k=TOPK,
                                         activation="swiglu", ep=4, dp=2,
                                         capacity_factor=cf)
    mesh = make_mesh({"data": 2, "model": 4}, shards_per_device=8)
    ctx = ShardingCtx(mesh=mesh, data_axes=("data",))
    pp = place_tree(mesh, tree_map(lambda t: t.cuda(), params), SPECS)
    xs = [t["x"] for t in place_tree(mesh, {"x": x.cuda()}, XSPEC)]
    ys, auxs, dropped = ffn.moe_ep(ctx, pp, xs, top_k=TOPK,
                                   activation="swiglu", capacity_factor=cf)
    y = unplace_tree(mesh, [{"x": t} for t in ys], XSPEC, device="cpu")["x"]
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0,
                               atol=Y_RTOL * want.abs().max())
    assert _drops(ctx, dropped) == int(wdrop)
    np.testing.assert_allclose(float(take(mesh, auxs, 0)), float(waux),
                               rtol=1e-5)
