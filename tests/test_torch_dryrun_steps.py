"""The steps the dry run traces, on a CPU mesh with data and model axes,
against the reference (``src/repro/training/step.py``,
``src/repro/models/model.py``) on one device, in fp32.

The production contexts split the batch over the data axes and the heads,
FFN columns, experts and vocabulary over the model axis, where no port
path had served before (data above 1):

* ``Model.prefill(params, batch, ctx)`` on a context with data axes takes
  FSDP-split params (gathered just before their use, as in the loss) and
  gives each position its rows' last logits: equal to the reference's
  prefill of the whole batch (reduced tinyllama; reduced gemma-2b, one kv
  head over the model axis; reduced moonshot, its experts through
  ``moe_ep`` at a capacity where none drops);
* ``make_serve_step(model, ctx)`` with params replicated over the data
  axes, the decode state's batch split over them and its caches split
  along their length over the model axis (the dry run's placement, the
  reference's ``state_sharding``), and the reference's ``active`` mask: two steps' tokens equal the reference's serve step's, and the
  masked slot's state stays as it was;
* ``make_serve_step(model)`` without a context takes the same mask.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.training.step import make_serve_step as j_make_serve_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed.mesh import make_mesh, take  # noqa: E402
from repro_torch.distributed.sharding import (ShardingCtx,  # noqa: E402
                                              batch_sharding,
                                              param_shardings, place_tree)
from repro_torch.launch.dryrun import decode_state_specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.step import make_serve_step  # noqa: E402

ARCHS = ["tinyllama-1.1b", "gemma-2b", "moonshot-v1-16b-a3b"]
MESH = {"data": 2, "model": 2}
B, S = 4, 12


def _fp32(arch):
    return dataclasses.replace(j_get_config(arch).reduced(),
                               dtype="float32"), \
        dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _pair(arch, seed):
    jcfg, cfg = _fp32(arch)
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, "cpu"), params


def _ctx(**kw):
    mesh = make_mesh(MESH, device="cpu", shards_per_device=4)
    # capacity 8: no expert assignment drops, the dense reference's result
    return ShardingCtx(mesh=mesh, data_axes=("data",),
                       moe_capacity_factor=8.0, **kw)


def _rows(ctx, i):
    """Position i's rows of the global batch (its data block)."""
    n = B // ctx.dp
    r = ctx.mesh.axis_index("data", i)
    return slice(r * n, (r + 1) * n)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_a_data_and_model_context_matches_reference(arch):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch, 3)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S))
    want = np.asarray(jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)}))
    ctx = _ctx()
    placed = place_tree(ctx.mesh, params, model.mesh_specs(ctx))
    batch = {"tokens": torch.from_numpy(toks)}
    feed = place_tree(ctx.mesh, batch,
                      batch_sharding(batch, ctx.mesh, ctx.data_axes))
    with torch.no_grad():
        got = model.prefill(placed, feed, ctx)
    assert len(got) == ctx.mesh.size
    for i, g in enumerate(got):
        assert g.shape == (B // ctx.dp, 1, cfg.vocab_size)
        np.testing.assert_allclose(take(ctx.mesh, got, i).numpy(),
                                   want[_rows(ctx, i)], atol=2e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_on_a_data_and_model_context_matches_reference(arch):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch, 5)
    max_len = 16
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 1))
    jstep = jax.jit(j_make_serve_step(jmodel))
    jstate = jmodel.init_decode_state(B, max_len)
    ctx = _ctx(infer_replicate_params=True, kv_len=max_len)
    mesh = ctx.mesh
    placed = place_tree(mesh, params, param_shardings(
        params, mesh, data_axes=(), cfg=cfg))
    state = model.init_decode_state(B, max_len)
    states = place_tree(mesh, state, decode_state_specs(
        cfg, state, mesh, ctx.data_axes), copy=True)
    # the dry run's placement: every cache split along its length
    assert states[0]["layers"][0]["k"].shape[1] == max_len // ctx.tp
    step = make_serve_step(model, ctx)
    active = np.array([True, True, False, True])
    for t, act in enumerate((None, active)):
        jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
        batch = {"tokens": torch.from_numpy(toks)}
        if act is not None:
            jbatch["active"] = jnp.asarray(act)
            batch["active"] = torch.from_numpy(act)
        want, jstate = jstep(jparams, jstate, jbatch)
        feed = place_tree(mesh, batch, batch_sharding(batch, mesh,
                                                      ctx.data_axes))
        before = [{k: v.clone() for k, v in st["layers"][0].items()}
                  for st in states]
        with torch.no_grad():
            got, states = step(placed, states, feed)
        for i in range(mesh.size):
            rows = _rows(ctx, i)
            np.testing.assert_array_equal(take(mesh, got, i).numpy(),
                                          np.asarray(want)[rows])
            if act is None:
                continue
            # a masked slot's whole state stays exactly as it was
            for r, a in enumerate(act[rows]):
                if not a:
                    for k, v in states[i]["layers"][0].items():
                        assert torch.equal(v[r], before[i][k][r]), k
        toks = np.asarray(want)[:, None].copy()


def test_serve_step_without_a_context_takes_the_active_mask():
    jcfg, jmodel, jparams, cfg, model, params = _pair("tinyllama-1.1b", 7)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, 1))
    state = model.init_decode_state(B, 16, per_slot=True)
    step = make_serve_step(model)
    _, state = step(params, state, {"tokens": torch.from_numpy(toks)})
    active = torch.tensor([False, True, True, False])
    pos_before = state["pos"].clone()
    k_before = state["layers"][0]["k"].clone()
    with torch.no_grad():
        _, new = step(params, state, {"tokens": torch.from_numpy(toks),
                                      "active": active})
    assert torch.equal(new["pos"], torch.where(active, pos_before + 1,
                                               pos_before))
    assert torch.equal(new["layers"][0]["k"][~active], k_before[~active])
    jstate = jmodel.init_decode_state(B, 16, per_slot=True)
    jstep = jax.jit(j_make_serve_step(jmodel))
    _, jstate = jstep(jparams, jstate, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)})
    _, jstate = jstep(jparams, jstate, {
        "tokens": jnp.asarray(toks, jnp.int32),
        "active": jnp.asarray(active.numpy())})
    np.testing.assert_array_equal(np.asarray(jstate["pos"]),
                                  new["pos"].numpy())
