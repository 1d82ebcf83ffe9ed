"""FSDP training with tensor and expert parallelism on the mesh, on the CPU:
the port's sharded train step on an 8-position CPU mesh
(``make_mesh(..., device="cpu", shards_per_device=8)``, a position a
stand-in for one of the reference's forced host devices) against the
reference, at reduced size (``.reduced()``, fp32), from the reference's
parameters (``params_from_jax``) and numpy-seeded batches.

* the sharded ``Model.loss(params, batch, ctx)`` of all nine decoder-only
  configurations on ``{"pod": 2, "data": 2, "model": 2}`` and ``{"data":
  2, "model": 4}`` (a mixture of experts at capacity factor 8.0, where
  nothing drops) against the reference's unsharded ``model.loss``
  in-process: rtol 1e-5, tighter than the reference test's 2e-3
  (``tests/test_distributed.py::test_pjit_train_loss_matches_single_device``;
  only the order of sums differs);
* for tinyllama-1.1b, moonshot-v1-16b-a3b, rwkv6-3b and recurrentgemma-2b:
  every gradient (``make_grad_fn(ctx=)``, the blocks joined back with
  ``unplace_tree``) against ``jax.grad``, and one ``make_train_step(ctx=)``
  step's metrics and parameters against the reference's unsharded
  ``make_train_step``, at ``tests/test_torch_train.py``'s tolerances
  (gradients and metrics atol 1e-4, each parameter's change within 1e-3 x
  max|reference change|), both sides at an AdamW eps of 1e-3, where an
  update is a smooth function of its gradient (``STEP_EPS``);
* the reference's own sharded loss, computed once in a subprocess on an
  ``AxisType.Auto`` mesh (``torch_mesh_reference.run_reference``; jax 0.9's
  default ``Explicit`` axes break the reference test), at capacity
  factors 8.0 and 1.25 (where the reference's expert parallelism drops
  tokens): the port's sharded loss equals it within rtol 1e-5; in the same
  subprocess, the reference's specs of a whole train state;
* ``param_shardings`` over a whole train state (params, AdamW moments,
  step): the moments take their parameters' specs, as the reference's do,
  and every parameter's spec is the reference's, the fused expert
  ``w_out``'s FSDP split on D in place of F (the port's layout);
* the elastic restore: 3 steps on ``{"data": 2, "model": 2}``, saved
  whole, restored onto ``{"data": 4, "model": 2}``, a fourth step; its
  metrics and parameters equal the reference's uninterrupted unsharded
  4-step run (``tests/test_elastic.py``'s scenario);
* microbatches on the mesh, ``forward_logits(ctx)``, and a placed state
  saved whole;
* the repair of the mesh's pricing: on positions that share one card
  (the CPU mesh with its devices read as one GPU) the ``sort``,
  ``matmul``, ``serve_shard``, ``layer_shard`` and ``moe_dispatch`` sites
  pick serial, replicate or replicated_psum on auto; at one position a
  device every verdict and predicted second is the reference's;
* an encoder-decoder and gradient compression, refused on a training
  mesh before their slice, both run there (held to the reference in
  ``tests/test_torch_encdec_mesh.py`` and
  ``tests/test_torch_compress_mesh.py``), and ``paged=True`` still
  refuses an encoder-decoder; a mixture of experts on a serve mesh still
  raises ``MOE_MESH_REFUSAL``;
* on a card only (``cuda`` marker): the sharded loss and gradients on 8
  positions of GPU 0 against the port's unsharded loss on the CPU.
"""

import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_reference import needs_reference, run_reference  # noqa: E402

try:  # the reference; a card machine without jax runs the rest
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.core.costs.engine import CostEngine as JCostEngine
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.core.planner import plan_model as j_plan_model
    from repro.data import SyntheticLMData as JSyntheticLMData
    from repro.hw import HardwareSpec as JSpec
    from repro.models import build_model as j_build_model
    from repro.optim import adamw as j_adamw
    from repro.training import TrainLoopConfig as JTrainLoopConfig
    from repro.training import init_train_state as j_init_train_state
    from repro.training import make_train_step as j_make_train_step
except ImportError:
    jax = None

from repro_torch.checkpoint import restore, restore_resharded, save  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.core.planner import plan_model  # noqa: E402
from repro_torch.core.sort import distributed_sort  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ShardingCtx,
    batch_sharding,
    param_shardings,
    place_tree,
    unplace_tree,
)
from repro_torch.hw import H100, HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    MOE_MESH_REFUSAL,
    mrope_positions,
    tensor_parallel,
)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.serving.scheduler import ServeScheduler  # noqa: E402
from repro_torch.training import (  # noqa: E402
    TrainLoopConfig,
    init_train_state,
    make_grad_fn,
    make_train_step,
)
from repro_torch.tree import (  # noqa: E402
    leaves_with_paths,
    tree_map,
    tree_map_with_path,
)

ARCHS = [a for a in list_configs() if not get_config(a).is_encdec]
MESHES = {"p2d2m2": {"pod": 2, "data": 2, "model": 2},
          "d2m4": {"data": 2, "model": 4}}
B, S = 8, 16
LOSS_RTOL = 1e-5  # tighter than the reference test's 2e-3
ATOL = 1e-4  # tests/test_torch_train.py's: gradients and metrics
CHANGE_RTOL = 1e-3  # x max|reference change| of a leaf over the steps
# a rate that moves every parameter from the first step, for the step
# checks (tests/test_torch_train.py's peak, its warmup of one step for
# the elastic run's four), and an AdamW eps (the same on both sides) at
# which an update is a smooth function of its gradient: at the default
# 1e-8 a first step moves each weight by lr * g / (|g| + 1e-8), so a
# gradient of 1e-6 moves by 0.99 lr or less as its last bits go, and any
# other order of sums (the reference's own against the port's unsharded
# included) moves some weight by 1 % of lr
STEP_LR = 1e-2
STEP_EPS = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


def _batches(cfg, tokens):
    """The same batch for the reference (jnp) and the port (torch): an
    mrope config's (B, S, 3) text positions with it."""
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens).long()}
    if cfg.pos_type == "mrope":
        pos = np.broadcast_to(np.arange(tokens.shape[1])[None, :, None],
                              tokens.shape + (3,)).astype(np.int32)
        jb["positions"] = jnp.asarray(pos)
        tb["positions"] = mrope_positions(*tokens.shape, 0).clone()
    return jb, tb


def _ctx(shape, cf=8.0, engine=None):
    mesh = make_mesh(shape, device="cpu",
                     shards_per_device=int(np.prod(list(shape.values()))))
    return ShardingCtx(mesh=mesh, data_axes=tuple(
        a for a in shape if a != "model"), moe_capacity_factor=cf,
        cost_engine=engine)


def _placed(ctx, tree, cfg, copy=False):
    specs = param_shardings(tree, ctx.mesh, data_axes=ctx.data_axes,
                            cfg=cfg)
    return place_tree(ctx.mesh, tree, specs, copy=copy), specs


def _batch(ctx, tb):
    return place_tree(ctx.mesh, tb, batch_sharding(tb, ctx.mesh,
                                                   ctx.data_axes))


_PAIRS: dict = {}


def _pair(arch):
    """(cfg, the reference's model and params, the port's model and the
    same params), built once a module."""
    if arch not in _PAIRS:
        jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
        jmodel = j_build_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        _PAIRS[arch] = (cfg, jmodel, jparams, build_model(cfg, "cpu"),
                        params_from_jax(_np(jparams), cfg, "cpu"))
    return _PAIRS[arch]


# ---------------------------------------------------------------------------
# The sharded loss and gradients against the reference's unsharded ones
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_matches_reference(arch, mesh_key):
    cfg, jmodel, jparams, model, params = _pair(arch)
    jb, tb = _batches(cfg, _tokens(cfg, seed=1))
    jloss, jmet = jax.jit(jmodel.loss)(jparams, jb)
    ctx = _ctx(MESHES[mesh_key])
    placed, _ = _placed(ctx, params, cfg)
    losses, mets = model.loss(placed, _batch(ctx, tb), ctx)
    assert len(losses) == ctx.mesh.size
    assert all(torch.equal(x, losses[0]) for x in losses), \
        "every position holds the same loss"
    np.testing.assert_allclose(float(losses[0]), float(jloss),
                               rtol=LOSS_RTOL)
    for k in ("ce", "aux", "z"):
        np.testing.assert_allclose(float(mets[0][k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


GRAD_ARCHS = ["tinyllama-1.1b", "moonshot-v1-16b-a3b", "rwkv6-3b",
              "recurrentgemma-2b"]


@needs_reference
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_sharded_gradients_and_step_match_reference(arch):
    cfg, jmodel, jparams, model, params = _pair(arch)
    tokens = _tokens(cfg, seed=2)
    jb, tb = _batches(cfg, tokens)
    jgrads = jax.grad(lambda p: jmodel.loss(p, jb)[0])(jparams)
    ctx = _ctx(MESHES["p2d2m2"])
    loop = TrainLoopConfig(optimizer=adamw.AdamWConfig(lr=STEP_LR,
                                                       eps=STEP_EPS),
                           warmup_steps=0)
    state = {"params": params, "opt": adamw.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    placed, specs = _placed(ctx, state, cfg, copy=True)
    pb = _batch(ctx, tb)
    _, _, grads = make_grad_fn(model, ctx=ctx)([p["params"] for p in placed],
                                               pb)
    whole = unplace_tree(ctx.mesh, grads, specs["params"])
    want = dict(leaves_with_paths(params_from_jax(_np(jgrads), cfg, "cpu")))
    for path, g in leaves_with_paths(whole):
        np.testing.assert_allclose(g.numpy(), want[path].numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"grad {path}")
    # one step against the reference's unsharded make_train_step
    jloop = JTrainLoopConfig(optimizer=j_adamw.AdamWConfig(
        lr=STEP_LR, eps=STEP_EPS), warmup_steps=0)
    jstate = {"params": jparams, "opt": j_adamw.adamw_init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jax.jit(j_make_train_step(jmodel, jloop))(jstate, jb)
    new, m = make_train_step(model, loop, ctx=ctx)(placed, pb)
    assert len(m) == ctx.mesh.size and set(m[0]) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[0][k]), float(jm[k]), atol=ATOL,
                                   rtol=1e-6, err_msg=k)
        assert all(float(x[k]) == float(m[0][k]) for x in m), k
    got = unplace_tree(ctx.mesh, [p["params"] for p in new],
                       specs["params"])
    _changes_match(params, got, params_from_jax(_np(jstate["params"]), cfg,
                                                "cpu"))


def _changes_match(start, got, want):
    """Each leaf's change from ``start`` within CHANGE_RTOL x max|the
    reference's change|, a change that moved."""
    begin, want = dict(leaves_with_paths(start)), dict(leaves_with_paths(
        want))
    for path, p in leaves_with_paths(got):
        moved = (p - begin[path]).numpy()
        want_moved = (want[path] - begin[path]).numpy()
        tol = CHANGE_RTOL * np.abs(want_moved).max()
        assert np.abs(moved).max() >= 10 * tol, f"{path}: no update"
        np.testing.assert_allclose(moved, want_moved, atol=tol, rtol=0,
                                   err_msg=f"change of {path}")


# ---------------------------------------------------------------------------
# The reference's sharded values (one subprocess)
# ---------------------------------------------------------------------------

_REFERENCE = """
from repro.configs import get_config
from repro.distributed.sharding import (ShardingCtx, batch_sharding,
                                        param_shardings)
from repro.models import build_model
from repro.training import TrainLoopConfig, init_train_state

cfg = get_config("moonshot-v1-16b-a3b").reduced()
model = build_model(cfg)
params = jax.jit(model.init)(jax.random.PRNGKey(0))
rng = np.random.default_rng(%d)
tokens = rng.integers(1, cfg.vocab_size, (%d, %d)).astype(np.int32)
batch = {"tokens": jnp.asarray(tokens)}
mesh = auto_mesh((2, 2, 2), ("pod", "data", "model"))
data = ("pod", "data")
params_s = jax.device_put(params, param_shardings(
    jax.eval_shape(lambda: params), mesh, data_axes=data))
batch_s = jax.device_put(batch, batch_sharding(
    jax.eval_shape(lambda: batch), mesh, data_axes=data))
for cf in (8.0, 1.25):
    ctx = ShardingCtx(mesh=mesh, data_axes=data, moe_capacity_factor=cf)
    loss, met = jax.jit(lambda p, b: model.loss(p, b, ctx))(params_s,
                                                            batch_s)
    OUT[f"loss/{cf}"] = loss
    OUT[f"aux/{cf}"] = met["aux"]


def specs_of(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): [list(a) if isinstance(a, tuple) else a
                                      for a in s.spec]
            for path, s in flat}


loop = TrainLoopConfig()
for arch in ("tinyllama-1.1b", "moonshot-v1-16b-a3b"):
    m = build_model(get_config(arch).reduced())
    shapes = jax.eval_shape(lambda: init_train_state(
        m, jax.random.PRNGKey(0), loop))
    for name, shape, names in (("p2d2m2", (2, 2, 2), ("pod", "data",
                                                       "model")),
                               ("d4m2", (4, 2), ("data", "model"))):
        mesh = auto_mesh(shape, names)
        specs = param_shardings(shapes, mesh,
                                data_axes=tuple(n for n in names
                                                if n != "model"))
        OUT[f"specs/{arch}/{name}"] = np.array(json.dumps(specs_of(specs)))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_mesh_ref") / "out.npz"
    return run_reference(_REFERENCE % (3, B, S), out)


@needs_reference
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_sharded_loss_matches_reference_sharded_loss(reference, cf):
    """The port's sharded moonshot loss against the reference's own
    sharded loss at the same capacity factor: at 1.25 both drop the same
    assignments, and the loss differs from the unsharded one."""
    cfg, jmodel, jparams, model, params = _pair("moonshot-v1-16b-a3b")
    jb, tb = _batches(cfg, _tokens(cfg, seed=3))
    ctx = _ctx(MESHES["p2d2m2"], cf=cf)
    placed, _ = _placed(ctx, params, cfg)
    losses, mets = model.loss(placed, _batch(ctx, tb), ctx)
    np.testing.assert_allclose(float(losses[0]), float(reference[
        f"loss/{cf}"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(mets[0]["aux"]),
                               float(reference[f"aux/{cf}"]), rtol=LOSS_RTOL)
    unsharded = float(jax.jit(jmodel.loss)(jparams, jb)[0])
    if cf == 1.25:  # tokens dropped: a different function
        assert abs(float(losses[0]) - unsharded) > 10 * LOSS_RTOL * unsharded
    else:
        np.testing.assert_allclose(float(losses[0]), unsharded,
                                   rtol=LOSS_RTOL)


def _port_spec(path, spec, lead):
    """A reference leaf's spec in the port's layout: the stacked layer axis
    dropped, (D, H, hd) attention fused to (D, H*hd), experts side by side
    with the fused ``w_out``'s FSDP split moved from F to D."""
    spec = tuple(tuple(a) if isinstance(a, list) else a
                 for a in spec[lead:])
    keys = path.split("/")
    if len(spec) == 3 and keys[-1] in ("wq", "wk", "wv"):
        return spec[:2]
    if len(spec) == 3 and keys[-2] == "ffn":
        return (spec[0], spec[1]) if keys[-1] == "w_out" else \
            (spec[1], spec[0])
    return spec


@needs_reference
@pytest.mark.parametrize("mesh_key", ["p2d2m2", "d4m2"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "moonshot-v1-16b-a3b"])
def test_train_state_specs_match_reference(reference, arch, mesh_key):
    ref = json.loads(str(reference[f"specs/{arch}/{mesh_key}"]))
    for path, spec in ref.items():  # the reference's moments
        if path.startswith("opt/mu/") or path.startswith("opt/nu/"):
            assert spec == ref["params/" + path[7:]], path
    cfg = get_config(arch).reduced()
    shape = {"p2d2m2": {"pod": 2, "data": 2, "model": 2},
             "d4m2": {"data": 4, "model": 2}}[mesh_key]
    ctx = _ctx(shape)
    state = init_train_state(build_model(cfg, "cpu"), 0, TrainLoopConfig())
    specs = param_shardings(state, ctx.mesh, data_axes=ctx.data_axes,
                            cfg=cfg)
    got = {}
    tree_map_with_path(lambda p, _, s: got.__setitem__(p, s), state, specs)
    assert got["step"] == () and got["opt/count"] == ()
    want = {}
    for path, spec in ref.items():
        if not path.startswith(("params/", "opt/mu/", "opt/nu/")):
            continue
        # reduced trees keep a key a layer (layer_<i>); stacked ones lead
        # with the layer axis
        lead = int("layer_" not in path and "layers" in path.split("/"))
        want[path] = _port_spec(path, spec, lead)
    checked = 0
    for path, spec in got.items():
        if path in ("step", "opt/count"):
            continue
        key = re.sub(r"/layers/(\d+)/", r"/layers/layer_\1/", path)
        assert spec == want[key], path
        if path.startswith("opt/"):
            assert spec == got["params/" + path[7:]], path
        checked += 1
    assert checked == 3 * len(leaves_with_paths(state["params"]))


# ---------------------------------------------------------------------------
# Elastic restore, microbatches, forward_logits, a placed save
# ---------------------------------------------------------------------------


@needs_reference
def test_elastic_restore_matches_reference_unsharded_run(tmp_path):
    """3 steps on (data 2, model 2), saved whole, restored onto (data 4,
    model 2), the fourth step: equal to the reference's uninterrupted
    unsharded run on its own batches."""
    arch = "tinyllama-1.1b"
    cfg, jmodel, jparams, model, params = _pair(arch)
    jloop = JTrainLoopConfig(optimizer=j_adamw.AdamWConfig(
        lr=STEP_LR, eps=STEP_EPS), warmup_steps=1)
    loop = TrainLoopConfig(optimizer=adamw.AdamWConfig(lr=STEP_LR,
                                                       eps=STEP_EPS),
                           warmup_steps=1)
    ds = JSyntheticLMData(j_get_config(arch).reduced(), seq_len=16,
                          global_batch=4)
    batches = [np.asarray(ds.batch_at(i)["tokens"]) for i in range(4)]
    jstate = j_init_train_state(jmodel, jax.random.PRNGKey(0), jloop)
    jstep = jax.jit(j_make_train_step(jmodel, jloop))
    for tokens in batches:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
    start = params_from_jax(_np(jparams), cfg, "cpu")
    state = {"params": tree_map(torch.clone, start),
             "opt": adamw.adamw_init(start),
             "step": torch.zeros((), dtype=torch.int32)}
    first = _ctx({"data": 2, "model": 2})
    placed, specs = _placed(first, state, cfg, copy=True)
    step = make_train_step(model, loop, ctx=first, donate=True)
    for tokens in batches[:3]:
        placed, _ = step(placed, _batch(first, {
            "tokens": torch.from_numpy(tokens).long()}))
    save(tmp_path, 3, placed, mesh=first.mesh, shardings=specs)
    second = _ctx({"data": 4, "model": 2})
    specs2 = param_shardings(state, second.mesh, data_axes=("data",),
                             cfg=cfg)
    restored = restore_resharded(tmp_path, 3, state, specs2,
                                 mesh=second.mesh, copy=True)
    assert all(int(p["step"]) == 3 for p in restored)
    restored, m = make_train_step(model, loop, ctx=second)(
        restored, {"tokens": torch.from_numpy(batches[3]).long()})
    for k in jm:
        np.testing.assert_allclose(float(m[0][k]), float(jm[k]), atol=ATOL,
                                   rtol=1e-6, err_msg=k)
    got = unplace_tree(second.mesh, [p["params"] for p in restored],
                       specs2["params"])
    _changes_match(start, got, params_from_jax(_np(jstate["params"]), cfg,
                                               "cpu"))


def test_microbatches_split_the_global_batch():
    """Microbatch i is rows [i·B/n, (i+1)·B/n) of the global batch, then
    split over the data axes: the sharded step with 2 microbatches, fed
    the placed batch or the global one, equals the unsharded port's."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg, "cpu")
    loop = TrainLoopConfig(optimizer=adamw.AdamWConfig(lr=STEP_LR,
                                                       eps=STEP_EPS),
                           warmup_steps=0, microbatches=2)
    state = init_train_state(model, 0, loop)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=4)).long()}
    want_state, want = make_train_step(model, loop)(state, batch)
    ctx = _ctx({"data": 4, "model": 2})
    for feed in (_batch(ctx, batch), batch):
        placed, specs = _placed(ctx, state, cfg)
        new, m = make_train_step(model, loop, ctx=ctx)(placed, feed)
        for k in want:
            np.testing.assert_allclose(float(m[0][k]), float(want[k]),
                                       rtol=1e-5, err_msg=k)
        got = unplace_tree(ctx.mesh, new, specs)
        for (path, a), (_, b) in zip(leaves_with_paths(got),
                                     leaves_with_paths(want_state)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5, err_msg=path)


def test_forward_logits_on_the_mesh_are_each_data_shards():
    cfg = get_config("mistral-nemo-12b").reduced()
    model = build_model(cfg, "cpu")
    params = model.init(0)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=5)).long()}
    want, _ = model.forward_logits(params, batch)
    ctx = _ctx(MESHES["p2d2m2"])
    placed, _ = _placed(ctx, params, cfg)
    logits, auxs = model.forward_logits(placed, _batch(ctx, batch), ctx)
    rows = B // ctx.dp
    for i, lg in enumerate(logits):
        d = ctx.mesh.axis_index("pod", i) * 2 + ctx.mesh.axis_index("data", i)
        assert lg.shape == (rows, S, cfg.vocab_size)
        np.testing.assert_allclose(lg.numpy(), want[d * rows:(d + 1) *
                                                    rows].numpy(),
                                   rtol=0, atol=1e-5 * want.abs().max())
        assert float(auxs[i]) == 0.0


def test_placed_state_saves_whole(tmp_path):
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    model = build_model(cfg, "cpu")
    state = init_train_state(model, 0, TrainLoopConfig())
    ctx = _ctx(MESHES["p2d2m2"])
    placed, specs = _placed(ctx, state, cfg)
    with pytest.raises(ValueError, match="mesh="):
        save(tmp_path, 1, placed)
    save(tmp_path, 1, placed, mesh=ctx.mesh, shardings=specs)
    back = restore(tmp_path, 1, state)
    for (path, a), (_, b) in zip(leaves_with_paths(back),
                                 leaves_with_paths(state)):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# The repair: positions that share one card priced as that card's
# ---------------------------------------------------------------------------


def _shared_card_mesh(shape):
    """An 8-position mesh whose positions read as sharing GPU 0: what the
    engine's sites see of ``make_mesh(shape, shards_per_device=8)`` on a
    card, with no card needed to price it."""
    mesh = make_mesh(shape, device="cpu", shards_per_device=8)
    mesh.devices = (torch.device("cuda", 0),) * mesh.size
    return mesh


def test_shared_card_prices_serial_or_replicate():
    shared = _shared_card_mesh({"data": 2, "model": 4})
    cpu = make_mesh({"data": 2, "model": 4}, device="cpu",
                    shards_per_device=8)
    assert shared.distinct_devices() == shared.distinct_devices("model") == 1
    assert cpu.distinct_devices("model") == 4 and cpu.distinct_devices() == 8
    eng = CostEngine(hw=HardwareSpec.from_dict(H100.to_dict()))
    # sort and matmul where the reference's pricing forks
    for n in (1 << 22, 1 << 26, 1 << 30):
        assert eng.decide_sort(n, chips=8).choice == "sample_sort"
        assert eng.decide_sort(n, chips=8, devices=1).choice == "serial"
    for order in (2048, 8192, 32768):
        assert eng.decide_matmul(order, order, order, chips=8).choice \
            != "serial"
        if order >= 4096:
            assert eng.decide_layer_shard(order, order, order,
                                          tp=8).choice == "shard_model"
        assert eng.decide_matmul(order, order, order, chips=8,
                                 devices=1).choice == "serial"
        assert eng.decide_layer_shard(order, order, order, tp=8,
                                      devices=1).choice == "replicate"
    x = torch.arange(4096.0).flip(0)
    got, rep = distributed_sort(x, shared, axis="data", engine=eng,
                                force_parallel=False)
    assert rep.strategy == "serial" and torch.equal(got, x.flip(0))
    row = [e for e in eng.ledger.entries if e.site == "sort"][-1]
    assert row.query["devices"] == 1
    # serve_shard: a 70B-class step that shards at one device a position
    large = dict(flops_per_token=2 * 70e9, weight_bytes=2 * 70e9,
                 kv_bytes_per_slot=4e8, n_layers=80, d_model=8192)
    assert eng.decide_serve_shard(8, tp=8, **large).choice == "shard_model"
    assert eng.decide_serve_shard(8, tp=8, devices=1, **large).choice == \
        "replicate"
    nemo = dataclasses.replace(get_config("mistral-nemo-12b"), n_layers=8)
    tp, dec = ServeScheduler(nemo, eng, max_len=96).serve_shard(
        4, tp=8, devices=shared.distinct_devices("model"))
    assert (tp, dec.choice) == (1, "replicate")
    # the planner's layer_shard and moe_dispatch over the shared mesh
    for arch in ("tinyllama-1.1b", "moonshot-v1-16b-a3b",
                 "qwen3-moe-235b-a22b", "qwen2-vl-72b"):
        for shape in ("train_4k", "decode_32k"):
            plan = plan_model(get_config(arch), SHAPES[shape], shared,
                              engine=eng)
            assert {d.choice for d in plan.decisions} <= {
                "replicate", "replicated_psum"}, (arch, shape)
    for t in (64, 4096, 1 << 20):
        for k in (2, 6, 8):
            assert eng.decide_moe_dispatch(
                t, 2048, top_k=k, ep_shards=4,
                devices=shared.distinct_devices("model")).choice == \
                "replicated_psum"


@needs_reference
def test_one_position_a_device_prices_as_reference():
    """Where every position has a device of its own (the CPU mesh's
    stand-ins for the reference's forced host devices, or ``devices`` ==
    ``chips``), every verdict and predicted second is the reference's, and
    the query carries nothing of the sharing."""
    fields = H100.to_dict()
    eng = CostEngine(hw=HardwareSpec.from_dict(fields))
    jeng = JCostEngine(hw=JSpec.from_dict(fields))
    cpu = make_mesh({"data": 2, "model": 4}, device="cpu",
                    shards_per_device=8)
    tp_dev = cpu.distinct_devices("model")
    for n in (1 << 10, 1 << 20, 1 << 26):
        a = eng.decide_sort(n, chips=8, devices=cpu.distinct_devices())
        b = jeng.decide_sort(n, chips=8)
        assert (a.choice, a.query.as_dict()) == (b.choice, b.query.as_dict())
        assert a.predicted.total == pytest.approx(b.predicted.total,
                                                  rel=1e-9)
    for o in (256, 4096, 16384):
        a = eng.decide_layer_shard(o, o, o, tp=4, devices=tp_dev)
        b = jeng.decide_layer_shard(o, o, o, tp=4)
        assert a.choice == b.choice
        assert a.predicted.total == pytest.approx(b.predicted.total,
                                                  rel=1e-9)
        a = eng.decide_moe_dispatch(o, 2048, top_k=1, ep_shards=4,
                                    devices=tp_dev)
        b = jeng.decide_moe_dispatch(o, 2048, top_k=1, ep_shards=4)
        assert a.choice == b.choice
        assert a.predicted.total == pytest.approx(b.predicted.total,
                                                  rel=1e-9)
    for arch in ("tinyllama-1.1b", "moonshot-v1-16b-a3b"):
        got = plan_model(get_config(arch), SHAPES["train_4k"], cpu,
                         engine=eng)
        want = j_plan_model(j_get_config(arch), JShapeSpec(
            *vars(SHAPES["train_4k"]).values()), dict(cpu.shape),
            engine=jeng)
        assert [(d.site, d.choice) for d in got.decisions] == \
            [(d.site, d.choice) for d in want.decisions]
        for g, w in zip(got.decisions, want.decisions):
            assert g.tp_cost == pytest.approx(w.tp_cost, rel=1e-9)
        assert got.hbm_per_chip == pytest.approx(want.hbm_per_chip,
                                                 rel=1e-9)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_encdec_and_compression_refused_on_a_training_mesh():
    """Both refused here before their slice; now a compressed step of
    seamless-m4t-medium runs on the mesh and equals the unsharded port's,
    and only ``paged=True`` still refuses an encoder-decoder."""
    ctx = _ctx({"data": 4, "model": 2})
    cfg = get_config("seamless-m4t-medium").reduced()
    model = build_model(cfg, "cpu")
    loop = TrainLoopConfig(optimizer=adamw.AdamWConfig(lr=STEP_LR,
                                                       eps=STEP_EPS),
                           warmup_steps=0, compression=True)
    state = init_train_state(model, 0, loop)
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=6)).long(),
             "frames": torch.from_numpy(rng.standard_normal(
                 (B, S, cfg.d_model)).astype(np.float32) * 0.1)}
    want_state, want = make_train_step(model, loop)(state, batch)
    placed, specs = _placed(ctx, state, cfg, copy=True)
    new, m = make_train_step(model, loop, ctx=ctx)(placed, batch)
    for k in want:
        np.testing.assert_allclose(float(m[0][k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    got = unplace_tree(ctx.mesh, new, specs)
    _changes_match(state["params"], got["params"], want_state["params"])
    with pytest.raises(ValueError, match="no paged layout"):
        Runtime(device="cpu").serve(cfg, synthetic_trace(
            2, prompt_len=4, max_new=2, vocab_size=cfg.vocab_size),
            paged=True, mesh_shape={"data": 1, "model": 2},
            shard_params="shard", shards_per_device=2)


def test_moe_on_a_serve_mesh_still_refused():
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    serve = ShardingCtx(mesh=make_mesh({"data": 1, "model": 8}, device="cpu",
                                       shards_per_device=8), data_axes=())
    with pytest.raises(ValueError, match="moe_ep"):
        tensor_parallel(cfg, serve)
    model = build_model(cfg, "cpu")
    placed = place_tree(serve.mesh, model.init(0), param_shardings(
        model.init(0), serve.mesh, data_axes=(), cfg=cfg))
    with pytest.raises(ValueError, match=MOE_MESH_REFUSAL[:40]):
        model.loss(placed, {"tokens": torch.zeros((2, 8), dtype=torch.long)},
                   serve)
    train = _ctx({"data": 1, "model": 8})
    assert tensor_parallel(cfg, train)  # a training context runs it


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda "
                    "tests/test_torch_train_mesh.py`")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_on_card(arch):
    """The sharded loss on 8 positions of GPU 0 (fp32, reduced) against
    the port's unsharded loss on the CPU from the same parameters."""
    _needs_card()
    cfg = get_config(arch).reduced()
    params = build_model(cfg, "cpu").init(0)
    tb = {"tokens": torch.from_numpy(_tokens(cfg, seed=1)).long()}
    if cfg.pos_type == "mrope":
        tb["positions"] = mrope_positions(B, S, 0).clone()
    want = float(build_model(cfg, "cpu").loss(params, tb)[0])
    mesh = make_mesh(MESHES["p2d2m2"], shards_per_device=8)
    ctx = ShardingCtx(mesh=mesh, data_axes=("pod", "data"),
                      moe_capacity_factor=8.0)
    card = tree_map(lambda t: t.cuda(), params)
    placed = place_tree(mesh, card, param_shardings(
        card, mesh, data_axes=ctx.data_axes, cfg=cfg))
    losses, _ = build_model(cfg, "cuda").loss(
        placed, tree_map(lambda t: t.cuda(), tb), ctx)
    np.testing.assert_allclose(float(losses[0]), want, rtol=LOSS_RTOL * 10)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_sharded_gradients_on_card(arch):
    """Every gradient of the sharded loss on 8 positions of GPU 0 against
    the port's unsharded gradients on the CPU: within 2e-3 x max|grad|
    (chip_smoke.py's card-against-CPU limit)."""
    _needs_card()
    cfg = get_config(arch).reduced()
    params = build_model(cfg, "cpu").init(0)
    tb = {"tokens": torch.from_numpy(_tokens(cfg, seed=2)).long()}
    _, _, want = make_grad_fn(build_model(cfg, "cpu"))(params, tb)
    mesh = make_mesh(MESHES["p2d2m2"], shards_per_device=8)
    ctx = ShardingCtx(mesh=mesh, data_axes=("pod", "data"),
                      moe_capacity_factor=8.0)
    card = tree_map(lambda t: t.cuda(), params)
    specs = param_shardings(card, mesh, data_axes=ctx.data_axes, cfg=cfg)
    _, _, grads = make_grad_fn(build_model(cfg, "cuda"), ctx=ctx)(
        place_tree(mesh, card, specs), tree_map(lambda t: t.cuda(), tb))
    got = dict(leaves_with_paths(unplace_tree(mesh, grads, specs,
                                              device="cpu")))
    for path, w in leaves_with_paths(want):
        np.testing.assert_allclose(got[path].numpy(), w.numpy(), rtol=0,
                                   atol=2e-3 * w.abs().max().item(),
                                   err_msg=path)
