"""Gradient compression under a mesh context, on the CPU: the port's
``make_train_step(ctx=)`` with ``TrainLoopConfig(compression=True)`` on
8-position CPU meshes against the reference, at reduced size (fp32), from
the reference's parameters (``params_from_jax``) and numpy-seeded
batches.

The reference's compressed step cannot be jitted (its
``CompressionState`` is no registered pytree, so ``jax.jit`` refuses the
train state), so the oracle is its eager, unsharded
``make_train_step(...)(state, batch)``: the logical gradient's
compression.

* 3 sharded compressed steps of tinyllama-1.1b on ``{"pod": 2, "data": 2,
  "model": 2}`` and of seamless-m4t-medium on ``{"data": 4, "model": 2}``
  against the reference's eager compressed steps: the loss (rtol 1e-5),
  ``wire_bytes_ratio`` (equal), every parameter's change within 1e-3 x
  max|reference change| and the residual within 1e-6 (the single-device
  compression test's limits), but for the entries a boundary splits: the
  two packages' gradients differ in their last bits (another order of
  sums), and an entry that lands on either side of an int8 rounding
  boundary or of the top-k threshold is kept or rounded one way in each,
  a difference of a quantum or of the kept value.  At most one entry in
  FLIP_SHARE of a leaf may so differ (1 of 16,384 did at these seeds);
  the compression itself is held bit for bit by the next test, on one
  gradient;
* the sharded gradient, joined back and fed to the reference's
  ``compress_gradients``, gives the mesh compression's values bit for bit
  (with and without int8, so the masks too), the residual carried over 3
  gradients;
* a replicated leaf counted once: a leaf whose blocks repeat over the
  data axis (or over every axis) keeps k entries, not 1;
* ``wire_bytes_ratio`` from the logical sizes, the reference's;
* microbatches: the compression runs once, on the accumulated gradient;
* a placed compressed state (the residual with it) saved whole and
  restored onto another mesh steps on as it would have;
* the reference's jitted compressed step refuses its own train state (a
  ``TypeError`` at ``state['compress']``), where the port's
  ``Runtime.train`` compresses;
* on a card only (``cuda`` marker): the sharded compressed gradient on 8
  positions of GPU 0 against the port's single-device
  ``compress_gradients`` of the same gradient, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the reference; a card machine without jax runs the rest
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model
    from repro.optim import adamw as j_adamw
    from repro.optim import compression as j_compression
    from repro.training import TrainLoopConfig as JTrainLoopConfig
    from repro.training import make_train_step as j_make_train_step
except ImportError:
    jax = None

needs_reference = pytest.mark.skipif(
    jax is None, reason="needs jax and the reference package")

from repro_torch.checkpoint import restore_resharded, save  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ShardingCtx,
    batch_sharding,
    param_shardings,
    place_tree,
    unplace_tree,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compression import (  # noqa: E402
    CompressionState,
    compress_gradients,
    compress_gradients_mesh,
    init_compression,
)
from repro_torch.training import (  # noqa: E402
    TrainLoopConfig,
    init_train_state,
    make_grad_fn,
    make_train_step,
)
from repro_torch.tree import leaves_with_paths, tree_map  # noqa: E402

CASES = {"tinyllama-1.1b": {"pod": 2, "data": 2, "model": 2},
         "seamless-m4t-medium": {"data": 4, "model": 2}}
B, S = 8, 16
KEEP = 0.1
LOSS_RTOL = 1e-5
CHANGE_RTOL = 1e-3
RESIDUAL_ATOL = 1e-6  # tests/test_torch_train.py's compression limit
FLIP_SHARE = 1000  # at most 1 entry in this many of a leaf split by a
# rounding or threshold boundary (see the module docstring)
STEP_LR, STEP_EPS = 1e-2, 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ctx(shape):
    mesh = make_mesh(shape, device="cpu",
                     shards_per_device=int(np.prod(list(shape.values()))))
    return ShardingCtx(mesh=mesh, data_axes=tuple(
        a for a in shape if a != "model"))


def _batch(cfg, seed):
    """The same batch for both packages (seamless's with its frames)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    tb = {"tokens": torch.from_numpy(tokens).long()}
    if cfg.is_encdec:
        tb["frames"] = torch.from_numpy((rng.standard_normal(
            (B, S, cfg.d_model)) * 0.1).astype(np.float32))
    jb = None if jax is None else {k: jnp.asarray(v.numpy() if k == "frames"
                                                  else tokens)
                                   for k, v in tb.items()}
    return jb, tb


def _placed_batch(ctx, tb):
    return place_tree(ctx.mesh, tb, batch_sharding(tb, ctx.mesh,
                                                   ctx.data_axes))


def _loop(**kw):
    return TrainLoopConfig(optimizer=adamw.AdamWConfig(lr=STEP_LR,
                                                       eps=STEP_EPS),
                           warmup_steps=0, compression=True,
                           compression_keep_frac=KEEP, **kw)


_PAIRS: dict = {}


def _pair(arch):
    if arch not in _PAIRS:
        jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
        jmodel = j_build_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        _PAIRS[arch] = (cfg, jmodel, jparams, build_model(cfg, "cpu"),
                        params_from_jax(_np(jparams), cfg, "cpu"))
    return _PAIRS[arch]


def _state(params):
    return {"params": tree_map(torch.clone, params),
            "opt": adamw.adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32),
            "compress": init_compression(params)}


def _placed(ctx, state, cfg):
    specs = param_shardings(state, ctx.mesh, data_axes=ctx.data_axes,
                            cfg=cfg)
    return place_tree(ctx.mesh, state, specs, copy=True), specs


# ---------------------------------------------------------------------------
# The sharded compressed step against the reference's eager one
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("arch", list(CASES))
def test_compressed_step_matches_reference_eager_step(arch):
    cfg, jmodel, jparams, model, params = _pair(arch)
    loop = _loop()
    jloop = JTrainLoopConfig(optimizer=j_adamw.AdamWConfig(
        lr=STEP_LR, eps=STEP_EPS), warmup_steps=0, compression=True,
        compression_keep_frac=KEEP)
    jstate = {"params": jparams, "opt": j_adamw.adamw_init(jparams),
              "step": jnp.zeros((), jnp.int32),
              "compress": j_compression.init_compression(jparams)}
    jstep = j_make_train_step(jmodel, jloop)  # eager: jit refuses it
    ctx = _ctx(CASES[arch])
    placed, specs = _placed(ctx, _state(params), cfg)
    assert specs["compress"].residual == specs["params"]
    step = make_train_step(model, loop, ctx=ctx, donate=True)
    for i in range(3):
        jb, tb = _batch(cfg, seed=20 + i)
        jstate, jm = jstep(jstate, jb)
        placed, m = step(placed, _placed_batch(ctx, tb))
        np.testing.assert_allclose(float(m[0]["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        assert m[0]["wire_bytes_ratio"] == float(jm["wire_bytes_ratio"])
        assert all(float(x["loss"]) == float(m[0]["loss"]) for x in m)
    got = unplace_tree(ctx.mesh, placed, specs)
    want_p = params_from_jax(_np(jstate["params"]), cfg, "cpu")
    want_r = dict(leaves_with_paths(params_from_jax(
        _np(jstate["compress"].residual), cfg, "cpu")))
    begin, want_p = dict(leaves_with_paths(params)), dict(leaves_with_paths(
        want_p))
    for path, p in leaves_with_paths(got["params"]):
        moved = (p - begin[path]).numpy()
        want_moved = (want_p[path] - begin[path]).numpy()
        tol = CHANGE_RTOL * np.abs(want_moved).max()
        assert np.abs(moved).max() >= 10 * tol, f"{path}: no update"
        _close_but_boundaries(moved, want_moved, tol, 0.0,
                              f"change of {path}")
    for path, r in leaves_with_paths(got["compress"].residual):
        _close_but_boundaries(r.numpy(), want_r[path].numpy(),
                              RESIDUAL_ATOL, 1e-6, f"residual {path}")


def _close_but_boundaries(got, want, atol, rtol, what):
    """``got`` within ``atol + rtol * |want|`` of ``want`` at every entry
    but at most one in FLIP_SHARE (at least one): the entries a rounding
    or threshold boundary splits."""
    off = np.abs(got - want) > atol + rtol * np.abs(want)
    assert int(off.sum()) <= max(1, want.size // FLIP_SHARE), (
        f"{what}: {int(off.sum())} of {want.size} entries off, worst "
        f"{np.abs(got - want).max():.3e}")


@needs_reference
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("arch", list(CASES))
def test_mesh_compression_equals_reference_bit_for_bit(arch, quantize):
    """3 sharded gradients (3 batches, the residual carried on both
    sides): the mesh compression joined back equals the reference's
    ``compress_gradients`` of the joined gradient bit for bit, values and
    residual; without int8 that is the mask itself."""
    cfg, _, _, model, params = _pair(arch)
    ctx = _ctx(CASES[arch])
    placed, specs = _placed(ctx, params, cfg)
    grad_fn = make_grad_fn(model, ctx=ctx)
    states, jst = None, None
    for i in range(3):
        _, tb = _batch(cfg, seed=30 + i)
        _, _, grads = grad_fn(placed, _placed_batch(ctx, tb))
        got, states, m = compress_gradients_mesh(
            ctx, grads, states, specs, keep_frac=KEEP, quantize=quantize)
        whole = unplace_tree(ctx.mesh, grads, specs)
        want, jst, jm = j_compression.compress_gradients(
            {p: jnp.asarray(g.numpy()) for p, g in leaves_with_paths(whole)},
            jst, keep_frac=KEEP, quantize=quantize)
        assert m[0]["wire_bytes_ratio"] == jm["wire_bytes_ratio"]
        out = dict(leaves_with_paths(unplace_tree(ctx.mesh, got, specs)))
        res = dict(leaves_with_paths(unplace_tree(
            ctx.mesh, [s.residual for s in states], specs)))
        for path, w in want.items():
            assert np.array_equal(out[path].numpy(), np.asarray(w)), \
                f"step {i} {path}"
            assert np.array_equal(res[path].numpy(),
                                  np.asarray(jst.residual[path])), \
                f"step {i} residual {path}"
            if not quantize and out[path].numel() > 16:
                kept = int((out[path] != 0).sum())
                assert kept >= max(int(out[path].numel() * KEEP), 1), path


# ---------------------------------------------------------------------------
# Replicated blocks, the wire ratio, microbatches, a checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec_name", ["over data", "everywhere"])
def test_replicated_leaf_counted_once(spec_name):
    """A (8, 32) leaf whose distinct blocks repeat over the data axis (or
    on every position): each block counted once, the leaf keeps its k =
    25 largest entries, as the single-device compression of the whole
    leaf does; counted once a replica, the 25th largest of the union would
    be a larger value and fewer would be kept."""
    ctx = _ctx({"data": 4, "model": 2})
    spec = (None, "model") if spec_name == "over data" else (None, None)
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    tree, specs = {"w": g}, {"w": spec}
    grads = place_tree(ctx.mesh, tree, specs, copy=True)
    for quantize in (False, True):
        got, states, m = compress_gradients_mesh(
            ctx, grads, None, specs, keep_frac=0.1, quantize=quantize)
        want, wst, wm = compress_gradients(tree, None, keep_frac=0.1,
                                           quantize=quantize)
        out = unplace_tree(ctx.mesh, got, specs)["w"]
        assert torch.equal(out, want["w"])
        assert torch.equal(unplace_tree(ctx.mesh, [s.residual for s in
                                                   states], specs)["w"],
                           wst.residual["w"])
        if not quantize:
            assert int((out != 0).sum()) == 25
        for i in range(ctx.mesh.size):  # every replica the same bits
            first = ctx.mesh.axis_index("model", i) \
                if spec_name == "over data" else 0
            assert torch.equal(got[i]["w"], got[first]["w"])
        assert m[0]["wire_bytes_ratio"] == wm["wire_bytes_ratio"]


@needs_reference
def test_wire_bytes_ratio_from_logical_sizes():
    """The ratio counts every leaf at its logical size, not a block's: the
    reference's on the whole tree, for both packages' train states."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg, "cpu")
    params = model.init(0)
    ctx = _ctx({"pod": 2, "data": 2, "model": 2})
    specs = param_shardings(params, ctx.mesh, data_axes=ctx.data_axes,
                            cfg=cfg)
    grads = place_tree(ctx.mesh, tree_map(torch.ones_like, params), specs)
    for quantize in (True, False):
        _, _, m = compress_gradients_mesh(ctx, grads, None, specs,
                                          keep_frac=KEEP, quantize=quantize)
        _, _, jm = j_compression.compress_gradients(
            {p: jnp.ones(t.shape) for p, t in leaves_with_paths(params)},
            None, keep_frac=KEEP, quantize=quantize)
        assert m[0]["wire_bytes_ratio"] == jm["wire_bytes_ratio"]
        assert all(x == m[0] for x in m)


def test_microbatched_compression_runs_once():
    """With 2 microbatches the sharded compressed step equals the
    unsharded port's, which compresses the accumulated gradient once."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg, "cpu")
    loop = _loop(microbatches=2)
    state = init_train_state(model, 0, loop)
    _, batch = _batch(cfg, seed=40)
    want_state, want = make_train_step(model, loop)(state, batch)
    ctx = _ctx({"data": 4, "model": 2})
    placed, specs = _placed(ctx, state, cfg)
    new, m = make_train_step(model, loop, ctx=ctx)(placed, batch)
    for k in want:
        np.testing.assert_allclose(float(m[0][k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    got = unplace_tree(ctx.mesh, new, specs)
    for (path, a), (_, b) in zip(leaves_with_paths(got),
                                 leaves_with_paths(want_state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5,
                                   err_msg=path)


def test_compressed_state_restores_onto_another_mesh(tmp_path):
    """A compressed state placed on (data 2, model 2), a step, saved
    whole (the residual with it), restored onto (data 4, model 2): the
    residual comes back bit for bit, and the next step equals the one
    taken on the first mesh."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg, "cpu")
    loop = _loop()
    state = init_train_state(model, 0, loop)
    first = _ctx({"data": 2, "model": 2})
    placed, specs = _placed(first, state, cfg)
    step1 = make_train_step(model, loop, ctx=first)
    placed, _ = step1(placed, _batch(cfg, seed=50)[1])
    save(tmp_path, 1, placed, mesh=first.mesh, shardings=specs)
    saved = unplace_tree(first.mesh, placed, specs)
    second = _ctx({"data": 4, "model": 2})
    specs2 = param_shardings(state, second.mesh, data_axes=("data",),
                             cfg=cfg)
    restored = restore_resharded(tmp_path, 1, state, specs2,
                                 mesh=second.mesh, copy=True)
    assert isinstance(restored[0]["compress"], CompressionState)
    back = unplace_tree(second.mesh, restored, specs2)
    for (path, a), (_, b) in zip(leaves_with_paths(back),
                                 leaves_with_paths(saved)):
        assert torch.equal(a, b), path
    _, tb = _batch(cfg, seed=51)
    want, wm = step1(placed, tb)
    got, m = make_train_step(model, loop, ctx=second)(restored, tb)
    np.testing.assert_allclose(float(m[0]["loss"]), float(wm[0]["loss"]),
                               rtol=LOSS_RTOL)
    a = dict(leaves_with_paths(unplace_tree(second.mesh, got, specs2)))
    for path, b in leaves_with_paths(unplace_tree(first.mesh, want, specs)):
        np.testing.assert_allclose(a[path].numpy(), b.numpy(), rtol=0,
                                   atol=1e-5, err_msg=path)


@needs_reference
def test_reference_jit_refuses_the_compression_state():
    """Why the oracle is the reference's eager step: ``jax.jit`` of its
    compressed step raises on ``CompressionState``, which is no
    registered pytree; the port's ``Runtime.train`` runs compressed."""
    from repro_torch.runtime import Runtime

    cfg, jmodel, jparams, _, _ = _pair("tinyllama-1.1b")
    jloop = JTrainLoopConfig(compression=True)
    jstate = {"params": jparams, "opt": j_adamw.adamw_init(jparams),
              "step": jnp.zeros((), jnp.int32),
              "compress": j_compression.init_compression(jparams)}
    jb, _ = _batch(cfg, seed=60)
    with pytest.raises(TypeError, match="CompressionState"):
        jax.jit(j_make_train_step(jmodel, jloop))(jstate, jb)
    res = Runtime(device="cpu").train(cfg, _loop(), steps=2, batch=2, seq=16,
                                      log=lambda _: None)
    assert res.steps_run == 2 and np.isfinite(res.final_loss)
    assert isinstance(res.state["compress"], CompressionState)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(CASES))
def test_mesh_compression_on_card(arch):
    """The sharded gradient on 8 positions of GPU 0 (reduced, fp32),
    compressed on the mesh, against the port's single-device
    ``compress_gradients`` of the same gradient joined back, bit for bit,
    over 3 gradients with the residual carried."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda "
                    "tests/test_torch_compress_mesh.py`")
    cfg = get_config(arch).reduced()
    model = build_model(cfg, "cuda")
    params = model.init(0)
    mesh = make_mesh(CASES[arch], shards_per_device=8)
    ctx = ShardingCtx(mesh=mesh, data_axes=tuple(
        a for a in CASES[arch] if a != "model"))
    specs = param_shardings(params, mesh, data_axes=ctx.data_axes, cfg=cfg)
    placed = place_tree(mesh, params, specs)
    states, st = None, None
    for i in range(3):
        _, tb = _batch(cfg, seed=30 + i)
        tb = tree_map(lambda t: t.cuda(), tb)
        _, _, grads = make_grad_fn(model, ctx=ctx)(placed, tb)
        got, states, _ = compress_gradients_mesh(ctx, grads, states, specs)
        want, st, _ = compress_gradients(unplace_tree(mesh, grads, specs),
                                         st)
        out = dict(leaves_with_paths(unplace_tree(mesh, got, specs)))
        for path, w in leaves_with_paths(want):
            assert torch.equal(out[path], w), f"step {i} {path}"
