"""The encoder-decoder (seamless-m4t-medium) on the mesh, on the CPU: the
port's sharded loss, gradients, train step, prefill, decode and serving
on CPU meshes (``make_mesh(..., device="cpu", shards_per_device=n)``, a
position a stand-in for one of the reference's forced host devices)
against the reference, at reduced size (``.reduced()``: 2 + 2 layers, d
64, 4 heads of 16, d_ff 128, vocab 256, fp32), from the reference's
parameters (``params_from_jax``) and numpy-seeded batches.

* the sharded ``EncDecModel.loss(params, batch, ctx)`` on ``{"data": 4,
  "model": 2}`` and ``{"pod": 2, "data": 2, "model": 2}`` against the
  reference's unsharded ``loss`` (rtol 1e-5); every gradient against
  ``jax.grad`` and one ``make_train_step(ctx=)`` step against the
  reference's unsharded ``make_train_step`` at
  ``tests/test_torch_train_mesh.py``'s tolerances (atol 1e-4; each
  parameter's change within 1e-3 x max|reference change|, AdamW eps
  1e-3 both sides);
* ``prefill(ctx)`` logits (the encoder and a cross term that is not
  zero) on a serve mesh at model 2, 4 and 8 (at 8 the 4 heads do not
  divide the axis: attention replicates, the FFN, ``wo`` rows and the
  vocabulary split) and on a training mesh, against the reference's
  ``prefill`` (atol 1e-4);
* ``decode_step(ctx)`` from cross caches filled with the encoded frames,
  4 steps a token, against the reference's decode (atol 1e-4);
* greedy tokens of ``Runtime.serve(mesh_shape=..., shard_params="shard")``
  at model 2, 4 and 8, 6 requests over 2 slots, equal to the reference's
  single-device static serve; the caches split by kv heads where they
  divide; ``serve_shard`` ledgered predicted and measured, its KV bytes
  with the cross caches;
* the elastic restore: 3 steps on ``{"data": 2, "model": 2}``, saved
  whole, restored onto ``{"data": 4, "model": 2}``, a fourth step, equal
  to the reference's uninterrupted unsharded run;
* the param and decode-state specs against the reference's
  (``enc_<i>``/``dec_<i>``/``cross_<i>`` in its tree), computed once in a
  subprocess on an ``AxisType.Auto`` mesh;
* on a card only (``cuda`` marker): the sharded loss and the served
  tokens on positions of GPU 0 against the port's unsharded ones.
"""

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
    from repro.models import build_model as j_build_model
    from repro.models import encdec as jencdec
    from repro.models.common import rmsnorm as j_rmsnorm
    from repro.optim import adamw as j_adamw
    from repro.serving import ServeEngine as JStatic
    from repro.training import TrainLoopConfig as JTrainLoopConfig
    from repro.training import make_train_step as j_make_train_step
except ImportError:
    jax = None

from repro_torch.checkpoint import restore_resharded, save  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    encdec_state_from_jax,
    params_from_jax,
)
from repro_torch.distributed import make_mesh, take  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ShardingCtx,
    batch_sharding,
    param_shardings,
    place_tree,
    serve_state_sharding,
    unplace_tree,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import ENCDEC_DECODE_ENC_LEN  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.serving.scheduler import ServeScheduler  # noqa: E402
from repro_torch.training import (  # noqa: E402
    TrainLoopConfig,
    make_grad_fn,
    make_train_step,
)
from repro_torch.tree import (  # noqa: E402
    leaves_with_paths,
    tree_map,
    tree_map_with_path,
)

ARCH = "seamless-m4t-medium"
MESHES = {"d4m2": {"data": 4, "model": 2},
          "p2d2m2": {"pod": 2, "data": 2, "model": 2}}
B, S, S_ENC = 8, 16, 20
LOSS_RTOL = 1e-5
ATOL = 1e-4
CHANGE_RTOL = 1e-3
STEP_LR, STEP_EPS = 1e-2, 1e-3
N_REQ, SLOTS, P_LEN, NEW = 6, 2, 8, 8
MAX_LEN = P_LEN + NEW


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(cfg, seed, b=B, s=S, s_enc=S_ENC):
    """Tokens (B, S) and frames (B, S_enc, d) for both packages: N(0, 1) x
    0.1 frames, as the data pipeline makes them."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = (rng.standard_normal((b, s_enc, cfg.d_model)) * 0.1).astype(
        np.float32)
    return ({"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
            if jax is not None else None,
            {"tokens": torch.from_numpy(tokens).long(),
             "frames": torch.from_numpy(frames)})


def _ctx(shape):
    mesh = make_mesh(shape, device="cpu",
                     shards_per_device=int(np.prod(list(shape.values()))))
    return ShardingCtx(mesh=mesh, data_axes=tuple(
        a for a in shape if a != "model"))


def _serve_ctx(tp):
    return ShardingCtx(mesh=make_mesh({"data": 1, "model": tp},
                                      device="cpu", shards_per_device=tp),
                       data_axes=())


def _placed(ctx, tree, cfg, copy=False):
    specs = param_shardings(tree, ctx.mesh, data_axes=ctx.data_axes,
                            cfg=cfg)
    return place_tree(ctx.mesh, tree, specs, copy=copy), specs


def _batch(ctx, tb):
    return place_tree(ctx.mesh, tb, batch_sharding(tb, ctx.mesh,
                                                   ctx.data_axes))


_PAIR: dict = {}


def _pair():
    """(cfg, the reference's model and params, the port's model and the
    same params), built once a module."""
    if not _PAIR:
        jcfg, cfg = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
        jmodel = j_build_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        _PAIR["v"] = (cfg, jcfg, jmodel, jparams, build_model(cfg, "cpu"),
                      params_from_jax(_np(jparams), cfg, "cpu"))
    return _PAIR["v"]


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


def _step_loop():
    return (TrainLoopConfig(optimizer=adamw.AdamWConfig(lr=STEP_LR,
                                                        eps=STEP_EPS),
                            warmup_steps=0),
            JTrainLoopConfig(optimizer=j_adamw.AdamWConfig(lr=STEP_LR,
                                                           eps=STEP_EPS),
                             warmup_steps=0))


# ---------------------------------------------------------------------------
# Training: loss, gradients and a step against the reference's unsharded
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_sharded_loss_matches_reference(mesh_key):
    cfg, _, jmodel, jparams, model, params = _pair()
    jb, tb = _inputs(cfg, seed=1)
    jloss, jmet = jax.jit(jmodel.loss)(jparams, jb)
    ctx = _ctx(MESHES[mesh_key])
    placed, _ = _placed(ctx, params, cfg)
    losses, mets = model.loss(placed, _batch(ctx, tb), ctx)
    assert len(losses) == ctx.mesh.size
    assert all(torch.equal(x, losses[0]) for x in losses)
    np.testing.assert_allclose(float(losses[0]), float(jloss),
                               rtol=LOSS_RTOL)
    assert set(mets[0]) == set(jmet) == {"ce", "z"}
    for k in jmet:
        np.testing.assert_allclose(float(mets[0][k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    # a global batch dict is split over the data axes here
    again, _ = model.loss(placed, tb, ctx)
    assert torch.equal(again[0], losses[0])


@needs_reference
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_sharded_gradients_and_step_match_reference(mesh_key):
    cfg, _, jmodel, jparams, model, params = _pair()
    jb, tb = _inputs(cfg, seed=2)
    jgrads = jax.grad(lambda p: jmodel.loss(p, jb)[0])(jparams)
    ctx = _ctx(MESHES[mesh_key])
    loop, jloop = _step_loop()
    state = {"params": params, "opt": adamw.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    placed, specs = _placed(ctx, state, cfg, copy=True)
    pb = _batch(ctx, tb)
    _, _, grads = make_grad_fn(model, ctx=ctx)(
        [p["params"] for p in placed], pb)
    whole = unplace_tree(ctx.mesh, grads, specs["params"])
    want = dict(leaves_with_paths(params_from_jax(_np(jgrads), cfg, "cpu")))
    paths = [p for p, _ in leaves_with_paths(whole)]
    assert any(p.startswith("encoder/1/") for p in paths)
    assert "decoder/1/cross/wk" in paths and "enc_final_norm/scale" in paths
    for path, g in leaves_with_paths(whole):
        np.testing.assert_allclose(g.numpy(), want[path].numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"grad {path}")
    jstate = {"params": jparams, "opt": j_adamw.adamw_init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jax.jit(j_make_train_step(jmodel, jloop))(jstate, jb)
    new, m = make_train_step(model, loop, ctx=ctx)(placed, pb)
    assert set(m[0]) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[0][k]), float(jm[k]), atol=ATOL,
                                   rtol=1e-6, err_msg=k)
        assert all(float(x[k]) == float(m[0][k]) for x in m), k
    got = unplace_tree(ctx.mesh, [p["params"] for p in new],
                       specs["params"])
    _changes_match(params, got, params_from_jax(_np(jstate["params"]), cfg,
                                                "cpu"))


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


PREFILL_MESHES = ["tp2", "tp4", "tp8", "d4m2"]


@needs_reference
@pytest.mark.parametrize("where", PREFILL_MESHES)
def test_prefill_logits_match_reference(where):
    """``prefill(ctx)``: the encoder over 20 frames, the decoder over 16
    tokens against it, the last position's logits, each position's rows
    (all of them on a serve mesh), the vocab gathered."""
    cfg, _, jmodel, jparams, model, params = _pair()
    jb, tb = _inputs(cfg, seed=3)
    want = np.asarray(jax.jit(jmodel.prefill)(jparams, jb))
    ctx = _serve_ctx(int(where[2:])) if where.startswith("tp") else \
        _ctx(MESHES[where])
    placed, _ = _placed(ctx, params, cfg)
    logits = model.prefill(placed, tb, ctx)
    assert len(logits) == ctx.mesh.size
    rows = B // ctx.dp
    for i, lg in enumerate(logits):
        d = ctx.mesh.axis_index("data", i)
        assert lg.shape == (rows, 1, cfg.vocab_size)
        np.testing.assert_allclose(take(ctx.mesh, logits, i).numpy(),
                                   want[d * rows:(d + 1) * rows],
                                   atol=ATOL, rtol=0, err_msg=f"pos {i}")


@needs_reference
@pytest.mark.parametrize("tp", [2, 8])
def test_decode_from_filled_cross_caches_matches_reference(tp):
    """A 5-token chunk, then 4 greedy steps a token, from cross caches
    filled with the reference's ``cross_kv`` of the encoded frames, placed
    by ``serve_state_sharding``: the logits each step against the
    reference's decode (atol 1e-4)."""
    cfg, jcfg, jmodel, jparams, model, params = _pair()
    jb, _ = _inputs(cfg, seed=4, b=2, s=5, s_enc=MAX_LEN)
    jst = jmodel.init_decode_state(2, MAX_LEN)
    x = jb["frames"]
    pos = jnp.broadcast_to(jnp.arange(MAX_LEN, dtype=jnp.int32), (2, MAX_LEN))
    for i in range(jcfg.encoder_layers):
        x = jencdec.encoder_layer_apply(jparams[f"enc_{i}"], jcfg, x, pos)
    enc = j_rmsnorm(jparams["enc_final_norm"], x, jcfg.norm_eps)
    for i in range(cfg.n_layers):
        k, v = jencdec.cross_kv(jparams[f"dec_{i}"], jcfg, enc)
        jst[f"cross_{i}"] = {"k": k, "v": v}
    st = encdec_state_from_jax(_np(jst), cfg, "cpu")
    ctx = _serve_ctx(tp)
    placed, _ = _placed(ctx, params, cfg)
    sts = place_tree(ctx.mesh, st, serve_state_sharding(
        st, ctx.mesh, cfg=cfg), copy=True)
    heads = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else \
        cfg.n_kv_heads
    assert sts[0]["layers"][0]["cross"]["k"].shape[2] == heads
    feed = np.asarray(jb["tokens"])
    for step in range(5):
        want, jst = jmodel.decode_step(jparams, jst,
                                       {"tokens": jnp.asarray(feed)})
        batch = {"tokens": torch.from_numpy(feed).long()}
        logits, sts = model.decode_step(placed, sts, [batch] * ctx.mesh.size,
                                        ctx)
        np.testing.assert_allclose(take(ctx.mesh, logits, 0).numpy(),
                                   np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=f"step {step}")
        feed = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(
            np.int32)
    assert all(int(s["pos"]) == 9 for s in sts)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _trace(cfg):
    return synthetic_trace(N_REQ, prompt_len=P_LEN, max_new=NEW,
                           vocab_size=cfg.vocab_size, arrival="all", seed=0)


def _rows(report):
    return np.stack([report.output(f"r{i}", NEW) for i in range(N_REQ)])


@needs_reference
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_sharded_serve_token_identity(tp):
    cfg, _, jmodel, jparams, model, params = _pair()
    prompts = np.stack([np.asarray(r.prompt, np.int32)
                        for r in _trace(cfg)])
    want = JStatic(jmodel, jparams, max_len=MAX_LEN, eos_id=0).generate(
        prompts, max_new_tokens=NEW)
    rt = Runtime(device="cpu")
    res = rt.serve(cfg, _trace(cfg), mode="continuous", model=model,
                   params=params, slots=SLOTS, max_len=MAX_LEN, eos_id=0,
                   mesh_shape={"data": 1, "model": tp},
                   shard_params="shard", shards_per_device=tp)
    rep = res.report
    np.testing.assert_array_equal(_rows(rep), np.asarray(want))
    assert res.engine.tp == tp and rep.device_count == tp
    assert rep.collective_ops > 0
    rows = [e for e in rt.ledger.entries if e.site == "serve_shard"]
    assert rows and all(e.choice == "shard_model" for e in rows)
    assert any(e.measured_s is not None for e in rows)
    assert any(e.measured_s is None for e in rows)
    # each position's caches: kv heads split where they divide the axis
    layer = res.engine.pool.state[0]["layers"][0]
    heads = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else \
        cfg.n_kv_heads
    assert layer["k"].shape[2] == layer["cross"]["k"].shape[2] == heads
    assert layer["cross"]["k"].data_ptr() != res.engine.pool.state[1][
        "layers"][0]["cross"]["k"].data_ptr()


def test_serve_shard_prices_the_cross_caches():
    """The serve_shard site's KV bytes a slot hold the cross caches
    (min(ENCDEC_DECODE_ENC_LEN, max_len) rows a decoder layer) beside the
    self-attention caches; the other sites keep the reference's bytes."""
    cfg = get_config(ARCH)
    for max_len in (512, 8192):
        sched = ServeScheduler(cfg, max_len=max_len)
        per_row = 2 * cfg.n_layers * cfg.n_kv_heads * \
            cfg.resolved_head_dim * 2
        assert sched.kv_bytes_per_slot == per_row * max_len
        assert sched.shard_kv_bytes_per_slot == per_row * (
            max_len + min(ENCDEC_DECODE_ENC_LEN, max_len))
        _, dec = sched.serve_shard(4, tp=2)
        assert dec.query.as_dict()["kv_bytes_per_slot"] == \
            sched.shard_kv_bytes_per_slot
    tiny = ServeScheduler(get_config("tinyllama-1.1b"), max_len=512)
    assert tiny.shard_kv_bytes_per_slot == tiny.kv_bytes_per_slot


# ---------------------------------------------------------------------------
# Elastic restore
# ---------------------------------------------------------------------------


@needs_reference
def test_elastic_restore_matches_reference_unsharded_run(tmp_path):
    """3 steps on (data 2, model 2), saved whole, restored onto (data 4,
    model 2), a fourth step: equal to the reference's uninterrupted
    unsharded run."""
    cfg, _, jmodel, jparams, model, params = _pair()
    loop, jloop = _step_loop()
    batches = [_inputs(cfg, seed=10 + i, b=4) for i in range(4)]
    jstate = {"params": jparams, "opt": j_adamw.adamw_init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(j_make_train_step(jmodel, jloop))
    for jb, _ in batches:
        jstate, jm = jstep(jstate, jb)
    state = {"params": tree_map(torch.clone, params),
             "opt": adamw.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    first = _ctx({"data": 2, "model": 2})
    placed, specs = _placed(first, state, cfg, copy=True)
    step = make_train_step(model, loop, ctx=first, donate=True)
    for _, tb in batches[:3]:
        placed, _ = step(placed, _batch(first, tb))
    save(tmp_path, 3, placed, mesh=first.mesh, shardings=specs)
    second = _ctx({"data": 4, "model": 2})
    specs2 = param_shardings(state, second.mesh, data_axes=("data",),
                             cfg=cfg)
    restored = restore_resharded(tmp_path, 3, state, specs2,
                                 mesh=second.mesh, copy=True)
    assert all(int(p["step"]) == 3 for p in restored)
    assert restored[0]["params"]["decoder"][0]["cross"]["wq"].shape[0] == \
        cfg.d_model // 4
    restored, m = make_train_step(model, loop, ctx=second)(
        restored, batches[3][1])
    for k in jm:
        np.testing.assert_allclose(float(m[0][k]), float(jm[k]), atol=ATOL,
                                   rtol=1e-6, err_msg=k)
    got = unplace_tree(second.mesh, [p["params"] for p in restored],
                       specs2["params"])
    _changes_match(params, got, params_from_jax(_np(jstate["params"]), cfg,
                                                "cpu"))


# ---------------------------------------------------------------------------
# The specs against the reference's (one subprocess)
# ---------------------------------------------------------------------------

_REFERENCE = """
from repro.configs import get_config
from repro.distributed.sharding import param_shardings, serve_state_sharding
from repro.models import build_model

model = build_model(get_config("seamless-m4t-medium").reduced())
shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
state = jax.eval_shape(lambda: model.init_decode_state(2, 16, per_slot=True))


def specs_of(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): [list(a) if isinstance(a, tuple) else a
                                      for a in s.spec]
            for path, s in flat}


for name, shape, names, data in (
        ("d4m2", (4, 2), ("data", "model"), ("data",)),
        ("p2d2m2", (2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
        ("serve8", (1, 8), ("data", "model"), ()),
        ("serve2", (1, 2), ("data", "model"), ())):
    mesh = auto_mesh(shape, names)
    OUT[f"params/{name}"] = np.array(json.dumps(specs_of(param_shardings(
        shapes, mesh, data_axes=data))))
    if not data:
        OUT[f"state/{name}"] = np.array(json.dumps(specs_of(
            serve_state_sharding(state, mesh))))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("encdec_mesh_ref") / "out.npz"
    return run_reference(_REFERENCE, out)


def _port_path(path):
    """A reference path in the port's tree: ``enc_<i>``/``dec_<i>`` as
    the lists ``encoder/<i>``/``decoder/<i>``."""
    return re.sub(r"^(enc|dec)_(\d+)/",
                  lambda m: f"{'encoder' if m[1] == 'enc' else 'decoder'}/"
                  f"{m[2]}/", path)


def _tuple(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


@needs_reference
@pytest.mark.parametrize("name", ["d4m2", "p2d2m2", "serve8", "serve2"])
def test_specs_match_reference(reference, name):
    """Every parameter's spec is the reference's (its (D, H, hd)
    attention leaves fused to (D, H*hd)); on a serve mesh the
    self-attention and cross caches split by kv heads as the reference's
    ``dec_``/``cross_`` caches do."""
    cfg = get_config(ARCH).reduced()
    shape = {"d4m2": {"data": 4, "model": 2},
             "p2d2m2": {"pod": 2, "data": 2, "model": 2},
             "serve8": {"data": 1, "model": 8},
             "serve2": {"data": 1, "model": 2}}[name]
    data = () if name.startswith("serve") else tuple(
        a for a in shape if a != "model")
    mesh = make_mesh(shape, device="cpu",
                     shards_per_device=int(np.prod(list(shape.values()))))
    model = build_model(cfg, "cpu")
    got = {}
    params = model.init(0)
    tree_map_with_path(lambda path, _, spec: got.__setitem__(path, spec),
                       params, param_shardings(params, mesh, data_axes=data,
                                               cfg=cfg))
    ref = json.loads(str(reference[f"params/{name}"]))
    assert {_port_path(p) for p in ref} == set(got)
    for path, spec in ref.items():  # (D, H, hd) attention fused
        assert got[_port_path(path)] == _tuple(spec)[:2 if len(spec) == 3
                                                     else None], path
    if not data:
        st = model.init_decode_state(2, 16, per_slot=True)
        sspecs = {}
        tree_map_with_path(lambda path, _, spec: sspecs.__setitem__(
            path, spec), st, serve_state_sharding(st, mesh))
        ref = json.loads(str(reference[f"state/{name}"]))
        assert len(ref) == len(sspecs) == 1 + 4 * cfg.n_layers
        for path, spec in ref.items():
            m = re.fullmatch(r"(dec|cross)_(\d+)/(k|v)", path)
            port = "pos" if m is None else f"layers/{m[2]}/" + (
                "cross/" if m[1] == "cross" else "") + m[3]
            assert sspecs[port] == _tuple(spec), path


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda "
                    "tests/test_torch_encdec_mesh.py`")


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_sharded_loss_on_card(mesh_key):
    """The sharded loss on 8 positions of GPU 0 (fp32, reduced) against
    the port's unsharded loss on the CPU from the same parameters."""
    _needs_card()
    cfg = get_config(ARCH).reduced()
    params = build_model(cfg, "cpu").init(0)
    _, tb = _inputs(cfg, seed=1)
    want = float(build_model(cfg, "cpu").loss(params, tb)[0])
    mesh = make_mesh(MESHES[mesh_key], shards_per_device=8)
    ctx = ShardingCtx(mesh=mesh, data_axes=tuple(
        a for a in MESHES[mesh_key] if a != "model"))
    card = tree_map(lambda t: t.cuda(), params)
    placed = place_tree(mesh, card, param_shardings(
        card, mesh, data_axes=ctx.data_axes, cfg=cfg))
    losses, _ = build_model(cfg, "cuda").loss(
        placed, tree_map(lambda t: t.cuda(), tb), ctx)
    np.testing.assert_allclose(float(losses[0]), want, rtol=LOSS_RTOL * 10)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_sharded_serve_token_identity_on_card(tp):
    """The served tokens (reduced, fp32) on ``tp`` positions of GPU 0
    against the port's unsharded continuous serve on the card."""
    _needs_card()
    cfg = get_config(ARCH).reduced()
    rt = Runtime(device="cuda")
    model = build_model(cfg, "cuda")
    params = model.init(0)
    want = rt.serve(cfg, _trace(cfg), mode="continuous", model=model,
                    params=params, slots=SLOTS, max_len=MAX_LEN, eos_id=0)
    res = rt.serve(cfg, _trace(cfg), mode="continuous", model=model,
                   params=params, slots=SLOTS, max_len=MAX_LEN, eos_id=0,
                   mesh_shape={"data": 1, "model": tp}, shard_params="shard",
                   shards_per_device=tp)
    np.testing.assert_array_equal(_rows(res.report), _rows(want.report))
    assert res.report.collective_ops > 0 and res.engine.tp == tp
    assert all(d.type == "cuda" for d in res.engine.mesh.devices)
