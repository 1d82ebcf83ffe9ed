"""The sequence-parallel decode attention against the reference, on CPU
meshes: a dense ``attn`` cache split along its length over the model axis
where the kv heads do not divide it (the reference's
``serve_state_sharding`` fallback and ``state_sharding``).

* token identity, reduced and fp32: tinyllama-1.1b (4 kv heads) on
  ``{"data": 1, "model": 8}`` and gemma-2b (1 kv head) on model 2 and 4,
  served continuously with the shard verdict forced, equal to the
  reference's static serve of the same parameters (``params_from_jax``)
  and trace; each position holds S/tp rows of every kv head;
* the logits of a prefilled chunk (the new rows straddle several blocks)
  and four decode steps through the length-split cache, within the fp32
  tolerance of the unsharded port's tests (1e-4) of the reference's and of
  the unsharded port's;
* the placement specs the serve engine and the dry run use (with ``cfg``)
  equal the reference's ``serve_state_sharding`` and ``state_sharding``
  on the same states (its abstract mesh, nothing compiled);
* mistral-nemo-12b decode_32k on the pod mesh: a position's cache bytes,
  read from the placed meta state without running a step, are 1/16 of its
  rows' whole cache.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the reference; a card machine without jax runs the rest
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model
    from repro.serving import ServeEngine as JStatic
except ImportError:
    jax = None

needs_reference = pytest.mark.skipif(
    jax is None, reason="needs jax and the reference package")

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed.mesh import make_mesh, take  # noqa: E402
from repro_torch.distributed.sharding import (ShardingCtx,  # noqa: E402
                                              param_shardings, place_shapes,
                                              place_tree,
                                              serve_state_sharding,
                                              state_sharding)
from repro_torch.launch.dryrun import decode_state_specs  # noqa: E402
from repro_torch.launch.mesh import (data_axes_of,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

ATOL = 1e-4  # the fp32 tolerance of the unsharded port's logits tests
N_REQ, SLOTS, P_LEN, NEW = 4, 2, 8, 8
MAX_LEN = P_LEN + NEW
CASES = [("tinyllama-1.1b", 8), ("gemma-2b", 2), ("gemma-2b", 4)]
IDS = [f"{a}-tp{t}" for a, t in CASES]

_PAIRS = {}


def _pair(arch):
    if arch not in _PAIRS:
        jcfg = j_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        jmodel = j_build_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu")
        _PAIRS[arch] = (cfg, jmodel, jparams, build_model(cfg, "cpu"), params)
    return _PAIRS[arch]


def _trace(cfg):
    return synthetic_trace(N_REQ, prompt_len=P_LEN, max_new=NEW,
                           vocab_size=cfg.vocab_size, arrival="all", seed=0)


@needs_reference
@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
def test_seq_split_serve_matches_reference_static(arch, tp):
    cfg, jmodel, jparams, model, params = _pair(arch)
    assert cfg.n_kv_heads % tp, "the kv heads do not divide the model axis"
    prompts = np.stack([np.asarray(r.prompt, np.int32) for r in _trace(cfg)])
    want = JStatic(jmodel, jparams, max_len=MAX_LEN, eos_id=0).generate(
        prompts, max_new_tokens=NEW)
    res = Runtime(device="cpu").serve(
        cfg, _trace(cfg), mode="continuous", model=model, params=params,
        slots=SLOTS, max_len=MAX_LEN, eos_id=0,
        mesh_shape={"data": 1, "model": tp}, shard_params="shard",
        shards_per_device=tp)
    got = np.stack([res.report.output(f"r{i}", NEW) for i in range(N_REQ)])
    np.testing.assert_array_equal(got, np.asarray(want))
    assert res.engine.tp == tp and res.report.collective_ops > 0
    pool = res.engine.pool.state
    hd = cfg.resolved_head_dim
    for st in pool:
        for layer in st["layers"]:
            assert tuple(layer["k"].shape) == (SLOTS, MAX_LEN // tp,
                                               cfg.n_kv_heads, hd)
    assert pool[0]["layers"][0]["k"].data_ptr() != \
        pool[1]["layers"][0]["k"].data_ptr()


@needs_reference
@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
def test_seq_split_logits_match_reference_and_unsharded(arch, tp):
    cfg, jmodel, jparams, model, params = _pair(arch)
    mesh = make_mesh({"data": 1, "model": tp}, device="cpu",
                     shards_per_device=tp)
    ctx = ShardingCtx(mesh=mesh, data_axes=(), infer_replicate_params=True,
                      kv_len=MAX_LEN)
    placed = place_tree(mesh, params, param_shardings(
        params, mesh, data_axes=(), cfg=cfg))
    state = model.init_decode_state(2, MAX_LEN)
    sts = place_tree(mesh, state, serve_state_sharding(state, mesh, cfg=cfg),
                     copy=True)
    assert sts[0]["layers"][0]["k"].shape[1] == MAX_LEN // tp
    jst = jmodel.init_decode_state(2, MAX_LEN)
    feed = np.random.default_rng(1).integers(1, cfg.vocab_size,
                                             (2, P_LEN)).astype(np.int32)
    for step in range(5):  # the prompt as one chunk, then 4 tokens
        want, jst = jmodel.decode_step(jparams, jst,
                                       {"tokens": jnp.asarray(feed)})
        batch = {"tokens": torch.from_numpy(feed).long()}
        with torch.no_grad():
            plain, state = model.decode_step(params, state, batch)
            logits, sts = model.decode_step(placed, sts, [batch] * mesh.size,
                                            ctx)
        for i in range(mesh.size):
            got = take(mesh, logits, i).numpy()
            np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                       rtol=0, err_msg=f"step {step}")
            np.testing.assert_allclose(got, plain.numpy(), atol=ATOL, rtol=0,
                                       err_msg=f"step {step}")
        feed = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(
            np.int32)
    assert all(int(s["pos"]) == P_LEN + 4 for s in sts)


@needs_reference
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-2b"])
@pytest.mark.parametrize("shape", [{"data": 1, "model": 8},
                                   {"data": 2, "model": 4}],
                         ids=["model8", "data2-model4"])
def test_placement_specs_match_reference(arch, shape):
    from jax.sharding import AbstractMesh

    from repro.distributed import sharding as J

    cfg, jmodel, _, model, _ = _pair(arch)
    data = tuple(a for a in shape if a != "model")
    jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    mesh = make_mesh(shape, device="cpu", shards_per_device=8)
    jstate = jax.eval_shape(lambda: jmodel.init_decode_state(
        SLOTS, MAX_LEN, per_slot=True))
    state = model.init_decode_state(SLOTS, MAX_LEN, per_slot=True)
    for jfn, fn in (
            (lambda st: J.serve_state_sharding(st, jmesh),
             lambda st: serve_state_sharding(st, mesh, cfg=cfg)),
            (lambda st: J.state_sharding(st, jmesh, data_axes=data),
             lambda st: decode_state_specs(cfg, st, mesh, data))):
        jspecs = {jax.tree_util.keystr(p): s.spec for p, s in
                  jax.tree_util.tree_flatten_with_path(jfn(jstate))[0]}
        want = [tuple(jspecs[f"['layers']['layer_{j}']['{kv}']"])
                for j in range(cfg.n_layers) for kv in "kv"]
        want = [w + (None,) * (4 - len(w)) for w in want]
        specs = fn(state)
        got = [tuple(layer[kv]) for layer in specs["layers"] for kv in "kv"]
        assert got == want
        assert all("model" in g for g in got)  # heads, else the length


def test_mistral_nemo_decode_32k_cache_a_position_is_a_sixteenth():
    cfg = get_config("mistral-nemo-12b")
    shape = SHAPES["decode_32k"]
    mesh = make_production_mesh()
    data = data_axes_of(mesh)
    model = build_model(cfg, "meta")
    state = model.init_decode_state(shape.global_batch, shape.seq_len)
    placed = place_shapes(mesh, state, decode_state_specs(cfg, state, mesh,
                                                          data))

    def cache_bytes(tree):
        return sum(t.numel() * t.element_size()
                   for path, t in leaves_with_paths(tree)
                   if path.endswith(("/k", "/v")))

    whole = cache_bytes(state)
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    assert whole == 2 * cfg.n_layers * shape.global_batch * shape.seq_len \
        * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    # a position's rows (1/dp of the batch), 1/16 of their cache length
    assert cache_bytes(placed[0]) * dp * tp == whole
    assert all(cache_bytes(p) == cache_bytes(placed[0]) for p in placed)
    k = placed[0]["layers"][0]["k"]
    assert tuple(k.shape) == (shape.global_batch // dp, shape.seq_len // tp,
                              cfg.n_kv_heads, cfg.resolved_head_dim)
