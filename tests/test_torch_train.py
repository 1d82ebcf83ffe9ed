"""The port's training path against the reference, on the CPU, at reduced
size (tinyllama-1.1b ``.reduced()``, fp32, batch 2, seq <= 32).

* optimizer pieces (``warmup_cosine``, ``clip_by_global_norm``,
  ``adamw_update`` with its decay mask, ``compress_gradients``) on the same
  arrays as the reference's: rtol/atol 1e-6 (fp32 elementwise);
* the loss and every gradient at step 0 against
  ``jax.value_and_grad(model.loss)``, on the reference's parameters carried
  across by ``params_from_jax``: atol 1e-4 (fp32, other summation orders);
* three ``make_train_step`` steps on the reference's own batches, with 1
  and 2 microbatches: losses and final parameters within 1e-4;
* ``plan_model`` against the reference's at one device, on the same
  hardware spec: same decisions and seconds (rtol 1e-9);
* port-only behaviour mirroring the reference's substrate and runtime
  tests: the data's step determinism and host partitioning, checkpoint
  round trip / atomicity / shape checks, ``Runtime(device="cpu").train``
  interruption and resume, the launcher.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the reference; a card machine without jax runs the rest
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.core.costs.engine import CostEngine as JCostEngine
    from repro.core.planner import plan_model as j_plan_model
    from repro.data import SyntheticLMData as JSyntheticLMData
    from repro.hw import V5E
    from repro.hw import HardwareSpec as JSpec
    from repro.models import build_model as j_build_model
    from repro.optim import adamw as j_adamw
    from repro.optim import compression as j_compression
    from repro.optim import schedule as j_schedule
    from repro.training import TrainLoopConfig as JTrainLoopConfig
    from repro.training import init_train_state as j_init_train_state
    from repro.training import make_train_step as j_make_train_step
except ImportError:
    jax = None

needs_reference = pytest.mark.skipif(
    jax is None, reason="needs jax and the reference package")

import repro_torch  # noqa: E402
from repro_torch.checkpoint import latest_step, restore, save  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.core.planner import plan_model  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.hw import H100, HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw, compression, schedule  # noqa: E402
from repro_torch.training import (  # noqa: E402
    TrainLoopConfig,
    make_grad_fn,
    make_train_step,
)
from repro_torch.tree import leaves_with_paths, tree_map  # noqa: E402

ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same(port_tree, want_tree, atol, what=""):
    """Every leaf of two port-layout trees within ``atol``."""
    want = dict(leaves_with_paths(want_tree))
    got = leaves_with_paths(port_tree)
    assert [p for p, _ in got] == list(want)
    for path, g in got:
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   want[path].float().numpy(), atol=atol,
                                   rtol=0, err_msg=f"{what} {path}")


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced tinyllama and its parameters, the port's
    model and the same parameters carried across."""
    jcfg = j_get_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams,
                model=model,
                params=params_from_jax(_np(jparams), cfg, "cpu"),
                batches=[np.asarray(JSyntheticLMData(
                    jcfg, seq_len=32, global_batch=2).batch_at(i)["tokens"])
                    for i in range(3)])


def _batch(tokens):
    return {"tokens": torch.from_numpy(np.array(tokens)).long()}


# ---------------------------------------------------------------------------
# Optimizer, schedule, compression
# ---------------------------------------------------------------------------


@needs_reference
def test_warmup_cosine_matches_reference():
    steps = np.arange(0, 130, 7)
    want = [float(j_schedule.warmup_cosine(s, peak_lr=3e-4, warmup_steps=10,
                                           total_steps=120)) for s in steps]
    got = schedule.warmup_cosine(torch.from_numpy(steps), peak_lr=3e-4,
                                 warmup_steps=10, total_steps=120)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(schedule.warmup_cosine(0, peak_lr=1.0, warmup_steps=10,
                                        total_steps=100)) == 0.0


@needs_reference
@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((10, 3)).astype(np.float32) * 30,
         "b": [rng.standard_normal((7,)).astype(np.float32)]}
    want, wgn = j_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                            max_norm)
    got, gn = adamw.clip_by_global_norm(tree_map(torch.from_numpy, g),
                                        max_norm)
    np.testing.assert_allclose(float(gn), float(wgn), rtol=1e-6)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["b"][0].numpy(), np.asarray(want["b"][0]),
                               rtol=1e-6, atol=1e-7)


@needs_reference
def test_decay_mask_selects_the_reference_leaves(ref):
    """The port's mask on its key paths (``layers/1/ln1/scale``) and the
    reference's on its own pick the same leaves of converted parameters."""
    marks = jax.tree_util.tree_map_with_path(
        lambda path, p: np.full(p.shape, float(j_adamw._decay_mask(path)),
                                np.float32), ref["jparams"])
    want = params_from_jax(marks, ref["cfg"], "cpu")
    decayed = []
    for path, leaf in leaves_with_paths(want):
        mark = adamw._decay_mask(path)
        assert torch.all(leaf == float(mark)), path
        decayed.append(mark)
    assert any(decayed) and not all(decayed)


@needs_reference
def test_adamw_update_matches_reference(ref):
    """Two AdamW updates (clip, bias correction, decoupled decay on the
    masked leaves) from the same parameters and gradients."""
    cfg, jparams = ref["cfg"], ref["jparams"]
    rng = np.random.default_rng(2)
    jgrads = [jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
        p.shape).astype(np.float32)), jparams) for _ in range(2)]
    ocfg = j_adamw.AdamWConfig(lr=1e-2)
    jp, jst = jparams, j_adamw.adamw_init(jparams)
    p = ref["params"]
    st = adamw.adamw_init(p)
    for jg in jgrads:
        jp, jst, jm = j_adamw.adamw_update(jp, jg, jst, ocfg)
        p, st, m = adamw.adamw_update(
            p, params_from_jax(_np(jg), cfg, "cpu"), st,
            adamw.AdamWConfig(lr=1e-2))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(st["count"]) == 2 and st["count"].dtype == torch.int32
    _same(p, params_from_jax(_np(jp), cfg, "cpu"), 1e-6, "param")
    _same(st["mu"], params_from_jax(_np(jst["mu"]), cfg, "cpu"), 1e-6, "mu")
    _same(st["nu"], params_from_jax(_np(jst["nu"]), cfg, "cpu"), 1e-6, "nu")


def test_adamw_keeps_bf16_params_and_fp32_moments():
    p = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    st = adamw.adamw_init(p)
    new, st2, _ = adamw.adamw_update(p, {"w": torch.ones((4,),
                                                         dtype=torch.bfloat16)},
                                     st, adamw.AdamWConfig(lr=0.1))
    assert new["w"].dtype == torch.bfloat16
    assert st2["mu"]["w"].dtype == torch.float32
    assert torch.all(p["w"] == 1)  # the input is left as it was


@pytest.mark.parametrize("block", [1, 7, 1 << 24])
def test_inplace_adamw_by_row_blocks_equals_functional(block, monkeypatch):
    """The in-place update runs a leaf a block of rows at a time
    (``adamw.INPLACE_BLOCK`` elements): the same values bit for bit as the
    functional update, for a bf16 leaf with a transposed gradient, an fp32
    one with decay and a 0-d one, at blocks of one element, a few rows,
    and the whole leaf."""
    monkeypatch.setattr(adamw, "INPLACE_BLOCK", block)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((9, 5), generator=gen).to(torch.bfloat16),
              "ln": {"scale": torch.randn((13,), generator=gen)},
              "s": torch.randn((), generator=gen)}
    grads = {"w": torch.randn((5, 9), generator=gen).to(torch.bfloat16).t(),
             "ln": {"scale": torch.randn((13,), generator=gen)},
             "s": torch.randn((), generator=gen)}
    cfg = adamw.AdamWConfig(lr=1e-2)
    st = adamw.adamw_init(params)
    st["mu"] = tree_map(lambda t: torch.randn(t.shape, generator=gen),
                        st["mu"])
    want, want_st, _ = adamw.adamw_update(params, grads, st, cfg)
    given = tree_map(torch.clone, params)
    given_st = tree_map(torch.clone, st)
    got, got_st, _ = adamw.adamw_update(given, grads, given_st, cfg,
                                        inplace=True)
    _same(got, want, 0.0, "params")
    _same(got_st["mu"], want_st["mu"], 0.0, "mu")
    _same(got_st["nu"], want_st["nu"], 0.0, "nu")
    assert got["w"] is given["w"] and got_st["nu"]["s"] is given_st["nu"]["s"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b", "gemma-2b",
                                  "recurrentgemma-2b"])
def test_donated_step_equals_functional_step_bit_for_bit(arch, dtype):
    """``make_train_step(donate=True)`` (what ``Runtime.train`` runs) writes
    the update into the state it is given and gives the functional step's
    values exactly: parameters, moments and metrics over three steps, the
    first at lr 0 (warmup), bf16 parameters included."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    model = build_model(cfg, "cpu")
    loop = TrainLoopConfig(optimizer=adamw.AdamWConfig(lr=1e-2),
                           warmup_steps=1)
    params = model.init(0)
    fresh = lambda: {"params": tree_map(torch.clone, params),  # noqa: E731
                     "opt": adamw.adamw_init(params),
                     "step": torch.zeros((), dtype=torch.int32)}
    functional, donated = fresh(), fresh()
    donated_leaves = [t for _, t in leaves_with_paths(donated["params"])]
    step_f = make_train_step(model, loop)
    step_d = make_train_step(model, loop, donate=True)
    data = SyntheticLMData(cfg, seq_len=16, global_batch=2, seed=3)
    for i in range(3):
        given = functional
        before = tree_map(torch.clone, given)
        functional, mf = step_f(given, data.batch_at(i))
        donated, md = step_d(donated, data.batch_at(i))
        _same(given, before, 0.0, "the functional step's input")
        assert {k: float(v) for k, v in mf.items()} == \
            {k: float(v) for k, v in md.items()}
    _same(donated["params"], functional["params"], 0.0, "params")
    _same(donated["opt"]["mu"], functional["opt"]["mu"], 0.0, "mu")
    _same(donated["opt"]["nu"], functional["opt"]["nu"], 0.0, "nu")
    assert int(donated["step"]) == int(functional["step"]) == 3
    # the donated step updated the very tensors it was given
    assert all(a is b for a, b in zip(
        donated_leaves, [t for _, t in leaves_with_paths(donated["params"])]))


@needs_reference
@pytest.mark.parametrize("quantize", [True, False])
def test_compress_gradients_matches_reference(quantize):
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((64,)).astype(np.float32),
         "s": rng.standard_normal((8,)).astype(np.float32)}
    jst, st = None, None
    for _ in range(3):  # error feedback carries over
        want, jst, jm = j_compression.compress_gradients(
            jax.tree.map(jnp.asarray, g), jst, keep_frac=0.25,
            quantize=quantize)
        got, st, m = compression.compress_gradients(
            tree_map(torch.from_numpy, g), st, keep_frac=0.25,
            quantize=quantize)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(st.residual[k].numpy(),
                                       np.asarray(jst.residual[k]),
                                       rtol=1e-6, atol=1e-6)
        assert m["wire_bytes_ratio"] == pytest.approx(jm["wire_bytes_ratio"])


# ---------------------------------------------------------------------------
# Loss, gradients, train steps
# ---------------------------------------------------------------------------


@needs_reference
def test_loss_and_every_gradient_match_reference(ref):
    tokens = ref["batches"][0]
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        ref["jmodel"].loss, has_aux=True))(ref["jparams"],
                                           {"tokens": jnp.asarray(tokens)})
    loss, met, grads = make_grad_fn(ref["model"])(ref["params"],
                                                  _batch(tokens))
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    for k in ("ce", "aux", "z"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), atol=ATOL,
                                   rtol=0, err_msg=k)
    _same(grads, params_from_jax(_np(jgrads), ref["cfg"], "cpu"), ATOL,
          "grad")


@needs_reference
def test_remat_on_and_off_give_equal_gradients(ref):
    batch = _batch(ref["batches"][1])
    on = make_grad_fn(ref["model"], remat=True)(ref["params"], batch)
    off = make_grad_fn(ref["model"], remat=False)(ref["params"], batch)
    assert float(on[0]) == float(off[0])
    _same(on[2], off[2], 0.0, "remat")


@needs_reference
def test_loss_is_chunked_above_two_chunks(ref):
    """``xent_auto`` switches to recomputed 1024-position chunks above
    2048; at a small chunk the two forms give the same loss and grads."""
    from repro_torch.models import model as mm

    rng = np.random.default_rng(5)
    cfg = ref["cfg"]
    table = torch.from_numpy(rng.standard_normal(
        (cfg.vocab_size, cfg.d_model)).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((2, 13, cfg.d_model)).astype(
        np.float32))
    tgt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 13)))
    mask = torch.ones((2, 13))
    direct = mm.xent_auto(table, x, tgt, mask, chunk=8)  # 13 <= 16
    g_direct = torch.autograd.grad(direct[0] + direct[1], table)[0]
    chunked = mm.xent_auto(table, x, tgt, mask, chunk=4)  # 13 > 8
    g_chunked = torch.autograd.grad(chunked[0] + chunked[1], table)[0]
    for a, b in zip(direct, chunked):
        assert float(a.detach()) == pytest.approx(float(b.detach()), abs=1e-5)
    np.testing.assert_allclose(g_chunked.numpy(), g_direct.numpy(), atol=1e-6)


@needs_reference
def test_forward_logits_aux_is_a_device_tensor(ref):
    logits, aux = ref["model"].forward_logits(ref["params"],
                                              _batch(ref["batches"][0]))
    assert torch.is_tensor(aux) and aux.dim() == 0
    assert aux.dtype == torch.float32 and aux.device == ref["model"].device
    assert float(aux) == 0.0 and logits.dtype == torch.float32
    total, met = ref["model"].loss(ref["params"], _batch(ref["batches"][0]))
    assert all(t.device == ref["model"].device and t.dim() == 0
               for t in (total, *met.values()))


@needs_reference
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(ref, microbatches):
    """Three steps from the same parameters on the reference's batches, at
    a warmup of one step and a peak lr of 1e-2 so that steps 1 and 2 move
    every parameter: every metric within 1e-4, and each leaf's change over
    the three steps within 1e-3 x max|reference change| of the reference's,
    a change at least 10x that tolerance (a missing or mis-scaled update,
    or a microbatch left out, fails)."""
    jloop = JTrainLoopConfig(optimizer=j_adamw.AdamWConfig(lr=1e-2),
                             warmup_steps=1, microbatches=microbatches)
    jstate = j_init_train_state(ref["jmodel"], jax.random.PRNGKey(0), jloop)
    jstep = jax.jit(j_make_train_step(ref["jmodel"], jloop))
    cfg = ref["cfg"]
    params = params_from_jax(_np(jstate["params"]), cfg, "cpu")
    start = tree_map(torch.clone, params)
    state = {"params": params, "opt": adamw.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(ref["model"], TrainLoopConfig(
        optimizer=adamw.AdamWConfig(lr=1e-2), warmup_steps=1,
        microbatches=microbatches))
    for tokens in ref["batches"]:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, _batch(tokens))
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL,
                                       rtol=1e-6, err_msg=k)
    assert int(state["step"]) == 3
    want = dict(leaves_with_paths(params_from_jax(_np(jstate["params"]), cfg,
                                                  "cpu")))
    begin = dict(leaves_with_paths(start))
    for path, p in leaves_with_paths(state["params"]):
        moved = (p - begin[path]).numpy()
        want_moved = (want[path] - begin[path]).numpy()
        tol = 1e-3 * np.abs(want_moved).max()
        assert tol >= 1e-3 * 1e-3, f"{path}: the reference barely moved"
        assert np.abs(moved).max() >= 10 * tol, f"{path}: no update"
        np.testing.assert_allclose(moved, want_moved, atol=tol, rtol=0,
                                   err_msg=f"change of {path}")


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("spec", ["v5e", "h100"])
@pytest.mark.parametrize("shape", [("cli_train", 64, 8, "train"),
                                   ("train_4k", 4096, 256, "train"),
                                   ("decode_32k", 32768, 128, "decode")],
                         ids=lambda s: s[0])
@pytest.mark.parametrize("reduced", [False, True])
def test_plan_matches_reference(spec, shape, reduced):
    fields = (V5E if spec == "v5e" else H100).to_dict()
    jcfg = j_get_config("tinyllama-1.1b")
    cfg = get_config("tinyllama-1.1b")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    mesh = {"data": 1, "model": 1}
    want = j_plan_model(jcfg, JShapeSpec(*shape), mesh,
                        engine=JCostEngine(hw=JSpec.from_dict(fields)))
    eng = CostEngine(hw=HardwareSpec.from_dict(fields))
    got = plan_model(cfg, ShapeSpec(*shape), mesh, engine=eng)
    assert [(d.site, d.choice, d.reason) for d in got.decisions] == \
        [(d.site, d.choice, d.reason) for d in want.decisions]
    for g, w in zip(got.decisions, want.decisions):
        assert g.tp_cost == pytest.approx(w.tp_cost, rel=1e-9)
        assert g.rep_cost == pytest.approx(w.rep_cost, rel=1e-9)
    assert got.overrides == {k: tuple(v) for k, v in want.overrides.items()}
    assert (got.rnn_chunk, got.attn_chunk, got.fits_hbm) == \
        (want.rnn_chunk, want.attn_chunk, want.fits_hbm)
    assert got.hbm_per_chip == pytest.approx(want.hbm_per_chip, rel=1e-12)
    assert {e.site for e in eng.ledger.entries} == {"layer_shard"}


def test_plan_over_several_devices_waits_for_multi_gpu():
    """The plan over a mesh is analytic and no longer waits for several
    GPUs: over 8 devices each holds an eighth of the state (its parity:
    tests/test_torch_mesh.py); the Runtime's own plan is one device's."""
    cfg = get_config("tinyllama-1.1b")
    one = plan_model(cfg, ShapeSpec("t", 64, 8, "train"),
                     {"data": 1, "model": 1})
    eight = plan_model(cfg, ShapeSpec("t", 64, 8, "train"),
                       {"data": 2, "model": 4})
    assert [d.site for d in eight.decisions] == \
        [d.site for d in one.decisions]
    assert eight.hbm_per_chip < one.hbm_per_chip / 4
    rt = repro_torch.Runtime(device="cpu")
    plan = rt.plan(cfg, ShapeSpec("t", 64, 8, "train"))
    assert plan.fits_hbm and "fits=True" in plan.summary()


# ---------------------------------------------------------------------------
# Data, checkpoints, the loop (port-only behaviour)
# ---------------------------------------------------------------------------


def test_data_deterministic_by_step_and_structured():
    cfg = get_config("tinyllama-1.1b").reduced()
    ds = SyntheticLMData(cfg, seq_len=32, global_batch=4)
    b1, b2, b3 = ds.batch_at(7), ds.batch_at(7), ds.batch_at(8)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    t = b1["tokens"]
    assert t.dtype == torch.int64 and t.shape == (4, 32)
    assert t.min() >= 0 and t.max() < cfg.vocab_size
    # the backbone: consecutive non-noise tokens step by the row's a mod V
    steps = (t[:, 1:3] - t[:, 0:2]) % cfg.vocab_size
    assert torch.equal(steps[:, 0], steps[:, 1])
    assert torch.all((steps[:, 0] >= 1) & (steps[:, 0] < 97))
    other = SyntheticLMData(cfg, seq_len=32, global_batch=4, seed=1)
    assert not torch.equal(other.batch_at(7)["tokens"], t)


def test_data_host_sharding_partitions_batch():
    cfg = get_config("tinyllama-1.1b").reduced()
    h0 = SyntheticLMData(cfg, seq_len=16, global_batch=8, n_hosts=2,
                         host_id=0)
    h1 = SyntheticLMData(cfg, seq_len=16, global_batch=8, n_hosts=2,
                         host_id=1)
    assert h0.host_batch == 4 and h1.host_batch == 4
    assert h0.batch_at(3)["tokens"].shape == (4, 16)
    assert not torch.equal(h0.batch_at(3)["tokens"], h1.batch_at(3)["tokens"])
    with pytest.raises(ValueError, match="split"):
        SyntheticLMData(cfg, seq_len=16, global_batch=7, n_hosts=2).host_batch


def _tiny_state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "h": torch.arange(4.0).to(torch.bfloat16)},
            "opt": {"mu": [torch.zeros((2, 3))]},
            "step": torch.tensor(5, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    st = _tiny_state()
    save(tmp_path, 5, st)
    assert latest_step(tmp_path) == 5
    manifest = json.loads((tmp_path / "step_00000005" /
                           "manifest.json").read_text())
    assert manifest["keys"]["params/h"]["dtype"] == "bfloat16"
    assert "opt/mu/0" in manifest["keys"]
    back = restore(tmp_path, 5, tree_map(torch.zeros_like, st))
    for (pa, a), (pb, b) in zip(leaves_with_paths(st),
                                leaves_with_paths(back)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomic_no_partial_visible(tmp_path):
    save(tmp_path, 3, _tiny_state())
    crash = tmp_path / "step_00000009.tmp"
    crash.mkdir()
    (crash / "shard_0.npz").write_bytes(b"garbage")
    assert latest_step(tmp_path) == 3
    assert latest_step(tmp_path / "none") is None


def test_checkpoint_rejects_shape_mismatch_and_missing_keys(tmp_path):
    st = _tiny_state()
    save(tmp_path, 1, st)
    wrong = _tiny_state()
    wrong["params"]["w"] = torch.zeros((3, 3))
    with pytest.raises(ValueError, match="shape"):
        restore(tmp_path, 1, wrong)
    extra = _tiny_state()
    extra["params"]["x"] = torch.zeros(1)
    with pytest.raises(ValueError, match="missing"):
        restore(tmp_path, 1, extra)
    save(tmp_path, 2, st)
    assert latest_step(tmp_path) == 2
    restore(tmp_path, 1, st)  # the older step is still valid


def test_train_should_stop_interrupts_even_without_ckpt_dir():
    rt = repro_torch.Runtime(device="cpu")
    cfg = get_config("tinyllama-1.1b").reduced()
    res = rt.train(cfg, steps=5, batch=2, seq=16, log_every=0,
                   should_stop=lambda: True)
    assert res.interrupted and res.steps_run == 1 and not res.diverged
    assert np.isfinite(res.final_loss) and int(res.state["step"]) == 1


def test_train_resume_past_requested_steps_runs_zero(tmp_path):
    rt = repro_torch.Runtime(device="cpu")
    cfg = get_config("tinyllama-1.1b").reduced()
    plans = []
    first = rt.train(cfg, steps=2, batch=2, seq=16, log_every=0,
                     ckpt_dir=str(tmp_path), on_plan=plans.append)
    assert first.steps_run == 2 and latest_step(tmp_path) == 2
    assert plans and plans[0] is first.plan
    logs = []
    back = rt.train(cfg, steps=1, batch=2, seq=16, log_every=0,
                    ckpt_dir=str(tmp_path), resume=True, log=logs.append)
    assert back.start_step == 2 and back.steps_run == 0
    assert not back.diverged and not back.interrupted
    assert logs == ["resumed from step 2"]
    _same(back.state["params"], first.state["params"], 0.0, "resumed")


def test_train_launcher_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch

    out = tmp_path / "ledger.json"
    rc = launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps",
                      "2", "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "1",
                      "--report-overheads", "--ledger-out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "done: 2 steps" in text and "overhead plan" in text
    assert latest_step(tmp_path / "ck") == 2
    entries = json.loads(out.read_text())["entries"]
    assert {r["site"] for r in entries} == {"layer_shard"}


def test_train_entry_points_need_the_card_by_default():
    """Without a card, ``Runtime().train`` and the launcher raise rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: training runs on it")
    from repro_torch.launch import train as launch

    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        repro_torch.Runtime().train(get_config("tinyllama-1.1b").reduced(),
                                    steps=1)


def test_exports():
    assert repro_torch.TrainLoopConfig is TrainLoopConfig
    assert repro_torch.AdamWConfig is adamw.AdamWConfig
    assert repro_torch.ShapeSpec is ShapeSpec
    assert dataclasses.is_dataclass(repro_torch.TrainResult)
    from repro_torch.core import plan_model as exported

    assert exported is plan_model
    assert TrainLoopConfig() == TrainLoopConfig(
        optimizer=adamw.AdamWConfig(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                                    weight_decay=0.1, grad_clip=1.0))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_reduced_train_step_on_card_reaches_every_parameter():
    """One training step of the reduced model on the card: every
    parameter gets a gradient through the kernels (matmul forward and
    backward, flash forward and backward), and the step moves them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_train.py`")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.matmul import LAUNCHES
    from repro_torch.training import init_train_state

    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg, "cuda")
    loop = TrainLoopConfig(warmup_steps=1, total_steps=4)
    state = init_train_state(model, 0, loop)
    batch = SyntheticLMData(cfg, seq_len=32, global_batch=2,
                            device="cuda").batch_at(0)
    LAUNCHES.reset()
    fa.LAUNCHES.reset()
    loss, _, grads = make_grad_fn(model)(state["params"], batch)
    assert LAUNCHES.count > 0
    assert fa.LAUNCHES.forward == 2 * cfg.n_layers  # forward + recompute
    assert fa.LAUNCHES.backward == cfg.n_layers
    for path, g in leaves_with_paths(grads):
        assert g is not None and g.is_cuda and torch.isfinite(g).all(), path
    new, metrics = make_train_step(model, loop)(state, batch)
    new, metrics = make_train_step(model, loop)(new, batch)
    assert np.isfinite(float(metrics["loss"]))
    moved = [not torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_paths(state["params"]), leaves_with_paths(new["params"]))]
    assert all(moved)
