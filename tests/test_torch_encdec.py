"""The port's encoder-decoder family (seamless-m4t-medium) against the
reference, on the CPU, at reduced size (``.reduced()``: 2 encoder + 2
decoder layers, d 64, 4 MHA heads of hd 16, GELU FFN of 128, vocab 256,
fp32), on the reference's parameters carried across by
``params_from_jax``.

* the config's fields and ``param_count``, full and reduced;
* the carried-across tree has the port's own init layout;
* ``encoder_layer_apply``, ``decoder_layer_apply`` with and without a
  cache, and ``cross_kv``: atol 1e-5 (fp32, other summation orders);
* ``cross_attention`` (decoder queries, encoder keys, S != S_enc) against
  the reference's ``dense_attention(causal=False)``: atol 1e-5;
* ``prefill`` (encoder, cross attention, decoder), the loss and its parts:
  atol 1e-4;
* 4 decode steps, from the reference's zero-filled cross cache and from a
  cross cache filled with ``cross_kv`` of the encoded frames (the state
  carried across by ``encdec_state_from_jax``): atol 1e-4 a step;
* every gradient leaf of the loss through ``convert.py`` against
  ``jax.value_and_grad``: within 1e-4 x max|grad| a leaf;
* ``reset_decode_slots``, ``insert_decode_slot`` and
  ``merge_decode_state`` against the reference's, bit for bit;
* greedy tokens of the static and continuous engines equal the
  reference's engines', host syncs and dispatches too; ``Runtime.serve``
  static equals continuous; ``paged=True`` refused with the reference's
  message; both launchers run the family;
* ``frames`` in the data pipeline's batch; a ``Runtime.train`` run with a
  checkpoint that restores; a loss that falls on a fixed batch;
* the flash launch counter's counts by direction, mode and path, untouched
  by a call on CPU tensors;
* on a card only (``cuda`` marker): the flash kernels' non-causal modes at
  the encoder's and two ragged cross-attention shapes, through
  ``ops.flash_attention`` forward and backward, against the plain
  versions; and the reduced model card against CPU in fp32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the reference; a card machine without jax runs the rest
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.core.costs.engine import CostEngine as JCostEngine
    from repro.hw import V5E
    from repro.models import attention as jattn
    from repro.models import build_model as j_build_model
    from repro.models import encdec as jencdec
    from repro.models.common import rmsnorm as j_rmsnorm
    from repro.serving import ContinuousServeEngine as JContinuous
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JStatic
except ImportError:
    jax = None

needs_reference = pytest.mark.skipif(
    jax is None, reason="needs jax and the reference package")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    encdec_state_from_jax,
    params_from_jax,
)
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.models import EncDecModel, build_model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.model import ENCDEC_PAGED_REFUSAL  # noqa: E402
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousServeEngine,
    Request,
    ServeEngine,
)
from repro_torch.tree import leaves_with_paths, tree_map  # noqa: E402

ARCH = "seamless-m4t-medium"
ATOL = 1e-4
LAYER_ATOL = 1e-5
PROMPT_LEN, MAX_NEW = 7, 9
MAX_LEN = PROMPT_LEN + MAX_NEW


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=atol, rtol=0.0, err_msg=what)


_CACHE = {}


def _pair():
    """The reference's reduced model and parameters, the port's model and
    the same parameters carried across (built once)."""
    if not _CACHE:
        jcfg = j_get_config(ARCH).reduced()
        cfg = get_config(ARCH).reduced()
        jmodel = j_build_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        _CACHE.update(jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams,
                      model=build_model(cfg, "cpu"),
                      params=params_from_jax(_np(jparams), cfg, "cpu"))
    return _CACHE


def _inputs(cfg, b, s, s_enc=None, seed=0):
    """Tokens (B, S) int32 and frames (B, S_enc, d) fp32, N(0, 1) x 0.1 as
    the data pipeline makes them."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = (rng.standard_normal((b, s_enc or s, cfg.d_model)) * 0.1
              ).astype(np.float32)
    return tokens, frames


def _batches(tokens, frames):
    return ({"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
            {"tokens": _t(tokens).long(), "frames": _t(frames)})


def _j_encode(jcfg, jparams, frames):
    """The reference's encoder: its ``_build_encdec.encode`` has no entry
    of its own in the model record, so its body is repeated here."""
    x = jnp.asarray(frames)
    b, s = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    for i in range(jcfg.encoder_layers):
        x = jencdec.encoder_layer_apply(jparams[f"enc_{i}"], jcfg, x, pos)
    return j_rmsnorm(jparams["enc_final_norm"], x, jcfg.norm_eps)


def _positions(b, s, offset=0):
    return torch.arange(s)[None].expand(b, s) + offset


# ---------------------------------------------------------------------------
# The config and the parameters
# ---------------------------------------------------------------------------


@needs_reference
def test_config_and_param_count_match_reference():
    full, jfull = get_config(ARCH), j_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(jfull.reduced())
    assert full.param_count() == jfull.param_count() == 877_031_424
    assert full.reduced().param_count() == jfull.reduced().param_count()
    assert full.active_param_count() == jfull.active_param_count()
    assert (full.encoder_layers, full.n_layers, full.d_model,
            full.vocab_size) == (12, 12, 1024, 256206)


@needs_reference
def test_params_from_jax_layout():
    """The carried-across tree has the port's own init layout (paths,
    shapes, dtypes): ``encoder`` and ``decoder`` lists, ``ln_cross`` and
    ``cross`` in decoder layers only, an untied ``unembed``; the values
    are the reference's."""
    pair = _pair()
    model, cfg = pair["model"], pair["cfg"]
    assert isinstance(model, EncDecModel)
    mine = sorted((p, tuple(t.shape), t.dtype)
                  for p, t in leaves_with_paths(model.init(0)))
    got = sorted((p, tuple(t.shape), t.dtype)
                 for p, t in leaves_with_paths(pair["params"]))
    assert got == mine
    assert "cross" in pair["params"]["decoder"][0]
    assert "cross" not in pair["params"]["encoder"][0]
    jp = _np(pair["jparams"])
    np.testing.assert_array_equal(
        pair["params"]["decoder"][1]["cross"]["wq"].numpy(),
        np.reshape(jp["dec_1"]["cross"]["wq"], (cfg.d_model, -1)))
    np.testing.assert_array_equal(pair["params"]["unembed"].numpy(),
                                  jp["unembed"])


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------


@needs_reference
def test_encoder_layer_matches_reference():
    pair = _pair()
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    _, x = _inputs(cfg, 2, 19, seed=1)
    want = jencdec.encoder_layer_apply(
        pair["jparams"]["enc_1"], jcfg, jnp.asarray(x),
        jnp.broadcast_to(jnp.arange(19), (2, 19)))
    got = encdec.encoder_layer_apply(pair["params"]["encoder"][1], cfg, _t(x),
                                     _positions(2, 19))
    _close(got, want, LAYER_ATOL, "encoder layer")


@needs_reference
def test_cross_kv_matches_reference():
    pair = _pair()
    _, enc = _inputs(pair["cfg"], 2, 13, seed=2)
    jk, jv = jencdec.cross_kv(pair["jparams"]["dec_0"], pair["jcfg"],
                              jnp.asarray(enc))
    k, v = encdec.cross_kv(pair["params"]["decoder"][0], pair["cfg"], _t(enc))
    assert k.shape == (2, 13, 4, 16)
    _close(k, jk, LAYER_ATOL, "cross k")
    _close(v, jv, LAYER_ATOL, "cross v")


@needs_reference
@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
def test_decoder_layer_matches_reference(cached):
    """Without a cache: causal self-attention over 11 positions and cross
    attention to 17 encoder rows.  With one: 3 new positions at cache
    position 5 of a (2, 16) cache holding seeded values, the cross
    attention over the 17 rows (no mask)."""
    pair = _pair()
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    rng = np.random.default_rng(3)
    s = 3 if cached else 11
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    ek, ev = (rng.standard_normal((2, 17, 4, 16)).astype(np.float32)
              for _ in range(2))
    kw, jkw, off = {}, {}, 0
    if cached:
        off = 5
        kc, vc = (rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
                  for _ in range(2))
        jkw = dict(self_cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                   cache_pos=jnp.asarray(off, jnp.int32))
        kw = dict(self_cache={"k": _t(kc), "v": _t(vc)},
                  cache_pos=torch.tensor(off))
    want, jcache = jencdec.decoder_layer_apply(
        pair["jparams"]["dec_0"], jcfg, jnp.asarray(x),
        jnp.broadcast_to(jnp.arange(s) + off, (2, s)),
        (jnp.asarray(ek), jnp.asarray(ev)), **jkw)
    got, cache = encdec.decoder_layer_apply(
        pair["params"]["decoder"][0], cfg, _t(x), _positions(2, s, off),
        (_t(ek), _t(ev)), **kw)
    _close(got, want, LAYER_ATOL, "decoder layer")
    assert (cache is None) == (jcache is None) == (not cached)
    if cached:
        _close(cache["k"], jcache["k"], LAYER_ATOL, "self cache k")
        _close(cache["v"], jcache["v"], LAYER_ATOL, "self cache v")


@needs_reference
@pytest.mark.parametrize("cached", [False, True], ids=["loss", "decode"])
def test_cross_attention_matches_reference(cached):
    """9 decoder queries against 23 encoder rows, no mask: the CPU's form
    without and with a cache (both ``dense_attention``) against the
    reference's ``dense_attention(causal=False)``."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 23, 4, 16)).astype(np.float32)
            for _ in range(2))
    want = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False)
    got = attn.cross_attention(_t(q), _t(k), _t(v), cached=cached)
    assert got.shape == (2, 9, 4, 16)
    _close(got, want, LAYER_ATOL, "cross attention")


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@needs_reference
def test_prefill_and_loss_match_reference():
    """Prefill (12 decoder tokens against 20 frames: encoder, cross
    attention, decoder) and the loss with its parts, with and without
    recomputation."""
    pair = _pair()
    jm, jp, m, p = pair["jmodel"], pair["jparams"], pair["model"], \
        pair["params"]
    tokens, frames = _inputs(pair["cfg"], 2, 12, s_enc=20, seed=5)
    jb, tb = _batches(tokens, frames)
    got = m.prefill(p, tb)
    assert got.shape == (2, 1, pair["cfg"].vocab_size)
    _close(got, jm.prefill(jp, jb), ATOL, "prefill")
    jtotal, jmet = jm.loss(jp, jb)
    for remat in (False, True):
        total, met = m.loss(p, tb, remat=remat)
        assert set(met) == set(jmet) == {"ce", "z"}
        for name in ("ce", "z"):
            _close(met[name], jmet[name], ATOL, name)
        _close(total, jtotal, ATOL, "total loss")


@needs_reference
@pytest.mark.parametrize("filled", [False, True], ids=["zero", "filled"])
def test_decode_steps_match_reference(filled):
    """A 5-token prompt chunk, then 4 greedy decode steps, per step against
    the reference's (atol 1e-4): from the zero-filled cross caches
    ``init_decode_state`` makes (the serving path), and from caches filled
    with ``cross_kv`` of the encoded frames (max_len 16 rows of them)."""
    pair = _pair()
    jm, jp, m, p, cfg = pair["jmodel"], pair["jparams"], pair["model"], \
        pair["params"], pair["cfg"]
    tokens, frames = _inputs(cfg, 2, 5, s_enc=MAX_LEN, seed=6)
    jst = jm.init_decode_state(2, MAX_LEN)
    if filled:
        enc = _j_encode(pair["jcfg"], jp, frames)
        for i in range(cfg.n_layers):
            k, v = jencdec.cross_kv(jp[f"dec_{i}"], pair["jcfg"], enc)
            jst[f"cross_{i}"] = {"k": k, "v": v}
    st = encdec_state_from_jax(_np(jst), cfg, "cpu")
    assert st["pos"].dtype == torch.int64 and st["pos"].dim() == 0
    if filled:  # the port's encoder and cross_kv give the same cache
        enc_t = m.encode(p, _t(frames))
        k, _ = encdec.cross_kv(p["decoder"][1], cfg, enc_t)
        _close(k, st["layers"][1]["cross"]["k"].numpy(), ATOL, "cross cache")
    feed = tokens
    for step in range(5):
        want, jst = jm.decode_step(jp, jst, {"tokens": jnp.asarray(feed)})
        got, st = m.decode_step(p, st, {"tokens": _t(feed).long()})
        _close(got, want, ATOL, f"step {step}")
        feed = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(
            np.int32)
    assert int(st["pos"]) == int(jst["pos"]) == 5 + 4
    # the cross caches go through the steps untouched
    _close(st["layers"][0]["cross"]["v"], jst["cross_0"]["v"], 0.0, "cross")


@needs_reference
def test_loss_gradients_match_reference():
    """The loss and every parameter's gradient (encoder, cross attention,
    decoder, both embeddings and final norms) against
    ``jax.value_and_grad`` of the reference's, within 1e-4 x max|grad| a
    leaf (fp32), through the recomputed layers."""
    from repro_torch.training.step import make_grad_fn

    pair = _pair()
    tokens, frames = _inputs(pair["cfg"], 2, 16, seed=7)
    jb, tb = _batches(tokens, frames)
    jloss, jgrads = jax.value_and_grad(
        lambda q: pair["jmodel"].loss(q, jb)[0])(pair["jparams"])
    loss, _, grads = make_grad_fn(pair["model"])(pair["params"], tb)
    _close(loss, jloss, ATOL, "loss")
    want = params_from_jax(_np(jgrads), pair["cfg"], "cpu")
    paths = [p for p, _ in leaves_with_paths(grads)]
    assert paths == [p for p, _ in leaves_with_paths(want)]
    assert len(paths) == 4 + 2 * 8 + 2 * 13  # top, encoder, decoder leaves
    for (path, g), (_, w) in zip(leaves_with_paths(grads),
                                 leaves_with_paths(want)):
        top = w.abs().max().item()
        _close(g, w.numpy(), 1e-4 * top, path)


# ---------------------------------------------------------------------------
# Slot surgery
# ---------------------------------------------------------------------------


def _filled_state(jm, cfg, seed):
    """A per-slot reference decode state of 3 slots with seeded values in
    every cache and per-slot positions."""
    rng = np.random.default_rng(seed)
    jst = jm.init_decode_state(3, MAX_LEN, per_slot=True)
    jst = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jst)
    jst["pos"] = jnp.asarray([4, 7, 2], jnp.int32)
    return jst


@needs_reference
@pytest.mark.parametrize("op", ["reset", "insert", "merge"])
def test_slot_surgery_matches_reference(op):
    """``reset_decode_slots``, ``insert_decode_slot`` and
    ``merge_decode_state`` give the reference's state, self and cross
    caches and positions, bit for bit."""
    pair = _pair()
    jm, m, cfg = pair["jmodel"], pair["model"], pair["cfg"]
    jst = _filled_state(jm, cfg, 8)
    st = encdec_state_from_jax(_np(jst), cfg, "cpu")
    if op == "reset":
        mask = np.array([False, True, True])
        want = jm.reset_decode_slots(jst, mask)
        got = m.reset_decode_slots(st, mask)
    elif op == "insert":
        jsrc = jax.tree.map(lambda a: a[1:2], _filled_state(jm, cfg, 9))
        want = jm.insert_decode_slot(jst, jsrc, 2)
        got = m.insert_decode_slot(
            st, encdec_state_from_jax(_np(jsrc), cfg, "cpu"), 2)
    else:
        jnew = _filled_state(jm, cfg, 10)
        active = np.array([True, False, True])
        want = jm.merge_decode_state(jnew, jst, jnp.asarray(active))
        got = m.merge_decode_state(
            encdec_state_from_jax(_np(jnew), cfg, "cpu"), st,
            torch.from_numpy(active))
    want = encdec_state_from_jax(_np(want), cfg, "cpu")
    for (path, g), (_, w) in zip(leaves_with_paths(got),
                                 leaves_with_paths(want)):
        assert torch.equal(g, w), path


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _spec_engine():
    return CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))


def _outputs(report, n):
    return np.stack([report.output(f"r{i}", MAX_NEW) for i in range(n)])


@needs_reference
def test_served_tokens_match_reference_engines():
    """Static and continuous (3 requests on 2 slots, auto horizon, chunked
    prefill) against the reference's static and continuous engines, with
    its host syncs and dispatches."""
    pair = _pair()
    prompts, _ = _inputs(pair["cfg"], 3, PROMPT_LEN, seed=11)
    want = JStatic(pair["jmodel"], pair["jparams"], max_len=MAX_LEN,
                   eos_id=-1).generate(prompts, max_new_tokens=MAX_NEW)
    jrep = JContinuous(pair["jmodel"], pair["jparams"], max_len=MAX_LEN,
                       cost_engine=JCostEngine(hw=V5E), n_slots=2,
                       eos_id=-1).run(
        [JRequest(f"r{i}", prompts[i], MAX_NEW) for i in range(3)],
        now_fn=lambda: 0.0)
    np.testing.assert_array_equal(_outputs(jrep, 3), want)
    static = ServeEngine(pair["model"], pair["params"], max_len=MAX_LEN,
                         eos_id=-1).generate(prompts, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(static, want)
    rep = ContinuousServeEngine(
        pair["model"], pair["params"], max_len=MAX_LEN,
        cost_engine=_spec_engine(), n_slots=2, eos_id=-1).run(
        [Request(f"r{i}", prompts[i], MAX_NEW) for i in range(3)],
        now_fn=lambda: 0.0)
    np.testing.assert_array_equal(_outputs(rep, 3), want)
    assert rep.host_syncs == jrep.host_syncs
    assert rep.device_dispatches == jrep.device_dispatches


def test_runtime_serve_static_equals_continuous_on_cpu():
    cfg = get_config(ARCH).reduced()
    rt = Runtime(device="cpu")
    trace = lambda: synthetic_trace(  # noqa: E731
        5, prompt_len=6, max_new=5, vocab_size=cfg.vocab_size,
        arrival="all", seed=1)
    static = rt.serve(cfg, trace(), mode="static", eos_id=-1, warmup=False)
    cont = rt.serve(cfg, trace(), mode="continuous", slots=2, eos_id=-1,
                    warmup=False)
    assert static.generated_tokens == cont.generated_tokens == 25
    for rid, toks in static.outputs.items():
        np.testing.assert_array_equal(cont.outputs[rid], toks)


@needs_reference
def test_paged_serving_refused_with_reference_message():
    """``paged=True`` raises the reference's ValueError, word for word, from
    the engine, from ``Runtime.serve`` and from ``init_decode_state``."""
    pair = _pair()
    with pytest.raises(ValueError) as jerr:
        JContinuous(pair["jmodel"], pair["jparams"], max_len=MAX_LEN,
                    paged=True)
    assert str(jerr.value) == ENCDEC_PAGED_REFUSAL
    with pytest.raises(ValueError) as err:
        ContinuousServeEngine(pair["model"], pair["params"], max_len=MAX_LEN,
                              paged=True)
    assert str(err.value) == ENCDEC_PAGED_REFUSAL
    trace = synthetic_trace(2, prompt_len=4, max_new=2, vocab_size=256,
                            arrival="all")
    with pytest.raises(ValueError, match="enc-dec decode state"):
        Runtime(device="cpu").serve(pair["cfg"], trace, paged=True,
                                    warmup=False)
    with pytest.raises(ValueError, match="no paged layout"):
        pair["model"].init_decode_state(2, MAX_LEN, paging=(8, 4))


def test_serve_and_train_launchers_run_seamless(capsys):
    from repro_torch.launch import serve, train

    rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--requests", "3", "--max-new", "4", "--slots", "2",
                     "--engine", "both"])
    assert rc in (0, None)
    assert "r2" in capsys.readouterr().out
    rc = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--steps", "2", "--batch", "2", "--seq", "16"])
    assert rc in (0, None)
    assert "loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Data and training
# ---------------------------------------------------------------------------


def test_pipeline_batch_has_frames():
    """``frames`` (B, S, d) fp32, N(0, 1) x 0.1, one frame per token
    position, drawn from the step's generator: the same step gives the
    same frames, another step others."""
    from repro_torch.data import SyntheticLMData

    cfg = get_config(ARCH).reduced()
    ds = SyntheticLMData(cfg, seq_len=64, global_batch=4, seed=3)
    batch = ds.batch_at(5)
    assert set(batch) == {"tokens", "frames"}
    assert batch["frames"].shape == (4, 64, cfg.d_model)
    assert batch["frames"].dtype == torch.float32
    assert abs(batch["frames"].std().item() - 0.1) < 0.01
    assert torch.equal(ds.batch_at(5)["frames"], batch["frames"])
    assert not torch.equal(ds.batch_at(6)["frames"], batch["frames"])
    full = SyntheticLMData(get_config(ARCH), seq_len=8,
                           global_batch=1).batch_at(0)
    assert full["frames"].shape == (1, 8, 1024)


def test_runtime_train_checkpoints_and_restores(tmp_path):
    """Two ``Runtime.train`` steps with finite losses and a checkpoint of
    the encoder and decoder trees; a resumed run restores every leaf of
    the saved state, bit for bit."""
    from repro_torch.checkpoint import latest_step, restore

    cfg = get_config(ARCH).reduced()
    rt = Runtime(device="cpu")
    res = rt.train(cfg, steps=2, batch=2, seq=16, ckpt_dir=str(tmp_path),
                   ckpt_every=1, log=lambda _: None)
    assert res.steps_run == 2 and np.isfinite(res.final_loss)
    assert latest_step(tmp_path) == 2
    back = restore(tmp_path, 2, res.state)
    saved = dict(leaves_with_paths(res.state))
    assert any(p.startswith("params/encoder/1/") for p in saved)
    assert any(p.startswith("params/decoder/1/cross/") for p in saved)
    assert any(p.startswith("opt/") for p in saved)
    for path, leaf in leaves_with_paths(back):
        assert torch.equal(leaf, saved[path]), path
    resumed = rt.train(cfg, steps=2, batch=2, seq=16, ckpt_dir=str(tmp_path),
                       resume=True, log=lambda _: None)
    assert resumed.steps_run == 0 and int(resumed.state["step"]) == 2


def test_loss_falls_on_a_fixed_batch():
    """Two AdamW steps (lr 1e-2) on one batch lower the loss: the
    optimizer and every gradient path are wired."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import (TrainLoopConfig, init_train_state,
                                      make_train_step)

    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, "cpu")
    loop = TrainLoopConfig(optimizer=AdamWConfig(lr=1e-2), warmup_steps=1,
                           total_steps=2)
    state = init_train_state(model, 0, loop)
    batch = SyntheticLMData(cfg, seq_len=32, global_batch=2,
                            seed=1).batch_at(0)
    step = make_train_step(model, loop)
    first = float(model.loss(state["params"], batch)[0])
    for _ in range(2):
        state, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"]))
    assert float(model.loss(state["params"], batch)[0]) < first


def test_flash_counts_by_mode_only_where_kernels_launch():
    """The flash launch counter keeps one count for each direction, mode
    and path, all 0 after ``reset``; a non-causal call on CPU tensors (the
    plain version, forward and backward) launches nothing and counts
    nothing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    fa.LAUNCHES.reset()
    assert fa.LAUNCHES.by_mode == {
        f"{d} {m} {p}": 0 for d in ("forward", "backward")
        for m in ("causal", "non-causal") for p in fa.PATHS}
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, rows, 4, 16)).astype(np.float32)).requires_grad_(True)
        for rows in (5, 9, 9))
    out = ops.flash_attention(q, k, v, causal=False)
    out.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert set(fa.LAUNCHES.by_mode.values()) == {0}
    assert (fa.LAUNCHES.forward, fa.LAUNCHES.backward) == (0, 0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_encdec.py`")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 512, 512, 16, 16, 64),
                                   (3, 100, 160, 8, 8, 64),
                                   (3, 160, 100, 8, 8, 64)],
                         ids=["encoder", "cross", "cross_more_queries"])
def test_noncausal_flash_on_card(shape, dtype):
    """The encoder's bidirectional self-attention (S == S_kv, 16 MHA heads
    of 64) and ragged cross attentions (100 queries against 160 keys, and
    160 against 100) through ``ops.flash_attention(causal=False)`` forward
    and backward, against autograd of the plain versions on the same
    inputs: one forward and one backward call on the path the dtype names
    (bf16: the tensor cores, no operand copied), each counted as
    non-causal; fp32 within 2e-3 x max|plain|, bf16 within 8e-3 x
    max|plain| (output) and 2e-2 x (gradients, after the bf16 output)."""
    _card()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    b, s, skv, hq, hkv, hd = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    q = torch.randn((b, s, hq, hd), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((b, skv, hkv, hd), generator=gen, device="cuda")
            .to(dt) for _ in range(2))
    do = torch.randn((b, s, hq, hd), generator=gen, device="cuda").to(dt)
    path = fa.choose_path(dt, hd)
    modes = (f"forward non-causal {path}", f"backward non-causal {path}")
    before = (fa.LAUNCHES.forward, fa.LAUNCHES.backward,
              fa.LAUNCHES.by_path[path], fa.LAUNCHES.copied_operands,
              *(fa.LAUNCHES.by_mode[m] for m in modes))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=False)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES.forward, fa.LAUNCHES.backward,
            fa.LAUNCHES.by_path[path], fa.LAUNCHES.copied_operands,
            *(fa.LAUNCHES.by_mode[m] for m in modes)) == (
        before[0] + 1, before[1] + 1, before[2] + 2, before[3],
        before[4] + 1, before[5] + 1)
    o_p, lse_p = ref.flash_attention_fwd_plain(q, k, v, False)
    grads_p = ref.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, False)
    f32 = dt == torch.float32
    for name, got, want, tol in [("o", out, o_p, 2e-3 if f32 else 8e-3),
                                 *((n, g, w, 2e-3 if f32 else 2e-2)
                                   for n, g, w in zip(("dq", "dk", "dv"),
                                                      grads, grads_p))]:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (name, err)


@pytest.mark.cuda
def test_reduced_model_card_matches_cpu():
    """The reduced model in fp32 from one set of parameters, card against
    CPU: prefill logits and 4 decode steps from a filled cross cache
    within 2e-3 x max|logit| (chip_smoke.py phase 6's limit), the loss
    within 1e-4 relative and every gradient within 2e-3 x max|grad|."""
    _card()
    from repro_torch.training.step import make_grad_fn

    cfg = get_config(ARCH).reduced()
    tokens, frames = _inputs(cfg, 2, 24, s_enc=32, seed=12)
    out = {}
    params = build_model(cfg, "cpu").init(0)
    for where in ("cpu", "cuda"):
        model = build_model(cfg, where)
        p = tree_map(lambda t: t.to(where), params)
        batch = {"tokens": _t(tokens).long().to(where),
                 "frames": _t(frames).to(where)}
        logits = [model.prefill(p, batch)[:, 0]]
        st = model.init_decode_state(2, 32)
        enc = model.encode(p, batch["frames"], remat=False)
        for lp, layer in zip(p["decoder"], st["layers"]):
            layer["cross"]["k"], layer["cross"]["v"] = encdec.cross_kv(
                lp, cfg, enc)
        for i in range(4):  # a 4-token chunk, then a token a step
            feed = batch["tokens"][:, :4] if i == 0 else \
                batch["tokens"][:, 3 + i:4 + i]
            lg, st = model.decode_step(p, st, {"tokens": feed})
            logits.append(lg[:, -1])
        loss, _, grads = make_grad_fn(model)(p, batch)
        out[where] = ([t.cpu() for t in logits], float(loss),
                      {k: g.cpu() for k, g in leaves_with_paths(grads)})
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        top = want.abs().max().item()
        assert (got - want).abs().max().item() <= 2e-3 * top
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * abs(out["cpu"][1])
    for path, want in out["cpu"][2].items():
        got = out["cuda"][2][path]
        assert (got - want).abs().max().item() <= \
            2e-3 * want.abs().max().item(), path
