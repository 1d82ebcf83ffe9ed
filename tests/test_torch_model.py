"""The port's dense decoder-only model against the reference, on the
reference's own ``model.init`` parameters bridged through numpy
(``repro_torch.convert.params_from_jax``), in fp32 on the CPU.

Both parameter layouts are covered: tinyllama-1.1b ``.reduced()`` (2 layers,
unrolled ``layer_{i}``) and a 4-layer variant (scan-stacked, leading L
axis).  Tolerance: atol 1e-4 on logits (fp32, different summation orders);
greedy tokens must be equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ATOL = 1e-4


def _pair(n_layers):
    jcfg = dataclasses.replace(j_get_config("tinyllama-1.1b").reduced(),
                               n_layers=n_layers)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              n_layers=n_layers)
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(n_layers))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, jmodel, jparams, model, params


@pytest.fixture(scope="module", params=[2, 4], ids=["unrolled", "scan"])
def pair(request):
    return _pair(request.param)


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


def test_config_matches_reference():
    for name in ("tinyllama-1.1b",):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name))
        assert dataclasses.asdict(get_config(name).reduced()) == \
            dataclasses.asdict(j_get_config(name).reduced())


def test_bridge_layouts(pair):
    cfg, _, jparams, _, params = pair
    assert len(params["layers"]) == cfg.n_layers
    hd = cfg.resolved_head_dim
    lp = params["layers"][-1]
    assert lp["attn"]["wq"].shape == (cfg.d_model, cfg.n_heads * hd)
    assert lp["attn"]["wo"].shape == (cfg.n_heads * hd, cfg.d_model)
    scan = "layer_0" not in jparams["layers"]
    assert scan == (cfg.n_layers >= 4)
    src = (jparams["layers"]["attn"]["wk"][-1] if scan
           else jparams["layers"][f"layer_{cfg.n_layers - 1}"]["attn"]["wk"])
    np.testing.assert_array_equal(
        lp["attn"]["wk"].numpy(), np.asarray(src).reshape(cfg.d_model, -1))


def test_forward_logits_and_prefill_match(pair):
    cfg, jmodel, jparams, model, params = pair
    toks = _tokens(cfg, 2, 11, seed=1)
    want, _ = jax.jit(jmodel.forward_logits)(jparams,
                                             {"tokens": jnp.asarray(toks)})
    got, _ = model.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    want_p = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    got_p = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_chain_matches(pair, per_slot):
    """A 5-token prompt then an 8-step greedy decode_step chain: same
    logits, same argmax, at every step."""
    cfg, jmodel, jparams, model, params = pair
    toks = _tokens(cfg, 2, 5, seed=2)
    jstate = jmodel.init_decode_state(2, 16, per_slot=per_slot)
    state = model.init_decode_state(2, 16, per_slot=per_slot)
    jfeed, feed = jnp.asarray(toks), torch.from_numpy(toks).long()
    jstep = jax.jit(jmodel.decode_step)
    for step in range(9):
        jlog, jstate = jstep(jparams, jstate, {"tokens": jfeed})
        log, state = model.decode_step(params, state, {"tokens": feed})
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        jnext = np.asarray(jnp.argmax(jlog[:, -1], axis=-1))
        nxt = torch.argmax(log[:, -1], dim=-1)
        np.testing.assert_array_equal(nxt.numpy(), jnext)
        jfeed, feed = jnp.asarray(jnext[:, None]), nxt[:, None]
    assert state["pos"].tolist() == (
        [13, 13] if per_slot else 13)


def test_cache_free_attention_matches_reference():
    """Both cache-free paths (dense, and chunked with a ragged last chunk)
    against the reference's, and against each other."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as attn

    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 11, h, 8)).astype(np.float32)
               for h in (4, 2, 2))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    want = np.asarray(jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), chunk=4))
    np.testing.assert_allclose(
        attn.chunked_attention(tq, tk, tv, chunk=4).numpy(), want, atol=1e-5,
        rtol=0)
    np.testing.assert_allclose(attn.attention(tq, tk, tv, chunk=4).numpy(),
                               want, atol=1e-5, rtol=0)  # 11 > 2*4: chunked
    np.testing.assert_allclose(attn.dense_attention(tq, tk, tv).numpy(), want,
                               atol=1e-5, rtol=0)


def test_slot_surgery_in_place():
    """insert/reset write the pooled state in place; merge freezes masked
    slots exactly."""
    cfg, _, _, model, params = _pair(2)
    pool = model.init_decode_state(3, 16, per_slot=True)
    single = model.init_decode_state(1, 16, per_slot=True)
    _, single = model.decode_step(
        params, single, {"tokens": torch.from_numpy(_tokens(cfg, 1, 4, 3))})
    k_buf = pool["layers"][0]["k"]
    model.insert_decode_slot(pool, single, 1)
    assert pool["layers"][0]["k"] is k_buf  # same storage, written in place
    assert torch.equal(pool["layers"][0]["k"][1], single["layers"][0]["k"][0])
    assert pool["pos"].tolist() == [0, 4, 0]
    stepped = {"layers": [{k: v + 1 for k, v in lay.items()}
                          for lay in pool["layers"]], "pos": pool["pos"] + 1}
    merged = model.merge_decode_state(stepped, pool,
                                      torch.tensor([True, False, True]))
    assert merged["pos"].tolist() == [1, 4, 1]
    assert torch.equal(merged["layers"][0]["v"][1], pool["layers"][0]["v"][1])
    model.reset_decode_slots(pool, np.array([False, True, False]))
    assert pool["pos"].tolist() == [0, 0, 0]
    assert not pool["layers"][0]["k"].any()
