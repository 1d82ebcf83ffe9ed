"""The port's rwkv6 family against the reference, on the CPU, at reduced
size (rwkv6-3b ``.reduced()``: 2 layers, d 64, head size 16, vocab 256,
fp32), on the reference's parameters carried across by ``params_from_jax``.

* the time mix and the channel mix of one layer, with and without a decode
  state: atol 1e-5 (fp32, other summation orders);
* ``forward_logits``, ``prefill`` and ``decode_step`` over several tokens:
  atol 1e-4;
* the loss and every gradient (22 leaves a layer, plus embed, unembed and
  the final norm) against ``jax.value_and_grad(model.loss)``: atol 1e-4;
* three ``make_train_step`` steps at warmup 1 and lr 1e-2: loss, ce, z
  within 1e-4, the gradient norm within 1e-4 relative, and each leaf's
  change within 1e-4 of the reference's, a change of at least 10x that;
* serving: the port's static and continuous engines emit the reference's
  static and continuous engines' tokens (chunk-1 prefill replay, slot
  reuse, an EOS inside a macro-step, ragged budgets), and
  ``Runtime(device="cpu").serve`` and the training launcher run it;
* slot surgery on the nested recurrent state: reset, insert, and a masked
  merge that leaves frozen slots bit-equal, on leaves of every rank.
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
    from repro.data import SyntheticLMData as JSyntheticLMData
    from repro.hw import V5E
    from repro.models import build_model as j_build_model
    from repro.models import rwkv as jrwkv
    from repro.optim import adamw as j_adamw
    from repro.serving import ContinuousServeEngine as JContinuous
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JStatic
    from repro.training import TrainLoopConfig as JTrainLoopConfig
    from repro.training import init_train_state as j_init_train_state
    from repro.training import make_train_step as j_make_train_step
except ImportError:
    jax = None

needs_reference = pytest.mark.skipif(
    jax is None, reason="needs jax and the reference package")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rwkv as rwkv_lib  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousServeEngine,
    Request,
    ServeEngine,
)
from repro_torch.training import TrainLoopConfig, make_grad_fn  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

ATOL = 1e-4
MIX_ATOL = 1e-5
PROMPT_LEN = 7
MAX_NEW = 9
MAX_LEN = PROMPT_LEN + MAX_NEW
ARCH = "rwkv6-3b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(tokens):
    return {"tokens": torch.from_numpy(np.array(tokens)).long()}


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced rwkv6-3b and its parameters, the port's
    model and the same parameters carried across."""
    jcfg = j_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams,
                model=build_model(cfg, "cpu"),
                params=params_from_jax(_np(jparams), cfg, "cpu"),
                batches=[np.asarray(JSyntheticLMData(
                    jcfg, seq_len=40, global_batch=2).batch_at(i)["tokens"])
                    for i in range(3)])


def _same(port_tree, want_tree, atol, what=""):
    want = dict(leaves_with_paths(want_tree))
    got = leaves_with_paths(port_tree)
    assert [p for p, _ in got] == list(want)
    for path, g in got:
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   want[path].float().numpy(), atol=atol,
                                   rtol=0, err_msg=f"{what} {path}")


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# Layers and the model
# ---------------------------------------------------------------------------


def test_params_from_jax_layout_matches_init(ref):
    """The carried-across tree has the port's own init layout: the same
    paths, shapes and dtypes, 22 leaves a layer."""
    mine = leaves_with_paths(ref["model"].init(0))
    got = leaves_with_paths(ref["params"])
    assert [(p, tuple(t.shape), t.dtype) for p, t in got] == \
        [(p, tuple(t.shape), t.dtype) for p, t in mine]
    assert len(got) == 22 * ref["cfg"].n_layers + 3
    full = get_config(ARCH)
    bf16 = build_model(dataclasses.replace(full, n_layers=1, d_model=128,
                                           d_ff=256, vocab_size=64), "cpu")
    dtypes = {p: t.dtype for p, t in leaves_with_paths(bf16.init(0))}
    assert dtypes["layers/0/time/w_r"] == torch.bfloat16
    assert dtypes["layers/0/time/mu_w"] == torch.bfloat16
    for leaf in ("decay_w0", "decay_w1", "decay_w2", "bonus_u",
                 "ln_x_scale"):
        assert dtypes[f"layers/0/time/{leaf}"] == torch.float32, leaf


@needs_reference
@pytest.mark.parametrize("with_state", [False, True])
def test_time_and_channel_mix_match_reference(ref, with_state):
    cfg = ref["cfg"]
    lp_j = ref["jparams"]["layers"]["layer_0"]
    lp = ref["params"]["layers"][0]
    rng = np.random.default_rng(3)
    s = 1 if with_state else 37
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    h = cfg.d_model // cfg.rnn_head_dim
    if with_state:
        st = {"S": rng.standard_normal((2, h, cfg.rnn_head_dim,
                                        cfg.rnn_head_dim)).astype(np.float32),
              "shift": rng.standard_normal((2, 1, cfg.d_model)).astype(
                  np.float32)}
        jst = jax.tree.map(jnp.asarray, st)
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
    else:
        jst = tst = None
    want, want_state = jrwkv.rwkv_time_mix(lp_j["time"], jnp.asarray(x),
                                           cfg.rnn_head_dim, jst, chunk=16)
    got, got_state = rwkv_lib.rwkv_time_mix(lp["time"], torch.from_numpy(x),
                                            cfg.rnn_head_dim, tst, chunk=16)
    _close(got, want, MIX_ATOL, "time mix")
    if with_state:
        for k in ("S", "shift"):
            _close(got_state[k], want_state[k], MIX_ATOL, k)
    else:
        assert got_state is None and want_state is None
    cst = {"shift": jst["shift"]} if with_state else None
    want, want_state = jrwkv.rwkv_channel_mix(lp_j["channel"], jnp.asarray(x),
                                              cst)
    got, got_state = rwkv_lib.rwkv_channel_mix(
        lp["channel"], torch.from_numpy(x),
        {"shift": tst["shift"]} if with_state else None)
    _close(got, want, MIX_ATOL, "channel mix")
    if with_state:
        _close(got_state["shift"], want_state["shift"], 0.0, "shift")


@needs_reference
def test_forward_prefill_and_decode_match_reference(ref):
    jm, jp, m, p = ref["jmodel"], ref["jparams"], ref["model"], ref["params"]
    tokens = ref["batches"][0]
    want, _ = jm.forward_logits(jp, {"tokens": jnp.asarray(tokens)})
    got, aux = m.forward_logits(p, _batch(tokens))
    _close(got, want, ATOL, "forward_logits")
    assert float(aux) == 0.0
    want = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    _close(m.prefill(p, _batch(tokens)), want, ATOL, "prefill")
    jst = jm.init_decode_state(2, 48, per_slot=True)
    st = m.init_decode_state(2, 48, per_slot=True)
    for i in range(6):
        feed = tokens[:, i:i + 1]
        want, jst = jm.decode_step(jp, jst, {"tokens": jnp.asarray(feed)})
        got, st = m.decode_step(p, st, _batch(feed))
        _close(got, want, ATOL, f"decode step {i}")
    np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(jst["pos"]))
    for path, a in leaves_with_paths(st["layers"]):
        i, *keys = path.split("/")
        b = jst["layers"][f"layer_{i}"]
        for key in keys:
            b = b[key]
        _close(a, b, ATOL, path)
    # the decode state after the steps drives the same next logits as a
    # full forward over those tokens (stateless path through ops.wkv)
    full, _ = m.forward_logits(p, _batch(tokens[:, :6]))
    _close(got[:, -1], full[:, -1].numpy(), ATOL, "decode vs forward")


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
    assert len(leaves(grads)) == 47
    _same(grads, params_from_jax(_np(jgrads), ref["cfg"], "cpu"), ATOL,
          "grad")
    off = make_grad_fn(ref["model"], remat=False)(ref["params"],
                                                  _batch(tokens))
    assert float(off[0]) == float(loss)
    _same(off[2], grads, 0.0, "remat")


@needs_reference
def test_train_steps_match_reference(ref):
    """Three steps from the same parameters on the reference's batches at
    warmup 1 and peak lr 1e-2, so that steps 1 and 2 move every parameter:
    loss, ce and z within 1e-4, the gradient norm within 1e-4 relative, and
    each leaf's change within 1e-4 of the reference's (changes are ~1e-2),
    at least 10x that.  Why these limits: at step 0 the gradients agree
    to 3e-5 x max|grad| per leaf, the size of the port's own rounding
    spread (its gradients at WKV chunk 64 and chunk 8 differ by 1.4e-5 x
    max|grad|); Adam's early updates, ~lr x sign(g) elementwise, carry that
    spread into the parameters (1.9e-3 x max|change| after step 1), and
    the third step's gradient norm, taken at those parameters, differs
    by 4e-5 relative."""
    jloop = JTrainLoopConfig(optimizer=j_adamw.AdamWConfig(lr=1e-2),
                             warmup_steps=1)
    jstate = j_init_train_state(ref["jmodel"], jax.random.PRNGKey(0), jloop)
    jstep = jax.jit(j_make_train_step(ref["jmodel"], jloop))
    cfg = ref["cfg"]
    params = params_from_jax(_np(jstate["params"]), cfg, "cpu")
    start = tree_map(torch.clone, params)
    state = {"params": params, "opt": adamw.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(ref["model"], TrainLoopConfig(
        optimizer=adamw.AdamWConfig(lr=1e-2), warmup_steps=1))
    for tokens in ref["batches"]:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, _batch(tokens))
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(
                float(m[k]), float(jm[k]), atol=0 if k == "grad_norm" else
                ATOL, rtol=1e-4 if k == "grad_norm" else 1e-6, err_msg=k)
    want = dict(leaves_with_paths(params_from_jax(_np(jstate["params"]), cfg,
                                                  "cpu")))
    begin = dict(leaves_with_paths(start))
    for path, p in leaves_with_paths(state["params"]):
        moved = (p - begin[path]).numpy()
        want_moved = (want[path] - begin[path]).numpy()
        tol = ATOL
        assert np.abs(want_moved).max() >= 10 * tol, \
            f"{path}: the reference barely moved"
        assert np.abs(moved).max() >= 10 * tol, f"{path}: no update"
        np.testing.assert_allclose(moved, want_moved, atol=tol, rtol=0,
                                   err_msg=f"change of {path}")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _prompts(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, PROMPT_LEN)).astype(np.int32)


def _spec_engine():
    return CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))


def _run_port(model, params, prompts, budgets, **kw):
    engine = ContinuousServeEngine(model, params, max_len=MAX_LEN,
                                   cost_engine=_spec_engine(), **kw)
    return engine.run([Request(f"r{i}", prompts[i], budgets[i])
                       for i in range(len(prompts))], now_fn=lambda: 0.0)


@needs_reference
def test_served_tokens_match_reference_engines(ref):
    """Static and continuous (chunk-1 prefill replay, 2 slots for 3
    requests, auto horizon) against the reference's static and continuous
    engines on the same parameters and prompts."""
    cfg = ref["cfg"]
    prompts = _prompts(cfg, 3)
    want = JStatic(ref["jmodel"], ref["jparams"], max_len=MAX_LEN,
                   eos_id=0).generate(prompts, max_new_tokens=MAX_NEW)
    jreport = JContinuous(ref["jmodel"], ref["jparams"], n_slots=2,
                          max_len=MAX_LEN, eos_id=0,
                          cost_engine=JCostEngine(hw=V5E)).run(
        [JRequest(f"r{i}", prompts[i], MAX_NEW) for i in range(3)],
        now_fn=lambda: 0.0)
    jcont = np.stack([jreport.output(f"r{i}", MAX_NEW) for i in range(3)])
    np.testing.assert_array_equal(jcont, want)
    static = ServeEngine(ref["model"], ref["params"], max_len=MAX_LEN,
                         eos_id=0).generate(prompts, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(static, want)
    report = _run_port(ref["model"], ref["params"], prompts, [MAX_NEW] * 3,
                       n_slots=2, eos_id=0)
    got = np.stack([report.output(f"r{i}", MAX_NEW) for i in range(3)])
    np.testing.assert_array_equal(got, want)
    assert report.host_syncs == jreport.host_syncs
    assert report.device_dispatches == jreport.device_dispatches


@needs_reference
def test_macro_step_eos_turnover_ragged_budgets_match_reference(ref):
    cfg = ref["cfg"]
    prompts = _prompts(cfg, 3, seed=4)
    base = JStatic(ref["jmodel"], ref["jparams"], max_len=MAX_LEN,
                   eos_id=-1).generate(prompts, max_new_tokens=MAX_NEW)
    eos = int(base[0, 3])  # the first row's EOS fires mid-run
    want = JStatic(ref["jmodel"], ref["jparams"], max_len=MAX_LEN,
                   eos_id=eos, pad_id=0).generate(prompts,
                                                  max_new_tokens=MAX_NEW)
    budgets = [MAX_NEW, 5, 6]
    for k in (1, 4):
        report = _run_port(ref["model"], ref["params"], prompts, budgets,
                           n_slots=2, eos_id=eos, pad_id=0, macro_step=k)
        for i in range(3):
            np.testing.assert_array_equal(report.output(f"r{i}", budgets[i]),
                                          want[i, : budgets[i]])
        assert report.all_terminal


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


# ---------------------------------------------------------------------------
# Slot surgery on the nested recurrent state
# ---------------------------------------------------------------------------


def _filled_state(model, batch, seed):
    """A per-slot decode state with every leaf filled with distinct
    values."""
    st = model.init_decode_state(batch, MAX_LEN, per_slot=True)
    gen = torch.Generator().manual_seed(seed)
    for leaf in leaves(st["layers"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    st["pos"].copy_(torch.arange(batch) + 3)
    return st


def test_slot_reset_and_insert_on_nested_state():
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, "cpu")
    st = _filled_state(model, 3, seed=0)
    layer = st["layers"][0]
    assert set(layer) == {"time", "channel"}
    assert layer["time"]["S"].dim() == 4 and layer["time"]["shift"].dim() == 3
    before = tree_map(torch.clone, st)
    model.reset_decode_slots(st, np.array([False, True, False]))
    for new, old in zip(leaves(st["layers"]), leaves(before["layers"])):
        assert torch.equal(new[1], torch.zeros_like(new[1]))
        assert torch.equal(new[0], old[0]) and torch.equal(new[2], old[2])
    assert st["pos"].tolist() == [3, 0, 5]
    src = _filled_state(model, 1, seed=1)
    model.insert_decode_slot(st, src, 1)
    for new, one, old in zip(leaves(st["layers"]), leaves(src["layers"]),
                             leaves(before["layers"])):
        assert torch.equal(new[1], one[0])
        assert torch.equal(new[0], old[0]) and torch.equal(new[2], old[2])
    assert st["pos"].tolist() == [3, 3, 5]


def test_masked_merge_freezes_recurrent_slots_bit_exactly():
    """A decode step over all slots, merged under a mask: the active slots
    take the stepped state, the frozen ones keep theirs bit for bit,
    recurrent state included."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, "cpu")
    params = model.init(0)
    st = _filled_state(model, 3, seed=2)
    tokens = torch.tensor([[5], [7], [9]])
    _, stepped = model.decode_step(params, st, {"tokens": tokens})
    active = torch.tensor([True, False, True])
    merged = model.merge_decode_state(stepped, st, active)
    for path, m in leaves_with_paths(merged["layers"]):
        new = dict(leaves_with_paths(stepped["layers"]))[path]
        old = dict(leaves_with_paths(st["layers"]))[path]
        assert m.shape == old.shape, path
        assert torch.equal(m[1], old[1]), path
        assert torch.equal(m[0], new[0]) and torch.equal(m[2], new[2]), path
        assert not torch.equal(new[1], old[1]), path  # the step moved it
    assert merged["pos"].tolist() == [4, 4, 6]


def test_merge_decode_state_regression_rank3_leaf():
    """The mask of a (B, 1, D) leaf must not broadcast to (B, B, 1, D): a
    mask shaped for 4-D KV leaves did that silently."""
    model = build_model(get_config(ARCH).reduced(), "cpu")
    new = {"layers": [{"channel": {"shift": torch.ones((4, 1, 8))}}],
           "pos": torch.ones(4, dtype=torch.int64)}
    old = {"layers": [{"channel": {"shift": torch.zeros((4, 1, 8))}}],
           "pos": torch.zeros(4, dtype=torch.int64)}
    active = torch.tensor([True, False, False, True])
    out = model.merge_decode_state(new, old, active)
    shift = out["layers"][0]["channel"]["shift"]
    assert shift.shape == (4, 1, 8)
    assert shift[:, 0, 0].tolist() == [1.0, 0.0, 0.0, 1.0]
    assert out["pos"].tolist() == [1, 0, 0, 1]


def test_train_launcher_runs_rwkv_on_cpu(capsys):
    from repro_torch.launch import train as launch

    rc = launch.main(["--arch", ARCH, "--reduced", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--log-every", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "done: 2 steps" in out and "step     1 loss" in out
