"""The port's mixture of experts against the reference, on the CPU, at
reduced size (``.reduced()``: d 64, 8 experts of F 128, top-2, 4 query
heads of hd 16, vocab 256, fp32), on the reference's parameters carried
across by ``params_from_jax``: moonshot-v1-16b-a3b (MHA) and
qwen3-moe-235b-a22b (GQA 4/4 at this size, RoPE theta 1e6).

* ``_router_topk`` and ``load_balance_loss`` on seeded logits: weights and
  the loss within 1e-6 (fp32, other summation orders), the selected ids
  equal;
* ``moe_dense`` (output and aux) against ``repro.models.ffn.moe_dense`` at
  top-k 1 and 2, SwiGLU and GELU: atol 1e-5 (fp32; the port sums over the
  experts inside one product, the reference after rounding each expert's
  output, readings ~1e-7);
* the port's counterparts of the reference's
  ``test_moe_dense_topk_weights_sum_to_one`` and
  ``test_moe_topk1_equals_best_expert`` (``tests/test_blocks.py``);
* ``params_from_jax``: the experts side by side, the router fp32 whatever
  the weights' dtype, both of the reference's layer layouts;
* ``forward_logits``, ``prefill`` and ``loss`` (ce, aux and z): atol 1e-4
  on logits and the losses (fp32);
* ``decode_step`` token by token against the reference's steps (1e-4) and
  both forwards (2e-3, the reference's decode-consistency tolerance);
* the loss's gradients against ``jax.value_and_grad`` (1e-4 x max|grad|
  a leaf, fp32);
* greedy tokens of the static and continuous engines equal the
  reference's engines', host syncs and dispatches too; ``Runtime.serve``
  static equals continuous, and the launcher serves;
* ``moe_apply`` under a context that turns expert parallelism off on a
  model axis raises (expert parallelism itself: tests/test_torch_moe_ep.py);
* on a card only (``cuda`` marker): the expert products (gate with SiLU,
  up, the weighted down projection) and the fp32 router against the plain
  version, each a launch of the matmul kernel on the path its dtypes name,
  with every operand on TMA.

Ties: ``torch.topk`` need not break a tie toward the lower index as
``lax.top_k`` does; the ids are compared, and a mismatch is allowed only
where the two probabilities differ by fp32 rounding (the test says which).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the reference; a card machine without jax runs the rest
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.core.costs.engine import CostEngine as JCostEngine
    from repro.hw import V5E
    from repro.models import build_model as j_build_model
    from repro.models import ffn as jffn
    from repro.serving import ContinuousServeEngine as JContinuous
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JStatic
except ImportError:
    jax = None

needs_reference = pytest.mark.skipif(
    jax is None, reason="needs jax and the reference package")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import _ffn, params_from_jax  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousServeEngine,
    Request,
    ServeEngine,
)
from repro_torch.tree import leaves_with_paths  # noqa: E402

MOE = ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"]
ATOL = 1e-4
MOE_ATOL = 1e-5
ROUTER_ATOL = 1e-6
DECODE_TOL = 2e-3  # atol and rtol of tests/test_decode_consistency.py
PROMPT_LEN, MAX_NEW = 7, 9
MAX_LEN = PROMPT_LEN + MAX_NEW


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(tokens):
    return {"tokens": torch.from_numpy(np.array(tokens)).long()}


def _close(got, want, atol, what="", rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=what)


def _same_ids(got, want, probs):
    """The selected expert ids equal, row by row, up to ties: where a row's
    sets differ, the probabilities of the experts that swapped must agree
    to fp32 rounding (4 ulps of the larger)."""
    got, want = np.asarray(got), np.asarray(want)
    probs = np.asarray(probs, np.float32)
    for row in range(got.shape[0]):
        if set(got[row]) == set(want[row]):
            continue
        swapped = sorted(set(got[row]) ^ set(want[row]))
        p = probs[row, swapped]
        assert p.max() - p.min() <= 4 * np.spacing(p.max()), (
            f"row {row}: ids {got[row]} vs {want[row]}, probabilities "
            f"{p} differ by more than fp32 rounding")


_CACHE = {}


def _pair(arch, n_layers=None):
    """The reference's reduced model and parameters, the port's model and
    the same parameters carried across (built once per arch and depth)."""
    key = (arch, n_layers)
    if key not in _CACHE:
        jcfg = j_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        if n_layers is not None:
            jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jmodel = j_build_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        _CACHE[key] = dict(
            jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams,
            model=build_model(cfg, "cpu"),
            params=params_from_jax(_np(jparams), cfg, "cpu"))
    return _CACHE[key]


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("arch", MOE)
def test_config_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(j_get_config(arch).reduced())
    assert get_config(arch).active_param_count() == \
        j_get_config(arch).active_param_count()


@needs_reference
@pytest.mark.parametrize("arch,n_layers", [(MOE[0], None), (MOE[1], 4)],
                         ids=["unrolled", "scan"])
def test_params_from_jax_layout(arch, n_layers):
    """The carried-across tree has the port's own init layout (paths,
    shapes, dtypes), expert e of ``w_in``/``w_gate`` in columns [e*F,
    (e+1)*F) and of ``w_out`` in rows [e*F, (e+1)*F), from the unrolled
    and the scan-stacked layer layouts; with bf16 weights the router stays
    fp32."""
    pair = _pair(arch, n_layers)
    cfg = pair["cfg"]
    mine = sorted((p, tuple(t.shape), t.dtype)
                  for p, t in leaves_with_paths(pair["model"].init(0)))
    got = sorted((p, tuple(t.shape), t.dtype)
                 for p, t in leaves_with_paths(pair["params"]))
    assert got == mine
    layers = pair["jparams"]["layers"]
    last = cfg.n_layers - 1
    jffn_last = _np(layers[f"layer_{last}"]["ffn"] if "layer_0" in layers
                    else jax.tree.map(lambda a: a[last], layers["ffn"]))
    mffn = pair["params"]["layers"][last]["ffn"]
    e, f = cfg.n_experts, cfg.d_ff
    assert mffn["w_in"].shape == (cfg.d_model, e * f)
    assert mffn["w_out"].shape == (e * f, cfg.d_model)
    for i in range(e):
        cols = slice(i * f, (i + 1) * f)
        np.testing.assert_array_equal(mffn["w_in"][:, cols].numpy(),
                                      jffn_last["w_in"][i])
        np.testing.assert_array_equal(mffn["w_gate"][:, cols].numpy(),
                                      jffn_last["w_gate"][i])
        np.testing.assert_array_equal(mffn["w_out"][cols].numpy(),
                                      jffn_last["w_out"][i])
    bf = params_from_jax(_np(pair["jparams"]), cfg, "cpu",
                         dtype=torch.bfloat16)["layers"][0]["ffn"]
    assert bf["router"].dtype == torch.float32
    assert {bf[k].dtype for k in ("w_in", "w_gate", "w_out")} == \
        {torch.bfloat16}


# ---------------------------------------------------------------------------
# The router, the load-balance loss and moe_dense
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("e,k", [(8, 2), (64, 6), (128, 8)])
def test_router_topk_matches_reference(e, k):
    rng = np.random.default_rng(e)
    logits = (rng.standard_normal((37, e)) * 2).astype(np.float32)
    w, ids = ffn._router_topk(torch.from_numpy(logits), k)
    jw, jids = jffn._router_topk(jnp.asarray(logits), k)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    _same_ids(ids.numpy(), jids, probs)
    _close(w, jw, ROUTER_ATOL, "router weights")
    _close(w.sum(-1), np.ones(37), ROUTER_ATOL, "weights sum to one")


@needs_reference
@pytest.mark.parametrize("e,k", [(8, 2), (64, 6)])
def test_load_balance_loss_matches_reference(e, k):
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((2, 19, e)).astype(np.float32)
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), k)
    ids = torch.from_numpy(np.asarray(jids).astype(np.int64))
    got = ffn.load_balance_loss(torch.from_numpy(logits), ids, e)
    want = jffn.load_balance_loss(jnp.asarray(logits), jids, e)
    assert got.shape == () and got.dtype == torch.float32
    _close(got, want, ROUTER_ATOL, "load-balance loss")


@needs_reference
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_dense_matches_reference(top_k, activation):
    d, f, e = 16, 24, 5
    jp = jffn.moe_init(jax.random.PRNGKey(top_k), d, f, e, activation)
    p = _ffn(_np(jp), "cpu", torch.float32)
    assert ("w_gate" in p) is (activation == "swiglu")
    x = np.random.default_rng(7).standard_normal((2, 9, d)).astype(np.float32)
    want, jaux = jffn.moe_dense(jp, jnp.asarray(x), top_k=top_k,
                                activation=activation)
    got, aux = ffn.moe_dense(p, torch.from_numpy(x), top_k=top_k,
                             activation=activation)
    logits = x.reshape(-1, d) @ np.asarray(jp["router"])
    _, ids = ffn._router_topk(torch.from_numpy(logits), top_k)
    _, jids = jffn._router_topk(jnp.asarray(logits), top_k)
    _same_ids(ids.numpy(), jids, jax.nn.softmax(jnp.asarray(logits), -1))
    _close(got, want, MOE_ATOL, "moe_dense output")
    _close(aux, jaux, ROUTER_ATOL, "moe_dense aux")
    _, none = ffn.moe_dense(p, torch.from_numpy(x), top_k=top_k,
                            activation=activation, aux=False)
    assert none is None


def test_moe_dense_topk_weights_sum_to_one():
    d, f, e = 8, 16, 4
    gen = torch.Generator().manual_seed(0)
    params = ffn.moe_init(gen, d, f, e, "swiglu")
    x = torch.randn((2, 6, d), generator=gen)
    y, aux = ffn.moe_dense(params, x, top_k=2, activation="swiglu")
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux) > 0.0
    w, _ = ffn._router_topk(x.reshape(-1, d) @ params["router"], 2)
    _close(w.sum(-1), np.ones(12), ROUTER_ATOL)


def test_moe_topk1_equals_best_expert():
    """With top_k=1, the output is the single selected expert's FFN."""
    d, f, e = 4, 8, 3
    gen = torch.Generator().manual_seed(1)
    params = ffn.moe_init(gen, d, f, e, "swiglu")
    x = torch.randn((1, 5, d), generator=gen)
    y, _ = ffn.moe_dense(params, x, top_k=1, activation="swiglu")
    t = x.reshape(-1, d)
    ids = torch.argmax(t @ params["router"], -1)
    for i, eid in enumerate(ids.tolist()):
        cols = slice(eid * f, (eid + 1) * f)
        p_e = {"w_in": params["w_in"][:, cols],
               "w_gate": params["w_gate"][:, cols],
               "w_out": params["w_out"][cols]}
        want = ffn.ffn_apply(p_e, t[i:i + 1], "swiglu")
        _close(y.reshape(-1, d)[i:i + 1], want.numpy(), 1e-6,
               f"token {i}, expert {eid}")


def test_moe_apply_expert_parallel_context_raises():
    """Expert parallelism is ported (``moe_ep``, held against the
    reference's in tests/test_torch_moe_ep.py), so an EP context over a
    model axis runs it; what still raises is a context that turns it off
    (``use_ep=False``) on a model axis, whose experts the specs split.  A
    context without a model axis is ``moe_dense``, as in the
    reference."""
    d, f, e = 8, 16, 4
    params = ffn.moe_init(torch.Generator().manual_seed(2), d, f, e,
                          "swiglu")
    x = torch.zeros((1, 3, d))
    ctx = types.SimpleNamespace(use_ep=False, model_axis="model",
                                mesh=types.SimpleNamespace(shape={
                                    "data": 1, "model": 2}))
    with pytest.raises(NotImplementedError, match="use_ep=False"):
        ffn.moe_apply([params, params], [x, x], top_k=2,
                      activation="swiglu", ctx=ctx)
    one = types.SimpleNamespace(use_ep=True, model_axis="model",
                                mesh=types.SimpleNamespace(shape={
                                    "model": 1}))
    y, aux = ffn.moe_apply(params, x, top_k=2, activation="swiglu", ctx=one)
    want, want_aux = ffn.moe_dense(params, x, top_k=2, activation="swiglu")
    assert torch.equal(y, want) and torch.equal(aux, want_aux)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("arch", MOE)
def test_forward_prefill_and_loss_match_reference(arch):
    pair = _pair(arch)
    jm, jp, m, p = pair["jmodel"], pair["jparams"], pair["model"], \
        pair["params"]
    tokens = _tokens(pair["cfg"], 2, 24, seed=1)
    jb = {"tokens": jnp.asarray(tokens)}
    want, jaux = jm.forward_logits(jp, jb)
    got, aux = m.forward_logits(p, _batch(tokens))
    _close(got, want, ATOL, "forward_logits")
    assert aux.shape == () and aux.dtype == torch.float32
    assert float(aux) > 0.0
    _close(aux, jaux, ATOL, "aux")
    _close(m.prefill(p, _batch(tokens)), jm.prefill(jp, jb), ATOL, "prefill")
    jtotal, jmet = jm.loss(jp, jb)
    total, met = m.loss(p, _batch(tokens), remat=False)
    for name in ("ce", "aux", "z"):
        _close(met[name], jmet[name], ATOL, name)
    _close(total, jtotal, ATOL, "total loss")


@needs_reference
@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward(arch):
    """B 2, S 24 token by token against the full forward (2e-3) and each
    step against the reference's step (1e-4)."""
    pair = _pair(arch)
    jm, jp, m, p = pair["jmodel"], pair["jparams"], pair["model"], \
        pair["params"]
    b, s = 2, 24
    tokens = _tokens(pair["cfg"], b, s, seed=2)
    full, _ = jm.forward_logits(jp, {"tokens": jnp.asarray(tokens)})
    mine, _ = m.forward_logits(p, _batch(tokens))
    jst = jm.init_decode_state(b, s + 8)
    st = m.init_decode_state(b, s + 8)
    outs = []
    for t in range(s):
        feed = tokens[:, t:t + 1]
        want, jst = jm.decode_step(jp, jst, {"tokens": jnp.asarray(feed)})
        got, st = m.decode_step(p, st, _batch(feed))
        _close(got, want, ATOL, f"decode step {t}")
        outs.append(got[:, 0])
    dec = torch.stack(outs, dim=1)
    _close(dec, full, DECODE_TOL, "decode vs reference forward",
           rtol=DECODE_TOL)
    _close(dec, mine.numpy(), DECODE_TOL, "decode vs port forward",
           rtol=DECODE_TOL)
    assert int(st["pos"]) == int(jst["pos"]) == s


@needs_reference
def test_loss_gradients_match_reference():
    """Every expert product is a 2-D launch, so ``ops.MatmulFn`` carries
    the MoE's gradients (the router's through the renormalised top-k
    weights and the load-balance loss): reduced moonshot's loss and every
    parameter's gradient against ``jax.value_and_grad`` of the
    reference's, within 1e-4 x max|grad| a leaf (fp32)."""
    from repro_torch.training.step import make_grad_fn

    pair = _pair(MOE[0])
    tokens = _tokens(pair["cfg"], 2, 16, seed=4)
    jloss, jgrads = jax.value_and_grad(lambda q: pair["jmodel"].loss(
        q, {"tokens": jnp.asarray(tokens)})[0])(pair["jparams"])
    loss, _, grads = make_grad_fn(pair["model"])(pair["params"],
                                                 _batch(tokens))
    _close(loss, jloss, ATOL, "loss")
    want = params_from_jax(_np(jgrads), pair["cfg"], "cpu")
    for (path, g), (_, w) in zip(leaves_with_paths(grads),
                                 leaves_with_paths(want)):
        top = w.abs().max().item()
        _close(g, w.numpy(), 1e-4 * top, path)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _spec_engine():
    return CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))


def _outputs(report, n):
    return np.stack([report.output(f"r{i}", MAX_NEW) for i in range(n)])


@needs_reference
@pytest.mark.parametrize("arch", MOE)
def test_served_tokens_match_reference_engines(arch):
    """Static and continuous (3 requests on 2 slots, auto horizon, chunked
    prefill) against the reference's static and continuous engines, with
    its host syncs and dispatches."""
    pair = _pair(arch)
    prompts = _tokens(pair["cfg"], 3, PROMPT_LEN, seed=5)
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


@pytest.mark.parametrize("arch", MOE)
def test_runtime_serve_static_equals_continuous_on_cpu(arch):
    cfg = get_config(arch).reduced()
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


def test_serve_launcher_runs_moonshot(capsys):
    from repro_torch.launch import serve

    rc = serve.main(["--arch", "moonshot-v1-16b-a3b", "--reduced",
                     "--device", "cpu", "--requests", "3", "--max-new", "4",
                     "--slots", "2", "--engine", "both"])
    assert rc in (0, None)
    assert "r2" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_products_on_card(dtype):
    """The MoE's products at moonshot's widths (d 2048, 64 experts of F
    1408, 4 tokens) on the card against the plain version: the fp32
    router (FMA path), the gate with SiLU fused and the up projection (N
    = E*F), the weighted down projection (K = E*F); each one launch on the
    path its dtypes name, every bf16 operand on TMA; fp32 within 1e-5 x
    max|plain|, bf16 within 8e-3 x max|plain| (one bf16 rounding of the
    output); and the whole moe_dense against the plain version within
    the same limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_moe.py`")
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    dt = getattr(torch, dtype)
    d, f, e, t = 2048, 1408, 64, 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = ffn.moe_init(gen, d, f, e, "swiglu", dt)
    x = torch.randn((1, t, d), generator=gen, device="cuda").to(dt)
    xt = x.reshape(t, d)
    h = (torch.randn((t, e * f), generator=gen, device="cuda") * 0.1).to(dt)
    calls = [(xt.float(), p["router"], None), (xt, p["w_gate"], "silu"),
             (xt, p["w_in"], None), (h, p["w_out"], None)]
    for a, b, act in calls:
        path = mm.choose_path(a.dtype, b.dtype)
        if path != "fma":
            assert mm.operand_mode(a, "a")[1] and mm.operand_mode(b, "b")[1]
        before = mm.LAUNCHES.by_path[path]
        got = ops.matmul(a, b, activation=act)
        torch.cuda.synchronize()
        assert mm.LAUNCHES.by_path[path] == before + 1
        want = kref.matmul_fused_ref(a, b, activation=act)
        tol = 1e-5 if want.dtype == torch.float32 else 8e-3
        top = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * top, (path, err)
    # the whole block, card against the CPU's plain version: tokens whose
    # expert sets differ (a near-tie, checked) are left out of the output
    # comparison
    y, aux = ffn.moe_dense(p, x, top_k=6, activation="swiglu")
    p_cpu = {k: v.cpu() for k, v in p.items()}
    want, want_aux = ffn.moe_dense(p_cpu, x.cpu(), top_k=6,
                                   activation="swiglu")
    logits = xt.float().cpu() @ p_cpu["router"]
    ids_card = ffn._router_topk(logits.cuda(), 6)[1].cpu().numpy()
    ids_cpu = ffn._router_topk(logits, 6)[1].numpy()
    _same_ids(ids_card, ids_cpu, torch.softmax(logits, -1).numpy())
    same = [set(a) == set(b) for a, b in zip(ids_card, ids_cpu)]
    tol = 1e-5 if dt == torch.float32 else 8e-3
    top = want.float().abs().max().item()
    err = (y.cpu().float() - want.float()).abs()[0, same].max().item()
    assert err <= tol * top
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)
