"""The port's VLM backbone (qwen2-vl-72b: M-RoPE and the vision stub)
against the reference, on the CPU, at reduced size (``.reduced()``: d 64,
GQA 4/4 of hd 16, vocab 256, fp32), on the reference's parameters carried
across by ``params_from_jax``.

* ``apply_mrope`` with distinct (t, h, w) planes at hd 16 (sections (2, 3,
  3)) and hd 128 ((16, 24, 24)): atol 1e-5 (fp32 sin and cos of the same
  angles); text-only positions rotate exactly as RoPE does, bit for bit;
* ``mrope_positions``: the cases of the reference's
  ``tests/test_serving.py::test_mrope_positions_helper``;
* ``forward_logits``, ``prefill`` and ``loss`` (ce, aux and z) with
  ``vision_embeds`` over the first P positions and distinct (t, h, w)
  positions: atol 1e-4 (fp32), the patch positions' targets masked out of
  the loss as the reference masks them;
* ``decode_step`` with per-step positions against the reference's steps
  (1e-4) and the forward (2e-3); without positions it raises;
* the loss's gradients against ``jax.value_and_grad`` (1e-4 x
  max|grad| a leaf, fp32);
* the data pipeline's vision batch: shapes, dtypes, text-only positions;
* served tokens equal the reference's engines' (static, continuous), and
  the macro-step with an EOS inside it, ragged budgets and slot turnover
  equals the static engine (the reference's ``tests/test_serving.py``
  cases for this config).
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
    from repro.models import build_model as j_build_model
    from repro.models import common as jcommon
    from repro.models.model import _vlm_patches as j_vlm_patches
    from repro.serving import ContinuousServeEngine as JContinuous
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JStatic
except ImportError:
    jax = None

needs_reference = pytest.mark.skipif(
    jax is None, reason="needs jax and the reference package")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    apply_mrope,
    apply_rope,
    mrope_sections,
)
from repro_torch.models.model import (  # noqa: E402
    _vlm_patches, mrope_positions)
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousServeEngine,
    Request,
    ServeEngine,
)

ARCH = "qwen2-vl-72b"
ATOL = 1e-4
ROPE_ATOL = 1e-5
DECODE_TOL = 2e-3  # atol and rtol of tests/test_decode_consistency.py
PROMPT_LEN, MAX_NEW = 7, 9
MAX_LEN = PROMPT_LEN + MAX_NEW


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol, what="", rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=what)


_CACHE = {}


def _pair():
    if not _CACHE:
        jcfg = j_get_config(ARCH).reduced()
        cfg = get_config(ARCH).reduced()
        jmodel = j_build_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        _CACHE.update(jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams,
                      model=build_model(cfg, "cpu"),
                      params=params_from_jax(_np(jparams), cfg, "cpu"))
    return _CACHE


def _planes(b, s, seed):
    """Distinct (t, h, w) ids: t sequential, h and w a patch grid's rows
    and columns, shuffled per row."""
    rng = np.random.default_rng(seed)
    t = np.arange(s)[None].repeat(b, 0)
    h = rng.integers(0, 6, (b, s))
    w = rng.integers(0, 9, (b, s))
    return np.stack([t, h, w], axis=-1).astype(np.int32)


def _vision_batch(cfg, b, s, seed):
    """Tokens, ``vision_embeds`` over the first P positions (P as the
    reference sizes it for S) and distinct (t, h, w) positions."""
    rng = np.random.default_rng(seed)
    p = j_vlm_patches(j_get_config(ARCH).reduced(), s)
    return dict(
        tokens=rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32),
        vision_embeds=(rng.standard_normal((b, p, cfg.d_model)) * 0.02)
        .astype(np.float32),
        positions=_planes(b, s, seed))


def _torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    if "positions" in out:
        out["positions"] = out["positions"].long()
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@needs_reference
def test_config_matches_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(get_config(ARCH).reduced()) == \
        dataclasses.asdict(j_get_config(ARCH).reduced())


@pytest.mark.parametrize("hd,want", [(16, (2, 3, 3)), (128, (16, 24, 24)),
                                     (80, (10, 15, 15)), (24, (3, 4, 5))])
def test_mrope_sections(hd, want):
    """(16, 24, 24) scaled to hd/2 by integer floor, the last section
    taking the remainder."""
    assert mrope_sections(hd) == want
    assert sum(want) == hd // 2


@needs_reference
@pytest.mark.parametrize("hd", [16, 128])
def test_apply_mrope_matches_reference(hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 11, 3, hd)).astype(np.float32)
    pos = _planes(2, 11, hd)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos).long(), 1e6)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    _close(got, want, ROPE_ATOL, "apply_mrope")
    # the planes matter: a plain RoPE by t alone differs
    rope = apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]).long(),
                      1e6)
    assert not torch.allclose(got, rope, atol=1e-3)


@pytest.mark.parametrize("hd", [16, 128])
def test_text_only_mrope_equals_rope_bitwise(hd):
    x = torch.randn((2, 9, 4, hd), generator=torch.Generator().manual_seed(hd))
    pos = torch.arange(5, 14)[None].expand(2, 9)
    got = apply_mrope(x, mrope_positions(2, 9, 5), 1e6)
    assert torch.equal(got, apply_rope(x, pos, 1e6))


def test_mrope_positions_helper():
    """The reference's tests/test_serving.py::test_mrope_positions_helper
    cases, on the port's helper."""
    scalar = mrope_positions(2, 3, 5).numpy()
    assert scalar.shape == (2, 3, 3)
    np.testing.assert_array_equal(scalar[0, :, 0], [5, 6, 7])
    np.testing.assert_array_equal(scalar[1], scalar[0])
    assert (scalar == scalar[..., :1]).all()  # three planes share the index
    vec = mrope_positions(2, 2, torch.tensor([3, 10], dtype=torch.int32))
    vec = vec.numpy()
    np.testing.assert_array_equal(vec[0, :, 0], [3, 4])
    np.testing.assert_array_equal(vec[1, :, 0], [10, 11])
    dev = mrope_positions(2, 2, torch.tensor([3, 10])).numpy()
    np.testing.assert_array_equal(dev, vec)


# ---------------------------------------------------------------------------
# The model with the vision stub
# ---------------------------------------------------------------------------


@needs_reference
def test_forward_logits_and_loss_with_vision_match_reference():
    pair = _pair()
    jm, jp, m, p = pair["jmodel"], pair["jparams"], pair["model"], \
        pair["params"]
    s = 24
    batch = _vision_batch(pair["cfg"], 2, s, seed=1)
    assert _vlm_patches(m.cfg, s) == batch["vision_embeds"].shape[1] == 3
    want, _ = jm.forward_logits(jp, _jax(batch))
    got, aux = m.forward_logits(p, _torch(batch))
    _close(got, want, ATOL, "forward_logits")
    assert aux.shape == () and float(aux) == 0.0
    _close(m.prefill(p, _torch(batch)), jm.prefill(jp, _jax(batch)), ATOL,
           "prefill")
    jtotal, jmet = jm.loss(jp, _jax(batch))
    total, met = m.loss(p, _torch(batch), remat=False)
    for name in ("ce", "aux", "z"):
        _close(met[name], jmet[name], ATOL, name)
    _close(total, jtotal, ATOL, "total loss")
    # the splice: the first P positions read the vision embeddings, not
    # the tokens, and the patch positions' targets are out of the loss
    other = dict(batch, tokens=batch["tokens"].copy())
    other["tokens"][:, :3] = 1
    got2, _ = m.forward_logits(p, _torch(other))
    assert torch.equal(got2, got)
    moved = dict(batch, tokens=batch["tokens"].copy())
    moved["tokens"][:, 1:3] = (moved["tokens"][:, 1:3] + 1) % 256
    _, met2 = m.loss(p, _torch(moved), remat=False)
    assert float(met2["ce"]) == float(met["ce"])


@needs_reference
def test_decode_with_positions_matches_forward():
    """Token by token with distinct (t, h, w) positions fed per step,
    against the reference's steps (1e-4) and the full forward (2e-3);
    without positions the step raises."""
    pair = _pair()
    jm, jp, m, p = pair["jmodel"], pair["jparams"], pair["model"], \
        pair["params"]
    b, s = 2, 16
    batch = _vision_batch(pair["cfg"], b, s, seed=2)
    del batch["vision_embeds"]
    full, _ = jm.forward_logits(jp, _jax(batch))
    jst = jm.init_decode_state(b, s + 4)
    st = m.init_decode_state(b, s + 4)
    outs = []
    for t in range(s):
        feed = {k: v[:, t:t + 1] for k, v in batch.items()}
        want, jst = jm.decode_step(jp, jst, _jax(feed))
        got, st = m.decode_step(p, st, _torch(feed))
        _close(got, want, ATOL, f"decode step {t}")
        outs.append(got[:, 0])
    _close(torch.stack(outs, 1), full, DECODE_TOL, "decode vs forward",
           rtol=DECODE_TOL)
    with pytest.raises(ValueError, match="positions"):
        m.decode_step(p, st, {"tokens": torch.ones((b, 1), dtype=torch.long)})


@needs_reference
def test_loss_gradients_with_vision_match_reference():
    """The loss with vision embeddings and distinct (t, h, w) positions:
    every parameter's gradient against ``jax.value_and_grad`` of the
    reference's, within 1e-4 x max|grad| a leaf (fp32)."""
    from repro_torch.training.step import make_grad_fn
    from repro_torch.tree import leaves_with_paths

    pair = _pair()
    batch = _vision_batch(pair["cfg"], 2, 16, seed=4)
    jloss, jgrads = jax.value_and_grad(lambda q: pair["jmodel"].loss(
        q, _jax(batch))[0])(pair["jparams"])
    loss, _, grads = make_grad_fn(pair["model"])(pair["params"],
                                                 _torch(batch))
    _close(loss, jloss, ATOL, "loss")
    want = params_from_jax(_np(jgrads), pair["cfg"], "cpu")
    for (path, g), (_, w) in zip(leaves_with_paths(grads),
                                 leaves_with_paths(want)):
        _close(g, w.numpy(), 1e-4 * w.abs().max().item(), path)


def test_pipeline_vision_batch():
    cfg = get_config(ARCH).reduced()
    data = SyntheticLMData(cfg, seq_len=32, global_batch=4, seed=3)
    batch = data.batch_at(5)
    assert set(batch) == {"tokens", "vision_embeds", "positions"}
    assert batch["tokens"].shape == (4, 32)
    assert batch["tokens"].dtype == torch.int64
    assert batch["vision_embeds"].shape == (4, 4, cfg.d_model)
    assert batch["vision_embeds"].dtype == torch.float32
    assert 0.01 < float(batch["vision_embeds"].std()) < 0.03
    assert batch["positions"].shape == (4, 32, 3)
    assert batch["positions"].dtype == torch.int64
    assert torch.equal(batch["positions"], mrope_positions(4, 32, 0))
    again = data.batch_at(5)
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    model = build_model(cfg, "cpu")
    total, met = model.loss(model.init(0), batch, remat=False)
    assert bool(torch.isfinite(total)) and float(met["aux"]) == 0.0
    short = SyntheticLMData(cfg, seq_len=8, global_batch=2).batch_at(0)
    assert short["vision_embeds"].shape == (2, 0, cfg.d_model)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _spec_engine():
    return CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))


def _prompts(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, PROMPT_LEN)).astype(np.int32)


@needs_reference
def test_served_tokens_match_reference_engines():
    """Static and continuous (3 requests on 2 slots) against the
    reference's engines, host syncs and dispatches too."""
    pair = _pair()
    prompts = _prompts(pair["cfg"], 3, seed=5)
    want = JStatic(pair["jmodel"], pair["jparams"], max_len=MAX_LEN,
                   eos_id=-1).generate(prompts, max_new_tokens=MAX_NEW)
    jrep = JContinuous(pair["jmodel"], pair["jparams"], max_len=MAX_LEN,
                       cost_engine=JCostEngine(hw=V5E), n_slots=2,
                       eos_id=-1).run(
        [JRequest(f"r{i}", prompts[i], MAX_NEW) for i in range(3)],
        now_fn=lambda: 0.0)
    static = ServeEngine(pair["model"], pair["params"], max_len=MAX_LEN,
                         eos_id=-1).generate(prompts, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(static, want)
    rep = ContinuousServeEngine(
        pair["model"], pair["params"], max_len=MAX_LEN,
        cost_engine=_spec_engine(), n_slots=2, eos_id=-1).run(
        [Request(f"r{i}", prompts[i], MAX_NEW) for i in range(3)],
        now_fn=lambda: 0.0)
    got = np.stack([rep.output(f"r{i}", MAX_NEW) for i in range(3)])
    np.testing.assert_array_equal(got, want)
    assert rep.host_syncs == jrep.host_syncs
    assert rep.device_dispatches == jrep.device_dispatches


@needs_reference
def test_macro_step_eos_turnover_ragged_budgets_match_static():
    """Pinned K=4 macro-steps with an EOS inside one, slot turnover (2
    slots, 3 requests) and ragged budgets: the port's continuous tokens
    equal the reference's static engine's (the reference's
    tests/test_serving.py case for this config)."""
    pair = _pair()
    prompts = _prompts(pair["cfg"], 3, seed=0)
    base = JStatic(pair["jmodel"], pair["jparams"], max_len=MAX_LEN,
                   eos_id=-1).generate(prompts, max_new_tokens=MAX_NEW)
    eos = int(base[0, 3])
    want = JStatic(pair["jmodel"], pair["jparams"], max_len=MAX_LEN,
                   eos_id=eos, pad_id=0).generate(prompts,
                                                  max_new_tokens=MAX_NEW)
    budgets = [MAX_NEW, 5, 6]
    rep = ContinuousServeEngine(
        pair["model"], pair["params"], max_len=MAX_LEN,
        cost_engine=_spec_engine(), n_slots=2, eos_id=eos, pad_id=0,
        macro_step=4).run(
        [Request(f"r{i}", prompts[i], budgets[i]) for i in range(3)],
        now_fn=lambda: 0.0)
    for i in range(3):
        np.testing.assert_array_equal(rep.output(f"r{i}", budgets[i]),
                                      want[i, :budgets[i]])
    assert rep.all_terminal


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


def test_serve_launcher_runs_qwen2_vl(capsys):
    from repro_torch.launch import serve

    rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--requests", "3", "--max-new", "4", "--slots", "2",
                     "--engine", "both"])
    assert rc in (0, None)
    assert "r2" in capsys.readouterr().out
