"""The port's dense and hybrid families against the reference, on the CPU,
at reduced size (``.reduced()``: d 64, 4 query heads of hd 16, vocab 256,
fp32), on the reference's parameters carried across by
``params_from_jax``: mistral-nemo-12b (GQA 4/4 at this size, RoPE theta
1e6), phi3-mini-3.8b (MHA), gemma-2b (MQA, GeGLU, tied embeddings scaled
by sqrt(d)) and recurrentgemma-2b (two periods of (rglru, rglru, local),
window 8, in the reference's period-scan layout).

* configs, the carried-across tree's layout (no ``unembed`` when tied);
* ``forward_logits`` and ``prefill``: atol 1e-4 (fp32, other summation
  orders; readings ~1e-6);
* token-by-token ``decode_step`` against the reference's decode steps
  (atol 1e-4) and against both packages' ``forward_logits`` (atol and rtol
  2e-3, the reference's own tests/test_decode_consistency.py tolerance);
* the ring buffer streamed past its window (window 8, 28 tokens) against
  a full forward, as the reference's ``test_local_ring_buffer_long_stream``;
* the windowed attention forms (masked dense, chunked, banded local, and
  ``attention``'s dispatch between them) against the reference's: atol
  1e-5;
* serving: static and continuous tokens equal the reference's engines',
  and recurrentgemma's paged tokens (pages of 4; no page pool, since it has
  no full-attention layer; prefix reuse off) equal the reference's paged
  engine's and the dense ones; ``Runtime.serve`` and the launcher;
* the bf16-rounded embedding scale, bit for bit the reference's;
* slot surgery on ring buffers and RG-LRU state;
* (MoE and the VLM backbone: tests/test_torch_moe.py and
  tests/test_torch_vlm.py; encoder-decoder: tests/test_torch_encdec.py);
* on a card only (``cuda`` marker): the flash forward and backward at hd
  96 and 256 against their plain versions, bf16 on the tensor cores and
  fp32 on the FMA path.
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
    from repro.models import common as jcommon
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
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import embed_lookup  # noqa: E402
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousServeEngine,
    Request,
    ServeEngine,
)
from repro_torch.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

FAMILIES = ["mistral-nemo-12b", "phi3-mini-3.8b", "gemma-2b",
            "recurrentgemma-2b"]
TIED = ("gemma-2b", "recurrentgemma-2b")
ATOL = 1e-4
DECODE_TOL = 2e-3  # atol and rtol of tests/test_decode_consistency.py
ATTN_ATOL = 1e-5
PROMPT_LEN, MAX_NEW = 7, 9
MAX_LEN = PROMPT_LEN + MAX_NEW


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(tokens):
    return {"tokens": torch.from_numpy(np.array(tokens)).long()}


def _close(got, want, atol, what="", rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=what)


_CACHE = {}


def _pair(arch):
    """The reference's reduced model and parameters, the port's model and
    the same parameters carried across (built once per arch)."""
    if arch not in _CACHE:
        jcfg = j_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        jmodel = j_build_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        _CACHE[arch] = dict(
            jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams,
            model=build_model(cfg, "cpu"),
            params=params_from_jax(_np(jparams), cfg, "cpu"))
    return _CACHE[arch]


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("arch", FAMILIES)
def test_config_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(j_get_config(arch).reduced())


@needs_reference
@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_layout_matches_init(arch):
    """The carried-across tree has the port's own init layout (paths,
    shapes, dtypes); a tied tree has no ``unembed`` on either side."""
    pair = _pair(arch)
    mine = sorted((p, tuple(t.shape), t.dtype)
                  for p, t in leaves_with_paths(pair["model"].init(0)))
    got = sorted((p, tuple(t.shape), t.dtype)
                 for p, t in leaves_with_paths(pair["params"]))
    assert got == mine
    tied = arch in TIED
    assert ("unembed" in pair["jparams"]) is not tied
    assert ("unembed" in pair["params"]) is not tied
    if arch == "recurrentgemma-2b":
        assert "groups" in pair["jparams"]["layers"]  # the period-scan layout
        kinds = [set(lp) - {"ln1", "ln2"} for lp in pair["params"]["layers"]]
        assert kinds == [{"rglru", "ffn"}, {"rglru", "ffn"},
                         {"attn", "ffn"}] * 2


@needs_reference
def test_tied_logits_read_the_embedding():
    """gemma-2b: the logits are x @ embed.T (no unembed leaf); moving one
    embedding row moves that token's logit."""
    pair = _pair("gemma-2b")
    m, p = pair["model"], pair["params"]
    tokens = _tokens(pair["cfg"], 1, 5)
    base = m.prefill(p, _batch(tokens))
    moved = dict(p, embed=p["embed"].clone())
    moved["embed"][17] += 1.0
    after = m.prefill(moved, _batch(tokens))
    diff = (after - base).abs()[0, 0]
    assert diff[17] > 1e-3 and diff.argmax() == 17


# ---------------------------------------------------------------------------
# Forward, prefill and decode
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_and_prefill_match_reference(arch):
    pair = _pair(arch)
    jm, jp, m, p = pair["jmodel"], pair["jparams"], pair["model"], \
        pair["params"]
    tokens = _tokens(pair["cfg"], 2, 24, seed=1)
    want, _ = jm.forward_logits(jp, {"tokens": jnp.asarray(tokens)})
    got, aux = m.forward_logits(p, _batch(tokens))
    _close(got, want, ATOL, "forward_logits")
    assert float(aux) == 0.0
    want = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    _close(m.prefill(p, _batch(tokens)), want, ATOL, "prefill")


@needs_reference
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """The port's counterpart of the reference's
    tests/test_decode_consistency.py::test_decode_matches_forward: B 2, S
    24 token by token against the full forward (2e-3), and each step
    against the reference's step (1e-4)."""
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
def test_local_ring_buffer_long_stream():
    """recurrentgemma, window 8: 28 tokens streamed one at a time wrap the
    ring buffer three times; the last step's logits equal a full
    forward's last position (2e-3, as the reference's test) and the
    reference's decode (1e-4)."""
    pair = _pair("recurrentgemma-2b")
    jm, jp, m, p = pair["jmodel"], pair["jparams"], pair["model"], \
        pair["params"]
    assert pair["cfg"].window_size == 8
    tokens = _tokens(pair["cfg"], 1, 28, seed=3)
    full, _ = jm.forward_logits(jp, {"tokens": jnp.asarray(tokens)})
    jst = jm.init_decode_state(1, 28)
    st = m.init_decode_state(1, 28)
    for t in range(28):
        feed = tokens[:, t:t + 1]
        want, jst = jm.decode_step(jp, jst, {"tokens": jnp.asarray(feed)})
        got, st = m.decode_step(p, st, _batch(feed))
    assert st["layers"][2]["k"].shape[1] == 8  # the ring, not the stream
    _close(got[:, 0], np.asarray(full)[:, -1], DECODE_TOL,
           "stream vs forward", rtol=DECODE_TOL)
    _close(got, want, ATOL, "stream vs reference stream")
    # the ring buffer's contents, slot by slot, are the reference's
    jring = jst["layers"]["groups"]["2"]["k"][1]  # group 1's local layer
    _close(st["layers"][5]["k"], jring, ATOL, "ring buffer")


def _qkv(b, s, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, hd)).astype(np.float32)
                 for h in (hq, hkv, hkv))


@needs_reference
@pytest.mark.parametrize("form", ["dense", "chunked", "local", "dispatch"])
def test_windowed_attention_matches_reference(form):
    """Each windowed form on seeded inputs (GQA 6/2, S 37 not a multiple
    of the window 5) against the reference's same form."""
    q, k, v = _qkv(2, 37, 6, 2, 8, seed=4)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    w = 5
    if form == "dense":
        got = attn.dense_attention(tq, tk, tv, window=w)
        want = jattn.dense_attention(jq, jk, jv, window=w)
    elif form == "chunked":
        got = attn.chunked_attention(tq, tk, tv, window=w, chunk=8)
        want = jattn.chunked_attention(jq, jk, jv, window=w, chunk=8)
    elif form == "local":
        got = attn.local_attention(tq, tk, tv, window=w)
        want = jattn.local_attention(jq, jk, jv, window=w)
    else:  # S 37 > 2 * 5: the banded form, as in the reference
        got = attn.attention(tq, tk, tv, window=w)
        want = jattn.attention(jq, jk, jv, window=w)
        _close(got, attn.local_attention(tq, tk, tv, window=w).numpy(), 0.0,
               "dispatch takes the banded form")
        short = attn.attention(tq[:, :9], tk[:, :9], tv[:, :9], window=w)
        _close(short, np.asarray(jattn.attention(jq[:, :9], jk[:, :9],
                                                 jv[:, :9], window=w)),
               ATTN_ATOL, "dispatch below 2 * window")
    _close(got, want, ATTN_ATOL, form)
    # every form is the same function
    _close(got, np.asarray(jattn.dense_attention(jq, jk, jv, window=w)),
           ATTN_ATOL, f"{form} vs dense")


# ---------------------------------------------------------------------------
# The embedding scale
# ---------------------------------------------------------------------------


@needs_reference
@pytest.mark.parametrize("d", [2048, 2560])
def test_embedding_scale_rounds_to_bf16(d):
    """gemma's sqrt(2048) and recurrentgemma's sqrt(2560) multiply in the
    table's dtype after rounding to it (45.25 and 50.5 in bf16), bit for
    bit the reference's ``embed_lookup``; an fp32 scale would differ."""
    rng = np.random.default_rng(d)
    table32 = (rng.standard_normal((64, 32)) * 0.02).astype(np.float32)
    ids = np.array([[0, 5, 63, -1]])
    table = torch.from_numpy(table32).to(torch.bfloat16)
    scale = float(d) ** 0.5
    got = embed_lookup(table, torch.from_numpy(ids), scale)
    want = jcommon.embed_lookup(jnp.asarray(table.float().numpy(),
                                            jnp.bfloat16),
                                jnp.asarray(ids), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    rounded = float(torch.tensor(scale, dtype=torch.bfloat16))
    assert rounded == {2048: 45.25, 2560: 50.5}[d]
    rows = table[torch.from_numpy(ids % 64)].float()
    assert torch.equal(got, (rows * rounded).to(torch.bfloat16))
    assert not torch.equal(got, (rows * scale).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _spec_engine():
    return CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))


def _run_port(model, params, prompts, **kw):
    engine = ContinuousServeEngine(model, params, max_len=MAX_LEN,
                                   cost_engine=_spec_engine(), **kw)
    return engine.run([Request(f"r{i}", prompts[i], MAX_NEW)
                       for i in range(len(prompts))], now_fn=lambda: 0.0)


def _run_ref(pair, prompts, **kw):
    engine = JContinuous(pair["jmodel"], pair["jparams"], max_len=MAX_LEN,
                         cost_engine=JCostEngine(hw=V5E), **kw)
    return engine.run([JRequest(f"r{i}", prompts[i], MAX_NEW)
                       for i in range(len(prompts))], now_fn=lambda: 0.0)


def _outputs(report, n):
    return np.stack([report.output(f"r{i}", MAX_NEW) for i in range(n)])


@needs_reference
@pytest.mark.parametrize("arch", FAMILIES)
def test_served_tokens_match_reference_engines(arch):
    """Static and continuous (3 requests on 2 slots, auto horizon; the
    hybrid family prefills by chunk-1 replay) against the reference's
    static and continuous engines, with its host syncs and dispatches."""
    pair = _pair(arch)
    prompts = _tokens(pair["cfg"], 3, PROMPT_LEN, seed=5)
    want = JStatic(pair["jmodel"], pair["jparams"], max_len=MAX_LEN,
                   eos_id=-1).generate(prompts, max_new_tokens=MAX_NEW)
    jrep = _run_ref(pair, prompts, n_slots=2, eos_id=-1)
    np.testing.assert_array_equal(_outputs(jrep, 3), want)
    static = ServeEngine(pair["model"], pair["params"], max_len=MAX_LEN,
                         eos_id=-1).generate(prompts, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(static, want)
    rep = _run_port(pair["model"], pair["params"], prompts, n_slots=2,
                    eos_id=-1)
    np.testing.assert_array_equal(_outputs(rep, 3), want)
    assert rep.host_syncs == jrep.host_syncs
    assert rep.device_dispatches == jrep.device_dispatches


@needs_reference
def test_paged_recurrentgemma_serves_dense_tokens():
    """paged=True keeps the paged layout for a model with no full-attention
    layer: no page pool at all, ring buffers and RG-LRU state dense per
    slot, prefix reuse off, full prefill; the tokens are the reference's
    paged engine's and the dense ones."""
    pair = _pair("recurrentgemma-2b")
    prompts = _tokens(pair["cfg"], 3, PROMPT_LEN, seed=6)
    dense = _run_port(pair["model"], pair["params"], prompts, n_slots=2,
                      eos_id=-1)
    jrep = _run_ref(pair, prompts, n_slots=2, eos_id=-1, paged=True,
                    block_size=4, prefix_cache="force")
    engine = ContinuousServeEngine(pair["model"], pair["params"],
                                   max_len=MAX_LEN, n_slots=2, eos_id=-1,
                                   cost_engine=_spec_engine(), paged=True,
                                   block_size=4, prefix_cache="force")
    assert not engine.prefix_cache
    assert not any(p.endswith(("pk", "pv"))
                   for p, _ in leaves_with_paths(engine.pool.state["layers"]))
    rep = engine.run([Request(f"r{i}", prompts[i], MAX_NEW)
                      for i in range(3)], now_fn=lambda: 0.0)
    np.testing.assert_array_equal(_outputs(rep, 3), _outputs(dense, 3))
    np.testing.assert_array_equal(_outputs(rep, 3), _outputs(jrep, 3))
    assert rep.prefix_hit_tokens == jrep.prefix_hit_tokens == 0
    assert rep.prefilled_tokens == jrep.prefilled_tokens == 3 * PROMPT_LEN
    assert rep.host_syncs == jrep.host_syncs


@pytest.mark.parametrize("arch", FAMILIES)
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


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-2b"])
def test_serve_launcher_runs_the_new_families(arch, capsys):
    from repro_torch.launch import serve

    rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--requests", "3", "--max-new", "4", "--slots", "2",
                     "--engine", "both"])
    assert rc in (0, None)
    assert "r2" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Slot surgery on ring buffers and RG-LRU state
# ---------------------------------------------------------------------------


def test_slot_surgery_on_ring_buffers_and_rglru_state():
    """Reset, insert and a masked merge on recurrentgemma's per-slot
    leaves (ring buffers, h, conv): the other slots keep their bits."""
    cfg = get_config("recurrentgemma-2b").reduced()
    model = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)

    def filled(batch):
        st = model.init_decode_state(batch, MAX_LEN, per_slot=True)
        for leaf in leaves(st["layers"]):
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
        st["pos"].copy_(torch.arange(batch) + 3)
        return st

    st = filled(3)
    kinds = {p.split("/", 1)[1] for p, _ in leaves_with_paths(st["layers"])}
    assert kinds == {"h", "conv", "k", "v"}
    assert st["layers"][0]["h"].dtype == torch.float32
    assert st["layers"][2]["k"].shape == (3, cfg.window_size,
                                          cfg.n_kv_heads, 16)
    before = tree_map(torch.clone, st)
    model.reset_decode_slots(st, np.array([False, True, False]))
    for new, old in zip(leaves(st["layers"]), leaves(before["layers"])):
        assert torch.equal(new[1], torch.zeros_like(new[1]))
        assert torch.equal(new[0], old[0]) and torch.equal(new[2], old[2])
    src = filled(1)
    model.insert_decode_slot(st, src, 1)
    for new, one in zip(leaves(st["layers"]), leaves(src["layers"])):
        assert torch.equal(new[1], one[0])
    params = model.init(0)
    _, stepped = model.decode_step(params, st,
                                   {"tokens": torch.tensor([[5], [7], [9]])})
    merged = model.merge_decode_state(stepped, st,
                                      torch.tensor([True, False, True]))
    for m_, new, old in zip(leaves(merged["layers"]),
                            leaves(stepped["layers"]), leaves(st["layers"])):
        assert torch.equal(m_[1], old[1])
        assert torch.equal(m_[0], new[0]) and torch.equal(m_[2], new[2])
    assert merged["pos"].tolist() == [4, 3, 6]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 200, 32, 32, 96), (1, 300, 8, 1, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_forward_new_head_dims_on_card(shape, dtype):
    """phi3's MHA at hd 96 and gemma's MQA at hd 256: the forward kernel
    (bf16 on the tensor cores, fp32 on the FMA path) against its plain
    version, fp32 within 2e-3 x max|plain|, bf16 element by element within
    8e-3 x its row's max|plain| + 1e-5 x max|plain| (chip_smoke.py phase
    7's rule); the backward kernel (on the same path, fed the plain
    forward's output and lse) against the plain backward by the same
    rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda "
                    "tests/test_torch_families.py`")
    b, s, hq, hkv, hd = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(hd)
    q, k, v, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
                   .to(dt) for h in (hq, hkv, hkv, hq))
    path = "tensor_core" if dt == torch.bfloat16 else "fma"
    assert fa.choose_path(dt, hd) == path
    before = fa.LAUNCHES.by_path[path]
    o, lse = fa.flash_attention_fwd_cuda(q, k, v)
    o_p, lse_p = kref.flash_attention_fwd_plain(q, k, v)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do)
    grads_p = kref.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.by_path[path] == before + 2
    for got, want in ((o, o_p), (lse, lse_p), *zip(grads, grads_p)):
        diff = (got.float() - want.float()).abs()
        mag = want.float().abs()
        if want.dtype == torch.bfloat16:
            limit = 8e-3 * mag.amax(-1, keepdim=True) + 1e-5 * mag.max()
        else:
            limit = 2e-3 * mag.max()
        assert bool((diff <= limit).all()), diff.max().item()
