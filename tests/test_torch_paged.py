"""The port's paged KV cache and radix prefix cache against the reference's,
on the CPU, at reduced size (fp32), on the reference's parameters carried
across by ``params_from_jax``.

* ``paged_update_kv_cache`` and ``paged_gather_kv`` on seeded inputs
  (per-slot and whole-batch offsets, chunks that cross pages, writes past
  the table and masked rows routed to the null page) are bit-equal to the
  reference's;
* slot surgery (``reset_decode_slots``, ``insert_decode_slot``,
  ``merge_decode_state``) leaves the page pools untouched, also where the
  pool has exactly as many pages as there are slots;
* the paged continuous engine on the reference's shared-prefix trace
  (block size 4, a 6-token prefix, 1-3 slots, forced and cost-decided
  reuse) emits the reference's tokens and the port's static tokens, with
  the reference's prefix hits, prefilled tokens, copy-on-write count,
  reserved pages, host syncs, device dispatches and serve_prefix verdicts;
  also with a prompt one short of ``max_len`` (the chunk filter) and a
  block size that does not divide ``max_len``;
* a page deduplicated by the trie holds the same bits as the page that
  replaces it;
* rwkv6-3b: ``paged=True`` serves the dense tokens, prefix reuse stays off;
* bad configurations are rejected as the reference rejects them;
* the token stream carries exactly the outputs, adds no host sync, and a
  broken stream fails what is in flight and empties the pool;
* ``examples/torch_quickstart.py --device cpu`` runs to its end.

Left out, waiting for the robustness slice of the port: the reference's
paged preemption, deadline and fatal-abort tests
(``tests/test_serving_paged.py``); its sharded paged test waits for
multi-GPU.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.costs.engine import CostEngine as JCostEngine  # noqa: E402
from repro.hw import V5E  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import ContinuousServeEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JStatic  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousServeEngine,
    Request,
    RequestState,
    ServeEngine,
    StreamBroken,
    TokenStream,
)
from repro_torch.tree import leaves_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 4
P_LEN, NEW = 8, 8
MAX_LEN = P_LEN + NEW
COUNTERS = ("host_syncs", "device_dispatches", "prefix_hit_tokens",
            "prefilled_tokens", "cow_count", "reserved_blocks")


def _build(arch="tinyllama-1.1b"):
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, jmodel, jparams, model, params


@pytest.fixture(scope="module")
def llama():
    return _build()


def _spec_engine():
    """The port's engine on the reference's default spec, so its decisions
    are the reference's."""
    return CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))


def _shared_prompts(cfg, n=6, p=P_LEN, prefix=6, seed=7):
    """The reference's shared-prefix trace: ``n`` prompts opening with one
    ``prefix``-token system prompt."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size, (n, p)).astype(np.int32)
    prompts[:, :prefix] = prompts[0, :prefix]
    return prompts


def _run_both(llama, prompts, new, *, n_slots, max_len, **kw):
    """(reference report, reference engine, port report, port engine) of
    the same trace through both paged engines."""
    _, jmodel, jparams, model, params = llama
    jengine = JContinuous(jmodel, jparams, n_slots=n_slots, max_len=max_len,
                          eos_id=0, cost_engine=JCostEngine(hw=V5E),
                          paged=True, **kw)
    jrep = jengine.run([JRequest(f"r{i}", prompts[i], new)
                        for i in range(len(prompts))], now_fn=lambda: 0.0)
    engine = ContinuousServeEngine(model, params, n_slots=n_slots,
                                   max_len=max_len, eos_id=0,
                                   cost_engine=_spec_engine(), paged=True,
                                   **kw)
    rep = engine.run([Request(f"r{i}", prompts[i], new)
                      for i in range(len(prompts))], now_fn=lambda: 0.0)
    return jrep, jengine, rep, engine


def _verdicts(ledger):
    return [(e.choice, e.query["hit_tokens"], e.measured_s is None)
            for e in ledger.entries if e.site == "serve_prefix"]


# ---------------------------------------------------------------------------
# Paged update and gather, bit for bit
# ---------------------------------------------------------------------------

N_BLOCKS, MAX_BLOCKS, HKV, HD = 9, 3, 2, 8


def _tables():
    """Slot 0 owns pages 1-3, slot 1 pages 4-5 (its third entry
    unallocated), slot 2 nothing (a masked row)."""
    return np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)


@pytest.mark.parametrize("pos,s_new", [
    ([0, 3, 5], 1),        # per-slot offsets, one token each
    ([2, 1, 0], 4),        # chunks crossing a page boundary
    ([10, 11, 2], 3),      # writes past the table land in the null page
    (5, 2),                # one offset for the whole batch
], ids=["decode", "cross-page", "past-table", "batch-offset"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_update_and_gather_bit_equal_reference(pos, s_new, dtype):
    rng = np.random.default_rng(0)
    shape = (N_BLOCKS, BLOCK, HKV, HD)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    k_new = rng.standard_normal((3, s_new, HKV, HD)).astype(np.float32)
    v_new = rng.standard_normal((3, s_new, HKV, HD)).astype(np.float32)
    tables = _tables()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jpk, jpv = jattn.paged_update_kv_cache(
        jnp.asarray(pk, jd), jnp.asarray(pv, jd), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(pos, jnp.int32), jnp.asarray(tables),
        BLOCK)
    jkc, jvc = jattn.paged_gather_kv(jpk, jpv, jnp.asarray(tables), BLOCK)
    tpk = torch.from_numpy(pk).to(td)
    tpv = torch.from_numpy(pv).to(td)
    before = tpk.data_ptr()
    out_k, out_v = attn.paged_update_kv_cache(
        tpk, tpv, torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.as_tensor(pos), torch.from_numpy(tables).long(), BLOCK)
    assert out_k is tpk and out_v is tpv and tpk.data_ptr() == before
    kc, vc = attn.paged_gather_kv(tpk, tpv, torch.from_numpy(tables).long(),
                                  BLOCK)
    assert kc.shape == (3, MAX_BLOCKS * BLOCK, HKV, HD)

    def bits(x):
        return np.asarray(x.float() if isinstance(x, torch.Tensor)
                          else x.astype(jnp.float32)).view(np.uint32)

    for got, want in ((tpk, jpk), (tpv, jpv), (kc, jkc), (vc, jvc)):
        np.testing.assert_array_equal(bits(got), bits(want))
    # slot 2's writes (and slot 1's past its pages) went to page 0 only
    np.testing.assert_array_equal(bits(tpk[6:]), bits(
        torch.from_numpy(pk[6:]).to(td)))


# ---------------------------------------------------------------------------
# Slot surgery passes the page pools through
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
@pytest.mark.parametrize("n_blocks", [3, 7], ids=["blocks==slots", "more"])
def test_slot_surgery_leaves_pools_untouched(arch, n_blocks):
    """With as many pages as slots, the pool's leading axis looks like a
    slot axis: zeroing ``pk[slot]`` or broadcasting a slot mask over it
    would pass unnoticed.  Every pool must come through bit for bit."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    if arch == "rwkv6-3b":  # one paged attention layer beside one rwkv
        cfg = dataclasses.replace(cfg, block_pattern=("attn", "rwkv"))
    model = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)

    def filled():
        st = model.init_decode_state(3, 8, per_slot=True,
                                     paging=(n_blocks, BLOCK))
        for _, leaf in leaves_with_paths(st["layers"]):
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
        st["pos"].copy_(torch.tensor([3, 5, 7]))
        return st

    def pools(st):
        return {p: leaf.clone() for p, leaf in leaves_with_paths(st["layers"])
                if p.endswith(("pk", "pv"))}

    state = filled()
    assert all(v.shape[0] == n_blocks for v in pools(state).values())
    before = pools(state)
    model.reset_decode_slots(state, np.array([False, True, False]))
    src = model.init_decode_state(1, 8, per_slot=True,
                                  paging=(n_blocks, BLOCK))
    model.insert_decode_slot(state, src, 2)
    other = filled()
    merged = model.merge_decode_state(state, other,
                                      torch.tensor([True, False, True]))
    for p, v in pools(merged).items():
        assert torch.equal(v, before[p]), p
    for p, leaf in leaves_with_paths(merged["layers"]):
        if not p.endswith(("pk", "pv")):  # per-slot leaves: slot 1 frozen
            assert torch.equal(leaf[1], dict(leaves_with_paths(
                other["layers"]))[p][1]), p
    assert merged["pos"].tolist() == [3, 5, 0]


# ---------------------------------------------------------------------------
# The paged engine against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_slots,prefix_cache", [
    (1, "force"), (2, "force"), (3, "force"), (2, True)])
def test_shared_prefix_engine_matches_reference(llama, n_slots, prefix_cache):
    """The reference's shared-prefix trace: six 8-token prompts opening
    with one 6-token prefix, block 4 (one shared page plus a 2-token tail
    copied on write).  Forced reuse prefills under half the prompt tokens;
    cost-decided reuse at this toy size prefills everything."""
    cfg, jmodel, jparams, model, params = llama
    prompts = _shared_prompts(cfg)
    jrep, jengine, rep, engine = _run_both(
        llama, prompts, NEW, n_slots=n_slots, max_len=MAX_LEN,
        block_size=BLOCK, prefix_cache=prefix_cache)
    static = ServeEngine(model, params, max_len=MAX_LEN, eos_id=0).generate(
        prompts, max_new_tokens=NEW)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(rep.output(f"r{i}"),
                                      jrep.output(f"r{i}"))
        np.testing.assert_array_equal(rep.output(f"r{i}"), static[i])
    assert {k: rep.as_dict()[k] for k in COUNTERS} == \
        {k: jrep.as_dict()[k] for k in COUNTERS}
    assert _verdicts(engine.scheduler.engine.ledger) == \
        _verdicts(jengine.scheduler.engine.ledger)
    assert rep.prefix_hit_tokens + rep.prefilled_tokens == 6 * P_LEN
    if prefix_cache == "force":
        assert rep.prefilled_tokens * 2 <= 6 * P_LEN and rep.cow_count == 5
    assert engine.pool.free_count == n_slots
    assert engine.pool.blocks.used_blocks == engine.pool.blocks.trie_blocks


@pytest.mark.parametrize("p_len,max_len,block", [
    (13, 14, 4),   # one token short of max_len: the chunk filter bites
    (7, 16, 5),    # 5 does not divide 16: the gathered view is 20 long
], ids=["near-max-len", "ragged-pages"])
def test_paged_matches_reference_and_static(llama, p_len, max_len, block):
    cfg, jmodel, jparams, model, params = llama
    new = max_len - p_len
    prompts = _shared_prompts(cfg, n=5, p=p_len, prefix=p_len - 2, seed=3)
    jrep, _, rep, _ = _run_both(llama, prompts, new, n_slots=2,
                                max_len=max_len, block_size=block,
                                prefix_cache="force")
    want = JStatic(jmodel, jparams, max_len=max_len, eos_id=0).generate(
        prompts, max_new_tokens=new)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(rep.output(f"r{i}"), want[i])
        np.testing.assert_array_equal(rep.output(f"r{i}"),
                                      jrep.output(f"r{i}"))
    assert {k: rep.as_dict()[k] for k in COUNTERS} == \
        {k: jrep.as_dict()[k] for k in COUNTERS}


def test_deduplicated_page_has_the_same_bits(llama):
    """Two requests sharing two full pages, admitted as one group (the
    split that would defer the second is bypassed): the trie keeps the
    first's pages and swaps the second's duplicates out.  Each duplicate
    must hold the bits of the page it is swapped for, layer by layer."""
    cfg, _, _, model, params = llama
    prompts = _shared_prompts(cfg, n=2, p=10, prefix=9)
    engine = ContinuousServeEngine(model, params, n_slots=2, max_len=16,
                                   eos_id=-1, cost_engine=_spec_engine(),
                                   paged=True, block_size=BLOCK,
                                   prefix_cache="force")
    compared = []
    apply_swaps = engine.pool.apply_swaps

    def checked(slot, swaps):
        for _, old, new in swaps:
            for path, leaf in leaves_with_paths(engine.pool.state["layers"]):
                if path.endswith(("pk", "pv")):
                    assert torch.equal(leaf[old], leaf[new]), path
            compared.append((old, new))
        apply_swaps(slot, swaps)

    engine.pool.apply_swaps = checked
    reqs = [Request(f"r{i}", prompts[i], 4) for i in range(2)]
    for r in reqs:
        r.reset_lifecycle()
    engine._group_pad = 10
    engine._admit_group(reqs, lambda: 0.0)
    assert len(compared) == 2  # both full pages of the second request


# ---------------------------------------------------------------------------
# rwkv6, bad configurations
# ---------------------------------------------------------------------------


def test_rwkv_paged_equals_dense_without_prefix_reuse():
    cfg, jmodel, jparams, model, params = _build("rwkv6-3b")
    prompts = _shared_prompts(cfg, n=4, p=7, prefix=6, seed=2)
    want = JStatic(jmodel, jparams, max_len=16, eos_id=0).generate(
        prompts, max_new_tokens=9)
    dense = ServeEngine(model, params, max_len=16, eos_id=0).generate(
        prompts, max_new_tokens=9)
    np.testing.assert_array_equal(dense, want)
    engine = ContinuousServeEngine(model, params, n_slots=2, max_len=16,
                                   eos_id=0, cost_engine=_spec_engine(),
                                   paged=True, block_size=BLOCK,
                                   prefix_cache="force")
    assert engine.paged and not engine.prefix_cache
    rep = engine.run([Request(f"r{i}", prompts[i], 9) for i in range(4)],
                     now_fn=lambda: 0.0)
    for i in range(4):
        np.testing.assert_array_equal(rep.output(f"r{i}"), dense[i])
    assert rep.prefix_hit_tokens == 0 and rep.prefilled_tokens == 28
    assert not any(e.site == "serve_prefix" and e.choice == "use_prefix"
                   for e in engine.scheduler.engine.ledger.entries)


def test_paged_rejects_bad_configs(llama):
    cfg, _, _, model, params = llama
    with pytest.raises(ValueError, match="block_size"):
        ContinuousServeEngine(model, params, paged=True, block_size=0)
    with pytest.raises(ValueError, match="prefix_cache"):
        ContinuousServeEngine(model, params, paged=True, prefix_cache="yes")
    rt = Runtime(device="cpu")
    trace = synthetic_trace(1, prompt_len=4, max_new=2,
                            vocab_size=cfg.vocab_size, seed=0)
    with pytest.raises(ValueError, match="static"):
        rt.serve(cfg, trace, mode="static", model=model, params=params,
                 paged=True)
    with pytest.raises(ValueError, match="static"):
        rt.serve(cfg, trace, mode="static", model=model, params=params,
                 stream=True)
    with pytest.raises(ValueError, match="block_size"):
        rt.serve(cfg, trace, model=model, params=params, paged=True,
                 block_size=0)


# ---------------------------------------------------------------------------
# Runtime.serve: host syncs, the token stream
# ---------------------------------------------------------------------------


def test_runtime_paged_and_stream(llama):
    """Paged serving through the public entry point: the dense run's
    tokens and host syncs for the same pinned K and chunk; with a stream,
    the stream carries exactly the outputs at no extra host sync."""
    cfg, _, _, model, params = llama
    rt = Runtime(device="cpu")

    def trace():
        return synthetic_trace(5, prompt_len=6, max_new=7,
                               vocab_size=cfg.vocab_size, arrival="all")

    kw = dict(model=model, params=params, slots=2, eos_id=-1, macro_step=4,
              prefill_chunk=4)
    dense = rt.serve(cfg, trace(), **kw)
    paged = rt.serve(cfg, trace(), paged=True, block_size=4, **kw)
    streamed = rt.serve(cfg, trace(), paged=True, block_size=4, stream=True,
                        **kw)
    for rid, out in dense.outputs.items():
        np.testing.assert_array_equal(paged.outputs[rid], out)
        np.testing.assert_array_equal(streamed.outputs[rid], out)
        assert streamed.stream.tokens(rid) == out.tolist()
        assert streamed.stream.is_done(rid)
    assert paged.report.host_syncs == dense.report.host_syncs
    assert streamed.report.host_syncs == paged.report.host_syncs
    assert streamed.report.streamed_tokens == streamed.generated_tokens == 35
    assert paged.stream is None and paged.report.stream_events == 0
    assert paged.engine.stream is None  # detached after the run


class _BreaksAfter(TokenStream):
    def __init__(self, n):
        super().__init__()
        self.n = n

    def publish(self, rid, tokens, done, t):
        if self.published_events >= self.n:
            raise StreamBroken("consumer gone")
        super().publish(rid, tokens, done, t)


def test_broken_stream_fails_inflight_and_drains(llama):
    cfg, _, _, model, params = llama
    prompts = _shared_prompts(cfg, n=5)
    engine = ContinuousServeEngine(model, params, n_slots=2, max_len=MAX_LEN,
                                   eos_id=-1, cost_engine=_spec_engine(),
                                   paged=True, block_size=BLOCK,
                                   stream=_BreaksAfter(3))
    rep = engine.run([Request(f"r{i}", prompts[i], NEW) for i in range(5)],
                     now_fn=lambda: 0.0)
    assert rep.all_terminal
    failed = [r for r in rep.requests if r.state == RequestState.FAILED]
    assert failed and all("stream broken" in r.reason for r in failed)
    assert engine.pool.free_count == 2
    assert engine.pool.blocks.used_blocks == 0


# ---------------------------------------------------------------------------
# The quickstart
# ---------------------------------------------------------------------------


def test_quickstart_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "continuous batching matched token-for-token" in out.stdout
    assert "paged serving matched static" in out.stdout
