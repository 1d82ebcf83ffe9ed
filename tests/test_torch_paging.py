"""The port's paged-KV host bookkeeping against the reference's, on the CPU.

* ``BlockPool`` and the radix trie: the reference's own cases
  (``tests/test_serving_paged.py``: refcounts and the null block, the
  lookup cap at prompt_len - 1, dedupe swaps, LRU eviction of idle trie
  leaves only, drain, ``default_kv_blocks``) run on both pools, and a
  seeded random sequence of alloc / incref / decref / release / lookup /
  insert / ensure / drain gives the same block ids, refcounts,
  ``PrefixMatch``es, swaps, evictions and errors on both;
* the ``serve_prefix`` decision site: the same verdicts, values and ledger
  rows as the reference's engine on the reference's hardware spec;
* ``synthetic_trace(prefix_share=, prefix_len=)`` makes the reference's
  prompts for the same seed, and rejects what it rejects;
* ``RuntimeConfig.from_env`` reads an explicit mapping;
* ``TokenStream``: bursts, the terminal event, first-token time.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.costs.engine import CostEngine as JCostEngine  # noqa: E402
from repro.hw import V5E  # noqa: E402
from repro.runtime import synthetic_trace as j_synthetic_trace  # noqa: E402
from repro.serving.paging import BlockPool as JBlockPool  # noqa: E402
from repro.serving.paging import default_kv_blocks as j_default_kv_blocks  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.runtime import RuntimeConfig, synthetic_trace  # noqa: E402
from repro_torch.serving import BlockPool, TokenStream, default_kv_blocks  # noqa: E402

BLOCK = 4
POOLS = pytest.mark.parametrize("Pool", [JBlockPool, BlockPool],
                                ids=["reference", "port"])


# ---------------------------------------------------------------------------
# The reference's BlockPool cases, on both pools
# ---------------------------------------------------------------------------


@POOLS
def test_block_pool_refcounts_and_null_block(Pool):
    pool = Pool(6, BLOCK)
    assert pool.free_blocks == 5 and pool.used_blocks == 0
    bids = pool.alloc(3)
    assert 0 not in bids and len(set(bids)) == 3
    assert pool.used_blocks == 3
    pool.incref(bids[0])
    pool.release(bids)
    assert pool.used_blocks == 1
    pool.decref(bids[0])
    assert pool.used_blocks == 0 and pool.free_blocks == 5
    pool.incref(0)
    pool.decref(0)
    assert pool.refcount(0) == 1
    with pytest.raises(RuntimeError, match="decref on free block"):
        pool.decref(bids[0])
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(6)


@POOLS
def test_lookup_caps_hit_at_prompt_minus_one(Pool):
    pool = Pool(8, BLOCK)
    toks = tuple(range(100, 108))
    bids = pool.alloc(2)
    pool.insert(toks, bids)
    m = pool.lookup(toks)
    assert m.block_ids == [bids[0]]
    assert m.tail_donor == bids[1] and m.tail_len == 3
    assert m.hit_tokens(BLOCK) == 7
    assert pool.refcount(bids[0]) == 3 and pool.refcount(bids[1]) == 3


@POOLS
def test_trie_insert_dedupe_returns_swaps(Pool):
    pool = Pool(8, BLOCK)
    toks = tuple(range(4))
    first = pool.alloc(1)
    pool.insert(toks, first)
    dup = pool.alloc(1)
    assert pool.insert(toks, dup) == [(0, dup[0], first[0])]
    assert pool.refcount(dup[0]) == 0
    assert pool.refcount(first[0]) == 3


@POOLS
def test_lru_eviction_frees_idle_trie_leaves_only(Pool):
    pool = Pool(4, BLOCK)
    a = pool.alloc(2)
    pool.insert(tuple(range(8)), a)
    pool.release(a)
    got = pool.alloc(3)
    assert len(got) == 3 and pool.evictions == 2
    assert pool.trie_blocks == 0
    pool2 = Pool(4, BLOCK)
    b = pool2.alloc(2)
    pool2.insert(tuple(range(8)), b)
    assert not pool2.ensure(2)
    with pytest.raises(RuntimeError, match="exhausted"):
        pool2.alloc(2)


@POOLS
def test_drain_reclaims_every_block(Pool):
    pool = Pool(8, BLOCK)
    bids = pool.alloc(3)
    pool.insert(tuple(range(12)), bids)
    pool.lookup(tuple(range(12)))
    pool.drain()
    assert pool.used_blocks == 0 and pool.free_blocks == 7
    assert pool.trie_blocks == 0
    assert pool.lookup(tuple(range(12))).hit_tokens(BLOCK) == 0


@pytest.mark.parametrize("n_slots,max_len,bs",
                         [(3, 16, 4), (1, 5, 4), (4, 96, 16), (4, 352, 16),
                          (2, 16, 5)])
def test_default_kv_blocks_matches_reference(n_slots, max_len, bs):
    assert default_kv_blocks(n_slots, max_len, bs) == \
        j_default_kv_blocks(n_slots, max_len, bs)
    assert default_kv_blocks(3, 16, 4) == 13


@pytest.mark.parametrize("args", [(1, 4), (6, 0)])
def test_block_pool_rejects_bad_sizes(args):
    for Pool in (JBlockPool, BlockPool):
        with pytest.raises(ValueError):
            Pool(*args)


# ---------------------------------------------------------------------------
# One random operation sequence, both pools, every observable equal
# ---------------------------------------------------------------------------


def _script(pool, seed: int, steps: int = 400) -> list:
    """Apply a seeded random op sequence to ``pool`` and record everything
    it returns or raises, with the pool's counters after each op.  Prompts
    draw on 3 prefixes over a 3-token vocabulary, so lookups hit, tails
    match partially and inserts dedupe."""
    rng = np.random.default_rng(seed)
    bs = pool.block_size
    held = []  # block ids this script holds a reference to
    log = []
    prefixes = [tuple(int(t) for t in rng.integers(1, 4, 12))
                for _ in range(3)]
    for _ in range(steps):
        op = rng.choice(["alloc", "incref", "decref", "release", "lookup",
                         "insert", "ensure", "resident", "drain"],
                        p=[.2, .05, .1, .1, .2, .2, .08, .05, .02])
        try:
            if op == "alloc":
                got = pool.alloc(int(rng.integers(1, 4)))
                held += got
                out = got
            elif op in ("incref", "decref") and held:
                bid = held[int(rng.integers(len(held)))]
                getattr(pool, op)(bid)
                if op == "incref":
                    held.append(bid)
                else:
                    held.remove(bid)
                out = bid
            elif op == "release" and held:
                k = int(rng.integers(1, len(held) + 1))
                out, held = held[:k], held[k:]
                pool.release(out)
            elif op in ("lookup", "insert", "resident"):
                base = prefixes[int(rng.integers(3))]
                n = int(rng.integers(2, 13))
                toks = base[:n] + tuple(int(t) for t in rng.integers(1, 4, 3))
                if op == "lookup":
                    m = pool.lookup(toks)
                    held += m.block_ids
                    if m.tail_donor is not None:
                        held.append(m.tail_donor)
                    out = (m.block_ids, m.tail_donor, m.tail_len,
                           m.hit_tokens(bs))
                elif op == "resident":
                    out = pool.resident_prefix_tokens(toks)
                else:
                    need = len(toks) // bs
                    live = [b for b in held if pool.refcount(b) > 0]
                    if len(live) < need:
                        continue
                    out = pool.insert(toks, live[:need])
                    for _, old, new in out:
                        held.remove(old)
                        held.append(new)
            elif op == "ensure":
                out = pool.ensure(int(rng.integers(1, 6)))
            elif op == "drain":
                pool.drain()
                held = []
                out = None
            else:
                continue
        except RuntimeError as e:
            out = ("raised", str(e).split(":")[0])
        log.append((str(op), out, pool.free_blocks, pool.used_blocks,
                    pool.trie_blocks, pool.evictions,
                    [pool.refcount(b) for b in range(pool.n_blocks)]))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequence_matches_reference(seed):
    want = _script(JBlockPool(10, 3), seed)
    got = _script(BlockPool(10, 3), seed)
    assert len(got) == len(want) > 300
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"op {i}: port {g} != reference {w}"
    assert any(entry[0] == "insert" and entry[1] for entry in got), \
        "the sequence made no dedupe swap"
    assert any(entry[0] == "lookup" and entry[1][1] is not None
               for entry in got), "the sequence made no tail match"


# ---------------------------------------------------------------------------
# serve_prefix, the tenth decision site
# ---------------------------------------------------------------------------

BIG = dict(cow_blocks=0, chunk=512, block_size=16, flops_per_token=2e10,
           weight_bytes=1e10)
TOY = dict(cow_blocks=1, chunk=8, block_size=4, flops_per_token=2e5,
           weight_bytes=1e5)


@pytest.mark.parametrize("prompt,hit,kw,override,value", [
    (1024, 512, BIG, None, 512),          # reuse wins at scale
    (1024, 0, BIG, None, 0),              # nothing to reuse
    (8, 6, TOY, None, 0),                 # a CoW page outweighs 6 tokens
    (8, 6, TOY, "use_prefix", 6),         # the override pins reuse on
    (1024, 512, BIG, "full_prefill", 0),  # ... or off
])
def test_serve_prefix_site_matches_reference(prompt, hit, kw, override,
                                             value):
    port = CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))
    ref = JCostEngine(hw=V5E)
    got = port.decide_serve_prefix(prompt, hit_tokens=hit, override=override,
                                   **kw)
    want = ref.decide_serve_prefix(prompt, hit_tokens=hit, override=override,
                                   **kw)
    assert (got.choice, got.value) == (want.choice, want.value)
    assert got.value == value
    assert got.predicted.total == pytest.approx(want.predicted.total,
                                                rel=1e-9)
    (row,) = [e for e in port.ledger.entries if e.site == "serve_prefix"]
    assert row.choice == got.choice and row.predicted_s >= 0


# ---------------------------------------------------------------------------
# Runtime helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("share,plen", [(1.0, 264), (0.5, 6), (0.25, 1)])
def test_prefix_trace_matches_reference(share, plen):
    kw = dict(prompt_len=320 if plen == 264 else 8, max_new=4,
              vocab_size=32000, arrival="all", seed=3,
              prefix_share=share, prefix_len=plen)
    got = synthetic_trace(8, **kw)
    want = j_synthetic_trace(8, **kw)
    for g, w in zip(got, want):
        assert g.rid == w.rid and g.arrival_s == w.arrival_s
        np.testing.assert_array_equal(np.asarray(g.prompt),
                                      np.asarray(w.prompt))
    shared = int(round(share * 8))
    heads = {tuple(np.asarray(r.prompt)[:plen]) for r in got[:shared]}
    assert len(heads) == 1


@pytest.mark.parametrize("share,plen", [(1.5, 4), (0.5, 0), (0.5, 8)])
def test_prefix_trace_rejects_what_reference_rejects(share, plen):
    kw = dict(prompt_len=8, max_new=4, vocab_size=256, prefix_share=share,
              prefix_len=plen)
    with pytest.raises(ValueError):
        j_synthetic_trace(4, **kw)
    with pytest.raises(ValueError):
        synthetic_trace(4, **kw)


def test_runtime_config_from_env():
    cfg = RuntimeConfig.from_env({"REPRO_CALIBRATE": "1",
                                  "REPRO_COST_CACHE": "/tmp/cache",
                                  "REPRO_AUTOTUNE": "1"})
    assert cfg.calibrate is True and cfg.cache_dir == Path("/tmp/cache")
    assert cfg.device is None
    assert RuntimeConfig.from_env({}) == RuntimeConfig()
    over = RuntimeConfig.from_env({"REPRO_CALIBRATE": "1"}, calibrate=False,
                                  device="cpu")
    assert over == dataclasses.replace(RuntimeConfig(), device="cpu")
    assert RuntimeConfig.from_env({"REPRO_CALIBRATE": "0"}).calibrate is False


def test_default_runtime_is_settable():
    import repro_torch
    from repro_torch.runtime import Runtime

    rt = Runtime(device="cpu")
    repro_torch.set_default_runtime(rt)
    try:
        assert repro_torch.default_runtime() is rt
    finally:
        repro_torch.set_default_runtime(None)


# ---------------------------------------------------------------------------
# TokenStream
# ---------------------------------------------------------------------------


def test_token_stream_bursts_and_terminal():
    s = TokenStream()
    s.publish("a", (), done=False, t=0.1)
    s.publish("a", (5,), done=False, t=0.2)
    s.publish("b", (7, 8), done=True, t=0.3)
    s.publish("a", (6, 9), done=True, t=0.4)
    s.publish("a", (1,), done=False, t=0.5)  # after done: ignored
    assert s.tokens("a") == [5, 6, 9] and s.tokens("b") == [7, 8]
    assert s.is_done("a") and s.is_done("b") and not s.is_done("c")
    assert s.first_token_s("a") == 0.2 and s.first_token_s("c") is None
    assert [ev.tokens for ev in s.events("a")] == [(), (5,), (6, 9)]
    assert s.published_events == 4 and s.published_tokens == 5
    assert sorted(s.rids()) == ["a", "b"]
