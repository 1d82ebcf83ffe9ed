"""Paged KV-cache bookkeeping: a reference-counted BlockPool of fixed-size
cache pages plus a radix-style prefix cache over full blocks.

All state here is HOST-side (Python lists and dicts): the physical pages
live in the pooled decode state as ``pk``/``pv`` leaves of shape
``(n_blocks, block_size, kv_heads, head_dim)`` per attention layer, and the
per-slot block tables are handed to the prefill and macro-step programs as
device tensors of block indices.  Nothing in this module touches a device
or triggers a host sync.  It is the port's own copy of the reference's
``serving/paging.py``, with the same conventions.

Conventions (load-bearing for token identity):

* **Block 0 is the null block** — never allocated, permanently pinned.
  Unallocated block-table entries are 0, so any out-of-range or inactive
  write self-redirects into garbage storage and any read of an unwritten
  position is masked by the attention length limit (exp of ``NEG_INF``
  underflows to exactly 0.0 in fp32, and stale KV is always finite).
* **Only full blocks are shared.**  The radix trie keys nodes by the exact
  ``block_size``-token tuple they cache.  A partial-tail match (the next
  tokens are a proper prefix of a stored child's key) is served by EAGER
  copy-on-write at admission: the donor is pinned, duplicated into a fresh
  private block by the SlotPool's page copy, and released — so
  no decode or prefill write ever lands in a shared block.
* **refcount = slot users + (1 if the block is a trie node).**  Eviction
  (when the free list runs dry) walks refcount-1 trie LEAVES in LRU order;
  interior nodes and blocks any slot still uses are never evicted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class PrefixMatch:
    """Result of a radix lookup at admission.

    ``block_ids`` are full-block hits, already pinned (one reference each,
    owned by the admitting slot once it writes them into its table).
    ``tail_donor`` (if not None) is a pinned block whose first
    ``tail_len`` tokens extend the match; the caller must copy-on-write it
    into a private block and then ``decref`` the donor.  Total matched
    tokens = ``len(block_ids) * block_size + tail_len``.
    """

    block_ids: List[int]
    tail_donor: Optional[int]
    tail_len: int

    def hit_tokens(self, block_size: int) -> int:
        return len(self.block_ids) * block_size + self.tail_len


class _TrieNode:
    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_TrieNode"]):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], _TrieNode] = {}
        self.parent = parent
        self.last_used = 0


class BlockPool:
    """Reference-counted pool of ``n_blocks`` KV pages of ``block_size``
    tokens each, with a radix prefix trie over full blocks.

    Purely host-side bookkeeping; the caller owns the device pages and the
    block-table mirrors.  Block 0 is reserved as the null/garbage block.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(f"n_blocks must be >= 2 (got {n_blocks}): "
                             "block 0 is the reserved null block")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1 (got {block_size})")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._ref = [0] * self.n_blocks
        self._ref[0] = 1  # null block: permanently pinned, never freed
        # pop() yields low ids first — keeps tables dense and debuggable
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._root = _TrieNode((), 0, None)
        self._by_block: Dict[int, _TrieNode] = {}
        self._clock = 0
        self.evictions = 0

    # ------------------------------------------------------------- pool --
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Allocated (non-null) blocks, including trie-only residents."""
        return self.n_blocks - 1 - len(self._free)

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def incref(self, bid: int) -> None:
        if bid == 0:
            return
        if self._ref[bid] <= 0:
            raise RuntimeError(f"incref on free block {bid}")
        self._ref[bid] += 1

    def decref(self, bid: int) -> None:
        if bid == 0:
            return
        r = self._ref[bid]
        if r <= 0:
            raise RuntimeError(f"decref on free block {bid}")
        self._ref[bid] = r - 1
        if r == 1:
            self._free.append(bid)

    def ensure(self, n: int) -> bool:
        """Make at least ``n`` blocks allocatable, evicting LRU trie-only
        leaves as needed.  Returns False if the demand cannot be met."""
        while len(self._free) < n:
            if not self._evict_one():
                return False
        return True

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` private blocks (refcount 1 each).  Raises
        RuntimeError on exhaustion — callers gate with ``ensure`` first."""
        if not self.ensure(n):
            raise RuntimeError(
                f"KV BlockPool exhausted: need {n} blocks, "
                f"{len(self._free)} free of {self.n_blocks - 1} "
                f"(trie holds {len(self._by_block)} pinned)")
        out = []
        for _ in range(n):
            bid = self._free.pop()
            self._ref[bid] = 1
            out.append(bid)
        return out

    def release(self, bids: Sequence[int]) -> None:
        """Drop one slot reference from each non-null table entry."""
        for bid in bids:
            if bid != 0:
                self.decref(int(bid))

    # ------------------------------------------------------------- trie --
    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    def _evict_one(self) -> bool:
        """Evict the least-recently-used refcount-1 trie leaf."""
        victim = None
        for node in self._by_block.values():
            if node.children or self._ref[node.block] != 1:
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        del self._by_block[victim.block]
        self.decref(victim.block)  # trie ref -> 0 -> free list
        self.evictions += 1
        return True

    def lookup(self, tokens: Sequence[int]) -> PrefixMatch:
        """Walk the trie over ``tokens`` (a full prompt).  Matched blocks
        come back PINNED (slot ref for full blocks, a temporary ref for the
        CoW donor).  The match is capped at ``len(tokens) - 1`` so at least
        one suffix token always goes through prefill (first-token capture
        stays on the existing path)."""
        bs = self.block_size
        cap = len(tokens) - 1
        node = self._root
        full: List[int] = []
        pos = 0
        while pos + bs <= cap:
            key = tuple(int(t) for t in tokens[pos:pos + bs])
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            self.incref(child.block)
            full.append(child.block)
            node = child
            pos += bs
        # partial tail: the next tokens are a proper prefix of some child's
        # key — pick the longest usable overlap (m >= 1, pos + m <= cap)
        donor, tail_len = None, 0
        remaining = [int(t) for t in tokens[pos:cap]]
        if remaining:
            for key, child in node.children.items():
                m = 0
                for a, b in zip(remaining, key):
                    if a != b:
                        break
                    m += 1
                if m > tail_len:
                    donor, tail_len = child, m
            if donor is not None:
                self._touch(donor)
                self.incref(donor.block)
                donor = donor.block
        return PrefixMatch(block_ids=full, tail_donor=donor,
                           tail_len=tail_len)

    def resident_prefix_tokens(self, tokens: Sequence[int]) -> int:
        """Read-only trie probe: how many leading tokens of ``tokens`` are
        covered by RESIDENT full blocks right now.  Takes no pins and does
        not touch LRU clocks — admission grouping uses it to PREDICT
        whether a same-group peer's pages would be visible after a split,
        never to acquire references (that is ``lookup``'s job)."""
        bs = self.block_size
        node = self._root
        pos = 0
        while pos + bs <= len(tokens):
            key = tuple(int(t) for t in tokens[pos:pos + bs])
            child = node.children.get(key)
            if child is None:
                break
            node = child
            pos += bs
        return pos

    def insert(self, tokens: Sequence[int],
               block_ids: Sequence[int]) -> List[Tuple[int, int, int]]:
        """Publish a prefilled prompt's FULL blocks into the trie.

        ``block_ids`` is the slot's table prefix covering the prompt;
        only the first ``len(tokens) // block_size`` entries (fully valid
        blocks) are inserted.  Returns dedupe swaps as
        ``(block_index, old_bid, new_bid)`` triples: when an identical key
        already resides in the trie under a different block, the slot
        should repoint its table at the resident block (contents are
        identical under greedy determinism) — this method already moved
        the refcounts (incref resident, decref duplicate)."""
        bs = self.block_size
        node = self._root
        swaps: List[Tuple[int, int, int]] = []
        for i in range(len(tokens) // bs):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            bid = int(block_ids[i])
            child = node.children.get(key)
            if child is None:
                if self._ref[bid] <= 0:
                    raise RuntimeError(
                        f"insert of free block {bid} into prefix trie")
                child = _TrieNode(key, bid, node)
                node.children[key] = child
                self._by_block[bid] = child
                self._ref[bid] += 1  # trie reference
            elif child.block != bid:
                # dedupe: identical tokens already cached — converge on the
                # resident block and release the freshly-prefilled duplicate
                self.incref(child.block)
                self.decref(bid)
                swaps.append((i, bid, child.block))
            self._touch(child)
            node = child
        return swaps

    def drain(self) -> None:
        """Forget everything (fatal-abort / engine drain): clear the trie
        and all slot references so every non-null block returns to the
        free list.  Callers must also zero their block-table mirrors."""
        self._root = _TrieNode((), 0, None)
        self._by_block.clear()
        for bid in range(1, self.n_blocks):
            self._ref[bid] = 0
        self._free = list(range(self.n_blocks - 1, 0, -1))

    @property
    def trie_blocks(self) -> int:
        return len(self._by_block)


def default_kv_blocks(n_slots: int, max_len: int, block_size: int) -> int:
    """Pool size that can never OOM: every slot full-length simultaneously,
    plus the null block."""
    import math
    return n_slots * math.ceil(max_len / block_size) + 1
