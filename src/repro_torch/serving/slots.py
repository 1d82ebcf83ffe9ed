"""Slot-pooled decode-state manager for continuous batching.

The pool owns ONE device-resident decode state sized for ``n_slots``
concurrent requests, with a per-slot cache position.  Requests borrow a slot
for their lifetime:

    acquire() -> slot          take the lowest free slot (deterministic)
    release(slot)              zero the slot and return it to the free list

The engine prefills admitted groups straight into the pooled state; release
zeroes a slot's tensors in place (the reference donates the buffers to a
jitted program instead).  Occupancy and per-slot positions
are HOST MIRRORS kept by acquire/release/``advance``: reading them never
synchronizes with the device.

``block_size`` switches full-attention KV storage to a PAGED pool: one
shared set of pages per attention layer, a reference-counted
``BlockPool`` over them with a radix prefix trie (``serving/paging.py``),
and per-slot block tables kept as a host mirror.  The tables go to the
device once per dispatch, copied from pinned memory without waiting for
the device; copy-on-write duplicates a page on the device, also without a
host sync.

On a serve mesh (``ctx``, tensor-parallel) the state is one tree a
position, placed by ``serve_state_sharding``: caches and page pools split
over kv heads where they divide; elsewhere a dense ``attn`` cache splits
along its length (the engine's context carries that length, ``kv_len``)
and page pools, ring buffers and the encoder-decoder's caches stay whole;
each replicated leaf in storage of its own (it is written in place).  Slot bookkeeping and the block tables stay
on the host, shared by every position; a reset or a copy-on-write runs on
every position, as that position's work.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import (place_tree,
                                              serve_state_sharding)
from repro_torch.models.model import AnyModel, is_page_pool
from repro_torch.serving.paging import BlockPool, default_kv_blocks
from repro_torch.tree import leaves_with_paths


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A fresh device copy of ``host``.  To a card it goes from pinned
    memory without waiting for the device: the pinned copy is not reused
    before the transfer has run, so ``host`` may change at once."""
    t = torch.from_numpy(host)
    if device.type == "cpu":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


class SlotPool:
    def __init__(self, model: AnyModel, n_slots: int, max_len: int,
                 block_size: Optional[int] = None,
                 kv_blocks: Optional[int] = None, ctx=None):
        """``block_size`` pages the attention KV: ``kv_blocks`` shared pages
        (default: enough that every slot can run to ``max_len``, so
        allocation never fails) addressed by per-slot block tables.
        ``ctx`` (tensor-parallel) places the state on its mesh."""
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.paged = block_size is not None
        paging = None
        self.blocks: Optional[BlockPool] = None
        if self.paged:
            if kv_blocks is None:
                kv_blocks = default_kv_blocks(n_slots, max_len, block_size)
            self.block_size = int(block_size)
            self.max_blocks = math.ceil(max_len / self.block_size)
            self.blocks = BlockPool(kv_blocks, self.block_size)
            # host mirror of the per-slot block tables; entry 0 = null block
            self._table = np.zeros((n_slots, self.max_blocks), np.int64)
            self._slot_nblocks = np.zeros((n_slots,), np.int64)
            paging = (kv_blocks, self.block_size)
        self.ctx = ctx if ctx is not None and ctx.tp > 1 else None
        self._paging = paging
        self.state = self._new_state()
        self._free: List[int] = list(range(n_slots))
        self._owner: List[Optional[object]] = [None] * n_slots
        self._active = np.zeros((n_slots,), bool)
        self._host_pos = np.zeros((n_slots,), np.int64)
        self.dispatch_count = 0  # slot resets and page copies issued

    def _new_state(self):
        """A fresh pooled state, on the mesh's positions where there is
        one."""
        state = self.model.init_decode_state(
            self.n_slots, self.max_len, per_slot=True, paging=self._paging)
        if self.ctx is None:
            return state
        mesh = self.ctx.mesh
        return place_tree(mesh, state, serve_state_sharding(
            state, mesh, model_axis=self.ctx.model_axis, cfg=self.model.cfg),
            copy=True)

    def _each(self, fn) -> None:
        """``fn(state)`` on the pooled state: on every position's, as its
        work, on a mesh."""
        if self.ctx is None:
            fn(self.state)
        else:
            self.ctx.map(fn, self.state)

    # ------------------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.n_slots - len(self._free)

    def active_slots(self) -> List[int]:
        return [i for i in range(self.n_slots) if self._owner[i] is not None]

    def active_mask(self) -> np.ndarray:
        return self._active.copy()

    def owner(self, slot: int):
        return self._owner[slot]

    # ------------------------------------------------------------------

    def acquire(self, owner) -> int:
        """Take the lowest-numbered free slot for ``owner``."""
        if not self._free:
            raise RuntimeError("slot pool exhausted")
        self._free.sort()
        slot = self._free.pop(0)
        self._owner[slot] = owner
        self._active[slot] = True
        return slot

    def release(self, slot: int) -> None:
        """Evict the slot's request: zero its decode state (position 0,
        empty caches) and return it to the free list.  Paged mode also
        drops the slot's page references (shared prefix pages survive in
        the trie; private pages return to the free list) and zeroes its
        table row."""
        if self._owner[slot] is None:
            raise ValueError(f"slot {slot} is not in use")
        mask = np.zeros((self.n_slots,), bool)
        mask[slot] = True
        self._each(lambda st: self.model.reset_decode_slots(st, mask))
        self.dispatch_count += 1
        if self.paged:
            n = int(self._slot_nblocks[slot])
            self.blocks.release(self._table[slot, :n])
            self._table[slot] = 0
            self._slot_nblocks[slot] = 0
        self._owner[slot] = None
        self._active[slot] = False
        self._host_pos[slot] = 0
        self._free.append(slot)

    def drain(self, fresh: bool = False) -> None:
        """Failure-path reset: release every slot and leave a valid, empty
        pooled state whatever the failed step left behind.  Paged mode
        reclaims the WHOLE BlockPool, trie included.

        By default the existing tensors are zeroed in place.  ``fresh=True``
        (after a step abandoned by the watchdog, ``StepFailed(abandoned=
        True)``) allocates new state with ``init_decode_state`` instead,
        page pools included: the abandoned worker thread still holds the
        old tensors and may write into them when it wakes, and it cannot
        reach the new ones.  (The reference falls back to the same fresh
        init when an abandoned program consumed its donated buffers.)"""
        if fresh:
            self.state = self._new_state()
        else:
            every = np.ones((self.n_slots,), bool)
            self._each(lambda st: self.model.reset_decode_slots(st, every))
            self.dispatch_count += 1
        if self.paged:
            self.blocks.drain()
            self._table[:] = 0
            self._slot_nblocks[:] = 0
        self._free = list(range(self.n_slots))
        self._owner = [None] * self.n_slots
        self._active[:] = False
        self._host_pos[:] = 0

    # ------------------------------------------------------------------
    # Paged block tables (host mirrors + per-dispatch device upload)
    # ------------------------------------------------------------------

    def block_tables(self) -> torch.Tensor:
        """A fresh device copy of the (n_slots, max_blocks) block-table
        mirror, uploaded without a host sync."""
        return upload(self._table, self.model.device)

    def ensure_blocks(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s table to cover ``n_tokens`` logical positions,
        allocating private pages (and LRU-evicting idle trie pages) as
        needed.  Raises RuntimeError if the pool is exhausted."""
        need = math.ceil(min(n_tokens, self.max_len) / self.block_size)
        have = int(self._slot_nblocks[slot])
        if need <= have:
            return
        fresh = self.blocks.alloc(need - have)
        self._table[slot, have:need] = fresh
        self._slot_nblocks[slot] = need

    def assign_prefix(self, slot: int, block_ids) -> None:
        """Point the (freshly acquired, empty) slot's table at pinned
        prefix-cache pages.  The caller owns the pins (one slot reference
        per page, taken by ``BlockPool.lookup``)."""
        n = len(block_ids)
        if int(self._slot_nblocks[slot]) != 0:
            raise RuntimeError(
                f"assign_prefix on slot {slot} with live blocks")
        self._table[slot, :n] = np.asarray(block_ids, np.int64)
        self._slot_nblocks[slot] = n

    def cow_block(self, slot: int, donor: int) -> int:
        """Copy-on-write: duplicate pinned page ``donor`` into a fresh
        private page appended to ``slot``'s table (one device copy per
        attention layer's pk and pv, counted as one dispatch, as the
        reference's one copy program), then release the donor pin.
        Returns the new page id."""
        (fresh,) = self.blocks.alloc(1)

        def copy(state):
            for path, leaf in leaves_with_paths(state["layers"]):
                if is_page_pool(path):
                    leaf[fresh].copy_(leaf[donor])

        self._each(copy)  # every position's pools (its kv heads)
        self.dispatch_count += 1
        idx = int(self._slot_nblocks[slot])
        self._table[slot, idx] = fresh
        self._slot_nblocks[slot] = idx + 1
        self.blocks.decref(donor)
        return fresh

    def slot_table(self, slot: int) -> np.ndarray:
        """This slot's live table entries (host mirror)."""
        return self._table[slot, : int(self._slot_nblocks[slot])].copy()

    def apply_swaps(self, slot: int, swaps) -> None:
        """Apply trie-insert dedupe swaps ((index, old, new) triples from
        ``BlockPool.insert``) to the table mirror.  ``insert`` has already
        moved the refcounts; the pages hold the same values because the
        same tokens at the same positions give the same KV bits (the
        matmul kernel, rope, rmsnorm and the softmax compute each row
        alone, whatever the batch)."""
        for idx, old, new in swaps:
            if self._table[slot, idx] != old:
                raise RuntimeError(
                    f"dedupe swap mismatch at slot {slot} block {idx}")
            self._table[slot, idx] = new

    # ------------------------------------------------------------------
    # Host position mirror (the engine advances it as tokens land)
    # ------------------------------------------------------------------

    def set_pos(self, slot: int, pos: int) -> None:
        self._host_pos[slot] = pos

    def advance(self, slot: int, n: int) -> None:
        self._host_pos[slot] += n

    def positions(self) -> np.ndarray:
        """Per-slot cache positions (host mirror — no device sync)."""
        return self._host_pos.copy()
