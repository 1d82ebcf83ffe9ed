"""Slot-pooled decode-state manager for continuous batching (dense KV).

The pool owns ONE device-resident decode state sized for ``n_slots``
concurrent requests, with a per-slot cache position.  Requests borrow a slot
for their lifetime:

    acquire() -> slot          take the lowest free slot (deterministic)
    release(slot)              zero the slot and return it to the free list

The engine prefills admitted groups straight into the pooled state; release
zeroes a slot's tensors in place (the reference donates the buffers to a
jitted program instead).  Occupancy and per-slot positions
are HOST MIRRORS kept by acquire/release/``advance``: reading them never
synchronizes with the device.  Paged KV and the prefix cache come with a
later slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.models.model import Model


class SlotPool:
    def __init__(self, model: Model, n_slots: int, max_len: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.state = model.init_decode_state(n_slots, max_len, per_slot=True)
        self._free: List[int] = list(range(n_slots))
        self._owner: List[Optional[object]] = [None] * n_slots
        self._active = np.zeros((n_slots,), bool)
        self._host_pos = np.zeros((n_slots,), np.int64)
        self.dispatch_count = 0  # slot resets issued

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
        empty caches) and return it to the free list."""
        if self._owner[slot] is None:
            raise ValueError(f"slot {slot} is not in use")
        mask = np.zeros((self.n_slots,), bool)
        mask[slot] = True
        self.model.reset_decode_slots(self.state, mask)
        self.dispatch_count += 1
        self._owner[slot] = None
        self._active[slot] = False
        self._host_pos[slot] = 0
        self._free.append(slot)

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
