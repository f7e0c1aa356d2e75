"""Slotted KV cache: preallocated per-layer slabs + a host slot allocator.

The counterpart of `paddle_tpu/serving/kv_cache.py`. Per-layer K and V
slabs `[max_slots, max_seq, heads, head_dim]` live on the device and
are written IN PLACE by the engine's prefill and decode steps (the JAX
manager swaps in the arrays each jitted step returns, donating the old
ones). Beside them, the PREFIX POOL of the automatic prefix cache:
per-layer `[pool_pages, prefix_block, heads, head_dim]` slabs whose
pages hold cached prompt-prefix rows (`serving/prefix_cache.py` hands
out the page ids); `copy_pool_to_slot` and `copy_slot_to_pool` move
rows between the two with index copies, in place. `kv_dtype` picks the
slabs' storage independently of the compute dtype: "int8" makes every
slab, the pool's included, the quantized `{"q": int8, "s": f32}` form
of `quantization/kv.py`, and a copy moves codes and scales verbatim.
The manager itself is host bookkeeping: a LIFO free list of slot ids
and per-slot lengths — allocation never touches the device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..core import DeviceLike, resolve_device, resolve_dtype
from ..quantization.kv import (make_slab, normalize_kv_dtype,
                               slab_leaves, slab_nbytes)

__all__ = ["KVCacheManager", "NoFreeSlot"]


class NoFreeSlot(RuntimeError):
    """Raised by `allocate()` when every slot is occupied."""


class KVCacheManager:
    """Fixed-shape per-layer K/V slabs plus a slot free-list. Slot ids
    are stable for a sequence's lifetime — `allocate()` pins one,
    `release()` recycles it (LIFO, so a mostly idle engine keeps
    touching the same warm slots)."""

    def __init__(self, num_layers: int, max_slots: int, max_seq: int,
                 num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 kv_dtype: Optional[str] = None,
                 prefix_pool_pages: int = 0, prefix_block: int = 64):
        if max_slots < 1 or max_seq < 1:
            raise ValueError(f"need max_slots >= 1 and max_seq >= 1, got "
                             f"{max_slots}, {max_seq}")
        if prefix_pool_pages < 0 or prefix_block < 1:
            raise ValueError(f"need prefix_pool_pages >= 0 and "
                             f"prefix_block >= 1, got "
                             f"{prefix_pool_pages}, {prefix_block}")
        self.num_layers = num_layers
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.device = resolve_device(device)
        self.kv_dtype = normalize_kv_dtype(kv_dtype, dtype)
        self.quantized = self.kv_dtype == "int8"
        self.slab_dtype = dtype if self.quantized \
            else resolve_dtype(self.kv_dtype)
        # 0 pages = no prefix cache, and no pool memory at all
        self.prefix_pool_pages = int(prefix_pool_pages)
        self.prefix_block = int(prefix_block)
        self._alloc_slabs()
        self.reallocate_pool()
        self._free: List[int] = list(range(max_slots - 1, -1, -1))
        self._lengths: List[int] = [0] * max_slots

    def _new_slab(self, shape):
        """One zeroed per-layer slab in the configured kv_dtype (a plain
        tensor, or the quantized {"q", "s"} pair): the seam through
        which `_alloc_slabs` and `reallocate_pool` make every slab, and
        which the TP-sharded managers override (`sharded_kv.py`)."""
        return make_slab(shape, self.slab_dtype, self.quantized,
                         self.device)

    def _alloc_slabs(self):
        shape = (self.max_slots, self.max_seq, self.num_heads,
                 self.head_dim)
        self.k = [self._new_slab(shape) for _ in range(self.num_layers)]
        self.v = [self._new_slab(shape) for _ in range(self.num_layers)]

    # --- slot bookkeeping (host-side, O(1)) ------------------------------- #
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return self.max_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.num_active / self.max_slots

    def allocate(self, slot: Optional[int] = None) -> int:
        """Pin a free slot; raises `NoFreeSlot` under full occupancy (the
        engine checks `num_free` first, so hitting this is a bug).
        `slot` pins that SPECIFIC slot: resume puts each request back
        into the lane it held, so the free stack, and with it the lane
        each later request lands in, is the uninterrupted run's."""
        if not self._free:
            raise NoFreeSlot(f"all {self.max_slots} KV slots occupied")
        if slot is None:
            slot = self._free.pop()
        else:
            if slot not in self._free:
                raise ValueError(f"slot {slot} not free (free: "
                                 f"{sorted(self._free)})")
            self._free.remove(slot)
        self._lengths[slot] = 0
        return slot

    def reset_length(self, slot: int):
        """Zero a LIVE slot's length without releasing it: an admission
        attempt starts over from row 0 (rows a failed attempt left are
        simply rewritten)."""
        if slot in self._free or not 0 <= slot < self.max_slots:
            raise ValueError(f"reset_length of unallocated slot {slot}")
        self._lengths[slot] = 0

    def release(self, slot: int):
        """Recycle a slot. Its slab rows keep their stale K/V: the next
        occupant's prefill overwrites rows as it claims them, and the
        per-slot length mask keeps the stale tail unread. Row
        `max_seq - 1` is the frozen-lane PARK row (never attendable:
        live lanes cap at `max_seq - 2`)."""
        if slot in self._free or not 0 <= slot < self.max_slots:
            raise ValueError(f"release of unallocated slot {slot}")
        self._lengths[slot] = 0
        self._free.append(slot)

    def free_slots(self) -> List[int]:
        """The free stack, bottom to top (`allocate()` pops the end):
        what a snapshot records, since the pop order decides which lane
        each queued request lands in."""
        return list(self._free)

    def restore_free_order(self, order: Sequence[int]):
        """Reorder the free stack to `order` (bottom to top). Slots in
        `order` that are no longer free are skipped; free slots not in
        it sink to the bottom."""
        cur = set(self._free)
        ordered = [int(s) for s in order if int(s) in cur]
        keep = set(ordered)
        self._free = [s for s in self._free if s not in keep] + ordered

    def length(self, slot: int) -> int:
        return self._lengths[slot]

    def advance(self, slot: int, n: int = 1):
        new = self._lengths[slot] + n
        if new > self.max_seq:
            raise ValueError(f"slot {slot}: length {new} exceeds max_seq "
                             f"{self.max_seq}")
        self._lengths[slot] = new

    # --- the prefix pool --------------------------------------------------- #
    def reallocate_pool(self):
        """Create zeroed prefix-pool slabs, none when the pool has 0
        pages. The reference rebuilds its pool after a failed insert
        consumed the donated slabs; the port writes the pool in place,
        and a failed insert touched only pages the tree rolled back, so
        only construction calls this."""
        shape = (self.prefix_pool_pages, self.prefix_block,
                 self.num_heads, self.head_dim)
        n = self.num_layers if self.prefix_pool_pages else 0
        self.pool_k = [self._new_slab(shape) for _ in range(n)]
        self.pool_v = [self._new_slab(shape) for _ in range(n)]

    def copy_pool_to_slot(self, pages: Sequence[int], slot: int):
        """A prefix-cache HIT: the rows of pool `pages` become rows
        [0, len(pages) * prefix_block) of `slot`, in every layer (codes
        and scales alike for int8 slabs: no requantization)."""
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=self.device)
        n = len(pages) * self.prefix_block
        for dst, src in zip(self.k + self.v, self.pool_k + self.pool_v):
            for d, s_ in zip(slab_leaves(dst), slab_leaves(src)):
                d[slot, :n] = s_[idx].reshape((n,) + tuple(s_.shape[2:]))

    def copy_slot_to_pool(self, slot: int, chunk0: int,
                          pages: Sequence[int]):
        """A prefix-cache INSERT: the slot's chunks chunk0, chunk0 + 1,
        ... (rows of `prefix_block` each) become pool `pages`, in every
        layer."""
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=self.device)
        B = self.prefix_block
        r0, r1 = chunk0 * B, (chunk0 + len(pages)) * B
        for src, dst in zip(self.k + self.v, self.pool_k + self.pool_v):
            for s_, d in zip(slab_leaves(src), slab_leaves(dst)):
                d.index_copy_(0, idx, s_[slot, r0:r1].reshape(
                    (len(pages), B) + tuple(s_.shape[2:])))

    # --- footprint ---------------------------------------------------------- #
    def nbytes(self) -> int:
        """Total preallocated slab bytes (all layers, K+V, scales
        included, the prefix pool's too) — a constant per
        configuration."""
        return sum(slab_nbytes(a)
                   for a in self.k + self.v + self.pool_k + self.pool_v)

    def pool_nbytes(self) -> int:
        """The prefix pool's share of `nbytes()`: what the prefix cache
        costs in memory."""
        return sum(slab_nbytes(a) for a in self.pool_k + self.pool_v)

    def bytes_per_token(self) -> float:
        """K+V slab bytes per cache row (all layers; scales included
        for quantized slabs; the prefix pool excluded) — the
        `kv_bytes_per_token` gauge."""
        return sum(slab_nbytes(a) for a in self.k + self.v) \
            / (self.max_slots * self.max_seq)
