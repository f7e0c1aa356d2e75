"""Slotted KV cache: preallocated per-layer slabs + a host slot allocator.

The counterpart of `paddle_tpu/serving/kv_cache.py` without the prefix
pool. Per-layer K and V slabs `[max_slots, max_seq, heads, head_dim]`
live on the device and are written IN PLACE by the engine's prefill and
decode steps (the JAX manager swaps in the arrays each jitted step
returns, donating the old ones). `kv_dtype` picks the slabs' storage
independently of the compute dtype: "int8" makes every slab the
quantized `{"q": int8, "s": f32}` form of `quantization/kv.py`. The
manager itself is host bookkeeping: a LIFO free list of slot ids and
per-slot lengths — allocation never touches the device.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core import DeviceLike, resolve_device, resolve_dtype
from ..quantization.kv import make_slab, normalize_kv_dtype, slab_nbytes

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
                 kv_dtype: Optional[str] = None):
        if max_slots < 1 or max_seq < 1:
            raise ValueError(f"need max_slots >= 1 and max_seq >= 1, got "
                             f"{max_slots}, {max_seq}")
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
        self._alloc_slabs()
        self._free: List[int] = list(range(max_slots - 1, -1, -1))
        self._lengths: List[int] = [0] * max_slots

    def _new_slab(self, shape):
        """One zeroed per-layer slab in the configured kv_dtype (a plain
        tensor, or the quantized {"q", "s"} pair)."""
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

    def allocate(self) -> int:
        """Pin a free slot; raises `NoFreeSlot` under full occupancy (the
        engine checks `num_free` first, so hitting this is a bug)."""
        if not self._free:
            raise NoFreeSlot(f"all {self.max_slots} KV slots occupied")
        slot = self._free.pop()
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

    def length(self, slot: int) -> int:
        return self._lengths[slot]

    def advance(self, slot: int, n: int = 1):
        new = self._lengths[slot] + n
        if new > self.max_seq:
            raise ValueError(f"slot {slot}: length {new} exceeds max_seq "
                             f"{self.max_seq}")
        self._lengths[slot] = new

    # --- footprint ---------------------------------------------------------- #
    def nbytes(self) -> int:
        """Total preallocated slab bytes (all layers, K+V, scales
        included) — a constant per configuration."""
        return sum(slab_nbytes(a) for a in self.k + self.v)

    def bytes_per_token(self) -> float:
        """K+V slab bytes per cache row (all layers; scales included
        for quantized slabs) — the `kv_bytes_per_token` gauge."""
        return self.nbytes() / (self.max_slots * self.max_seq)
