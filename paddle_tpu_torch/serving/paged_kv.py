"""Paged KV memory: one refcounted page pool with per-lane block tables.

The counterpart of `paddle_tpu/serving/paged_kv.py` without the prefix
tree's allocator, copy-on-write forks, host swap and page transfer
(ROADMAP Queue 1 items 7-8):

- ONE pool per layer: fixed-shape slabs `[num_pages, page_size, heads,
  head_dim]` (fp or the quantized {"q", "s"} form) hold every resident
  K/V row.
- PER-LANE BLOCK TABLES: lane `s` keeps a row of page ids
  `[pages_per_seq]`; sequence row `r` lives at
  `(table[r // page_size], r % page_size)`. The tables are a small host
  array the engine uploads with its scheduler mirrors.
- SPECULATIVE blocks (`engine._spec_decode_block`, one block for both
  layouts, as the plain decode block is) address the verify pass's
  virtual lanes through their lanes' table rows repeated once per
  position; draft and verify writes of frozen lanes, and verify rows
  past a lane's reservation, land on the trash page.
- REFCOUNTED pages (`PagePool`): a page frees when its last reference
  drops. Page 0 is a reserved TRASH page: table filler past a lane's
  bound pages, and where frozen lanes park their discarded writes (the
  paged analog of the slotted engine's row `max_seq - 1`). A retired
  lane's pages can be reallocated at once, so a frozen lane must never
  write through its old table row.

Numerics: `pages_per_seq * page_size == max_seq` is enforced, so the
masked paged attention gathers a lane's pages into exactly the
`[max_seq, heads, head_dim]` view the slotted path reads, and paged
streams are bitwise the slotted ones.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import DeviceLike
from .kv_cache import KVCacheManager

__all__ = ["NoFreePages", "PagePool", "PagedKVCache", "paged_rows"]


class NoFreePages(RuntimeError):
    """Raised by `PagePool.alloc` when the pool cannot cover a request
    (the engine's admission gate prices pages first, and requeues the
    request if this is raised anyway)."""


class PagePool:
    """Host-side refcounted allocator over `num_pages` device pages.

    Pure bookkeeping — never touches the device. A page is FREE
    (refcount 0, on the free stack) or HELD (refcount >= 1). The first
    `reserved` pages (the trash page) are pinned forever and never
    allocated. `peak_used` tracks the high-water mark.
    """

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages < reserved + 1:
            raise ValueError(f"need num_pages > reserved, got "
                             f"{num_pages} <= {reserved}")
        self.num_pages = int(num_pages)
        self.reserved = int(reserved)
        self._refs = [1] * self.reserved + [0] * (self.num_pages
                                                  - self.reserved)
        # LIFO free stack: a mostly idle pool keeps touching warm pages
        self._free: List[int] = list(range(self.num_pages - 1,
                                           self.reserved - 1, -1))
        self.peak_used = self.reserved

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int) -> List[int]:
        """Take `n` fresh pages, each with refcount 1; raises
        `NoFreePages` when the pool cannot cover it (nothing blocks)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise NoFreePages(
                f"need {n} pages, {len(self._free)} free of "
                f"{self.num_pages} ({self.pages_used} held)")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        self.peak_used = max(self.peak_used, self.pages_used)
        return out

    def ref(self, page: int):
        """Add a reference to a HELD page (sharing). Refing a free page
        is a bug."""
        if self._refs[page] < 1:
            raise ValueError(f"ref of free page {page}")
        self._refs[page] += 1

    def unref(self, page: int):
        """Drop one reference; the page frees at zero."""
        if self._refs[page] < 1 or page < self.reserved:
            raise ValueError(f"unref of free or reserved page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)

    def leaked(self) -> int:
        """Held pages beyond the reserved set: 0 once every request has
        retired."""
        return self.pages_used - self.reserved


class PagedKVCache(KVCacheManager):
    """Slot/lane bookkeeping of `KVCacheManager` over one paged pool:
    per-layer slabs `[num_pages, page_size, heads, head_dim]` plus
    per-lane block tables. Lanes remain the decode step's fixed grid;
    a lane's rows live in refcounted pages instead of a private
    `max_seq` stripe. `bind_owned` installs pages fresh out of
    `pool.alloc`; `reset_length` and `release` drop every reference of
    the lane, and its table row returns to trash filler.
    """

    def __init__(self, num_layers: int, max_slots: int, max_seq: int,
                 num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, page_size: int = 64,
                 num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_seq % page_size != 0:
            # pages_per_seq * page_size == max_seq keeps the gathered
            # lane view the exact shape the slotted path reads: the
            # bitwise paged ≡ slotted contract needs identical
            # reduction shapes, not just identical rows
            raise ValueError(f"max_seq {max_seq} must be a multiple of "
                             f"page_size {page_size}")
        self.page_size = int(page_size)
        self.pages_per_seq = max_seq // self.page_size
        if num_pages is None:
            # every lane at full span, as much again, and the trash page
            num_pages = 2 * max_slots * self.pages_per_seq + 1
        if num_pages < self.pages_per_seq + 1:
            raise ValueError(f"num_pages {num_pages} cannot hold even "
                             f"one sequence ({self.pages_per_seq} "
                             f"pages) beside the trash page")
        self.num_pages = int(num_pages)
        super().__init__(num_layers, max_slots, max_seq, num_heads,
                         head_dim, dtype, device, kv_dtype=kv_dtype)
        self.pool = PagePool(self.num_pages, reserved=1)
        self.block_tables = np.zeros((max_slots, self.pages_per_seq),
                                     np.int32)
        self._lane_pages: List[List[int]] = [[] for _ in
                                             range(max_slots)]

    def _alloc_slabs(self):
        shape = (self.num_pages, self.page_size, self.num_heads,
                 self.head_dim)
        self.k = [self._new_slab(shape) for _ in range(self.num_layers)]
        self.v = [self._new_slab(shape) for _ in range(self.num_layers)]

    # --- page bookkeeping -------------------------------------------------- #
    def span_pages(self, rows: int) -> int:
        """Pages covering `rows` sequence rows."""
        return -(-int(rows) // self.page_size)

    def lane_pages(self, slot: int) -> List[int]:
        return list(self._lane_pages[slot])

    def lane_page_count(self, slot: int) -> int:
        return len(self._lane_pages[slot])

    def bind_owned(self, slot: int, pages: Sequence[int]):
        """Install pages fresh out of `pool.alloc` (refcount already 1:
        the lane is the holder); the lane's table row extends."""
        lane = self._lane_pages[slot]
        start = len(lane)
        if start + len(pages) > self.pages_per_seq:
            raise ValueError(f"slot {slot}: {start}+{len(pages)} pages "
                             f"exceed pages_per_seq {self.pages_per_seq}")
        lane.extend(int(p) for p in pages)
        self.block_tables[slot, start:start + len(pages)] = \
            np.asarray(pages, np.int32)

    def clear_lane_pages(self, slot: int):
        """Drop every page reference of the lane and reset its table row
        to trash filler."""
        for p in self._lane_pages[slot]:
            self.pool.unref(p)
        self._lane_pages[slot] = []
        self.block_tables[slot, :] = 0

    # --- KVCacheManager overrides ------------------------------------------ #
    def reset_length(self, slot: int):
        super().reset_length(slot)
        self.clear_lane_pages(slot)

    def release(self, slot: int):
        super().release(slot)
        self.clear_lane_pages(slot)

    def bytes_per_token(self) -> float:
        return self.nbytes() / (self.num_pages * self.page_size)


def paged_rows(tables: torch.Tensor, pos: torch.Tensor,
               page_size: int, live: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (page id, row offset) index of sequence rows `pos` through
    block tables: `tables` (n, pages_per_seq) with `pos` (n,) — one row
    per lane, the decode write — or one table row (pages_per_seq,) with
    `pos` (L,) — a prefill. Where `live` is False the row goes to the
    trash page 0 instead: a frozen lane parks its discarded write."""
    if tables.dim() == 1:
        pids = tables[pos // page_size]
    else:
        pids = tables.gather(1, (pos // page_size)[:, None])[:, 0]
    if live is not None:
        pids = torch.where(live, pids, 0)
    return pids.long(), pos % page_size

