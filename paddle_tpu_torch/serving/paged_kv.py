"""Paged KV memory: one refcounted page pool with per-lane block tables.

The counterpart of `paddle_tpu/serving/paged_kv.py`:

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
- SHARED PAGES: the prefix tree (`serving/prefix_cache.py`) allocates
  from, returns to and references pages of the same pool
  (`TreePageAllocator`). A prefix hit binds the tree's pages into the
  lane's table (`bind_shared`, one more reference each, no copy); an
  insert references the lane's freshly prefilled pages. A page frees
  when its last holder (tree or lane) lets go.
- COPY-ON-WRITE FORKS: a best-of-n sibling binds its parent's full
  prompt pages shared and owns a copy of the partial boundary page
  (`copy_page`), the one page its first decode write would change.
- PAGE TRANSFER (host swap, page handoff): `gather_pages` reads pages
  of every layer to host memory (one device buffer, one copy, one
  synchronise) and `scatter_pages` writes host rows into pages. The payload is the reference's: per layer a
  `[n, page_size, heads, head_dim]` stack, or `{"q", "s"}` under int8 —
  the pool slabs' own layout, so a JAX engine's payload uploads as it
  is. Both are eager index ops (the reference's page programs are
  jitted XLA gathers and scatters, not kernels). A TP group's pool
  (`serving/sharded_kv.py`) joins its ranks' heads into that layout on
  the way out and splits them on the way in, so a payload is the same
  bytes at every degree (the reference's "the wire format never sees
  the mesh").

Numerics: `pages_per_seq * page_size == max_seq` is enforced, so the
masked paged attention gathers a lane's pages into exactly the
`[max_seq, heads, head_dim]` view the slotted path reads, and paged
streams are bitwise the slotted ones.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import DeviceLike, host_tensor
from ..quantization.kv import (HeadShards, is_quantized, join_heads,
                               slab_data, slab_leaves, slab_parts,
                               split_heads)
from .kv_cache import KVCacheManager

__all__ = ["NoFreePages", "PagePool", "TreePageAllocator", "PagedKVCache",
           "paged_rows"]

_ALIGN = 16     # byte alignment of each leaf in a transfer buffer


def _layout(leaves) -> Tuple[List[int], int]:
    """Each leaf's byte offset in one transfer buffer (aligned), and the
    buffer's size."""
    offs, n = [], 0
    for t in leaves:
        offs.append(n)
        n += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    return offs, n


def _typed(buf: torch.Tensor, off: int, like: torch.Tensor,
           shape) -> torch.Tensor:
    """The view of `buf` (uint8) at byte `off` with `like`'s dtype and
    `shape`."""
    nbytes = int(np.prod(shape)) * like.element_size()
    return buf[off:off + nbytes].view(like.dtype).view(*shape)


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


class TreePageAllocator:
    """The `PrefixCache` side of the one pool: the tree allocates from,
    returns to and references pages of the same `PagePool` the block
    tables use."""

    def __init__(self, pool: PagePool):
        self.pool = pool

    def take(self) -> Optional[int]:
        """One fresh page for a tree insert, or None under pressure
        (the tree then evicts, or drops the tail of the insert)."""
        try:
            return self.pool.alloc(1)[0]
        except NoFreePages:
            return None

    def give(self, page: int):
        """Return a tree-held page (eviction, clear, rollback); it frees
        only when no block table still references it."""
        self.pool.unref(page)

    def adopt(self, page: int):
        """Reference an existing page into the tree (a paged insert
        shares the freshly prefilled page, never copies it)."""
        self.pool.ref(page)

    def free_pages(self) -> int:
        return self.pool.num_free


class PagedKVCache(KVCacheManager):
    """Slot/lane bookkeeping of `KVCacheManager` over one paged pool:
    per-layer slabs `[num_pages, page_size, heads, head_dim]` plus
    per-lane block tables. Lanes remain the decode step's fixed grid;
    a lane's rows live in refcounted pages instead of a private
    `max_seq` stripe. `bind_shared` references pages someone else holds
    (a prefix hit), `bind_owned` installs pages fresh out of
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

    def lane_page(self, slot: int, idx: int) -> int:
        return self._lane_pages[slot][idx]

    def lane_page_count(self, slot: int) -> int:
        return len(self._lane_pages[slot])

    def bind_shared(self, slot: int, pages: Sequence[int]):
        """Reference pages someone else holds into the lane (a prefix
        hit): each gains a reference; the table row extends."""
        self.bind_owned(slot, pages)
        for p in pages:
            self.pool.ref(p)

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

    def copy_page(self, src: int, dst: int):
        """Copy pool page `src`'s rows into page `dst`, in every layer
        (codes and scales alike for int8 slabs): one index copy per
        slab, eager, as the prefix copies are."""
        idx_s = torch.tensor([src], dtype=torch.long, device=self.device)
        idx_d = torch.tensor([dst], dtype=torch.long, device=self.device)
        for slab in self.k + self.v:
            for t in slab_leaves(slab):
                t.index_copy_(0, idx_d, t.index_select(0, idx_s))

    # --- KVCacheManager overrides ------------------------------------------ #
    def reset_length(self, slot: int):
        super().reset_length(slot)
        self.clear_lane_pages(slot)

    def release(self, slot: int):
        super().release(slot)
        self.clear_lane_pages(slot)

    def bytes_per_token(self) -> float:
        return self.nbytes() / (self.num_pages * self.page_size)

    # --- page transfer (host swap, page handoff) ---------------------------- #
    def page_nbytes(self) -> int:
        """Bytes of one page across every layer, K and V (scales
        included): what a transfer moves per page."""
        return self.nbytes() // self.num_pages

    def gather_pages(self, pages: Sequence[int]):
        """Read `pages` of every layer to host memory: each slab's rows
        (both leaves of an int8 slab) are gathered into ONE device
        buffer, which goes to pinned host memory in ONE copy behind ONE
        synchronise (the caller books it as a swap host sync). Returns
        (k, v): per layer a CPU `[n, page_size, heads, head_dim]` tensor,
        or {"q", "s"} under int8, views of that one host buffer."""
        idx = torch.tensor(list(pages), dtype=torch.long,
                           device=self.device)
        n = len(pages)
        slabs = self.k + self.v
        leaves = [t for slab in slabs for t in slab_leaves(slab)]
        offs, size = _layout(t[:n] for t in leaves)
        dev = torch.empty(size, dtype=torch.uint8, device=self.device)
        for t, off in zip(leaves, offs):
            torch.index_select(t, 0, idx, out=_typed(
                dev, off, t, (n, *t.shape[1:])))
        cuda = self.device.type == "cuda"
        host = torch.empty(size, dtype=torch.uint8, pin_memory=cuda)
        host.copy_(dev, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        views = iter(_typed(host, off, t, (n, *t.shape[1:]))
                     for t, off in zip(leaves, offs))
        # a TP group's ranks' rows joined by heads (a copy); one rank's
        # rows are views of the host buffer
        rows = [join_heads([{"q": next(views), "s": next(views)}
                            if is_quantized(p) else next(views)
                            for p in slab_parts(slab)]) for slab in slabs]
        L = self.num_layers
        return rows[:L], rows[L:]

    def scatter_pages(self, pages: Sequence[int], k_rows, v_rows):
        """Write host row stacks (`gather_pages`' layout, torch or numpy
        leaves) into `pages` of every layer: one upload and one index
        copy per slab leaf (a leaf in pinned memory, as `gather_pages`
        returns them, uploads asynchronously). The payload's structure
        must match the pool's (int8 {"q", "s"} or fp stacks), and each
        leaf's shape `[len(pages), ...]` and dtype the pool's rows';
        raises otherwise, before anything is written."""
        n = len(pages)
        slabs = self.k + self.v
        if len(k_rows) != self.num_layers or len(v_rows) != self.num_layers:
            raise ValueError(f"payload has {len(k_rows)}/{len(v_rows)} "
                             f"layers, the pool {self.num_layers}")
        pairs = []
        for slab, rows in zip(slabs, list(k_rows) + list(v_rows)):
            if isinstance(rows, dict) != is_quantized(slab):
                raise ValueError("payload and pool differ in kv_dtype")
            rows = {k: host_tensor(a) for k, a in rows.items()} \
                if isinstance(rows, dict) else host_tensor(rows)
            if isinstance(slab, HeadShards):
                heads = [slab_data(p).shape[-2] for p in slab]
                full = (rows["q"] if isinstance(rows, dict) else rows
                        ).shape[-2]
                if full != sum(heads):
                    raise ValueError(f"payload heads {full} != pool heads "
                                     f"{sum(heads)}")
                ranks = split_heads(rows, heads)
            else:
                ranks = [rows]
            for part, prow in zip(slab_parts(slab), ranks):
                leaves = [prow["q"], prow["s"]] if isinstance(prow, dict) \
                    else [prow]
                for t, a in zip(slab_leaves(part), leaves):
                    want = (n, *t.shape[1:])
                    if tuple(a.shape) != want or a.dtype != t.dtype:
                        raise ValueError(f"payload rows {tuple(a.shape)} "
                                         f"{a.dtype} != pool rows {want} "
                                         f"{t.dtype}")
                    pairs.append((t, a))
        idx = torch.tensor(list(pages), dtype=torch.long,
                           device=self.device)
        for t, a in pairs:
            t.index_copy_(0, idx, a.to(self.device,
                                       non_blocking=a.is_pinned()))


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

