"""Automatic prefix caching: a radix tree over token-id chunks mapping
shared prompt prefixes to pages of precomputed K/V rows.

The port's own copy of `paddle_tpu/serving/prefix_cache.py` (host-side
numpy and dicts; it touches no device):

- Token prefixes are chunked into fixed `prefix_block`-sized pieces.
  Only FULL chunks are cacheable. One node == one chunk == one PAGE of
  per-layer K/V rows: a page of the slotted engine's prefix pool
  (`KVCacheManager`'s `[pool_pages, prefix_block, heads, head_dim]`
  slabs), or, under the paged layout, a page of the one shared
  `PagePool` (`paged_kv.TreePageAllocator`). The tree hands out page
  ids and never touches the device. Under a TP group the pool's slabs
  are per-rank (`sharded_kv.ShardedKVCacheManager`): a page id names the
  same page on every rank, and the copies move every rank's rows.
- A node at depth d commits to the exact d * prefix_block leading
  tokens, from position 0, and a K/V row depends only on the tokens at
  and before it and its position: the rows behind a matched path are
  the rows a cold prefill computes for those positions (bitwise, given
  a prefill whose row bits do not depend on the rows sharing its
  calls: the engine's prefill row floor).
- Host-side REF-COUNTING pins a matched path while a request holds it;
  LRU EVICTION reclaims unreferenced leaf pages when the pool runs dry,
  leaf first.
- Insertion is BEST-EFFORT: a full pool degrades the hit rate, never
  correctness and never admission.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache", "PrefixNode"]


class PrefixNode:
    """One cached chunk: `prefix_block` tokens at depth*prefix_block,
    backed by pool page `page`. The root is a sentinel (page None)."""

    __slots__ = ("key", "page", "parent", "children", "ref", "last_used",
                 "depth")

    def __init__(self, key: Optional[bytes], page: Optional[int],
                 parent: Optional["PrefixNode"], depth: int):
        self.key = key            # chunk token bytes (int32.tobytes())
        self.page = page          # pool page id (None only for root)
        self.parent = parent
        self.children: Dict[bytes, "PrefixNode"] = {}
        self.ref = 0              # live requests pinning this chunk
        self.last_used = 0        # LRU clock at last match/insert touch
        self.depth = depth        # 1-based chunk index from the root

    def __repr__(self):  # pragma: no cover — debugging aid
        return (f"PrefixNode(depth={self.depth}, page={self.page}, "
                f"ref={self.ref}, children={len(self.children)})")


class PrefixCache:
    """Radix tree + page free-list over a fixed pool of
    `num_pages` pages of `prefix_block` tokens each.

    The engine calls, per admission:
      1. `match(tokens)` → the longest cached path (nodes + page ids);
      2. `acquire(nodes)` to pin it for the request's lifetime
         (release with `release(nodes)` when the request retires);
      3. after prefilling the uncached suffix, `insert(tokens)` →
         `(node, chunk_index)` pairs for the chunks that still need
         their rows copied from the slot into the pool
         (`drop(created)` rolls a failed device copy back).

    NOT thread-safe, by design — it lives inside `LLMEngine`, which is
    single-threaded (scheduling-thread) already.
    """

    def __init__(self, prefix_block: int, num_pages: int,
                 allocator=None):
        if prefix_block < 1:
            raise ValueError(f"prefix_block must be >= 1, "
                             f"got {prefix_block}")
        if num_pages < 0:
            raise ValueError(f"num_pages must be >= 0, got {num_pages}")
        self.prefix_block = int(prefix_block)
        self.num_pages = int(num_pages)
        self.root = PrefixNode(None, None, None, 0)
        # PAGED mode: with an `allocator`
        # (`paged_kv.TreePageAllocator`), the tree holds no free list
        # of its own — it allocates from, returns to, and REF-SHARES
        # pages of the one `PagePool` the block tables use. The tree
        # is then an INDEX over shared pages: `insert_mapped` adds a
        # reference to a request's freshly prefilled page instead of
        # copying rows into a separate slab, and eviction drops the
        # tree's reference (the page only truly frees when no live
        # block table still points at it). `num_pages` is advisory in
        # that mode (stats denominator); real capacity is the pool's.
        self.allocator = allocator
        self._owned = 0           # tree-held pages (allocator mode)
        self._free: List[int] = [] if allocator is not None \
            else list(range(num_pages - 1, -1, -1))
        self._clock = itertools.count(1)
        self.evictions = 0        # pages reclaimed by LRU (lifetime)

    # ------------------------------------------------------------------ #
    # read side
    # ------------------------------------------------------------------ #
    @property
    def pages_used(self) -> int:
        if self.allocator is not None:
            return self._owned
        return self.num_pages - len(self._free)

    @property
    def pages_free(self) -> int:
        if self.allocator is not None:
            return self.allocator.free_pages()
        return len(self._free)

    def reclaimable_pages(self) -> int:
        """How many POOL pages eviction could ULTIMATELY return to the
        free list (the fixpoint `evict()` iterates to): every node
        whose whole subtree is unpinned AND whose page the tree is the
        only holder of (shared-pool mode: a page a live block table
        still references frees nothing when the tree drops it — that
        page is real load). Idle cached chunks are an asset the engine
        can always turn back into capacity, so the
        least-work/page_load surface subtracts this, not the one-round
        `evictable_pages` bound — a deep unpinned chain is fully
        reclaimable even though only its leaf is evictable per
        round."""
        pool = self.allocator.pool if self.allocator is not None \
            else None
        count = [0]

        def walk(node) -> bool:
            """True iff `node`'s subtree holds any pinned node."""
            pinned = node.ref > 0
            for child in node.children.values():
                pinned |= walk(child)
            if node.page is not None and not pinned and \
                    (pool is None or pool.refcount(node.page) == 1):
                count[0] += 1
            return pinned

        walk(self.root)
        return count[0]

    def _chunks(self, tokens: np.ndarray) -> List[bytes]:
        B = self.prefix_block
        t = np.ascontiguousarray(np.asarray(tokens, np.int32))
        return [t[i:i + B].tobytes() for i in range(0, (t.size // B) * B,
                                                    B)]

    def match(self, tokens) -> Tuple[List[PrefixNode], List[int]]:
        """Longest cached prefix of `tokens`, at chunk granularity:
        returns the path's nodes and their pool page ids (both empty on
        a full miss). Touches the path's LRU clock."""
        nodes: List[PrefixNode] = []
        node = self.root
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            nodes.append(child)
            node = child
        now = next(self._clock)
        for n in nodes:
            n.last_used = now
        return nodes, [n.page for n in nodes]

    # ------------------------------------------------------------------ #
    # pinning
    # ------------------------------------------------------------------ #
    @staticmethod
    def acquire(nodes: List[PrefixNode]):
        for n in nodes:
            n.ref += 1

    @staticmethod
    def release(nodes: List[PrefixNode]):
        """Unpin a path. Tolerates nodes that `clear()` has since
        orphaned (the heal path rebuilds the tree under live
        requests) — their counters are dead state either way."""
        for n in nodes:
            if n.ref > 0:
                n.ref -= 1

    # ------------------------------------------------------------------ #
    # insertion + eviction
    # ------------------------------------------------------------------ #
    def insert(self, tokens) -> List[Tuple[PrefixNode, int]]:
        """Extend the tree with every full chunk of `tokens` that is
        not already cached (an admission normally finds its matched
        head present and only adds suffix chunks). Allocates a pool
        page per NEW chunk, evicting unreferenced LRU leaves when the
        free list runs dry; when eviction cannot free enough, the
        remaining chunks are dropped (best-effort — a full pool never
        fails admission).

        Returns `(node, chunk_index)` pairs for the newly created
        chunks — the caller must copy slot rows
        `[chunk_index*B, (chunk_index+1)*B)` into each node's page
        (and `drop()` the nodes if that device copy fails)."""
        chunks = self._chunks(tokens)
        if not chunks:
            return []
        # walk + PIN the existing path up front: the nodes of the path
        # being extended must survive both the batch eviction below
        # and any straggler eviction inside _alloc_page — evicting one
        # mid-insert would orphan the deeper nodes about to hang off
        # it and leak their pages
        path: List[PrefixNode] = []
        node = self.root
        for key in chunks:
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        for n in path:
            n.ref += 1
        created: List[Tuple[PrefixNode, int]] = []
        try:
            # reserve the pages this insert needs in ONE eviction
            # batch (one tree walk), not one full-tree DFS per page
            missing = len(chunks) - len(path)
            if missing > self.pages_free:
                self.evict(missing - self.pages_free)
            now = next(self._clock)
            for n in path:
                n.last_used = now
            for idx in range(len(path), len(chunks)):
                page = self._alloc_page()
                if page is None:
                    break  # pool full of pinned pages: drop the tail
                child = PrefixNode(chunks[idx], page, node,
                                   node.depth + 1)
                # created-pin until this insert returns: the caller
                # has not copied this chunk's rows into the pool yet
                child.ref += 1
                node.children[chunks[idx]] = child
                created.append((child, idx))
                child.last_used = now
                node = child
        finally:
            for n in path:
                n.ref -= 1
            for n, _ in created:
                n.ref -= 1
        return created

    def insert_mapped(self, tokens,
                      page_of_chunk) -> List[Tuple[PrefixNode, int]]:
        """PAGED-mode insertion: extend the tree with every full chunk
        of `tokens` not already cached, REFERENCING the caller's pages
        (`page_of_chunk(chunk_index) -> page id` — the lane pages
        whose rows the chunk's prefill just wrote) instead of
        allocating and copying. Requires an `allocator` (the shared
        `PagePool`); each new node `adopt()`s its page, so the rows
        outlive the request that computed them. Never fails and never
        evicts — sharing a page costs nothing. Returns the created
        `(node, chunk_index)` pairs (no device copy is owed)."""
        if self.allocator is None:
            raise RuntimeError("insert_mapped needs the shared-pool "
                               "allocator (paged mode)")
        chunks = self._chunks(tokens)
        created: List[Tuple[PrefixNode, int]] = []
        if not chunks:
            return created
        node = self.root
        now = next(self._clock)
        for idx, key in enumerate(chunks):
            child = node.children.get(key)
            if child is None:
                page = int(page_of_chunk(idx))
                self.allocator.adopt(page)
                self._owned += 1
                child = PrefixNode(key, page, node, node.depth + 1)
                node.children[key] = child
                created.append((child, idx))
            child.last_used = now
            node = child
        return created

    def drop(self, created: List[Tuple[PrefixNode, int]]):
        """Roll back an `insert()` whose device copy failed: unlink the
        new nodes (deepest first) and return their pages to the free
        list. Only safe for nodes fresh out of `insert` — they have no
        refs and their only children are later entries of `created`."""
        for node, _ in reversed(created):
            parent = node.parent
            if parent is not None and \
                    parent.children.get(node.key) is node:
                del parent.children[node.key]
            if node.page is not None:
                self._free_page(node.page)
                node.page = None

    def _free_page(self, page: int):
        """Return one tree-held page: to the private free list, or —
        in paged mode — back to the shared pool (where it truly frees
        only when no block table still references it)."""
        if self.allocator is not None:
            self.allocator.give(page)
            self._owned -= 1
        else:
            self._free.append(page)

    def _alloc_page(self) -> Optional[int]:
        if self.allocator is not None:
            page = self.allocator.take()
            if page is None and self._evict_one():
                page = self.allocator.take()
            if page is not None:
                self._owned += 1
            return page
        if not self._free and not self._evict_one():
            return None
        return self._free.pop()

    def _evictable(self) -> List[PrefixNode]:
        out = []
        pool = self.allocator.pool if self.allocator is not None \
            else None
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.ref == 0 and (pool is None
                                 or pool.refcount(n.page) == 1):
                # shared-pool mode: a page a live block table still
                # references frees NOTHING when the tree drops it —
                # evicting such a node would destroy a warm index
                # entry while reclaiming zero memory (and overstate
                # evict()'s return). It becomes a victim once its
                # last lane reference drops.
                out.append(n)
        return out

    def _evict_one(self) -> bool:
        """Reclaim the least-recently-used unreferenced LEAF page.
        Interior nodes become leaves (and so candidates) once their
        subtree is gone — deeper chunks depend on their ancestors'
        tokens, so eviction always proceeds leaf-first."""
        victims = self._evictable()
        if not victims:
            return False
        victim = min(victims, key=lambda n: n.last_used)
        del victim.parent.children[victim.key]
        self._free_page(victim.page)
        victim.page = None
        self.evictions += 1
        return True

    def evict(self, n_pages: int) -> int:
        """Best-effort: evict up to `n_pages` unreferenced LRU leaf
        pages; returns how many were reclaimed. Batched: one tree walk
        reclaims a whole round of current candidates (a parent only
        becomes a candidate after its last child goes, which the outer
        loop's re-walk picks up), so reserving k pages costs O(tree)
        not O(k * tree)."""
        done = 0
        while done < n_pages:
            victims = sorted(self._evictable(),
                             key=lambda n: n.last_used)
            if not victims:
                break
            for victim in victims[:n_pages - done]:
                del victim.parent.children[victim.key]
                self._free_page(victim.page)
                victim.page = None
                self.evictions += 1
                done += 1
        return done

    def clear(self):
        """Drop every cached chunk and reset the free list — the deep
        dispatch-recovery path: when the donated pool slabs die with a
        failed step, every page is garbage and the tree must forget
        them before re-ingest repopulates it. Outstanding `acquire`d
        node references become orphans; `release` on them stays
        harmless. In paged mode every tree-held page is returned to
        the shared pool (zero-leak: the tree never strands a
        reference)."""
        if self.allocator is not None:
            stack = list(self.root.children.values())
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n.page is not None:
                    self._free_page(n.page)
                    n.page = None
        self.root = PrefixNode(None, None, None, 0)
        self._free = [] if self.allocator is not None \
            else list(range(self.num_pages - 1, -1, -1))
