"""TP-sharded KV space: the `KVManager` interface and group-aware managers.

The counterpart of `paddle_tpu/serving/sharded_kv.py`. Serving over a
tensor-parallel group partitions the decode state as well as the
weights:

- `KVManager` is the one slot / page bookkeeping interface the engine
  programs against: admission, lengths, the free order a snapshot
  records, the footprint. `KVCacheManager` and
  `PagedKVCache` are registered as its single-device implementations,
  as the reference registers them (`sharded_kv.py:135-138`).
- `ShardedKVCacheManager` / `ShardedPagedKVCache` subclass them and
  change one thing: every slab (slot slabs, prefix-pool pages, the paged
  pool) is a `HeadShards`, one contiguous slab per rank over that
  rank's `nh / tp` heads (int8 scale rows `[..., nh / tp]` shard with
  their heads, the reference's `KV_SCALE_SPEC`). The seam is
  `_new_slab`, through which `_alloc_slabs` and `reallocate_pool` make
  every slab. Free lists, lengths, block tables, refcounts and the COW
  stash are inherited unchanged; the page copies move the ranks'
  leaves alike, and the page transfer joins and splits the heads, so a
  payload (snapshot, extract / adopt, host swap, the fleet KV tier) is
  the bytes an unsharded engine moves.
- The layout is the trainer's: qkv's column split gives each rank its
  heads' K / V, which it writes into its own slab
  (`models/gpt.py`, `tp_param_specs`).

`make_kv_manager` is the factory the engine builds its cache with;
`make_tp_mesh` (`nn/tp.py`) the group, bound to the engine's device by
the engine; `shard_serving_params` places the weights.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence

import torch

from ..nn.tp import (ShardedParams, TPGroup, make_tp_mesh,
                     mesh_fingerprint, require_tp_heads)
from ..quantization.kv import HeadShards, make_slab
from .kv_cache import KVCacheManager
from .paged_kv import PagedKVCache

__all__ = ["KVManager", "ShardedKVCacheManager", "ShardedPagedKVCache",
           "make_kv_manager", "make_tp_mesh", "mesh_fingerprint",
           "shard_serving_params", "TPGroup"]


class KVManager(abc.ABC):
    """The layout- and group-agnostic KV bookkeeping contract: what
    `LLMEngine` needs from a cache, with no mention of how (or over how
    many ranks) the bytes are laid out; slot ids and lengths are the
    currency. The reference's slab hand-off (`arrays`, `swap`,
    `swap_pool`, `reallocate`) is left out: the port's programs write
    the slabs in place and never hand them back."""

    # --- admission / lifetime ------------------------------------------- #
    @abc.abstractmethod
    def allocate(self, slot: Optional[int] = None) -> int: ...

    @abc.abstractmethod
    def release(self, slot: int) -> None: ...

    @abc.abstractmethod
    def reset_length(self, slot: int) -> None: ...

    @abc.abstractmethod
    def length(self, slot: int) -> int: ...

    @abc.abstractmethod
    def advance(self, slot: int, n: int = 1) -> None: ...

    # --- snapshot / adopt ------------------------------------------------ #
    @abc.abstractmethod
    def free_slots(self) -> List[int]: ...

    @abc.abstractmethod
    def restore_free_order(self, order: Sequence[int]) -> None: ...

    # --- accounting ------------------------------------------------------ #
    @abc.abstractmethod
    def reallocate_pool(self) -> None: ...

    @abc.abstractmethod
    def nbytes(self) -> int: ...


# the single-device managers predate the interface: register rather
# than rebase, so their MRO is untouched
KVManager.register(KVCacheManager)


def shard_serving_params(params: Dict[str, torch.Tensor],
                         specs: Dict[str, tuple],
                         group: TPGroup) -> ShardedParams:
    """Place a flat parameter dict over `group` by `specs`
    (`models.gpt.tp_param_specs`): each sharded tensor becomes one
    contiguous tensor per rank on the group's device, every other
    tensor is replicated (shared by the ranks, which share the device).
    The reference's `shard_serving_params` (`sharded_kv.py:185`) places
    by the trainer's `PartitionSpec`s; here "qkv" splits head-aligned
    where the reference's `(None, "tp")` spec splits the 3h axis in
    contiguous blocks and GSPMD reshards (a contiguous half would give
    rank 0 all of q and half of k)."""
    tp, dev = group.tp, group.device
    ranks: List[Dict[str, torch.Tensor]] = [{} for _ in range(tp)]
    replicated: Dict[str, torch.Tensor] = {}
    vocab_starts = [0] * tp
    for name, t in params.items():
        t = t.to(dev)
        spec = specs.get(name)
        if spec is None:
            replicated[name] = t
            continue
        kind = spec[0]
        if kind == "qkv":
            nh = require_tp_heads(int(spec[1]), tp)
            lead = t.shape[:-1]
            cols = t.reshape(*lead, 3, nh, -1)
            shards = [cols[..., r * (nh // tp):(r + 1) * (nh // tp), :]
                      .reshape(*lead, -1) for r in range(tp)]
        elif kind in ("col", "vocab_col"):
            shards = torch.tensor_split(t, tp, dim=-1)
        elif kind in ("row", "vocab"):
            shards = torch.tensor_split(t, tp, dim=0)
            if kind == "vocab":
                vocab_starts = [0]
                for sh in shards[:-1]:
                    vocab_starts.append(vocab_starts[-1] + sh.shape[0])
        else:
            raise ValueError(f"{name}: unknown TP spec {spec!r}")
        for r, sh in enumerate(shards):
            ranks[r][name] = sh.contiguous()
    return ShardedParams(replicated, ranks, group, vocab_starts)


class _ShardedSlabs:
    """The one seam of the sharded managers: every slab is a
    `HeadShards` of per-rank slabs over `nh / tp` heads each, on the
    group's device."""

    def _init_group(self, group: TPGroup, num_heads: int):
        self.group = group
        self.tp = require_tp_heads(num_heads, group.tp)

    def _new_slab(self, shape):
        rank_shape = tuple(shape[:-2]) + (shape[-2] // self.tp, shape[-1])
        return HeadShards(make_slab(rank_shape, self.slab_dtype,
                                    self.quantized, self.device)
                          for _ in range(self.tp))


class ShardedKVCacheManager(_ShardedSlabs, KVCacheManager):
    """Slotted slabs, and the prefix pool's, with heads partitioned over
    the group's ranks; the bookkeeping is `KVCacheManager`'s."""

    def __init__(self, num_layers: int, max_slots: int, max_seq: int,
                 num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 kv_dtype: Optional[str] = None,
                 prefix_pool_pages: int = 0, prefix_block: int = 64, *,
                 group: TPGroup):
        # the group must exist before the base constructor makes slabs
        self._init_group(group, num_heads)
        super().__init__(num_layers, max_slots, max_seq, num_heads,
                         head_dim, dtype, device, kv_dtype=kv_dtype,
                         prefix_pool_pages=prefix_pool_pages,
                         prefix_block=prefix_block)


class ShardedPagedKVCache(_ShardedSlabs, PagedKVCache):
    """The paged pool with heads partitioned over the group's ranks: a
    page id means the same page on every rank; only its bytes split."""

    def __init__(self, num_layers: int, max_slots: int, max_seq: int,
                 num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 page_size: int = 64, num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None, *, group: TPGroup):
        self._init_group(group, num_heads)
        super().__init__(num_layers, max_slots, max_seq, num_heads,
                         head_dim, dtype, device, page_size=page_size,
                         num_pages=num_pages, kv_dtype=kv_dtype)


def make_kv_manager(layout: str, group: Optional[TPGroup] = None,
                    **kw) -> KVManager:
    """The cache of an engine: `layout` "slotted" or "paged"; without a
    group (or with a one-rank group) the single-device manager, else
    its sharded twin over the group (bound to `kw["device"]` when it
    names none)."""
    if layout not in ("slotted", "paged"):
        raise ValueError(f"unknown KV layout {layout!r}")
    if group is None or group.tp == 1:
        cls = PagedKVCache if layout == "paged" else KVCacheManager
        return cls(**kw)
    if group.device is None:
        group = group.bind(kw.get("device"))
    cls = ShardedPagedKVCache if layout == "paged" \
        else ShardedKVCacheManager
    return cls(group=group, **kw)
