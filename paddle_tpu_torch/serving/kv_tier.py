"""Fleet-global host-RAM KV tier over the port's `ps.SparseTable`.

The port of `paddle_tpu/serving/kv_tier.py`. Prefill output is a
cacheable artifact, not a per-replica side effect: replicas PUBLISH the
KV pages of page-aligned token prefixes into one shared host tier,
keyed by a hash of the tokens that produced them, and any replica that
later sees the same prefix BINDS those pages into its block table
instead of prefilling them. A popular system prompt is prefilled once
per fleet, not once per replica.

Store: the byte-blob API of `ps.SparseTable` (threaded shards; with
`spill_dir`, an append-only disk layer with transparent fault-in, so
cold chunks spill to disk under RAM pressure and come back on the next
hit).

A TP engine publishes and binds through the same payload: its pool
joins its ranks' heads on the way out and splits them on the way in
(`paged_kv.PagedKVCache.gather_pages` / `scatter_pages`), so a chunk
published at one degree binds at any other.

Keying: chunk i covers tokens [i*page_size, (i+1)*page_size). A row's
K/V depend on every earlier token, so a chunk's key hashes the WHOLE
aligned prefix up to and including the chunk (`chunk_key`, equal to the
JAX package's for the same tokens): two prompts share tier entries as
far as their common page-aligned prefix, the prefix tree's rule.

Two traffic classes share the store:

* prefix chunks: content-addressed, immutable once published,
  LRU-evicted (spilled to disk first when a disk layer exists);
* handoff parcels: single-use payloads of decode handoffs, swap-outs
  and drains (`put_handoff` / `take_handoff` / `drop_handoff`), keyed
  by a process-unique sequence and exempt from eviction.

The payload codec. A payload is a dict of per-layer K and V row stacks
(`[n, page_size, heads, head_dim]` tensors, or int8 `{"q", "s"}`
pairs), `rows` and `quantized`, as `PagedKVCache.gather_pages` returns
them: views of ONE pinned host buffer. The reference pickles its numpy
payloads; pickling a torch view writes its whole storage (every page of
the gather in every chunk), and holding the views would keep pinned
memory alive for as long as the tier holds them. So `encode_payload`
writes each leaf's OWN bytes behind a small header (magic, the JSON
structure: rows, quantized, layers, each leaf's dtype and shape), and
the table keeps them in pageable memory; `ram_bytes` counts exactly
those bytes. `decode_payload` rebuilds CPU tensors that
`scatter_pages` takes; bfloat16 travels as its raw bits (no
`ml_dtypes`).

Threading: single-owner, like the engine: the fleet drives every
replica from one thread, and the tier inherits that contract.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import struct
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import host_tensor
from ..ps import SparseTable

__all__ = ["KVTier", "chunk_key", "encode_payload", "decode_payload"]

# Row width of the backing table: 256 float lanes = 2048 payload bytes
# per row (the tier never pulls or pushes floats: only the byte-blob
# API touches this table)
_BLOB_DIM = 256
_MAGIC = b"PTKV\x01\x00\x00\x00"


def chunk_key(tokens: Sequence[int], namespace: str = "kv") -> int:
    """Content hash of a page-aligned token prefix -> signed int64 blob
    key. The namespace keeps tiers of different page sizes or model
    families from aliasing in a shared store."""
    raw = namespace.encode() + b"\0" \
        + np.asarray(tokens, np.int32).tobytes()
    h = hashlib.blake2b(raw, digest_size=8).digest()
    return struct.unpack("<q", h)[0]


def _leaves(layers) -> List:
    out = []
    for lay in layers:
        if isinstance(lay, dict):
            out += [lay["q"], lay["s"]]
        else:
            out.append(lay)
    return out


def encode_payload(payload: Dict[str, Any]) -> bytes:
    """One payload as bytes: the header, then every leaf's own bytes (K
    layers, then V layers; an int8 layer's codes before its scales)."""
    k, v = list(payload["k"]), list(payload["v"])
    tensors = [host_tensor(a).contiguous() for a in _leaves(k + v)]
    header = json.dumps({
        "rows": int(payload["rows"]),
        "quantized": bool(payload.get("quantized", False)),
        "layers": len(k),
        "leaves": [[str(t.dtype).replace("torch.", ""), list(t.shape)]
                   for t in tensors]}).encode()
    parts = [_MAGIC, struct.pack("<q", len(header)), header]
    parts += [t.reshape(-1).view(torch.uint8).numpy().tobytes()
              for t in tensors]
    return b"".join(parts)


def decode_payload(data: bytes) -> Dict[str, Any]:
    """Inverse of `encode_payload`: CPU tensors (one copy each, pageable
    memory) in the payload's structure."""
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError("not a KV tier payload")
    off = len(_MAGIC)
    (n,) = struct.unpack_from("<q", data, off)
    off += 8
    header = json.loads(data[off:off + n].decode())
    off += n
    tensors = []
    for dtype, shape in header["leaves"]:
        dt = getattr(torch, dtype)
        count = int(np.prod(shape, dtype=np.int64)) \
            * torch.empty((), dtype=dt).element_size()
        raw = np.frombuffer(data, np.uint8, count, off).copy()
        off += count
        tensors.append(torch.from_numpy(raw).view(dt).reshape(shape))
    quant, L = bool(header["quantized"]), int(header["layers"])
    it = iter(tensors)
    layers = [{"q": next(it), "s": next(it)} if quant else next(it)
              for _ in range(2 * L)]
    return {"k": layers[:L], "v": layers[L:], "rows": int(header["rows"]),
            "quantized": quant}


class KVTier:
    """Fleet-shared host KV tier: publish / bind prefix chunks, relay
    single-use handoff parcels (see the module docstring)."""

    def __init__(self, page_size: int, capacity_mb: float = 256.0,
                 spill_dir: Optional[str] = None,
                 namespace: str = "kv"):
        self.page_size = int(page_size)
        self.capacity_bytes = int(capacity_mb * (1 << 20))
        self.namespace = namespace
        self._table = SparseTable(_BLOB_DIM, optimizer="sgd",
                                  spill_dir=spill_dir)
        self._spillable = spill_dir is not None
        self._ram: "OrderedDict[int, int]" = OrderedDict()  # key->nbytes
        self._disk: Dict[int, int] = {}
        self._handoffs: Dict[int, int] = {}
        self._handoff_seq = itertools.count(1)
        # lifetime counters (the fleet's stats and exposition read them)
        self.publishes = 0
        self.evictions = 0
        self.spills = 0
        self.handoffs_in = 0
        self.handoffs_out = 0

    # --- keys ------------------------------------------------------------- #
    def chunk_key(self, tokens: Sequence[int]) -> int:
        return chunk_key(tokens, self.namespace)

    # --- prefix chunks ---------------------------------------------------- #
    def has_chunk(self, key: int) -> bool:
        return key in self._ram or key in self._disk

    def has_prefix(self, tokens: Sequence[int]) -> bool:
        """True iff the FIRST full page-aligned chunk of `tokens` is
        published: any replica can start this prompt from the tier, so
        prefix affinity stops mattering (the router's probe)."""
        if len(tokens) < self.page_size:
            return False
        return self.has_chunk(self.chunk_key(tokens[:self.page_size]))

    def publish_chunk(self, key: int, payload: Dict[str, Any]) -> int:
        """Store one chunk's K/V rows; returns the bytes stored (0 when
        the chunk is published already: the first writer wins, and the
        content hash means equal bytes)."""
        if self.has_chunk(key):
            self._touch(key)
            return 0
        data = encode_payload(payload)
        self._table.put_bytes(key, data)
        self._ram[key] = len(data)
        self.publishes += 1
        self._enforce_capacity()
        return len(data)

    def fetch_chunk(self, key: int) -> Optional[Dict[str, Any]]:
        """A published chunk (faulted back from disk when spilled); None
        on a miss."""
        if key in self._disk:  # fault-in moves the rows back to RAM
            self._ram[key] = self._disk.pop(key)
        elif key not in self._ram:
            return None
        data = self._table.get_bytes(key)
        if data is None:  # pragma: no cover - index/table drift
            self._ram.pop(key, None)
            return None
        self._touch(key)
        self._enforce_capacity()
        return decode_payload(data)

    def _touch(self, key: int):
        if key in self._ram:
            self._ram.move_to_end(key)

    def _enforce_capacity(self):
        """LRU-demote until RAM fits the budget: spill cold chunks to
        the disk layer when one exists, drop them otherwise."""
        while self._ram and self.ram_bytes > self.capacity_bytes:
            key, nbytes = next(iter(self._ram.items()))
            self._ram.pop(key)
            if self._spillable:
                self._table.spill_bytes(key)
                self._disk[key] = nbytes
                self.spills += 1
            else:
                self._table.delete_bytes(key)
                self.evictions += 1

    # --- single-use handoff parcels --------------------------------------- #
    def put_handoff(self, payload: Dict[str, Any]) -> int:
        """Park a handoff / swap / drain payload; returns the single-use
        key the adopting replica redeems."""
        raw = (self.namespace.encode() + b"/handoff\0"
               + struct.pack("<q", next(self._handoff_seq)))
        key = struct.unpack(
            "<q", hashlib.blake2b(raw, digest_size=8).digest())[0]
        data = encode_payload(payload)
        self._table.put_bytes(key, data)
        self._handoffs[key] = len(data)
        self.handoffs_in += 1
        return key

    def take_handoff(self, key: int) -> Optional[Dict[str, Any]]:
        """Redeem (and delete) a parcel; None if the key was never
        parked or was taken already."""
        if self._handoffs.pop(key, None) is None:
            return None
        data = self._table.get_bytes(key)
        self._table.delete_bytes(key)
        self.handoffs_out += 1
        return None if data is None else decode_payload(data)

    def drop_handoff(self, key: int):
        """Discard an abandoned parcel (its request died before any
        replica adopted it)."""
        if self._handoffs.pop(key, None) is not None:
            self._table.delete_bytes(key)

    # --- accounting -------------------------------------------------------- #
    @property
    def ram_bytes(self) -> int:
        return sum(self._ram.values()) + sum(self._handoffs.values())

    @property
    def disk_bytes(self) -> int:
        return sum(self._disk.values())

    def stats(self) -> Dict[str, int]:
        return {
            "chunks_ram": len(self._ram),
            "chunks_disk": len(self._disk),
            "bytes_ram": self.ram_bytes,
            "bytes_disk": self.disk_bytes,
            "publishes": self.publishes,
            "evictions": self.evictions,
            "spills": self.spills,
            "handoffs_open": len(self._handoffs),
            "handoffs_in": self.handoffs_in,
            "handoffs_out": self.handoffs_out,
        }
