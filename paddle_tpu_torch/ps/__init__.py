"""Parameter-server analog: host-RAM sparse tables, and the byte-blob
store the fleet KV tier keeps its pages in.

The port of `paddle_tpu/ps/__init__.py`'s table half (reference:
the-one-PS, `paddle/fluid/distributed/ps/` — `table/
memory_sparse_table.cc`, `ctr_accessor.h`, `ssd_sparse_table.cc`):
CTR-scale sparse rows live in host RAM; callers pull rows by feature id
and push gradients, and the TABLE owns the sparse optimizer (adagrad /
sgd applied server-side).

The store is the port's own copy of the sharded C++ hash table
(`native/ps_table.cc`: threaded pull/push, lazy deterministic row init,
exact duplicate-id accumulation), built with g++ at first use
(`native.lazy_host_loader`), with `_PyTable`, a numpy twin of identical
semantics, when there is no toolchain or `PTPU_NO_NATIVE` is set.
Pulled rows equal the JAX package's table's bit for bit, backend for
backend (the same source, the same `_splitmix64` / `_init_row`).

Scale tiers: `CtrAccessor` adds the reference's show/click statistics
with decay and score eviction (`SparseTable.shrink()`), and `spill_dir`
gives cold rows an append-only disk tier with transparent fault-in.

Byte blobs (`put_bytes` / `get_bytes` / `delete_bytes` / `spill_bytes`
/ `blob_count`) pack arbitrary bytes into rows, never through `push`,
so they round-trip exactly: `serving/kv_tier.py` stores its chunks and
handoff parcels there. Rows shard by id hash (`shard_owner`), the
multi-host sharding contract of the reference.

The JAX package's `DistributedEmbedding` (a Layer whose pull and push
run as host callbacks inside the compiled step) and `ps/graph.py` are
not ported yet (ROADMAP.md, Queue 1 item 13).
"""
from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import struct
from typing import Optional

import numpy as np

from ..native import lazy_host_loader

__all__ = ["SparseTable", "native_available", "CtrAccessor",
           "shard_owner"]


def _bind(lib):
    lib.ptpu_ps_create.restype = ctypes.c_void_p
    lib.ptpu_ps_create.argtypes = [
        ctypes.c_int64, ctypes.c_float, ctypes.c_uint64, ctypes.c_int]
    lib.ptpu_ps_free.argtypes = [ctypes.c_void_p]
    lib.ptpu_ps_size.restype = ctypes.c_int64
    lib.ptpu_ps_size.argtypes = [ctypes.c_void_p]
    lib.ptpu_ps_pull.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int]
    lib.ptpu_ps_push.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.c_int]
    lib.ptpu_ps_snapshot_bytes.restype = ctypes.c_int64
    lib.ptpu_ps_snapshot_bytes.argtypes = [ctypes.c_void_p]
    lib.ptpu_ps_snapshot.restype = ctypes.c_int64
    lib.ptpu_ps_snapshot.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]
    lib.ptpu_ps_clear.argtypes = [ctypes.c_void_p]
    lib.ptpu_ps_restore.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ptpu_ps_export_rows.restype = ctypes.c_int64
    lib.ptpu_ps_export_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p]
    lib.ptpu_ps_erase.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]


_load_lib = lazy_host_loader("ps_table", bind=_bind)


def native_available() -> bool:
    return _load_lib() is not None


# --------------------------------------------------------------------------- #
# deterministic init shared by both backends (bit-identical)
# --------------------------------------------------------------------------- #

_M64 = (1 << 64) - 1

# Monotonic per-process sequence for spill-file names. `id(self)` is
# NOT collision-safe here: CPython reuses addresses after GC, so two
# tables created at the same address in one process would append to the
# same spill file and corrupt each other's offset index.
_SPILL_SEQ = itertools.count()


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _init_row(seed: int, id_: int, dim: int, init_std: float) -> np.ndarray:
    """Box-Muller over splitmix64 streams — mirrors ps_table.cc row_of().

    All arithmetic is float32 like the C++ (uniform01 scale, clamp,
    sqrt/log/cos), so native and fallback rows agree to float32 rounding
    — the libm-vs-numpy transcendental implementations may still differ
    in the last ulp, which the cross-backend parity test
    bounds at rtol=1e-6."""
    base = _splitmix64((seed ^ (id_ & _M64)) & _M64)
    w = np.zeros(dim, np.float32)
    f32 = np.float32
    scale = f32(1.0 / 9007199254740992.0)
    two_pi = f32(6.28318530718)
    std = f32(init_std)
    for j in range(0, dim, 2):
        a = _splitmix64((base + 2 * j) & _M64)
        b = _splitmix64((base + 2 * j + 1) & _M64)
        u1 = f32(a >> 11) * scale
        u2 = f32(b >> 11) * scale
        if u1 < f32(1e-12):
            u1 = f32(1e-12)
        r = np.sqrt(f32(-2.0) * np.log(u1)) * std
        w[j] = r * np.cos(two_pi * u2)
        if j + 1 < dim:
            w[j + 1] = r * np.sin(two_pi * u2)
    return w


class _PyTable:
    """Numpy fallback with identical semantics (single-threaded)."""

    def __init__(self, dim, init_std, seed):
        self.dim = dim
        self.init_std = init_std
        self.seed = seed
        self.rows = {}  # id -> (w, acc) float32 arrays

    def _row(self, id_):
        r = self.rows.get(id_)
        if r is None:
            r = (_init_row(self.seed, id_, self.dim, self.init_std),
                 np.zeros(self.dim, np.float32))
            self.rows[id_] = r
        return r

    def pull(self, ids, out):
        for i, id_ in enumerate(ids):
            out[i] = self._row(int(id_))[0]

    def push(self, ids, grads, lr, mode, eps):
        for i, id_ in enumerate(ids):
            w, acc = self._row(int(id_))
            g = grads[i]
            if mode == 1:
                acc += g * g
                w -= lr * g / (np.sqrt(acc) + eps)
            else:
                w -= lr * g

    def __len__(self):
        return len(self.rows)

    def export_rows(self, ids):
        parts = [struct.pack("<q", len(ids))]
        for id_ in ids:
            w, acc = self._row(int(id_))
            parts.append(struct.pack("<q", int(id_)))
            parts.append(w.tobytes())
            parts.append(acc.tobytes())
        return b"".join(parts)

    def erase(self, ids):
        for id_ in ids:
            self.rows.pop(int(id_), None)

    def snapshot(self):
        parts = [struct.pack("<q", len(self.rows))]
        for id_, (w, acc) in self.rows.items():
            parts.append(struct.pack("<q", id_))
            parts.append(w.tobytes())
            parts.append(acc.tobytes())
        return b"".join(parts)

    def restore(self, buf):
        self.rows.clear()  # restore REPLACES state, never merges
        (n,) = struct.unpack_from("<q", buf, 0)
        off = 8
        row_bytes = 4 * self.dim
        for _ in range(n):
            (id_,) = struct.unpack_from("<q", buf, off)
            off += 8
            w = np.frombuffer(buf, np.float32, self.dim, off).copy()
            off += row_bytes
            acc = np.frombuffer(buf, np.float32, self.dim, off).copy()
            off += row_bytes
            self.rows[id_] = (w, acc)


def shard_owner(ids, world_size: int) -> np.ndarray:
    """Owning host of each feature id under the pod-wide id-hash (the
    multi-host sharding contract: every host runs the SAME function, so
    any host can route any id). splitmix64 like the row init."""
    x = np.asarray(ids, np.uint64)
    for add, mul, sh1, sh2 in (
            (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 30, 27),):
        x = x + np.uint64(add)
        x = (x ^ (x >> np.uint64(sh1))) * np.uint64(mul)
        x = (x ^ (x >> np.uint64(sh2))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(world_size)).astype(np.int64)


class CtrAccessor:
    """Per-row show/click statistics with time decay and score-based
    eviction (reference: `ps/table/ctr_accessor.h` CtrCommonAccessor —
    show_click_score, show_click_decay_rate, delete_threshold,
    delete_after_unseen_days).

    The row payload stays in the C++ table; the accessor keeps the
    (show, click, unseen_days) statistics host-side and tells the table
    which rows to drop at `SparseTable.shrink()` time.
    """

    def __init__(self, show_coeff: float = 0.25, click_coeff: float = 9.0,
                 decay_rate: float = 0.98, delete_threshold: float = 0.8,
                 delete_after_unseen_days: int = 30):
        self.show_coeff = float(show_coeff)
        self.click_coeff = float(click_coeff)
        self.decay_rate = float(decay_rate)
        self.delete_threshold = float(delete_threshold)
        self.delete_after_unseen_days = int(delete_after_unseen_days)
        self.stats = {}  # id -> [show, click, unseen_days]

    def push_show_click(self, ids, shows, clicks):
        ids = np.asarray(ids, np.int64).reshape(-1)
        shows = np.broadcast_to(np.asarray(shows, np.float64),
                                ids.shape).reshape(-1)
        clicks = np.broadcast_to(np.asarray(clicks, np.float64),
                                 ids.shape).reshape(-1)
        for id_, sh, ck in zip(ids.tolist(), shows, clicks):
            st = self.stats.setdefault(id_, [0.0, 0.0, 0])
            st[0] += float(sh)
            st[1] += float(ck)
            st[2] = 0  # seen now

    def score(self, id_) -> float:
        st = self.stats.get(int(id_))
        if st is None:
            return 0.0
        return self.show_coeff * st[0] + self.click_coeff * st[1]

    def shrink_candidates(self):
        """One shrink cycle over the stats: decay every row, age unseen
        rows, and return the ids whose score fell below the delete
        threshold (or that went unseen too long)."""
        evict = []
        for id_, st in self.stats.items():
            st[0] *= self.decay_rate
            st[1] *= self.decay_rate
            st[2] += 1
            score = self.show_coeff * st[0] + self.click_coeff * st[1]
            if (score < self.delete_threshold
                    or st[2] > self.delete_after_unseen_days):
                evict.append(id_)
        for id_ in evict:
            del self.stats[id_]
        return np.asarray(evict, np.int64)


class SparseTable:
    """A sparse parameter table with a built-in sparse optimizer.

    Matches the reference's memory_sparse_table semantics: rows appear
    on first touch (deterministic init), `push` applies the optimizer
    immediately (server-side apply), duplicate ids in one push
    accumulate exactly.

    Scale tiers (reference `ps/table/`): an optional `accessor`
    (CtrAccessor) drives `shrink()` eviction like ctr_accessor.h, and
    an optional `spill_dir` gives cold rows a disk tier like
    ssd_sparse_table.cc — `spill_rows(ids)` moves them out of RAM into
    an append-only file, and pull/push transparently fault them back.
    """

    _MODES = {"sgd": 0, "adagrad": 1}

    def __init__(self, embedding_dim: int, init_std: float = 0.01,
                 seed: int = 0, optimizer: str = "adagrad",
                 learning_rate: float = 0.05, epsilon: float = 1e-8,
                 n_shards: Optional[int] = None,
                 accessor: Optional[CtrAccessor] = None,
                 spill_dir: Optional[str] = None):
        if optimizer not in self._MODES:
            raise ValueError(f"optimizer must be one of "
                             f"{sorted(self._MODES)}")
        self.dim = int(embedding_dim)
        self.init_std = float(init_std)
        self.seed = int(seed)
        self.optimizer = optimizer
        self.learning_rate = float(learning_rate)
        self.epsilon = float(epsilon)
        self.n_shards = int(n_shards or min(os.cpu_count() or 1, 16))
        self.accessor = accessor
        self.spill_dir = spill_dir
        self._spilled = {}  # id -> (offset, nbytes) in the spill file
        self._blobs = {}  # blob key -> (nbytes, row-id array)
        self._spill_path = None
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            self._spill_path = os.path.join(
                spill_dir,
                f"table_{os.getpid()}_{next(_SPILL_SEQ)}.spill")
        lib = _load_lib()
        if lib is not None:
            self._lib = lib
            self._h = ctypes.c_void_p(lib.ptpu_ps_create(
                self.dim, self.init_std, self.seed, self.n_shards))
            self._py = None
        else:
            self._lib = None
            self._h = None
            self._py = _PyTable(self.dim, self.init_std, self.seed)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None) is not None:
            self._lib.ptpu_ps_free(h)
            self._h = None

    def __len__(self):
        if self._py is not None:
            return len(self._py)
        return int(self._lib.ptpu_ps_size(self._h))

    def _flat_ids(self, ids):
        a = np.ascontiguousarray(np.asarray(ids), np.int64)
        return a.reshape(-1), a.shape

    def pull(self, ids) -> np.ndarray:
        """Fetch rows for `ids` (any shape) → float32 ids.shape+(dim,)."""
        flat, shape = self._flat_ids(ids)
        self._fault_in(flat)
        out = np.empty((flat.size, self.dim), np.float32)
        if self._py is not None:
            self._py.pull(flat, out)
        else:
            self._lib.ptpu_ps_pull(
                self._h, flat.ctypes.data_as(ctypes.c_void_p), flat.size,
                out.ctypes.data_as(ctypes.c_void_p), 0)
        return out.reshape(shape + (self.dim,))

    def push(self, ids, grads, learning_rate: Optional[float] = None):
        """Apply the table optimizer to `grads` (ids.shape+(dim,))."""
        flat, shape = self._flat_ids(ids)
        self._fault_in(flat)
        g = np.ascontiguousarray(np.asarray(grads, np.float32)
                                 .reshape(flat.size, self.dim))
        lr = self.learning_rate if learning_rate is None \
            else float(learning_rate)
        mode = self._MODES[self.optimizer]
        if self._py is not None:
            self._py.push(flat, g, lr, mode, self.epsilon)
        else:
            self._lib.ptpu_ps_push(
                self._h, flat.ctypes.data_as(ctypes.c_void_p), flat.size,
                g.ctypes.data_as(ctypes.c_void_p), lr, mode,
                self.epsilon, 0)

    # --- row administration (export / erase) ----------------------------- #
    def _export_rows(self, flat_ids: np.ndarray) -> bytes:
        if self._py is not None:
            return self._py.export_rows(flat_ids)
        n = flat_ids.size
        nbytes = 8 + n * (8 + 8 * self.dim)
        raw = (ctypes.c_char * nbytes)()
        used = int(self._lib.ptpu_ps_export_rows(
            self._h, flat_ids.ctypes.data_as(ctypes.c_void_p), n, raw))
        return bytes(raw[:used])

    def _insert_rows(self, buf: bytes):
        if self._py is not None:
            # O(inserted): borrow the dict, restore into an empty one,
            # merge the (small) restored set back
            saved, self._py.rows = self._py.rows, {}
            self._py.restore(buf)
            saved.update(self._py.rows)
            self._py.rows = saved
        else:
            self._lib.ptpu_ps_restore(self._h, buf)  # C++ restore merges

    def _erase_ram(self, flat: np.ndarray):
        if self._py is not None:
            self._py.erase(flat)
        else:
            self._lib.ptpu_ps_erase(
                self._h, flat.ctypes.data_as(ctypes.c_void_p), flat.size)

    def erase(self, ids):
        flat, _ = self._flat_ids(ids)
        for id_ in flat.tolist():  # an erased row must not resurrect
            self._spilled.pop(id_, None)  # from the disk tier
        self._erase_ram(flat)

    # --- CTR accessor ----------------------------------------------------- #
    def push_show_click(self, ids, shows=1.0, clicks=0.0):
        """Record impression/click statistics (reference: the show/click
        columns the worker pushes alongside gradients)."""
        if self.accessor is None:
            raise ValueError("table has no CtrAccessor")
        self.accessor.push_show_click(np.asarray(ids), shows, clicks)

    def shrink(self) -> int:
        """One eviction cycle: decay statistics, drop rows whose
        show/click score fell below the accessor's delete threshold
        (reference MemorySparseTable::Shrink via the accessor)."""
        if self.accessor is None:
            raise ValueError("table has no CtrAccessor")
        evict = self.accessor.shrink_candidates()
        if evict.size:
            self.erase(evict)  # drops spilled copies too
        return int(evict.size)

    # --- disk spill tier -------------------------------------------------- #
    def spill_rows(self, ids) -> int:
        """Move rows to the disk tier (reference ssd_sparse_table.cc:
        cold rows leave RAM; access faults them back transparently)."""
        if self._spill_path is None:
            raise ValueError("table was created without spill_dir")
        flat, _ = self._flat_ids(ids)
        flat = np.asarray([i for i in flat.tolist()
                           if i not in self._spilled], np.int64)
        if not flat.size:
            return 0
        buf = self._export_rows(flat)
        rec = 8 + 8 * self.dim
        with open(self._spill_path, "ab") as f:
            base = f.tell()
            f.write(buf[8:])  # records only; offsets index them
        for j, id_ in enumerate(flat.tolist()):
            self._spilled[id_] = base + j * rec
        self._erase_ram(flat)  # NOT erase(): that drops spill entries
        return int(flat.size)

    def _fault_in(self, flat_ids: np.ndarray):
        if not self._spilled:
            return
        hit = [i for i in dict.fromkeys(flat_ids.tolist())
               if i in self._spilled]
        if not hit:
            return
        rec = 8 + 8 * self.dim
        parts = [struct.pack("<q", len(hit))]
        with open(self._spill_path, "rb") as f:
            for id_ in hit:
                f.seek(self._spilled.pop(id_))
                parts.append(f.read(rec))
        self._insert_rows(b"".join(parts))

    @property
    def spilled_rows(self) -> int:
        return len(self._spilled)

    # --- raw byte blobs (fleet KV tier) ----------------------------------- #
    # A record is 8 id bytes + 8*dim payload bytes (the w and acc
    # lanes). The blob API packs arbitrary byte strings straight into
    # those lanes — never through push(), whose float arithmetic would
    # mangle bit patterns — so blobs round-trip exactly and spill/
    # fault-in like any other row. Row ids derive from (key, chunk
    # index) via blake2b so blobs and embedding ids share the table
    # without collisions. The host-side `_blobs` index records length
    # and row ids because export_rows lazily CREATES rows for unknown
    # ids (reference semantics): a read must only name rows the blob
    # actually wrote. Blobs are a process-local tier — they do not
    # survive save()/load().

    @staticmethod
    def _blob_row_ids(key: int, n_rows: int) -> np.ndarray:
        ids = np.empty(n_rows, np.int64)
        for i in range(n_rows):
            h = hashlib.blake2b(struct.pack("<qq", key, i),
                                digest_size=8).digest()
            ids[i] = struct.unpack("<q", h)[0]
        return ids

    def put_bytes(self, key: int, data: bytes) -> int:
        """Store `data` under integer `key`; returns len(data)."""
        cap = 8 * self.dim
        n_rows = max(1, -(-len(data) // cap))
        ids = self._blob_row_ids(key, n_rows)
        for id_ in ids.tolist():          # a stale spilled copy must
            self._spilled.pop(id_, None)  # not shadow the fresh write
        old = self._blobs.get(key)
        if old is not None and len(old[1]) > n_rows:
            self.erase(old[1][n_rows:])  # shrink: drop leftover rows
        parts = [struct.pack("<q", n_rows)]
        for i, id_ in enumerate(ids.tolist()):
            parts.append(struct.pack("<q", id_))
            parts.append(data[i * cap:(i + 1) * cap].ljust(cap, b"\0"))
        self._insert_rows(b"".join(parts))
        self._blobs[key] = (len(data), ids)
        return len(data)

    def get_bytes(self, key: int) -> Optional[bytes]:
        """Fetch the blob stored under `key`, faulting spilled rows
        back from disk; None if no blob is stored there."""
        entry = self._blobs.get(key)
        if entry is None:
            return None
        nbytes, ids = entry
        self._fault_in(ids)
        buf = self._export_rows(ids)
        rec = 8 + 8 * self.dim
        (n,) = struct.unpack_from("<q", buf, 0)
        by_id = {}
        for j in range(n):
            off = 8 + j * rec
            (id_,) = struct.unpack_from("<q", buf, off)
            by_id[id_] = buf[off + 8:off + rec]
        return b"".join(by_id[i] for i in ids.tolist())[:nbytes]

    def delete_bytes(self, key: int) -> bool:
        entry = self._blobs.pop(key, None)
        if entry is None:
            return False
        self.erase(entry[1])  # drops spilled copies too
        return True

    def spill_bytes(self, key: int) -> int:
        """Move a blob's rows to the disk tier (cold layer); get_bytes
        faults them back transparently."""
        entry = self._blobs.get(key)
        if entry is None:
            return 0
        return self.spill_rows(entry[1])

    @property
    def blob_count(self) -> int:
        return len(self._blobs)

    # --- checkpoint ------------------------------------------------------ #
    def save(self, path: str):
        if self._py is not None:
            buf = self._py.snapshot()
        else:
            n = int(self._lib.ptpu_ps_snapshot_bytes(self._h))
            raw = (ctypes.c_char * n)()
            used = int(self._lib.ptpu_ps_snapshot(self._h, raw, n))
            buf = bytes(raw[:used])
        if self._spilled:
            # a snapshot covers the WHOLE table, but spilled records are
            # appended straight from disk (same record format) — never
            # faulted back into RAM, which is scarce by definition here
            rec = 8 + 8 * self.dim
            (n_ram,) = struct.unpack_from("<q", buf, 0)
            parts = [struct.pack("<q", n_ram + len(self._spilled)),
                     buf[8:]]
            with open(self._spill_path, "rb") as f:
                for off in self._spilled.values():
                    f.seek(off)
                    parts.append(f.read(rec))
            buf = b"".join(parts)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(struct.pack("<qq", 1, self.dim))  # version, dim
            f.write(buf)
        os.replace(tmp, path)  # a crashed save never leaves a short file

    def load(self, path: str):
        with open(path, "rb") as f:
            ver, dim = struct.unpack("<qq", f.read(16))
            if ver != 1:
                raise ValueError(f"unknown table snapshot version {ver}")
            if dim != self.dim:
                raise ValueError(f"snapshot dim {dim} != table dim "
                                 f"{self.dim}")
            buf = f.read()
        (n,) = struct.unpack_from("<q", buf, 0)
        want = 8 + n * (8 + 8 * self.dim)
        if len(buf) < want:
            raise ValueError(f"truncated table snapshot: header declares "
                             f"{n} rows ({want} bytes), file holds "
                             f"{len(buf)}")
        # load REPLACES the whole table; stale spill-file rows must not
        # resurrect over checkpoint rows on the next fault-in
        self._spilled.clear()
        if self._py is not None:
            self._py.restore(buf)
        else:
            self._lib.ptpu_ps_clear(self._h)  # replace, never merge
            self._lib.ptpu_ps_restore(self._h, buf)
        return self
