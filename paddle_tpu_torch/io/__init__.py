"""The data pipeline of the PyTorch/CUDA port: the counterpart of
`paddle_tpu/io/__init__.py`.

Datasets (`Dataset`, `IterableDataset`, `TensorDataset`,
`ComposeDataset`, `ChainDataset`, `ConcatDataset`, `Subset`,
`random_split`), samplers (`SequenceSampler`, `RandomSampler`,
`WeightedRandomSampler`, `BatchSampler`, `DistributedBatchSampler`),
`default_collate_fn`, `WorkerInfo` / `get_worker_info` and
`DataLoader` with no workers, thread workers or spawned process
workers. Batches are numpy arrays, as in JAX; `DataLoader(to_device=
...)` names a torch device, and each batch then goes through pinned
host memory to it with `non_blocking=True`, the copy made on the
consumer's thread only (a worker never touches the card).

The port keeps no global RNG state, so the random draws take an
explicit seed: a `RandomSampler(seed=s)` draws its e-th epoch from
`numpy.random.RandomState((s · 1000003 + e) mod 2^31)`, the law of the
JAX sampler after `paddle_tpu.seed(s)` with its epoch counter at e, so
one seed gives the same index order in both packages;
`WeightedRandomSampler` the same; `random_split` permutes with
`RandomState(seed)`; `DistributedBatchSampler` with `RandomState(epoch)`
as in JAX. A worker's `WorkerInfo.seed` is the loader's seed + its id.
`default_collate_fn` stacks a batch of arrays of 256 KiB or more
through the native parallel-memcpy collate (`native.collate_batch`,
`native/collate.cc`), smaller ones with `np.stack`, as JAX does.
"""
from __future__ import annotations

import itertools
import math
import queue
import threading
from collections import deque
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core import resolve_device

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "DataLoader", "default_collate_fn", "WorkerInfo",
           "get_worker_info"]


class Dataset:
    """Map-style dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        # TypeError, Python's "no len()": list() and friends then take
        # it as no length hint (the JAX package's RuntimeError breaks
        # list(dataset))
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        arrays = [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                  else np.asarray(t) for t in tensors]
        n = arrays[0].shape[0]
        if any(a.shape[0] != n for a in arrays):
            raise ValueError("all tensors must share dim 0")
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        if any(len(d) != n for d in self.datasets):
            raise ValueError("datasets must have equal length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, seed: int = 0):
    """Subsets of `lengths` over `RandomState(seed).permutation`."""
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.RandomState(seed).permutation(len(dataset))
    out, ofs = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + n].tolist()))
        ofs += n
    return out


# --------------------------------------------------------------------------- #
# samplers
# --------------------------------------------------------------------------- #


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class _EpochSeeds:
    """(seed · 1000003 + e) mod 2^31 for the e-th epoch, e = 0, 1, ..."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._epochs = itertools.count()

    def next_state(self) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed * 1000003 + next(self._epochs)) % (2 ** 31))


class RandomSampler(Sampler):
    """A permutation (or, with `replacement`, uniform draws) per epoch
    from the seed's epoch stream."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 seed: int = 0):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self._seeds = _EpochSeeds(seed)

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = self._seeds.next_state()
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True,
                 seed: int = 0):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self._seeds = _EpochSeeds(seed)

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = self._seeds.next_state().choice(
            len(self.weights), self.num_samples, replace=self.replacement,
            p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False, seed: int = 0):
        if sampler is None:
            sampler = RandomSampler(dataset, seed=seed) if shuffle else \
                SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batches: the indices (shuffled by
    `RandomState(epoch)`) padded to a multiple of the ranks, every
    `num_replicas`-th from `rank`. The ranks default to
    `torch.distributed`'s when it is initialised, else 1 and 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if up else 1
        if rank is None:
            rank = dist.get_rank() if up else 0
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas
        self.local_rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(indices)
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        batch = []
        for idx in indices[self.local_rank::self.nranks].tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# --------------------------------------------------------------------------- #
# collate & worker info
# --------------------------------------------------------------------------- #


def default_collate_fn(batch: List[Any]):
    """Stack a list of samples: arrays with `np.stack` (256 KiB or more
    through the native collate), numbers into an array, tuples / lists
    / dicts field by field, recursively (a CPU tensor as its numpy
    array)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([s.detach().cpu().numpy() for s in batch])
    if isinstance(sample, np.ndarray):
        if sample.nbytes * len(batch) >= (1 << 18):
            from .. import native
            return native.collate_batch(batch)
        return np.stack(batch)
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items))
                            for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return np.asarray(batch)


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info = threading.local()


def get_worker_info() -> Optional[WorkerInfo]:
    """The calling worker's `WorkerInfo`; None outside a worker."""
    return getattr(_worker_info, "info", None)


# --------------------------------------------------------------------------- #
# DataLoader
# --------------------------------------------------------------------------- #

_SENTINEL = object()


def _process_worker_loop(wid, dataset, collate_fn, worker_init_fn, in_q,
                         out_q, num_workers=0, base_seed=0):
    """A spawned worker: collate index batches until a None job comes.
    Module-level, so it pickles under the spawn start method."""
    _worker_info.info = WorkerInfo(wid, num_workers, dataset,
                                   base_seed + wid)
    if worker_init_fn is not None:
        worker_init_fn(wid)
    while True:
        job = in_q.get()
        if job is None:
            break
        seq, indices = job
        try:
            out_q.put((seq, collate_fn([dataset[i] for i in indices])))
        except Exception as e:  # noqa: BLE001 — handed to the consumer
            out_q.put((seq, e))


def _to_device(tree, dev: torch.device):
    """Every numpy array of a batch as a tensor on `dev`: pinned, then
    copied with non_blocking=True (the caching host allocator keeps the
    pinned buffer until the copy is done)."""
    if isinstance(tree, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(tree))
        if dev.type == "cpu":
            return t
        return t.pin_memory().to(dev, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    return tree


class DataLoader:
    """Batches of a dataset with background prefetch.

    `num_workers > 0` fetches batches on a thread pool (numpy and PIL
    release the GIL) or, with `use_process_workers`, on spawned
    processes (the dataset and `collate_fn` must pickle), in order
    either way; `prefetch_factor` batches per worker are staged ahead.
    `shuffle` draws from `RandomSampler(seed=seed)`. `to_device` (a
    torch device, or None for numpy batches) moves each batch on the
    consumer's thread."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=120,
                 worker_init_fn=None, persistent_workers=False,
                 use_process_workers=False, to_device=None, seed: int = 0):
        self.dataset = dataset
        self.is_iterable = isinstance(dataset, IterableDataset)
        self.seed = int(seed)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif not self.is_iterable:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last, seed=seed)
            self.batch_size = batch_size
        else:
            self.batch_sampler = None
            self.batch_size = batch_size
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_process_workers = use_process_workers
        self.device = None if to_device in (None, False) \
            else resolve_device(to_device)
        self.return_list = return_list

    def __len__(self):
        if self.is_iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    # --- iteration ----------------------------------------------------------
    def _fetch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _out(self, batch):
        return batch if self.device is None else _to_device(batch,
                                                           self.device)

    def __iter__(self):
        if self.is_iterable:
            src: Iterator = self._iter_iterable()
            if self.num_workers > 0:
                src = self._prefetch_thread(src)
        elif self.num_workers == 0:
            src = (self._fetch(ix) for ix in self.batch_sampler)
        elif self.use_process_workers:
            src = self._iter_processes()
        else:
            src = self._iter_threads()
        for b in src:
            yield self._out(b)

    def _prefetch_thread(self, src: Iterator):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)

        def feeder():
            try:
                for item in src:
                    q.put(item)
            finally:
                q.put(_SENTINEL)

        threading.Thread(target=feeder, daemon=True).start()
        while True:
            item = q.get(timeout=self.timeout)
            if item is _SENTINEL:
                break
            yield item

    def _iter_threads(self):
        from concurrent.futures import ThreadPoolExecutor
        batches = list(self.batch_sampler)
        wids = itertools.count()

        def init_worker():
            # a WorkerInfo per pool thread (thread-local), so per-worker
            # random streams (the vision transforms') differ
            wid = next(wids)
            _worker_info.info = WorkerInfo(wid, self.num_workers,
                                           self.dataset, self.seed + wid)

        with ThreadPoolExecutor(max_workers=self.num_workers,
                                initializer=init_worker) as pool:
            depth = self.num_workers * self.prefetch_factor
            fq: deque = deque()
            it = iter(batches)
            for _ in range(min(depth, len(batches))):
                fq.append(pool.submit(self._fetch, next(it)))
            while fq:
                fut = fq.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    fq.append(pool.submit(self._fetch, nxt))
                yield fut.result(timeout=self.timeout)

    def _iter_processes(self):
        import multiprocessing as mp
        # spawn, not fork: a forked child of a process that has touched
        # CUDA (or holds torch's thread pools) can deadlock
        ctx = mp.get_context("spawn")
        batches = list(self.batch_sampler)
        in_q = ctx.Queue()
        out_q = ctx.Queue(maxsize=self.num_workers * self.prefetch_factor)
        procs = [ctx.Process(
            target=_process_worker_loop,
            args=(w, self.dataset, self.collate_fn, self.worker_init_fn,
                  in_q, out_q, self.num_workers, self.seed), daemon=True)
            for w in range(self.num_workers)]
        for p in procs:
            p.start()
        try:
            for seq, indices in enumerate(batches):
                in_q.put((seq, indices))
            for _ in range(self.num_workers):
                in_q.put(None)
            pending = {}
            for next_seq in range(len(batches)):
                while next_seq not in pending:
                    seq, data = out_q.get(timeout=self.timeout)
                    pending[seq] = data
                data = pending.pop(next_seq)
                if isinstance(data, Exception):
                    raise data
                yield data
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join()
