"""The port's data pipeline against the JAX package's: samplers,
datasets, transforms, collate, the DataLoader's workers, `Accuracy` and
the ips timer.

Bit for bit for one seed: a `RandomSampler(seed=s)` gives the index
order JAX's gives after `paddle_tpu.seed(s)` (epoch by epoch), as do
`WeightedRandomSampler`, `random_split` and `DistributedBatchSampler`;
the synthetic `Cifar10` / `Cifar100` / `MNIST` / `FashionMNIST` arrays
and the CIFAR tar and MNIST idx readers give JAX's arrays; a random
transform seeded `s` in worker w draws what JAX's draws after
`paddle_tpu.seed(s)` in worker w (a `SeededRandom` shared by a Compose
is JAX's one module-level stream); the DataLoader gives the same batches
in the same order with no workers, with thread workers and with two
spawned process workers, and JAX's DataLoader gives them too.
"""
import gzip
import io as _io
import itertools
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import metric as pmetric
from paddle_tpu_torch import profiler
from paddle_tpu_torch.vision import datasets as pds
from paddle_tpu_torch.vision import transforms as PT
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def jax_seed(monkeypatch):
    """paddle_tpu.seed(s) with the JAX sampler's epoch counter at 0."""
    def seed(s):
        pt.seed(s)
        monkeypatch.setattr(jio, "_epoch_counter", itertools.count())
    yield seed
    pt.seed(0)


@pytest.fixture
def synthetic():
    jds.set_synthetic_fallback(True)
    pds.set_synthetic_fallback(True)
    yield
    jds._SYNTHETIC = None
    pds._SYNTHETIC = None


# --------------------------------------------------------------------------- #
# samplers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 7, 123456])
@pytest.mark.parametrize("replacement,num", [(False, None), (True, 50),
                                             (False, 20)])
def test_random_sampler_order_equals_jax(jax_seed, seed, replacement, num):
    data = list(range(37))
    jax_seed(seed)
    js = jio.RandomSampler(data, replacement=replacement, num_samples=num)
    want = [list(js) for _ in range(3)]              # three epochs
    ps = pio.RandomSampler(data, replacement=replacement, num_samples=num,
                           seed=seed)
    assert [list(ps) for _ in range(3)] == want
    assert len(ps) == len(js)


@pytest.mark.parametrize("replacement,num", [(True, 30), (False, 15)])
def test_weighted_sampler_equals_jax(jax_seed, replacement, num):
    w = np.random.RandomState(0).rand(20)
    jax_seed(5)
    js = jio.WeightedRandomSampler(w, num, replacement=replacement)
    want = [list(js) for _ in range(2)]
    ps = pio.WeightedRandomSampler(w, num, replacement=replacement, seed=5)
    assert [list(ps) for _ in range(2)] == want


def test_random_split_equals_jax(jax_seed):
    data = list(range(25))
    jax_seed(3)
    want = [list(s) for s in jio.random_split(data, [10, 15])]
    got = [list(s) for s in pio.random_split(data, [10, 15], seed=3)]
    assert got == want
    with pytest.raises(ValueError):
        pio.random_split(data, [3, 4])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_and_distributed_samplers_equal_jax(jax_seed, shuffle,
                                                  drop_last):
    data = list(range(23))
    jax_seed(0)
    want = list(jio.BatchSampler(data, shuffle=shuffle, batch_size=4,
                                 drop_last=drop_last))
    got = list(pio.BatchSampler(data, shuffle=shuffle, batch_size=4,
                                drop_last=drop_last, seed=0))
    assert got == want
    for rank in range(3):
        js = jio.DistributedBatchSampler(data, 4, num_replicas=3, rank=rank,
                                         shuffle=shuffle, drop_last=drop_last)
        ps = pio.DistributedBatchSampler(data, 4, num_replicas=3, rank=rank,
                                         shuffle=shuffle, drop_last=drop_last)
        js.set_epoch(2)
        ps.set_epoch(2)
        assert list(ps) == list(js) and len(ps) == len(js)
    assert pio.DistributedBatchSampler(data, 4).nranks == 1


# --------------------------------------------------------------------------- #
# datasets
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["Cifar10", "Cifar100", "MNIST",
                                  "FashionMNIST"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_datasets_equal_jax(synthetic, name, mode):
    j, p = getattr(jds, name)(mode=mode), getattr(pds, name)(mode=mode)
    assert np.array_equal(p.images, j.images)
    assert np.array_equal(p.labels, j.labels)
    assert len(p) == len(j)
    for i in (0, len(p) - 1):
        (pi, pl), (ji, jl) = p[i], j[i]
        assert np.array_equal(pi, ji) and pl == jl and pl.dtype == np.int64


def test_missing_files_raise_without_the_fallback(monkeypatch):
    monkeypatch.delenv("PTPU_SYNTHETIC_DATA", raising=False)
    pds._SYNTHETIC = None
    with pytest.raises(FileNotFoundError, match="synthetic"):
        pds.Cifar10(data_file="/nonexistent/cifar.tar.gz")
    with pytest.raises(FileNotFoundError):
        pds.MNIST()
    monkeypatch.setenv("PTPU_SYNTHETIC_DATA", "1")
    assert len(pds.MNIST(mode="test")) == 256
    with pytest.raises(ValueError):
        pds.Cifar10(mode="valid")


def test_cifar_tar_reader_equals_jax(tmp_path):
    rs = np.random.RandomState(0)
    path = tmp_path / "cifar-10-python.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        for name, n in (("data_batch_1", 6), ("data_batch_2", 4),
                        ("test_batch", 5)):
            blob = pickle.dumps({b"data": rs.randint(0, 256, (n, 3072),
                                                     dtype=np.uint8),
                                 b"labels": rs.randint(0, 10, n).tolist()})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, _io.BytesIO(blob))
    for mode, n in (("train", 10), ("test", 5)):
        j = jds.Cifar10(data_file=str(path), mode=mode)
        p = pds.Cifar10(data_file=str(path), mode=mode)
        assert p.images.shape == (n, 32, 32, 3)
        assert np.array_equal(p.images, j.images)
        assert np.array_equal(p.labels, j.labels)


def test_mnist_idx_reader_equals_jax(tmp_path):
    rs = np.random.RandomState(1)
    imgs = rs.randint(0, 256, (7, 28, 28), dtype=np.uint8)
    labels = rs.randint(0, 10, 7).astype(np.uint8)
    ip, lp = tmp_path / "img.gz", tmp_path / "lab.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 7, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 7) + labels.tobytes())
    j = jds.MNIST(image_path=str(ip), label_path=str(lp))
    p = pds.MNIST(image_path=str(ip), label_path=str(lp))
    assert np.array_equal(p.images, j.images) and p.images.shape == \
        (7, 28, 28, 1)
    assert np.array_equal(p.labels, j.labels)
    with pytest.raises(ValueError, match="label_path"):
        pds.MNIST(image_path=str(ip), label_path=str(tmp_path / "none"))


def test_dataset_classes_equal_jax():
    a = np.arange(12).reshape(6, 2)
    b = np.arange(6) * 10
    jt, ptd = jio.TensorDataset([a, b]), pio.TensorDataset([a, b])
    assert len(ptd) == 6 and all(
        np.array_equal(x, y) for x, y in zip(ptd[4], jt[4]))
    assert pio.TensorDataset([torch.from_numpy(a)])[1][0].tolist() == [2, 3]
    with pytest.raises(ValueError):
        pio.TensorDataset([a, b[:3]])
    jc = jio.ComposeDataset([jt, jio.TensorDataset([b])])
    pc = pio.ComposeDataset([ptd, pio.TensorDataset([b])])
    assert [np.asarray(x).tolist() for x in pc[2]] == \
        [np.asarray(x).tolist() for x in jc[2]]
    cat = pio.ConcatDataset([ptd, pio.Subset(ptd, [5, 0])])
    jcat = jio.ConcatDataset([jt, jio.Subset(jt, [5, 0])])
    assert len(cat) == len(jcat) == 8
    for i in (0, 6, 7, -1):
        assert [np.asarray(x).tolist() for x in cat[i]] == \
            [np.asarray(x).tolist() for x in jcat[i]]

    class It(pio.IterableDataset):
        def __iter__(self):
            return iter(range(3))

    assert list(pio.ChainDataset([It(), It()])) == [0, 1, 2, 0, 1, 2]
    with pytest.raises(TypeError):
        len(It())


# --------------------------------------------------------------------------- #
# transforms
# --------------------------------------------------------------------------- #

def _imgs(n=6):
    return np.random.RandomState(2).randint(0, 256, (n, 12, 10, 3),
                                            dtype=np.uint8)


@pytest.mark.parametrize("worker", [None, 0, 3])
@pytest.mark.parametrize("seed", [0, 11])
def test_random_transforms_draw_as_jax(seed, worker):
    """One seed and worker: RandomHorizontalFlip alone, and a Compose
    of RandomCrop(padding) + flip sharing one stream, give JAX's
    images."""
    imgs = _imgs()
    if worker is not None:
        jio._worker_info.info = jio.WorkerInfo(worker, 4, None, 0)
        pio._worker_info.info = pio.WorkerInfo(worker, 4, None, 0)
    try:
        pt.seed(seed)
        jflip = JT.RandomHorizontalFlip()
        want = [jflip(a) for a in imgs]
        pflip = PT.RandomHorizontalFlip(seed=seed)
        got = [pflip(a) for a in imgs]
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        pt.seed(seed)
        jc = JT.Compose([JT.RandomCrop(10, padding=2), JT.RandomHorizontalFlip(
            prob=0.3)])
        want = [jc(a) for a in imgs]
        r = PT.SeededRandom(seed)
        pc = PT.Compose([PT.RandomCrop(10, padding=2, seed=r),
                         PT.RandomHorizontalFlip(prob=0.3, seed=r)])
        got = [pc(a) for a in imgs]
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    finally:
        jio._worker_info.info = None
        pio._worker_info.info = None
        pt.seed(0)


def test_deterministic_transforms_equal_jax():
    img = _imgs(1)[0]
    pairs = [
        (JT.ToTensor(), PT.ToTensor()),
        (JT.ToTensor(data_format="HWC"), PT.ToTensor(data_format="HWC")),
        (JT.Normalize([125.3, 123.0, 113.9], [63.0, 62.1, 66.7], "HWC"),
         PT.Normalize([125.3, 123.0, 113.9], [63.0, 62.1, 66.7], "HWC")),
        (JT.Transpose(), PT.Transpose()),
        (JT.Pad(3, fill=7), PT.Pad(3, fill=7)),
        (JT.Pad((1, 2, 3, 4), padding_mode="reflect"),
         PT.Pad((1, 2, 3, 4), padding_mode="reflect")),
        (JT.CenterCrop(8), PT.CenterCrop(8)),
        (JT.Resize((20, 16)), PT.Resize((20, 16))),
        (JT.Resize(6, interpolation="nearest"),
         PT.Resize(6, interpolation="nearest")),
        (JT.Compose([JT.Normalize(0.5, 2.0, "HWC"), JT.Transpose()]),
         PT.Compose([PT.Normalize(0.5, 2.0, "HWC"), PT.Transpose()])),
    ]
    for j, p in pairs:
        w, g = j(img), p(img)
        assert g.dtype == w.dtype and np.array_equal(g, w), repr(p)
    out = PT.Transpose()((img, np.int64(3)))       # (image, label) pairs
    assert out[1] == 3 and out[0].shape == (3, 12, 10)


def test_seeded_random_pickles_without_its_streams():
    r = PT.SeededRandom(4)
    first = r.random()
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.seed == 4 and r2.random() == first


# --------------------------------------------------------------------------- #
# collate and the DataLoader
# --------------------------------------------------------------------------- #

def test_default_collate_nested_equals_jax():
    rs = np.random.RandomState(0)
    batch = [{"img": rs.rand(2, 3).astype(np.float32),
              "meta": (np.int64(i), [float(i), rs.rand(2)]),
              "id": i} for i in range(4)]
    want = jio.default_collate_fn(batch)
    got = pio.default_collate_fn(batch)

    def same(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            return all(same(a[k], b[k]) for k in b)
        if isinstance(b, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            return all(same(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b) and np.asarray(a).dtype == \
            np.asarray(b).dtype

    assert same(got, want)
    t = pio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert isinstance(t, np.ndarray) and t.shape == (2, 2)


def _cifar_tail(n=40):
    return pio.Subset(pds.Cifar10(mode="test", transform=PT.Compose([
        PT.Normalize([125.3, 123.0, 113.9], [63.0, 62.1, 66.7], "HWC"),
        PT.Transpose()])), list(range(n)))


def _batches(loader):
    return [tuple(np.array(t) for t in b) for b in loader]


def test_dataloader_workers_give_the_same_batches(synthetic):
    """No workers, 3 threads and 2 spawned processes: the same batches
    in order; shuffled with one seed, JAX's loader gives them too."""
    ds = _cifar_tail()
    base = _batches(pio.DataLoader(ds, batch_size=8))
    assert len(base) == 5 and base[0][0].shape == (8, 3, 32, 32)
    for kw in (dict(num_workers=3), dict(num_workers=2,
                                         use_process_workers=True)):
        got = _batches(pio.DataLoader(ds, batch_size=8, **kw))
        assert len(got) == len(base)
        for g, b in zip(got, base):
            assert all(np.array_equal(x, y) for x, y in zip(g, b)), kw
    jds_ = jio.Subset(jds.Cifar10(mode="test", transform=JT.Compose([
        JT.Normalize([125.3, 123.0, 113.9], [63.0, 62.1, 66.7], "HWC"),
        JT.Transpose()])), list(range(40)))
    pt.seed(9)
    jio._epoch_counter = itertools.count()
    want = _batches(jio.DataLoader(jds_, batch_size=8, shuffle=True))
    got = _batches(pio.DataLoader(ds, batch_size=8, shuffle=True, seed=9))
    for g, w in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(g, w))
    pt.seed(0)


def test_worker_info_and_iterable_prefetch():
    seen = []

    class Probe(pio.Dataset):
        def __getitem__(self, i):
            info = pio.get_worker_info()
            seen.append((info.id, info.seed, info.num_workers))
            return np.float32(i)

        def __len__(self):
            return 12

    batches = list(pio.DataLoader(Probe(), batch_size=3, num_workers=2,
                                  seed=40))
    assert [b.tolist() for b in batches] == [[0, 1, 2], [3, 4, 5],
                                             [6, 7, 8], [9, 10, 11]]
    assert {s for _, s, _ in seen} <= {40, 41} and {n for *_, n in seen} \
        == {2}
    assert pio.get_worker_info() is None

    class Stream(pio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(7, dtype=np.float32))

    for w in (0, 2):
        got = [b.tolist() for b in pio.DataLoader(Stream(), batch_size=3,
                                                  num_workers=w)]
        assert got == [[0, 1, 2], [3, 4, 5], [6]]
    with pytest.raises(TypeError):
        len(pio.DataLoader(Stream()))


def test_to_device_moves_batches_and_refuses_a_missing_card(monkeypatch):
    ds = pio.TensorDataset([np.arange(10, dtype=np.float32), np.arange(10)])
    out = list(pio.DataLoader(ds, batch_size=4, to_device="cpu"))
    assert all(isinstance(t, torch.Tensor) for b in out for t in b)
    assert out[-1][1].tolist() == [8, 9]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pio.DataLoader(ds, to_device="cuda")


def test_worker_errors_reach_the_consumer():
    class Bad(pio.Dataset):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("sample 5")
            return np.float32(i)

        def __len__(self):
            return 8

    for kw in ({}, {"num_workers": 2}):
        with pytest.raises(KeyError, match="sample 5"):
            list(pio.DataLoader(Bad(), batch_size=2, **kw))


# --------------------------------------------------------------------------- #
# metric and the timer
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("topk", [1, (1, 3), (2, 5)])
@pytest.mark.parametrize("labels", ["ids", "column", "onehot"])
def test_accuracy_equals_jax(topk, labels):
    rs = np.random.RandomState(0)
    jm, pm = jmetric.Accuracy(topk=topk), pmetric.Accuracy(topk=topk)
    for step in range(3):
        pred = rs.randn(16, 10).astype(np.float32)
        ids = rs.randint(0, 10, 16)
        lab = {"ids": ids, "column": ids[:, None],
               "onehot": np.eye(10, dtype=np.float32)[ids]}[labels]
        want = jm.update(jm.compute(pred, lab))
        got = pm.update(pm.compute(torch.from_numpy(pred).bfloat16().float(),
                                   torch.from_numpy(lab)))
        np.testing.assert_array_equal(got, want)
    assert pm.accumulate() == jm.accumulate()
    assert pm.name() == jm.name()
    pm.reset()
    assert np.all(pm.count == 0)


def test_accuracy_takes_bf16_device_tensors():
    m = pmetric.Accuracy()
    pred = torch.tensor([[0.1, 2.0], [3.0, 0.5]], dtype=torch.bfloat16)
    assert m.update(m.compute(pred, torch.tensor([1, 1]))) == 0.5


def test_benchmark_skips_warmup_and_counts_samples(monkeypatch):
    clock = iter([0.0, 1.0, 3.0, 3.5, 4.0, 4.5, 10.0, 11.0])
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: next(clock))
    b = profiler.Benchmark(skip_steps=2)
    b.begin()                       # t = 0
    for _ in range(5):              # steps end at 1, 3, 3.5, 4, 4.5
        b.step(8)
    rep = b.report()
    assert rep["steps"] == 3 and rep["avg_step_s"] == pytest.approx(0.5)
    assert rep["ips"] == pytest.approx(16.0)
    b.pause()
    b.step(8)                       # re-baselines at 10: not counted
    b.step(8)                       # 11 - 10 = 1 s
    assert b.report()["steps"] == 4 and b.active
    b.end()
    assert not b.active and profiler.benchmark() is profiler.benchmark()
