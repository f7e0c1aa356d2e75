"""The port's host sparse table (`paddle_tpu_torch.ps`) against the JAX
package's (`paddle_tpu.ps`), the store behind the fleet KV tier.

- Pulled rows (the lazy deterministic init) equal the JAX table's bit for
  bit, native against native and `_PyTable` against `_PyTable`; pushes
  under SGD and Adagrad (duplicate ids included) agree within 1 ulp of
  fp32.
- The byte-blob API round-trips random bytes exactly, NaN bit patterns
  included, through RAM, the disk tier and a shrinking rewrite, and
  reads back what the JAX table stores for the same key.
- Erase, CTR shrink, spill / fault-in and save / load keep the JAX
  table's rows; a JAX table's snapshot file loads into the port's.
- The native library builds from the port's own source into
  `paddle_tpu_torch/_build/`, is counted once in `_build.BUILDS`, and
  `PTPU_NO_NATIVE` turns it off.
"""
import numpy as np
import pytest

import paddle_tpu.ps as jps
import paddle_tpu_torch.ps as tps
from paddle_tpu_torch import native
from paddle_tpu_torch.ops_cuda import _build

from port_threads import one_torch_thread  # noqa: F401 — autouse fixture

IDS = np.array([3, -7, 5, 2 ** 40 + 11, 0, 5, 123456789], np.int64)


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    """Both packages on the same backend: their C++ libraries, or both
    forced onto the numpy twin."""
    if request.param == "numpy":
        monkeypatch.setattr(tps, "_load_lib", lambda: None)
        monkeypatch.setattr(jps, "_load_lib", lambda: None)
    else:
        assert tps.native_available() and jps.native_available()
    return request.param


def _pair(**kw):
    return tps.SparseTable(**kw), jps.SparseTable(**kw)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dim", [1, 8, 33])
def test_pulled_rows_bitwise(backend, dim):
    a, b = _pair(embedding_dim=dim, init_std=0.02, seed=11)
    assert (a._py is None) == (backend == "native")
    np.testing.assert_array_equal(_bits(a.pull(IDS)), _bits(b.pull(IDS)))
    # any id shape, rows appear on first touch
    ids2 = IDS.reshape(7, 1)[:6].reshape(2, 3)
    assert a.pull(ids2).shape == (2, 3, dim)
    np.testing.assert_array_equal(_bits(a.pull(ids2)), _bits(b.pull(ids2)))
    assert len(a) == len(b)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_push_within_one_ulp(backend, optimizer):
    a, b = _pair(embedding_dim=16, optimizer=optimizer, seed=3,
                 learning_rate=0.1)
    rng = np.random.RandomState(0)
    for step in range(4):
        g = rng.randn(IDS.size, 16).astype(np.float32)
        lr = None if step % 2 else 0.03
        a.push(IDS, g, learning_rate=lr)
        b.push(IDS, g, learning_rate=lr)
        np.testing.assert_array_max_ulp(a.pull(IDS), b.pull(IDS), maxulp=1)


def _nan_bytes(rng, n):
    """Random bytes with quiet and signalling NaN, -0.0 and inf bit
    patterns spliced in (a blob must never pass through float math)."""
    words = rng.randint(0, 2 ** 32, n // 4, dtype=np.uint64).astype(
        np.uint32)
    words[::5] = 0x7FC00001           # quiet NaN with a payload
    words[1::7] = 0x7F800001          # signalling NaN
    words[2::11] = 0xFFFFFFFF         # NaN, all ones
    words[3::13] = 0x80000000         # -0.0
    words[4::17] = 0x7F800000         # inf
    return words.tobytes() + rng.bytes(n % 4)


def test_blob_round_trip(backend, tmp_path):
    rng = np.random.RandomState(1)
    a = tps.SparseTable(64, optimizer="sgd", spill_dir=str(tmp_path / "a"))
    b = jps.SparseTable(64, optimizer="sgd", spill_dir=str(tmp_path / "b"))
    blobs = {7: _nan_bytes(rng, 5001), -3: _nan_bytes(rng, 512),
             2 ** 50: b"", 9: rng.bytes(1)}
    for key, data in blobs.items():
        assert a.put_bytes(key, data) == len(data) == b.put_bytes(key, data)
    assert a.blob_count == b.blob_count == len(blobs)
    for key, data in blobs.items():
        assert a.get_bytes(key) == data == b.get_bytes(key)
    # the disk tier: spilled rows fault back on the next read
    assert a.spill_bytes(7) == b.spill_bytes(7) > 0
    assert a.spilled_rows == b.spilled_rows
    assert a.get_bytes(7) == blobs[7] and a.spilled_rows == 0
    # a shorter rewrite drops the leftover rows, a delete the rest
    short = _nan_bytes(rng, 100)
    a.put_bytes(7, short)
    b.put_bytes(7, short)
    assert a.get_bytes(7) == short == b.get_bytes(7)
    assert len(a) == len(b)
    assert a.delete_bytes(-3) and not a.delete_bytes(-3)
    assert a.get_bytes(-3) is None and a.blob_count == len(blobs) - 1


def test_erase_shrink_spill_save_load(backend, tmp_path):
    kw = dict(embedding_dim=6, optimizer="adagrad", seed=5)
    a = tps.SparseTable(**kw, spill_dir=str(tmp_path / "a"),
                        accessor=tps.CtrAccessor(delete_threshold=0.5))
    b = jps.SparseTable(**kw, spill_dir=str(tmp_path / "b"),
                        accessor=jps.CtrAccessor(delete_threshold=0.5))
    g = np.random.RandomState(2).randn(IDS.size, 6).astype(np.float32)
    for t in (a, b):
        t.push(IDS, g)
        t.push_show_click(IDS[:3], shows=[1.0, 4.0, 0.5], clicks=[0, 1, 0])
        t.spill_rows(IDS[3:5])
        t.erase(IDS[5:6])
    assert a.spilled_rows == b.spilled_rows == 2
    assert a.shrink() == b.shrink()
    np.testing.assert_array_max_ulp(a.pull(IDS), b.pull(IDS), maxulp=1)
    # a save covers the spilled rows; the JAX table's file loads here
    a.spill_rows(IDS[:2])
    b.spill_rows(IDS[:2])
    a.save(str(tmp_path / "a.tbl"))
    b.save(str(tmp_path / "b.tbl"))
    for path in ("a.tbl", "b.tbl"):
        c = tps.SparseTable(**kw).load(str(tmp_path / path))
        assert len(c) == len(a) + a.spilled_rows
        np.testing.assert_array_max_ulp(c.pull(IDS), b.pull(IDS),
                                        maxulp=1)
    with pytest.raises(ValueError, match="dim"):
        tps.SparseTable(7).load(str(tmp_path / "b.tbl"))


def test_shard_owner_and_validation():
    ids = np.arange(-50, 50, dtype=np.int64) * 7919
    for world in (1, 3, 8):
        np.testing.assert_array_equal(tps.shard_owner(ids, world),
                                      jps.shard_owner(ids, world))
    with pytest.raises(ValueError, match="optimizer"):
        tps.SparseTable(4, optimizer="adam")
    with pytest.raises(ValueError, match="CtrAccessor"):
        tps.SparseTable(4).shrink()


def test_native_build_is_the_ports_own(monkeypatch):
    assert tps.native_available()
    path = native.host_library_path("ps_table")
    assert path.exists()
    assert path.parent == _build.BUILD_DIR
    assert "paddle_tpu_torch" in path.parts
    assert _build.BUILDS.get("ps_table", 0) <= 1   # one build per process
    # the opt-out: a fresh loader returns None and the table runs numpy
    monkeypatch.setenv("PTPU_NO_NATIVE", "1")
    assert native.lazy_host_loader("ps_table")() is None
    with pytest.raises(ValueError, match="unknown host source"):
        native.lazy_host_loader("graph_table")


def test_watchdog_budgets_the_native_build(monkeypatch):
    from paddle_tpu_torch.models import gpt_tiny
    from paddle_tpu_torch.serving import LLMEngine
    eng = LLMEngine(gpt_tiny(device="cpu"), max_slots=2, max_seq=32,
                    device="cpu", register_stats=False)
    monkeypatch.setitem(_build.BUILDS, "ps_table", 1)
    counts = eng.watchdog.counts()
    assert counts["native_build"] == {"programs": 1, "compiles": 1,
                                      "retraces": 0, "budget": 1}
    assert counts["kernel_build"]["budget"] == len(_build.kernel_names())
    assert eng.watchdog.compiles_unexpected == 0
    monkeypatch.setitem(_build.BUILDS, "ps_table", 2)  # a second build
    assert eng.watchdog.compiles_unexpected == 1
