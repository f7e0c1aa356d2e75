"""Port paged KV (`paddle_tpu_torch/serving/paged_kv.py` and the
engine's paged layout) against the JAX reference, and its invariants
inside the port.

- `PagePool` / `PagedKVCache` bookkeeping: the trash page is never
  allocated, refcounts free a page at zero, `max_seq % page_size` is
  checked, block tables fill with trash past a lane's pages.
- Cross-package: the port's paged engine (fp32, "masked") gives the JAX
  paged engine's greedy streams (`prefix_cache=False`) token for token
  on `gpt_tiny`, where the reference's top-2 logit margin is above 1e-3
  at every step.
- Inside the port, bitwise under "masked": paged ≡ slotted at every
  page size and block size; the paged ragged seam (plain K4 on CPU
  tensors) agrees; admission waits on pages (FIFO, never fails) and a
  run that mixes cancels and deadlines leaks no page.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.gpt import _decode_forward as jax_decode_forward
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.serving import (LLMEngine, NoFreePages, PagedKVCache,
                                      PagePool, SamplingParams)
from paddle_tpu_torch.serving.paged_kv import paged_rows
from port_threads import one_torch_thread  # noqa: F401


LENGTHS = (5, 13, 9, 21)


@pytest.fixture(scope="module")
def jax_model():
    pt.seed(0)
    m = jax_gpt_tiny()
    m.eval()
    return m


@pytest.fixture(scope="module")
def model(jax_model):
    np_params = {k: np.asarray(v)
                 for k, v in jax_model.raw_parameters().items()}
    return load_jax_params(gpt_tiny(device="cpu"), np_params)


def _prompts(lengths=LENGTHS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def _engine(model, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq", 64)
    return LLMEngine(model, device="cpu", **kw)


def _leaked(eng) -> int:
    """Pages held beyond the trash page once the prefix tree's
    (legitimate) holdings are released."""
    if eng.prefix is not None:
        eng.prefix.clear()
    return eng.cache.pool.leaked()


def _streams(model, prompts, sp, **kw):
    return [r.token_ids for r in _engine(model, **kw).generate(prompts, sp)]


# ---------------------------------------------------------------------- #
# bookkeeping
# ---------------------------------------------------------------------- #

class TestPagePool:
    def test_alloc_ref_unref_free(self):
        pool = PagePool(6, reserved=1)
        assert pool.num_free == 5 and pool.pages_used == 1
        pages = pool.alloc(3)
        assert len(set(pages)) == 3 and 0 not in pages
        assert pool.pages_used == 4
        pool.ref(pages[0])
        pool.unref(pages[0])
        assert pool.refcount(pages[0]) == 1   # still held
        pool.unref(pages[0])
        assert pool.num_free == 3             # freed at zero
        with pytest.raises(ValueError):
            pool.unref(pages[0])              # double free
        with pytest.raises(ValueError):
            pool.ref(pages[0])                # ref of a free page
        with pytest.raises(NoFreePages):
            pool.alloc(4)
        assert pool.peak_used == 4
        pool.unref(pages[1])
        pool.unref(pages[2])
        assert pool.leaked() == 0

    def test_trash_page_reserved_forever(self):
        pool = PagePool(4)
        got = pool.alloc(3)
        assert 0 not in got and pool.refcount(0) == 1
        with pytest.raises(NoFreePages):
            pool.alloc(1)
        with pytest.raises(ValueError):
            pool.unref(0)
        with pytest.raises(ValueError):
            PagePool(1)


class TestPagedKVCache:
    def test_lane_binding_and_release(self):
        c = PagedKVCache(1, 2, 64, 2, 4, page_size=16, num_pages=9,
                         device="cpu")
        s = c.allocate()
        owned = c.pool.alloc(2)
        c.bind_owned(s, owned)
        more = c.pool.alloc(1)
        c.bind_owned(s, more)
        c.pool.ref(more[0])                 # a second holder
        assert c.lane_pages(s) == owned + more
        assert list(c.block_tables[s, :3]) == owned + more
        assert c.block_tables[s, 3] == 0    # trash filler
        assert c.pool.refcount(more[0]) == 2
        c.release(s)
        assert c.pool.refcount(more[0]) == 1     # the other holder
        assert not c.block_tables[s].any()
        c.pool.unref(more[0])
        assert c.pool.leaked() == 0

    def test_reset_length_drops_the_lane_pages(self):
        c = PagedKVCache(1, 2, 64, 2, 4, page_size=16, device="cpu")
        s = c.allocate()
        c.bind_owned(s, c.pool.alloc(3))
        c.advance(s, 40)
        c.reset_length(s)
        assert c.length(s) == 0 and c.lane_page_count(s) == 0
        assert c.pool.leaked() == 0
        with pytest.raises(ValueError, match="pages_per_seq"):
            c.bind_owned(s, c.pool.alloc(5))

    def test_page_size_must_divide_max_seq(self):
        with pytest.raises(ValueError, match="multiple"):
            PagedKVCache(1, 2, 60, 2, 4, page_size=16, device="cpu")
        with pytest.raises(ValueError, match="one sequence"):
            PagedKVCache(1, 2, 64, 2, 4, page_size=16, num_pages=4,
                         device="cpu")

    def test_span_pages_default_pool_and_bytes(self):
        c = PagedKVCache(2, 3, 64, 2, 4, page_size=16, device="cpu",
                         kv_dtype="int8")
        assert (c.span_pages(1), c.span_pages(16), c.span_pages(17)) == \
            (1, 1, 2)
        assert c.num_pages == 2 * 3 * 4 + 1
        assert c.k[0]["q"].shape == (25, 16, 2, 4)
        assert c.k[0]["s"].shape == (25, 16, 2)
        assert c.bytes_per_token() == 2 * 2 * 2 * (4 + 4)

    def test_paged_rows_park_frozen_lanes_on_the_trash_page(self):
        tables = torch.tensor([[3, 5, 0, 0], [7, 2, 9, 0]],
                              dtype=torch.int32)
        pos = torch.tensor([17, 40])
        pids, offs = paged_rows(tables, pos, 16)
        assert pids.tolist() == [5, 9] and offs.tolist() == [1, 8]
        pids, offs = paged_rows(tables, pos, 16,
                                live=torch.tensor([True, False]))
        assert pids.tolist() == [5, 0] and offs.tolist() == [1, 8]
        pids, offs = paged_rows(tables[1], torch.arange(30, 35), 16)
        assert pids.tolist() == [2, 2, 9, 9, 9]


# ---------------------------------------------------------------------- #
# the engine against the JAX engine
# ---------------------------------------------------------------------- #

def test_paged_greedy_streams_match_jax_engine(jax_model, model):
    prompts = _prompts(seed=4)
    base = dict(max_slots=4, max_seq=64, decode_block_size=4,
                attend_impl="masked", kv_layout="paged", page_size=8)
    jeng = JaxEngine(jax_model, seed=1, prefix_cache=False,
                     register_stats=False, **base)
    want = [r.token_ids for r in jeng.generate(
        prompts, JaxParams(max_new_tokens=12))]
    cfg = jax_model.cfg
    params = jax_model.raw_parameters()
    for p, toks in zip(prompts, want):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])[None]
        jk = jnp.zeros((cfg.num_layers, 1, seq.shape[1], cfg.num_heads,
                        cfg.hidden_size // cfg.num_heads))
        lg, _, _ = jax_decode_forward(cfg, params, jnp.asarray(seq), 0, jk,
                                      jnp.zeros_like(jk))
        top2 = np.sort(np.asarray(lg)[0, len(p) - 1:], axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        assert margin.min() > 1e-3, f"near-tie in the reference: {margin}"
    got = _streams(model, prompts, SamplingParams(max_new_tokens=12), **base)
    assert got == want


# ---------------------------------------------------------------------- #
# paged ≡ slotted, bitwise, inside the port
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def slotted_streams(model):
    return _streams(model, _prompts(), SamplingParams(max_new_tokens=12),
                    decode_block_size=4)


@pytest.mark.parametrize("page_size,block", [(8, 1), (8, 4), (16, 8),
                                             (64, 4)])
def test_paged_equals_slotted_bitwise(model, slotted_streams, page_size,
                                      block):
    eng = _engine(model, kv_layout="paged", page_size=page_size,
                  decode_block_size=block)
    got = [r.token_ids for r in eng.generate(
        _prompts(), SamplingParams(max_new_tokens=12))]
    assert got == slotted_streams
    assert _leaked(eng) == 0


def test_paged_sampled_streams_equal_slotted(model):
    sps = [SamplingParams(max_new_tokens=10, temperature=0.9),
           SamplingParams(max_new_tokens=10, temperature=1.1, top_k=20),
           SamplingParams(max_new_tokens=10, temperature=0.8, top_p=0.7),
           SamplingParams(max_new_tokens=10)]
    want = _streams(model, _prompts(seed=5), sps, seed=11)
    got = _streams(model, _prompts(seed=5), sps, seed=11, kv_layout="paged",
                   page_size=16)
    assert got == want


def test_paged_ragged_plain_kernel_agrees(model, slotted_streams):
    eng = _engine(model, kv_layout="paged", attend_impl="ragged",
                  decode_block_size=4)
    assert eng.page_size == 64 and eng.kv_pages == 2 * 4 * 1 + 1
    got = [r.token_ids for r in eng.generate(
        _prompts(), SamplingParams(max_new_tokens=12))]
    assert got == slotted_streams


def test_page_size_default_and_knob_checks(model):
    assert _engine(model, kv_layout="paged", max_seq=48).page_size == 16
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        _engine(model, page_size=16)
    with pytest.raises(ValueError, match="kv_layout"):
        _engine(model, kv_layout="ring")
    # the paged prefix cache is on by default: its chunk is the page
    eng = _engine(model, kv_layout="paged", page_size=16)
    assert eng.prefix is not None and eng.prefix_block == 16
    assert eng.prefix.allocator.pool is eng.cache.pool


# ---------------------------------------------------------------------- #
# admission under page pressure, and zero leaks
# ---------------------------------------------------------------------- #

def test_admission_waits_on_pages_fifo(model):
    """A pool of 6 pages (5 usable) holds one 3-page span at a time
    while lanes are free (no prefix tree holding pages beside them):
    admission waits, in order, and every request still gives its
    slotted stream."""
    prompts = _prompts((30, 30, 30))
    sp = SamplingParams(max_new_tokens=8)       # span 38 rows -> 3 pages
    eng = _engine(model, kv_layout="paged", page_size=16, kv_pages=6,
                  decode_block_size=2, prefix_cache=False)
    rids = [eng.submit(p, sp) for p in prompts]
    eng.step()
    assert eng.cache.num_active == 1 and len(eng._queue) == 2
    st = eng.stats()
    assert st["kv_pages_used"] == 1 + 3 and st["kv_pages_total"] == 6
    admitted = []
    while eng.has_work():
        admitted += [r.rid for r in eng._active.values()
                     if r.rid not in admitted]
        eng.step()
    assert admitted == rids                      # FIFO
    want = _streams(model, prompts, sp)
    assert [eng.result(r).token_ids for r in rids] == want
    assert _leaked(eng) == 0
    assert eng.stats()["kv_pages_peak"] == 4


def test_no_free_pages_mid_admission_requeues(model, monkeypatch):
    """If allocation fails after the gate (the pool changed under it),
    the request goes back to the queue head once its admission retries
    are spent (none here) and admits later; it never finishes with an
    error."""
    eng = _engine(model, max_slots=2, kv_layout="paged", page_size=16,
                  max_retries=0)
    real = LLMEngine._alloc_pages
    blown = {"n": 0}

    def flaky(self, n):
        if blown["n"] < 2:
            blown["n"] += 1
            raise NoFreePages("simulated")
        return real(self, n)

    monkeypatch.setattr(LLMEngine, "_alloc_pages", flaky)
    rid = eng.submit(_prompts((12,))[0], SamplingParams(max_new_tokens=4))
    eng.step()
    assert len(eng._queue) == 1 and not eng._active
    while eng.has_work():
        eng.step()
    assert eng.result(rid).finish_reason == "length"
    assert _leaked(eng) == 0 and eng.cache.num_free == 2


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_zero_leaked_pages_after_cancels_and_deadlines(model, kv_dtype):
    eng = _engine(model, max_slots=3, kv_layout="paged", page_size=8,
                  kv_pages=14, decode_block_size=2, kv_dtype=kv_dtype)
    prompts = _prompts((5, 13, 9, 21, 30, 7, 16, 11), seed=9)
    rids = []
    for i, p in enumerate(prompts):
        sp = SamplingParams(max_new_tokens=12 + i,
                            deadline_s=1e-9 if i == 5 else None)
        rids.append(eng.submit(p, sp))
    eng.step()
    assert eng.cancel(rids[0])              # generating
    assert eng.cancel(rids[7])              # still queued
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        if steps == 3:
            live = [r.rid for r in eng._active.values()
                    if r.finish_reason is None]
            assert eng.cancel(live[0])
    reasons = [eng.result(r).finish_reason for r in rids]
    assert reasons.count("cancelled") == 3
    assert reasons[5] == "deadline" and reasons.count("length") == 4
    # only the prefix tree holds pages now, beside the trash page
    assert eng.stats()["kv_pages_used"] == 1 + eng.prefix.pages_used
    assert _leaked(eng) == 0
    assert eng.cache.num_free == 3
