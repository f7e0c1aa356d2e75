"""The port's prefill programs (`serving/graphs.PrefillRunner`): the
counterpart of the JAX engine's compiled prefill (`_prefill_fn`, one
jitted program per bucket).

- `_prefill_forward` on device values (slot, pos0, length and the paged
  table row as tensors in the runner's static buffer) equals, bitwise,
  the slice-indexed prefill it replaced (a copy below), slotted and
  paged, fp and int8 KV: the logits and every cache row a real row
  writes; rows past the cache park (slotted row T-1 of the lane, the
  paged trash page), and other slots' stripes and other lanes' pages
  stay untouched.
- One runner per row count, made at its first use and reused.
- The `prefill` fault fires once per piece, and a retried piece is
  bit-identical.
- Across packages: chunked, prefix-cached admission gives the JAX
  engine's greedy streams where the reference's top-2 margin is above
  1e-3 at every step.

On the CPU the runner calls the function on its static buffers (no
graph); the card's capture and replay are `chip_smoke.py` phase 4f's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.models.gpt import _body_layers, _head, _masked_attend
from paddle_tpu_torch.quantization.kv import (dequant_slab, kv_update,
                                              map_slab, slab_leaves,
                                              slab_shape, take_rows)
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
from paddle_tpu_torch.serving import engine as E
from paddle_tpu_torch.serving.paged_kv import paged_rows
from paddle_tpu_torch.testing import faults
from port_streams import reference_margins
from port_threads import one_torch_thread  # noqa: F401


def _slice_prefill(cfg, params, k_list, v_list, ids, slot, pos0, length,
                   table=None, page_size=0):
    """The prefill as the engine computed it before its device-value
    form: Python ints `slot`, `pos0`, `length`; writes through a slice
    of the first W = min(L, T - pos0) rows, the lane view by a slice."""
    L = ids.shape[1]
    T = table.shape[0] * page_size if table is not None \
        else slab_shape(k_list[0])[1]
    W = min(L, T - pos0)
    dev = ids.device
    q_pos = pos0 + torch.arange(L, device=dev)
    x = E._embed(params, ids, q_pos[None])
    keep = (torch.arange(T, device=dev)[None, :]
            <= q_pos[:, None])[None, None]
    if table is None:
        rows = (slot, slice(pos0, pos0 + W))
    else:
        rows = paged_rows(table, q_pos[:W], page_size)

    def lane_view(slab, dtype):
        if table is None:
            return dequant_slab(map_slab(slab, lambda a: a[slot:slot + 1]),
                                dtype)
        return take_rows(slab, table, dtype).reshape(
            1, T, *slab_shape(slab)[2:])

    def attn(i, q, kn, vn):
        kv_update(k_list[i], rows, kn[0, :W])
        kv_update(v_list[i], rows, vn[0, :W])
        return _masked_attend(q, lane_view(k_list[i], q.dtype),
                              lane_view(v_list[i], q.dtype), keep)

    x = _body_layers(cfg, params, x, attn)
    return _head(params, x[:, length - 1:length])[0, 0].float()


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


def _leaves(eng):
    return [t for slab in eng.cache.k + eng.cache.v
            for t in slab_leaves(slab)]


def _fill(eng, seed):
    """Every cache slab filled with seeded noise (int8 codes and
    positive scales), so that an untouched row is recognisable."""
    g = torch.Generator().manual_seed(seed)
    for t in _leaves(eng):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        elif t.dim() == 3 and eng.cache.quantized:
            t.copy_(torch.rand(t.shape, generator=g) * 0.01 + 1e-3)
        else:
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))


LAYOUTS = [pytest.param(kw, id=name) for name, kw in (
    ("slotted", {}), ("slotted-int8", dict(kv_dtype="int8")),
    ("paged", dict(kv_layout="paged", page_size=16)),
    ("paged-int8", dict(kv_layout="paged", page_size=16,
                        kv_dtype="int8")))]


@pytest.mark.parametrize("knobs", LAYOUTS)
@pytest.mark.parametrize("pos0,n", [(0, 23), (40, 9)])
def test_runner_equals_slice_indexed_prefill(model, knobs, pos0, n):
    """A piece of n tokens at pos0 through its runner (128 rows, all of
    them past T = 64 from row 64 - pos0 on: parking) against the
    slice-indexed prefill on a copy of the same cache: the logits and
    every row but the parking ones bitwise equal; other slots' stripes
    (slotted) and every page but the lane's own and the trash page
    (paged) keep their noise."""
    eng = LLMEngine(model, max_slots=3, max_seq=64, device="cpu",
                    prefix_cache=False, **knobs)
    paged = eng.paged
    for s in range(3):
        eng.cache.allocate()
        if paged:
            eng.cache.bind_owned(s, eng.cache.pool.alloc(
                eng.cache.pages_per_seq))
    _fill(eng, seed=7)
    before = [t.clone() for t in _leaves(eng)]
    slot = 1
    toks = np.random.RandomState(3).randint(0, 1024, n).astype(np.int32)
    got = eng._prefill_tokens(slot, toks, pos0)
    assert sorted(eng._prefill_runners) == [E.PREFILL_MIN_ROWS]

    ref = LLMEngine(model, max_slots=3, max_seq=64, device="cpu",
                    prefix_cache=False, **knobs)
    for t, b in zip(_leaves(ref), before):
        t.copy_(b)
    ids = np.zeros((1, E.PREFILL_MIN_ROWS), np.int64)
    ids[0, :n] = toks
    table = torch.from_numpy(eng.cache.block_tables[slot]) if paged \
        else None
    want = _slice_prefill(model.cfg, ref._params, ref.cache.k, ref.cache.v,
                          torch.from_numpy(ids), slot, pos0, n, table=table,
                          page_size=ref.page_size)
    assert torch.equal(got, want)

    T = 64
    if paged:
        lane = set(eng.cache.lane_pages(slot))
        for a, b, r in zip(_leaves(eng), _leaves(ref), before):
            for page in range(a.shape[0]):
                if page == 0:
                    continue               # the trash page: parked rows
                assert torch.equal(a[page], b[page]), page
                if page not in lane:
                    assert torch.equal(a[page], r[page]), page
    else:
        for a, b, r in zip(_leaves(eng), _leaves(ref), before):
            # row T-1 of the lane holds a parked row's write
            assert torch.equal(a[slot, :T - 1], b[slot, :T - 1])
            for s in (0, 2):
                assert torch.equal(a[s], r[s])
    # the piece's rows were written
    assert not all(torch.equal(a, r) for a, r in zip(_leaves(eng), before))


def test_one_runner_per_row_count(model):
    """max_seq 200 (no power of two: buckets 16 ... 128 and 200):
    prompts of 10, 150 and 100 tokens use the row counts 128, 200 and
    128 again; each runner is made once and reused."""
    eng = LLMEngine(model, max_slots=2, max_seq=200, device="cpu",
                    prefix_cache=False)
    sp = SamplingParams(max_new_tokens=3)
    prompts = [np.arange(n, dtype=np.int32) % 1024 for n in (10, 150)]
    eng.generate(prompts, sp)
    assert sorted(eng._prefill_runners) == [128, 200]
    first = dict(eng._prefill_runners)
    eng.generate([np.arange(100, dtype=np.int32)], sp)
    assert eng._prefill_runners == first
    assert all(eng._prefill_runners[r] is first[r] for r in first)
    st = eng.stats()
    # the CPU runs the runners ungraphed: no capture, nothing booked
    assert (st["prefill_graph_captures"], st["prefill_graph_capture_s"],
            st["prefill_graph_pool_bytes"], st["graph_captures"]) \
        == (0, 0.0, 0, 0)
    # caller-given buckets give their own row counts, at least the floor
    eng = LLMEngine(model, max_slots=2, max_seq=256, device="cpu",
                    prefill_buckets=[160, 256], prefix_cache=False)
    eng.generate([np.arange(150, dtype=np.int32)], sp)
    assert sorted(eng._prefill_runners) == [160]


def test_prefill_fault_fires_once_per_piece_and_retry_is_bitwise(model):
    """prefill_chunk 16 over a 50-token prompt: 4 pieces, 4 `prefill`
    calls clean; a fault at call 2 fails the admission attempt, which
    re-runs from row 0 (one retry, 4 + 1 calls in all), and the stream
    equals the clean one token for token."""
    prompt = np.random.RandomState(5).randint(0, 1024, 50).astype(np.int32)
    sp = SamplingParams(max_new_tokens=6, temperature=0.9)
    kw = dict(max_slots=2, max_seq=96, device="cpu", prefill_chunk=16,
              prefix_cache=False, retry_backoff_s=0.0)
    clean = faults.FaultPlan()
    with faults.inject(clean):
        want = LLMEngine(model, **kw).generate([prompt], sp)[0].token_ids
    assert clean.calls["prefill"] == 4
    plan = faults.FaultPlan().fail_at("prefill", 2)
    eng = LLMEngine(model, **kw)
    with faults.inject(plan):
        rid = eng.submit(prompt, sp)
        eng.run_until_complete(max_steps=100)
    assert eng.result(rid).token_ids == want
    assert plan.injected == {"prefill": 1}
    assert plan.calls["prefill"] == 2 + 4
    st = eng.stats()
    assert (st["retries"], st["recoveries"], st["failed_requests"]) \
        == (1, 1, 0)


def test_greedy_streams_match_jax_engine_chunked_prefix_cached(jax_model,
                                                               model):
    """Monolithic admission in 16-token pieces with the prefix cache on
    (a 32-token shared prefix), the JAX engine with the same knobs: the
    same greedy streams and the same reused tokens."""
    rng = np.random.RandomState(21)
    shared = rng.randint(0, 1024, 32).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 1024, n)
                               .astype(np.int32)]) for n in (37, 6, 19)]
    kw = dict(max_slots=2, max_seq=128, seed=1, decode_block_size=4,
              attend_impl="masked", prefill_chunk=16, prefix_block=16)
    jeng = JaxEngine(jax_model, register_stats=False, trace=False, **kw)
    want = [r.token_ids for r in jeng.generate(
        prompts, JaxParams(max_new_tokens=10))]
    margins = reference_margins(jax_model, prompts, want)
    print(f"smallest reference top-2 margin per stream: {margins}")
    assert min(margins) > 1e-3, f"near-tie in the reference: {margins}"
    eng = LLMEngine(model, device="cpu", **kw)
    out = eng.generate(prompts, SamplingParams(max_new_tokens=10))
    assert [r.token_ids for r in out] == want
    assert eng.stats()["prefix_tokens_reused"] == \
        jeng.stats()["prefix_tokens_reused"] > 0
    assert sorted(eng._prefill_runners) == [E.PREFILL_MIN_ROWS]
