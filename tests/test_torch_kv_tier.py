"""The fleet KV tier (`serving/kv_tier.py`) and the engine's tier hooks
(`attach_kv_tier`, `_tier_bind`, `_tier_publish`, `_resolve_tier_stub`),
the counterpart of `tests/test_kv_tier.py`.

- `chunk_key` equals the JAX package's for the same tokens.
- A tier-bound admission (a second engine binding the first one's
  published pages past its empty prefix tree) gives the cold prefill's
  stream bitwise: paged fp and int8 KV, monolithic and interleaved
  admission, greedy and sampled, with no unexpected capture; both equal
  the JAX engine's greedy streams (reference margins > 1e-3).
- A `tier_fetch` fault degrades to a prefill (same stream, a miss);
  a chunk of the other kv_dtype is a miss, never a cast.
- A swapped-out request's pages park in the tier as a single-use parcel
  and are redeemed exactly once; a cancelled parked request drops it.
- A published chunk stores its own page's bytes plus the header, not
  the gather's whole buffer, and decodes to that page's rows.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import chunk_key as jax_chunk_key
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.serving import (KVTier, LLMEngine, SamplingParams,
                                      chunk_key)
from paddle_tpu_torch.serving.kv_tier import decode_payload, encode_payload
from paddle_tpu_torch.testing import faults

from port_streams import reference_margins
from port_threads import one_torch_thread  # noqa: F401 — autouse fixture

PAGED = dict(max_slots=2, max_seq=96, kv_layout="paged", page_size=16,
             seed=0, register_stats=False, device="cpu")


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


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def _leaked(eng) -> int:
    if eng.prefix is not None:
        eng.prefix.clear()
    return eng.cache.pool.leaked()


def _run(model, prompts, sp, tier=None, **kw):
    eng = LLMEngine(model, **{**PAGED, **kw}, kv_tier=tier)
    res = eng.generate(prompts, [sp] * len(prompts))
    assert eng.watchdog.compiles_unexpected == 0
    return [r.token_ids for r in res], eng


def test_chunk_key_equals_jax():
    rng = np.random.RandomState(3)
    for n in (1, 16, 64, 337):
        toks = rng.randint(0, 50000, (n,))
        for ns in ("kv", "gpt_small/64"):
            assert chunk_key(toks, ns) == jax_chunk_key(toks, ns)
            assert KVTier(16, namespace=ns).chunk_key(toks) \
                == jax_chunk_key(toks, ns)
    assert chunk_key([1, 2]) != chunk_key([1, 2], "other")


@pytest.mark.parametrize("case", [
    dict(),
    dict(kv_dtype="int8"),
    dict(prefill_budget=16),
    dict(sampled=True),
], ids=["fp", "int8", "interleaved", "sampled"])
def test_tier_bind_is_the_cold_stream(model, case):
    kw = dict(case)
    sampled = kw.pop("sampled", False)
    sp = SamplingParams(max_new_tokens=8, temperature=0.8, top_p=0.9) \
        if sampled else SamplingParams(max_new_tokens=8)
    prompts = _prompts((40, 40, 24), seed=1)
    prompts[1][:32] = prompts[0][:32]        # two pages shared
    cold, _ = _run(model, prompts, sp, **kw)
    tier = KVTier(page_size=16)
    pub, ea = _run(model, prompts, sp, tier=tier, **kw)
    sub, eb = _run(model, prompts, sp, tier=tier, **kw)
    assert cold == pub == sub
    # prompt 1's two full pages are prompt 0's: 2 + 0 + 1 chunks
    assert tier.stats()["publishes"] == 3
    assert ea.metrics.kv_tier_hits == 0            # the tier was empty
    # the subscriber binds prompt 0's and prompt 2's pages from the
    # tier; prompt 1 hits its own tree (prompt 0 admitted first), but
    # interleaved, both start their prefill in one round and prompt 1
    # binds from the tier too
    assert eb.metrics.kv_tier_hits == (5 if "prefill_budget" in kw else 3)
    assert eb.metrics.kv_tier_bytes > 0
    assert eb.metrics.prefix_tokens_reused >= 5 * 16
    assert ea.metrics.swap_host_syncs == 2         # one gather a publish
    assert _leaked(ea) == _leaked(eb) == 0
    kinds = {e[2] for e in eb.tracer.events()}
    assert "tier_bind" in kinds and "tier_publish" in {
        e[2] for e in ea.tracer.events()}


def test_tier_streams_equal_jax_engine(model, jax_model):
    prompts = _prompts((40, 36), seed=4)
    prompts[1][:32] = prompts[0][:32]
    jeng = JaxEngine(jax_model, max_slots=2, max_seq=96,
                     kv_layout="paged", page_size=16, seed=0,
                     register_stats=False)
    want = [r.token_ids for r in jeng.generate(
        prompts, JaxParams(max_new_tokens=8))]
    assert min(reference_margins(jax_model, prompts, want)) > 1e-3
    tier = KVTier(page_size=16)
    sp = SamplingParams(max_new_tokens=8)
    pub, _ = _run(model, prompts, sp, tier=tier)
    sub, eb = _run(model, prompts, sp, tier=tier)
    assert pub == sub == want and eb.metrics.kv_tier_hits == 2


def test_tier_fetch_fault_degrades_to_prefill(model):
    prompts = _prompts((40,), seed=2)
    sp = SamplingParams(max_new_tokens=8)
    cold, _ = _run(model, prompts, sp)
    tier = KVTier(page_size=16)
    _run(model, prompts, sp, tier=tier)
    plan = faults.FaultPlan().fail_at("tier_fetch", 1)
    with faults.inject(plan):
        got, eng = _run(model, prompts, sp, tier=tier)
    assert got == cold and plan.injected["tier_fetch"] == 1
    assert eng.metrics.kv_tier_hits == 0 and eng.metrics.kv_tier_misses == 1
    # the other kv_dtype: a miss, never a cast
    cold8, _ = _run(model, prompts, sp, kv_dtype="int8")
    got8, e8 = _run(model, prompts, sp, tier=tier, kv_dtype="int8")
    assert got8 == cold8
    assert e8.metrics.kv_tier_hits == 0 and e8.metrics.kv_tier_misses == 1


def test_swap_parks_pages_in_the_tier_redeemed_once(model):
    prompts = _prompts((20, 12))
    sp = SamplingParams(max_new_tokens=12, temperature=0.6)
    want = [r.token_ids for r in LLMEngine(model, **PAGED).generate(
        prompts, [sp, sp])]
    tier = KVTier(page_size=16)
    eng = LLMEngine(model, **PAGED, kv_tier=tier)
    r0, r1 = (eng.submit(p, sp) for p in prompts)
    eng.step()
    assert eng.swap_out(r0)
    parked = eng._swapped[r0].kv_host
    assert set(parked) == {"tier_key", "rows", "n_pages", "origin",
                           "quantized"}
    assert parked["origin"] == "swap" and tier.stats()["handoffs_open"] == 1
    key = parked["tier_key"]
    # the stub rides snapshot / unqueue as a stub, not as bytes
    assert eng.snapshot()["swapped"][0]["kv_pages"]["tier_key"] == key
    assert eng.swap_in(r0)
    while eng.has_work():
        eng.step()
    assert [eng.result(r).token_ids for r in (r0, r1)] == want
    st = tier.stats()
    assert st["handoffs_open"] == 0 and st["handoffs_out"] == 1
    assert tier.take_handoff(key) is None          # single use
    assert eng.metrics.kv_tier_hits == 1 and eng.metrics.swap_ins == 1
    assert _leaked(eng) == 0
    # a parked request cancelled with its parcel unredeemed drops it
    rid = eng.submit(prompts[0], sp)
    eng.step()
    assert eng.swap_out(rid) and tier.stats()["handoffs_open"] == 1
    assert eng.cancel(rid)
    assert tier.stats()["handoffs_open"] == 0
    assert eng.result(rid).finish_reason == "cancelled"


def test_published_chunk_holds_its_own_bytes(model):
    prompts = _prompts((50,), seed=6)
    tier = KVTier(page_size=16)
    for kv_dtype in (None, "int8"):
        tier = KVTier(page_size=16, namespace=str(kv_dtype))
        _, eng = _run(model, prompts, SamplingParams(max_new_tokens=4),
                      tier=tier, kv_dtype=kv_dtype)
        _, pages = eng.prefix.match(prompts[0])
        assert len(pages) == 3
        k_host, v_host = eng.cache.gather_pages(pages)
        for ci, page in enumerate(pages):
            data = tier._table.get_bytes(
                tier.chunk_key(prompts[0][:(ci + 1) * 16]))
            # the stored blob is this page's rows and a small header,
            # not the 3-page gather buffer it was sliced from
            header = len(data) - eng.cache.page_nbytes()
            assert 0 < header < 4096
            assert tier.stats()["bytes_ram"] == 3 * len(data)
            got = decode_payload(data)
            assert got["rows"] == 16 and len(got["k"]) == 4
            assert got["quantized"] == (kv_dtype == "int8")
            for side, host in (("k", k_host), ("v", v_host)):
                for lay, want in zip(got[side], host):
                    if kv_dtype == "int8":
                        for leaf in ("q", "s"):
                            assert torch.equal(lay[leaf],
                                               want[leaf][ci:ci + 1])
                    else:
                        assert torch.equal(lay, want[ci:ci + 1])
        assert _leaked(eng) == 0


def test_codec_round_trips_bf16_bits():
    rng = torch.Generator().manual_seed(0)
    k = [torch.randn(2, 4, 3, 8, generator=rng).to(torch.bfloat16)
         for _ in range(2)]
    k[0].view(torch.int16)[0, 0, 0, :2] = torch.tensor(
        [0x7FC1, -1], dtype=torch.int16)               # NaN payloads
    v = [np.asarray(t.float().numpy()) for t in k]     # numpy leaves
    back = decode_payload(encode_payload(
        {"k": k, "v": v, "rows": 4, "quantized": False}))
    for a, b in zip(back["k"], k):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for a, b in zip(back["v"], v):
        assert np.array_equal(a.numpy().view(np.uint32), b.view(np.uint32))
    with pytest.raises(ValueError, match="payload"):
        decode_payload(b"nope" * 4)


def test_store_lru_spill_and_geometry(model, tmp_path):
    payload = {"k": [torch.ones(1, 16, 4, 32)] * 4,
               "v": [torch.zeros(1, 16, 4, 32)] * 4, "rows": 16,
               "quantized": False}
    size = len(encode_payload(payload))
    tier = KVTier(page_size=16, capacity_mb=2.5 * size / (1 << 20))
    for key in (1, 2, 3):
        assert tier.publish_chunk(key, payload) == size
    assert tier.publish_chunk(2, payload) == 0         # first writer wins
    st = tier.stats()
    assert st["chunks_ram"] == 2 and st["evictions"] == 1
    assert tier.fetch_chunk(1) is None                 # LRU: 1 dropped
    disk = KVTier(page_size=16, capacity_mb=1.5 * size / (1 << 20),
                  spill_dir=str(tmp_path))
    disk.publish_chunk(1, payload)
    disk.publish_chunk(2, payload)
    assert disk.stats()["chunks_disk"] == 1
    back = disk.fetch_chunk(1)                         # faults back in
    assert torch.equal(back["k"][0], payload["k"][0])
    assert disk.stats()["spills"] == 2
    # handoff parcels are exempt from eviction
    key = tier.put_handoff(payload)
    assert tier.stats()["handoffs_open"] == 1
    tier.drop_handoff(key)
    assert tier.take_handoff(key) is None
    with pytest.raises(ValueError, match="page_size"):
        LLMEngine(model, **PAGED, kv_tier=KVTier(page_size=8))
    # a slotted engine holds the tier inertly
    got, eng = _run(model, _prompts((40,)), SamplingParams(max_new_tokens=4),
                    tier=tier, kv_layout="slotted", page_size=None)
    assert eng.metrics.kv_tier_hits == 0 and tier.stats()["publishes"] == 3
