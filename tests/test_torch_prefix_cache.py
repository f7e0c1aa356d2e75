"""Port prefix cache (`paddle_tpu_torch/serving/prefix_cache.py`, the
slotted prefix pool of `kv_cache.py`, the shared pages of
`paged_kv.py`) against the JAX reference, and the reference's engine
contracts (`tests/test_prefix_cache.py`) held inside the port.

- The same seeded operation sequences through the JAX and the port
  `PrefixCache` (private page list, and pages of a shared `PagePool`)
  give equal matches, pages, evictions and refcounts.
- Inside the port, bitwise, on the slotted and paged layouts and int8
  KV: a cache hit serves the cold engine's greedy AND sampled streams,
  partial overlaps and chunked prefill included; a failed insert never
  fails admission; the pool is off when no chunk fits and its bytes are
  visible; eviction under pressure keeps the streams; cancel and
  deadline release every pin (and, paged, every page); a `prefix_copy`
  fault recovers bitwise and its exhaustion fails one request.
- Across packages: the port with the prefix cache on gives the JAX
  engine's greedy streams (prefix cache on), where the reference's
  top-2 logit margin is above 1e-3 at every step.
"""
import time

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import paged_kv as jax_paged_kv
from paddle_tpu.serving import prefix_cache as jax_prefix_cache
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.serving import (LLMEngine, PagePool, PrefixCache,
                                      SamplingParams, TreePageAllocator)
from paddle_tpu_torch.testing import faults
from port_streams import reference_margins
from port_threads import one_torch_thread  # noqa: F401


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


def _shared_prefix_prompts(prefix_len, tail_lens, seed=0):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 1024, (prefix_len,)).astype(np.int32)
    return [np.concatenate([prefix,
                            rng.randint(0, 1024, (n,)).astype(np.int32)])
            for n in tail_lens]


def _mixed_params():
    return [SamplingParams(max_new_tokens=20),
            SamplingParams(max_new_tokens=18, temperature=0.9),
            SamplingParams(max_new_tokens=16, temperature=0.8, top_k=16),
            SamplingParams(max_new_tokens=14, temperature=0.7, top_p=0.9)]


BASE = dict(max_slots=2, max_seq=96, seed=7)
# the engine configurations every contract runs on; the prefix chunk is
# 8 tokens (the page under "paged")
CONFIGS = {
    "slotted": dict(prefix_block=8),
    "paged": dict(kv_layout="paged", page_size=8),
    "int8_kv": dict(prefix_block=8, kv_dtype="int8"),
}
# the configurations with a slotted pool (a hit copies pages)
COPYING = ("slotted", "int8_kv")


def _cold(config):
    """The same engine with the prefix cache off."""
    return {k: v for k, v in CONFIGS[config].items()
            if k != "prefix_block"}


def _run(model, prompts, params, **kw):
    kw = {**BASE, **kw}
    eng = LLMEngine(model, device="cpu", **kw)
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run_until_complete(max_steps=500)
    return [eng.result(r).token_ids for r in rids], eng


def _leaked(eng) -> int:
    """Pages held beyond the trash page once the prefix tree's
    (legitimate) holdings are released."""
    if eng.prefix is not None:
        eng.prefix.clear()
    return eng.cache.pool.leaked()


def _unpinned(prefix) -> bool:
    stack = list(prefix.root.children.values())
    while stack:
        n = stack.pop()
        if n.ref != 0:
            return False
        stack.extend(n.children.values())
    return True


# ---------------------------------------------------------------------- #
# the radix tree against the JAX package's
# ---------------------------------------------------------------------- #

def _tree_state(cache):
    out = []
    stack = [(cache.root, ())]
    while stack:
        node, path = stack.pop()
        for key in sorted(node.children):
            child = node.children[key]
            out.append((path + (key,), child.page, child.ref,
                        child.depth))
            stack.append((child, path + (key,)))
    return sorted(out)


def _drive(module, paged_module, mode, seed):
    """A seeded operation sequence on one package's `PrefixCache`; the
    log of every observable result."""
    rng = np.random.RandomState(seed)
    pool = None
    if mode == "shared":
        pool = paged_module.PagePool(9, reserved=1)
        cache = module.PrefixCache(
            2, 8, allocator=paged_module.TreePageAllocator(pool))
    else:
        cache = module.PrefixCache(2, 6)
    log, pinned, last = [], [], None
    for step in range(120):
        op = rng.choice(["insert", "match", "release", "evict", "drop",
                         "clear"], p=[0.35, 0.3, 0.15, 0.1, 0.07, 0.03])
        toks = rng.randint(0, 3, (int(rng.randint(0, 11)),)).astype(
            np.int32)
        if op == "insert":
            if mode == "shared":
                lane = pool.alloc(min(len(toks) // 2, pool.num_free))
                created = cache.insert_mapped(
                    toks[:2 * len(lane)], lambda i: lane[i])
                for p in lane:              # the lane retires
                    pool.unref(p)
            else:
                created = cache.insert(toks)
            last = created
            log.append(("insert", [(n.depth, i, n.page)
                                   for n, i in created]))
            continue
        if op == "match":
            nodes, pages = cache.match(toks)
            log.append(("match", pages))
            if nodes and rng.rand() < 0.6:
                cache.acquire(nodes)
                pinned.append(nodes)
        elif op == "release" and pinned:
            cache.release(pinned.pop(int(rng.randint(len(pinned)))))
        elif op == "evict":
            log.append(("evict", cache.evict(int(rng.randint(1, 4)))))
        elif op == "drop" and last and mode == "pool":
            cache.drop(last)
            log.append(("drop", len(last)))
        elif op == "clear":
            cache.clear()
            pinned = []
        last = None
        log.append(("state", cache.pages_used, cache.pages_free,
                    cache.evictions, cache.reclaimable_pages(),
                    _tree_state(cache),
                    pool.pages_used if pool is not None else None))
    return log


@pytest.mark.parametrize("mode,seed", [("pool", 0), ("pool", 1),
                                       ("pool", 2), ("shared", 0),
                                       ("shared", 1), ("shared", 2)])
def test_tree_operations_match_jax(mode, seed):
    from paddle_tpu_torch.serving import paged_kv, prefix_cache
    port = _drive(prefix_cache, paged_kv, mode, seed)
    ref = _drive(jax_prefix_cache, jax_paged_kv, mode, seed)
    assert port == ref
    kinds = {e[0] for e in port}
    assert {"insert", "match", "evict", "state"} <= kinds


def test_tree_allocator_shares_the_lane_pool():
    pool = PagePool(6)
    tree = PrefixCache(4, 6, allocator=TreePageAllocator(pool))
    lane = pool.alloc(2)
    tree.insert_mapped(np.arange(8, dtype=np.int32), lambda i: lane[i])
    assert [pool.refcount(p) for p in lane] == [2, 2]
    for p in lane:
        pool.unref(p)                  # the lane retires: the tree holds
    assert tree.pages_used == 2 and pool.pages_used == 3
    assert tree.evict(2) == 2 and pool.leaked() == 0


# ---------------------------------------------------------------------- #
# the engine: a hit is a cold prefill's bits
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_hit_equals_cold_bitwise(model, config):
    prompts = _shared_prefix_prompts(40, (5, 9, 13, 3), seed=2)
    params = _mixed_params()
    ref, e0 = _run(model, prompts, params, prefix_cache=False,
                   **_cold(config))
    out, e1 = _run(model, prompts, params, **CONFIGS[config])
    assert out == ref
    s = e1.stats()
    assert s["prefix_hits"] == 3 and s["prefix_lookups"] == 4
    assert s["prefix_tokens_reused"] == 3 * 40
    assert s["prefix_tokens_reused"] + s["prefill_tokens_computed"] \
        == sum(p.size for p in prompts)
    assert e0.stats()["prefix_lookups"] == 0
    assert e0.stats()["prefill_tokens_computed"] == sum(p.size
                                                        for p in prompts)
    if e1.paged:
        assert _leaked(e1) == 0


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_partial_overlap_and_chunked_prefill(model, config):
    prompts = _shared_prefix_prompts(24, (20, 28), seed=5)
    prompts.append(prompts[0][:30].copy())      # a sub-prefix of another
    params = [SamplingParams(max_new_tokens=10),
              SamplingParams(max_new_tokens=10, temperature=0.8),
              SamplingParams(max_new_tokens=10)]
    ref, _ = _run(model, prompts, params, prefix_cache=False,
                  prefill_chunk=16, **_cold(config))
    out, eng = _run(model, prompts, params, prefill_chunk=16,
                    **CONFIGS[config])
    assert out == ref
    assert eng.stats()["prefix_hits"] >= 2
    # chunking alone changes nothing either
    assert _run(model, prompts, params, prefix_cache=False,
                **_cold(config))[0] == ref


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_identical_prompt_reuses_full_prefix(model, config):
    p = _shared_prefix_prompts(33, (0,), seed=9)[0][:33]
    sp = SamplingParams(max_new_tokens=8)
    eng = LLMEngine(model, device="cpu", **BASE, **CONFIGS[config])
    a = eng.generate([p], sp)[0].token_ids
    pre = eng.stats()["prefill_tokens_computed"]
    b = eng.generate([p], sp)[0].token_ids
    assert a == b
    s = eng.stats()
    assert s["prefix_tokens_reused"] == 32
    assert s["prefill_tokens_computed"] - pre == 33 - 32


@pytest.mark.parametrize("config", COPYING)
def test_insert_failure_never_fails_admission(model, config, monkeypatch):
    """Populating the cache is optional: a failing pool write serves the
    request anyway, the tree rolls back and no hit ever happens."""
    prompts = _shared_prefix_prompts(24, (4, 7), seed=13)
    sp = SamplingParams(max_new_tokens=6)
    ref, _ = _run(model, prompts, [sp] * 2, prefix_cache=False,
                  **_cold(config))
    eng = LLMEngine(model, device="cpu", max_retries=0, **BASE,
                    **CONFIGS[config])

    def boom(*a, **k):
        raise RuntimeError("pool write died")

    monkeypatch.setattr(eng.cache, "copy_slot_to_pool", boom)
    out = [r.token_ids for r in eng.generate(prompts, [sp] * 2)]
    assert out == ref
    assert eng.metrics.failed_requests == 0
    assert eng.stats()["prefix_hits"] == 0
    assert eng.prefix.pages_used == 0


def test_pool_auto_off_zero_pages_and_bytes(model):
    # max_seq < prefix_block: no prompt spans a chunk, no pool at all
    eng = LLMEngine(model, device="cpu", max_slots=2, max_seq=48)
    assert eng.prefix is None and eng.cache.pool_nbytes() == 0
    eng = LLMEngine(model, device="cpu", max_slots=2, max_seq=96,
                    prefix_pool_pages=0)
    assert eng.prefix is None and eng.cache.pool_nbytes() == 0
    res = eng.generate(_shared_prefix_prompts(24, (4,), seed=1),
                       SamplingParams(max_new_tokens=4))
    assert res[0].finish_reason == "length"
    assert eng.stats()["prefix_lookups"] == 0
    # the default pool mirrors the slot slabs: max_slots * max_seq / B
    on = LLMEngine(model, device="cpu", **BASE, prefix_block=8)
    off = LLMEngine(model, device="cpu", **BASE, prefix_cache=False)
    assert on.prefix_pool_pages == 2 * 96 // 8
    assert on.cache.nbytes() == off.cache.nbytes() + on.cache.pool_nbytes()
    assert on.cache.pool_nbytes() == off.cache.nbytes()
    assert on.stats()["kv_cache_bytes"] == on.cache.nbytes()
    assert on.stats()["prefix_pool_bytes"] == on.cache.pool_nbytes()
    assert on.stats()["kv_bytes_per_token"] \
        == off.stats()["kv_bytes_per_token"]
    # int8 KV: the pool holds codes and f32 scales, as the slot slabs
    q = LLMEngine(model, device="cpu", **BASE, prefix_block=8,
                  kv_dtype="int8")
    slab = q.cache.pool_k[0]
    assert slab["q"].dtype.is_floating_point is False
    assert tuple(slab["q"].shape) == (24, 8, 4, 32)
    assert tuple(slab["s"].shape) == (24, 8, 4)
    # paged: no pool of its own, the tree shares the page pool
    pg = LLMEngine(model, device="cpu", **BASE, kv_layout="paged",
                   page_size=8)
    assert pg.cache.pool_nbytes() == 0 and pg.prefix_block == 8


@pytest.mark.parametrize("config", ["slotted", "paged"])
def test_eviction_under_pressure_stays_correct(model, config):
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 1024, (24,)).astype(np.int32)
               for _ in range(6)]
    sp = SamplingParams(max_new_tokens=6)
    ref, _ = _run(model, prompts, [sp] * 6, prefix_cache=False,
                  **_cold(config))
    small = dict(prefix_pool_pages=4) if config == "slotted" \
        else dict(kv_pages=16)        # two 4-page lanes, 7 pages for the tree
    out, eng = _run(model, prompts, [sp] * 6, **CONFIGS[config], **small)
    assert out == ref
    s = eng.stats()
    assert s["prefix_evictions"] > 0
    if config == "slotted":
        assert s["prefix_pool_pages_used"] <= 4
    else:
        assert s["kv_pages_peak"] <= 16 and _leaked(eng) == 0


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_refcounts_released_on_cancel_and_deadline(model, config):
    prompts = _shared_prefix_prompts(16, (4, 5, 6), seed=6)
    params = [SamplingParams(max_new_tokens=60),
              SamplingParams(max_new_tokens=60),
              SamplingParams(max_new_tokens=60, deadline_s=0.25)]
    eng = LLMEngine(model, device="cpu", max_slots=3, max_seq=96, seed=7,
                    **CONFIGS[config])
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.step()            # all three admitted: #2 and #3 pin the path
    assert max(n.ref for n in eng.prefix.root.children.values()) >= 1
    assert eng.cancel(rids[1])
    time.sleep(0.3)       # request 3's TTL lapses mid-generation
    eng.run_until_complete(max_steps=300)
    assert eng.result(rids[1]).finish_reason == "cancelled"
    assert eng.result(rids[2]).finish_reason == "deadline"
    assert _unpinned(eng.prefix)
    used = eng.prefix.pages_used
    assert eng.prefix.evict(used) == used          # all evictable again
    if eng.paged:
        assert _leaked(eng) == 0


@pytest.mark.parametrize("config", COPYING)
def test_prefix_copy_fault_recovers_bitwise(model, config):
    prompts = _shared_prefix_prompts(24, (4, 7, 3, 9), seed=8)
    params = _mixed_params()
    ref, _ = _run(model, prompts, params, **CONFIGS[config])
    eng = LLMEngine(model, device="cpu", max_retries=2,
                    retry_backoff_s=0.0, **BASE, **CONFIGS[config])
    plan = faults.FaultPlan().fail_at("prefix_copy", 1)
    with faults.inject(plan):
        rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
        eng.run_until_complete(max_steps=500)
    assert [eng.result(r).token_ids for r in rids] == ref
    assert plan.injected["prefix_copy"] == 1
    assert eng.metrics.recoveries >= 1 and eng.metrics.failed_requests == 0


@pytest.mark.parametrize("config", COPYING)
def test_prefix_copy_exhaustion_fails_single_request(model, config):
    prompts = _shared_prefix_prompts(24, (4, 7, 3), seed=8)
    sp = SamplingParams(max_new_tokens=6)
    eng = LLMEngine(model, device="cpu", max_retries=0, **BASE,
                    **CONFIGS[config])
    plan = faults.FaultPlan().fail_at("prefix_copy", 1)
    with faults.inject(plan):
        rids = [eng.submit(p, sp) for p in prompts]
        eng.run_until_complete(max_steps=500)
    reasons = [eng.result(r).finish_reason for r in rids]
    assert reasons.count("error") == 1 and reasons.count("length") == 2
    assert eng.metrics.failed_requests == 1
    assert eng.cache.num_free == eng.max_slots
    assert _unpinned(eng.prefix)
    assert plan.postmortems[0]["detail"]["failed_rids"] == [
        rids[reasons.index("error")]]


# ---------------------------------------------------------------------- #
# across packages
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("config", ["slotted", "paged"])
def test_greedy_streams_match_jax_engine_with_prefix_cache(
        jax_model, model, config):
    prompts = _shared_prefix_prompts(32, (5, 9, 3, 12), seed=21)
    kw = dict(BASE, decode_block_size=4, attend_impl="masked",
              **CONFIGS[config])
    jeng = JaxEngine(jax_model, register_stats=False, trace=False, **kw)
    want = [r.token_ids for r in jeng.generate(
        prompts, JaxParams(max_new_tokens=12))]
    assert jeng.stats()["prefix_hits"] == 3
    margins = reference_margins(jax_model, prompts, want)
    print(f"smallest reference top-2 margin per stream: {margins}")
    assert min(margins) > 1e-3, f"near-tie in the reference: {margins}"
    got, eng = _run(model, prompts, [SamplingParams(max_new_tokens=12)] * 4,
                    **kw)
    assert got == want
    assert eng.stats()["prefix_tokens_reused"] == \
        jeng.stats()["prefix_tokens_reused"] == 3 * 32
