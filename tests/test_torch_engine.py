"""Port serving engine (`paddle_tpu_torch/serving`) against the JAX
engine, and the JAX engine's own invariants held inside the port.

Cross-package: the port's `LLMEngine(device="cpu",
attend_impl="masked")` and JAX `LLMEngine(attend_impl="masked",
prefix_cache=False)` on the same gpt_tiny weights give equal greedy
token streams, EOS mid-block included. Inside the port (bitwise, same
code path): engine ≡ single request at every block size, sampled
streams invariant to block size and lane assignment, one host sync per
dispatched block, admission control, and loud rejection of knobs whose
feature is not ported.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.serving import (EngineOverloadError, KVCacheManager,
                                      LLMEngine, NoFreeSlot, SamplingParams)
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


@pytest.fixture(scope="module")
def greedy_streams(model):
    eng = _engine(model, decode_block_size=4, attend_impl="masked")
    return [r.token_ids for r in eng.generate(
        _prompts(), SamplingParams(max_new_tokens=12))]


def _eos_params(streams, **kw):
    """Per-request EOS = the first token that differs from the stream's
    first token (so the stop lands after a few decode steps, mid-block)
    — None where the stream never changes."""
    out = []
    for toks in streams:
        eos = next((t for t in toks[1:] if t != toks[0]), None)
        out.append(dict(max_new_tokens=12, eos_token_id=eos, **kw))
    return out


def test_greedy_streams_match_jax_engine_with_eos(jax_model, model,
                                                  greedy_streams):
    params = _eos_params(greedy_streams)
    assert sum(p["eos_token_id"] is not None for p in params) >= 2
    jeng = JaxEngine(jax_model, max_slots=4, max_seq=64, seed=1,
                     attend_impl="masked", prefix_cache=False,
                     decode_block_size=4, register_stats=False)
    want = [r for r in jeng.generate(_prompts(),
                                     [JaxParams(**p) for p in params])]
    got = _engine(model, decode_block_size=4, attend_impl="masked").generate(
        _prompts(), [SamplingParams(**p) for p in params])
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.finish_reason for r in got] == \
        [r.finish_reason for r in want]
    stopped = [r for r in got if r.finish_reason == "stop"]
    assert stopped and all(1 < len(r.token_ids) < 12 for r in stopped)


@pytest.mark.parametrize("block", [1, 4, 8])
def test_engine_equals_single_request_bitwise(model, greedy_streams,
                                              block):
    params = [SamplingParams(**p) for p in _eos_params(greedy_streams)]
    batch = _engine(model, decode_block_size=block).generate(_prompts(),
                                                             params)
    for prompt, sp, res in zip(_prompts(), params, batch):
        solo = _engine(model, decode_block_size=block).generate([prompt],
                                                                sp)[0]
        assert solo.token_ids == res.token_ids
    if block == 4:
        assert [r.token_ids[:1] for r in batch] == \
            [s[:1] for s in greedy_streams]


def _sampled_params():
    return [SamplingParams(max_new_tokens=10, temperature=0.9),
            SamplingParams(max_new_tokens=10, temperature=1.1, top_k=20),
            SamplingParams(max_new_tokens=10, temperature=0.8, top_p=0.7),
            SamplingParams(max_new_tokens=10)]


def test_sampled_streams_invariant_to_block_size_and_lane(model):
    prompts = _prompts(seed=5)
    runs = {}
    for block in (1, 8):
        eng = _engine(model, decode_block_size=block, seed=11)
        runs[block] = [r.token_ids for r in eng.generate(prompts,
                                                         _sampled_params())]
    assert runs[1] == runs[8]
    # lane assignment: reorder the free stack so every request lands in
    # another slot (salts are assigned at queue-pop, order unchanged)
    eng = _engine(model, decode_block_size=8, seed=11)
    slots = [eng.cache.allocate() for _ in range(4)]
    for s in slots:                    # release 0..3: pops come out 3..0
        eng.cache.release(s)
    lanes = {}
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, _sampled_params())]
    eng.step()
    for slot, req in eng._active.items():
        lanes[req.rid] = slot
    eng.run_until_complete()
    assert [lanes[r] for r in rids] != [0, 1, 2, 3]
    assert [eng.result(r).token_ids for r in rids] == runs[8]
    # a different engine seed changes the sampled streams
    other = _engine(model, decode_block_size=8, seed=12).generate(
        prompts, _sampled_params())
    assert [r.token_ids for r in other][:3] != runs[8][:3]


def test_one_host_sync_per_dispatch_and_ragged_on_cpu(model,
                                                      greedy_streams):
    eng = _engine(model, decode_block_size=4, attend_impl="ragged")
    out = eng.generate(_prompts(), SamplingParams(max_new_tokens=12))
    st = eng.stats()
    assert st["host_syncs"] == st["decode_dispatches"] > 0
    assert st["decode_steps"] == 4 * st["decode_dispatches"]
    assert st["generated_tokens"] == sum(len(r.token_ids) for r in out)
    assert st["requests_completed"] == len(LENGTHS)
    assert st["ttft_p50_s"] > 0 and st["tokens_per_sec"] > 0
    # the ragged seam (plain split-K on CPU tensors) agrees with masked
    assert [r.token_ids for r in out] == greedy_streams


def test_overload_and_invalid_requests(model):
    eng = _engine(model, max_slots=1, max_queue=2)
    eng.submit(_prompts()[0])
    eng.submit(_prompts()[1])
    with pytest.raises(EngineOverloadError):
        eng.submit(_prompts()[2])
    assert eng.stats()["rejected_overload"] == 1
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.arange(60), SamplingParams(max_new_tokens=8))
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(NotImplementedError, match="best-of-n"):
        eng.submit([1, 2], SamplingParams(n=2))
    eng.run_until_complete()
    assert eng.stats()["requests_completed"] == 2


@pytest.mark.parametrize("knob,value", [
    ("prefix_cache", True), ("kv_layout", "paged"), ("kv_dtype", "int8"),
    ("speculate_k", 2), ("tp", 2), ("prefill_budget", 16),
    ("flight_dir", "flight"), ("prefill_chunk", 8)])
def test_unported_knob_raises(model, knob, value):
    """Unported features raise and name their ROADMAP item. The paged
    layout, int8 KV and speculative decoding are ported: with them, the
    prefix cache still raises."""
    knobs = {knob: value}
    if knob in ("kv_layout", "kv_dtype", "speculate_k"):
        knobs["prefix_cache"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP.*Queue 1"):
        _engine(model, **knobs)


def test_off_values_accepted_and_unknown_knob_rejected(model):
    eng = _engine(model, prefix_cache=False, overlap=False, tp=1,
                  kv_layout="slotted", speculate_k=0)
    assert eng.attend_impl == "masked"
    with pytest.raises(TypeError, match="unexpected"):
        _engine(model, no_such_knob=1)


def test_default_device_is_cuda_and_never_falls_back(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LLMEngine(model, max_slots=1, max_seq=64)


def test_cancel_and_deadline(model):
    eng = _engine(model, max_slots=1, decode_block_size=2)
    a = eng.submit(_prompts()[0], SamplingParams(max_new_tokens=20))
    b = eng.submit(_prompts()[1], SamplingParams(max_new_tokens=20))
    eng.step()
    assert eng.cancel(b) and eng.cancel(a)
    assert not eng.cancel(12345)
    eng.run_until_complete()
    ra, rb = eng.result(a), eng.result(b)
    assert ra.finish_reason == rb.finish_reason == "cancelled"
    assert rb.token_ids == [] and 0 < len(ra.token_ids) < 20
    c = eng.submit(_prompts()[2], SamplingParams(max_new_tokens=20,
                                                 deadline_s=1e-9))
    eng.run_until_complete()
    assert eng.result(c).finish_reason == "deadline"


def test_kv_cache_manager_lifecycle():
    c = KVCacheManager(2, 3, 16, 4, 8, device="cpu")
    s0, s1, s2 = c.allocate(), c.allocate(), c.allocate()
    assert sorted([s0, s1, s2]) == [0, 1, 2] and c.occupancy == 1.0
    with pytest.raises(NoFreeSlot):
        c.allocate()
    c.release(s1)
    assert c.allocate() == s1                  # LIFO reuse
    c.advance(s0, 16)
    with pytest.raises(ValueError, match="max_seq"):
        c.advance(s0, 1)
    c.release(s0)
    with pytest.raises(ValueError):
        c.release(s0)
    assert c.k[0].shape == (3, 16, 4, 8)
    assert c.nbytes() == 2 * 2 * 3 * 16 * 4 * 8 * 4
