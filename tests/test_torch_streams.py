"""The port engine's stream and lifecycle surface against the JAX
engine's (`attach_stream` / `detach_stream`, `has_result` /
`peek_result`, `close` and the context manager).

- `attach_stream`'s events on one gpt_tiny load equal the JAX engine's,
  event for event: sinks attached while queued, one attached late
  (its emitted tokens replay as one ("tokens", 0, ...) event), one
  attached after its request finished (replay + "finished" at once),
  where the reference's top-2 margin is above 1e-3 at every step.
- A detached sink hears nothing more; a sink that raises is dropped
  and its request goes on; cancel, extract and unqueue end a stream as
  the reference does.
- `has_result` / `peek_result` read without collecting.
- After `close()` the calls that feed or drive the engine raise
  `RuntimeError("engine closed")`, and `result`, `stats` and `snapshot`
  still work.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
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


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


PROMPTS = _prompts((9, 17, 5, 30, 12))
NEW = (7, 11, 5, 9, 6)
KW = dict(max_slots=2, max_seq=64, seed=1, decode_block_size=3,
          attend_impl="masked")


def _drive(eng, params_cls):
    """Submit the load; attach rids 0, 2 and 3 while queued, rid 1 after
    two steps (it has emitted by then), rid 4 after everything finished
    (uncollected). Returns (events per rid, streams)."""
    events = {}

    def attach(rid):
        events[rid] = []
        assert eng.attach_stream(rid, lambda *a: events[rid].append(a))

    rids = [eng.submit(p, params_cls(max_new_tokens=n))
            for p, n in zip(PROMPTS, NEW)]
    for r in (rids[0], rids[2], rids[3]):
        attach(r)
    eng.step()
    eng.step()
    attach(rids[1])
    while eng.has_work():
        eng.step()
    attach(rids[4])
    return events, [eng.result(r).token_ids for r in rids]


def test_stream_events_match_jax_engine(jax_model, model):
    jeng = JaxEngine(jax_model, register_stats=False, trace=False, **KW)
    want, want_streams = _drive(jeng, JaxParams)
    margins = reference_margins(jax_model, PROMPTS, want_streams)
    print(f"smallest reference top-2 margin per stream: {margins}")
    assert min(margins) > 1e-3, f"near-tie in the reference: {margins}"
    got, streams = _drive(LLMEngine(model, device="cpu", **KW),
                          SamplingParams)
    assert streams == want_streams
    assert got == want
    # the late attach replayed what request 1 had emitted, then went on
    late = got[1]
    assert late[0][:2] == ("tokens", 0) and len(late[0][2]) > 1
    # every stream reassembles to its result, and ends in one finish
    for rid, ev in got.items():
        toks = []
        for kind, *payload in ev[:-1]:
            assert kind == "tokens"
            start, ids = payload
            assert start <= len(toks)
            toks[start:start + len(ids)] = ids
        assert toks == streams[rid]
        assert ev[-1] == ("finished", "length", None)


def test_detach_and_a_broken_sink(model):
    eng = LLMEngine(model, device="cpu", **KW)
    rids = [eng.submit(p, SamplingParams(max_new_tokens=n))
            for p, n in zip(PROMPTS[:2], NEW[:2])]
    heard = []
    assert eng.attach_stream(rids[0], lambda *a: heard.append(a))

    def broken(*a):
        raise ValueError("client went away")

    assert eng.attach_stream(rids[1], broken)
    eng.step()
    n = len(heard)
    assert n >= 1
    eng.detach_stream(rids[0])
    eng.detach_stream(12345)                 # unknown: a no-op
    eng.run_until_complete(max_steps=100)
    assert len(heard) == n
    assert rids[1] not in eng._streams       # dropped at its first event
    assert [len(eng.result(r).token_ids) for r in rids] == list(NEW[:2])
    assert not eng.attach_stream(12345, heard.append)


def test_cancel_extract_unqueue_end_streams(model):
    """A cancelled queued request's stream gets ("finished",
    "cancelled", None); an extracted or unqueued one is dropped
    silently (its new owner's attach replays from zero)."""
    eng = LLMEngine(model, device="cpu", **{**KW, "max_slots": 1})
    rids = [eng.submit(p, SamplingParams(max_new_tokens=20))
            for p in PROMPTS[:3]]
    events = {r: [] for r in rids}
    for r in rids:
        eng.attach_stream(r, lambda *a, r=r: events[r].append(a))
    eng.step()
    assert eng.cancel(rids[2])
    assert events[rids[2]] == [("finished", "cancelled", None)]
    d = eng.unqueue(rids[1])
    assert d is not None and rids[1] not in eng._streams
    d = eng.extract(rids[0])
    assert d is not None and rids[0] not in eng._streams
    n = len(events[rids[0]])
    eng.run_until_complete(max_steps=100)
    assert len(events[rids[0]]) == n and events[rids[1]] == []
    assert not eng.has_result(rids[0])      # a handoff records no result


def test_has_result_and_peek_result(model):
    eng = LLMEngine(model, device="cpu", **KW)
    rid = eng.submit(PROMPTS[0], SamplingParams(max_new_tokens=4))
    assert not eng.has_result(rid) and eng.peek_result(rid) is None
    eng.run_until_complete(max_steps=100)
    assert eng.has_result(rid)
    peeked = eng.peek_result(rid)
    assert eng.peek_result(rid) is peeked and eng.has_result(rid)
    assert eng.result(rid) is peeked
    assert not eng.has_result(rid) and eng.peek_result(rid) is None
    assert not eng.has_result(999) and eng.peek_result(999) is None


def test_close_and_context_manager(model):
    sp = SamplingParams(max_new_tokens=4)
    with LLMEngine(model, device="cpu", **KW) as eng:
        done = eng.submit(PROMPTS[0], sp)
        eng.run_until_complete(max_steps=100)
        queued = eng.submit(PROMPTS[1], sp)
    assert eng._closed
    calls = (lambda: eng.submit(PROMPTS[0], sp), eng.step,
             lambda: eng.generate([PROMPTS[0]], sp),
             eng.run_until_complete, lambda: eng.cancel(queued),
             lambda: eng.extract(queued), lambda: eng.unqueue(queued),
             lambda: eng.adopt({"rid": 7, "prompt": PROMPTS[0],
                                "params": {"max_new_tokens": 4},
                                "generated": []}))
    for call in calls:
        with pytest.raises(RuntimeError, match="engine closed"):
            call()
    # what a shutting-down server still needs
    assert eng.stats()["requests_submitted"] == 2
    snap = eng.snapshot()
    assert [r["rid"] for r in snap["queued"]] == [queued]
    assert eng.result(done).finish_reason == "length"
    eng.close()                              # idempotent
