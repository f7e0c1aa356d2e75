"""The serving engine's dispatch loop (`paddle_tpu_torch/serving/engine.py`
and `serving/graphs.py`) on `gpt_tiny` on the CPU, where a block
program runs directly on the same static buffers a CUDA graph replays.

- Overlap on ≡ off, token for token, for greedy, sampled and EOS lanes,
  on both layouts, with fp and int8 KV and with speculation (trunc and
  int8 drafts); the lookahead really runs.
- One host sync per processed block; `has_work()` stays true while a
  block is in flight after every request has finished.
- The static-buffer staging: the lane state chains across blocks with
  no upload; after a discard the mirrors are re-uploaded and the
  streams are unchanged; a warm-up with every lane frozen (what a
  capture runs under) changes neither the lane state nor any stream.
- The launch counters' capture/replay accounting, on stub counters.
- The knobs `overlap`, `max_retries`, `retry_backoff_s`,
  `retry_backoff_max_s`: the reference's defaults and validation.
- Cross-package: the port's greedy streams at `overlap=True` equal the
  JAX engine's at its defaults, where the reference's top-2 logit
  margin is above 1e-3 at every step (the margins are printed); under
  one seeded fault plan both engines fire the same points at the same
  call numbers and fail the same requests, with the same post-mortems.
"""
import inspect

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
from paddle_tpu_torch.ops_cuda.decode_attention import _LaunchCounter
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
from paddle_tpu_torch.serving import graphs
from port_threads import one_torch_thread  # noqa: F401

CONFIGS = {
    "slotted": {},
    "paged": dict(kv_layout="paged", page_size=16),
    "int8_kv": dict(kv_dtype="int8"),
    "paged_int8_kv": dict(kv_layout="paged", page_size=16, kv_dtype="int8"),
    "spec_trunc": dict(speculate_k=2),
    "spec_int8": dict(speculate_k=2, draft="int8"),
    "spec_paged_int8_kv": dict(speculate_k=3, draft="int8",
                               kv_layout="paged", page_size=16,
                               kv_dtype="int8"),
}


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

def _leaked(eng) -> int:
    """Pages held beyond the trash page once the prefix tree's
    (legitimate) holdings are released."""
    if eng.prefix is not None:
        eng.prefix.clear()
    return eng.cache.pool.leaked()


def _prompts(lengths=(5, 13, 9, 21, 7), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def _params(eos=None):
    """Greedy, sampled and EOS lanes of different budgets."""
    return [SamplingParams(max_new_tokens=30),
            SamplingParams(max_new_tokens=24, temperature=0.9),
            SamplingParams(max_new_tokens=17, temperature=0.8, top_k=16),
            SamplingParams(max_new_tokens=28, eos_token_id=eos),
            SamplingParams(max_new_tokens=20, temperature=1.1, top_p=0.7)]


def _engine(model, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_seq", 64)
    kw.setdefault("decode_block_size", 4)
    kw.setdefault("seed", 3)
    return LLMEngine(model, device="cpu", **kw)


def _run(eng, prompts, params):
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run_until_complete(max_steps=500)
    return [eng.result(r) for r in rids]


@pytest.fixture(scope="module")
def eos(model):
    """An EOS id for lane 3: its 6th token in a run without one."""
    return _run(_engine(model), _prompts(), _params())[3].token_ids[5]


def _spy_syncs(monkeypatch):
    """Count the host waits on block outputs (the real syncs)."""
    waits = {"n": 0}
    real = graphs.BlockResult.wait

    def wait(self):
        waits["n"] += 1
        return real(self)

    monkeypatch.setattr(graphs.BlockResult, "wait", wait)
    return waits


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_overlap_on_equals_off(model, eos, config, monkeypatch):
    streams, stats = {}, {}
    for overlap in (False, True):
        eng = _engine(model, overlap=overlap, **CONFIGS[config])
        ahead = []
        real = eng._process_block

        def process(blk, eng=eng, ahead=ahead, real=real):
            ahead.append(eng._ahead is not None)
            real(blk)

        eng._process_block = process
        waits = _spy_syncs(monkeypatch)
        res = _run(eng, _prompts(), _params(eos))
        streams[overlap] = [(r.token_ids, r.finish_reason) for r in res]
        st = eng.stats()
        stats[overlap] = st
        assert waits["n"] == st["host_syncs"] == st["decode_dispatches"]
        assert any(ahead) == overlap      # the lookahead ran (or not)
        assert eng.cache.num_free == eng.max_slots and not eng.has_work()
        if eng.paged:
            assert _leaked(eng) == 0
        assert st["graph_captures"] == 0            # no graph on the CPU
    assert streams[True] == streams[False]
    assert streams[True][3][1] == "stop"
    if "spec" in config:
        assert stats[True]["spec_proposed"] > 0
        assert stats[True]["spec_blocks"] == stats[True]["decode_dispatches"]


def test_has_work_while_a_block_is_in_flight(model, eos):
    """A lane stopping at its EOS leaves the lookahead block in flight
    after every request has finished and retired: `has_work()` stays
    true until that block is processed (emitting nothing)."""
    eng = _engine(model, max_slots=1)
    rid = eng.submit(_prompts()[3], _params(eos)[3])
    seen = False
    for _ in range(100):
        if not eng.has_work():
            break
        eng.step()
        if not eng._active and eng._inflight is not None:
            seen = True
            assert eng.has_work()
    assert seen and not eng.has_work()
    assert eng.result(rid).finish_reason == "stop"
    st = eng.stats()
    assert st["host_syncs"] == st["decode_dispatches"]


def test_lane_state_chains_without_upload(model):
    """Between admissions the next block replays off the previous one's
    chained state: no upload, and the static buffers agree with the host
    mirrors after each processed block (overlap off)."""
    eng = _engine(model, overlap=False)
    uploads = {"n": 0}
    real = eng._lanes.upload

    def upload(arrays):
        uploads["n"] += 1
        real(arrays)

    eng._lanes.upload = upload
    for p, sp in zip(_prompts()[:3], _params()[:3]):
        eng.submit(p, sp)
    eng.step()                                   # admits 3, one upload
    assert uploads["n"] == 1 and not eng._dirty
    for _ in range(3):
        eng.step()
        bufs = eng._lanes.bufs
        live = eng._act
        assert live.any()
        for k in ("cur", "pos", "rem"):
            np.testing.assert_array_equal(bufs[k].numpy()[live],
                                          getattr(eng, "_" + k)[live])
        np.testing.assert_array_equal(bufs["act"].numpy(), live)
    assert uploads["n"] == 1


@pytest.mark.parametrize("config", ["slotted", "paged", "spec_trunc"])
def test_discard_reuploads_mirrors(model, eos, config):
    """A lookahead block discarded unprocessed leaves the static buffers
    one block ahead of the host mirrors; the next dispatch re-uploads
    the mirrors into them, and every stream equals an undisturbed run."""
    ref = [r.token_ids for r in _run(_engine(model, **CONFIGS[config]),
                                     _prompts(), _params(eos))]
    eng = _engine(model, **CONFIGS[config])
    uploads = {"n": 0}
    real = eng._lanes.upload

    def upload(arrays):
        uploads["n"] += 1
        real(arrays)

    eng._lanes.upload = upload
    rids = [eng.submit(p, sp) for p, sp in zip(_prompts(), _params(eos))]
    discarded = 0
    for _ in range(500):
        if not eng.has_work():
            break
        eng.step()
        if eng._inflight is not None and discarded < 2:
            # the lookahead advanced the live lanes past the mirrors
            assert not np.array_equal(eng._lanes.bufs["pos"].numpy(),
                                      eng._pos)
            eng._discard_inflight()
            assert eng._dirty and eng._inflight is None
            n = uploads["n"]
            eng.step()                   # dispatches: uploads first
            assert uploads["n"] == n + 1
            discarded += 1
    assert discarded == 2
    assert [eng.result(r).token_ids for r in rids] == ref


@pytest.mark.parametrize("config", ["slotted", "paged_int8_kv",
                                    "spec_int8"])
def test_frozen_warm_up_leaves_state_and_streams(model, eos, config):
    """Mid-run, one block run with every lane frozen (what warm-up and
    capture run under on a card) writes only rows no live lane attends
    and leaves the chained lane state as it was: the streams are those
    of an undisturbed run."""
    ref = [r.token_ids for r in _run(_engine(model, **CONFIGS[config]),
                                     _prompts(), _params(eos))]
    eng = _engine(model, **CONFIGS[config])
    rids = [eng.submit(p, sp) for p, sp in zip(_prompts(), _params(eos))]
    warmed = 0
    for _ in range(500):
        if not eng.has_work():
            break
        eng.step()
        if eng._runners and warmed < 4:
            runner = eng._runners[bool(eng.speculate_k)]
            state = {k: v.clone() for k, v in eng._lanes.bufs.items()}
            with runner.frozen():
                assert not eng._lanes.bufs["act"].any()
                runner._step()
            for k, v in eng._lanes.bufs.items():
                assert torch.equal(v, state[k]), k
            warmed += 1
    assert warmed == 4
    assert [eng.result(r).token_ids for r in rids] == ref


def test_launch_counters_capture_and_replay_on_a_stub(monkeypatch):
    """Warm-up and capture run no processed block: every counter is
    restored afterwards. The capture's launches are recorded per counter
    and added by each replay."""
    monkeypatch.setattr(_LaunchCounter, "instances", [])
    a, b, c = _LaunchCounter(), _LaunchCounter(), _LaunchCounter()
    a.count, b.count = 10, 4

    def warm_up():
        a.count += 3
        c.count += 1

    def capture():
        a.count += 2
        b.count += 5

    deltas = graphs.counted_capture(warm_up, capture)
    assert deltas == [2, 5, 0]
    assert (a.count, b.count, c.count) == (10, 4, 0)
    for n in range(1, 4):
        graphs.count_replay(deltas)
        assert (a.count, b.count, c.count) == (10 + 2 * n, 4 + 5 * n, 0)

    def failing():
        a.count += 7
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.counted_capture(warm_up, failing)
    assert (a.count, b.count, c.count) == (16, 19, 0)


def test_runners_one_per_program(model):
    """The CPU runs block programs ungraphed (no capture is counted);
    a speculative engine builds its plain runner only when a block
    degrades."""
    eng = _engine(model)
    _run(eng, _prompts()[:2], _params()[:2])
    assert sorted(eng._runners) == [False]
    assert eng._runners[False].graph is None
    spec = _engine(model, speculate_k=2)
    _run(spec, _prompts()[:2], _params()[:2])
    assert sorted(spec._runners) == [True]
    assert spec.stats()["graph_captures"] == 0


def test_dispatch_knobs_defaults_and_validation(model):
    ref = inspect.signature(JaxEngine.__init__).parameters
    ours = inspect.signature(LLMEngine.__init__).parameters
    for knob in ("overlap", "max_retries", "retry_backoff_s",
                 "retry_backoff_max_s"):
        assert ours[knob].default == ref[knob].default, knob
    eng = _engine(model)
    assert (eng.overlap, eng.max_retries, eng.retry_backoff_s,
            eng.retry_backoff_max_s) == (True, 2, 0.05, 1.0)
    with pytest.raises(ValueError, match="max_retries"):
        _engine(model, max_retries=-1)
    for kw in (dict(retry_backoff_s=-0.1), dict(retry_backoff_max_s=-1)):
        with pytest.raises(ValueError, match="backoff"):
            _engine(model, **kw)


def test_greedy_streams_match_jax_engine_defaults(jax_model, model):
    """The port at `overlap=True` (its default) against the JAX engine
    at its defaults (overlap on, prefix cache on, block 8, masked
    attention on the CPU): equal greedy streams, checked where the
    reference's top-2 logit margin is above 1e-3 at every step."""
    prompts = _prompts(seed=4)
    want = [r.token_ids for r in JaxEngine(
        jax_model, max_slots=4, max_seq=64, seed=1,
        register_stats=False).generate(prompts,
                                       JaxParams(max_new_tokens=16))]
    cfg = jax_model.cfg
    params = jax_model.raw_parameters()
    margins = []
    for p, toks in zip(prompts, want):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])[None]
        jk = jnp.zeros((cfg.num_layers, 1, seq.shape[1], cfg.num_heads,
                        cfg.hidden_size // cfg.num_heads))
        lg, _, _ = jax_decode_forward(cfg, params, jnp.asarray(seq), 0, jk,
                                      jnp.zeros_like(jk))
        top2 = np.sort(np.asarray(lg)[0, len(p) - 1:], axis=-1)[:, -2:]
        margins.append(float((top2[:, 1] - top2[:, 0]).min()))
    print(f"smallest reference top-2 margin per stream: {margins}")
    assert min(margins) > 1e-3, f"near-tie in the reference: {margins}"
    eng = LLMEngine(model, max_slots=4, max_seq=64, seed=1, device="cpu")
    assert eng.overlap
    got = [r.token_ids for r in _run(eng, prompts,
                                     [SamplingParams(max_new_tokens=16)]
                                     * len(prompts))]
    assert got == want


def test_fault_plan_fails_what_the_jax_engine_fails(jax_model, model):
    """One seeded fault plan over the port's engine and the JAX engine
    (both at overlap on, one retry): the points fire at the same call
    numbers, the same requests fail (one at admission, others when
    decode stays down) with the same post-mortems, and the streams
    agree (the survivors' in full, the failed ones as far as they
    got)."""
    from paddle_tpu.testing import faults as jax_faults
    from paddle_tpu_torch.testing import faults

    def plan(module):
        return (module.FaultPlan()
                .fail_rate("decode_dispatch", 0.25, seed=7)
                .fail_rate("host_sync", 0.2, seed=7)
                .fail_rate("prefill", 0.3, seed=7))

    prompts = _prompts(seed=4) + _prompts((6, 11, 3), seed=9)
    kw = dict(max_slots=4, max_seq=64, seed=1, max_retries=1,
              retry_backoff_s=0.0)
    jeng = JaxEngine(jax_model, register_stats=False, **kw)
    jplan = plan(jax_faults)
    with jax_faults.inject(jplan):
        want = jeng.generate(prompts, JaxParams(max_new_tokens=16))
    eng = LLMEngine(model, device="cpu", **kw)
    pplan = plan(faults)
    with faults.inject(pplan):
        got = _run(eng, prompts, [SamplingParams(max_new_tokens=16)]
                   * len(prompts))
    assert pplan.calls == jplan.calls and pplan.injected == jplan.injected
    assert sum(pplan.injected.values()) > 0
    assert [r.finish_reason for r in got] == \
        [r.finish_reason for r in want]
    reasons = [r.finish_reason for r in got]
    assert "error" in reasons and "length" in reasons
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [(p["reason"], p["detail"]["failed_rids"])
            for p in pplan.postmortems] == \
        [(p["reason"], p["detail"]["failed_rids"])
         for p in jplan.postmortems]
    assert {p["reason"] for p in pplan.postmortems} == \
        {"admission_failed", "decode_retry_exhausted"}
    assert eng.metrics.retries == jeng.metrics.retries
    assert eng.metrics.failed_requests == jeng.metrics.failed_requests
