"""Port speculative decoding (`paddle_tpu_torch/serving`: the accept
rule, the compaction, the int8 draft, the draft-and-verify block) against
the JAX reference, and the spec-on ≡ spec-off contract inside the port.

- `speculative_accept` and `compact_block` equal JAX's on random cases,
  bit for bit.
- `_int8_draft_params` on gpt_tiny fp32: the same keys; `qweight`,
  `w_scale` and everything shared equal JAX's bit for bit; `act_scale`
  to rtol 1e-6 (each package's float calibration forward reduces in its
  own order, so an observed maximum may move by an fp32 ulp or two).
- Inside the port, speculation on ≡ off token for token (the cases of
  tests/test_speculative.py:166-213 that the port has the knobs for):
  k in {2, 4}, slotted and paged, trunc and int8 drafts, an int8 KV
  cache, block sizes 1 and 16, draft depths, `max_slots=3`, greedy,
  sampled and EOS lanes; one host sync per dispatched block and
  `spec_proposed > 0`.
- The port's spec engine gives the JAX spec engine's greedy streams,
  where the reference's top-2 logit margin is above 1e-3 at every step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving import sampler as jax_sampler
from paddle_tpu.serving.engine import _int8_draft_params as jax_draft
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
from paddle_tpu_torch.serving import sampler
from paddle_tpu_torch.serving.engine import _int8_draft_params
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


def _mixed_params(eos=None):
    """Greedy and sampled lanes; lane 3 (greedy) stops at `eos`."""
    return [SamplingParams(max_new_tokens=6),
            SamplingParams(max_new_tokens=8, temperature=0.9),
            SamplingParams(max_new_tokens=5, temperature=0.8, top_k=16),
            SamplingParams(max_new_tokens=7, eos_token_id=eos),
            SamplingParams(max_new_tokens=9, temperature=1.1, top_p=0.7,
                           eos_token_id=7)]


def _run(model, prompts, params, **kw):
    eng = LLMEngine(model, device="cpu", **kw)
    res = eng.generate(prompts, params)
    return [r.token_ids for r in res], [r.finish_reason for r in res], \
        eng.stats()


# --------------------------------------------------------------------------- #
# the accept rule and the compaction, against JAX
# --------------------------------------------------------------------------- #

def _accept_case(rng, S, k, max_seq):
    W = k + 1
    target = rng.randint(0, 6, (S, W))
    drafted = np.where(rng.rand(S, k) < 0.6, target[:, :k],
                       rng.randint(0, 6, (S, k)))
    cur = rng.randint(0, 6, S)
    act = rng.rand(S) < 0.8
    pos = rng.randint(0, max_seq, S)
    rem = rng.randint(0, 8, S)
    eos = np.where(rng.rand(S) < 0.5, rng.randint(0, 6, S), -1)
    return drafted, target, cur, act, pos, rem, eos


@pytest.mark.parametrize("seed", range(6))
def test_speculative_accept_equals_jax(seed):
    rng = np.random.RandomState(seed)
    S, k, max_seq = 5, 1 + seed % 4, 16
    case = _accept_case(rng, S, k, max_seq)
    want = jax_sampler.speculative_accept(
        *(jnp.asarray(a.astype(np.int32) if a.dtype != bool else a)
          for a in case), max_seq)
    got = sampler.speculative_accept(
        *(torch.from_numpy(a.astype(np.int64) if a.dtype != bool else a)
          for a in case), max_seq)
    for name, w, g in zip(("emit", "toks", "cur", "pos", "rem", "act",
                           "accepted"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    emit = got[0].numpy()
    # prefix-shaped per lane, and an active lane always emits a token
    assert (np.diff(emit.astype(int), axis=1) <= 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_compact_block_equals_jax(seed):
    rng = np.random.RandomState(seed)
    steps, S = 12, 5
    toks = rng.randint(1, 100, (steps, S))
    emits = rng.rand(steps, S) < 0.5
    jt, je = jax_sampler.compact_block(jnp.asarray(toks.astype(np.int32)),
                                       jnp.asarray(emits))
    pt_, pe = sampler.compact_block(torch.from_numpy(toks),
                                    torch.from_numpy(emits))
    np.testing.assert_array_equal(pt_.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))


def test_verify_draws_equal_plain_draws():
    """A verify draw at (salt, position) is the plain step's draw there."""
    rng = np.random.RandomState(3)
    S, W, V = 3, 4, 64
    logits = torch.from_numpy(rng.randn(S, W, V).astype(np.float32) * 2)
    salts = torch.tensor([5, 9, 2])
    pos = torch.tensor([[4, 5, 6, 7], [10, 11, 12, 13], [0, 1, 2, 3]])
    temp = torch.tensor([0.0, 0.9, 1.2])
    topk = torch.tensor([0, 8, 0])
    topp = torch.tensor([1.0, 1.0, 0.8])
    got = sampler.sample_verify_tokens(logits, 7, salts, pos, temp, topk,
                                       topp)
    for j in range(W):
        want = sampler.sample_tokens_per_lane(logits[:, j], 7, salts,
                                              pos[:, j], temp, topk, topp)
        assert torch.equal(got[:, j], want)


# --------------------------------------------------------------------------- #
# the int8 draft against JAX's
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("layers", [4, 2])
def test_int8_draft_params_equal_jax(jax_model, model, layers):
    want = {k: np.asarray(v) for k, v in jax_draft(
        jax_model.cfg, jax_model.raw_parameters(), layers).items()}
    got = {k: v.numpy() for k, v in _int8_draft_params(
        model.cfg, model.serving_params(), layers).items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.endswith(".act_scale"):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["lm_head.qweight"].shape == (128, 1024)      # wte.T


def test_int8_draft_needs_fp_weights(model):
    from paddle_tpu_torch.quantization import PTQ
    q = gpt_tiny(device="cpu")
    q.load_state_dict(model.state_dict())
    ptq = PTQ()
    ptq.quantize(q)
    ptq.sample(q, [np.arange(16)[None]])
    ptq.convert(q)
    with pytest.raises(ValueError, match="trunc"):
        LLMEngine(q, max_slots=2, max_seq=64, device="cpu", speculate_k=2,
                  draft="int8")
    # an int8 target speculates with the trunc draft, K7's plain
    # version serving the draft and verify steps
    prompts = _prompts((5, 9))
    sp = SamplingParams(max_new_tokens=6)
    ref, _, _ = _run(q, prompts, sp, max_slots=2, max_seq=64)
    out, _, st = _run(q, prompts, sp, max_slots=2, max_seq=64,
                      speculate_k=2)
    assert out == ref and st["spec_proposed"] > 0


# --------------------------------------------------------------------------- #
# speculation on ≡ off, inside the port
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def reference(model):
    """The spec-off streams of the matrix load, per KV dtype, and its
    params: lane 3's EOS is the 4th token of its stream in a first run
    without it (the runs with it are that run up to the EOS)."""
    prompts = _prompts((5, 40, 9, 24, 13), seed=0)
    cfg = dict(max_slots=3, max_seq=64, seed=3)
    first, _, _ = _run(model, prompts, _mixed_params(), **cfg)
    params = _mixed_params(eos=first[3][3])
    out = {}
    for kv in (None, "int8"):
        toks, reasons, _ = _run(model, prompts, params, kv_dtype=kv, **cfg)
        out[kv] = (toks, reasons)
    assert out[None][1][3] == "stop"          # the EOS lane stops early
    return prompts, cfg, params, out


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("extra", [
    dict(), dict(kv_layout="paged", page_size=16), dict(draft="int8"),
    dict(draft="int8", kv_layout="paged", page_size=16),
    dict(kv_dtype="int8"), dict(draft="int8", kv_dtype="int8",
                                kv_layout="paged", page_size=16),
    dict(attend_impl="ragged"),
    dict(draft="int8", kv_layout="paged", page_size=16,
         attend_impl="ragged")],
    ids=["slotted", "paged", "int8_draft", "int8_draft_paged", "kv_int8",
         "int8_all_paged", "ragged", "ragged_paged_int8_draft"])
def test_spec_on_equals_off(model, reference, k, extra):
    prompts, cfg, params, ref = reference
    toks, reasons, st = _run(model, prompts, params, speculate_k=k, **cfg,
                             **extra)
    assert (toks, reasons) == ref[extra.get("kv_dtype")]
    assert st["spec_blocks"] > 0 and st["spec_proposed"] > 0
    assert 0 <= st["spec_accepted"] <= st["spec_proposed"]
    assert st["spec_fallbacks"] == 0
    assert st["host_syncs"] == st["decode_dispatches"] == st["spec_blocks"]
    assert st["decode_steps"] == st["decode_dispatches"] * \
        max(1, 8 // (k + 1)) * (k + 1)


@pytest.mark.parametrize("extra", [
    dict(speculate_k=2, decode_block_size=1),
    dict(speculate_k=4, decode_block_size=16),
    dict(speculate_k=2, draft_layers=2), dict(speculate_k=2, draft_layers=4),
    dict(speculate_k=3, draft="int8", draft_layers=1,
         decode_block_size=16)])
def test_block_sizes_and_draft_depths(model, reference, extra):
    prompts, cfg, params, ref = reference
    toks, reasons, _ = _run(model, prompts, params, **cfg, **extra)
    assert (toks, reasons) == ref[None]


def test_identical_sampled_prompts_stay_distinct(model):
    p = _prompts([9], seed=9)[0]
    sp = SamplingParams(max_new_tokens=10, temperature=0.9)
    cfg = dict(max_slots=3, max_seq=64, seed=2)
    ref, _, _ = _run(model, [p, p, p], [sp, sp, sp], **cfg)
    assert not (ref[0] == ref[1] == ref[2])
    out, _, _ = _run(model, [p, p, p], [sp, sp, sp], speculate_k=2, **cfg)
    assert out == ref


def test_knobs_validated(model):
    kw = dict(max_slots=2, max_seq=64, device="cpu")
    with pytest.raises(ValueError, match="speculate_k"):
        LLMEngine(model, speculate_k=-1, **kw)
    with pytest.raises(ValueError, match="draft must"):
        LLMEngine(model, speculate_k=2, draft="tiny", **kw)
    with pytest.raises(ValueError, match="draft_layers"):
        LLMEngine(model, speculate_k=2, draft_layers=5, **kw)
    with pytest.raises(ValueError, match="needs speculate_k"):
        LLMEngine(model, draft_layers=2, **kw)
    eng = LLMEngine(model, speculate_k=3, decode_block_size=8, **kw)
    assert (eng.draft_layers, eng.spec_rounds) == (1, 2)       # L // 6
    eng = LLMEngine(model, speculate_k=3, draft="int8", **kw)
    assert eng.draft_layers == 4                               # L
    assert eng._block_capacity == 8


# --------------------------------------------------------------------------- #
# the port's spec engine against the JAX spec engine
# --------------------------------------------------------------------------- #

def test_spec_greedy_streams_equal_jax_engine(jax_model, model):
    prompts = _prompts((5, 11, 9), seed=4)
    new = 8
    kw = dict(max_slots=3, max_seq=64, seed=1, speculate_k=2)
    jeng = JaxEngine(jax_model, attend_impl="masked", prefix_cache=False,
                     register_stats=False, **kw)
    want = [r.token_ids for r in jeng.generate(
        prompts, JaxParams(max_new_tokens=new))]
    for p, toks in zip(prompts, want):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])
        lg = np.asarray(jax_model(jnp.asarray(seq[None])))[0, p.size - 1:]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
    eng = LLMEngine(model, device="cpu", **kw)
    got = eng.generate(prompts, SamplingParams(max_new_tokens=new))
    assert [r.token_ids for r in got] == want
    st = eng.stats()
    assert st["spec_proposed"] > 0
    assert st["host_syncs"] == st["decode_dispatches"]
