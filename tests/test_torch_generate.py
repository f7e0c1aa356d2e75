"""The port's model-side generation surface (`paddle_tpu_torch/models/
gpt.py`: `init_cache`, `forward(caches=, cache_position=)`, `generate`,
`generate_jit` / `generate_compiled`, `beam_search` /
`beam_search_compiled`) against the JAX `GPT` on `gpt_tiny` with the
same weights, and the reference's own generation tests
(`tests/test_models.py`, the int8 cases of `tests/test_quantization.py`)
held inside the port.

- The cached forward's logits and cache rows equal JAX's within
  TOL = 1e-4 (prefill, then single-token steps).
- Greedy `generate` and `generate_jit` streams equal JAX's where the
  reference's top-2 logit margin is above 1e-3 at every step;
  `generate_jit` equals the port's eager `generate` bit for bit (one
  step function); `generate_greedy` is `generate_jit` at temperature 0.
- Sampling matches the reference in law, not in bits (a torch
  generator, Gumbel-max in the graph): seeded determinism, token
  bounds, and every sampled token inside the reference's top-k kept set
  at its step.
- Beam search: beam 1 equals greedy; beam = vocab over 2 steps equals a
  brute force over the port's plain forward, with and without an EOS
  (the finished pool); beams and scores equal JAX's where every pruning
  and the final choice clear a 1e-4 beam-score margin.
- Int8 PTQ: `generate_jit` keeps >= 0.6 of the fp model's generated
  tokens (the reference's bar); eager int8 `generate` equals it.
On the CPU nothing is captured: CUDA graphs are the card's
(`chip_smoke.py` phase 4j).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.models import GPT, GPTConfig, gpt_tiny, load_jax_params
from paddle_tpu_torch.models import gpt as port_gpt
from port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4


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


def _ids(b, s, seed=0, vocab=1024):
    return np.random.RandomState(seed).randint(0, vocab, (b, s))


def _jax_margins(jax_model, seqs, prompt):
    """The reference's smallest top-2 logit margin over the positions
    that decided each generated token of `seqs` (b, total)."""
    lg = np.asarray(jax_model(jnp.asarray(seqs[:, :-1])))
    top2 = np.sort(lg[:, prompt - 1:], axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


# ---------------------------------------------------------------------- #
# init_cache and the cached forward
# ---------------------------------------------------------------------- #

def test_init_cache_shapes_and_errors(model):
    caches = model.init_cache(2, 16)
    assert len(caches) == model.cfg.num_layers
    for k, v in caches:
        assert k.shape == v.shape == (2, 16, 4, 32)
        assert k.dtype == model.dtype and not k.any()
    assert model.init_cache(1, 8, dtype="bf16")[0][0].dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="max_seq_len"):
        model.init_cache(1, 257)
    with pytest.raises(ValueError, match="cache_position"):
        model(torch.zeros((1, 4), dtype=torch.long), caches=caches)


def test_cached_forward_matches_jax(jax_model, model):
    """Prefill of 8 tokens, then three single-token steps: the port's
    logits and cache rows against JAX's `forward(caches=...)`."""
    ids = _ids(2, 11, seed=1)
    jc = jax_model.init_cache(2, 16)
    pc = model.init_cache(2, 16)
    for pos, width in ((0, 8), (8, 1), (9, 1), (10, 1)):
        piece = ids[:, pos:pos + width]
        jl, jc = jax_model(jnp.asarray(piece), caches=jc,
                           cache_position=pos)
        with torch.no_grad():
            pl, pc = model(torch.from_numpy(piece), caches=pc,
                           cache_position=pos)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
    for (jk, jv), (pk, pv) in zip(jc, pc):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=TOL,
                                   atol=TOL)
    # the cached pass's last logits are the plain forward's
    full = model(torch.from_numpy(ids)).detach()
    np.testing.assert_allclose(pl[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------- #
# generate / generate_jit
# ---------------------------------------------------------------------- #

def test_greedy_streams_equal_jax(jax_model, model):
    ids = _ids(2, 8, seed=0)
    want = np.asarray(jax_model.generate(ids, max_new_tokens=10,
                                         temperature=0.0))
    np.testing.assert_array_equal(
        np.asarray(jax_model.generate_jit(ids, max_new_tokens=10)), want)
    margin = _jax_margins(jax_model, want, 8)
    print(f"smallest reference top-2 margin: {margin:.4g}")
    assert margin > 1e-3, f"near-tie in the reference: {margin}"
    eager = model.generate(ids, max_new_tokens=10, temperature=0.0)
    graph = model.generate_jit(ids, max_new_tokens=10)
    np.testing.assert_array_equal(eager.numpy(), want)
    np.testing.assert_array_equal(graph.numpy(), want)
    # rng None is greedy at any temperature, as in the reference
    np.testing.assert_array_equal(
        model.generate(ids, max_new_tokens=10).numpy(), want)


def test_generate_jit_is_eager_generate_bitwise(model):
    ids = _ids(3, 6, seed=5)
    a = model.generate_jit(ids, max_new_tokens=12)
    b = model.generate(ids, max_new_tokens=12, temperature=0.0)
    c = port_gpt.generate_greedy(model, ids, max_new_tokens=12)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert a.dtype == torch.int64 and a.shape == (3, 18)
    # the CPU builds no graph
    assert "_graph_capture_count" not in model.__dict__


def _kept_sets_hold(jax_model, seqs, prompt, temperature, top_k):
    """Every generated token of `seqs` lies in the reference's kept set
    at its step: logits / T >= the top_k-th largest."""
    lg = np.asarray(jax_model(jnp.asarray(seqs[:, :-1])))[:, prompt - 1:]
    lg = lg / max(temperature, 1e-6)
    kth = np.sort(lg, axis=-1)[..., -top_k]
    tok = seqs[:, prompt:]
    picked = np.take_along_axis(lg, tok[..., None], axis=-1)[..., 0]
    # a 1e-4 slack for the packages' float differences at the boundary
    return bool((picked >= kth - 1e-4).all())


def test_sampled_generate_jit(jax_model, model):
    ids = _ids(2, 4, seed=1)
    kw = dict(max_new_tokens=12, temperature=0.8, top_k=8)
    a = model.generate_jit(ids, seed=3, **kw)
    b = model.generate_jit(ids, seed=3, **kw)
    c = model.generate_jit(ids, seed=4, **kw)
    assert torch.equal(a, b), "seeded determinism"
    assert not torch.equal(a, c), "another seed, the same tokens"
    assert a.shape == (2, 16) and torch.equal(a[:, :4], torch.from_numpy(ids))
    assert int(a.min()) >= 0 and int(a.max()) < 1024
    for out in (a, c):
        assert _kept_sets_hold(jax_model, out.numpy(), 4, 0.8, 8)
    # top_k = 1 is greedy in law and in fact
    g = model.generate_jit(ids, max_new_tokens=12, temperature=0.8,
                           top_k=1, seed=9)
    assert torch.equal(g, model.generate_jit(ids, max_new_tokens=12))


def test_sampled_generate_with_rng(jax_model, model):
    ids = _ids(2, 5, seed=2)
    kw = dict(max_new_tokens=10, temperature=0.9, top_k=5)
    a = model.generate(ids, rng=torch.Generator().manual_seed(1), **kw)
    b = model.generate(ids, rng=torch.Generator().manual_seed(1), **kw)
    c = model.generate(ids, rng=torch.Generator().manual_seed(2), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    for out in (a, c):
        assert _kept_sets_hold(jax_model, out.numpy(), 5, 0.9, 5)


def test_top_k_keeps_ties():
    lg = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    out = port_gpt._top_k_mask(lg, 2)
    assert torch.isinf(out).tolist() == [[True, False, False, True, False]]
    assert torch.equal(port_gpt._top_k_mask(lg, 0), lg)


def test_bounds_and_zero_new_tokens(model):
    ids = _ids(1, 4, seed=1)
    out0 = model.generate_jit(ids, max_new_tokens=0, temperature=1.0)
    np.testing.assert_array_equal(out0.numpy(), ids)
    with pytest.raises(ValueError, match="max_seq_len"):
        model.generate_jit(np.zeros((1, 250), np.int64), max_new_tokens=10)
    with pytest.raises(ValueError, match="max_seq_len"):
        model.generate(np.zeros((1, 250), np.int64), max_new_tokens=10)
    with pytest.raises(ValueError, match="max_new_tokens"):
        model.beam_search(ids, max_new_tokens=0)


# ---------------------------------------------------------------------- #
# beam search
# ---------------------------------------------------------------------- #

def test_beam1_is_greedy(model):
    ids = _ids(2, 6, seed=0)
    beam, scores = model.beam_search(ids, beam_size=1, max_new_tokens=5)
    assert torch.equal(beam, model.generate_jit(ids, max_new_tokens=5))
    assert bool(torch.isfinite(scores).all()) and scores.shape == (2,)


def _small(seed):
    torch.manual_seed(0)
    return GPT(GPTConfig(vocab_size=12, max_seq_len=32, hidden_size=32,
                         num_layers=2, num_heads=2), seed=seed, device="cpu")


def _logprobs(m, seq):
    lg = m(torch.as_tensor(np.asarray(seq)[None])).detach().double()
    return torch.log_softmax(lg, dim=-1)[0].numpy()


def test_beam_exhaustive_wide_beam():
    """beam = vocab over 2 steps is exhaustive: the true argmax over all
    vocab^2 continuations, brute-forced through the plain forward."""
    V = 12
    m = _small(3)
    ids = _ids(1, 4, seed=1, vocab=V)
    best, _ = m.beam_search(ids, beam_size=V, max_new_tokens=2)
    got = tuple(best[0, 4:].tolist())

    def seq_logprob(t1, t2):
        lp = _logprobs(m, list(ids[0]) + [t1, t2])
        return lp[3, t1] + lp[4, t2]

    want = max(itertools.product(range(V), range(V)),
               key=lambda p: seq_logprob(*p))
    assert got == want, (got, want)


def test_beam_eos_exhaustive():
    """beam = vocab, 2 steps, an EOS: the returned score is the best
    GNMT-normalised score over the length-1 EOS ending and every 2-token
    continuation (the finished pool)."""
    V, EOS, ALPHA = 12, 3, 0.6
    m = _small(9)
    ids = _ids(1, 4, seed=4, vocab=V)
    out, score = m.beam_search(ids, beam_size=V, max_new_tokens=2,
                               eos_token_id=EOS, length_penalty=ALPHA)

    def norm(n):
        return ((5.0 + n) / 6.0) ** ALPHA

    prompt = list(ids[0])
    lp1 = _logprobs(m, prompt + [0])[3]
    best_score, best_seq = -np.inf, None
    for t1 in range(V):
        if t1 == EOS:
            cand = lp1[EOS] / norm(1)
            if cand > best_score:
                best_score, best_seq = cand, (EOS,)
            continue
        lp2 = _logprobs(m, prompt + [t1, 0])[4]
        for t2 in range(V):
            cand = (lp1[t1] + lp2[t2]) / norm(2)
            if cand > best_score:
                best_score, best_seq = cand, (t1, t2)
    np.testing.assert_allclose(float(score[0]), best_score, rtol=TOL,
                               atol=TOL)
    got = tuple(out[0, 4:4 + len(best_seq)].tolist())
    assert got == best_seq, (got, best_seq)


def _beam_margin(model, ids, K, max_new, eos, alpha=0.6):
    """The smallest margin of the port's beam search on `ids`: over every
    pruning step (K-th against the next candidate) and the final choice
    (best against the runner-up)."""
    cfg = model.cfg
    ids = torch.as_tensor(ids).long()
    b, prompt = ids.shape
    k0, v0 = port_gpt._fixed_cache(cfg, model.dtype, "cpu", b,
                                   prompt + max_new)
    caches = [port_gpt._fixed_cache(cfg, model.dtype, "cpu", b * K,
                                    prompt + max_new) for _ in range(2)]
    margins = []
    with torch.no_grad():
        port_gpt._beam_loop(cfg, model.serving_params(), ids, k0, v0,
                            caches, K, max_new, eos,
                            lambda n: ((5.0 + n) / 6.0) ** alpha, margins)
    m = torch.stack(margins)
    return float(m[torch.isfinite(m)].min())


@pytest.mark.parametrize("eos", [None, 7])
def test_beams_equal_jax(jax_model, model, eos):
    """Beams and scores against JAX's on the same weights, where every
    decision of the search clears a 1e-4 margin."""
    ids = _ids(2, 5, seed=6)
    kw = dict(beam_size=3, max_new_tokens=6, eos_token_id=eos)
    margin = _beam_margin(model, ids, 3, 6, eos)
    print(f"smallest beam-score margin: {margin:.4g}")
    assert margin > 1e-4, f"near-tie in the search: {margin}"
    jt, js = jax_model.beam_search(ids, **kw)
    pt_, ps = model.beam_search(ids, **kw)
    np.testing.assert_array_equal(pt_.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=TOL,
                               atol=TOL)


def test_beam_eos_output_contract(model):
    ids = _ids(2, 4, seed=2)
    out, score = model.beam_search(ids, beam_size=3, max_new_tokens=8,
                                   eos_token_id=7)
    assert out.shape == (2, 12)
    np.testing.assert_array_equal(out[:, :4].numpy(), ids)
    assert bool(torch.isfinite(score).all())


# ---------------------------------------------------------------------- #
# int8 PTQ
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def int8_pair(model):
    from paddle_tpu_torch.quantization import PTQ, Int8Linear
    q = gpt_tiny(device="cpu")
    q.load_state_dict(model.state_dict())
    ptq = PTQ()
    ptq.quantize(q)
    ptq.sample(q, [_ids(2, 32, seed=0)])
    ptq.convert(q)
    assert sum(isinstance(s, Int8Linear) for s in q.modules()) == \
        4 * q.cfg.num_layers
    return model, q


def test_int8_generate_jit_matches_fp(int8_pair):
    fp, q = int8_pair
    ids = _ids(2, 32, seed=0)
    ref = fp.generate_jit(ids, max_new_tokens=16).numpy()
    got = q.generate_jit(ids, max_new_tokens=16).numpy()
    np.testing.assert_array_equal(got[:, :32], ref[:, :32])
    agree = (got[:, 32:] == ref[:, 32:]).mean()
    print(f"int8 vs fp generated tokens agreeing: {agree:.3f}")
    assert agree >= 0.6
    # one step function: eager int8 generate is the graph's, bitwise
    np.testing.assert_array_equal(
        q.generate(ids, max_new_tokens=16, temperature=0.0).numpy(), got)
    seqs, scores = q.beam_search(ids[:1], beam_size=2, max_new_tokens=8)
    assert seqs.shape[-1] == 40 and bool(torch.isfinite(scores).all())
