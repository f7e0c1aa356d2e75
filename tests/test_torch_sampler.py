"""Port sampler (`paddle_tpu_torch/serving/sampler.py`) against the JAX
sampler, and the port's own sampling law.

`filtered_logits` is an exact port: on the same logits and knobs it
drops the same entries to -inf and keeps the finite entries within
atol = 1e-6 (temperature division and the nucleus cumsum in fp32). The
random draw cannot match JAX's threefry bits, so it is checked as a
law: a seeded chi-square test that the Gumbel-max draws follow
softmax(filtered_logits), plus the key invariants the engine relies on.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving.sampler import filtered_logits as jax_filtered
from paddle_tpu_torch.serving import sampler as port
from port_threads import one_torch_thread  # noqa: F401


def _knobs():
    # greedy, plain temperature, top-k, top-p, both, top-k larger than V
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.9, 1.0], np.float32)
    topk = np.array([0, 0, 5, 0, 7, 5000], np.int32)
    topp = np.array([1.0, 1.0, 1.0, 0.6, 0.8, 0.95], np.float32)
    return temp, topk, topp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filtered_logits_match_jax(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(6, 96) * 2.0).astype(np.float32)
    logits[2, 10:14] = logits[2].max()            # ties at the top-k edge
    temp, topk, topp = _knobs()
    want = np.asarray(jax_filtered(jnp.asarray(logits), jnp.asarray(temp),
                                   jnp.asarray(topk), jnp.asarray(topp)))
    got = port.filtered_logits(torch.from_numpy(logits),
                               torch.from_numpy(temp),
                               torch.from_numpy(topk),
                               torch.from_numpy(topp)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


def test_topk_ties_at_threshold_survive():
    lg = torch.tensor([[3.0, 1.0, 2.0, 2.0, 0.5]])
    out = port.filtered_logits(lg, 1.0, 2, 1.0)
    assert torch.isfinite(out).tolist() == [[True, False, True, True,
                                             False]]


def test_gumbel_max_follows_softmax_of_filtered_logits():
    """20000 seeded draws of one row (positions 0..N-1 give independent
    keys) against softmax(filtered_logits): chi-square below the
    p = 0.001 critical value for the support's degrees of freedom."""
    from scipy.stats import chi2
    V, N = 10, 20000
    row = torch.tensor(np.random.RandomState(3).randn(V).astype(np.float32))
    logits = row.expand(N, V)
    temp, topk, topp = 0.9, 8, 0.97
    draws = port.sample_tokens_per_lane(
        logits, 1234, torch.full((N,), 5), torch.arange(N), temp, topk, topp)
    probs = torch.softmax(port.filtered_logits(row[None], temp, topk, topp),
                          -1)[0].double().numpy()
    counts = np.bincount(draws.numpy(), minlength=V)
    support = probs > 0
    assert counts[~support].sum() == 0
    expected = N * probs[support]
    stat = float(((counts[support] - expected) ** 2 / expected).sum())
    assert stat < chi2.ppf(0.999, df=int(support.sum()) - 1), stat


def test_draw_depends_only_on_seed_salt_position():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(5, 64).astype(np.float32))
    salts = torch.tensor([3, 1, 4, 1, 5])
    pos = torch.tensor([10, 20, 30, 40, 50])
    a = port.sample_tokens_per_lane(logits, 7, salts, pos, 1.0, 0, 1.0)
    perm = torch.tensor([4, 2, 0, 3, 1])
    b = port.sample_tokens_per_lane(logits[perm], 7, salts[perm], pos[perm],
                                    1.0, 0, 1.0)
    assert torch.equal(a[perm], b)                 # row-independent
    c = port.sample_tokens_per_lane(logits, 8, salts, pos, 1.0, 0, 1.0)
    d = port.sample_tokens_per_lane(logits, 7, salts + 100, pos, 1.0, 0, 1.0)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    first = port.sample_tokens(logits, 7, 3, 10, 1.0, 0, 1.0)
    assert first.shape == (5,)


def test_greedy_lanes_are_argmax():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(6, 50).astype(np.float32))
    temp, topk, topp = (torch.from_numpy(a) for a in _knobs())
    out = port.sample_tokens_per_lane(logits, 0, torch.zeros(6),
                                      torch.arange(6), temp, topk, topp)
    assert out[0] == torch.argmax(logits[0])


def test_hash_arithmetic_and_uniform_range():
    rng = np.random.RandomState(2)
    x = rng.randint(0, 2 ** 32, size=1000, dtype=np.uint64)
    got = port._mul32(torch.from_numpy(x.astype(np.int64)), 0x846CA68B)
    want = [(int(v) * 0x846CA68B) % 2 ** 32 for v in x]
    assert got.tolist() == want
    keys = port.lane_keys(0, torch.arange(4), torch.arange(4))
    u = port.lane_uniforms(keys, 4096)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
