"""Sequence parallelism of the port (`parallel/sequence.py`, GPT's
`sequence_parallel`) against the JAX package on conftest's 8 virtual
devices, same numpy inputs and weights.

- Ring and Ulysses attention at sp 8 (the global form: the port's call
  runs the 8 sp ranks, each through the flash kernels' plain versions
  per kv chunk or per head group), causal and not: the output and the
  q, k, v gradients of sum(out * g) within 1e-5 relative (atol 1e-6)
  of JAX's `ring_attention` / `ulysses_attention`; the ring's 2 x 7
  ppermutes and Ulysses' 4 all_to_alls counted; at sp 1 both are
  plain attention.
- Inside an SPMD run: each rank's chunk in, its chunk out, equal to the
  global form's; `split_sequence` / `gather_sequence` round trip.
- gpt_tiny with `sequence_parallel` "ring" and "ulysses" at sp 2 x dp 2
  x tp 2 (3 AdamW steps, 4 x 64 ids): losses within 2e-5 relative of
  JAX's, and of the port's own one-rank run.
- What raises: heads % sp for Ulysses; attention dropout with
  sequence parallelism in training, as in JAX.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu import parallel as jpar
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.parallel import sequence as jseq
from paddle_tpu_torch import parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.nn import ranks
from paddle_tpu_torch.ops_cuda import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import sequence as seq
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _qkv(b=2, s=64, h=8, d=16, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, s, h, d) * 0.5).astype(np.float32)
            for _ in range(3)]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=what)


ROUTES = {"ring": (jseq.ring_attention, seq.ring_attention, 14),
          "ulysses": (jseq.ulysses_attention, seq.ulysses_attention, 4)}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_route_matches_jax(route, causal):
    jfn, pfn, n_coll = ROUTES[route]
    q, k, v = _qkv()
    g = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    jmesh = jpar.init_mesh(sp=8)

    def jloss(q, k, v):
        return (jfn(q, k, v, mesh=jmesh, causal=causal) * g).sum()

    jargs = [jax.numpy.asarray(x) for x in (q, k, v)]
    want, want_g = jax.jit(lambda *a: (
        jfn(*a, mesh=jmesh, causal=causal),
        jax.grad(jloss, argnums=(0, 1, 2))(*a)))(*jargs)
    want, want_g = np.asarray(want), [np.asarray(x) for x in want_g]

    mesh = parallel.init_mesh(sp=8, device="cpu")
    targs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ranks.reset_counts()
    out = pfn(*targs, mesh=mesh, causal=causal)
    c = ranks.counts()
    assert c["ppermute" if route == "ring" else "all_to_all"] == n_coll
    got_g = torch.autograd.grad((out * torch.from_numpy(g)).sum(), targs)
    _close(out.detach().numpy(), want, "out")
    for name, a, b in zip("qkv", got_g, want_g):
        _close(a.numpy(), b, f"d{name}")
    # at sp 1: plain attention
    parallel.set_mesh(None)
    ref = fa.attention_reference(*targs, causal=causal)
    _close(pfn(*targs, causal=causal).detach().numpy(),
           ref.detach().numpy(), "sp 1")


def test_rank_form_and_split_gather():
    q, k, v = (torch.from_numpy(x) for x in _qkv(s=32, h=4))
    want = seq.ring_attention(q, k, v, mesh=parallel.init_mesh(
        sp=4, device="cpu"), causal=True)
    parallel.set_mesh(None)

    def rank(i):
        qs, ks, vs = (seq.split_sequence(x) for x in (q, k, v))
        a = seq.ring_attention(qs, ks, vs, causal=True)
        b = seq.ulysses_attention(qs, ks, vs, causal=True)
        return a, b, seq.gather_sequence(a)

    res = parallel.spmd([{"sp": i} for i in range(4)], rank)
    ring = torch.cat([r[0] for r in res], 1)
    uly = torch.cat([r[1] for r in res], 1)
    torch.testing.assert_close(ring, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(uly, want, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(r[2], ring) for r in res)
    assert seq.split_sequence(q) is q and seq.gather_sequence(q) is q


def test_heads_not_divisible_raises():
    q, k, v = (torch.from_numpy(x) for x in _qkv(h=6))
    with pytest.raises(ValueError, match="% sp"):
        seq.ulysses_attention(q, k, v, mesh=parallel.init_mesh(
            sp=8, device="cpu"))
    jq = [jax.numpy.asarray(x) for x in _qkv(h=6)]
    with pytest.raises(ValueError):
        jseq.ulysses_attention(*jq, mesh=jpar.init_mesh(sp=8))


@pytest.fixture(scope="module")
def gpt_weights():
    pt.seed(5)
    return {k: np.array(v) for k, v in
            jax_gpt_tiny().raw_parameters().items()}


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_gpt_tiny_sp2_dp2_tp2_matches_jax(mode, gpt_weights):
    ids = np.random.RandomState(0).randint(0, 1024, (4, 64)).astype(
        np.int32)
    pt.seed(5)
    jm = jax_gpt_tiny(sequence_parallel=mode)
    jm.load_raw_parameters({k: jax.numpy.asarray(v)
                            for k, v in gpt_weights.items()})
    jmesh = jpar.init_mesh(sp=2, dp=2, tp=2)
    jt = JaxTrainer(jm, jopt.AdamW(learning_rate=1e-3),
                    lambda lg, y: jm.loss(lg, y), mesh=jmesh, donate=False)
    want = [float(jt.train_step(ids, ids)[0]) for _ in range(3)]

    def run(mesh):
        m = load_jax_params(gpt_tiny(seed=1, device="cpu",
                                     sequence_parallel=mode), gpt_weights)
        tr = Trainer(m, AdamW(1e-3), lambda lg, y: m.loss(lg, y),
                     mesh=mesh)
        return [float(tr.train_step(ids, ids)[0]) for _ in range(3)], tr

    ranks.reset_counts()
    got, tr = run(parallel.init_mesh(sp=2, dp=2, tp=2, device="cpu"))
    c = ranks.counts()
    np.testing.assert_allclose(got, want, rtol=2e-5)
    if mode == "ring":      # one hop of k and v per layer per dp x tp
        assert c["ppermute"] == 3 * 4 * 2 * 4
    else:                   # q, k, v in and the output back
        assert c["all_to_all"] == 3 * 4 * 4 * 4
    one, _ = run(None)
    np.testing.assert_allclose(got, one, rtol=2e-5)


def test_dropout_with_sequence_parallel_raises(gpt_weights):
    ids = np.zeros((2, 16), np.int32)
    m = gpt_tiny(seed=0, device="cpu", dropout=0.1,
                 sequence_parallel="ulysses")
    tr = Trainer(m, AdamW(1e-3), lambda lg, y: m.loss(lg, y),
                 mesh=parallel.init_mesh(sp=2, device="cpu"))
    with pytest.raises(ValueError, match="attention dropout"):
        tr.train_step(ids, ids)
    jm = jax_gpt_tiny(dropout=0.1, sequence_parallel="ulysses")
    jt = JaxTrainer(jm, jopt.AdamW(learning_rate=1e-3),
                    lambda lg, y: jm.loss(lg, y),
                    mesh=jpar.init_mesh(sp=2), donate=False)
    with pytest.raises(ValueError, match="attention dropout"):
        jt.train_step(ids, ids)
