"""Tensor parallelism of the port (`parallel/tp_layers.py`,
`Trainer(mesh=)` with tp > 1) against the JAX package on conftest's 8
virtual devices, same weights (carried by `load_jax_state` /
`load_jax_params`) and the same numpy batches.

- The specs: the TP layers', GPT's and BERT's `.spec`s equal JAX's.
- The reference's TP net (`tests/test_parallel.py:271`) under tp 8 and
  dp 2 x tp 4, and its MLP under dp 2 x fsdp 2 x tp 2 at ZeRO-3: 8 Adam
  steps' losses within JAX's bar (rtol 2e-4, atol 1e-5), final
  parameters within 1e-4 of the largest magnitude.
- `VocabParallelEmbedding` and `ParallelCrossEntropy` at tp 8 (each
  rank's result of an SPMD run): the lookup and the per-row losses
  within 1e-6 relative of JAX's, the logits' gradient within 1e-6.
- gpt_tiny under dp 2 x tp 2 (AdamW, 4 steps): losses within 2e-5
  relative of JAX's; the parameters within 5% of the largest move 4
  AdamW steps make; `gathered_state()` in JAX's layout; each rank's
  shard of a split parameter has JAX's shard shape, the qkv shard
  holding whole heads (head-aligned, a deviation from JAX's contiguous
  columns), which `join_shards` puts back.
- BERT-tiny's masked-LM head under tp 2 (AdamW, 3 steps, no dropout):
  losses within 2e-5 relative of JAX's.
- Inside the port: gpt_tiny with dropout 0.1 under dp 2 x tp 2 equals
  one rank's global step (each rank's residual masks are its rows of
  the global draw, its attention mask its heads' block of it): losses
  within 1e-5 relative; an attention's dropout mask is the heads'
  block of the draw over all heads only where the layer says it holds
  that block (`head_block`), and the whole draw on every tp rank of a
  replicated attention (outputs within 1e-6 of the whole draw's); the
  ranks' threads run at the driving thread's
  intra-op thread count; two equal steps give the same bits whatever
  ran between them.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import parallel as jpar
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForMaskedLM as JBertMLM
from paddle_tpu_torch import nn, parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM, gpt_tiny,
                                     load_jax_params, load_jax_state,
                                     train_state_numpy)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW
from paddle_tpu_torch.parallel.sharding import (join_shards, model_splits,
                                                param_specs, take_shard)
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _spec(s):
    return None if s is None else tuple(s)


class _JTPNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.col = jpar.ColumnParallelLinear(8, 32, gather_output=False)
        self.act = jnn.ReLU()
        self.row = jpar.RowParallelLinear(32, 4, input_is_parallel=True)

    def forward(self, x):
        return self.row(self.act(self.col(x)))


class _PTPNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.col = parallel.ColumnParallelLinear(8, 32, gather_output=False,
                                                 gen=g)
        self.act = nn.ReLU()
        self.row = parallel.RowParallelLinear(32, 4, input_is_parallel=True,
                                              gen=g)

    def forward(self, x):
        return self.row(self.act(self.col(x)))


def _jmlp():
    return jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))


def _pmlp():
    g = torch.Generator().manual_seed(0)
    return nn.Sequential(nn.Linear(8, 32, gen=g), nn.ReLU(),
                         nn.Linear(32, 4, gen=g))


NETS = {"tp8": ("tp", dict(tp=8), None),
        "dp2_tp4": ("tp", dict(dp=2, tp=4), None),
        "dp2_fsdp2_tp2_s3": ("mlp", dict(dp=2, fsdp=2, tp=2), 3)}


def _data():
    rs = np.random.RandomState(11)
    return rs.randn(32, 8).astype(np.float32), rs.randint(0, 4, (32,))


@pytest.fixture(scope="module")
def weights():
    pt.seed(11)
    return {name: {k: np.array(v) for k, v in f().raw_parameters().items()}
            for name, f in (("tp", _JTPNet), ("mlp", _jmlp))}


def test_tp_specs_are_jax():
    jm, pm = _JTPNet(), _PTPNet()
    got = {k: _spec(v) for k, v in param_specs(pm).items()}
    assert got == {k: _spec(v) for k, v in jm.param_specs().items()}
    assert got["col.weight"] == (None, "tp")
    assert got["row.weight"] == ("tp", None)
    pt.seed(0)
    for jmodel, pmodel in (
            (jax_gpt_tiny(), gpt_tiny(seed=0, device="cpu")),
            (JBertMLM(JBertConfig(vocab_size=1000, hidden_size=64,
                                  num_layers=2, num_heads=2,
                                  intermediate_size=128)),
             BertForMaskedLM(BertConfig(vocab_size=1000, hidden_size=64,
                                        num_layers=2, num_heads=2,
                                        intermediate_size=128),
                             device="cpu"))):
        want = {k: _spec(v) for k, v in jmodel.param_specs().items()}
        got = {k: _spec(v) for k, v in param_specs(pmodel).items()}
        assert got == want
        assert sum(v is not None for v in got.values()) > 4


@pytest.mark.parametrize("name", list(NETS))
def test_tp_meshes_match_jax(name, weights):
    net, mesh_kw, stage = NETS[name]
    x, y = _data()
    jm = _JTPNet() if net == "tp" else _jmlp()
    jm.load_raw_parameters({k: jax.numpy.asarray(v)
                            for k, v in weights[net].items()})
    jmesh = jpar.init_mesh(**mesh_kw)
    if stage is not None:
        jpar.apply_fsdp(jm, jmesh, stage=stage, min_size=8)
    jt = JaxTrainer(jm, jopt.Adam(learning_rate=0.01),
                    lambda o, t: jnn.functional.cross_entropy(o, t),
                    mesh=jmesh, donate=False)
    want = [float(jt.train_step(x, y)[0]) for _ in range(8)]

    pm = load_jax_state(_PTPNet() if net == "tp" else _pmlp(), weights[net])
    mesh = parallel.init_mesh(**mesh_kw, world_size=8, device="cpu")
    if stage is not None:
        parallel.apply_fsdp(pm, mesh, stage=stage, min_size=8)
    tr = Trainer(pm, Adam(0.01), lambda o, t: F.cross_entropy(o, t),
                 mesh=mesh)
    got = [float(tr.train_step(x, y)[0]) for _ in range(8)]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    assert got[-1] < got[0]
    st = tr.gathered_state()
    for k, v in jt.state.params.items():
        v = np.asarray(v)
        err = np.abs(st.params[k].numpy() - v).max() / np.abs(v).max()
        assert err < 1e-4, (k, err)


def test_vocab_embedding_and_parallel_cross_entropy_match_jax():
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 64, (4, 6))
    logits = rs.randn(4, 64).astype(np.float32)
    labels = rs.randint(0, 64, (4, 1))
    labels[2, 0] = -100
    jmesh = jpar.init_mesh(tp=8)
    pt.seed(1)
    jemb = jpar.VocabParallelEmbedding(64, 16)
    jpar.sharding.shard_model(jemb, jmesh)
    want_emb = np.asarray(jemb(jax.numpy.asarray(ids)))
    jpce = jpar.ParallelCrossEntropy()

    def jloss(lg):
        return jpce(lg, jax.numpy.asarray(labels))

    want_ce = np.asarray(jloss(jax.numpy.asarray(logits)))
    want_g = np.asarray(jax.grad(lambda lg: jloss(lg).sum())(
        jax.numpy.asarray(logits)))

    emb = parallel.VocabParallelEmbedding(64, 16,
                                          gen=torch.Generator())
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(np.array(jemb.weight.value)))
    pce = parallel.ParallelCrossEntropy()
    lg = torch.from_numpy(logits).requires_grad_()
    res = parallel.spmd([{"tp": r} for r in range(8)], lambda r: (
        emb(torch.from_numpy(ids)),
        pce(lg[:, r * 8:(r + 1) * 8], torch.from_numpy(labels))))
    for out, ce in res:
        np.testing.assert_allclose(out.detach().numpy(), want_emb,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ce.detach().numpy(), want_ce, rtol=1e-6,
                                   atol=1e-6)
    # every rank holds the whole loss; their joint backward adds 8
    # shares, as the Trainer's does
    g, = torch.autograd.grad(sum(ce.sum() for _, ce in res) / 8, lg)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-5, atol=1e-6)
    # outside a run: the plain layers
    np.testing.assert_allclose(pce(lg, torch.from_numpy(labels)).detach()
                               .numpy(), want_ce, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def gpt_weights():
    pt.seed(0)
    return {k: np.array(v) for k, v in
            jax_gpt_tiny().raw_parameters().items()}


def test_gpt_tiny_dp2_tp2_matches_jax(gpt_weights):
    ids = np.random.RandomState(0).randint(0, 1024, (8, 32)).astype(
        np.int32)
    labels = ids.copy()
    labels[1, 5:] = -100
    pt.seed(0)
    jm = jax_gpt_tiny()
    jm.load_raw_parameters({k: jax.numpy.asarray(v)
                            for k, v in gpt_weights.items()})
    jmesh = jpar.init_mesh(dp=2, tp=2)
    jt = JaxTrainer(jm, jopt.AdamW(learning_rate=1e-3),
                    lambda lg, y: jm.loss(lg, y), mesh=jmesh, donate=False)
    want = [float(jt.train_step(ids, labels)[0]) for _ in range(4)]

    m = load_jax_params(gpt_tiny(seed=1, device="cpu"), gpt_weights)
    mesh = parallel.init_mesh(dp=2, tp=2, device="cpu")
    tr = Trainer(m, AdamW(1e-3), lambda lg, y: m.loss(lg, y), mesh=mesh)
    got = []
    for _ in range(4):
        loss, out = tr.train_step(ids, labels)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert tuple(out.shape) == (8, 32, 1024)     # the ranks' logits joined
    jtree = jax.tree_util.tree_map(np.asarray, jt.state.tree())
    mine = train_state_numpy(tr.gathered_state())
    for k, v in jtree["params"].items():
        assert mine["params"][k].shape == v.shape
        assert np.abs(mine["params"][k] - v).max() < 0.05 * 4 * 1e-3, k
        for sk, sv in jtree["opt_state"]["slots"][k].items():
            assert mine["opt_state"]["slots"][k][sk].shape == sv.shape
    # each rank's shard has JAX's shard shape
    splits = model_splits(m, mesh)
    assert len(splits) == 1 + 4 * 6        # wte, 4 x (qkv, out, fc1, fc2)
    for k, v in jt.state.params.items():
        leaf = tr._rank_leaves(tr.state, mesh.coords(1))[k]
        assert tuple(leaf.shape) == v.sharding.shard_shape(v.shape), k
    # the qkv shard of tp rank 1 holds heads 2-3 of q, k and v whole
    w = tr.state.params["blocks.0.attn.qkv.weight"]
    shard = take_shard(w, 1, 1, 2, 3)
    torch.testing.assert_close(shard, torch.cat(
        [w[:, 64:128], w[:, 192:256], w[:, 320:384]], 1), rtol=0, atol=0)
    whole = join_shards([take_shard(w, 1, r, 2, 3) for r in range(2)], 1,
                        "tp", 3)
    assert torch.equal(whole, w)


def test_bert_tiny_tp2_matches_jax():
    kw = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
              intermediate_size=128, hidden_dropout=0.0,
              attention_dropout=0.0)
    pt.seed(4)
    jm = JBertMLM(JBertConfig(**kw))
    weights = {k: np.array(v) for k, v in jm.raw_parameters().items()}
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 1000, (4, 16)).astype(np.int32)
    labels = np.where(rs.rand(4, 16) < 0.3, ids, -100).astype(np.int32)
    jmesh = jpar.init_mesh(tp=2)
    jt = JaxTrainer(jm, jopt.AdamW(learning_rate=1e-3),
                    lambda o, y: jnn.functional.cross_entropy(
                        o.reshape(-1, 1000), y.reshape(-1)),
                    mesh=jmesh, donate=False)
    want = [float(jt.train_step(ids, labels)[0]) for _ in range(3)]
    m = load_jax_state(BertForMaskedLM(BertConfig(**kw), device="cpu"),
                       weights)
    mesh = parallel.init_mesh(tp=2, device="cpu")
    tr = Trainer(m, AdamW(1e-3), lambda o, y: F.cross_entropy(
        o.reshape(-1, 1000), y.reshape(-1)), mesh=mesh)
    got = [float(tr.train_step(ids, labels)[0]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert model_splits(m, mesh)["bert.layers.0.attn.qkv.weight"] == \
        [(1, "tp", 3)]


def test_inside_the_port_dropout_dp2_tp2_is_one_ranks_step():
    ids = np.random.RandomState(2).randint(0, 1024, (8, 32))

    def run(mesh):
        m = gpt_tiny(seed=0, device="cpu", dropout=0.1)
        tr = Trainer(m, AdamW(1e-3), lambda lg, y: m.loss(lg, y),
                     mesh=mesh)
        return [float(tr.train_step(ids, ids)[0]) for _ in range(3)]

    one = run(None)
    got = run(parallel.init_mesh(dp=2, tp=2, device="cpu"))
    np.testing.assert_allclose(got, one, rtol=1e-5)


def test_attention_dropout_draws_a_head_block_only_when_asked():
    """Under tp 2 a rank whose attention holds 2 of 4 heads
    (`head_block`) keeps its block of the mask over all heads; an
    attention that every tp rank computes whole (no head block) keeps
    the whole draw on each rank, so the replicas agree."""
    from paddle_tpu_torch.nn import rng
    from paddle_tpu_torch.parallel.tp_layers import head_block
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(2, 8, 4, 8).astype(np.float32))
               for _ in range(3))

    def attend(q_, k_, v_, block=None):
        with rng.rng_context(7, 0):
            return F.scaled_dot_product_attention(
                q_, k_, v_, dropout_p=0.5, is_causal=True, head_block=block)

    want = attend(q, k, v)

    def rank(r):
        h = slice(2 * r, 2 * r + 2)
        return attend(q, k, v), attend(q[:, :, h], k[:, :, h], v[:, :, h],
                                       head_block(2, 4))

    outs = parallel.spmd([{"tp": r} for r in range(2)], rank)
    for r, (whole, blk) in enumerate(outs):
        np.testing.assert_allclose(whole.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(blk.numpy(),
                                   want[:, :, 2 * r:2 * r + 2].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_rank_threads_run_at_the_driving_threads_count():
    """A rank's thread runs each job under the submitting thread's
    intra-op thread count (OpenMP's and MKL's counts are per thread: a
    worker used to keep the count of its first parallel op, so ranks
    could sum in other orders than the driving thread, and from one
    run to the next)."""
    n = torch.get_num_threads()
    coords = [{"dp": i} for i in range(4)]
    try:
        torch.set_num_threads(3)
        assert parallel.spmd(coords, lambda r: torch.get_num_threads()) \
            == [3] * 4
        torch.set_num_threads(1)
        assert parallel.spmd(coords, lambda r: torch.get_num_threads()) \
            == [1] * 4
    finally:
        torch.set_num_threads(n)


def test_equal_mesh_steps_give_equal_bits_whatever_ran_before():
    """The joint backward sums each collective's rank gradients in rank
    order (`nn.ranks._Joined`), so equal steps give the same bits
    whatever ran before them in the process (the engine used to add a
    shared result's gradients in the order the threads' autograd
    sequence numbers gave). Two conv / batch-norm layers (their
    moments all-reduced over the 4 data ranks) and a head, one SGD
    step: a step at dp 4 after a one-rank step, with remat, and again,
    bitwise."""
    rs = np.random.RandomState(0)
    x = rs.randn(16, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 5, (16,))

    def step(dp, remat=False):
        g = torch.Generator().manual_seed(0)
        kw = {"data_format": "NHWC"}
        m = nn.Sequential(
            nn.Conv2D(3, 8, 3, padding=1, bias_attr=False, gen=g, **kw),
            nn.BatchNorm2D(8, **kw), nn.ReLU(),
            nn.Conv2D(8, 8, 3, padding=1, bias_attr=False, gen=g, **kw),
            nn.BatchNorm2D(8, **kw), nn.ReLU(),
            nn.AdaptiveAvgPool2D(1, **kw), nn.Flatten(),
            nn.Linear(8, 5, gen=g))
        mesh = parallel.init_mesh(dp=dp, device="cpu") if dp > 1 else None
        tr = Trainer(m, SGD(1.0), lambda o, t: F.cross_entropy(o, t),
                     mesh=mesh, remat=remat)
        tr.train_step(x, y)
        return tr.gathered_state().params

    step(1)
    a, r, b = step(4), step(4, remat=True), step(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a[k], r[k]) for k in a)
