"""The port's BERT / ERNIE (`models/bert.py`) against the JAX package's:
the same weights (the JAX model's `raw_parameters()` carried over by
`load_jax_state`), the same seeded numpy batches, fp32 on the CPU.

A tiny config (vocab 1000, hidden 64, 2 layers, 2 heads: head dim 32,
intermediate 128; batch 4 x seq 16):
- parameter names and shapes equal JAX's, for the encoder, the
  classifier and the MLM head;
- eval forwards of `BertForSequenceClassification` (logits), `Bert`
  (sequence output and pooled output) and `BertForMaskedLM` (logits
  through the tied word embedding), with and without `token_type_ids`
  and a padding `attention_mask`: within 1e-5 of the largest magnitude;
- training forwards with dropout 0.1 everywhere (embedding, attention,
  both residual dropouts of every layer, the classifier) fed JAX's own
  keep masks, draw by draw (the port's `nn.rng.keep_mask` replaced by
  JAX's `bernoulli(fold_in(key, n))`), with and without a mask: the
  logits within 1e-5 and every parameter's gradient within 1e-4 of
  its largest magnitude; the draws come in JAX's order and shapes;
- the additive mask (1 - m) * -1e4 in bf16 equals JAX's bitwise
  (-9984), and in fp32 (-1e4);
- the attention route: no mask and no dropout (eval) reaches the flash
  entry (no `attention_dense` call), a mask or attention dropout the
  dense one, once per layer;
- one `Dropout` module applied twice in a layer draws two masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import rng
from paddle_tpu_torch.ops_cuda import flash_attention as fa
from port_resnet import numpy_tree, rel_err
from port_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=64)
KEY = jax.random.PRNGKey(11)
B, S = 4, 16


def _pair(jcls, pcls, *args, dropout=0.1):
    """(JAX model, its numpy parameters, the port twin); dropout p for
    hidden and attention dropout."""
    kw = dict(CFG, hidden_dropout=dropout, attention_dropout=dropout)
    pt.seed(0)
    jm = jcls(jbert.BertConfig(**kw), *args)
    params = numpy_tree(jm.raw_parameters())
    pm = load_jax_state(pcls(pbert.BertConfig(**kw), *args, seed=5,
                             device="cpu"), params)
    return jm, params, pm


@pytest.fixture(scope="module")
def cls_pair():
    return _pair(jbert.BertForSequenceClassification,
                 pbert.BertForSequenceClassification, 3)


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, CFG["vocab_size"], (B, S))
    tt = rs.randint(0, 4, (B, S))
    lengths = np.array([16, 11, 5, 14])
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int64)
    y = rs.randint(0, 3, (B,))
    return ids, tt, mask, y


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_names_and_shapes_match_jax(cls_pair):
    jm, params, pm = cls_pair
    assert {k: tuple(v.shape) for k, v in pm.named_parameters()} \
        == {k: v.shape for k, v in params.items()}
    jmlm, pmlm_params, pmlm = _pair(jbert.BertForMaskedLM,
                                    pbert.BertForMaskedLM)
    assert {k: tuple(v.shape) for k, v in pmlm.named_parameters()} \
        == {k: v.shape for k, v in pmlm_params.items()}
    with pytest.raises(KeyError, match="parameter names differ"):
        load_jax_state(pm, pmlm_params)


INPUTS = {"ids": (True, False, False), "ids+types": (True, True, False),
          "ids+types+mask": (True, True, True), "ids+mask": (True, False,
                                                             True)}


def _args(batch, which):
    ids, tt, mask, _ = batch
    use = INPUTS[which]
    return (ids, tt if use[1] else None, mask if use[2] else None)


@pytest.mark.parametrize("which", list(INPUTS))
def test_classifier_eval(cls_pair, batch, which):
    jm, _, pm = cls_pair
    args = _args(batch, which)
    jm.eval()
    pm.eval()
    want = jm(*map(_j, args))
    got = pm(*map(_t, args))
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("which", ["ids", "ids+types+mask"])
def test_encoder_outputs_eval(cls_pair, batch, which):
    jm, _, pm = cls_pair
    args = _args(batch, which)
    jm.eval()
    pm.eval()
    seq_w, pooled_w = jm.bert(*map(_j, args))
    seq_g, pooled_g = pm.bert(*map(_t, args))
    assert tuple(seq_g.shape) == (B, S, CFG["hidden_size"])
    assert rel_err(seq_g, seq_w) <= 1e-5
    assert rel_err(pooled_g, pooled_w) <= 1e-5


@pytest.mark.parametrize("which", ["ids", "ids+types+mask"])
def test_mlm_eval(batch, which):
    jm, _, pm = _pair(jbert.BertForMaskedLM, pbert.BertForMaskedLM)
    args = _args(batch, which)
    jm.eval()
    pm.eval()
    got = pm(*map(_t, args))
    assert tuple(got.shape) == (B, S, CFG["vocab_size"])
    assert rel_err(got, jm(*map(_j, args))) <= 1e-5


class _JaxDraws:
    """The port's keep masks replaced by JAX's n-th draw under KEY
    (`make_rng`: fold_in(key, n)); records each draw's shape."""

    def __init__(self):
        self.n, self.shapes = 0, []

    def __call__(self, prob, shape, device):
        k = jax.random.fold_in(KEY, self.n)
        self.n += 1
        self.shapes.append(tuple(shape))
        return torch.from_numpy(np.array(
            jax.random.bernoulli(k, prob, tuple(shape))))


@pytest.mark.parametrize("which", ["ids+types", "ids+types+mask"])
def test_train_dropout_with_jax_masks(cls_pair, batch, which, monkeypatch):
    """Logits and gradients of the cross-entropy in training with every
    dropout on, each mask JAX's own."""
    jm, params, pm = cls_pair
    args = _args(batch, which)
    y = batch[3]

    def loss_jax(p):
        out, _ = jax_functional_call(jm, p, *map(_j, args), rngs=KEY,
                                     training=True)
        return jbert.F.cross_entropy(out, _j(y)), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_jax, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()})
    draws = _JaxDraws()
    monkeypatch.setattr(rng, "keep_mask", draws)
    pm.train()
    pm.zero_grad()
    with rng.rng_context(0, 0):
        out = pm(*map(_t, args))
    F.cross_entropy(out, _t(y)).backward()
    # embedding, then per layer attention + two residual draws, then the
    # classifier: JAX's order and shapes
    h, nh = CFG["hidden_size"], CFG["num_heads"]
    assert draws.shapes == [(B, S, h)] + [
        (B, nh, S, S), (B, S, h), (B, S, h)] * CFG["num_layers"] + [(B, h)]
    assert rel_err(out, want) <= 1e-5
    for k, p in pm.named_parameters():
        g = np.asarray(grads[k])
        err = np.abs(p.grad.numpy() - g).max() / max(np.abs(g).max(), 1e-30)
        assert err <= 1e-4, (k, err)


def test_additive_mask_rounding():
    m = np.array([[1, 1, 0, 1]])
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        got = pbert.additive_mask(torch.from_numpy(m), tdt)
        want = (1.0 - jnp.asarray(m)[:, None, None, :].astype(jdt)) * -1e4
        assert got.dtype == tdt and got.shape == (1, 1, 1, 4)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))
    assert float(pbert.additive_mask(torch.tensor([[0]]),
                                     torch.bfloat16)) == -9984.0


@pytest.mark.parametrize("which,training,dropout,dense", [
    ("ids", False, 0.1, 0), ("ids+mask", False, 0.1, 2),
    ("ids", True, 0.0, 0), ("ids", True, 0.1, 2)])
def test_attention_route(batch, which, training, dropout, dense):
    """No mask and no attention dropout: the flash entry (its plain
    version on the CPU); a mask or dropout: `attention_dense`, once per
    layer."""
    _, _, pm = _pair(jbert.BertForSequenceClassification,
                     pbert.BertForSequenceClassification, 2,
                     dropout=dropout)
    pm.train(training)
    fa.DENSE_ATTENTION_CALLS.reset()
    with rng.rng_context(0, 0):
        pm(*map(_t, _args(batch, which)))
    assert fa.DENSE_ATTENTION_CALLS.count == dense


def test_one_dropout_two_draws():
    layer = pbert.BertLayer(pbert.BertConfig(**CFG),
                            torch.Generator().manual_seed(0))
    x = torch.ones(2, 8, CFG["hidden_size"])
    with rng.rng_context(1, 0):
        a, b = layer.dropout(x), layer.dropout(x)
    assert not torch.equal(a, b)
    with rng.rng_context(1, 0):
        assert torch.equal(layer.dropout(x), a)


def test_configs_match_jax():
    for name in ("ernie_base", "bert_base", "bert_large"):
        got = getattr(pbert, name)(attention_dropout=0.0)
        want = getattr(jbert, name)(attention_dropout=0.0)
        assert vars(got) == vars(want), name
    assert vars(pbert.BertConfig()) == vars(jbert.BertConfig())
