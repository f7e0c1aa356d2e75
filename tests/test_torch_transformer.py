"""The port's transformer layers (`nn/layers_transformer.py`) against the
JAX package's, with the JAX layer's weights carried over by
`load_jax_state` (same names, (in, out) layouts).

fp32 on the CPU, eval mode unless a case says otherwise, embed 32 and 2
heads (head dim 16), batch 2, seq 5-7:
- `MultiHeadAttention`: self and cross attention (kdim / vdim), a bool
  mask (True keeps), an additive float mask, `need_weights` (the
  weights too), the incremental `cache` (the new cache too);
- `TransformerEncoderLayer` post- and pre-norm, relu and gelu, with a
  mask and with a cache; `TransformerEncoder` (two deep-copied layers
  and a final norm); `TransformerDecoderLayer` / `TransformerDecoder`;
  `Transformer` with a causal target mask
  (`generate_square_subsequent_mask`) and a memory mask;
  `FusedFeedForward`;
- the gradients of an encoder layer and of a whole `Transformer` with
  respect to every parameter, against `jax.grad` of the same loss.
Outputs within 1e-5 of their largest magnitude (einsum and matmul
orders differ between XLA:CPU and torch); gradients within 1e-4 of
each tensor's largest magnitude (or of 1e-3 of the largest over all
tensors, for a gradient that is zero in exact arithmetic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import load_jax_state
from port_resnet import numpy_tree, rel_err
from port_threads import one_torch_thread  # noqa: F401

E, H = 32, 2


def _pair(jcls, pcls, *args, **kw):
    """(JAX layer, port layer carrying its weights), both in eval."""
    pt.seed(0)
    jm = jcls(*args, **kw)
    pm = load_jax_state(pcls(*args, **kw), numpy_tree(jm.raw_parameters()))
    jm.eval()
    pm.eval()
    return jm, pm


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol=1e-5):
    assert rel_err(got, want) <= tol, rel_err(got, want)


def _masks(sq, sk):
    rs = np.random.RandomState(3)
    keep = rs.rand(2, 1, sq, sk) > 0.3
    keep[..., 0] = True                      # every row sees a key
    return {"none": None, "bool": keep,
            "additive": np.where(keep, 0.0, -1e4).astype(np.float32),
            "bool 2-d": np.tril(np.ones((sq, sk), bool), sk - sq)}


@pytest.mark.parametrize("mask", ["none", "bool", "additive", "bool 2-d"])
@pytest.mark.parametrize("need_weights", [False, True])
def test_mha_self(mask, need_weights):
    jm, pm = _pair(jnn.MultiHeadAttention, nn.MultiHeadAttention, E, H,
                   need_weights=need_weights)
    x = _x(2, 6, E)
    m = _masks(6, 6)[mask]
    want = jm(_j(x), attn_mask=_j(m))
    got = pm(_t(x), attn_mask=_t(m))
    if need_weights:
        _close(got[1], want[1])
        got, want = got[0], want[0]
    _close(got, want)


@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
def test_mha_cross_kdim_vdim(mask):
    jm, pm = _pair(jnn.MultiHeadAttention, nn.MultiHeadAttention, E, H,
                   kdim=24, vdim=20)
    q, k, v = _x(2, 5, E), _x(2, 7, 24, seed=1), _x(2, 7, 20, seed=2)
    m = _masks(5, 7)[mask]
    _close(pm(_t(q), _t(k), _t(v), _t(m)), jm(_j(q), _j(k), _j(v), _j(m)))


@pytest.mark.parametrize("need_weights", [False, True])
def test_mha_cache(need_weights):
    """One new position against a cache of 4: the output and the new
    (k, v) cache."""
    jm, pm = _pair(jnn.MultiHeadAttention, nn.MultiHeadAttention, E, H,
                   need_weights=need_weights)
    x = _x(2, 1, E)
    kp, vp = _x(2, 4, H, E // H, seed=4), _x(2, 4, H, E // H, seed=5)
    want = jm(_j(x), cache=(_j(kp), _j(vp)))
    got = pm(_t(x), cache=(_t(kp), _t(vp)))
    assert len(got) == len(want) == (3 if need_weights else 2)
    _close(got[0], want[0])
    for g, w in zip(got[-1], want[-1]):
        assert tuple(g.shape) == (2, 5, H, E // H)
        _close(g, w)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_layer(normalize_before, activation):
    jm, pm = _pair(jnn.TransformerEncoderLayer, nn.TransformerEncoderLayer,
                   E, H, 64, dropout=0.1, activation=activation,
                   normalize_before=normalize_before)
    x = _x(2, 6, E)
    for mask in ("none", "bool", "additive"):
        m = _masks(6, 6)[mask]
        _close(pm(_t(x), _t(m)), jm(_j(x), _j(m)))
    kp, vp = _x(2, 3, H, E // H, seed=6), _x(2, 3, H, E // H, seed=7)
    got, gc = pm(_t(x[:, :1]), None, (_t(kp), _t(vp)))
    want, wc = jm(_j(x[:, :1]), None, (_j(kp), _j(vp)))
    _close(got, want)
    _close(gc[0], wc[0])


def test_encoder_stack():
    pt.seed(0)
    jl = jnn.TransformerEncoderLayer(E, H, 64, dropout=0.0)
    jm = jnn.TransformerEncoder(jl, 2, jnn.LayerNorm(E))
    params = numpy_tree(jm.raw_parameters())
    pm = nn.TransformerEncoder(
        nn.TransformerEncoderLayer(E, H, 64, dropout=0.0), 2,
        nn.LayerNorm(E))
    assert [k for k, _ in pm.named_parameters()] == list(params)
    load_jax_state(pm, params)
    # the two layers start equal (deep copies), as in JAX
    assert torch.equal(pm.layers[0].linear1.weight,
                       pm.layers[1].linear1.weight)
    x = _x(2, 6, E)
    m = _masks(6, 6)["bool"]
    _close(pm(_t(x), _t(m)), jm(_j(x), _j(m)))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder(normalize_before):
    pt.seed(0)
    jl = jnn.TransformerDecoderLayer(E, H, 64, dropout=0.0,
                                     normalize_before=normalize_before)
    jm = jnn.TransformerDecoder(jl, 2, jnn.LayerNorm(E))
    pm = load_jax_state(nn.TransformerDecoder(
        nn.TransformerDecoderLayer(E, H, 64, dropout=0.0,
                                   normalize_before=normalize_before), 2,
        nn.LayerNorm(E)), numpy_tree(jm.raw_parameters()))
    tgt, mem = _x(2, 5, E), _x(2, 7, E, seed=1)
    tmask = np.tril(np.ones((5, 5), bool))
    mmask = _masks(5, 7)["additive"]
    _close(pm(_t(tgt), _t(mem), _t(tmask), _t(mmask)),
           jm(_j(tgt), _j(mem), _j(tmask), _j(mmask)))
    _close(pm.layers[0](_t(tgt), _t(mem)), jm.layers[0](_j(tgt), _j(mem)))


@pytest.fixture(scope="module")
def transformer():
    return _pair(jnn.Transformer, nn.Transformer, E, H, 2, 2, 64,
                 dropout=0.0)


def test_transformer(transformer):
    jm, pm = transformer
    src, tgt = _x(2, 7, E), _x(2, 5, E, seed=1)
    tmask = nn.Transformer.generate_square_subsequent_mask(5)
    assert np.array_equal(tmask.numpy(), np.asarray(
        jnn.Transformer.generate_square_subsequent_mask(5)))
    smask = _masks(7, 7)["additive"]
    _close(pm(_t(src), _t(tgt), _t(smask), tmask),
           jm(_j(src), _j(tgt), _j(smask), _j(tmask.numpy())))


def _grads_close(pm, jm, loss_port, loss_jax):
    params = {k: jnp.asarray(v) for k, v in
              numpy_tree(jm.raw_parameters()).items()}
    want = jax.jit(jax.grad(loss_jax))(params)
    pm.zero_grad()
    loss_port().backward()
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    # a gradient that is 0 in exact arithmetic (k_proj's bias: the
    # softmax ignores a shift shared by every key) is rounding in both
    # packages: each error is taken against the larger of the tensor's
    # largest magnitude and 1e-3 of the largest over all tensors
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    worst = max((float(np.abs(got[k].numpy() - np.asarray(w)).max())
                 / max(float(np.abs(np.asarray(w)).max()), 1e-3 * top), k)
                for k, w in want.items())
    assert worst[0] <= 1e-4, worst


def test_encoder_layer_grads():
    jm, pm = _pair(jnn.TransformerEncoderLayer, nn.TransformerEncoderLayer,
                   E, H, 64, dropout=0.0, activation="gelu")
    x, m = _x(2, 6, E), _masks(6, 6)["bool"]
    # a fixed random projection of the output (sum(out ** 2) would not
    # do: after the last LayerNorm it hardly depends on the rest)
    r = _x(2, 6, E, seed=9)

    def loss_jax(p):
        out, _ = jax_functional_call(jm, p, _j(x), _j(m))
        return jnp.sum(out * _j(r))

    _grads_close(pm, jm, lambda: (pm(_t(x), _t(m)) * _t(r)).sum(),
                 loss_jax)


def test_transformer_grads(transformer):
    jm, pm = transformer
    src, tgt = _x(2, 7, E), _x(2, 5, E, seed=1)
    tmask = np.tril(np.ones((5, 5), bool))

    def loss_jax(p):
        out, _ = jax_functional_call(jm, p, _j(src), _j(tgt), None,
                                     _j(tmask))
        return jnp.sum(jnp.sin(out))

    _grads_close(pm, jm, lambda: torch.sin(
        pm(_t(src), _t(tgt), None, _t(tmask))).sum(), loss_jax)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_fused_feed_forward(normalize_before):
    jm, pm = _pair(jnn.FusedFeedForward, nn.FusedFeedForward, E, 64,
                   normalize_before=normalize_before)
    x = _x(2, 6, E)
    _close(pm(_t(x)), jm(_j(x)))
    assert nn.FusedMultiHeadAttention is nn.MultiHeadAttention
    assert nn.FusedTransformerEncoderLayer is nn.TransformerEncoderLayer


def test_train_mode_dropout_needs_a_key():
    """Dropout in training draws from the step's key, as the port's
    other dropouts do (the Trainer installs it)."""
    from paddle_tpu_torch.nn import rng
    layer = nn.TransformerEncoderLayer(E, H, 64, dropout=0.5)
    x = torch.from_numpy(_x(2, 6, E))
    with pytest.raises(RuntimeError, match="needs a key"):
        layer(x)
    with rng.rng_context(0, 0):
        a = layer(x)
    with rng.rng_context(0, 0):
        b = layer(x)
    with rng.rng_context(0, 1):
        c = layer(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
