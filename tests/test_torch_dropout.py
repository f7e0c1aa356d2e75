"""Dropout, masked and dropout attention, the RNG context, remat and
`loop_unroll` in the port, against the JAX package where the two share
a function.

- The dropout arithmetic (both modes, `axis`, `dropout2d`, `dropout3d`,
  `alpha_dropout`) and `attention_dense` with bool and additive masks
  and dropout against `_attention_reference`: both sides take JAX's own
  keep mask (the port through its test-only `keep=` argument), so the
  comparison is of the arithmetic, bitwise for dropout and within 1e-6
  for attention (einsum orders);
- the port's masks: different across steps and microbatches, the same
  bits for the same seed, and a keep rate of 1 - p in law (the draws
  are torch's, so they equal JAX's in law only);
- the dispatcher: a mask or dropout goes to `attention_dense`
  (`DENSE_ATTENTION_CALLS`), nothing else does;
- `remat=True` gives the same losses and parameters as `remat=False`,
  bitwise, with dropout 0.1 (the recomputed forward draws the same
  masks), and `loop_unroll=2` the same losses as 1.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as jF
from paddle_tpu.nn.layer import rng_context as jax_rng_context
from paddle_tpu.ops_pallas import flash_attention as jfa
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import rng
from paddle_tpu_torch.ops_cuda import flash_attention as fa
from paddle_tpu_torch.optimizer import SGD, AdamW
from port_threads import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_keep(p, shape):
    """The mask JAX's first draw under `KEY` takes (make_rng: fold_in(key,
    0))."""
    return jax.random.bernoulli(jax.random.fold_in(KEY, 0), 1.0 - p, shape)


# (p, axis, mode, shape)
DROPOUT_CASES = [(0.1, None, "upscale_in_train", (4, 6, 8)),
                 (0.5, None, "downscale_in_infer", (4, 6, 8)),
                 (0.3, 1, "upscale_in_train", (4, 6, 8)),
                 (0.25, (0, 2), "upscale_in_train", (4, 6, 8))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,axis,mode,shape", DROPOUT_CASES)
def test_dropout_arithmetic_matches_jax(p, axis, mode, shape, dtype):
    x = jnp.asarray(np.random.RandomState(0).randn(*shape), dtype)
    with jax_rng_context(KEY):
        want = jF.dropout(x, p=p, axis=axis, training=True, mode=mode)
    mshape = list(shape)
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else axis
        mshape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _t(_jax_keep(p, tuple(mshape)))
    xt = _t(x.astype(jnp.float32)).to(getattr(torch, dtype))
    got = F.dropout(xt, p=p, axis=axis, training=True, mode=mode, keep=keep)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # outside training
    ev = F.dropout(xt, p=p, training=False, mode=mode)
    jev = jF.dropout(x, p=p, training=False, mode=mode)
    np.testing.assert_array_equal(ev.float().numpy(),
                                  np.asarray(jev.astype(jnp.float32)))


def test_dropout2d_3d_and_alpha_dropout_match_jax():
    x4 = jnp.asarray(np.random.RandomState(1).randn(3, 5, 4, 4), jnp.float32)
    x5 = jnp.asarray(np.random.RandomState(2).randn(2, 3, 2, 4, 4),
                     jnp.float32)
    for jfn, pfn, x, mshape in (
            (jF.dropout2d, F.dropout2d, x4, (3, 5, 1, 1)),
            (jF.dropout3d, F.dropout3d, x5, (2, 3, 1, 1, 1)),
            (jF.alpha_dropout, F.alpha_dropout, x4, x4.shape)):
        with jax_rng_context(KEY):
            want = jfn(x, p=0.4, training=True)
        got = pfn(_t(x), p=0.4, training=True,
                  keep=_t(_jax_keep(0.4, mshape)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    assert F.dropout(_t(x4), p=1.0).abs().sum() == 0
    assert F.alpha_dropout(_t(x4), p=0.4, training=False) is not None


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["bool", "additive", "dropout",
                                  "bool+dropout"])
def test_attention_dense_matches_reference(kind, causal):
    b, sq, sk, h, d = 2, 16, 24, 3, 8
    rs = np.random.RandomState(3)
    q, k, v = (jnp.asarray(rs.randn(b, s, h, d), jnp.float32)
               for s in (sq, sk, sk))
    mask = None
    if "bool" in kind:
        mask = jnp.asarray(rs.rand(b, 1, sq, sk) > 0.3)
    elif kind == "additive":
        mask = jnp.asarray(rs.randn(1, h, sq, sk), jnp.float32)
    p = 0.2 if "dropout" in kind else 0.0
    key = jax.random.PRNGKey(11)
    want = jfa._attention_reference(q, k, v, mask, causal, None, p,
                                    key if p else None)
    keep = _t(jax.random.bernoulli(key, 1.0 - p, (b, h, sq, sk))) \
        if p else None
    fa.DENSE_ATTENTION_CALLS.reset()
    got = fa.attention_dense(_t(q), _t(k), _t(v),
                             None if mask is None else _t(mask), causal,
                             None, p, keep=keep)
    assert fa.DENSE_ATTENTION_CALLS.count == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_dispatcher_routes_masks_and_dropout_only():
    q = torch.randn(1, 8, 2, 64)
    fa.DENSE_ATTENTION_CALLS.reset()
    fa.dot_product_attention(q, q, q, causal=True)
    assert fa.DENSE_ATTENTION_CALLS.count == 0
    fa.dot_product_attention(q, q, q, mask=torch.ones(8, 8, dtype=bool))
    with rng.rng_context(0, 0):
        fa.dot_product_attention(q, q, q, causal=True, dropout_p=0.1)
    assert fa.DENSE_ATTENTION_CALLS.count == 2
    # scaled_dot_product_attention: dropout only in training
    F.scaled_dot_product_attention(q, q, q, dropout_p=0.1, is_causal=True,
                                   training=False)
    assert fa.DENSE_ATTENTION_CALLS.count == 2


def test_draws_need_a_key_and_are_keyed():
    with pytest.raises(RuntimeError, match="rng_context"):
        rng.keep_mask(0.9, (4,), "cpu")
    with rng.rng_context(5, 0):
        a, b = rng.keep_mask(0.5, (64,), "cpu"), rng.keep_mask(0.5, (64,),
                                                               "cpu")
    with rng.rng_context(5, 0):
        a2 = rng.keep_mask(0.5, (64,), "cpu")
    with rng.rng_context(5, 1):
        c = rng.keep_mask(0.5, (64,), "cpu")
    with rng.rng_context(5, 0, 1):
        m1 = rng.keep_mask(0.5, (64,), "cpu")
    assert torch.equal(a, a2)
    assert not torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, m1)
    with pytest.raises(RuntimeError, match="rng_context"):
        rng.next_seed()                       # the context has ended


def test_keep_rate_in_law():
    """1e6 draws at keep probability 0.9: the keep rate within 5 sigma
    (sigma = sqrt(0.09 / 1e6) = 3e-4)."""
    with rng.rng_context(1, 2):
        keep = rng.keep_mask(0.9, (1000, 1000), "cpu")
    assert abs(keep.float().mean().item() - 0.9) < 5 * math.sqrt(0.09 / 1e6)
    x = torch.ones(1000, 1000)
    with rng.rng_context(3, 4):
        y = F.dropout(x, p=0.1)
    assert abs(y.mean().item() - 1.0) < 5 * math.sqrt(0.1 / 0.9 / 1e6)


def _ids(b=4, s=32):
    return np.random.RandomState(0).randint(0, 1024, (b, s))


def _trainer(opt=None, seed=0, **kw):
    model = gpt_tiny(seed=seed, device="cpu", dropout=0.1)
    return Trainer(model, opt or AdamW(learning_rate=1e-3),
                   lambda lg, y: model.loss(lg, y), **kw)


def test_masks_differ_across_steps_and_microbatches_and_repeat():
    ids = _ids()
    tr = _trainer(SGD(learning_rate=0.0))
    _, o1 = tr.train_step(ids, ids)
    _, o2 = tr.train_step(ids, ids)
    assert not torch.equal(o1, o2)          # new masks each step
    # the same seed again: the same bits
    tr2 = _trainer(SGD(learning_rate=0.0))
    _, o1b = tr2.train_step(ids, ids)
    assert torch.equal(o1, o1b)
    # microbatches of one step: different keys, so different masks
    acc = _trainer(SGD(learning_rate=0.0), grad_accum=2)
    half = np.concatenate([ids[:2], ids[:2]])
    with torch.no_grad():
        st = acc.init_state()
        outs = []
        for i in range(2):
            loss, out = acc._forward(st.params, st.buffers,
                                     (torch.as_tensor(ids[:2]),) * 2, True,
                                     key=(st.rng_key, st.step, i))
            outs.append(out)
    assert not torch.equal(outs[0], outs[1])
    losses = acc.train_steps(half, half, steps=2)[1]
    assert torch.isfinite(losses).all()


def test_remat_is_bitwise_equal_with_dropout():
    ids = _ids()
    a, b = _trainer(), _trainer(remat=True)
    la = [a.train_step(ids, ids)[0] for _ in range(2)]
    lb = [b.train_step(ids, ids)[0] for _ in range(2)]
    assert [x.item() for x in la] == [x.item() for x in lb]
    for k, v in a.state.params.items():
        assert torch.equal(v, b.state.params[k]), k
    for k, sl in a.state.opt_state["slots"].items():
        for s, t in sl.items():
            assert torch.equal(t, b.state.opt_state["slots"][k][s]), (k, s)


def test_loop_unroll_changes_nothing():
    ids = _ids()
    one = _trainer(loop_unroll=1).train_steps(ids, ids, steps=3)[1]
    two = _trainer(loop_unroll=2).train_steps(ids, ids, steps=3)[1]
    assert one.tolist() == two.tolist()
    with pytest.raises(ValueError, match="loop_unroll"):
        _trainer(loop_unroll=0)
