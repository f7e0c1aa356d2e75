"""BERT fine-tuning in the port's `Trainer` against the JAX package's, in
lockstep from the same weights (carried by `load_jax_state`) on the
same seeded batch: a tiny BERT (vocab 1000, hidden 64, 2 layers, 2
heads, intermediate 128; dropout 0), batch 4 x 16, fp32 on the CPU.

- `BertForSequenceClassification` with `num_inputs=3` over (input_ids,
  token_type_ids, attention_mask, labels), and with `num_inputs=1`
  over (input_ids, labels), 3 AdamW(1e-3) steps each: every loss within
  1e-5 relative; after 3 steps every parameter within 1e-3 of its
  largest magnitude and within 1e-2 of how far JAX's run moved it, and
  both moments within 1e-4 of their largest magnitude (seen: 1.7e-4,
  8.3e-4, 5e-6; Adam divides each gradient by its running size, so an
  entry whose gradient is near 0 carries the two packages' rounding
  differences into a whole step);
- the JAX train state after those 3 steps (`from_jax_train_state(tree,
  model=..., optimizer=...)`: parameters, both moments, the step)
  resumed by the port for 2 more steps in lockstep with JAX's.
The MLM head and O2 are in `test_torch_bert_amp.py`.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models import from_jax_train_state, load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from port_resnet import numpy_tree, worst, worst_move
from port_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=64,
           hidden_dropout=0.0, attention_dropout=0.0)
LR, STEPS = 1e-3, 3


def _jce(o, t):
    return jnn.functional.cross_entropy(o, t)


def _ce(o, t):
    return F.cross_entropy(o, t)


@pytest.fixture(scope="module")
def start():
    pt.seed(0)
    jm = jbert.BertForSequenceClassification(jbert.BertConfig(**CFG), 3)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, CFG["vocab_size"], (4, 16))
    tt = rs.randint(0, 4, (4, 16))
    mask = (np.arange(16)[None] < np.array([16, 11, 5, 14])[:, None]
            ).astype(np.int64)
    y = rs.randint(0, 3, (4,))
    return jm, numpy_tree(jm.raw_parameters()), (ids, tt, mask, y)


def _port(params, cls=pbert.BertForSequenceClassification, *args):
    return load_jax_state(cls(pbert.BertConfig(**CFG), *args or (3,),
                              device="cpu"), params)


def _jax_run(jm, batch, steps=STEPS, more=0, **kw):
    """(losses, state tree after `steps`, losses of `more` steps on)."""
    jt = JaxTrainer(jm, jopt.AdamW(LR), _jce, num_inputs=len(batch) - 1,
                    donate=False, **kw)
    _, losses = jt.train_steps(*batch, steps=steps)
    tree = numpy_tree(jt.state.tree())
    extra = None
    if more:
        _, extra = jt.train_steps(*batch, steps=more)
        extra = (np.array(extra), numpy_tree(jt.state.tree()))
    return np.array(losses), tree, extra


@pytest.fixture(scope="module")
def jax_masked(start):
    jm, _, batch = start
    return _jax_run(jm, batch, more=2)


def _slots(opt_state, name):
    return {k: v[name] for k, v in opt_state["slots"].items()}


def _hold_state(port_state, tree, p0):
    assert worst(port_state.params, tree["params"])[0] <= 1e-3
    assert worst_move(port_state.params, tree["params"], p0)[0] <= 1e-2
    for name in ("moment1", "moment2"):
        got = _slots(port_state.opt_state, name)
        assert worst(got, _slots(tree["opt_state"], name))[0] <= 1e-4
    assert port_state.opt_state["step"] == int(tree["opt_state"]["step"])


@pytest.mark.parametrize("masked", [True, False])
def test_lockstep_fp32(start, jax_masked, masked):
    jm, p0, (ids, tt, mask, y) = start
    batch = (ids, tt, mask, y) if masked else (ids, y)
    losses, tree, _ = jax_masked if masked else _jax_run(jm, batch)
    tr = Trainer(_port(p0), AdamW(LR), _ce, num_inputs=len(batch) - 1)
    _, got = tr.train_steps(*batch, steps=STEPS)
    np.testing.assert_allclose(got.numpy(), losses, rtol=1e-5)
    _hold_state(tr.state, tree, p0)


def test_resume_jax_state(start, jax_masked):
    _, p0, batch = start
    _, tree, (more, final) = jax_masked
    model = _port(p0)
    tr = Trainer(model, AdamW(LR), _ce, num_inputs=3)
    tr.load_state(from_jax_train_state(tree, model=model,
                                       optimizer=AdamW(LR)))
    assert tr.state.step == STEPS
    _, got = tr.train_steps(*batch, steps=2)
    np.testing.assert_allclose(got.numpy(), more, rtol=1e-5)
    _hold_state(tr.state, final, p0)
