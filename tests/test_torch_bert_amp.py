"""BERT in the port's `Trainer` against the JAX package's, beside
`test_torch_bert_train.py`'s fp32 lockstep: the MLM head and O2. The
same tiny BERT (vocab 1000, hidden 64, 2 layers, 2 heads, intermediate
128; dropout 0), batch 4 x 16, on the CPU.

- one AdamW(1e-3) step of `BertForMaskedLM` (the head tied to the word
  embedding) over (input_ids, token_type_ids, attention_mask, labels):
  the loss within 1e-5 relative and every parameter within 1e-3 of its
  largest magnitude; the pooler, which the loss does not reach, gets a
  zero gradient in both packages and moves by AdamW's decay alone
  (lr x 0.01 x p, within 2 fp32 ulps of the weights; equal to JAX's
  within 1e-6);
- O2 (bf16), 3 AdamW(1e-3) steps of the classifier: the state's layout
  as JAX's (LayerNorm parameters fp32 with no master, the rest bf16
  with an fp32 master), the first loss within 2e-2 relative of JAX's
  bf16 loss (bf16 keeps 8 bits through 2 layers), and after 3 steps
  the port's fp32 masters as close to the fp32 run (the port's, which
  `test_torch_bert_train.py` holds to JAX's) as JAX's own bf16 run is:
  at most 1.5x its distance, as a share of how far the fp32 run moved
  each tensor, plus 0.01.
"""
import numpy as np

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from port_resnet import f32, numpy_tree, worst, worst_move
from port_threads import one_torch_thread  # noqa: F401
from test_torch_bert_train import (CFG, LR, STEPS, _ce, _jax_run, _port,
                                   start)  # noqa: F401


def test_mlm_step_decays_the_unreached_pooler(start):
    _, _, (ids, tt, mask, _) = start
    pt.seed(1)
    jm = jbert.BertForMaskedLM(jbert.BertConfig(**CFG))
    p0 = numpy_tree(jm.raw_parameters())
    vocab = CFG["vocab_size"]

    def jloss(o, t):
        return jnn.functional.cross_entropy(o.reshape(-1, vocab),
                                            t.reshape(-1))

    jt = JaxTrainer(jm, jopt.AdamW(LR), jloss, num_inputs=3, donate=False)
    jl, _ = jt.train_step(ids, tt, mask, ids)
    tree = numpy_tree(jt.state.tree())
    model = load_jax_state(pbert.BertForMaskedLM(pbert.BertConfig(**CFG),
                                                 device="cpu"), p0)
    tr = Trainer(model, AdamW(LR),
                 lambda o, t: F.cross_entropy(o.reshape(-1, vocab),
                                              t.reshape(-1)), num_inputs=3)
    pl, _ = tr.train_step(ids, tt, mask, ids)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    name = "bert.pooler.weight"
    moved = tr.state.params[name].detach().numpy() - p0[name]
    # the move is ~1e-7 of weights ~2e-2: the difference of two fp32
    # values carries their rounding, 2 ulps of the largest weight
    ulp = np.spacing(np.abs(p0[name]).max())
    np.testing.assert_allclose(moved, -LR * 0.01 * p0[name], rtol=0,
                               atol=2 * ulp)
    np.testing.assert_allclose(tr.state.params[name].detach().numpy(),
                               tree["params"][name], rtol=1e-6)
    assert worst(tr.state.params, tree["params"])[0] <= 1e-3


def test_o2_within_bf16s_own_distance(start):
    """The fp32 reference is the port's own fp32 run, which
    `test_torch_bert_train.py` holds to JAX's (one JAX compile less)."""
    jm, p0, batch = start
    ref = Trainer(_port(p0), AdamW(LR), _ce, num_inputs=3)
    ref.train_steps(*batch, steps=STEPS)
    j32 = {"params": {k: v.detach() for k, v in ref.state.params.items()}}
    j16_losses, j16, _ = _jax_run(jm, batch, amp_level="O2",
                                  amp_dtype="bfloat16")
    tr = Trainer(_port(p0), AdamW(LR), _ce, num_inputs=3, amp_level="O2",
                 amp_dtype="bfloat16")
    _, got = tr.train_steps(*batch, steps=STEPS)
    st = tr.state
    norms = tr._norm_param_names()
    assert norms == {k for k in p0 if "ln" in k.split(".")[-2]}
    for k, v in st.params.items():
        want = np.dtype(j16["params"][k].dtype).name
        assert str(v.dtype)[6:] == want, (k, v.dtype, want)
        assert ("master_weight" in st.opt_state["slots"][k]) \
            == (k not in norms)
    got = f32(got)
    assert abs(got[0] - j16_losses[0]) / abs(j16_losses[0]) <= 2e-2
    masters = {k: (s["master_weight"] if "master_weight" in s
                   else st.params[k])
               for k, s in st.opt_state["slots"].items()}
    jax16 = {k: (s["master_weight"] if "master_weight" in s
                 else j16["params"][k])
             for k, s in j16["opt_state"]["slots"].items()}
    own = worst_move(jax16, j32["params"], p0)[0]
    port = worst_move(masters, j32["params"], p0)[0]
    assert port <= 1.5 * own + 0.01, (port, own)
