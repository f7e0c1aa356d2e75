"""The port's optimizers (`paddle_tpu_torch/optimizer/__init__.py`) and
gradient clips (`paddle_tpu_torch/nn/clip.py`) against the JAX
package's.

Same numpy-seeded parameters and gradients on both sides:
- each of the 10 rules, 3 updates in fp32 with its weight decay (L2,
  decoupled, Lamb's and LARS's with their exclusions), and under
  multi-precision (bf16 parameters, fp32 masters) for the rules whose
  constructor takes `multi_precision`; slots, masters and parameters;
- each clip on fp32 and bf16 gradients, and a clip and a scheduler
  inside `update` (the first update sees `value(0)`);
- the eager surface (`bind` / `step` / `state_dict` / `set_state_dict`,
  `get_lr` / `set_lr`);
- `from_jax_train_state` of a JAX Momentum run and a JAX Lamb run on
  `gpt_tiny`, resumed in lockstep.

Tolerance: fp32 slots and parameters within 2e-6 relative (atol 1e-7):
the same rule, but torch's CPU kernels fuse some multiply-adds that
XLA rounds twice (seen: 4e-7); bf16 parameters within one bf16 ulp of
the JAX cast of the same master.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import utils_clip as jclip
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import (from_jax_train_state, gpt_tiny,
                                     load_jax_params)
from paddle_tpu_torch.models.weights import _to_tensor
from paddle_tpu_torch.nn import clip as pclip
from port_threads import one_torch_thread  # noqa: F401

SHAPES = {"fc.weight": (8, 16), "fc.bias": (16,), "ln.weight": (16,),
          "emb.weight": (12, 8)}

# rule -> constructor kwargs (the same on both sides)
RULES = {
    "SGD": dict(learning_rate=0.05, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.05, momentum=0.9, use_nesterov=True,
                     weight_decay=0.01),
    "Adam": dict(learning_rate=0.01, weight_decay=0.01),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.1,
                  apply_decay_param_fun=lambda n: not n.endswith("bias")),
    "Adamax": dict(learning_rate=0.01, weight_decay=0.01),
    "Adagrad": dict(learning_rate=0.05, weight_decay=0.01,
                    initial_accumulator_value=0.1),
    "Adadelta": dict(learning_rate=1.0, rho=0.9, weight_decay=0.01),
    "RMSProp": dict(learning_rate=0.01, rho=0.9, momentum=0.5,
                    centered=True, weight_decay=0.01),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.01,
                 exclude_from_weight_decay_fn=lambda n: "ln" in n),
    "LarsMomentum": dict(learning_rate=0.1, lars_coeff=0.01,
                         lars_weight_decay=0.001,
                         exclude_from_weight_decay=("bias",)),
}
MASTER_RULES = ["SGD", "Momentum", "Adam", "AdamW", "LarsMomentum"]


def _case(dtype, n_steps=3, seed=3):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(n_steps)]
    jp = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    tp = {k: _to_tensor(k, np.asarray(v)) for k, v in jp.items()}
    jg = [{k: jnp.asarray(v, dtype) for k, v in g.items()} for g in grads]
    tg = [{k: _to_tensor(k, np.asarray(v)) for k, v in g.items()} for g in jg]
    return jp, tp, jg, tg


def _run(rule, kw, dtype, multi_precision=False, **extra):
    jo = getattr(jopt, rule)(**kw, **extra)
    to = getattr(popt, rule)(**kw, **extra)
    jo.multi_precision = to.multi_precision = multi_precision
    jp, tp, jg, tg = _case(dtype)
    js, ts = jo.init(jp), to.init(tp)
    for g_j, g_t in zip(jg, tg):
        jp, js = jo.update(g_j, js, jp)
        tp, ts = to.update(g_t, ts, tp)
    return jp, js, tp, ts


def _assert_state(jp, js, tp, ts, bf16=False):
    assert ts["step"] == int(js["step"])
    for k in jp:
        assert sorted(ts["slots"][k]) == sorted(js["slots"][k]), k
        for sk, v in js["slots"][k].items():
            np.testing.assert_allclose(
                ts["slots"][k][sk].float().numpy(),
                np.asarray(v.astype(jnp.float32)), rtol=2e-6, atol=1e-7,
                err_msg=f"{k}.{sk}")
        tol = 2 ** -7 if bf16 else 2e-6
        np.testing.assert_allclose(
            tp[k].float().numpy(), np.asarray(jp[k].astype(jnp.float32)),
            rtol=tol, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("rule", list(RULES))
def test_rule_matches_jax_fp32(rule):
    jp, js, tp, ts = _run(rule, RULES[rule], jnp.float32)
    _assert_state(jp, js, tp, ts)
    assert all(v.dtype == torch.float32 for v in tp.values())


@pytest.mark.parametrize("rule", MASTER_RULES)
def test_rule_matches_jax_multi_precision(rule):
    jp, js, tp, ts = _run(rule, RULES[rule], jnp.bfloat16,
                          multi_precision=True)
    _assert_state(jp, js, tp, ts, bf16=True)
    for k in tp:
        assert tp[k].dtype == torch.bfloat16
        assert "master_weight" in ts["slots"][k]


def test_rmsprop_uncentered_and_momentum_plain():
    for rule, kw in (("RMSProp", dict(learning_rate=0.01)),
                     ("Momentum", dict(learning_rate=0.05))):
        _assert_state(*_run(rule, kw, jnp.float32))


# --------------------------------------------------------------------------- #
# clipping
# --------------------------------------------------------------------------- #

CLIPS = {"value": ("ClipGradByValue", (0.5,), {}),
         "value_asym": ("ClipGradByValue", (0.7,), dict(min=-0.2)),
         "norm": ("ClipGradByNorm", (1.5,), {}),
         "global": ("ClipGradByGlobalNorm", (2.0,), {}),
         "global_loose": ("ClipGradByGlobalNorm", (1e6,), {})}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("clip", list(CLIPS))
def test_clip_matches_jax(clip, dtype):
    name, args, kw = CLIPS[clip]
    _, _, jg, tg = _case(dtype, n_steps=1)
    want = getattr(jclip, name)(*args, **kw)(jg[0])
    got = getattr(pclip, name)(*args, **kw)(tg[0])
    for k in want:
        assert got[k].dtype == tg[0][k].dtype
        np.testing.assert_allclose(
            got[k].float().numpy(), np.asarray(want[k].astype(jnp.float32)),
            rtol=2e-6 if dtype == jnp.float32 else 2 ** -8, atol=1e-7,
            err_msg=k)
    assert all(torch.equal(tg[0][k], _to_tensor(k, np.asarray(jg[0][k])))
               for k in tg[0])                   # out of place


def test_global_norm_axes_raise():
    """`axes` sums the squared norm over a mesh's ranks: outside an SPMD
    run (`parallel.spmd`, `Trainer(mesh=)`) there are none to meet, and
    the call raises (tests/test_torch_parallel_train.py runs it over
    ranks)."""
    clip = pclip.ClipGradByGlobalNorm(1.0, axes=("dp",))
    with pytest.raises(RuntimeError, match="SPMD run"):
        clip({"w": torch.ones(3)})


def test_clip_and_scheduler_inside_update():
    """The clip runs before the update; the k-th update reads the
    scheduler at step k - 1 (so the first sees value(0) = 0 here and
    leaves the parameters where they are)."""
    def make(m, c):
        return m.Momentum(
            learning_rate=m.lr.LinearWarmup(0.1, 2, 0.0, 0.1),
            momentum=0.9, grad_clip=c.ClipGradByGlobalNorm(1.0))
    jo, to = make(jopt, jclip), make(popt, pclip)
    jp, tp, jg, tg = _case(jnp.float32)
    p0 = {k: v.clone() for k, v in tp.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i, (g_j, g_t) in enumerate(zip(jg, tg)):
        jp, js = jo.update(g_j, js, jp)
        tp, ts = to.update(g_t, ts, tp)
        if i == 0:
            assert all(torch.equal(tp[k], p0[k]) for k in tp)
    _assert_state(jp, js, tp, ts)


# --------------------------------------------------------------------------- #
# the eager surface
# --------------------------------------------------------------------------- #

class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.fc = torch.nn.Parameter(torch.randn(8, 4, generator=gen))
        self.b = torch.nn.Parameter(torch.zeros(4))


def test_eager_bind_step_and_state_dict():
    net = _Net()
    sched = popt.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    o = popt.Adam(learning_rate=sched).bind(net)
    with pytest.raises(ValueError, match="grads"):
        o.step()
    with pytest.raises(RuntimeError, match="LRScheduler"):
        o.set_lr(0.2)
    ref = popt.Adam(learning_rate=popt.lr.StepDecay(0.1, step_size=2,
                                                   gamma=0.5))
    params = {k: p.detach().clone() for k, p in net.named_parameters()}
    st = ref.init(params)
    rng = np.random.RandomState(1)
    grads = [{k: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
              for k, p in net.named_parameters()} for _ in range(4)]
    for g in grads[:2]:
        o.step(g)
        o.clear_grad()
        ref.update(g, st, params)
    for k, p in net.named_parameters():
        assert torch.equal(p.detach(), params[k])
    sd = o.state_dict()
    assert sd["step"] == 2 and set(sd) == {
        "step", "fc.moment1", "fc.moment2", "b.moment1", "b.moment2",
        "LR_Scheduler"}
    assert sd["LR_Scheduler"] == sched.state_dict()
    # a fresh optimizer takes the state and continues identically
    net2 = _Net()
    with torch.no_grad():
        for (_, a), (_, b) in zip(net2.named_parameters(),
                                  net.named_parameters()):
            a.copy_(b)
    o2 = popt.Adam(learning_rate=popt.lr.StepDecay(0.1, step_size=2,
                                                  gamma=0.5)).bind(net2)
    o2.set_state_dict({k: (v.clone() if torch.is_tensor(v) else v)
                       for k, v in sd.items()})
    for g in grads[2:]:
        o.step(g)
        o2.step(g)
    for (_, a), (_, b) in zip(net.named_parameters(),
                              net2.named_parameters()):
        assert torch.equal(a, b)
    plain = popt.SGD(learning_rate=0.5)
    plain.set_lr(0.25)
    assert plain.get_lr() == 0.25 and o.get_lr() == sched()
    with pytest.raises(RuntimeError, match="bind"):
        popt.SGD().step({})


# --------------------------------------------------------------------------- #
# from_jax_train_state for other rules
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def np_params():
    pt.seed(0)
    return {k: np.asarray(v) for k, v in jax_gpt_tiny().raw_parameters()
            .items()}


def _ids():
    return np.random.RandomState(0).randint(0, 1024, (2, 32)).astype(
        np.int32)


RESUME = {"Momentum": dict(learning_rate=0.05, momentum=0.9,
                           use_nesterov=True),
          "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.01)}


@pytest.mark.parametrize("rule", list(RESUME))
def test_from_jax_train_state_resumes_other_rules(rule, np_params):
    """A JAX run stopped after 1 step continues in the port for 2 more:
    the losses match JAX's within 1e-5 relative (fp32)."""
    pt.seed(0)
    jm = jax_gpt_tiny()
    jm.load_raw_parameters({k: jnp.asarray(v) for k, v in np_params.items()})
    jt = JaxTrainer(jm, getattr(jopt, rule)(**RESUME[rule]),
                    lambda lg, y: jm.loss(lg, y), donate=False)
    ids = _ids()
    jt.train_step(ids, ids)
    snap = jax.tree_util.tree_map(np.asarray, jt.state.tree())
    want = [float(jt.train_step(ids, ids)[0]) for _ in range(2)]
    opt = getattr(popt, rule)(**RESUME[rule])
    state = from_jax_train_state(snap, optimizer=opt)
    slot_names = sorted(state.opt_state["slots"]["wte.weight"])
    assert slot_names == sorted(snap["opt_state"]["slots"]["wte.weight"])
    model = load_jax_params(gpt_tiny(seed=1, device="cpu"), np_params)
    tr = Trainer(model, opt, lambda lg, y: model.loss(lg, y))
    tr.load_state(state)
    got = [float(tr.train_step(ids, ids)[0]) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a slot set no rule has is refused, naming the slots
    bad = jax.tree_util.tree_map(lambda x: x, snap)
    bad["opt_state"]["slots"]["wte.weight"]["extra"] = \
        bad["opt_state"]["slots"]["wte.weight"][slot_names[0]]
    with pytest.raises(KeyError, match="extra"):
        from_jax_train_state(bad)
