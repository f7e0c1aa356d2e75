"""The port's LR schedulers (`paddle_tpu_torch/optimizer/lr.py`) against
the JAX package's (`paddle_tpu/optimizer/lr.py`).

Every scheduler's `value(step)` for steps 0..40, in fp32 on both sides,
within 1 fp32 ulp (jnp and numpy evaluate exp, cos and pow with
different fp32 approximations; the rest of the arithmetic is the same
fp32 operations in the same order). The stateful interface: `step()`,
`get_lr()` and `__call__` over 12 epochs, ReduceOnPlateau's eager
`step(metrics)` over a metric sequence, and the `state_dict` round
trip.
"""
import math

import jax.numpy as jnp  # noqa: F401  (JAX runs on the CPU here)
import numpy as np
import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as plr
from port_threads import one_torch_thread  # noqa: F401

STEPS = range(41)

# (name, args, kwargs): each class of the JAX module with the knobs that
# pick its branches
CASES = [
    ("LRScheduler", (0.1,), {}),
    ("ConstantLR", (0.05,), {}),
    ("NoamDecay", (512, 8), dict(learning_rate=2.0)),
    ("PiecewiseDecay", ([3, 10, 25], [0.1, 0.05, 0.01, 0.001]), {}),
    ("NaturalExpDecay", (0.1, 0.07), {}),
    ("InverseTimeDecay", (0.1, 0.3), {}),
    ("PolynomialDecay", (0.1, 17), dict(end_lr=0.001, power=2.0)),
    ("PolynomialDecay", (0.1, 7), dict(end_lr=0.001, power=0.5,
                                       cycle=True)),
    ("LinearWarmup", (0.1, 6, 0.0, 0.1), {}),
    ("ExponentialDecay", (0.1, 0.93), {}),
    ("MultiStepDecay", (0.1, [4, 9, 30]), dict(gamma=0.3)),
    ("StepDecay", (0.1, 7), dict(gamma=0.5)),
    ("LambdaDecay", (0.1, lambda s: 0.95 ** s), {}),
    ("CosineAnnealingDecay", (0.1, 30), dict(eta_min=0.001)),
    ("OneCycleLR", (0.1, 40), {}),
    ("OneCycleLR", (0.1, 33), dict(anneal_strategy="linear",
                                   phase_pct=0.25)),
    ("CyclicLR", (0.01, 0.1), dict(step_size_up=5, step_size_down=7)),
    ("CyclicLR", (0.01, 0.1), dict(step_size_up=4, mode="triangular2")),
    ("CyclicLR", (0.01, 0.1), dict(step_size_up=4, mode="exp_range",
                                   exp_gamma=0.97)),
    ("CosineAnnealingWarmRestarts", (0.1, 7), dict(eta_min=0.002)),
    ("CosineAnnealingWarmRestarts", (0.1, 3), dict(T_mult=2)),
    ("CosineWarmup", (0.1, 5, 35), dict(min_lr=0.001)),
]


def _ids(cases):
    return [f"{name}-{i}" for i, (name, _, _) in enumerate(cases)]


@pytest.mark.parametrize("name,args,kw", CASES, ids=_ids(CASES))
def test_value_matches_jax_within_one_ulp(name, args, kw):
    j, p = getattr(jlr, name)(*args, **kw), getattr(plr, name)(*args, **kw)
    want = np.array([np.asarray(j.value(s), np.float32) for s in STEPS])
    got = np.array([p.value(s) for s in STEPS])
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_linear_warmup_over_cosine_matches_jax():
    """The fine-tune example's schedule: LinearWarmup(CosineAnnealingDecay)
    (the inner schedule runs from step 0 after the warm-up)."""
    def make(m):
        return m.LinearWarmup(m.CosineAnnealingDecay(5e-5, T_max=30),
                              warmup_steps=4, start_lr=0.0, end_lr=5e-5)
    j, p = make(jlr), make(plr)
    want = np.array([np.asarray(j.value(s), np.float32) for s in STEPS])
    got = np.array([p.value(s) for s in STEPS])
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert got[0] == 0.0 and got[4] == np.float32(5e-5)


@pytest.mark.parametrize("name,args,kw", CASES[:14], ids=_ids(CASES[:14]))
def test_stateful_stepping_matches_jax(name, args, kw):
    j, p = getattr(jlr, name)(*args, **kw), getattr(plr, name)(*args, **kw)
    for _ in range(12):
        assert math.isclose(p(), j(), rel_tol=2 ** -23, abs_tol=0)
        assert math.isclose(p.get_lr(), j.get_lr(), rel_tol=2 ** -23)
        j.step()
        p.step()
    assert p.last_epoch == j.last_epoch == 12


def test_multiplicative_decay_is_eager():
    j = jlr.MultiplicativeDecay(0.1, lambda e: 0.9)
    p = plr.MultiplicativeDecay(0.1, lambda e: 0.9)
    for _ in range(6):
        j.step()
        p.step()
        assert p() == j() and p.value(100) == np.float32(j())


def test_reduce_on_plateau_steps_eagerly():
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.91, 0.92, 0.93, 0.5, 0.6,
               0.61, 0.62, 0.63, 0.64]
    for kw in (dict(patience=2), dict(patience=1, cooldown=2,
                                      threshold_mode="abs", threshold=0.05),
               dict(mode="max", patience=1, factor=0.5, min_lr=0.02)):
        j, p = jlr.ReduceOnPlateau(0.1, **kw), plr.ReduceOnPlateau(0.1, **kw)
        trace_j, trace_p = [], []
        for m in metrics:
            j.step(m)
            p.step(np.float32(m))
            trace_j.append(j())
            trace_p.append(p())
        assert trace_p == trace_j
        assert p.value(0) == np.float32(trace_j[-1])
        p.step(None)                          # no metric: no step
        assert p.last_epoch == j.last_epoch == len(metrics)
    assert len(set(trace_p)) > 1              # the LR did move


@pytest.mark.parametrize("name,args,kw", [CASES[13], CASES[8], CASES[20]],
                         ids=_ids([CASES[13], CASES[8], CASES[20]]))
def test_state_dict_round_trip(name, args, kw):
    a = getattr(plr, name)(*args, **kw)
    for _ in range(7):
        a.step()
    sd = a.state_dict()
    assert sd == {"last_epoch": 7, "last_lr": a()}
    b = getattr(plr, name)(*args, **kw)
    b.set_state_dict(sd)
    for _ in range(5):
        a.step()
        b.step()
        assert a() == b()
    j = getattr(jlr, name)(*args, **kw)
    j.set_state_dict(sd)
    j.step()
    c = getattr(plr, name)(*args, **kw)
    c.set_state_dict(sd)
    c.step()
    assert math.isclose(c(), j(), rel_tol=2 ** -23)
