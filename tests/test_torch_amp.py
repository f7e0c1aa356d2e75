"""The port's AMP (`paddle_tpu_torch/amp`) and the Trainer's scaler, O1
and `check_nan_inf` against the JAX package.

- `GradScaler`'s pure state machine, step for step with JAX's over a
  seeded sequence of clean and overflowing steps, and `unscale` on
  fp32, bf16 and fp16 gradients;
- the O1 policy: only `linear` consults the white list;
- 5-step Trainer lockstep on `gpt_tiny` (the JAX weights carried over,
  the same token ids): a GradScaler on fp32, O1 in bf16, O2 in fp16
  with a GradScaler, and AdamW under LinearWarmup(CosineAnnealingDecay)
  with ClipGradByGlobalNorm. On the CPU both sides attend with plain
  functions (the port's plain K2/K3, JAX's `_attention_reference`);
- an overflowing step rejected: parameters, slots and the optimizer's
  step unchanged, the scale halved;
- `check_nan_inf` raising with the offenders' names, read from the
  flags at every step, and quiet on a scaler's overflow.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import utils_clip as jclip
from paddle_tpu_torch import amp, core
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.nn import clip as pclip
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Linear
from port_threads import one_torch_thread  # noqa: F401

STEPS = 5


# --------------------------------------------------------------------------- #
# GradScaler
# --------------------------------------------------------------------------- #

def test_grad_scaler_state_machine_matches_jax():
    kw = dict(init_loss_scaling=16.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    js, ps = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    jst, pst = js.init(), ps.init("cpu")
    flags = np.random.RandomState(0).rand(40) < 0.3
    flags[[1, 2]] = True                       # two in a row: a decrease
    for f in flags:
        jst = js.update(jst, jnp.asarray(f))
        pst = ps.update(pst, torch.tensor(bool(f)))
        for k in ("scale", "good_steps", "bad_steps"):
            assert pst[k].item() == np.asarray(jst[k]).item(), k
    assert pst["scale"].dtype == torch.float32
    assert pst["good_steps"].dtype == torch.int32
    # the floor of 1 and a fixed scale
    low = amp.GradScaler(init_loss_scaling=1.0, decr_every_n_nan_or_inf=1)
    st = low.update(low.init("cpu"), torch.tensor(True))
    assert st["scale"].item() == 1.0
    fixed = amp.GradScaler(use_dynamic_loss_scaling=False)
    st = fixed.init("cpu")
    assert fixed.update(st, torch.tensor(True)) is st


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_unscale_matches_jax(dtype):
    rng = np.random.RandomState(1)
    g = {"a": rng.randn(5, 3).astype(np.float32) * 1000,
         "b": rng.randn(7).astype(np.float32)}
    jg = {k: jnp.asarray(v, dtype) for k, v in g.items()}
    pg = {k: torch.tensor(np.asarray(jg[k].astype(jnp.float32))).to(
        getattr(torch, dtype)) for k in g}
    js, ps = jamp.GradScaler(init_loss_scaling=1000.0), \
        amp.GradScaler(init_loss_scaling=1000.0)
    jst, pst = js.init(), ps.init("cpu")
    ju, jf = js.unscale(jg, jst)
    pu, pf = ps.unscale(pg, pst)
    assert bool(pf) is bool(jf) is False
    for k in g:
        assert pu[k].dtype == pg[k].dtype
        np.testing.assert_array_equal(pu[k].float().numpy(),
                                      np.asarray(ju[k].astype(jnp.float32)))
    pg["b"][3] = float("nan")
    assert bool(ps.unscale(pg, pst)[1])
    assert ps.scale_loss(torch.tensor(2.0), pst).item() == 2000.0


def test_eager_scaler_skips_an_overflowing_step():
    net = torch.nn.Module()
    net.w = torch.nn.Parameter(torch.ones(3))
    o = popt.SGD(learning_rate=0.5).bind(net)
    s = amp.GradScaler(init_loss_scaling=4.0, decr_every_n_nan_or_inf=1)
    loss = s.scale(torch.tensor(1.0))
    assert loss.item() == 4.0 and s.get_loss_scaling() == 4.0
    s.step(o, {"w": torch.full((3,), 8.0)})
    assert torch.equal(net.w.detach(), torch.full((3,), 0.0))   # 1 - .5*2
    s.step(o, {"w": torch.tensor([float("inf"), 1.0, 1.0])})
    assert torch.equal(net.w.detach(), torch.zeros(3))          # skipped
    assert s.get_loss_scaling() == 2.0
    sd = s.state_dict()
    s2 = amp.GradScaler()
    s2.load_state_dict(sd)
    assert s2.get_loss_scaling() == 2.0


def test_o1_policy_casts_only_linear():
    x = torch.randn(2, 4)
    w = torch.randn(4, 3)
    with amp.auto_cast(True, dtype="float16"):
        assert amp.get_autocast_dtype("linear") == torch.float16
        assert F.linear(x, w, torch.zeros(3)).dtype == torch.float16
        # layer_norm stays in the input dtype (not torch.autocast's list)
        assert F.layer_norm(x, 4).dtype == torch.float32
        assert amp.white_op_hint(torch.arange(3), op="linear")[0].dtype \
            == torch.int64
    with amp.auto_cast(True, custom_black_list={"linear"}):
        assert F.linear(x, w).dtype == torch.float32
    assert amp.get_autocast_dtype("linear") is None
    assert F.linear(x, w).dtype == torch.float32


def test_decorate_o2():
    m = torch.nn.Linear(3, 3)
    o = popt.AdamW()
    m2, o2 = amp.decorate(m, o, level="O2", dtype="float16")
    assert m2 is m and o2 is o and o.multi_precision
    assert m.weight.dtype == torch.float16
    assert amp.decorate(m, level="O1") is m


# --------------------------------------------------------------------------- #
# Trainer lockstep
# --------------------------------------------------------------------------- #

def _sched(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(1e-3, T_max=10),
                          warmup_steps=2, start_lr=0.0, end_lr=1e-3)


def _config(name, jax_side):
    """(optimizer, trainer kwargs) of a lockstep config on one side."""
    o, a, c = (jopt, jamp, jclip) if jax_side else (popt, amp, pclip)
    if name == "scaler_fp32":
        return o.AdamW(learning_rate=1e-3), dict(scaler=a.GradScaler())
    if name == "O1_bf16":
        return o.AdamW(learning_rate=1e-3), dict(amp_level="O1",
                                                 amp_dtype="bfloat16")
    if name == "O2_fp16_scaler":
        return o.AdamW(learning_rate=1e-3), dict(
            amp_level="O2", amp_dtype="float16",
            scaler=a.GradScaler(init_loss_scaling=2.0 ** 12))
    return o.AdamW(learning_rate=_sched(o.lr),
                   grad_clip=c.ClipGradByGlobalNorm(1.0)), {}


CONFIGS = ["scaler_fp32", "O1_bf16", "O2_fp16_scaler", "sched_clip"]
# fp32 configs: summation order only (seen: 6e-7); O1 bf16 rounds at
# other places in the two frameworks, as O2 bf16 does (seen: 1.6e-4);
# fp16 has three more mantissa bits than bf16 (seen: 6e-5). Each limit
# keeps a 10x margin or more.
LOSS_RTOL = {"scaler_fp32": 1e-5, "O1_bf16": 2e-3,
             "O2_fp16_scaler": 1e-3, "sched_clip": 1e-5}


@pytest.fixture(scope="module")
def np_params():
    pt.seed(0)
    return {k: np.asarray(v) for k, v in jax_gpt_tiny().raw_parameters()
            .items()}


def _ids():
    return np.random.RandomState(0).randint(0, 1024, (4, 32)).astype(
        np.int32)


@pytest.mark.parametrize("config", CONFIGS)
def test_trainer_lockstep_with_jax(config, np_params):
    ids = _ids()
    pt.seed(0)
    jm = jax_gpt_tiny()
    jm.load_raw_parameters({k: jnp.asarray(v) for k, v in np_params.items()})
    jo, jkw = _config(config, True)
    jt = JaxTrainer(jm, jo, lambda lg, y: jm.loss(lg, y), donate=False,
                    **jkw)
    want = [float(jt.train_step(ids, ids)[0]) for _ in range(STEPS)]
    model = load_jax_params(gpt_tiny(seed=1, device="cpu"), np_params)
    po, pkw = _config(config, False)
    tr = Trainer(model, po, lambda lg, y: model.loss(lg, y), **pkw)
    got = [float(tr.train_step(ids, ids)[0]) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL[config])
    assert got[-1] < got[0]
    assert tr.state.opt_state["step"] == int(jt.state.opt_state["step"])
    if "scaler" in pkw:
        for k in ("scale", "good_steps", "bad_steps"):
            assert tr.state.scaler_state[k].item() == \
                np.asarray(jt.state.scaler_state[k]).item()
    if config == "O1_bf16":
        assert all(v.dtype == torch.float32
                   for v in tr.state.params.values())
    if config == "O2_fp16_scaler":
        assert tr.state.params["blocks.0.attn.qkv.weight"].dtype == \
            torch.float16


def test_keep_bn_fp32_off_casts_norms(np_params):
    model = load_jax_params(gpt_tiny(seed=1, device="cpu"), np_params)
    tr = Trainer(model, popt.AdamW(), lambda lg, y: model.loss(lg, y),
                 amp_level="O2", keep_bn_fp32=False)
    st = tr.init_state()
    assert st.params["ln_f.weight"].dtype == torch.bfloat16
    assert "master_weight" in st.opt_state["slots"]["ln_f.weight"]


# --------------------------------------------------------------------------- #
# overflow, check_nan_inf
# --------------------------------------------------------------------------- #

def _small(opt, **kw):
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(Linear(8, 4, 0.1, gen))
    return Trainer(model, opt, lambda o, t: torch.nn.functional.cross_entropy(
        o, t), **kw)


def _xy(scale=1.0, nan=False):
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32) * scale
    if nan:
        x[1, 2] = np.nan
    return x, np.array([1, 2, 3, 0], np.int64)


def test_overflowing_step_is_rejected():
    tr = _small(popt.AdamW(learning_rate=0.1),
                scaler=amp.GradScaler(init_loss_scaling=2.0 ** 100,
                                      decr_every_n_nan_or_inf=1))
    st = tr.init_state()
    tr.train_step(*_xy())                    # a clean step first
    before = {k: v.detach().clone() for k, v in st.params.items()}
    slots = {k: {s: t.clone() for s, t in v.items()}
             for k, v in tr.state.opt_state["slots"].items()}
    step = tr.state.opt_state["step"]
    scale = tr.state.scaler_state["scale"].item()
    tr.train_step(*_xy(1e20))                # scaled gradients overflow
    for k, v in tr.state.params.items():
        assert torch.equal(v.detach(), before[k]), k
        for s, t in tr.state.opt_state["slots"][k].items():
            assert torch.equal(t, slots[k][s]), (k, s)
    assert tr.state.opt_state["step"] == step
    assert tr.state.scaler_state["scale"].item() == scale / 2
    assert tr.state.step == 2


def test_check_nan_inf_names_offenders_and_reads_the_flag():
    tr = _small(popt.SGD(learning_rate=0.1))
    tr.train_step(*_xy(nan=True))            # flag off: no check
    core.set_flags({"check_nan_inf": True})
    try:
        tr2 = _small(popt.SGD(learning_rate=0.1))
        tr2.train_step(*_xy())
        w = tr2.state.params["0.weight"].detach().clone()
        with pytest.raises(FloatingPointError,
                           match=r"step 1 in: loss, grad:0\.weight"):
            tr2.train_step(*_xy(nan=True))
        assert torch.equal(tr2.state.params["0.weight"].detach(), w)
        # a scaler's overflow is its routine path, not a numerics fault
        tr3 = _small(popt.SGD(learning_rate=0.1),
                     scaler=amp.GradScaler(init_loss_scaling=2.0 ** 60))
        tr3.train_step(*_xy(1e20))
        assert torch.isfinite(tr3.state.params["0.weight"]).all()
        # under a scaler any non-finite gradient is found_inf: rejected,
        # and the check stays quiet (as JAX's flags | found_inf)
        w = tr3.state.params["0.weight"].detach().clone()
        tr3.train_step(*_xy(nan=True))
        assert torch.equal(tr3.state.params["0.weight"].detach(), w)
    finally:
        core.set_flags({"check_nan_inf": False})
    with pytest.raises(KeyError, match="check_nan_inf"):
        core.set_flags({"no_such_flag": True})
    assert core.get_flags("check_nan_inf") == {"check_nan_inf": False}
