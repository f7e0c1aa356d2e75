"""The port's GPT training slice against the JAX package on `gpt_tiny`.

Same weights (the JAX `gpt_tiny` parameters carried over by
`load_jax_params`), same token ids (numpy, seeded) in both packages:
- the training forward's logits, `GPT.loss` (with `ignore_index`
  labels) and every parameter's gradient, fp32;
- one and two AdamW updates, fp32 and multi-precision (bf16 params
  with fp32 masters), with `apply_decay_param_fun`;
- 5-step Trainer lockstep: fp32, AMP O2 in bf16, `grad_accum=2`, and a
  JAX O2 run resumed in the port through `from_jax_train_state`.
On CPU tensors attention runs the plain versions of K2/K3 (the JAX
side runs `_attention_reference`, its CPU dispatch).
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
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import (from_jax_train_state, gpt_tiny,
                                     load_jax_params)
from paddle_tpu_torch.models.weights import _to_tensor
from paddle_tpu_torch.ops_cuda import flash_attention as port_fa
from paddle_tpu_torch.optimizer import AdamW
from port_threads import one_torch_thread  # noqa: F401


LR = 1e-3
STEPS = 5


@pytest.fixture(scope="module")
def jax_model():
    pt.seed(0)
    return jax_gpt_tiny()


@pytest.fixture(scope="module")
def np_params(jax_model):
    return {k: np.asarray(v) for k, v in jax_model.raw_parameters().items()}


def _port_model(np_params):
    return load_jax_params(gpt_tiny(seed=1, device="cpu"), np_params)


def _ids(b=4, s=32, seed=0):
    return np.random.RandomState(seed).randint(0, 1024, (b, s)).astype(
        np.int32)


def _labels(ids):
    labels = ids.copy()
    labels[0, 3:9] = -100                     # ignored positions
    labels[2, -4:] = -100
    return labels


# --------------------------------------------------------------------------- #
# forward, loss and gradients
# --------------------------------------------------------------------------- #

def test_forward_loss_and_grads_match_jax(jax_model, np_params):
    """fp32; logits within 1e-5, loss within 1e-6 relative, each
    gradient within 2e-5 x its largest magnitude: torch and XLA sum in
    different orders through four layers and the tied head (the errors
    seen are below 1e-6 relative; the limits keep a 10x margin)."""
    ids, labels = _ids(), _labels(_ids())
    jparams = jax_model.raw_parameters()

    def jloss(p):
        out, _ = jax_functional_call(jax_model, p, jnp.asarray(ids),
                                     training=True)
        return jax_model.loss(out, jnp.asarray(labels)), out

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)

    model = _port_model(np_params)
    port_fa.FWD_LAUNCHES.reset()
    logits = model(torch.from_numpy(ids).long())
    loss = model.loss(logits, torch.from_numpy(labels).long())
    loss.backward()
    assert port_fa.FWD_LAUNCHES.count == 0            # CPU: plain versions
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    got = dict(model.named_parameters())
    assert set(got) == set(jgrads)
    for k, g in jgrads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(got[k].grad.numpy(), g,
                                   atol=2e-5 * np.abs(g).max(),
                                   rtol=0, err_msg=k)


def test_loss_ignores_labels_and_matches_plain_ce(np_params):
    """The fused CE equals torch's own cross-entropy over the kept
    labels, and its gradient equals autograd's through it."""
    model = _port_model(np_params)
    ids, labels = _ids(), _labels(_ids())
    logits = model(torch.from_numpy(ids).long()).detach().requires_grad_()
    lab = torch.from_numpy(labels).long()
    loss = model.loss(logits, lab)
    ref = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, 1024), lab[:, 1:].reshape(-1),
        ignore_index=-100)
    torch.testing.assert_close(loss, ref, atol=1e-6, rtol=1e-6)
    g, = torch.autograd.grad(loss, logits)
    g_ref, = torch.autograd.grad(ref, logits)
    torch.testing.assert_close(g, g_ref, atol=1e-7, rtol=1e-5)
    all_ignored = torch.full_like(lab, -100)
    assert model.loss(logits, all_ignored).item() == 0.0


def test_bf16_forward_keeps_bf16_logits(np_params):
    model = _port_model(np_params)
    params = {k: (v if ".ln" in k or k.startswith("ln_") else
                  v.detach().bfloat16())
              for k, v in model.named_parameters()}
    logits = torch.func.functional_call(
        model, params, (torch.from_numpy(_ids()).long(),))
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()


def test_dropout_and_sequence_parallel_raise():
    from paddle_tpu_torch.models import GPTConfig
    model = gpt_tiny(seed=0, device="cpu", dropout=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(torch.zeros(1, 8, dtype=torch.long))
    model.eval()                                  # eval: dropout is off
    assert model(torch.zeros(1, 8, dtype=torch.long)).shape == (1, 8, 1024)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPTConfig(sequence_parallel="ring")


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #

def _opt_case(dtype):
    rng = np.random.RandomState(3)
    shapes = {"fc.weight": (8, 16), "fc.bias": (16,), "ln.weight": (16,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    jp = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    tp = {k: _to_tensor(k, np.asarray(v)) for k, v in jp.items()}
    jg = [{k: jnp.asarray(v, dtype) for k, v in g.items()} for g in grads]
    tg = [{k: _to_tensor(k, np.asarray(v)) for k, v in g.items()} for g in jg]
    return jp, tp, jg, tg


@pytest.mark.parametrize("multi_precision", [False, True])
def test_adamw_updates_match_jax(multi_precision):
    """Two updates (bias correction at steps 1 and 2, decay skipped for
    biases). fp32 slots and masters within 1e-6 relative (the same
    rule; XLA and torch may fuse a multiply-add differently); bf16
    params within one bf16 ulp of the JAX cast of the same master."""
    dtype = jnp.bfloat16 if multi_precision else jnp.float32
    decay = lambda name: not name.endswith("bias")      # noqa: E731
    kw = dict(learning_rate=1e-2, weight_decay=0.1,
              apply_decay_param_fun=decay, multi_precision=multi_precision)
    jo, to = jopt.AdamW(**kw), AdamW(**kw)
    jp, tp, jg, tg = _opt_case(dtype)
    js, ts = jo.init(jp), to.init(tp)
    for g_j, g_t in zip(jg, tg):
        jp, js = jo.update(g_j, js, jp)
        tp, ts = to.update(g_t, ts, tp)
    assert ts["step"] == int(js["step"]) == 2
    for k in jp:
        slots = ["moment1", "moment2"] + (["master_weight"]
                                          if multi_precision else [])
        assert sorted(ts["slots"][k]) == sorted(js["slots"][k]) == \
            sorted(slots)
        for sk in slots:
            np.testing.assert_allclose(
                ts["slots"][k][sk].numpy(), np.asarray(js["slots"][k][sk]),
                rtol=1e-6, atol=1e-7, err_msg=f"{k}.{sk}")
        assert tp[k].dtype == (torch.bfloat16 if multi_precision
                               else torch.float32)
        want = np.asarray(jp[k].astype(jnp.float32))
        tol = 2 ** -7 if multi_precision else 1e-6
        np.testing.assert_allclose(tp[k].float().numpy(), want, rtol=tol,
                                   atol=1e-7, err_msg=k)


def test_optimizer_refuses_schedulers_and_clipping():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AdamW(learning_rate=lambda step: 1e-3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AdamW(grad_clip=object())


# --------------------------------------------------------------------------- #
# Trainer lockstep
# --------------------------------------------------------------------------- #

CONFIGS = {"fp32": dict(), "O2": dict(amp_level="O2", amp_dtype="bfloat16"),
           "accum2": dict(grad_accum=2)}
# fp32: float summation order only, compounded over 5 Adam steps (seen:
# 3e-7); O2: bf16 rounds at other places in the two frameworks (GELU,
# the attention softmax, the bf16 matmul outputs), compounded likewise
# (seen: 1.5e-4). Each limit keeps a 10x margin or more.
LOSS_RTOL = {"fp32": 1e-5, "O2": 2e-3, "accum2": 1e-5}
RESUME_AT = 2


def _np_tree(tree):
    """A snapshot of a JAX state tree as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs(np_params):
    """Per config: the JAX Trainer's STEPS losses, and for O2 its state
    after RESUME_AT steps."""
    ids = _ids()
    runs = {}
    for name, kw in CONFIGS.items():
        pt.seed(0)
        m = jax_gpt_tiny()
        m.load_raw_parameters({k: jnp.asarray(v)
                               for k, v in np_params.items()})
        tr = JaxTrainer(m, jopt.AdamW(learning_rate=LR),
                        lambda lg, y, m=m: m.loss(lg, y), donate=False,
                        **kw)
        losses, snap = [], None
        for i in range(STEPS):
            if i == RESUME_AT:
                snap = _np_tree(tr.state.tree())
            loss, _ = tr.train_step(ids, ids)
            losses.append(float(loss))
        runs[name] = (losses, snap)
    return runs


def _port_trainer(np_params, **kw):
    model = _port_model(np_params)
    return Trainer(model, AdamW(learning_rate=LR),
                   lambda lg, y: model.loss(lg, y), **kw)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_trainer_lockstep_with_jax(config, np_params, jax_runs):
    tr = _port_trainer(np_params, **CONFIGS[config])
    ids = _ids()
    losses = [float(tr.train_step(ids, ids)[0]) for _ in range(STEPS)]
    want = jax_runs[config][0]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL[config])
    assert losses[-1] < losses[0]
    if config == "O2":
        st = tr.state
        assert st.params["blocks.0.attn.qkv.weight"].dtype == torch.bfloat16
        assert st.params["blocks.0.ln1.weight"].dtype == torch.float32
        assert "master_weight" in st.opt_state["slots"]["wte.weight"]
        assert "master_weight" not in st.opt_state["slots"]["ln_f.bias"]


def test_train_steps_equals_repeated_train_step(np_params):
    """`train_steps` is the Python loop of `train_step` (and `stacked`
    feeds one slice per step)."""
    ids = _ids()
    a = _port_trainer(np_params)
    one = [float(a.train_step(ids, ids)[0]) for _ in range(3)]
    b = _port_trainer(np_params)
    last, losses = b.train_steps(ids, ids, steps=3)
    assert losses.tolist() == one and float(last) == one[-1]
    c = _port_trainer(np_params)
    stacked = np.stack([ids] * 3)
    _, losses_s = c.train_steps(stacked, stacked, steps=3, stacked=True)
    assert losses_s.tolist() == one


def test_resume_jax_train_state_in_lockstep(np_params, jax_runs):
    """A JAX O2 run stopped after RESUME_AT steps continues in the port
    through `from_jax_train_state`; the remaining steps match JAX's at
    the O2 tolerance."""
    losses_jax, snap = jax_runs["O2"]
    state = from_jax_train_state(snap)
    assert state.step == RESUME_AT and state.opt_state["step"] == RESUME_AT
    assert state.params["wte.weight"].dtype == torch.bfloat16
    tr = _port_trainer(np_params, **CONFIGS["O2"])
    tr.load_state(state)
    ids = _ids()
    losses = [float(tr.train_step(ids, ids)[0])
              for _ in range(STEPS - RESUME_AT)]
    np.testing.assert_allclose(losses, losses_jax[RESUME_AT:],
                               rtol=LOSS_RTOL["O2"])
    assert tr.state.step == STEPS


def test_from_jax_train_state_checks_slots(jax_runs):
    snap = jax_runs["O2"][1]
    bad = jax.tree_util.tree_map(lambda x: x, snap)
    del bad["opt_state"]["slots"]["wte.weight"]["moment2"]
    with pytest.raises(KeyError, match="moment"):
        from_jax_train_state(bad)
    bad = jax.tree_util.tree_map(lambda x: x, snap)
    bad["opt_state"]["slots"]["wpe.weight"]["moment1"] = np.zeros((3, 3))
    with pytest.raises(ValueError, match="shape"):
        from_jax_train_state(bad)


def test_sync_model_writes_masters_back(np_params):
    tr = _port_trainer(np_params, **CONFIGS["O2"])
    ids = _ids()
    tr.train_step(ids, ids)
    model = tr.sync_model()
    master = tr.state.opt_state["slots"]["wte.weight"]["master_weight"]
    torch.testing.assert_close(model.wte.weight.detach(),
                               master.bfloat16().float(), atol=0, rtol=0)
    loss, logits = tr.eval_step(ids, ids)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(loss)


def test_trainer_refuses_what_is_not_ported(np_params):
    for kw in (dict(mesh=object()), dict(remat=True), dict(scaler=object()),
               dict(amp_level="O1"), dict(check_nan_inf=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port_trainer(np_params, **kw)
    with pytest.raises(ValueError, match="loop_unroll"):
        _port_trainer(np_params, loop_unroll=2)
