"""ResNet-18 under AMP O2 (bf16) in the port's Trainer against the JAX
package's: the state's layout exactly, the numbers within what bf16
itself moves them.

Layout, as JAX's: every parameter bf16 except BatchNorm's weight and
bias (`keep_bn_fp32`), which stay fp32 with no master; an fp32
`master_weight` for exactly the bf16 ones; the velocity slots fp32; the
BatchNorm buffers fp32 after the steps.

Numbers. Same weights and batch (8 x 32 x 32, NHWC, `stem_s2d`), 3 steps
of Momentum(1e-3, 0.9). bf16 gradients of this network are far from the
fp32 ones: on this batch each package's bf16 gradient differs from the
fp32 gradient by ~46% (median over tensors; normalising layer4's 1 x 1
planes over 8 samples in bf16 leaves few good bits), and the two
packages' bf16 gradients differ by ~27%, so no elementwise tolerance
holds them. The test holds what bf16 allows instead: the port's bf16
run lies as close to the JAX fp32 run as JAX's own bf16 run does (the
distance of the fp32 masters, as a share of how far the fp32 run moved
them, at most 1.5x JAX's + 0.01), and as close to JAX's bf16 run
(at most 1.5x; seen: JAX bf16 0.59 from fp32, the port 0.62 from fp32
and 0.43 from JAX bf16); the same for the BatchNorm buffers; the
first loss (the bf16 forward) within 2e-2 relative of JAX's (bf16 keeps
8 bits, ~4e-3 per rounding, through 20 layers), and every loss within
twice JAX's own bf16-vs-fp32 gap plus 1e-2 of the first loss.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.models import resnet18 as jax_resnet18
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import resnet18
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from port_resnet import f32, images, jax_model, numpy_tree, port_twin
from port_threads import one_torch_thread  # noqa: F401

KW = dict(num_classes=10, data_format="NHWC", stem_s2d=True)
LR, STEPS = 1e-3, 3


def _jce(o, t):
    return jnn.functional.cross_entropy(o, t)


@pytest.fixture(scope="module")
def runs():
    jm, P, B = jax_model(jax_resnet18, **KW)
    x, y = images(8, 32)
    out = {"P": P, "B": B}
    for name, amp in (("jax32", None), ("jax16", "O2")):
        kw = dict(amp_level="O2", amp_dtype="bfloat16") if amp else {}
        jt = JaxTrainer(jm, jopt.Momentum(LR, 0.9), _jce, donate=False,
                        **kw)
        _, losses = jt.train_steps(x, y, steps=STEPS)
        out[name] = numpy_tree(jt.state.tree())
        out[name + "_losses"] = np.array(losses).astype(np.float32)
    tr = Trainer(port_twin(resnet18, P, B, **KW), Momentum(LR, 0.9),
                 lambda o, t: F.cross_entropy(o, t), amp_level="O2",
                 amp_dtype="bfloat16")
    _, losses = tr.train_steps(x, y, steps=STEPS)
    out["port"], out["port_losses"] = tr.state, f32(losses)
    return out


def _dtype_name(a):
    return "bfloat16" if str(a.dtype) in ("bfloat16", "torch.bfloat16") \
        else str(a.dtype).replace("torch.", "")


def test_o2_state_layout_equals_jax(runs):
    st, j = runs["port"], runs["jax16"]
    assert {k: _dtype_name(v) for k, v in st.params.items()} == \
        {k: _dtype_name(v) for k, v in j["params"].items()}
    bn = {k for k in st.params if ".bn" in k or k.startswith("bn")
          or "downsample.1." in k}
    for k, v in st.params.items():
        assert v.dtype == (torch.float32 if k in bn else torch.bfloat16), k
    slots, jslots = st.opt_state["slots"], j["opt_state"]["slots"]
    assert {k: sorted(s) for k, s in slots.items()} == \
        {k: sorted(s) for k, s in jslots.items()}
    for k, s in slots.items():
        assert ("master_weight" in s) == (k not in bn), k
        assert all(t.dtype == torch.float32 for t in s.values()), k
    assert all(b.dtype == torch.float32 for b in st.buffers.values())


def _masters(state_params, slots):
    return {k: f32(s.get("master_weight", state_params[k]))
            for k, s in slots.items()}


def _dist(a, b, ref, start):
    """||a - b|| over every tensor, over how far `ref` moved from
    `start`."""
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in ref)
    den = sum(float(np.sum((ref[k] - start[k]) ** 2)) for k in ref)
    return (num / den) ** 0.5


def test_master_weights_as_close_to_fp32_as_jax_bf16(runs):
    p0 = {k: v.astype(np.float32) for k, v in runs["P"].items()}
    ref = {k: f32(v) for k, v in runs["jax32"]["params"].items()}
    jax16 = _masters(runs["jax16"]["params"],
                     runs["jax16"]["opt_state"]["slots"])
    port = _masters(runs["port"].params, runs["port"].opt_state["slots"])
    e_jax = _dist(jax16, ref, ref, p0)
    e_port = _dist(port, ref, ref, p0)
    e_pj = _dist(port, jax16, ref, p0)
    assert e_port <= 1.5 * e_jax + 0.01, (e_port, e_jax)
    assert e_pj <= 1.5 * e_jax + 0.01, (e_pj, e_jax)


def test_buffers_as_close_to_fp32_as_jax_bf16(runs):
    b0 = runs["B"]
    ref = {k: f32(v) for k, v in runs["jax32"]["buffers"].items()}
    jax16 = {k: f32(v) for k, v in runs["jax16"]["buffers"].items()}
    port = {k: f32(v) for k, v in runs["port"].buffers.items()}
    e_jax = _dist(jax16, ref, ref, b0)
    assert _dist(port, ref, ref, b0) <= 1.5 * e_jax + 0.01
    assert _dist(port, jax16, ref, b0) <= 1.5 * e_jax + 0.01


def test_losses_within_bf16s_own_gap(runs):
    pl, jl, ref = runs["port_losses"], runs["jax16_losses"], \
        runs["jax32_losses"]
    assert abs(pl[0] - jl[0]) <= 2e-2 * abs(jl[0])
    gap = np.abs(jl - ref).max()
    assert np.abs(pl - jl).max() <= 2 * gap + 1e-2 * abs(ref[0])
    assert np.all(np.isfinite(pl)) and pl[-1] < pl[0]
