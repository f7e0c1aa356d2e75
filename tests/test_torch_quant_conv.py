"""The port's quantized convolutions against the JAX package's:
`QuantedConv2D` (QAT fake-quant and its straight-through gradient),
`Int8Conv2D` (codes, per-output-channel scales and the exact int32
accumulators, bitwise, for one group and depthwise), and QAT / PTQ
over a small ResNet-like net (stem, two BasicBlocks, one with a 1 x 1
downsample, a depthwise convolution, the fc): both packages swap the
same 7 `Conv2D`s and 1 `Linear`, convert them to `Int8Conv2D` /
`Int8Linear`, and give the same logits (within 1e-5 of the largest:
the activation scales may differ by a few fp32 ulps, ROADMAP's
caveats);
carried into the port, JAX's converted buffers give JAX's logits
within 1e-6.

JAX models are built under `jax.eval_shape` (no draw is compiled) and
take the port's weights; the float and converted forwards run under
`jax.jit`. PTQ's calibration is eager in JAX (its observers read host
floats), on two 4 x 3 x 16 x 16 batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu import quantization as JQ
from paddle_tpu.models.resnet import BasicBlock as JBasicBlock
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.models.resnet import BasicBlock as PBasicBlock
from port_threads import one_torch_thread  # noqa: F401


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _small_resnet(nn, block):
    return nn.Sequential(
        nn.Conv2D(3, 8, 3, padding=1, bias_attr=False), nn.BatchNorm2D(8),
        nn.ReLU(), block(8, 8),
        block(8, 16, stride=2, downsample=nn.Sequential(
            nn.Conv2D(8, 16, 1, stride=2, bias_attr=False),
            nn.BatchNorm2D(16))),
        nn.Conv2D(16, 16, 3, padding=1, groups=16), nn.ReLU(),
        nn.AdaptiveAvgPool2D(1), nn.Flatten(), nn.Linear(16, 10))


def _twins(make_jax, make_port):
    """(JAX module carrying the port's weights, port module), the JAX
    one built under eval_shape."""
    box = {}

    def build():
        box["m"] = make_jax()
        return box["m"].raw_parameters()

    jax.eval_shape(build)
    pm = make_port()
    rs = np.random.RandomState(5)
    with torch.no_grad():
        for k, b in pm.named_buffers():
            b.copy_(torch.from_numpy(
                (rs.rand(*b.shape) + 0.5 if k.endswith("_variance")
                 else rs.randn(*b.shape) * 0.1).astype(np.float32)))
    jm = box["m"]
    jm.load_raw_parameters({k: jnp.asarray(v.detach().numpy())
                            for k, v in pm.named_parameters()})
    jm.load_raw_buffers({k: jnp.asarray(v.numpy())
                         for k, v in pm.named_buffers()})
    return jm, pm


def _net_twins():
    return _twins(lambda: _small_resnet(jnn, JBasicBlock),
                  lambda: _small_resnet(
                      pnn, lambda i, p, **k: PBasicBlock(i, p, None, **k)))


def _kinds(model, names):
    out = {n: 0 for n in names}
    for m in (model.sublayers(include_self=True)
              if hasattr(model, "sublayers") else model.modules()):
        if type(m).__name__ in out:
            out[type(m).__name__] += 1
    return out


KINDS = ("QuantedConv2D", "QuantedLinear", "Int8Conv2D", "Int8Linear",
         "Conv2D", "Linear")


def test_qat_and_ptq_swap_and_convert_convolutions_as_jax():
    """QAT and PTQ swap every Conv2D and Linear, as JAX's `_QAT_MAP`,
    and convert them to Int8Conv2D / Int8Linear; the converted logits
    are JAX's."""
    jm, pm = _net_twins()
    jptq, pptq = JQ.PTQ(), Q.PTQ()
    jptq.quantize(jm)
    pptq.quantize(pm)
    want = _kinds(jm, KINDS)
    assert want["QuantedConv2D"] == 7 and want["QuantedLinear"] == 1
    assert _kinds(pm, KINDS) == want
    batches = [_x((4, 3, 16, 16), seed=s) for s in (1, 2)]
    jptq.sample(jm, batches)
    pptq.sample(pm, batches)
    jptq.convert(jm)
    pptq.convert(pm)
    want = _kinds(jm, KINDS)
    assert want["Int8Conv2D"] == 7 and want["Int8Linear"] == 1
    assert want["Conv2D"] == want["QuantedConv2D"] == 0
    assert _kinds(pm, KINDS) == want
    x = _x((4, 3, 16, 16), seed=3)
    jf = jax.jit(lambda b, a: jax_functional_call(jm, {}, a, buffers=b,
                                                   training=False)[0])
    jbufs = {k: np.asarray(v) for k, v in jm.raw_buffers().items()}
    want = np.asarray(jf(jbufs, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    # codes and weight scales are bitwise; activation scales within a
    # few ulps (each is the observed maximum of a float activation, and
    # the float nets round apart in the last bits)
    pbufs = dict(pm.named_buffers())
    for k, v in jbufs.items():
        if k.endswith(("qweight", "w_scale")):
            np.testing.assert_array_equal(pbufs[k].numpy(), v)
        if k.endswith("act_scale"):
            np.testing.assert_allclose(pbufs[k].numpy(), v, rtol=2e-6)
    # JAX's own buffers in the port: the same function
    pm2 = _small_resnet(pnn, lambda i, p, **k: PBasicBlock(i, p, None, **k))
    load_jax_state(pm2, {k: np.asarray(v)
                         for k, v in jm.raw_parameters().items()}, jbufs)
    assert _kinds(pm2, KINDS) == _kinds(jm, KINDS)
    pm2.eval()
    with torch.no_grad():
        got = pm2(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * scale


def test_qat_quantize_respects_the_layer_types():
    jm, pm = _net_twins()
    cfg = dict(quantizable_layer_type=("Conv2D",))
    JQ.QAT(JQ.QuantConfig(**cfg)).quantize(jm)
    Q.QAT(Q.QuantConfig(**cfg)).quantize(pm)
    assert _kinds(pm, KINDS) == _kinds(jm, KINDS)
    assert _kinds(pm, KINDS)["QuantedLinear"] == 0
    with pytest.raises(ValueError, match="no quantizable"):
        Q.QAT(Q.QuantConfig(quantizable_layer_type=("GRU",))).quantize(pm)


@pytest.mark.parametrize("groups,cin,cout,k,stride,pad,bias", [
    (1, 4, 6, 3, 1, 1, True), (1, 3, 8, 5, 2, 2, False),
    (6, 6, 6, 3, 2, 1, True), (2, 4, 6, 3, 1, (1, 0), True)])
def test_quanted_conv2d_forward_and_straight_through_gradient(
        groups, cin, cout, k, stride, pad, bias):
    kw = dict(stride=stride, padding=pad, groups=groups)
    if not bias:
        kw["bias_attr"] = False
    jl, pl = _twins(lambda: jnn.Conv2D(cin, cout, k, **kw),
                    lambda: pnn.Conv2D(cin, cout, k, **kw))
    jq = JQ.QuantedConv2D(jl, JQ.QuantConfig())
    pq = Q.QuantedConv2D(pl, Q.QuantConfig())
    x = _x((2, cin, 9, 8), seed=4)
    params = {k_: v.detach().numpy() for k_, v in pq.named_parameters()}

    def jloss(p, a):
        out, upd = jax_functional_call(jq, p, a, training=True)
        return jnp.sum(out * out), (out, upd)

    (_, (want, upd)), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    pq.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pq(xt)
    (out * out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(pq._act_scale.numpy(),
                                  np.asarray(upd["_act_scale"]))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=1e-5 * np.abs(gx).max())
    for name, p in pq.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[name]),
                                   rtol=0, atol=1e-5 * np.abs(gp[name]).max())


@pytest.mark.parametrize("groups,cin,cout,k,stride,pad,fmt", [
    (1, 8, 16, 3, 1, 1, "NCHW"), (1, 3, 8, 7, 2, 3, "NCHW"),
    (16, 16, 16, 3, 2, 1, "NCHW"), (1, 8, 12, 3, 2, "SAME", "NHWC"),
    (8, 8, 8, 5, 1, 2, "NHWC")])
def test_int8_conv2d_codes_scales_and_accumulators_are_jax_s(
        groups, cin, cout, k, stride, pad, fmt):
    jl, pl = _twins(lambda: jnn.Conv2D(cin, cout, k, stride=stride,
                                       padding=pad, groups=groups,
                                       data_format=fmt),
                    lambda: pnn.Conv2D(cin, cout, k, stride=stride,
                                       padding=pad, groups=groups,
                                       data_format=fmt))
    shape = (2, cin, 11, 10) if fmt == "NCHW" else (2, 11, 10, cin)
    cal = _x(shape, seed=6, scale=2.0)
    jptq, pptq = JQ.PTQ(), Q.PTQ()
    jm, pm = jnn.Sequential(jl), pnn.Sequential(pl)
    jptq.quantize(jm)
    pptq.quantize(pm)
    jptq.sample(jm, [cal])
    pptq.sample(pm, [cal])
    jptq.convert(jm)
    pptq.convert(pm)
    ji, pi = jm[0], pm[0]
    assert isinstance(pi, Q.Int8Conv2D)
    for name in ("qweight", "w_scale", "act_scale", "bias"):
        np.testing.assert_array_equal(getattr(pi, name).numpy(),
                                      np.asarray(ji._buffers[name]))
    assert pi.qweight.dtype == torch.int8
    x = _x(shape, seed=7, scale=2.0)
    qx = JQ.quantize_tensor(jnp.asarray(x), ji._buffers["act_scale"])
    want = JF.conv2d(qx, ji._buffers["qweight"], None, stride=stride,
                     padding=pad, groups=groups, data_format=fmt,
                     preferred_element_type=jnp.int32)
    got = pi.int32_acc(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_out = np.asarray(jax.jit(lambda a: ji(a))(jnp.asarray(x)))
    with torch.no_grad():
        out = pi(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want_out, rtol=0,
                               atol=1e-6 * np.abs(want_out).max())


def test_int8_conv2d_is_exact_at_large_k():
    """K = 256 · 3 · 3 = 2304 > 1040, where an fp32 convolution of the
    codes would round: both routes give the int64 sums exactly."""
    rs = np.random.RandomState(8)
    qx = rs.randint(-127, 128, (1, 256, 5, 5)).astype(np.int8)
    qw = rs.randint(-127, 128, (4, 256, 3, 3)).astype(np.int8)
    for groups in (1, 2):
        w = qw[:, :256 // groups]
        got = Q.int8_conv2d(torch.from_numpy(qx), torch.from_numpy(w),
                            groups=groups).numpy()
        cg, og = 256 // groups, 4 // groups
        for i in range(3):
            for j in range(3):
                patch = qx[0, :, i:i + 3, j:j + 3].astype(np.int64)
                for o in range(4):
                    g = o // og
                    want = int((patch[g * cg:(g + 1) * cg]
                                * w[o].astype(np.int64)).sum())
                    assert int(got[0, o, i, j]) == want


def _port_resnet():
    return _small_resnet(pnn, lambda i, p, **k: PBasicBlock(i, p, None, **k))


@pytest.fixture(scope="module")
def converted_state():
    """A converted port net's (parameters, buffers) as numpy: the names
    and layouts of a converted JAX net's."""
    pm = _port_resnet()
    ptq = Q.PTQ()
    ptq.quantize(pm)
    ptq.sample(pm, [_x((2, 3, 16, 16), seed=1)])
    ptq.convert(pm)
    return ({k: v.detach().numpy() for k, v in pm.named_parameters()},
            {k: v.numpy() for k, v in pm.named_buffers()})


def _spoil(case, params, bufs):
    if case == "qweight shape":        # the stem's, transposed
        bufs["0.qweight"] = bufs["0.qweight"].transpose(1, 0, 2, 3).copy()
    elif case == "w_scale shape":
        bufs["5.w_scale"] = bufs["5.w_scale"][:8]
    elif case == "act_scale missing":
        del bufs["5.act_scale"]
    elif case == "qweight dtype":
        bufs["0.qweight"] = bufs["0.qweight"].astype(np.int16)
    elif case == "qweight at a BatchNorm":
        bufs["1.qweight"] = bufs["0.qweight"]
    elif case == "unexpected parameter":
        params["0.weight"] = np.zeros((8, 3, 3, 3), np.float32)
    return {"qweight shape": ValueError, "w_scale shape": ValueError,
            "qweight dtype": TypeError}.get(case, KeyError)


@pytest.mark.parametrize("case", [
    "qweight shape", "w_scale shape", "act_scale missing", "qweight dtype",
    "qweight at a BatchNorm", "unexpected parameter"])
def test_load_jax_state_checks_int8_buffers_before_any_swap(
        case, converted_state):
    """A converted net's buffers that do not fit the model raise before
    any layer is swapped or any value copied; once they fit, every
    Conv2D and the Linear become int8 layers with those buffers."""
    params, bufs = (dict(d) for d in converted_state)
    error = _spoil(case, params, bufs)
    pm = _port_resnet()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    kinds = _kinds(pm, KINDS)
    with pytest.raises(error):
        load_jax_state(pm, params, bufs)
    assert _kinds(pm, KINDS) == kinds
    after = pm.state_dict()
    assert set(after) == set(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    params, bufs = converted_state
    load_jax_state(pm, params, bufs)
    assert _kinds(pm, KINDS) == dict(kinds, Conv2D=0, Linear=0,
                                     Int8Conv2D=7, Int8Linear=1)
    got = dict(pm.named_buffers())
    for k, v in bufs.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
