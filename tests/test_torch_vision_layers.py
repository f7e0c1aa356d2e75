"""The port's convolution, batch-norm, pooling and loss ops and layers
against the JAX package's, on the same numpy inputs (seeded).

Every op is held in fp32 within 2e-5 x the largest magnitude of the
JAX result (torch and XLA sum a window or a reduction in other orders;
the errors seen are below 1e-6 relative), gradients within 1e-4 x the
largest magnitude (a backward sums over more terms). Channels-last
inputs, every padding form of the reference, groups, dilation,
`ceil_mode` and `exclusive` are covered; the initializers are held to
their laws over a large draw (mean within 4 standard errors, std within
2%).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from port_threads import one_torch_thread  # noqa: F401


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, rel=2e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# convolution
# --------------------------------------------------------------------------- #

CONV2D = [
    # (padding, stride, dilation, groups)
    (0, 1, 1, 1), (1, 1, 1, 1), (2, 2, 1, 1), ([1, 2], 1, 1, 1),
    ([1, 0, 2, 1], 2, 1, 1), ([(0, 1), (2, 0)], 1, 1, 1), ("SAME", 2, 1, 1),
    ("VALID", 1, 1, 1), ("SAME", 1, 2, 1), (1, 1, 1, 2), (2, 1, 2, 4),
    ([(2, 1), (2, 1)], 1, 1, 1),
]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("padding,stride,dilation,groups", CONV2D)
def test_conv2d_matches_jax(fmt, padding, stride, dilation, groups):
    cin, cout = 4, 8
    shape = (2, cin, 9, 10) if fmt == "NCHW" else (2, 9, 10, cin)
    x, w, b = _x(shape), _x((cout, cin // groups, 3, 3), 1), _x((cout,), 2)
    want = JF.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                     padding, dilation, groups, data_format=fmt)
    got = F.conv2d(_t(x), _t(w), _t(b), stride, padding, dilation, groups,
                   data_format=fmt)
    _close(got, want)


@pytest.mark.parametrize("fmt", ["NCL", "NLC"])
@pytest.mark.parametrize("padding", [1, "SAME", [(2, 0)]])
def test_conv1d_matches_jax(fmt, padding):
    shape = (2, 4, 11) if fmt == "NCL" else (2, 11, 4)
    x, w = _x(shape), _x((6, 4, 3), 1)
    want = JF.conv1d(jnp.asarray(x), jnp.asarray(w), None, 2, padding,
                     data_format=fmt)
    _close(F.conv1d(_t(x), _t(w), None, 2, padding, data_format=fmt), want)


@pytest.mark.parametrize("fmt", ["NCDHW", "NDHWC"])
def test_conv3d_matches_jax(fmt):
    shape = (1, 3, 5, 6, 7) if fmt == "NCDHW" else (1, 5, 6, 7, 3)
    x, w, b = _x(shape), _x((4, 3, 3, 3, 3), 1), _x((4,), 2)
    want = JF.conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1, 1,
                     data_format=fmt)
    _close(F.conv3d(_t(x), _t(w), _t(b), 1, 1, data_format=fmt), want)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_grads_match_jax(fmt):
    shape = (2, 4, 8, 8) if fmt == "NCHW" else (2, 8, 8, 4)
    x, w = _x(shape), _x((6, 2, 3, 3), 1)
    g = _x((2, 6, 4, 4) if fmt == "NCHW" else (2, 4, 4, 6), 3)

    def jf(x, w):
        return jnp.sum(JF.conv2d(x, w, None, 2, [1, 0, 1, 0], 1, 2,
                                 data_format=fmt) * g)

    jgx, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    (F.conv2d(tx, tw, None, 2, [1, 0, 1, 0], 1, 2, data_format=fmt)
     * _t(g)).sum().backward()
    _close(tx.grad, jgx, 1e-4)
    _close(tw.grad, jgw, 1e-4)


def test_conv2d_channels_last_view_and_o1_cast():
    """NHWC goes to the convolution as a channels-last view (no copy of
    the input); under O1 the operands are cast to the compute dtype."""
    x = _t(_x((2, 8, 8, 4)))
    view = F._channels_first(x, 2)
    assert view.data_ptr() == x.data_ptr()
    assert view.is_contiguous(memory_format=torch.channels_last)
    w = _t(_x((8, 4, 3, 3), 1))
    with amp.auto_cast(True, dtype="bfloat16"):
        out = F.conv2d(x, w, padding=1, data_format="NHWC")
    assert out.dtype == torch.bfloat16 and out.shape == (2, 8, 8, 8)
    with amp.auto_cast(True, dtype="bfloat16", custom_black_list={"conv2d"}):
        assert F.conv2d(x, w, padding=1, data_format="NHWC").dtype \
            == torch.float32


# --------------------------------------------------------------------------- #
# batch norm
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("fmt,shape", [("NCHW", (8, 5, 4, 3)),
                                       ("NHWC", (8, 4, 3, 5)),
                                       ("NCHW", (16, 5))])
@pytest.mark.parametrize("mode", ["train", "eval", "global_stats"])
def test_batch_norm_matches_jax(fmt, shape, mode):
    """(out, new_mean, new_var), with running stats away from the
    batch's (the shift path) and an affine."""
    x = _x(shape, scale=3.0) + 1.5
    rm, rv = _x((5,), 1), np.abs(_x((5,), 2)) + 0.5
    w, b = _x((5,), 3), _x((5,), 4)
    kw = dict(training=mode == "train", momentum=0.9, epsilon=1e-5,
              data_format=fmt,
              use_global_stats=True if mode == "global_stats" else None)
    jo, jm, jv = JF.batch_norm(jnp.asarray(x), jnp.asarray(rm),
                               jnp.asarray(rv), jnp.asarray(w),
                               jnp.asarray(b), **kw)
    po, pm, pv = F.batch_norm(_t(x), _t(rm), _t(rv), _t(w), _t(b), **kw)
    _close(po, jo)
    _close(pm, jm)
    _close(pv, jv)
    if mode != "train":
        assert pm.data_ptr() == _t(rm).data_ptr() or torch.equal(pm, _t(rm))


def test_batch_norm_uses_the_biased_variance_and_keeps_dtypes():
    """The running variance moves by the biased batch variance (torch's
    own batch_norm would use n/(n-1)); bf16 activations normalise in
    bf16 while the statistics stay fp32."""
    x = _x((4, 3, 2, 2))
    rm, rv = torch.zeros(3), torch.ones(3)
    _, nm, nv = F.batch_norm(_t(x), rm, rv, training=True)
    biased = x.transpose(1, 0, 2, 3).reshape(3, -1).var(axis=1)
    np.testing.assert_allclose(nv.numpy(), 0.9 + 0.1 * biased, rtol=1e-6)
    out, nm, nv = F.batch_norm(_t(x).bfloat16(), rm, rv, torch.ones(3),
                               torch.zeros(3), training=True)
    assert out.dtype == torch.bfloat16
    assert nm.dtype == nv.dtype == torch.float32


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_grads_match_jax(fmt):
    shape = (6, 3, 4, 4) if fmt == "NCHW" else (6, 4, 4, 3)
    x, g = _x(shape, scale=2.0), _x(shape, 9)
    rm, rv = _x((3,), 1), np.abs(_x((3,), 2)) + 0.5
    w, b = _x((3,), 3), _x((3,), 4)

    def jf(x, w, b):
        out, _, _ = JF.batch_norm(x, jnp.asarray(rm), jnp.asarray(rv), w, b,
                                  training=True, data_format=fmt)
        return jnp.sum(out * g)

    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b))
    ts = [_t(a).requires_grad_() for a in (x, w, b)]
    out, _, _ = F.batch_norm(ts[0], _t(rm), _t(rv), ts[1], ts[2],
                             training=True, data_format=fmt)
    (out * _t(g)).sum().backward()
    for t, j in zip(ts, jg):
        _close(t.grad, j, 1e-4)


def test_batchnorm_layer_updates_its_buffers_as_jax():
    """Outside the Trainer a BatchNorm in training writes its new stats
    into its buffers (JAX's `_update_buffer`); eval leaves them; names
    are `_mean` / `_variance`; use_global_stats normalises with them."""
    pt.seed(0)
    jbn = jnn.BatchNorm2D(4, data_format="NHWC")
    bn = pnn.BatchNorm2D(4, data_format="NHWC")
    assert [k for k, _ in bn.named_buffers()] == list(jbn.raw_buffers())
    assert [k for k, _ in bn.named_parameters()] == \
        list(jbn.raw_parameters())
    x = _x((8, 3, 3, 4), scale=2.0) + 1.0
    out, upd = jax_functional_call(jbn, jbn.raw_parameters(),
                                   jnp.asarray(x), buffers=jbn.raw_buffers(),
                                   training=True)
    bn.train()
    _close(bn(_t(x)), out)
    for k, v in upd.items():
        _close(dict(bn.named_buffers())[k], v)
    before = {k: v.clone() for k, v in bn.named_buffers()}
    bn.eval()
    bn(_t(x))
    for k, v in bn.named_buffers():
        assert torch.equal(v, before[k])
    g = pnn.BatchNorm2D(4, data_format="NHWC", use_global_stats=True)
    g.train()
    want, _, _ = F.batch_norm(_t(x), g._mean, g._variance, g.weight, g.bias,
                              use_global_stats=True, data_format="NHWC")
    torch.testing.assert_close(g(_t(x)), want, rtol=0, atol=0)
    assert torch.equal(g._mean, torch.zeros(4))


def test_stat_sink_collects_instead_of_writing():
    bn = pnn.BatchNorm2D(3)
    bn.train()
    x = _t(_x((4, 3, 2, 2)))
    with pnn.layers_norm.collect_stats(bn) as sink:
        bn(x)
        bn(x * 2)                              # a recompute: dropped
    assert torch.equal(bn._mean, torch.zeros(3))
    (m, v), = sink.updates.values()
    _, nm, nv = F.batch_norm(x, torch.zeros(3), torch.ones(3),
                             training=True)
    assert torch.equal(m, nm) and torch.equal(v, nv)
    assert bn._stat_sink is None


# --------------------------------------------------------------------------- #
# pooling
# --------------------------------------------------------------------------- #

POOLS = [
    # (kernel, stride, padding, ceil_mode)
    (3, 2, 1, False), (2, 2, 0, False), (3, 2, 1, True), (3, 2, 0, True),
    (2, 1, [1, 0, 0, 1], False), (3, 2, "SAME", False), ((2, 3), (2, 1), 0,
                                                         True),
    (3, 3, "VALID", False), (3, 2, 2, False),
]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kernel,stride,padding,ceil_mode", POOLS)
def test_max_pool2d_matches_jax(fmt, kernel, stride, padding, ceil_mode):
    shape = (2, 3, 9, 8) if fmt == "NCHW" else (2, 9, 8, 3)
    x = _x(shape)
    want = JF.max_pool2d(jnp.asarray(x), kernel, stride, padding,
                         ceil_mode=ceil_mode, data_format=fmt)
    got = F.max_pool2d(_t(x), kernel, stride, padding, ceil_mode,
                       data_format=fmt)
    _close(got, want, 0)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("kernel,stride,padding,ceil_mode", POOLS)
def test_avg_pool2d_matches_jax(fmt, exclusive, kernel, stride, padding,
                                ceil_mode):
    shape = (2, 3, 9, 8) if fmt == "NCHW" else (2, 9, 8, 3)
    x = _x(shape)
    want = JF.avg_pool2d(jnp.asarray(x), kernel, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         data_format=fmt)
    got = F.avg_pool2d(_t(x), kernel, stride, padding, ceil_mode, exclusive,
                       data_format=fmt)
    _close(got, want)


def test_avg_pool2d_divisor_override():
    x = _x((1, 2, 6, 6))
    want = JF.avg_pool2d(jnp.asarray(x), 2, 2, 1, divisor_override=3)
    _close(F.avg_pool2d(_t(x), 2, 2, 1, divisor_override=3), want)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("out_size", [1, 3, (2, 5), (None, 2)])
def test_adaptive_avg_pool2d_matches_jax(fmt, out_size):
    shape = (2, 3, 7, 10) if fmt == "NCHW" else (2, 7, 10, 3)
    x = _x(shape)
    want = JF.adaptive_avg_pool2d(jnp.asarray(x), out_size, data_format=fmt)
    _close(F.adaptive_avg_pool2d(_t(x), out_size, data_format=fmt), want)


def test_pool_grads_match_jax():
    x, g = _x((2, 3, 10, 10)), _x((2, 3, 5, 5), 1)

    def jf(x):
        return jnp.sum((JF.max_pool2d(x, 3, 2, 1)
                        + JF.avg_pool2d(x, 3, 2, 0, ceil_mode=True)) * g)

    jg = jax.grad(jf)(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    ((F.max_pool2d(tx, 3, 2, 1) + F.avg_pool2d(tx, 3, 2, 0, ceil_mode=True))
     * _t(g)).sum().backward()
    _close(tx.grad, jg, 1e-4)


# --------------------------------------------------------------------------- #
# losses and small ops
# --------------------------------------------------------------------------- #

CE = [
    dict(), dict(reduction="sum"), dict(reduction="none"),
    dict(ignore_index=2), dict(weight=True), dict(weight=True,
                                                  reduction="none"),
    dict(weight=True, ignore_index=1), dict(label_smoothing=0.1),
    dict(soft_label=True), dict(soft_label=True, label_smoothing=0.2),
    dict(column=True), dict(use_softmax=False),
]


@pytest.mark.parametrize("opts", CE, ids=lambda o: "-".join(
    f"{k}" for k in o) or "plain")
def test_cross_entropy_matches_jax(opts):
    opts = dict(opts)
    rs = np.random.RandomState(0)
    logits = rs.randn(12, 6).astype(np.float32)
    label = rs.randint(0, 6, (12,))
    if opts.pop("column", False):
        label = label[:, None]
    if opts.get("soft_label"):
        label = rs.dirichlet(np.ones(6), 12).astype(np.float32)
    if not opts.get("use_softmax", True):
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if opts.pop("weight", False):
        opts["weight"] = rs.rand(6).astype(np.float32) + 0.5
    jw = None if "weight" not in opts else jnp.asarray(opts["weight"])
    want = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label),
                            **{**opts, "weight": jw})
    got = F.cross_entropy(_t(logits), _t(label),
                          **{**opts, "weight": None if jw is None
                             else _t(opts["weight"])})
    _close(got, want, 1e-6)
    loss = pnn.CrossEntropyLoss(**{**opts, "weight": None if jw is None
                                   else _t(opts["weight"])})
    _close(loss(_t(logits), _t(label)), want, 1e-6)


def test_cross_entropy_grad_matches_jax():
    rs = np.random.RandomState(1)
    logits = rs.randn(10, 7).astype(np.float32)
    label = rs.randint(0, 7, (10,))
    label[3] = -100
    jg = jax.grad(lambda z: JF.cross_entropy(z, jnp.asarray(label),
                                             label_smoothing=0.1))(
        jnp.asarray(logits))
    t = _t(logits).requires_grad_()
    F.cross_entropy(t, _t(label), label_smoothing=0.1).backward()
    _close(t.grad, jg, 1e-5)


def test_relu_flatten_sequential():
    x = _x((2, 3, 4, 5))
    _close(F.relu(_t(x)), JF.relu(jnp.asarray(x)), 0)
    from paddle_tpu.ops.manipulation import flatten as jflatten
    for a, b in ((0, -1), (1, -1), (1, 2)):
        _close(F.flatten(_t(x), a, b), jflatten(jnp.asarray(x), a, b), 0)
    assert pnn.Flatten()(_t(x)).shape == (2, 60)
    g = torch.Generator().manual_seed(0)
    seq = pnn.Sequential(pnn.Conv2D(3, 4, 3, gen=g), pnn.ReLU(),
                         pnn.Sequential(pnn.BatchNorm2D(4)))
    assert [k for k, _ in seq.named_parameters()] == [
        "0.weight", "0.bias", "2.0.weight", "2.0.bias"]
    assert [k for k, _ in seq.named_buffers()] == ["2.0._mean",
                                                   "2.0._variance"]
    named = pnn.Sequential(("a", pnn.ReLU()), ("b", pnn.Flatten()))
    assert list(dict(named.named_children())) == ["a", "b"]


# --------------------------------------------------------------------------- #
# layers and initializers
# --------------------------------------------------------------------------- #

def test_conv_layers_match_jax_layout_and_forward():
    pt.seed(0)
    g = torch.Generator().manual_seed(0)
    for jcls, pcls, k, shape in ((jnn.Conv2D, pnn.Conv2D, 3, (2, 8, 8, 4)),
                                 (jnn.Conv1D, pnn.Conv1D, 3, (2, 9, 4))):
        fmt = "NHWC" if len(shape) == 4 else "NLC"
        jl = jcls(4, 6, k, stride=2, padding=1, groups=2, data_format=fmt)
        pl = pcls(4, 6, k, stride=2, padding=1, groups=2, data_format=fmt,
                  gen=g)
        jp = jl.raw_parameters()
        assert {k: tuple(v.shape) for k, v in pl.named_parameters()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
        with torch.no_grad():
            for n, p in pl.named_parameters():
                p.copy_(_t(np.asarray(jp[n])))
        x = _x(shape)
        _close(pl(_t(x)), jl(jnp.asarray(x)))
    assert pnn.Conv3D(2, 3, 3, gen=g).weight.shape == (3, 2, 3, 3, 3)
    # no gen: the default generator draws, reproducibly under seed
    from paddle_tpu_torch import core as pcore
    pcore.seed(5)
    w0 = pnn.Conv2D(3, 4, 3).weight
    pcore.seed(5)
    assert torch.equal(pnn.Conv2D(3, 4, 3).weight, w0)
    with pytest.raises(NotImplementedError):
        pnn.Conv2D(3, 4, 3, padding_mode="reflect", gen=g)


def test_conv_default_init_law():
    """Uniform(±1/sqrt(fan_in)) for weight and bias: within the bound,
    mean ~0, std bound/sqrt(3)."""
    g = torch.Generator().manual_seed(1)
    conv = pnn.Conv2D(64, 128, 3, groups=2, gen=g)
    bound = 1 / math.sqrt(32 * 9)
    w = conv.weight.detach()
    assert w.abs().max() <= bound and conv.bias.abs().max() <= bound
    assert abs(w.mean()) < 4 * bound / math.sqrt(3 * w.numel())
    assert abs(w.std() / (bound / math.sqrt(3)) - 1) < 0.02


INITS = [
    (lambda m: m.Normal(0.5, 2.0), 0.5, 2.0),
    (lambda m: m.Uniform(-3.0, 1.0), -1.0, 4 / math.sqrt(12)),
    (lambda m: m.XavierNormal(), 0.0, math.sqrt(2 / (64 * 9 + 32 * 9))),
    (lambda m: m.XavierUniform(gain=2.0), 0.0,
     2 * math.sqrt(6 / (64 * 9 + 32 * 9)) / math.sqrt(3)),
    (lambda m: m.KaimingNormal(), 0.0, math.sqrt(2) / math.sqrt(64 * 9)),
    (lambda m: m.KaimingUniform(nonlinearity="leaky_relu",
                                negative_slope=0.1), 0.0,
     math.sqrt(2 / 1.01) * math.sqrt(3 / (64 * 9)) / math.sqrt(3)),
]


@pytest.mark.parametrize("k", range(len(INITS)))
def test_initializer_laws_match_jax(k):
    """Both packages' draws over a (32, 64, 3, 3) kernel have the law's
    mean and std (4 standard errors; 2%)."""
    make, mean, std = INITS[k]
    shape = (32, 64, 3, 3)
    pt.seed(k)
    for a in (np.asarray(make(JI)(shape)),
              make(I)(shape, torch.Generator().manual_seed(k)).numpy()):
        assert a.shape == shape and a.dtype == np.float32
        assert abs(a.mean() - mean) < 4 * std / math.sqrt(a.size)
        assert abs(a.std() / std - 1) < 0.02


def test_fans_gain_and_constants():
    for shape in [(), (7,), (5, 9), (32, 16, 3, 3), (4, 2, 3, 3, 3)]:
        assert I._fans(shape) == JI._fans(shape)
    for nl, p in [("relu", None), ("tanh", None), ("leaky_relu", 0.2),
                  ("selu", None), ("conv2d", None)]:
        assert I.calculate_gain(nl, p) == JI.calculate_gain(nl, p)
    with pytest.raises(ValueError):
        I.calculate_gain("swish")
    assert torch.equal(I.Constant(2.5)((2, 3)), torch.full((2, 3), 2.5))
    assert I.Ones()((3,), dtype=torch.bfloat16).dtype == torch.bfloat16


def test_linear_initializers_and_gpt_draws_unchanged():
    """Without a std a Linear takes XavierUniform and bias 0 (the JAX
    `Linear`'s); with one it draws N(0, std) exactly as before (the GPT
    path's bits)."""
    g = torch.Generator().manual_seed(3)
    lin = pnn.Linear(2048, 1000, gen=g)
    limit = math.sqrt(6 / 3048)
    assert lin.weight.abs().max() <= limit and torch.equal(
        lin.bias, torch.zeros(1000))
    assert abs(lin.weight.std() / (limit / math.sqrt(3)) - 1) < 0.02
    assert pnn.Linear(4, 5, gen=g, bias=False).bias is None
    custom = pnn.Linear(4, 5, weight_attr=I.Constant(0.5))   # no draw
    assert torch.equal(custom.weight, torch.full((4, 5), 0.5))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    old = torch.empty((16, 32)).normal_(0.0, 0.02, generator=g1)
    new = pnn.Linear(16, 32, 0.02, g2)
    assert torch.equal(new.weight.detach(), old)
    assert torch.equal(new.bias.detach(), torch.zeros(32))


def test_pool_layers():
    x = _t(_x((2, 6, 6, 3)))
    assert pnn.MaxPool2D(3, 2, 1, data_format="NHWC")(x).shape == (2, 3, 3, 3)
    assert pnn.AvgPool2D(2, data_format="NHWC")(x).shape == (2, 3, 3, 3)
    assert pnn.AdaptiveAvgPool2D(1, data_format="NHWC")(x).shape == \
        (2, 1, 1, 3)
    # return_mask is ported: (values, the flat argmax index), NCHW
    out, mask = pnn.MaxPool2D(2, return_mask=True)(x.permute(0, 3, 1, 2))
    assert out.shape == mask.shape == (2, 3, 3, 3)
    assert mask.dtype == torch.int32
