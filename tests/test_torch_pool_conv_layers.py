"""The port's pooling layers (1-D, 3-D, adaptive average and max,
`MaxPool2D(return_mask=True)`) and transposed convolution layers
against the JAX package's, on the same seeded numpy inputs.

Each JAX layer runs once per case under `jax.jit`. Max pools and their
masks are held bitwise, on inputs with ties (after a ReLU, half the
entries are 0) and with padding; averages within 2e-6 of the largest
magnitude (fp32 sums in other orders); transposed convolutions within
2e-5, their weights carried from the port (JAX's layout and names);
string padding with groups is left out: JAX's `lax.conv_transpose`
route ignores `groups` there (a reference fault, ROADMAP's caveats).
The adaptive max pools' masks are JAX's zeros, in JAX's dtype (int32:
int64 at x64 off). The refusals are JAX's: `return_mask` for other than
2-D pools and with string padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch import nn as pnn
from port_threads import one_torch_thread  # noqa: F401

# JAX's masks ask for int64 and get int32 (x64 is off)
pytestmark = pytest.mark.filterwarnings("ignore:Explicitly requested dtype")


def _x(shape, seed=0, relu=False):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.maximum(a, 0) if relu else a


def _jax(layer, x):
    out = jax.jit(lambda a: layer(a))(jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, out)


def _port(layer, x):
    with torch.no_grad():
        out = layer(torch.from_numpy(x))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _close(got, want, rel):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


POOLS_1D = [  # (kernel, stride, padding, ceil_mode, exclusive)
    (3, 2, 1, False, True), (2, 2, 0, False, True), (3, 2, 1, True, True),
    (3, 1, 1, False, False), (4, 3, 2, True, False), (3, None, 0, False,
                                                      True)]


@pytest.mark.parametrize("k,s,p,ceil,excl", POOLS_1D)
def test_pool1d_layers_match_jax(k, s, p, ceil, excl):
    x = _x((2, 3, 11), relu=True)
    want = _jax(jnn.AvgPool1D(k, s, p, exclusive=excl, ceil_mode=ceil), x)
    _close(_port(pnn.AvgPool1D(k, s, p, exclusive=excl, ceil_mode=ceil), x),
           want, 2e-6)
    want = _jax(jnn.MaxPool1D(k, s, p, ceil_mode=ceil), x)
    got = _port(pnn.MaxPool1D(k, s, p, ceil_mode=ceil), x)
    np.testing.assert_array_equal(got, want)


POOLS_3D = [  # (kernel, stride, padding, ceil_mode, exclusive, format)
    (2, 2, 0, False, True, "NCDHW"), (3, 2, 1, True, True, "NCDHW"),
    ((2, 3, 1), (1, 2, 1), (1, 1, 0), False, False, "NCDHW"),
    (3, 2, 1, False, True, "NDHWC")]


@pytest.mark.parametrize("k,s,p,ceil,excl,fmt", POOLS_3D)
def test_pool3d_layers_match_jax(k, s, p, ceil, excl, fmt):
    x = _x((2, 3, 5, 6, 7) if fmt == "NCDHW" else (2, 5, 6, 7, 3),
           relu=True)
    want = _jax(jnn.AvgPool3D(k, s, p, ceil_mode=ceil, exclusive=excl,
                              data_format=fmt), x)
    _close(_port(pnn.AvgPool3D(k, s, p, ceil_mode=ceil, exclusive=excl,
                               data_format=fmt), x), want, 2e-6)
    want = _jax(jnn.MaxPool3D(k, s, p, ceil_mode=ceil, data_format=fmt), x)
    got = _port(pnn.MaxPool3D(k, s, p, ceil_mode=ceil, data_format=fmt), x)
    np.testing.assert_array_equal(got, want)


ADAPTIVE = [  # (layer name, input shape, output size)
    ("AdaptiveAvgPool1D", (2, 3, 11), 4), ("AdaptiveAvgPool1D", (2, 3, 12), 4),
    ("AdaptiveAvgPool3D", (1, 2, 5, 6, 7), (2, 3, 4)),
    ("AdaptiveAvgPool3D", (1, 2, 4, 6, 7), (2, None, 3)),
    ("AdaptiveMaxPool1D", (2, 3, 11), 4), ("AdaptiveMaxPool1D", (2, 3, 11), 1),
    ("AdaptiveMaxPool2D", (2, 3, 9, 8), (4, 3)),
    ("AdaptiveMaxPool2D", (2, 3, 9, 8), (3, 4)),
    ("AdaptiveMaxPool3D", (1, 2, 5, 6, 7), (2, 3, 4))]


@pytest.mark.parametrize("name,shape,size", ADAPTIVE)
def test_adaptive_pools_match_jax(name, shape, size):
    x = _x(shape, seed=1, relu=True)
    want = _jax(getattr(jnn, name)(size), x)
    got = _port(getattr(pnn, name)(size), x)
    if "Max" in name:
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want, 2e-6)


@pytest.mark.parametrize("name,shape,size",
                         [a for a in ADAPTIVE if "Max" in a[0]])
def test_adaptive_max_masks_are_jax_zeros(name, shape, size):
    x = _x(shape, seed=2)
    want_out, want_mask = _jax(getattr(jnn, name)(size, return_mask=True), x)
    got_out, got_mask = _port(getattr(pnn, name)(size, return_mask=True), x)
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_mask.dtype == want_mask.dtype == np.int32
    assert not got_mask.any()


MASKS = [  # (kernel, stride, padding, input shape)
    (3, 2, 1, (2, 3, 9, 8)), (2, 2, 0, (2, 3, 8, 8)), (3, 1, 1, (1, 4, 6, 7)),
    ((3, 2), (2, 1), (1, 0), (2, 2, 9, 8)), (2, None, 0, (1, 2, 7, 9)),
    (3, 2, [(1, 0), (0, 1)], (2, 3, 8, 9)), (3, 2, [1, 0, 1, 1], (1, 3, 9, 9))]


@pytest.mark.parametrize("k,s,p,shape", MASKS)
@pytest.mark.parametrize("relu", [True, False])
def test_max_pool2d_return_mask_matches_jax(k, s, p, shape, relu):
    x = _x(shape, seed=3, relu=relu)
    want_out, want_mask = _jax(jnn.MaxPool2D(k, s, p, return_mask=True), x)
    got_out, got_mask = _port(pnn.MaxPool2D(k, s, p, return_mask=True), x)
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_mask.dtype == want_mask.dtype == np.int32
    # every index points at the window's value in the unpadded plane
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    picked = np.take_along_axis(flat, got_mask.reshape(
        *got_mask.shape[:2], -1), axis=2).reshape(got_out.shape)
    np.testing.assert_array_equal(picked, got_out)


def test_return_mask_refusals_are_jax_s():
    cases = [(jnn.MaxPool1D(2, return_mask=True),
              pnn.MaxPool1D(2, return_mask=True), (1, 2, 8)),
             (jnn.MaxPool3D(2, return_mask=True),
              pnn.MaxPool3D(2, return_mask=True), (1, 2, 4, 4, 4)),
             (jnn.MaxPool2D(3, 2, "SAME", return_mask=True),
              pnn.MaxPool2D(3, 2, "SAME", return_mask=True), (1, 2, 6, 6))]
    for jl, pl, shape in cases:
        x = _x(shape)
        with pytest.raises(NotImplementedError) as want:
            jl(jnp.asarray(x))
        with pytest.raises(NotImplementedError) as got:
            pl(torch.from_numpy(x))
        assert str(got.value) == str(want.value)


TRANSPOSE = [  # (nd, cin, cout, k, stride, padding, output_padding,
    #            dilation, groups, bias, format)
    (1, 4, 6, 3, 2, 1, 1, 1, 1, True, "NCL"),
    (1, 4, 6, 4, 1, "SAME", 0, 1, 1, False, "NCL"),
    (2, 4, 6, 3, 2, 1, 1, 1, 2, True, "NCHW"),
    (2, 3, 5, (3, 2), (2, 1), [1, 0], 0, 2, 1, True, "NCHW"),
    (2, 4, 4, 3, 2, "VALID", 0, 1, 1, False, "NHWC"),
    (2, 4, 6, 4, 2, [(1, 2), (0, 1)], 0, 1, 1, True, "NCHW"),
    (3, 2, 4, 3, 2, 1, 1, 1, 2, True, "NCDHW"),
    (3, 2, 3, 2, 1, 0, 0, 1, 1, False, "NDHWC")]


def _transpose_layers(nd, cin, cout, k, stride, padding, opad, dil, groups,
                      bias, fmt):
    kw = dict(stride=stride, padding=padding, output_padding=opad,
              dilation=dil, groups=groups, data_format=fmt)
    if not bias:
        kw["bias_attr"] = False
    name = f"Conv{nd}DTranspose"
    box = {}

    def build():                 # shapes only: no JAX draw is compiled
        box["m"] = getattr(jnn, name)(cin, cout, k, **kw)
        return box["m"].raw_parameters()

    shapes = jax.eval_shape(build)
    port = getattr(pnn, name)(cin, cout, k, **kw)
    return box["m"], shapes, port


@pytest.mark.parametrize("case", TRANSPOSE)
def test_transpose_conv_layers_match_jax(case):
    nd, cin, cout, k, stride, padding, opad, dil, groups, bias, fmt = case
    jl, shapes, pl = _transpose_layers(*case)
    params = {n: p.detach().numpy() for n, p in pl.named_parameters()}
    assert {n: tuple(s.shape) for n, s in shapes.items()} == \
        {n: a.shape for n, a in params.items()}
    assert params["weight"].shape[:2] == (cin, cout // groups)
    spatial = (7, 6, 5)[:nd]
    shape = (2, cin) + spatial if fmt.startswith("NC") else \
        (2,) + spatial + (cin,)
    x = _x(shape, seed=4)
    want = jax.jit(lambda p, a: jax_functional_call(jl, p, a)[0])(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = pl(torch.from_numpy(x), output_size=None)
    _close(got.numpy(), np.asarray(want), 2e-5)


def test_transpose_conv_initializer_draws_from_the_default_generator():
    import paddle_tpu_torch as pt
    pt.seed(11)
    a = pnn.Conv2DTranspose(4, 6, 3, groups=2)
    pt.seed(11)
    b = pnn.Conv2DTranspose(4, 6, 3, groups=2)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    bound = 1 / np.sqrt(4 // 2 * 9)          # fan_in = in / groups * k
    assert float(a.weight.abs().max()) <= bound
    assert pnn.Conv1DTranspose(2, 4, 3, bias_attr=False).bias is None
