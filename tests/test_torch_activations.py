"""The port's activations, containers and `Embedding(padding_idx=)`
against the JAX package's.

- Every activation function of `paddle_tpu/nn/functional.py:71-200` on
  the same seeded fp32 input (values spread over [-8, 8] and the
  thresholds' edges), with non-default arguments where it takes them:
  within 1e-6 absolute + 1e-6 relative (the same formulas; the two
  libraries' exp / log / tanh differ in the last ulp). `softmax` and
  `log_softmax` with `dtype=` also in bf16 (the cast first): within
  bf16's rounding, 1e-2. Each activation layer of the `_act_layer`
  family the same way, constructed with the same arguments.
- `rrelu` in eval (the mean slope) exactly; in training its slopes lie
  in [lower, upper) and repeat under one key. `gumbel_softmax` rows
  sum to 1 and `hard` ones are one-hot (the draws are torch's, so
  they equal JAX's in law only).
- `embedding` with `padding_idx` bitwise; the `Embedding` layer zeroes
  its padding row and passes it no gradient.
- The containers name their children as JAX's do, so a model built of
  them has the JAX `raw_parameters()` keys; `LayerList`'s append,
  insert and slicing, `LayerDict`, `ParameterList`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import rng
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def x():
    rs = np.random.RandomState(0)
    a = rs.uniform(-8, 8, (4, 6, 10)).astype(np.float32)
    # the thresholds' edges: 0, +-0.5, +-1, +-3, +-6, 20
    a.flat[:12] = [0.0, 0.5, -0.5, 1.0, -1.0, 3.0, -3.0, 6.0, -6.0, 20.0,
                   1e-7, -1e-7]
    return a


# (name, args, kwargs)
ACTIVATIONS = [
    ("relu", (), {}), ("relu6", (), {}), ("leaky_relu", (0.2,), {}),
    ("elu", (0.7,), {}), ("selu", (), {}), ("celu", (1.3,), {}),
    ("gelu", (), {}), ("gelu", (True,), {}), ("silu", (), {}),
    ("swish", (), {}), ("mish", (), {}), ("sigmoid", (), {}),
    ("log_sigmoid", (), {}), ("hardsigmoid", (), {}),
    ("hardsigmoid", (0.2, 0.4), {}), ("hardswish", (), {}),
    ("hardtanh", (-2.0, 3.0), {}), ("hardshrink", (0.6,), {}),
    ("softshrink", (0.4,), {}), ("tanhshrink", (), {}),
    ("softplus", (), {}), ("softplus", (2.0, 5.0), {}),
    ("softsign", (), {}), ("tanh", (), {}), ("glu", (), {"axis": -1}),
    ("glu", (), {"axis": 1}), ("maxout", (2,), {"axis": 1}),
    ("maxout", (5,), {"axis": 2}), ("softmax", (), {"axis": -1}),
    ("softmax", (), {"axis": 1}), ("log_softmax", (), {"axis": -1}),
    ("temperature_softmax", (0.5,), {}),
]


def _ids(cases):
    return [f"{n}{a}{k}" for n, a, k in cases]


@pytest.mark.parametrize("name,args,kwargs", ACTIVATIONS,
                         ids=_ids(ACTIVATIONS))
def test_activation_matches_jax(x, name, args, kwargs):
    want = np.asarray(getattr(jF, name)(jnp.asarray(x), *args, **kwargs))
    got = getattr(F, name)(torch.from_numpy(x), *args, **kwargs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["softmax", "log_softmax"])
def test_softmax_dtype(x, name):
    """`dtype=` casts first: bf16 in, fp32 out, and fp32 in, bf16 out."""
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = getattr(F, name)(xb, axis=-1, dtype="float32")
    assert got.dtype == torch.float32
    want = np.asarray(getattr(jF, name)(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), axis=-1,
        dtype="float32"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    half = getattr(F, name)(torch.from_numpy(x), axis=-1, dtype="bfloat16")
    assert half.dtype == torch.bfloat16
    want = np.asarray(getattr(jF, name)(jnp.asarray(x), axis=-1,
                                        dtype="bfloat16")).astype(np.float32)
    np.testing.assert_allclose(half.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("per_channel", [False, True])
def test_prelu(x, per_channel):
    w = np.linspace(0.1, 0.6, 6 if per_channel else 1).astype(np.float32)
    want = np.asarray(jF.prelu(jnp.asarray(x), jnp.asarray(w)))
    got = F.prelu(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    layer = nn.PReLU(6 if per_channel else 1, init=0.3)
    jl = jnn.PReLU(6 if per_channel else 1, init=0.3)
    np.testing.assert_array_equal(
        layer(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jl(jnp.asarray(x))))


def test_rrelu(x):
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        F.rrelu(xt, 0.1, 0.3, training=False).numpy(),
        np.asarray(jF.rrelu(jnp.asarray(x), 0.1, 0.3, training=False)))
    with rng.rng_context(3, 0):
        a = F.rrelu(xt, 0.1, 0.3, training=True)
    with rng.rng_context(3, 0):
        b = F.rrelu(xt, 0.1, 0.3, training=True)
    assert torch.equal(a, b)
    neg = xt < 0
    slope = a[neg] / xt[neg]
    assert bool((slope >= 0.1).all()) and bool((slope < 0.3 + 1e-6).all())
    assert torch.equal(a[~neg], xt[~neg])
    m = nn.RReLU(0.1, 0.3)
    m.eval()
    assert torch.equal(m(xt), F.rrelu(xt, 0.1, 0.3))


def test_gumbel_softmax(x):
    xt = torch.from_numpy(x)
    with rng.rng_context(5, 1):
        soft = F.gumbel_softmax(xt, temperature=0.5)
        hard = F.gumbel_softmax(xt.requires_grad_(), hard=True)
    torch.testing.assert_close(soft.sum(-1), torch.ones(4, 6))
    assert bool(((hard == 0) | (hard == 1)).all())
    assert torch.equal(hard.sum(-1), torch.ones(4, 6))
    hard.sum().backward()               # the straight-through gradient
    assert xt.grad is not None
    with pytest.raises(RuntimeError, match="needs a key"):
        F.gumbel_softmax(xt)


# (class name, args) of the `_act_layer` family and the other layers
LAYERS = [("ReLU", ()), ("ReLU6", ()), ("LeakyReLU", (0.3,)),
          ("ELU", (0.5,)), ("SELU", ()), ("CELU", (0.8,)), ("Silu", ()),
          ("Swish", ()), ("Mish", ()), ("Sigmoid", ()), ("LogSigmoid", ()),
          ("Hardsigmoid", ()), ("Hardswish", ()), ("Hardtanh", (-0.5, 2.0)),
          ("Hardshrink", ()), ("Softshrink", (0.7,)), ("Tanhshrink", ()),
          ("Softplus", (1.5, 10.0)), ("Softsign", ()), ("Tanh", ()),
          ("GLU", (1,)), ("Maxout", (3, 1)), ("Softmax", (1,)),
          ("LogSoftmax", (-1,)), ("ThresholdedReLU", (0.9,)),
          ("Identity", ())]


@pytest.mark.parametrize("cls,args", LAYERS, ids=[c for c, _ in LAYERS])
def test_activation_layer_matches_jax(x, cls, args):
    if cls == "Maxout":
        xx = x.reshape(4, 6, 10)
    else:
        xx = x
    jl, layer = getattr(jnn, cls)(*args), getattr(nn, cls)(*args)
    assert type(layer).__name__ == cls
    want = np.asarray(jl(jnp.asarray(xx)))
    got = layer(torch.from_numpy(xx)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cls", ["Dropout2D", "Dropout3D", "AlphaDropout"])
def test_dropout_layers(cls):
    shape = (2, 3, 4, 5, 6) if cls == "Dropout3D" else (2, 3, 4, 5)
    xt = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    layer = getattr(nn, cls)(0.5)
    layer.eval()
    assert torch.equal(layer(xt), xt)
    layer.train()
    with rng.rng_context(0, 0):
        out = layer(xt)
    assert out.shape == xt.shape and not torch.equal(out, xt)
    if cls != "AlphaDropout":       # whole channels dropped
        flat = out.flatten(2)
        assert bool(((flat == 0).all(-1) | (flat != 0).all(-1)).all())


@pytest.mark.parametrize("padding_idx", [None, 0, 3, -1])
def test_embedding_padding_idx(padding_idx):
    w = np.random.RandomState(1).randn(7, 4).astype(np.float32)
    ids = np.array([[0, 3, 6, 2], [6, 6, 1, 0]])
    want = np.asarray(jF.embedding(jnp.asarray(ids), jnp.asarray(w),
                                   padding_idx=None if padding_idx is None
                                   else padding_idx % 7))
    got = F.embedding(torch.from_numpy(ids), torch.from_numpy(w),
                      padding_idx=None if padding_idx is None
                      else padding_idx % 7)
    np.testing.assert_array_equal(got.numpy(), want)
    layer = nn.Embedding(7, 4, padding_idx=padding_idx,
                         gen=torch.Generator().manual_seed(0))
    jl = jnn.Embedding(7, 4, padding_idx=padding_idx)
    assert layer.padding_idx == jl.padding_idx
    if padding_idx is not None:
        assert bool((layer.weight[layer.padding_idx] == 0).all())
        layer(torch.from_numpy(ids)).sum().backward()
        assert bool((layer.weight.grad[layer.padding_idx] == 0).all())
        assert bool((layer.weight.grad[1] != 0).all())


def test_embedding_default_init():
    """JAX's default Normal(0, 1) without a std; GPT's (num, dim, std,
    gen) form keeps its N(0, std)."""
    g = torch.Generator().manual_seed(0)
    big = nn.Embedding(2000, 64, gen=g)
    assert abs(float(big.weight.detach().std()) - 1.0) < 0.02
    small = nn.Embedding(2000, 64, 0.02, g)
    assert abs(float(small.weight.detach().std()) - 0.02) < 0.001
    xav = nn.Embedding(2000, 64, gen=g, weight_attr=True)
    bound = (6.0 / (2000 + 64)) ** 0.5
    assert float(xav.weight.detach().abs().max()) <= bound


def _jax_tree():
    return jnn.LayerList([jnn.Linear(3, 4), jnn.LayerDict(
        {"a": jnn.Linear(4, 2), "b": jnn.LayerNorm(2)})])


def test_container_names_match_jax():
    g = torch.Generator().manual_seed(0)
    port = nn.LayerList([nn.Linear(3, 4, gen=g), nn.LayerDict(
        {"a": nn.Linear(4, 2, gen=g), "b": nn.LayerNorm(2)})])
    jm = _jax_tree()
    assert dict((k, tuple(v.shape)) for k, v in port.named_parameters()) \
        == {k: tuple(v.shape) for k, v in jm.raw_parameters().items()}
    seq = nn.Sequential(nn.Linear(3, 3, gen=g), nn.ReLU(),
                        nn.Linear(3, 2, gen=g))
    jseq = jnn.Sequential(jnn.Linear(3, 3), jnn.ReLU(), jnn.Linear(3, 2))
    assert [k for k, _ in seq.named_parameters()] \
        == list(jseq.raw_parameters())


def test_layer_list_surface():
    g = torch.Generator().manual_seed(0)
    layers = nn.LayerList([nn.Linear(2, 2, gen=g)])
    layers.append(nn.Tanh()).extend([nn.ReLU(), nn.Identity()])
    assert len(layers) == 4
    layers.insert(1, nn.Sigmoid())
    assert [type(m).__name__ for m in layers] == [
        "Linear", "Sigmoid", "Tanh", "ReLU", "Identity"]
    assert [n for n, _ in layers.named_children()] == ["0", "1", "2", "3",
                                                       "4"]
    assert isinstance(layers[1:3], nn.LayerList) and len(layers[1:3]) == 2
    layers[4] = nn.ReLU6()
    assert type(layers[4]).__name__ == "ReLU6"
    d = nn.LayerDict([("x", nn.Tanh())])
    d.update({"y": nn.ReLU()})
    d["z"] = nn.Identity()
    del d["x"]
    assert list(d.keys()) == ["y", "z"] and len(d) == 2
    params = nn.ParameterList([torch.nn.Parameter(torch.zeros(2))])
    params.append(torch.nn.Parameter(torch.ones(3)))
    assert [n for n, _ in params.named_parameters()] == ["0", "1"]
    assert tuple(params[1].shape) == (3,) and len(params) == 2


def test_linear_bias_attr():
    from paddle_tpu_torch.nn import initializer as I
    g = torch.Generator().manual_seed(0)
    assert nn.Linear(3, 4, gen=g, bias_attr=False).bias is None
    b = nn.Linear(3, 4, gen=g, bias_attr=I.Constant(0.5)).bias
    assert torch.equal(b.detach(), torch.full((4,), 0.5))
    jl = jnn.Linear(3, 4, bias_attr=False)
    assert jl.bias is None


def test_jax_glu_reference_is_jax_nn(x):
    """The JAX side computes jax.nn.glu, the port chunk + sigmoid."""
    np.testing.assert_allclose(
        np.asarray(jax.nn.glu(jnp.asarray(x), axis=-1)),
        F.glu(torch.from_numpy(x)).numpy(), atol=1e-6, rtol=1e-6)
