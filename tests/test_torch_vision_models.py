"""The port's vision zoo (`models/vision.py`, `models/vision_extra.py`)
against the JAX package's.

- Every constructor (23, and `vgg16(batch_norm=True)`) builds JAX's
  network: the same parameter and buffer names and shapes, at 10
  classes and the smallest scale, so `models.load_jax_state` carries a
  JAX model across; at full width (1000 classes, scale 1) the parameter
  and buffer counts are the JAX package's, pinned below (read from the
  JAX constructors; the port counted on the `meta` device).
- One constructor per family (11): the eval forward of the same state
  (seeded numpy weights, fan-in scaled; BatchNorm statistics moved off
  0 / 1), carried into the JAX model and into the port with
  `load_jax_state`, within 1e-4 of the largest logit (the errors seen
  are ~1e-6). LeNet runs at 1 x 28 x 28, InceptionV3 at 75 x 75 (its
  smallest input), the others at 32-64 px: VGG at 64 px pools 2 x 2
  maps to 7 x 7 and AlexNet 1 x 1 to 6 x 6 (the non-divisible
  adaptive segments), Inception's branches pool 7 x 7 maps with the
  `exclusive` `AvgPool2D(3, 1, padding=1)`. Dropout models run in eval
  mode only (dropout masks equal JAX's only in law).
- MobileNetV1 x0.25 (no dropout) in training mode: logits and every
  BatchNorm statistic within 2e-3, as `test_torch_resnet_family.py`.

JAX models are built under `jax.eval_shape` (no draw is compiled) and
run under `jax.jit` over `functional_call`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu import models as jmodels
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch import models
from paddle_tpu_torch.models import load_jax_state
from port_threads import one_torch_thread  # noqa: F401

ZOO = [("LeNet", {}), ("AlexNet", {}), ("vgg11", {}), ("vgg13", {}),
       ("vgg16", {}), ("vgg19", {}), ("vgg16", {"batch_norm": True}),
       ("mobilenet_v1", {"scale": 0.25}), ("mobilenet_v2", {"scale": 0.25}),
       ("mobilenet_v3_small", {"scale": 0.25}),
       ("mobilenet_v3_large", {"scale": 0.25}), ("densenet121", {}),
       ("densenet161", {}), ("densenet169", {}), ("densenet201", {}),
       ("inception_v3", {}), ("shufflenet_v2_x0_25", {}),
       ("shufflenet_v2_x0_5", {}), ("shufflenet_v2_x1_0", {}),
       ("shufflenet_v2_x1_5", {}), ("shufflenet_v2_x2_0", {}),
       ("squeezenet1_0", {}), ("squeezenet1_1", {}), ("googlenet", {})]

# (parameters, buffers) at 1000 classes and scale 1, as the JAX
# package's constructors give them
FULL_WIDTH = {
    "LeNet": (145760, 0), "AlexNet": (61100840, 0),
    "vgg11": (132863336, 0), "vgg13": (133047848, 0),
    "vgg16": (138357544, 0), "vgg19": (143667240, 0),
    "vgg16_bn": (138365992, 8448),
    "mobilenet_v1": (4231976, 21888), "mobilenet_v2": (3504872, 34112),
    "mobilenet_v3_small": (2542856, 12112),
    "mobilenet_v3_large": (5483032, 24400),
    "densenet121": (7978856, 83648), "densenet161": (28681000, 219936),
    "densenet169": (14149480, 158400), "densenet201": (20013928, 229056),
    "inception_v3": (23834568, 34432),
    "shufflenet_v2_x0_25": (603688, 4024),
    "shufflenet_v2_x0_5": (1366792, 7952),
    "shufflenet_v2_x1_0": (2278604, 16180),
    "shufflenet_v2_x1_5": (3503624, 23440),
    "shufflenet_v2_x2_0": (7393996, 33716),
    "squeezenet1_0": (1248424, 0), "squeezenet1_1": (1235496, 0),
    "googlenet": (6998552, 0)}


def _key(name, kw):
    return name + ("_bn" if kw.get("batch_norm") else "")


def _jax_model(name, **kw):
    """(JAX model built under eval_shape, {name: shape} of its
    parameters, {name: shape} of its buffers), once per module."""
    return _jax_built(name, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _jax_built(name, kw):
    kw = dict(kw)
    box = {}

    def build():
        box["m"] = getattr(jmodels, name)(**kw)
        return box["m"].raw_parameters(), box["m"].raw_buffers()

    params, buffers = jax.eval_shape(build)
    return (box["m"], {k: tuple(v.shape) for k, v in params.items()},
            {k: tuple(v.shape) for k, v in buffers.items()})


def _meta_port(name, **kw):
    with torch.device("meta"):
        return getattr(models, name)(device="meta", **kw)


@pytest.mark.parametrize("name,kw", ZOO, ids=[_key(*z) for z in ZOO])
def test_constructor_names_and_shapes_are_jax_s(name, kw):
    _, jp, jb = _jax_model(name, num_classes=10, **kw)
    m = _meta_port(name, num_classes=10, **kw)
    assert {k: tuple(p.shape) for k, p in m.named_parameters()} == jp
    assert {k: tuple(b.shape) for k, b in m.named_buffers()} == jb


@pytest.mark.parametrize("name,kw", ZOO, ids=[_key(*z) for z in ZOO])
def test_full_width_counts_are_jax_s(name, kw):
    kw = {k: v for k, v in kw.items() if k != "scale"}
    m = _meta_port(name, num_classes=1000, **kw)
    assert (sum(p.numel() for p in m.parameters()),
            sum(b.numel() for b in m.buffers())) == FULL_WIDTH[_key(name, kw)]


def _numpy_state(m, seed=0):
    """Seeded fp32 weights for every parameter and buffer of `m`
    (numpy's default generator):
    convolutions and linears uniform with variance 1 / fan_in, BatchNorm
    weights near 1, biases and running means near 0, running variances
    in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(k, shape):
        # a tensor of more than 2^20 entries repeats its first 2^20 draws
        # (the classifiers of VGG and AlexNet: drawing is the test's cost)
        n = int(np.prod(shape))
        u = np.resize(rng.random(min(n, 1 << 20), dtype=np.float32), shape)
        if k.endswith("_variance"):
            return u + 0.5
        z = (u - 0.5) * np.float32(np.sqrt(12.0))      # mean 0, var 1
        if k.endswith("weight") and len(shape) >= 2:
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            return z / np.float32(np.sqrt(fan_in))
        if k.endswith("weight"):
            return 1 + 0.1 * z
        return 0.1 * z

    return ({k: draw(k, tuple(p.shape)) for k, p in m.named_parameters()},
            {k: draw(k, tuple(b.shape)) for k, b in m.named_buffers()})


def _cpu_twin(name, kw, seed=0):
    """(port model on the CPU, numpy params, numpy buffers): the state
    drawn once in numpy and loaded with `load_jax_state` (the model is
    laid out on meta first, so nothing else is drawn)."""
    m = _meta_port(name, **kw).to_empty(device="cpu")
    params, buffers = _numpy_state(m, seed)
    return load_jax_state(m, params, buffers), params, buffers


FAMILIES = [("LeNet", {}, (1, 28)), ("AlexNet", {}, (3, 64)),
            ("vgg11", {}, (3, 64)), ("mobilenet_v1", {"scale": 0.25}, (3, 32)),
            ("mobilenet_v2", {"scale": 0.25}, (3, 32)),
            ("mobilenet_v3_small", {"scale": 0.25}, (3, 32)),
            ("densenet121", {}, (3, 32)), ("inception_v3", {}, (3, 75)),
            ("shufflenet_v2_x0_25", {}, (3, 32)),
            ("squeezenet1_1", {}, (3, 48)), ("googlenet", {}, (3, 32))]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name,kw,inp", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_eval_forward_matches_jax(name, kw, inp):
    kw = dict(kw, num_classes=10)
    jm, _, _ = _jax_model(name, **kw)
    pm, params, buffers = _cpu_twin(name, kw)
    c, s = inp
    x = np.random.RandomState(1).randn(2, c, s, s).astype(np.float32)
    want = jax.jit(lambda p, b, a: jax_functional_call(
        jm, p, a, buffers=b, training=False)[0])(params, buffers,
                                                 jnp.asarray(x))
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert _rel(got, want) < 1e-4


def test_training_forward_and_batch_norm_updates_match_jax():
    kw = dict(num_classes=10)
    kw = dict(kw, scale=0.25)
    jm, _, _ = _jax_model("mobilenet_v1", **kw)
    pm, params, buffers = _cpu_twin("mobilenet_v1", kw, seed=2)
    x = np.random.RandomState(3).randn(4, 3, 32, 32).astype(np.float32)
    want, upd = jax.jit(lambda p, b, a: jax_functional_call(
        jm, p, a, buffers=b, training=True))(params, buffers, jnp.asarray(x))
    pm.train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert _rel(got, want) < 2e-3
    bufs = dict(pm.named_buffers())
    assert set(upd) == set(bufs)
    assert max(_rel(bufs[k], v) for k, v in upd.items()) < 2e-3


def test_constructor_options():
    a = models.mobilenet_v2(scale=0.25, num_classes=10, seed=3,
                            device="cpu")
    b = models.mobilenet_v2(scale=0.25, num_classes=10, seed=3,
                            device="cpu")
    c = models.mobilenet_v2(scale=0.25, num_classes=10, seed=4,
                            device="cpu")
    wa, wb, wc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(v, wb[k]) for k, v in wa.items())
    assert not torch.equal(wa["features.0.0.weight"],
                           wc["features.0.0.weight"])
    m = models.squeezenet1_1(num_classes=10, device="cpu", dtype="bfloat16")
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    m = models.mobilenet_v1(scale=0.25, num_classes=0, with_pool=False,
                            device="cpu")
    assert not hasattr(m, "fc") and not hasattr(m, "pool")
    for ctor in (models.vgg11, models.densenet121, models.googlenet,
                 models.mobilenet_v3_small, models.shufflenet_v2_x1_0):
        with pytest.raises(ValueError, match="download"):
            ctor(pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="SqueezeNet version"):
        models.SqueezeNet("2.0", device="cpu")
    assert P.vision.models is models
    assert P.vision.mobilenet_v2 is models.mobilenet_v2
    with pytest.raises(AttributeError):
        P.vision.no_such_model
