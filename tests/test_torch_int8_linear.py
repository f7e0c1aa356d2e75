"""Port int8 linear (`paddle_tpu_torch/quantization`, kernel K7's plain
version in `ops_cuda/int8_linear.py`) against the JAX reference.

- `int8_linear_plain` equals JAX's fused Pallas kernel
  `_int8_linear_fused`, run in interpret mode on the CPU, bit for bit:
  rows 1-4, gpt_tiny's (k, n), bf16 and fp32 activations, with and
  without a bias, inputs on code half-points. One case differs by
  construction of the reference run, not of the kernel: fp32 with a
  bias. XLA's CPU backend contracts the kernel's `acc * s + b` into one
  fused multiply-add (one rounding), while the Pallas source, the TPU
  and the port round the product and the sum separately. There the test
  holds JAX to the fused formula, the port to the two-rounding one, and
  the two within the product's rounding.
- The port's `int8_linear` equals JAX's on the unfused path (more than
  4 rows), bitwise, with and without a bias.
- `_fused_ok` makes JAX's choice, apart from JAX's backend test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu import quantization as jq
from paddle_tpu_torch import quantization as pq
from paddle_tpu_torch.ops_cuda import int8_linear as k7
from port_threads import one_torch_thread  # noqa: F401


SHAPES = ((128, 384), (128, 512), (512, 128), (128, 1024))
SX = 1.0 / 64          # a power of two: (c + 0.5) * SX is exact in bf16


def _inputs(m, k, n, seed):
    """x (m, k) whose first row holds code half-points and +-127.5 * sx,
    int8 weights, fp32 weight scales and bias."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 0.5).astype(np.float32)
    halves = np.array([-3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 127.5,
                       -127.5], np.float32)
    x[0, :halves.size] = halves * SX
    qw = rng.randint(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.rand(n) * 0.01).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    return x, qw, ws, b


def _torch(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _jax_fused(x, qw, ws, b, dtype):
    with pltpu.force_tpu_interpret_mode():
        out = jq._int8_linear_fused(
            jnp.asarray(x).astype(dtype), jnp.asarray(qw), jnp.asarray(ws),
            jnp.asarray(SX, jnp.float32),
            None if b is None else jnp.asarray(b))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_plain_k7_equals_jax_fused_kernel(k, n, dtype, bias):
    tdt = getattr(torch, dtype)
    for m in (1, 2, 3, 4):
        x, qw, ws, b = _inputs(m, k, n, seed=k + n + m)
        b = b if bias else None
        # the activations as the reference rounds them (bf16 or fp32)
        xr = np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))
        want = _jax_fused(x, qw, ws, b, dtype)
        got = k7.int8_linear_plain(
            _torch(xr, tdt), _torch(qw), _torch(ws), torch.tensor(SX),
            None if b is None else _torch(b)).float().numpy()
        if not (bias and dtype == "float32"):
            np.testing.assert_array_equal(got, want)
            continue
        qx = np.clip(np.round(xr / np.float32(SX)), -127, 127)
        acc = (qx.astype(np.int64) @ qw.astype(np.int64)).astype(np.float32)
        s = (ws * np.float32(SX)).astype(np.float32)
        fused = (acc.astype(np.float64) * s + b).astype(np.float32)
        two = (acc * s).astype(np.float32) + b
        np.testing.assert_array_equal(want, fused)       # XLA:CPU's FMA
        np.testing.assert_array_equal(got, two)          # two roundings
        # the two differ by the product's rounding: at most an ulp of
        # the product plus an ulp of the result
        bound = np.spacing(np.abs(acc * s)) + np.spacing(np.abs(want))
        assert (np.abs(got - want) <= bound).all()


def test_half_points_round_to_even():
    x, qw, ws, _ = _inputs(1, 128, 128, seed=0)
    codes = pq.quantize_tensor(_torch(x), SX)[0, :10].tolist()
    assert codes == [-4, -2, -2, 0, 0, 2, 2, 4, 127, -127]


@pytest.mark.parametrize("lead", [(5,), (2, 3), (9,)])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_int8_linear_equals_jax(lead, bias, dtype):
    k, n = 128, 384
    rng = np.random.RandomState(len(lead) * 10 + lead[-1])
    x = (rng.randn(*lead, k) * 0.7).astype(np.float32)
    _, qw, ws, b = _inputs(1, k, n, seed=3)
    b = b if bias else None
    jx = jnp.asarray(x).astype(dtype)
    want = jq.int8_linear(jx, jnp.asarray(qw), jnp.asarray(ws),
                          jnp.asarray(0.02, jnp.float32),
                          None if b is None else jnp.asarray(b))
    assert not jq._fused_ok(jx, jnp.asarray(qw), 0.02)
    tx = _torch(np.asarray(jx.astype(jnp.float32)), getattr(torch, dtype))
    got = pq.int8_linear(tx, _torch(qw), _torch(ws),
                         torch.tensor(0.02, dtype=torch.float32),
                         None if b is None else _torch(b))
    assert got.dtype == tx.dtype and got.shape == (*lead, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_fused_and_unfused_paths_agree_bitwise():
    """The rows of one call through K7's plain version equal the same
    rows inside a call that takes the unfused path."""
    x, qw, ws, b = _inputs(9, 128, 512, seed=5)
    args = (_torch(qw), _torch(ws), torch.tensor(SX), _torch(b))
    few = pq.int8_linear(_torch(x[:4]), *args)
    many = pq.int8_linear(_torch(x), *args)
    assert pq._fused_ok(_torch(x[:4]), args[0], SX)
    assert not pq._fused_ok(_torch(x), args[0], SX)
    assert torch.equal(few, many[:4])


@pytest.mark.parametrize("xshape,wshape,scale", [
    ((1, 128), (128, 384), 0.1), ((4, 128), (128, 384), 0.1),
    ((5, 128), (128, 384), 0.1), ((2, 2, 128), (128, 256), 0.1),
    ((2, 3, 128), (128, 256), 0.1), ((1, 96), (96, 384), 0.1),
    ((1, 128), (128, 200), 0.1), ((128,), (128, 384), 0.1),
    ((1, 128), (128, 384), "vector"), ((1, 64), (128, 384), 0.1)])
def test_fused_ok_makes_jax_choice(monkeypatch, xshape, wshape, scale):
    """Apart from the backend test (JAX takes the fused kernel on a TPU
    only; the port on either device), the rule is the same."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    x = np.zeros(xshape, np.float32)
    qw = np.zeros(wshape, np.int8)
    s = np.full(wshape[1], 0.1, np.float32) if scale == "vector" \
        else np.float32(scale)
    want = jq._fused_ok(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s))
    assert pq._fused_ok(_torch(x), _torch(qw), _torch(s)) == want


def test_cuda_only_argument_checks():
    """The checks that guard a K7 launch raise on what the kernel does
    not take (run here on CPU tensors: the checks themselves need no
    card)."""
    x, qw, ws, b = (_torch(a) for a in _inputs(2, 128, 384, seed=1))
    sx = torch.tensor(SX)
    k7._check_cuda_args(x, qw, ws, sx, b)
    with pytest.raises(ValueError, match="rows"):
        k7._check_cuda_args(torch.zeros(5, 128), qw, ws, sx, b)
    with pytest.raises(TypeError, match="int8"):
        k7._check_cuda_args(x, qw.float(), ws, sx, b)
    with pytest.raises(TypeError, match="dtype"):
        k7._check_cuda_args(x.half(), qw, ws, sx, b)
    with pytest.raises(TypeError, match="act_scale"):
        k7._check_cuda_args(x, qw, ws, sx.double(), b)
    with pytest.raises(ValueError, match="contiguous"):
        k7._check_cuda_args(torch.zeros(128, 2).t(), qw, ws, sx, b)
    with pytest.raises(ValueError, match="device"):
        k7.int8_linear_fused(x.to("meta"), qw, ws, sx, b)
