"""Helpers of the port's op-sweep test files: a case of
`paddle_tpu_torch.testing.op_cases` run through the JAX package (its
ops and `nn.functional`), the port's default device set to the CPU for
a module's tests (restored after), and the checks of the case table
(forward, gradient, bf16, random laws) as functions each test file
parametrizes over its own ops modules."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu import ops as jops
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import core
from paddle_tpu_torch.ops.registry import build_registry
from paddle_tpu_torch.testing import op_cases as oc

JNS = oc.namespace(jops, JF)
GRAD_TOL = (1e-5, 1e-6)      # fp32 gradients, as the forward
# JAX compositions that run op by op for seconds: compiled once instead
# (every gradient is compiled too: as fast as eager for one primitive)
JIT = {"roi_align", "roi_pool", "psroi_pool", "yolo_box", "yolo_box_1",
       "deformable_conv", "deformable_conv_1", "lu_unpack", "cummax",
       "cummax_1", "cummin", "logcumsumexp"}


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    """The port's default device is the CPU for the module's tests; the
    previous default (the card) comes back after."""
    with oc.on_device("cpu"):
        yield


def _is_float(v):
    return hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating)


def jax_run(case, grad=False):
    args = [jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for v in case.inputs()]
    if case.label in JIT:
        res = jax.jit(lambda *xs: case.call(JNS, *xs))(*args)
    else:
        res = case.call(JNS, *args)
    g = None
    if grad:
        def total(t, *rest):
            r = case.call(JNS, t, *rest)
            return sum(jnp.sum(v.astype(jnp.float32))
                       for v in oc.leaves(r) if _is_float(v))
        g = np.asarray(jax.jit(jax.grad(total))(*args))
    ls = oc.leaves(res)
    return [np.asarray(v) for v in ls], [np.asarray(v).dtype.name
                                         for v in ls], g


def cases(modules):
    return [c for c in oc.CASES if c.module in modules]


def ids(c):
    return c.label


def check_forward(case):
    run = oc.port_run(case, "cpu")
    got, got_dt = run.values, run.dtypes
    want, want_dt, _ = jax_run(case)
    assert run.devices <= {"cpu"}
    assert got_dt == want_dt, f"dtypes {got_dt} != JAX's {want_dt}"
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        err = oc.compare(g, w, case.rtol, case.atol, f"{case.label}[{i}]")
        assert err is None, err


def check_grad(case):
    got = oc.port_run(case, "cpu", grad=True).grad
    _, _, want = jax_run(case, grad=True)
    err = oc.compare(got, want, *GRAD_TOL, f"d {case.label}")
    assert err is None, err


def check_bf16(case):
    """The bf16 forward tracks the fp32 one within bf16's tolerance."""
    f32 = oc.port_run(case, "cpu").values
    b16 = oc.port_run(case, "cpu", first_dtype="bf16").values
    for g, w in zip(b16, f32):
        g = np.asarray(g, np.float32)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   rtol=oc.BF16_TOL, atol=oc.BF16_TOL)


def check_random(rcase):
    """Reproducible under `seed`, and the law holds."""
    o = oc.port_namespace()
    core.seed(1234)
    a = oc.to_numpy(rcase.draw(o))
    b = oc.to_numpy(rcase.draw(o))
    core.seed(1234)
    c = oc.to_numpy(rcase.draw(o))
    assert np.array_equal(a, c) and not (a.size > 20 and np.array_equal(a, b))
    assert rcase.law(a), f"{rcase.name}: the law does not hold"


def check_complete(modules, exempt=()):
    """Every op the port's registry counts as implemented in `modules`
    has a case (or a random case, or an exemption naming its test)."""
    reg = build_registry()
    implemented = {n for n, i in reg.items() if i.status == "implemented"
                   and i.module in modules}
    covered = ({c.name for c in oc.CASES} | {c.name for c in oc.RANDOM}
               | set(exempt))
    assert implemented, modules
    assert not implemented - covered, sorted(implemented - covered)
