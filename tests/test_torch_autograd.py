"""The port's functional autograd against JAX's on the same numpy
functions: `grad` / `value_and_grad` (argnums, has_aux, dict
parameters, nesting), `vjp`, `jvp`, `jacobian`, `hessian`, the `Cube`
PyLayer of `tests/test_optimizer.py`, `stop_gradient`, and `backward`
raising; then `pt.value_and_grad` of `gpt_tiny`'s loss over
`pt.functional_call` against `jax.value_and_grad` of the JAX model's,
weights carried across, loss and gradients within fp32 1e-5 (the CPU
runs the plain attention). Tolerance elsewhere: fp32 rtol 1e-5, atol
1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.ops_cuda import flash_attention as fa
from paddle_tpu_torch.testing.op_cases import on_device
from port_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    with on_device("cpu"):
        yield


def _x(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _close(got, want, **tol):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(
            g.detach().numpy(), np.asarray(w), **(tol or TOL)), got, want)


def _f(o):
    """The same function in both packages, through each one's ops."""
    def f(p, x):
        h = o.tanh(o.matmul(x, p["w"]) + p["b"])
        return o.sum(o.square(h)) + 0.5 * o.sum(p["w"] * p["w"])
    return f


def _params(seed=0):
    return {"w": _x((4, 3), seed), "b": _x((3,), seed + 1)}


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_value_and_grad_over_a_dict():
    p, x = _params(), _x((5, 4), 2)
    jv, jg = jax.value_and_grad(_f(jpt))(_j(p), jnp.asarray(x))
    v, g = pt.value_and_grad(_f(pt))(_t(p), torch.from_numpy(x))
    np.testing.assert_allclose(v.item(), float(jv), **TOL)
    assert set(g) == {"w", "b"}
    _close(g, jg)


def test_argnums_and_has_aux():
    p, x = _params(), _x((5, 4), 2)

    def aux(o):
        def f(p, x):
            return _f(o)(p, x), o.mean(x)
        return f

    (jv, ja), (jgp, jgx) = jax.value_and_grad(
        aux(jpt), argnums=(0, 1), has_aux=True)(_j(p), jnp.asarray(x))
    (v, a), (gp, gx) = pt.value_and_grad(
        aux(pt), argnums=(0, 1), has_aux=True)(_t(p), torch.from_numpy(x))
    np.testing.assert_allclose(v.item(), float(jv), **TOL)
    np.testing.assert_allclose(a.item(), float(ja), **TOL)
    _close(gp, jgp)
    _close(gx, jgx)
    gx2 = pt.grad(_f(pt), argnums=1)(_t(p), torch.from_numpy(x))
    _close(gx2, jax.grad(_f(jpt), argnums=1)(_j(p), jnp.asarray(x)))
    g, a = pt.grad(aux(pt), has_aux=True)(_t(p), torch.from_numpy(x))
    _close(g, jgp)


def test_grad_of_an_unused_input_is_zero_and_scalar_required():
    g = pt.grad(lambda a, b: pt.sum(a * 2.0), argnums=(0, 1))(
        torch.ones(3), torch.ones(2))
    jg = jax.grad(lambda a, b: jnp.sum(a * 2.0), argnums=(0, 1))(
        jnp.ones(3), jnp.ones(2))
    _close(list(g), list(jg))
    with pytest.raises(TypeError):
        pt.grad(lambda a: a * 2)(torch.ones(3))
    with pytest.raises(TypeError):
        pt.grad(lambda a: pt.sum(a))(torch.ones(3, dtype=torch.int32))


def test_grad_nests():
    """grad of grad, and a hessian-vector product through a closure."""
    f = lambda o: (lambda x: o.sum(o.sin(x) * x ** 3))
    x = _x((4,), 3)
    want = jax.grad(lambda t: jnp.sum(jax.grad(f(jpt))(t)))(jnp.asarray(x))
    got = pt.grad(lambda t: pt.sum(pt.grad(f(pt))(t)))(torch.from_numpy(x))
    _close(got, want)
    v = _x((4,), 4)
    want = jax.grad(lambda t: jnp.vdot(jax.grad(f(jpt))(t),
                                       jnp.asarray(v)))(jnp.asarray(x))
    got = pt.grad(lambda t: pt.sum(pt.grad(f(pt))(t)
                                   * torch.from_numpy(v)))(
        torch.from_numpy(x))
    _close(got, want)


def test_vjp():
    f = lambda o: (lambda a, b: (o.matmul(a, b), o.sum(a)))
    a, b = _x((3, 4)), _x((4, 2), 1)
    ct = (_x((3, 2), 5), np.float32(2.0))
    jout, jpull = jax.vjp(f(jpt), jnp.asarray(a), jnp.asarray(b))
    out, pull = pt.autograd.vjp(f(pt), (torch.from_numpy(a),
                                        torch.from_numpy(b)))
    _close(list(out), list(jout))
    _close(list(pull((torch.from_numpy(ct[0]), torch.tensor(ct[1])))),
           list(jpull((jnp.asarray(ct[0]), jnp.asarray(ct[1])))))
    # with v: the reference's (out, grads) form
    g = lambda o: (lambda x: o.sum(x ** 2))
    _, got = pt.autograd.vjp(g(pt), torch.arange(3.0), torch.tensor(1.0))
    _, want = jpt.autograd.vjp(g(jpt), jnp.arange(3.0), jnp.asarray(1.0))
    _close(got, want)


def test_jvp_jacobian_hessian():
    f = lambda o: (lambda x: o.sin(x) * o.sum(x))
    x, t = _x((3,)), _x((3,), 1)
    jo, jt = jax.jit(lambda a, b: jpt.autograd.jvp(f(jpt), a, b))(
        jnp.asarray(x), jnp.asarray(t))
    o, tt = pt.autograd.jvp(f(pt), torch.from_numpy(x), torch.from_numpy(t))
    _close([o, tt], [jo, jt])
    _close(pt.autograd.jacobian(f(pt), torch.from_numpy(x)),
           jax.jit(lambda a: jpt.autograd.jacobian(f(jpt), a))(
               jnp.asarray(x)))
    h = lambda o: (lambda x, y: o.sum(x ** 3 * y))
    _close(pt.autograd.hessian(h(pt), (torch.from_numpy(x),
                                       torch.from_numpy(t))),
           jax.jit(lambda a, b: jpt.autograd.hessian(h(jpt), (a, b)))(
               jnp.asarray(x), jnp.asarray(t)))
    _close(pt.autograd.jacobian(h(pt), [torch.from_numpy(x),
                                        torch.from_numpy(t)]),
           jax.jit(lambda a, b: jpt.autograd.jacobian(h(jpt), [a, b]))(
               jnp.asarray(x), jnp.asarray(t)))


def _cube(package):
    class Cube(package.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x ** 3

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return 3 * x ** 2 * dy
    return Cube


def test_pylayer_cube_matches_jax():
    jc, pc = _cube(jpt), _cube(pt)
    x = _x((4,), 2) + 2.0
    _close(pc.apply(torch.from_numpy(x)), jc.apply(jnp.asarray(x)))
    got = pt.grad(lambda t: pt.sum(pc.apply(t) * t))(torch.from_numpy(x))
    want = jax.grad(lambda t: jnp.sum(jc.apply(t) * t))(jnp.asarray(x))
    _close(got, want)
    x0 = torch.tensor(2.0, requires_grad=True)
    y = pc.apply(x0)
    assert y.item() == 8.0
    assert torch.autograd.grad(y, x0)[0].item() == 12.0


def test_pylayer_passes_non_tensors_and_missing_grads():
    class Scale(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k, y):
            ctx.k = k
            return x * k + y

        @staticmethod
        def backward(ctx, dz):
            return dz * ctx.k          # no gradient given for y: zeros

    x, y = torch.ones(3, requires_grad=True), torch.ones(3,
                                                        requires_grad=True)
    gx, gy = torch.autograd.grad(Scale.apply(x, 4.0, y).sum(), [x, y])
    assert torch.equal(gx, torch.full((3,), 4.0))
    assert torch.equal(gy, torch.zeros(3))


def test_stop_gradient_and_backward():
    g = pt.grad(lambda t: pt.sum(t * pt.autograd.stop_gradient(t)))(
        torch.ones(2) * 3)
    assert torch.equal(g, torch.full((2,), 3.0))
    with pytest.raises(RuntimeError, match="value_and_grad"):
        pt.autograd.backward(torch.ones(1))
    assert pt.autograd.no_grad is pt.no_grad


def test_gpt_tiny_value_and_grad_over_functional_call_matches_jax():
    jpt.seed(0)
    jm = jax_gpt_tiny()
    jparams = jm.raw_parameters()
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    ids = np.random.RandomState(0).randint(0, 1024, (2, 32)).astype(
        np.int32)

    def jloss(p):
        out, _ = jax_functional_call(jm, p, jnp.asarray(ids), training=True)
        return jm.loss(out, jnp.asarray(ids))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)

    model = load_jax_params(gpt_tiny(seed=1, device="cpu"), np_params)
    tids = torch.from_numpy(ids).long()

    def loss_fn(p):
        out, updates = pt.functional_call(model, p, tids, training=True)
        assert updates == {}
        return model.loss(out, tids)

    pt.seed(0)
    fa.FWD_LAUNCHES.reset()
    params = {k: v.detach() for k, v in model.named_parameters()}
    loss, grads = pt.value_and_grad(loss_fn)(params)
    assert fa.FWD_LAUNCHES.count == 0              # CPU: plain attention
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(grads) == set(jg)
    for k, g in jg.items():
        g = np.asarray(g)
        np.testing.assert_allclose(grads[k].detach().numpy(), g,
                                   atol=1e-5 * np.abs(g).max(), rtol=0,
                                   err_msg=k)
    # the model's own parameters were not touched or given .grad
    assert all(p.grad is None for p in model.parameters())
