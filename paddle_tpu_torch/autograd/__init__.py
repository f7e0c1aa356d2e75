"""Functional autograd: the counterpart of `paddle_tpu/autograd/`.

The reference differentiates functions, not tapes: `pt.grad(f)` over a
loss function of a {path: tensor} parameter dict (see
`functional_call`). The training idiom is the reference's:

    loss, grads = pt.value_and_grad(loss_fn)(params)

`grad`, `value_and_grad` and `vjp` take dicts, lists and tuples of
tensors, with `argnums` and `has_aux` as JAX's. They run `fun` on
fresh leaves that require gradients (an argument that already carries a
graph enters as a view of it, so a call nests inside another) and take
`torch.autograd.grad` with `create_graph` while grad mode is on, so
their results are differentiable again; a leaf the output does not
reach gets zeros, as `jax.grad` gives. They run every operator autograd
runs, the flash operators' registered backward (K3) included.
`jvp`, `jacobian` and `hessian` use `torch.func`: they cover the
operators with forward-mode (jvp, hessian) or vmap-able backward
formulas (jacobian), which excludes the flash operators
(`paddle_tpu_torch::flash_attention_*` have neither a forward-mode
formula nor a batching rule); as the reference's, `jacobian` and
`hessian` of a tuple of inputs differentiate with respect to the first.
`PyLayer` builds a `torch.autograd.Function` from the user's static
`forward(ctx, *args)` / `backward(ctx, *grads)`. `backward` raises: the
port adds no tape-style surface the reference lacks.
"""
from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

from ..core import is_grad_enabled, no_grad

__all__ = ["grad", "value_and_grad", "vjp", "jvp", "jacobian", "hessian",
           "PyLayer", "PyLayerContext", "no_grad", "is_grad_enabled",
           "stop_gradient", "backward"]


def _flatten(tree):
    """(tensor leaves, rebuild(leaves) -> tree) of a nest of dicts,
    lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [], lambda ls: tree
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, rb), n in zip(parts, sizes):
            out.append(rb(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [t for p in parts for t in p[0]], rebuild


def _leaf(t: torch.Tensor) -> torch.Tensor:
    if not (t.is_floating_point() or t.is_complex()):
        raise TypeError(f"grad requires real- or complex-valued inputs, "
                        f"got a {t.dtype} tensor")
    if t.requires_grad:
        return t.view_as(t)          # nested: keep the outer graph
    return t.detach().requires_grad_()


def _grads(out, leaves, grad_outputs=None):
    outs = [out] if isinstance(out, torch.Tensor) else list(out)
    cts = None if grad_outputs is None else (
        [grad_outputs] if isinstance(grad_outputs, torch.Tensor)
        else list(grad_outputs))
    live = [i for i, o in enumerate(outs) if o.requires_grad]
    if not live:                     # the output does not depend on them
        return [torch.zeros_like(t) for t in leaves]
    gs = torch.autograd.grad([outs[i] for i in live], leaves,
                             grad_outputs=None if cts is None
                             else [cts[i] for i in live],
                             create_graph=torch.is_grad_enabled(),
                             retain_graph=True, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(gs, leaves)]


def _with_leaves(args, argnums):
    """(args with fresh leaves at argnums, [(leaves, rebuild)] per
    argnum)."""
    nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)
    args = list(args)
    parts = []
    for i in nums:
        leaves, rebuild = _flatten(args[i])
        leaves = [_leaf(t) for t in leaves]
        args[i] = rebuild(leaves)
        parts.append((leaves, rebuild))
    return args, parts


def value_and_grad(fun: Callable, argnums: Union[int, Sequence[int]] = 0,
                   has_aux: bool = False) -> Callable:
    """`jax.value_and_grad`: a function returning (value, grads) — or
    ((value, aux), grads) with `has_aux` — where grads has the structure
    of the argument at `argnums` (a tuple of them for a sequence)."""

    def wrapped(*args, **kwargs):
        args, parts = _with_leaves(args, argnums)
        res = fun(*args, **kwargs)
        value, aux = res if has_aux else (res, None)
        if not isinstance(value, torch.Tensor) or value.numel() != 1:
            raise TypeError("grad requires a scalar output, got "
                            f"{getattr(value, 'shape', type(value))}")
        flat = [t for leaves, _ in parts for t in leaves]
        gs = _grads(value, flat)
        out, i = [], 0
        for leaves, rebuild in parts:
            out.append(rebuild(gs[i:i + len(leaves)]))
            i += len(leaves)
        grads = out[0] if isinstance(argnums, int) else tuple(out)
        return ((value, aux) if has_aux else value), grads

    return wrapped


def grad(fun: Callable, argnums: Union[int, Sequence[int]] = 0,
         has_aux: bool = False) -> Callable:
    """`jax.grad`: the gradient of a scalar function (with `has_aux`,
    (grads, aux))."""
    vg = value_and_grad(fun, argnums, has_aux)

    def wrapped(*args, **kwargs):
        value, grads = vg(*args, **kwargs)
        return (grads, value[1]) if has_aux else grads

    return wrapped


def stop_gradient(x):
    return x.detach()


def vjp(func: Callable, xs, v=None):
    """The reference's signature: (out, vjp_fn) without `v`, else (out,
    the cotangent `v` pulled back to `xs` (one tensor for one input))."""
    xs = tuple(xs) if isinstance(xs, (tuple, list)) else (xs,)
    args, parts = _with_leaves(xs, tuple(range(len(xs))))
    out = func(*args)

    def pullback(ct):
        outs, _ = _flatten(out)
        cts, _ = _flatten(ct)
        flat = [t for leaves, _ in parts for t in leaves]
        gs = _grads(outs, flat, cts)
        res, i = [], 0
        for leaves, rebuild in parts:
            res.append(rebuild(gs[i:i + len(leaves)]))
            i += len(leaves)
        return tuple(res)

    if v is None:
        return out, pullback
    grads = pullback(v)
    return out, grads[0] if len(grads) == 1 else grads


def jvp(func: Callable, xs, v):
    """(out, tangent) by forward mode (`torch.func.jvp`)."""
    xs = tuple(xs) if isinstance(xs, (tuple, list)) else (xs,)
    v = tuple(v) if isinstance(v, (tuple, list)) else (v,)
    return torch.func.jvp(func, xs, v)


def jacobian(func: Callable, xs, create_graph: bool = False,
             allow_unused: bool = False):
    """Reverse-mode jacobian (`torch.func.jacrev`) with respect to the
    first input, as the reference's."""
    if isinstance(xs, (tuple, list)):
        return torch.func.jacrev(func)(*xs)
    return torch.func.jacrev(func)(xs)


def hessian(func: Callable, xs, create_graph: bool = False,
            allow_unused: bool = False):
    """`torch.func.hessian` with respect to the first input."""
    if isinstance(xs, (tuple, list)):
        return torch.func.hessian(func)(*xs)
    return torch.func.hessian(func)(xs)


def backward(tensors, grad_tensors=None, retain_graph=False):
    raise RuntimeError(
        "paddle_tpu_torch has functional autograd (no global tape): "
        "replace `loss.backward()` with `loss, grads = "
        "pt.value_and_grad(loss_fn)(params)` over `pt.functional_call` — "
        "see pt.Trainer for the packaged train step.")


class PyLayerContext:
    """`save_for_backward` / `saved_tensor` and attribute storage for a
    PyLayer's forward and backward."""

    def __init__(self):
        self._saved = ()
        self._attrs = {}

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved

    def __setattr__(self, k, v):
        if k.startswith("_"):
            object.__setattr__(self, k, v)
        else:
            self._attrs[k] = v

    def __getattr__(self, k):
        try:
            return self.__dict__["_attrs"][k]
        except KeyError:
            raise AttributeError(k) from None


class _PyLayerMeta(type):
    def __init__(cls, name, bases, ns):
        super().__init__(name, bases, ns)
        if name == "PyLayer" or not hasattr(cls, "forward"):
            return
        layer = cls

        class _Function(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *args):
                pctx = PyLayerContext()
                out = layer.forward(pctx, *args)
                ctx.pctx = pctx
                ctx.is_tensor = [isinstance(v, torch.Tensor) for v in args]
                ctx.like = [v for v in args if isinstance(v, torch.Tensor)]
                return out

            @staticmethod
            def backward(ctx, *grads):
                res = layer.backward(ctx.pctx, *grads)
                if not isinstance(res, tuple):
                    res = (res,)
                full, gi = [], 0
                for is_t in ctx.is_tensor:
                    if is_t:
                        full.append(res[gi] if gi < len(res) else
                                    torch.zeros_like(ctx.like[gi]))
                        gi += 1
                    else:
                        full.append(None)
                return tuple(full)

        _Function.__name__ = f"{name}Function"
        cls._function = _Function


class PyLayer(metaclass=_PyLayerMeta):
    """A user-defined differentiable op:

        class Cube(PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x ** 3
            @staticmethod
            def backward(ctx, dy):
                (x,) = ctx.saved_tensor()
                return 3 * x ** 2 * dy

        y = Cube.apply(x)
    """

    @classmethod
    def apply(cls, *args):
        return cls._function.apply(*args)
