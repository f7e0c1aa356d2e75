"""Math / reduction / comparison ops: the counterpart of
`paddle_tpu/ops/math.py`.

The reference's conventions (`axis`, `keepdim`, `paddle.add(x, y)`-style
names) over torch ops; values, shapes and dtypes are JAX's with x64
off (an integer sum, a count or an index is int32; the mean, variance
and logsumexp of integers are fp32). `quantile` / `median` (and
`extras.nanquantile`) sort and interpolate as JAX does, so they take any
size (torch's own `quantile` refuses more than 2^24 elements). Names
ending in `_` (`multiply_`, `softplus_`) return a new tensor and leave
the input alone, as the reference's do.
"""
from __future__ import annotations

import torch

from .. import core
from ._common import a, dims, floating, out, pair

__all__ = [
    # elementwise binary
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "maximum", "minimum", "fmax", "fmin", "atan2",
    "logaddexp", "heaviside", "gcd", "lcm", "hypot", "ldexp", "copysign",
    "nextafter",
    # elementwise unary
    "abs", "neg", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "square", "reciprocal", "sign", "floor", "ceil", "round",
    "trunc", "frac", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfinv", "sigmoid",
    "logit", "lgamma", "digamma", "polygamma", "i0", "i1", "angle", "conj",
    "real", "imag", "deg2rad", "rad2deg", "nan_to_num", "clip",
    # reductions
    "sum", "mean", "max", "min", "prod", "all", "any", "amax", "amin",
    "logsumexp", "median", "nanmedian", "nansum", "nanmean", "quantile",
    "std", "var", "count_nonzero", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp",
    # comparison / logic
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal_all", "allclose", "isclose", "isnan", "isinf",
    "isfinite", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "left_shift", "right_shift",
    # linalg-lite / products
    "matmul", "dot", "mm", "bmm", "inner", "outer", "cross", "kron",
    "multiply_", "trace", "diagonal", "addmm",
    # misc
    "lerp", "diff", "scale", "stanh", "softplus_", "increment",
    "broadcast_shape", "cast",
]


def _binary(fn):
    def op(x, y, name=None):
        return fn(*pair(x, y))
    op.__name__ = fn.__name__
    return op


# --- elementwise binary ----------------------------------------------------- #

add = _binary(torch.add)
subtract = _binary(torch.subtract)
multiply = _binary(torch.multiply)
multiply_ = multiply
divide = _binary(torch.true_divide)
floor_divide = _binary(torch.floor_divide)
mod = _binary(torch.remainder)
remainder = mod
pow = _binary(torch.pow)
maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)
fmax = _binary(torch.fmax)
fmin = _binary(torch.fmin)
atan2 = _binary(torch.atan2)
logaddexp = _binary(torch.logaddexp)
heaviside = _binary(torch.heaviside)
gcd = _binary(torch.gcd)
lcm = _binary(torch.lcm)
hypot = _binary(torch.hypot)
ldexp = _binary(torch.ldexp)
copysign = _binary(torch.copysign)
nextafter = _binary(torch.nextafter)


# --- elementwise unary ------------------------------------------------------ #

def _unary(fn):
    def op(x, name=None):
        return fn(a(x))
    op.__name__ = getattr(fn, "__name__", "op")
    return op


abs = _unary(torch.abs)
neg = _unary(torch.neg)
exp = _unary(torch.exp)
expm1 = _unary(torch.expm1)
log = _unary(torch.log)
log2 = _unary(torch.log2)
log10 = _unary(torch.log10)
log1p = _unary(torch.log1p)
sqrt = _unary(torch.sqrt)
rsqrt = _unary(torch.rsqrt)
square = _unary(torch.square)
reciprocal = _unary(torch.reciprocal)
sign = _unary(torch.sign)
floor = _unary(torch.floor)
ceil = _unary(torch.ceil)
round = _unary(torch.round)           # half to even, as jnp.round
trunc = _unary(torch.trunc)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
asin = _unary(torch.asin)
acos = _unary(torch.acos)
atan = _unary(torch.atan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
asinh = _unary(torch.asinh)
acosh = _unary(torch.acosh)
atanh = _unary(torch.atanh)
erf = _unary(torch.erf)
erfinv = _unary(torch.erfinv)
sigmoid = _unary(torch.sigmoid)
lgamma = _unary(torch.lgamma)
digamma = _unary(torch.digamma)
i0 = _unary(torch.special.i0)
i1 = _unary(torch.special.i1)
angle = _unary(torch.angle)
conj = _unary(torch.conj)
real = _unary(torch.real)
deg2rad = _unary(torch.deg2rad)
rad2deg = _unary(torch.rad2deg)


def frac(x, name=None):
    x = a(x)
    return x - torch.trunc(x)


def logit(x, eps=None, name=None):
    x = a(x)
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def polygamma(x, n, name=None):
    return torch.special.polygamma(n, a(x))


def imag(x, name=None):
    """The imaginary part; zeros for a real tensor, as jnp.imag."""
    x = a(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(a(x), nan=nan, posinf=posinf, neginf=neginf)


def clip(x, min=None, max=None, name=None):
    x = a(x)
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * a(x))


def softplus_(x, beta=1.0, threshold=20.0):
    """`jax.nn.softplus(x * beta) / beta` (log(1 + e^x) without the
    threshold, as the reference)."""
    z = a(x) * beta
    return torch.logaddexp(z, torch.zeros_like(z)) / beta


def increment(x, value=1.0, name=None):
    x, v = pair(x, value)
    return x + v


def cast(x, dtype):
    return a(x).to(core.convert_dtype(dtype))


# --- reductions ------------------------------------------------------------- #

def _keep(res, x, axes, keepdim):
    """`res` reduced over `axes` of x, with the reduced axes put back as
    1s under keepdim."""
    if keepdim:
        shape = [1 if i in axes else s for i, s in enumerate(x.shape)]
        res = res.reshape(shape)
    return res


def _per_axis(fn, x, axis, keepdim):
    """A reduction that takes one dim at a time, over any axis spec."""
    axes = dims(axis, x.dim())
    res = x
    for ax in sorted(axes, reverse=True):
        res = fn(res, ax)
    if x.dim() == 0:
        res = fn(x.reshape(1), 0)
    return _keep(res, x, axes, keepdim)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = a(x)
    return out(torch.sum(x, dim=dims(axis, x.dim()), keepdim=keepdim,
                         dtype=core.convert_dtype(dtype)))


def mean(x, axis=None, keepdim=False, name=None):
    x = floating(a(x))
    return torch.mean(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):
    x = a(x)
    return torch.amax(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):
    x = a(x)
    return torch.amin(x, dim=dims(axis, x.dim()), keepdim=keepdim)


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = a(x)
    dtype = core.convert_dtype(dtype)
    return out(_per_axis(lambda t, ax: torch.prod(t, ax, dtype=dtype), x,
                         axis, keepdim))


def all(x, axis=None, keepdim=False, name=None):
    x = a(x)
    return torch.all(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):
    x = a(x)
    return torch.any(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = floating(a(x))
    return torch.logsumexp(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def _quantile(x, q, axis, keepdim, method="linear", skip_nan=False):
    """JAX's `_quantile`: sort along the axis (NaNs last), take the
    values at floor / ceil of q · (n - 1) (n: the count of non-NaN
    entries with `skip_nan`, where a slice of any NaN is NaN otherwise)
    and interpolate `lo · (1 - w) + hi · w` (or their midpoint). q's
    dims lead the result."""
    x = a(x)
    qt = pair(x, q)[1] if not isinstance(q, torch.Tensor) else q
    qt = qt.to(x.dtype if x.is_floating_point() else
               core.get_default_dtype())
    if axis is None:
        src = x.reshape(-1)
        ax = 0
    else:
        src, ax = x, int(axis) % x.dim()
    moved = src.movedim(ax, -1)
    n = moved.shape[-1]
    if skip_nan:
        srt = torch.sort(moved, dim=-1).values
        counts = (~torch.isnan(srt)).sum(-1).to(qt.dtype)
    else:
        nan_row = torch.isnan(moved).any(-1, keepdim=True)
        srt = torch.sort(moved, dim=-1).values
        srt = torch.where(nan_row, torch.full_like(srt, float("nan")), srt)
        counts = torch.full(moved.shape[:-1], float(n), dtype=qt.dtype,
                            device=x.device)
    qv = qt.reshape(qt.shape + (1,) * counts.dim())
    pos = qv * (counts - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    lw = 1 - hw
    lo = torch.minimum(torch.clamp(lo, min=0), (counts - 1).clamp(min=0))
    hi = torch.minimum(torch.clamp(hi, min=0), (counts - 1).clamp(min=0))
    full_srt = srt.expand(qt.shape + srt.shape)
    lo_v = torch.gather(full_srt, -1, lo.long().unsqueeze(-1)).squeeze(-1)
    hi_v = torch.gather(full_srt, -1, hi.long().unsqueeze(-1)).squeeze(-1)
    if method == "midpoint":
        res = (lo_v + hi_v) * 0.5
    else:
        res = lo_v.to(qt.dtype) * lw + hi_v.to(qt.dtype) * hw
    if keepdim:
        if axis is None:
            res = res.reshape(qt.shape + (1,) * x.dim())
        else:
            res = res.unsqueeze(qt.dim() + ax)
    return res.to(x.dtype) if x.is_floating_point() else res


def median(x, axis=None, keepdim=False, name=None):
    return _quantile(x, 0.5, axis, keepdim, method="midpoint")


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(x, 0.5, axis, keepdim, method="midpoint",
                     skip_nan=True)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(x, q, axis, keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = a(x)
    return out(torch.nansum(x, dim=dims(axis, x.dim()), keepdim=keepdim,
                            dtype=core.convert_dtype(dtype)))


def nanmean(x, axis=None, keepdim=False, name=None):
    x = floating(a(x))
    return torch.nanmean(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = floating(a(x))
    return torch.std(x, dim=dims(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = floating(a(x))
    return torch.var(x, dim=dims(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = a(x)
    axes = dims(axis, x.dim())
    return out(_keep(torch.count_nonzero(x, dim=axes), x, axes, keepdim))


def _flat_axis(x, axis):
    x = a(x)
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis)


def cumsum(x, axis=None, dtype=None, name=None):
    x, axis = _flat_axis(x, axis)
    return out(torch.cumsum(x, axis, dtype=core.convert_dtype(dtype)))


def cumprod(x, dim=None, dtype=None, name=None):
    x, dim = _flat_axis(x, dim)
    return out(torch.cumprod(x, dim, dtype=core.convert_dtype(dtype)))


def _cum_extreme(x, axis, take):
    """(running extreme, the last index where x reaches it), as the
    reference's associative scans."""
    x, axis = _flat_axis(x, axis)
    axis = axis % x.dim()
    vals = (torch.cummax if take == "max" else torch.cummin)(x, axis).values
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    idx = torch.arange(x.shape[axis], dtype=torch.int32,
                       device=x.device).reshape(shape).expand(x.shape)
    is_new = x >= vals if take == "max" else x <= vals
    run = torch.cummax(torch.where(is_new, idx, torch.full_like(idx, -1)),
                       axis).values
    return vals, run


def cummax(x, axis=None, name=None):
    return _cum_extreme(x, axis, "max")


def cummin(x, axis=None, name=None):
    return _cum_extreme(x, axis, "min")


def logcumsumexp(x, axis=None, name=None):
    x, axis = _flat_axis(x, axis)
    return torch.logcumsumexp(floating(x), axis)


# --- comparison / logic ----------------------------------------------------- #

equal = _binary(torch.eq)
not_equal = _binary(torch.ne)
less_than = _binary(torch.lt)
less_equal = _binary(torch.le)
greater_than = _binary(torch.gt)
greater_equal = _binary(torch.ge)
logical_and = _binary(torch.logical_and)
logical_or = _binary(torch.logical_or)
logical_xor = _binary(torch.logical_xor)
bitwise_and = _binary(torch.bitwise_and)
bitwise_or = _binary(torch.bitwise_or)
bitwise_xor = _binary(torch.bitwise_xor)
left_shift = _binary(torch.bitwise_left_shift)
right_shift = _binary(torch.bitwise_right_shift)
isnan = _unary(torch.isnan)
isinf = _unary(torch.isinf)
isfinite = _unary(torch.isfinite)
logical_not = _unary(torch.logical_not)
bitwise_not = _unary(torch.bitwise_not)


def equal_all(x, y, name=None):
    """A 0-d bool tensor: same shape and equal everywhere (no host
    read)."""
    x, y = pair(x, y)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.eq(x, y).all()


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    """A 0-d bool tensor (no host read)."""
    return isclose(x, y, rtol, atol, equal_nan).all()


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    x, y = pair(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


# --- products --------------------------------------------------------------- #

def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = pair(x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def dot(x, y, name=None):
    x, y = pair(x, y)
    if x.dim() == 2:  # paddle.dot supports batched 2-D
        return torch.sum(x * y, dim=-1)
    if x.dim() <= 1 or y.dim() <= 1:
        return torch.matmul(x, y) if x.dim() and y.dim() else x * y
    return torch.tensordot(x, y, dims=([-1], [-2]))


def mm(x, y, name=None):
    return torch.matmul(*pair(x, y))


def bmm(x, y, name=None):
    return torch.matmul(*pair(x, y))


def inner(x, y, name=None):
    return torch.inner(*pair(x, y))


def outer(x, y, name=None):
    x, y = pair(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


def cross(x, y, axis=None, name=None):
    x, y = pair(x, y)
    if axis is None:
        # reference semantics: first axis whose length is 3
        axis = next((i for i, s in enumerate(x.shape) if s == 3), None)
        if axis is None:
            raise ValueError("cross: no axis of length 3 found")
    return torch.linalg.cross(x, y, dim=axis)


def kron(x, y, name=None):
    return torch.kron(*pair(x, y))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return out(torch.diagonal(a(x), offset, axis1, axis2).sum(-1))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(a(x), offset, axis1, axis2)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * a(input) + alpha * torch.matmul(*pair(x, y))


# --- misc ------------------------------------------------------------------- #

def lerp(x, y, weight, name=None):
    x, y = pair(x, y)
    w = weight if isinstance(weight, (int, float)) else a(weight, x.device)
    return x + w * (y - x)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = a(x)

    def edge(v):
        if v is None:
            return None
        v = pair(x, v)[1]
        if v.dim() == 0:
            shape = list(x.shape)
            shape[axis] = 1
            v = v.expand(shape)
        return v

    return torch.diff(x, n=n, dim=axis, prepend=edge(prepend),
                      append=edge(append))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    x = a(x)
    res = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act is not None:
        from ..nn import functional as F
        res = getattr(F, act)(res)
    return res


def broadcast_shape(x_shape, y_shape):
    return tuple(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))

