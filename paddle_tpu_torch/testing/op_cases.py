"""The op sweep's case table: every op of the flat surface with seeded
inputs, a call and a tolerance, shared by the CPU tests (the port
against the JAX package) and `chip_smoke.py`'s phase 10a (the port on
the card against the port on the CPU).

A `Case` builds its inputs from a seed with numpy (`inputs()`: a tuple
of numpy arrays and plain Python values) and calls `call(o, *args)`,
where `o` is a namespace of one package's ops and `nn.functional`
(`namespace`), so one call runs on either package: the JAX package's
`paddle_tpu.ops` or this one's `paddle_tpu_torch.ops`. Numpy inputs
become each package's tensors (here on the chosen device); the results
are compared leaf by leaf for shape, dtype and value within (rtol,
atol). A decomposition's case returns a reconstruction or an invariant
(signs and phases differ across libraries). `grad` marks the cases
whose gradient the reference sweep takes (`tests/test_op_sweep.py`):
the gradient of sum(result) with respect to the first input; `bf16`
the cases whose bf16 forward must track the fp32 one within bf16's
tolerance (5e-2). `module` is the registry module of the op.

`RANDOM` holds the random ops: a draw and a check of its law (range,
mean, variance within the stated bounds), since the draws equal JAX's
in law only. `main_path_cases` builds phase 10a's cases at GPT-small's sizes,
built on the device by torch itself.

No JAX here: the tests bring it.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Optional

import numpy as np

RS = np.random.RandomState

# fp32 elementwise and reductions; decompositions (by reconstruction)
TOL = (1e-5, 1e-6)
LINALG_TOL = (1e-4, 1e-4)
BF16_TOL = 5e-2


class Case:
    __slots__ = ("name", "module", "inputs", "call", "rtol", "atol", "grad",
                 "bf16", "label")

    def __init__(self, name, module, inputs, call, tol=TOL, grad=False,
                 bf16=False, label=None):
        self.name, self.module = name, module
        self.inputs, self.call = inputs, call
        self.rtol, self.atol = tol
        self.grad, self.bf16 = grad, bf16
        self.label = label or name

    def __repr__(self):
        return f"Case({self.label})"


def x(shape=(3, 4), seed=0, lo=-2.0, hi=2.0):
    return RS(seed).uniform(lo, hi, shape).astype(np.float32)


def ints(shape=(3, 4), seed=3, lo=1, hi=20):
    return RS(seed).randint(lo, hi, shape).astype(np.int32)


def bools(shape=(3, 4), seed=4):
    return RS(seed).rand(*shape) > 0.5


def spd(n=4, seed=7):
    m = x((n, n), seed=seed)
    return (m @ m.T + n * np.eye(n)).astype(np.float32)


def sym(n=4, seed=7):
    m = x((n, n), seed=seed)
    return ((m + m.T) / 2).astype(np.float32)


class namespace:
    """Attribute lookup in `ops` first, then in `functional`."""

    def __init__(self, ops, functional):
        self._ops, self._f = ops, functional

    def __getattr__(self, name):
        fn = getattr(self._ops, name, None)
        return fn if fn is not None else getattr(self._f, name)


CASES: List[Case] = []


def _add(name, module, inputs, call, **kw):
    CASES.append(Case(name, module, inputs, call, **kw))


M, C, MA, L, E, F = ("ops.math", "ops.creation", "ops.manipulation",
                     "ops.linalg", "ops.extras", "nn.functional")
_p = functools.partial

# --- unary (the reference sweep's UNARY, same input ranges) --------------- #

_UNARY = {
    # name: (module, (lo, hi), grad, bf16)
    "abs": (M, (-2, 2), True, True), "acos": (M, (-.9, .9), True, True),
    "acosh": (M, (1.1, 3), True, True), "asin": (M, (-.9, .9), True, True),
    "asinh": (M, (-2, 2), True, True), "atan": (M, (-2, 2), True, True),
    "atanh": (M, (-.9, .9), True, True), "ceil": (M, (-2, 2), False, True),
    "cos": (M, (-2, 2), True, True), "cosh": (M, (-2, 2), True, True),
    "deg2rad": (M, (-2, 2), True, True), "rad2deg": (M, (-2, 2), True, True),
    "digamma": (M, (.5, 4), True, True), "erf": (M, (-2, 2), True, True),
    "erfinv": (M, (-.9, .9), True, True), "exp": (M, (-2, 2), True, True),
    "expm1": (M, (-2, 2), True, True), "floor": (M, (-2, 2), False, True),
    "frac": (M, (-2, 2), True, True), "lgamma": (M, (.5, 4), True, True),
    "log": (M, (.1, 4), True, True), "log10": (M, (.1, 4), True, True),
    "log1p": (M, (-.5, 4), True, True), "log2": (M, (.1, 4), True, True),
    "logit": (M, (.1, .9), True, True), "neg": (M, (-2, 2), True, True),
    "reciprocal": (M, (.5, 3), True, True),
    "round": (M, (-2, 2), False, True), "rsqrt": (M, (.2, 4), True, True),
    "sign": (M, (-2, 2), False, True), "sin": (M, (-2, 2), True, True),
    "sinh": (M, (-2, 2), True, True), "sqrt": (M, (.1, 4), True, True),
    "square": (M, (-2, 2), True, True), "tan": (M, (-1, 1), True, True),
    "tanh": (M, (-2, 2), True, True), "trunc": (M, (-2, 2), False, True),
    "sigmoid": (M, (-2, 2), True, True), "stanh": (M, (-2, 2), True, True),
    "angle": (M, (-2, 2), False, False), "conj": (M, (-2, 2), False, False),
    "real": (M, (-2, 2), False, False), "imag": (M, (-2, 2), False, False),
    "isfinite": (M, (-2, 2), False, False),
    "isinf": (M, (-2, 2), False, False), "isnan": (M, (-2, 2), False, False),
    "i0": (M, (-2, 2), True, True), "i1": (M, (-2, 2), True, True),
    "thresholded_relu": (E, (-2, 2), True, True),
    "relu": (F, (-2, 2), True, True), "silu": (F, (-2, 2), True, True),
    "gelu": (F, (-2, 2), True, True), "elu": (F, (-2, 2), True, True),
    "selu": (F, (-2, 2), True, True), "leaky_relu": (F, (-2, 2), True, True),
    "mish": (F, (-2, 2), True, True), "swish": (F, (-2, 2), True, True),
    "softmax": (F, (-2, 2), True, True),
    "log_softmax": (F, (-2, 2), True, True),
}
for _n, (_m, (_lo, _hi), _g, _b) in _UNARY.items():
    _add(_n, _m, _p(lambda lo, hi: (x(lo=lo, hi=hi),), _lo, _hi),
         _p(lambda n, o, v: getattr(o, n)(v), _n), grad=_g, bf16=_b)

_add("softplus_", M, lambda: (x(),), lambda o, v: o.softplus_(v, beta=2.0),
     grad=True)
_add("polygamma", M, lambda: (x(lo=.5, hi=4),),
     lambda o, v: o.polygamma(v, 1))
_add("nan_to_num", M, lambda: (np.array([1.0, np.nan, np.inf, -np.inf],
                                        np.float32),),
     lambda o, v: o.nan_to_num(v, nan=0.5))
_add("clip", M, lambda: (x(),), lambda o, v: o.clip(v, -1.0, 1.0),
     grad=True, bf16=True)
_add("cast", M, lambda: (x(),), lambda o, v: o.cast(v, "int32"))
_add("cast", M, lambda: (x(),), lambda o, v: o.cast(v, "float64"),
     label="cast_float64")
_add("scale", M, lambda: (x(),), lambda o, v: o.scale(v, 2.0, bias=1.0),
     grad=True)
_add("scale", M, lambda: (x(),),
     lambda o, v: o.scale(v, 2.0, bias=1.0, bias_after_scale=False,
                          act="tanh"), label="scale_act")
_add("increment", M, lambda: (np.array([3.0], np.float32),),
     lambda o, v: o.increment(v))

# --- binary ---------------------------------------------------------------- #

_posx = _p(x, lo=0.5, hi=3.0)
_BINARY = {
    # name: (module, lhs, rhs, grad)
    "add": (M, x, _p(x, seed=1), True),
    "subtract": (M, x, _p(x, seed=1), True),
    "multiply": (M, x, _p(x, seed=1), True),
    "multiply_": (M, x, _p(x, seed=1), True),
    "divide": (M, x, _p(_posx, seed=1), True),
    "maximum": (M, x, _p(x, seed=1), True),
    "minimum": (M, x, _p(x, seed=1), True),
    "fmax": (M, x, _p(x, seed=1), True), "fmin": (M, x, _p(x, seed=1), True),
    "pow": (M, _posx, _p(x, seed=1, lo=-1.0, hi=2.0), True),
    "mod": (M, x, _p(_posx, seed=1), False),
    "remainder": (M, x, _p(_posx, seed=1), False),
    "floor_divide": (M, x, _p(_posx, seed=1), False),
    "atan2": (M, x, _p(x, seed=1), True),
    "heaviside": (M, x, _p(x, seed=1), False),
    "logaddexp": (M, x, _p(x, seed=1), True),
    "hypot": (M, x, _p(x, seed=1), True),
    "copysign": (M, x, _p(x, seed=1), False),
    "nextafter": (M, x, _p(x, seed=1), False),
    "gcd": (M, ints, _p(ints, seed=5), False),
    "lcm": (M, ints, _p(ints, seed=5), False),
    "logical_and": (M, bools, _p(bools, seed=5), False),
    "logical_or": (M, bools, _p(bools, seed=5), False),
    "logical_xor": (M, bools, _p(bools, seed=5), False),
    "bitwise_and": (M, ints, _p(ints, seed=5), False),
    "bitwise_or": (M, ints, _p(ints, seed=5), False),
    "bitwise_xor": (M, ints, _p(ints, seed=5), False),
    "left_shift": (M, ints, _p(ints, seed=5, lo=0, hi=4), False),
    "right_shift": (M, ints, _p(ints, seed=5, lo=0, hi=4), False),
    "equal": (M, ints, _p(ints, seed=5), False),
    "not_equal": (M, ints, _p(ints, seed=5), False),
    "greater_equal": (M, x, _p(x, seed=1), False),
    "greater_than": (M, x, _p(x, seed=1), False),
    "less_equal": (M, x, _p(x, seed=1), False),
    "less_than": (M, x, _p(x, seed=1), False),
    "kron": (M, _p(x, (2, 3)), _p(x, (3, 2), seed=1), True),
    "cross": (M, _p(x, (4, 3)), _p(x, (4, 3), seed=1), True),
    "dot": (M, _p(x, (5,)), _p(x, (5,), seed=1), True),
    "inner": (M, _p(x, (5,)), _p(x, (5,), seed=1), True),
    "outer": (M, _p(x, (3,)), _p(x, (4,), seed=1), True),
    "isclose": (M, x, x, False),
    "allclose": (M, x, x, False),
    "equal_all": (M, x, x, False),
    "matmul": (M, x, _p(x, (4, 2), seed=1), True),
    "mm": (M, x, _p(x, (4, 2), seed=1), True),
    "bmm": (M, _p(x, (2, 3, 4)), _p(x, (2, 4, 5), seed=1), True),
    "mv": (E, x, _p(x, (4,), seed=1), True),
    "dist": (E, x, _p(x, seed=1), True),
}
for _n, (_m, _l, _r, _g) in _BINARY.items():
    _add(_n, _m, _p(lambda l, r: (l(), r()), _l, _r),
         _p(lambda n, o, u, v: getattr(o, n)(u, v), _n), grad=_g,
         bf16=_g and _m != E)
_add("logical_not", M, lambda: (bools(),), lambda o, v: o.logical_not(v))
_add("bitwise_not", M, lambda: (ints(),), lambda o, v: o.bitwise_not(v))
_add("add", M, lambda: (x(),), lambda o, v: o.add(v, 2.0), label="add_scalar")
_add("add", M, lambda: (ints(),), lambda o, v: o.add(v, 2.5),
     label="add_int_float")
_add("divide", M, lambda: (ints(), ints(seed=5)), lambda o, u, v: o.divide(u, v),
     label="divide_int")
_add("ldexp", M, lambda: (x(), ints(lo=-2, hi=3)),
     lambda o, u, v: o.ldexp(u, v))
_add("matmul", M, lambda: (x((4, 3)), x((4, 2), seed=1)),
     lambda o, u, v: o.matmul(u, v, transpose_x=True), label="matmul_tx")
_add("dot", M, lambda: (x(), x(seed=1)), lambda o, u, v: o.dot(u, v),
     label="dot_2d")
_add("addmm", M, lambda: (x((3, 2), seed=2), x(), x((4, 2), seed=1)),
     lambda o, i, u, v: o.addmm(i, u, v, beta=0.5, alpha=2.0), grad=True)
_add("lerp", M, lambda: (x(), x(seed=1)), lambda o, u, v: o.lerp(u, v, 0.3),
     grad=True)

# --- reductions ------------------------------------------------------------ #

_REDUCE = {
    # name: (module, inputs, kwargs list, grad)
    "sum": (M, x, [{}, {"axis": 0}, {"axis": 1, "keepdim": True}], True),
    "mean": (M, x, [{}, {"axis": 0}, {"axis": [0, 1]}], True),
    "max": (M, x, [{}, {"axis": 1}], True),
    "min": (M, x, [{}, {"axis": 0}], True),
    "amax": (M, x, [{}, {"axis": 1}], True),
    "amin": (M, x, [{}, {"axis": 0}], True),
    "prod": (M, _p(x, lo=0.5, hi=1.5), [{}, {"axis": 1}], True),
    "std": (M, x, [{}, {"axis": 0}], True),
    "var": (M, x, [{}, {"axis": 0, "unbiased": False}], True),
    "nansum": (M, x, [{}], True),
    "nanmean": (M, x, [{}], True),
    "logsumexp": (M, x, [{}, {"axis": 1}], True),
    "all": (M, bools, [{}, {"axis": 0}], False),
    "any": (M, bools, [{}, {"axis": 1}], False),
    "median": (M, _p(x, (3, 5)), [{}, {"axis": 1}], False),
    "nanmedian": (M, _p(x, (3, 5)), [{}, {"axis": 0}], False),
    "numel": (MA, x, [{}], False),
    "count_nonzero": (M, ints, [{}, {"axis": 0}], False),
    "cumsum": (M, x, [{"axis": 1}, {}], True),
    "cumprod": (M, x, [{"dim": 1}], True),
    "cummax": (M, x, [{"axis": 1}, {}], False),
    "cummin": (M, x, [{"axis": 0}], False),
    "logcumsumexp": (M, x, [{"axis": 1}], False),
}
for _n, (_m, _b, _kws, _g) in _REDUCE.items():
    for _i, _kw in enumerate(_kws):
        _add(_n, _m, _p(lambda b: (b(),), _b),
             _p(lambda n, kw, o, v: getattr(o, n)(v, **kw), _n, _kw),
             grad=_g and _i == 0, bf16=_g and _i == 0 and _n != "prod",
             label=_n if _i == 0 else f"{_n}_{_i}")
_add("sum", M, lambda: (ints(),), lambda o, v: o.sum(v), label="sum_int")
_add("sum", M, lambda: (bools(),), lambda o, v: o.sum(v), label="sum_bool")
_add("mean", M, lambda: (ints(),), lambda o, v: o.mean(v), label="mean_int")
_add("cumsum", M, lambda: (ints(),), lambda o, v: o.cumsum(v, axis=0),
     label="cumsum_int")
_add("median", M, lambda: (x((4, 4)),), lambda o, v: o.median(v, axis=0),
     label="median_even")
_add("quantile", M, lambda: (x(),), lambda o, v: o.quantile(v, 0.5))
_add("quantile", M, lambda: (x((3, 5)), np.array([0.1, 0.75], np.float32)),
     lambda o, v, q: o.quantile(v, q, axis=1, keepdim=True),
     label="quantile_q_axis")
_add("nanquantile", E, lambda: (np.where(bools((3, 5)), x((3, 5)),
                                         np.nan).astype(np.float32),),
     lambda o, v: o.nanquantile(v, 0.3, axis=1))

# --- creation -------------------------------------------------------------- #

_add("zeros_like", C, lambda: (x(),), lambda o, v: o.zeros_like(v))
_add("ones_like", C, lambda: (x(),), lambda o, v: o.ones_like(v, "int32"))
_add("full_like", C, lambda: (x(),), lambda o, v: o.full_like(v, 7.0))
_add("empty_like", C, lambda: (x(),), lambda o, v: o.empty_like(v))
_add("empty", C, lambda: (), lambda o: o.empty([2, 3]))
_add("zeros", C, lambda: (), lambda o: o.zeros([2, 3], "int64"))
_add("ones", C, lambda: (), lambda o: o.ones((2,)))
_add("full", C, lambda: (), lambda o: o.full([2, 3], 7.0))
_add("full", C, lambda: (), lambda o: o.full([2, 3], 7), label="full_int")
_add("eye", C, lambda: (), lambda o: o.eye(3, 4))
_add("arange", C, lambda: (), lambda o: o.arange(2, 10, 2))
_add("arange", C, lambda: (), lambda o: o.arange(0.0, 1.0, 0.25),
     label="arange_float")
_add("linspace", C, lambda: (), lambda o: o.linspace(0.0, 1.0, 5))
_add("logspace", C, lambda: (), lambda o: o.logspace(0.0, 2.0, 5))
_add("diag", C, lambda: (x((4,)),), lambda o, v: o.diag(v))
_add("diag", C, lambda: (x((4,)),),
     lambda o, v: o.diag(v, offset=1, padding_value=9.0), label="diag_pad")
_add("diag", C, lambda: (x((4, 4)),), lambda o, v: o.diag(v, -1),
     label="diag_2d")
_add("diagflat", C, lambda: (x((2, 2)),), lambda o, v: o.diagflat(v, 1))
_add("tril", C, lambda: (x(),), lambda o, v: o.tril(v, 1))
_add("triu", C, lambda: (x(),), lambda o, v: o.triu(v, -1))
_add("tril_indices", C, lambda: (), lambda o: o.tril_indices(4, 3, 1))
_add("triu_indices", C, lambda: (), lambda o: o.triu_indices(3))
_add("meshgrid", C, lambda: (x((3,)), x((4,), seed=1)),
     lambda o, u, v: o.meshgrid(u, v))
_add("one_hot", C, lambda: (np.array([0, 2, 1, 5], np.int32),),
     lambda o, v: o.one_hot(v, 3))
_add("assign", C, lambda: (x(),), lambda o, v: o.assign(v))
_add("clone", C, lambda: (x(),), lambda o, v: o.clone(v))
_add("complex", C, lambda: (x(), x(seed=1)), lambda o, u, v: o.complex(u, v))
_add("to_tensor", C, lambda: (np.arange(6.0).reshape(2, 3),),
     lambda o, v: o.to_tensor(o.tolist(v)))

# --- manipulation ---------------------------------------------------------- #

_I = lambda *v: np.asarray(v, np.int32)
_MANIP = [
    ("reshape", lambda: (x(),), lambda o, v: o.reshape(v, [4, 3]), True),
    ("transpose", lambda: (x(),), lambda o, v: o.transpose(v, [1, 0]), True),
    ("squeeze", lambda: (x((3, 1, 4)),), lambda o, v: o.squeeze(v), True),
    ("squeeze", lambda: (x((3, 1, 4)),), lambda o, v: o.squeeze(v, [0, 1]),
     False),
    ("unsqueeze", lambda: (x(),), lambda o, v: o.unsqueeze(v, [0, -1]), True),
    ("flatten", lambda: (x((2, 3, 4)),), lambda o, v: o.flatten(v, 1), True),
    ("flip", lambda: (x(),), lambda o, v: o.flip(v, axis=0), True),
    ("roll", lambda: (x(),), lambda o, v: o.roll(v, 2, axis=1), True),
    ("rot90", lambda: (x(),), lambda o, v: o.rot90(v), True),
    ("tile", lambda: (x(),), lambda o, v: o.tile(v, [2, 1]), True),
    ("expand", lambda: (x((1, 4)),), lambda o, v: o.expand(v, [3, -1]), True),
    ("expand_as", lambda: (x((1, 4)), x()), lambda o, v, w: o.expand_as(v, w),
     True),
    ("broadcast_to", lambda: (x((1, 4)),),
     lambda o, v: o.broadcast_to(v, [3, 4]), True),
    ("concat", lambda: (x(), x(seed=1)), lambda o, u, v: o.concat([u, v], 1),
     True),
    ("stack", lambda: (x(), x(seed=1)), lambda o, u, v: o.stack([u, v], 0),
     True),
    ("split", lambda: (x(),), lambda o, v: o.split(v, 2, axis=1), True),
    ("split", lambda: (x((3, 6)),), lambda o, v: o.split(v, [1, -1, 2], 1),
     False),
    ("chunk", lambda: (x((3, 5)),), lambda o, v: o.chunk(v, 2, axis=1), True),
    ("unbind", lambda: (x(),), lambda o, v: o.unbind(v, axis=0), True),
    ("unstack", lambda: (x(),), lambda o, v: o.unstack(v, axis=1), False),
    ("gather", lambda: (x(), _I(2, 0)), lambda o, v, i: o.gather(v, i, 0),
     True),
    ("gather_nd", lambda: (x(), _I([1, 2], [0, 3])),
     lambda o, v, i: o.gather_nd(v, i), True),
    ("index_select", lambda: (x(), _I(2, 0)),
     lambda o, v, i: o.index_select(v, i, axis=0), True),
    ("index_select", lambda: (x(), _I([3, 0], [1, 1])),
     lambda o, v, i: o.index_select(v, i, axis=1), False),
    ("masked_select", lambda: (x(), x() > 0),
     lambda o, v, m: o.masked_select(v, m), False),
    ("masked_fill", lambda: (x(), x(seed=1) > 0),
     lambda o, v, m: o.masked_fill(v, m, 5.0), True),
    ("nonzero", lambda: (x() > 0,), lambda o, v: o.nonzero(v), False),
    ("nonzero", lambda: (x() > 0,), lambda o, v: o.nonzero(v, as_tuple=True),
     False),
    ("where", lambda: (x() > 0, x(), x(seed=1)),
     lambda o, c, u, v: o.where(c, u, v), False),
    ("where", lambda: (x() > 0,), lambda o, c: o.where(c), False),
    ("take_along_axis", lambda: (x(), _I([1], [2], [0])),
     lambda o, v, i: o.take_along_axis(v, i, 1), True),
    ("put_along_axis", lambda: (x(), _I([1], [2], [0]), np.full(
        (3, 1), 9.0, np.float32)),
     lambda o, v, i, u: o.put_along_axis(v, i, u, 1), True),
    ("put_along_axis", lambda: (x(), _I([1], [2], [0]), np.full(
        (3, 1), 2.0, np.float32)),
     lambda o, v, i, u: o.put_along_axis(v, i, u, 1, reduce="multiply"),
     False),
    ("pad", lambda: (x(),), lambda o, v: o.pad(v, [1, 1, 0, 2]), True),
    ("pad", lambda: (x((1, 2, 3, 4)),),
     lambda o, v: o.pad(v, [2, 1, 1, 2], mode="reflect"), False),
    ("pad", lambda: (x((1, 2, 3, 4)),),
     lambda o, v: o.pad(v, [1, 2], mode="replicate"), False),
    ("pad", lambda: (x((1, 2, 3, 4)),),
     lambda o, v: o.pad(v, [3, 1, 1, 0], mode="circular"), False),
    ("pad", lambda: (x((1, 3, 4, 2)),),
     lambda o, v: o.pad(v, [1, 1, 2, 0], value=-1.0, data_format="NHWC"),
     False),
    ("slice", lambda: (x(),),
     lambda o, v: o.slice(v, axes=[0, 1], starts=[1, 0], ends=[3, 2]), True),
    ("strided_slice", lambda: (x(),),
     lambda o, v: o.strided_slice(v, axes=[1], starts=[0], ends=[4],
                                  strides=[2]), True),
    ("strided_slice", lambda: (x(),),
     lambda o, v: o.strided_slice(v, axes=[1], starts=[3], ends=[0],
                                  strides=[-2]), False),
    ("crop", lambda: (x(),), lambda o, v: o.crop(v, [2, 2], [1, 1]), False),
    ("moveaxis", lambda: (x((2, 3, 4)),), lambda o, v: o.moveaxis(v, 0, 2),
     True),
    ("swapaxes", lambda: (x((2, 3, 4)),), lambda o, v: o.swapaxes(v, 0, 2),
     False),
    ("repeat_interleave", lambda: (x(),),
     lambda o, v: o.repeat_interleave(v, 2, axis=0), True),
    ("diagonal", lambda: (x(),), lambda o, v: o.diagonal(v), True),
    ("trace", lambda: (x(),), lambda o, v: o.trace(v), True),
    ("trace", lambda: (ints((3, 3)),), lambda o, v: o.trace(v), False),
    ("scatter", lambda: (x(), _I(1, 0), x((2, 4), seed=1)),
     lambda o, v, i, u: o.scatter(v, i, u, overwrite=True), True),
    ("scatter", lambda: (x(), _I(1, 1), x((2, 4), seed=1)),
     lambda o, v, i, u: o.scatter(v, i, u, overwrite=False), False),
    ("scatter_nd_add", lambda: (x((5,)), _I([1], [1]), x((2,), seed=1)),
     lambda o, v, i, u: o.scatter_nd_add(v, i, u), True),
    ("index_add", lambda: (x(), _I(2, 0, 2), x((3, 3), seed=1)),
     lambda o, v, i, u: o.index_add(v, i, 1, u), False),
    ("index_put", lambda: (x(), _I(0, 2), _I(1, 3)),
     lambda o, v, i, j: o.index_put(v, (i, j), 9.0), False),
    ("argmax", lambda: (x(),), lambda o, v: o.argmax(v, axis=1), False),
    ("argmax", lambda: (x(),), lambda o, v: o.argmax(v, keepdim=True), False),
    ("argmin", lambda: (x(),), lambda o, v: o.argmin(v, axis=0), False),
    ("argsort", lambda: (x(),), lambda o, v: o.argsort(v, axis=1), False),
    ("argsort", lambda: (x(),),
     lambda o, v: o.argsort(v, axis=0, descending=True), False),
    ("sort", lambda: (x(),), lambda o, v: o.sort(v, axis=1), True),
    ("sort", lambda: (x(),), lambda o, v: o.sort(v, descending=True), False),
    ("topk", lambda: (x(),), lambda o, v: o.topk(v, 2, axis=1), True),
    ("topk", lambda: (x(),), lambda o, v: o.topk(v, 2, axis=0, largest=False),
     False),
    ("kthvalue", lambda: (x(),), lambda o, v: o.kthvalue(v, 2, axis=1),
     False),
    ("mode", lambda: (np.array([[1.0, 1.0, 2.0], [3.0, 2.0, 2.0],
                                [5.0, 4.0, 6.0]], np.float32),),
     lambda o, v: o.mode(v), False),
    ("searchsorted", lambda: (np.array([1.0, 3.0, 5.0], np.float32),
                              np.array([2.0, 3.0, 6.0], np.float32)),
     lambda o, s, v: o.searchsorted(s, v), False),
    ("searchsorted", lambda: (np.array([1.0, 3.0, 5.0], np.float32),
                              np.array([2.0, 3.0, 6.0], np.float32)),
     lambda o, s, v: o.searchsorted(s, v, right=True), False),
    ("bucketize", lambda: (x(), np.array([-1.0, 0.0, 1.0], np.float32)),
     lambda o, v, s: o.bucketize(v, s), False),
    ("unique", lambda: (np.array([3.0, 1.0, 3.0, 2.0], np.float32),),
     lambda o, v: o.unique(v), False),
    ("unique", lambda: (np.array([[3, 1, 3], [2, 1, 7]], np.int32),),
     lambda o, v: o.unique(v, return_index=True, return_inverse=True,
                           return_counts=True), False),
    ("unique_consecutive", lambda: (np.array([1.0, 1.0, 2.0, 1.0],
                                             np.float32),),
     lambda o, v: o.unique_consecutive(v, return_inverse=True,
                                       return_counts=True), False),
    ("as_complex", lambda: (x((3, 2)),), lambda o, v: o.as_complex(v), False),
    ("as_real", lambda: (x((3, 2)),),
     lambda o, v: o.as_real(o.as_complex(v)), False),
    ("view", lambda: (x(),), lambda o, v: o.view(v, [2, 6]), False),
    ("view", lambda: (x(),), lambda o, v: o.view(v, "int32"), False),
    ("view_as", lambda: (x(), x((6, 2))), lambda o, v, w: o.view_as(v, w),
     False),
    ("unfold", lambda: (np.arange(6.0, dtype=np.float32),),
     lambda o, v: o.unfold(v, 0, 3, 2), False),
    ("shard_index", lambda: (_I(1, 5, 9),),
     lambda o, v: o.shard_index(v, 10, 2, 0, -1), False),
    ("tensordot", lambda: (x(), x((4, 2), seed=1)),
     lambda o, u, v: o.tensordot(u, v, axes=1), True),
    ("shape", lambda: (x(),), lambda o, v: o.shape(v), False),
    ("rank", lambda: (x(),), lambda o, v: o.rank(v), False),
    ("is_tensor", lambda: (x(),), lambda o, v: o.is_tensor(v), False),
    ("tolist", lambda: (x(),), lambda o, v: o.tolist(v), False),
    ("item", lambda: (x((1,)),), lambda o, v: o.item(v), False),
    ("atleast_1d", lambda: (np.float32(2.0),), lambda o, v: o.atleast_1d(v),
     False),
    ("atleast_2d", lambda: (x((3,)),), lambda o, v: o.atleast_2d(v), False),
    ("atleast_3d", lambda: (x(),), lambda o, v: o.atleast_3d(v), False),
    ("vstack", lambda: (x(), x(seed=1)), lambda o, u, v: o.vstack([u, v]),
     False),
    ("hstack", lambda: (x(), x(seed=1)), lambda o, u, v: o.hstack([u, v]),
     False),
    ("dstack", lambda: (x(), x(seed=1)), lambda o, u, v: o.dstack([u, v]),
     False),
    ("column_stack", lambda: (x((3,)), x(seed=1)),
     lambda o, u, v: o.column_stack([u, v]), False),
    ("row_stack", lambda: (x(), x(seed=1)),
     lambda o, u, v: o.row_stack([u, v]), False),
    ("diff", lambda: (x(),), lambda o, v: o.diff(v, axis=1), True),
    ("diff", lambda: (x(),), lambda o, v: o.diff(v, n=2, axis=0, prepend=1.0),
     False),
    ("broadcast_shape", lambda: (), lambda o: o.broadcast_shape([1, 4], [3, 1]),
     False),
]
_MODULE_OF = {"diagonal": M, "trace": M, "diff": M, "broadcast_shape": M}
_seen: Dict[str, int] = {}
for _n, _in, _call, _g in _MANIP:
    _k = _seen[_n] = _seen.get(_n, -1) + 1
    _add(_n, _MODULE_OF.get(_n, MA), _in, _call, grad=_g, bf16=_g,
         label=_n if _k == 0 else f"{_n}_{_k}")

# --- linear algebra -------------------------------------------------------- #


def _recon_qr(o, v):
    q, r = o.qr(v)
    return o.matmul(q, r)


def _recon_svd(o, v):
    u, s, vh = o.svd(v)
    return o.matmul(o.multiply(u, o.unsqueeze(s, 0)), vh)


def _recon_eigh(o, v):
    w, vec = o.eigh(v)
    return o.matmul(o.multiply(vec, o.unsqueeze(w, 0)), o.t(vec))


def _recon_lu(o, v):
    lu, piv = o.lu(v)
    p, lo, up = o.lu_unpack(lu, piv)
    return o.matmul(p, o.matmul(lo, up))


_LT = LINALG_TOL
_LINALG = [
    ("norm", lambda: (x(),), lambda o, v: o.norm(v), True, TOL),
    ("norm", lambda: (x(),), lambda o, v: o.norm(v, p=1, axis=1), False, TOL),
    ("norm", lambda: (x(),), lambda o, v: o.norm(v, p=float("inf"), axis=0),
     False, TOL),
    ("norm", lambda: (x(),), lambda o, v: o.norm(v, p="nuc", axis=(0, 1)),
     False, _LT),
    ("vector_norm", lambda: (x(),), lambda o, v: o.vector_norm(v, p=3.0),
     False, TOL),
    ("matrix_norm", lambda: (x(),), lambda o, v: o.matrix_norm(v, p=1),
     False, TOL),
    ("cond", lambda: (spd(),), lambda o, v: o.cond(v), False, _LT),
    ("det", lambda: (spd(),), lambda o, v: o.det(v), False, _LT),
    ("slogdet", lambda: (spd(),), lambda o, v: o.slogdet(v), False, _LT),
    ("inv", lambda: (spd(),), lambda o, v: o.inv(v), False, _LT),
    ("pinv", lambda: (x((4, 3)),), lambda o, v: o.pinv(v), False, _LT),
    ("matrix_power", lambda: (spd(),), lambda o, v: o.matrix_power(v, 2),
     False, _LT),
    ("matrix_rank", lambda: (spd(),), lambda o, v: o.matrix_rank(v), False,
     TOL),
    ("svd", lambda: (x((4, 3)),), _recon_svd, False, _LT),
    ("qr", lambda: (x((4, 3)),), _recon_qr, False, _LT),
    ("lu", lambda: (spd(),), lambda o, v: o.lu(v), False, _LT),
    ("lu_unpack", lambda: (spd(),), _recon_lu, False, _LT),
    ("cholesky", lambda: (spd(),), lambda o, v: o.cholesky(v), False, _LT),
    ("cholesky", lambda: (spd(),), lambda o, v: o.cholesky(v, upper=True),
     False, _LT),
    ("cholesky_solve", lambda: (x((4, 2), seed=1),
                                np.linalg.cholesky(spd()).astype(np.float32)),
     lambda o, b, lo: o.cholesky_solve(b, lo, upper=False), False, _LT),
    ("triangular_solve", lambda: (np.tril(spd()), x((4, 2), seed=1)),
     lambda o, lo, b: o.triangular_solve(lo, b, upper=False), False, _LT),
    ("triangular_solve", lambda: (np.tril(spd()), x((4, 2), seed=1)),
     lambda o, lo, b: o.triangular_solve(lo, b, upper=False, transpose=True),
     False, _LT),
    ("solve", lambda: (spd(), x((4, 2), seed=1)),
     lambda o, u, v: o.solve(u, v), False, _LT),
    ("lstsq", lambda: (x((5, 3)), x((5, 2), seed=1)),
     lambda o, u, v: o.lstsq(u, v), False, _LT),
    ("eig", lambda: (sym(),),
     lambda o, v: o.sort(o.real(o.eig(v)[0])), False, _LT),
    ("eigvals", lambda: (sym(),),
     lambda o, v: o.sort(o.real(o.eigvals(v))), False, _LT),
    ("eigh", lambda: (sym(),), _recon_eigh, False, _LT),
    ("eigvalsh", lambda: (sym(),), lambda o, v: o.eigvalsh(v), False, _LT),
    ("multi_dot", lambda: (x(), x((4, 2), seed=1), x((2, 3), seed=2)),
     lambda o, u, v, w: o.multi_dot([u, v, w]), False, _LT),
    ("einsum", lambda: (x(), x((4, 2), seed=1)),
     lambda o, u, v: o.einsum("ij,jk->ik", u, v), True, TOL),
    ("corrcoef", lambda: (x(),), lambda o, v: o.corrcoef(v), False, _LT),
    ("cov", lambda: (x(),), lambda o, v: o.cov(v), False, TOL),
    ("cov", lambda: (x(),), lambda o, v: o.cov(v, rowvar=False, ddof=False),
     False, TOL),
    ("histogram", lambda: (x(),),
     lambda o, v: o.histogram(v, bins=5, min=-2.0, max=2.0), False, TOL),
    ("histogram", lambda: (x((40,)),), lambda o, v: o.histogram(v, bins=7),
     False, TOL),
    ("histogramdd", lambda: (x((30, 2)),),
     lambda o, v: o.histogramdd(v, bins=[3, 4]), False, TOL),
    ("bincount", lambda: (np.array([0, 2, 2, 3], np.int32),),
     lambda o, v: o.bincount(v), False, TOL),
    ("bincount", lambda: (np.array([0, 2, 2, 3], np.int32),
                          np.array([.5, 1., 2., 3.], np.float32)),
     lambda o, v, w: o.bincount(v, w, minlength=6), False, TOL),
    ("householder_product", lambda: (x((4, 3)), x((2,), seed=1)),
     lambda o, v, t: o.householder_product(v, t), False, _LT),
    ("pca_lowrank", lambda: (x((5, 4)),),
     lambda o, v: o.pca_lowrank(v, q=2)[1], False, _LT),
]
_seen = {}
for _n, _in, _call, _g, _tol in _LINALG:
    _k = _seen[_n] = _seen.get(_n, -1) + 1
    _add(_n, L if _n != "lu_unpack" else E, _in, _call, grad=_g, bf16=_g,
         tol=_tol, label=_n if _k == 0 else f"{_n}_{_k}")

# --- extras ---------------------------------------------------------------- #

_EXTRAS = [
    ("add_n", lambda: (x(), x(seed=1), x(seed=2)),
     lambda o, u, v, w: o.add_n([u, v, w])),
    ("broadcast_tensors", lambda: (x((1, 4)), x((3, 1), seed=1)),
     lambda o, u, v: o.broadcast_tensors([u, v])),
    ("index_sample", lambda: (x(), _I([1, 2], [0, 3], [2, 2])),
     lambda o, v, i: o.index_sample(v, i)),
    ("is_complex", lambda: (x(),), lambda o, v: o.is_complex(v)),
    ("is_floating_point", lambda: (x(),), lambda o, v: o.is_floating_point(v)),
    ("is_integer", lambda: (ints(),), lambda o, v: o.is_integer(v)),
    ("is_empty", lambda: (np.zeros((0,), np.float32),),
     lambda o, v: o.is_empty(v)),
    ("multiplex", lambda: (x(), x(seed=1), _I([0], [1], [0])),
     lambda o, u, v, i: o.multiplex([u, v], i)),
    ("scatter_nd", lambda: (_I([1], [3], [1]), x((3,), seed=1)),
     lambda o, i, u: o.scatter_nd(i, u, [5])),
    ("segment_sum", lambda: (x((5, 2)), _I(0, 0, 1, 3, 3)),
     lambda o, v, i: o.segment_sum(v, i)),
    ("segment_mean", lambda: (x((5, 2)), _I(0, 0, 1, 3, 3)),
     lambda o, v, i: o.segment_mean(v, i)),
    ("segment_max", lambda: (x((5, 2)), _I(0, 0, 1, 3, 3)),
     lambda o, v, i: o.segment_max(v, i)),
    ("segment_min", lambda: (x((5, 2)), _I(0, 0, 1, 3, 3)),
     lambda o, v, i: o.segment_min(v, i)),
    ("t", lambda: (x(),), lambda o, v: o.t(v)),
    ("graph_send_recv", lambda: (x((4, 3)), _I(0, 1, 2, 3, 0),
                                 _I(1, 2, 1, 0, 1)),
     lambda o, v, s, d: o.graph_send_recv(v, s, d)),
    ("graph_send_recv", lambda: (x((4, 3)), _I(0, 1, 2, 3, 0),
                                 _I(1, 2, 1, 0, 1)),
     lambda o, v, s, d: o.graph_send_recv(v, s, d, "mean", out_size=5)),
    ("graph_send_recv", lambda: (x((4, 3)), _I(0, 1, 2, 3, 0),
                                 _I(1, 2, 1, 0, 1)),
     lambda o, v, s, d: o.graph_send_recv(v, s, d, "max")),
    ("roi_align", lambda: (x((2, 3, 8, 8)), np.array(
        [[0.5, 1.0, 6.0, 5.5], [2.0, 0.0, 7.5, 7.0], [-1.0, 3.0, 4.0, 9.0]],
        np.float32), _I(1, 2)),
     lambda o, v, b, n: o.roi_align(v, b, n, output_size=2,
                                    spatial_scale=0.9, sampling_ratio=2)),
    ("roi_pool", lambda: (x((2, 3, 8, 8)), np.array(
        [[0.5, 1.0, 6.0, 5.5], [2.0, 0.0, 7.5, 7.0], [1.0, 3.0, 4.0, 6.0]],
        np.float32), _I(1, 2)),
     lambda o, v, b, n: o.roi_pool(v, b, n, output_size=(2, 3))),
    ("psroi_pool", lambda: (x((1, 8, 6, 6)), np.array(
        [[0.0, 0.0, 5.0, 5.0], [1.0, 2.0, 4.0, 5.0]], np.float32)),
     lambda o, v, b: o.psroi_pool(v, b, output_size=2)),
    ("yolo_box", lambda: (x((2, 2 * 8, 3, 3)), np.array([[96, 96], [64, 80]],
                                                        np.int32)),
     lambda o, v, s: o.yolo_box(v, s, [10, 13, 16, 30], 3, 0.3, 32)),
    ("yolo_box", lambda: (x((1, 2 * 9, 3, 3)), np.array([[96, 96]],
                                                        np.int32)),
     lambda o, v, s: o.yolo_box(v, s, [10, 13, 16, 30], 3, 0.3, 32,
                                iou_aware=True)),
    ("deformable_conv", lambda: (x((2, 4, 5, 5)), x((2, 2 * 2 * 9, 5, 5),
                                                    seed=1, lo=-1, hi=1),
                                 x((6, 2, 3, 3), seed=2)),
     lambda o, v, off, w: o.deformable_conv(v, off, w, padding=1,
                                            deformable_groups=2, groups=2)),
    ("deformable_conv", lambda: (x((1, 2, 5, 5)), x((1, 18, 3, 3), seed=1),
                                 x((3, 2, 3, 3), seed=2),
                                 x((1, 9, 3, 3), seed=3, lo=0, hi=1),
                                 x((3,), seed=4)),
     lambda o, v, off, w, m, b: o.deformable_conv(v, off, w, b, stride=2,
                                                  padding=1, mask=m)),
]
_seen = {}
for _n, _in, _call in _EXTRAS:
    _k = _seen[_n] = _seen.get(_n, -1) + 1
    _add(_n, E, _in, _call, label=_n if _k == 0 else f"{_n}_{_k}",
         tol=LINALG_TOL if _n in ("roi_align", "deformable_conv") else TOL)

# --- the registry's nn.functional ops ------------------------------------- #

_FUNCTIONAL = [
    ("prelu", lambda: (x(), np.array([0.25], np.float32)),
     lambda o, v, w: o.prelu(v, w, data_format="NC")),
    ("maxout", lambda: (x((1, 4, 2, 2)),), lambda o, v: o.maxout(v, 2)),
    ("nll_loss", lambda: (np.log(np.exp(x()) / np.exp(x()).sum(
        -1, keepdims=True)).astype(np.float32), _I(1, 0, 3)),
     lambda o, v, y: o.nll_loss(v, y)),
    ("log_loss", lambda: (np.array([[0.7], [0.2]], np.float32),
                          np.array([[1.0], [0.0]], np.float32)),
     lambda o, v, y: o.log_loss(v, y, epsilon=0.0)),
    ("huber_loss", lambda: (np.array([0.0, 3.0], np.float32),
                            np.array([0.5, 0.0], np.float32)),
     lambda o, v, y: o.huber_loss(v, y, delta=1.0)),
    ("label_smooth", lambda: (np.eye(4, dtype=np.float32),),
     lambda o, v: o.label_smooth(v, epsilon=0.1)),
    ("pixel_shuffle", lambda: (x((1, 8, 3, 3)),),
     lambda o, v: o.pixel_shuffle(v, 2)),
    ("pixel_shuffle", lambda: (x((1, 3, 3, 8)),),
     lambda o, v: o.pixel_shuffle(v, 2, data_format="NHWC")),
    ("layer_norm", lambda: (x((2, 3, 4)), x((4,), seed=1), x((4,), seed=2)),
     lambda o, v, w, b: o.layer_norm(v, 4, w, b)),
    ("batch_norm", lambda: (x((4, 3, 2, 2)), x((3,), seed=1),
                            x((3,), seed=2, lo=0.5, hi=2.0)),
     lambda o, v, m, s: o.batch_norm(v, m, s, training=True)),
    ("conv2d", lambda: (x((2, 4, 6, 6)), x((6, 2, 3, 3), seed=1)),
     lambda o, v, w: o.conv2d(v, w, stride=2, padding=[1, 0], groups=2)),
    ("conv2d_transpose", lambda: (x((2, 4, 5, 5)), x((4, 3, 3, 3), seed=1),
                                  x((3,), seed=2)),
     lambda o, v, w, b: o.conv2d_transpose(v, w, b, stride=2, padding=1,
                                           output_padding=1)),
    ("conv2d_transpose", lambda: (x((1, 4, 5, 4)), x((4, 1, 3, 2), seed=1)),
     lambda o, v, w: o.conv2d_transpose(v, w, stride=(2, 1),
                                        padding=[2, 0, 1, 1], groups=2,
                                        dilation=(1, 2))),
    ("conv2d_transpose", lambda: (x((1, 5, 5, 4)), x((4, 3, 3, 3), seed=1)),
     lambda o, v, w: o.conv2d_transpose(v, w, stride=2, padding="SAME",
                                        data_format="NHWC")),
    ("conv2d_transpose", lambda: (x((1, 4, 5, 5)), x((4, 3, 2, 2), seed=1)),
     lambda o, v, w: o.conv2d_transpose(v, w, stride=3, padding="VALID")),
    ("conv3d_transpose", lambda: (x((1, 2, 3, 4, 3)), x((2, 3, 2, 3, 2),
                                                        seed=1)),
     lambda o, v, w: o.conv3d_transpose(v, w, stride=2, padding=1,
                                        output_padding=1)),
    ("conv1d_transpose", lambda: (x((2, 3, 6)), x((3, 2, 4), seed=1)),
     lambda o, v, w: o.conv1d_transpose(v, w, stride=3, padding=[1, 2])),
    ("max_pool3d", lambda: (x((1, 2, 5, 4, 6)),),
     lambda o, v: o.max_pool3d(v, 2, stride=2, padding=1, ceil_mode=True)),
    ("avg_pool3d", lambda: (x((1, 2, 5, 4, 6)),),
     lambda o, v: o.avg_pool3d(v, (2, 2, 3), stride=(1, 2, 2), padding=1)),
    ("avg_pool3d", lambda: (x((1, 5, 4, 6, 2)),),
     lambda o, v: o.avg_pool3d(v, 2, exclusive=False, data_format="NDHWC")),
]
_seen = {}
for _n, _in, _call in _FUNCTIONAL:
    _k = _seen[_n] = _seen.get(_n, -1) + 1
    _add(_n, F, _in, _call, label=_n if _k == 0 else f"{_n}_{_k}",
         tol=LINALG_TOL if "conv" in _n else TOL,
         grad=_n in ("conv2d_transpose", "layer_norm") and _k == 0)

# the ops whose reference is the stateful or random path of `nn.functional`
# are in RANDOM below (dropout, gumbel_softmax)


# --------------------------------------------------------------------------- #
# random ops: reproducibility under seed, and the law
# --------------------------------------------------------------------------- #

class RandomCase:
    """`draw(o)` with the default generator; `law(arr)` is True when the
    numpy result follows the op's law within the stated bounds."""
    __slots__ = ("name", "module", "draw", "law")

    def __init__(self, name, module, draw, law):
        self.name, self.module, self.draw, self.law = name, module, draw, law

    def __repr__(self):
        return f"RandomCase({self.name})"


def _mean_var(arr, mean, var, tol_mean, tol_var):
    return (abs(float(arr.mean()) - mean) <= tol_mean
            and abs(float(arr.var()) - var) <= tol_var)


def _keyed(fn):
    """Run a draw that takes the step's key (`nn.rng`) under a key from
    the default generator."""
    def draw(o):
        from .. import core
        from ..nn import rng
        with rng.rng_context(core.default_generator().next_seed()):
            return fn(o)
    return draw


RANDOM: List[RandomCase] = [
    RandomCase("bernoulli", C, lambda o: o.bernoulli(o.full([4000], 0.3)),
               lambda r: set(np.unique(r)) <= {0.0, 1.0}
               and abs(r.mean() - 0.3) <= 0.03),
    RandomCase("multinomial", C, lambda o: o.multinomial(
        o.to_tensor(np.array([0.0, 1.0, 3.0], np.float32)), 4000,
        replacement=True),
        lambda r: set(np.unique(r)) <= {1, 2}
        and abs((r == 2).mean() - 0.75) <= 0.03),
    RandomCase("multinomial", C, lambda o: o.multinomial(
        o.to_tensor(np.array([1.0, 1.0, 0.0, 2.0], np.float32)), 3),
        lambda r: sorted(r.tolist()) == [0, 1, 3]),
    RandomCase("randint", C, lambda o: o.randint(0, 5, [4000]),
               lambda r: r.dtype == np.int32 and r.min() >= 0
               and r.max() <= 4 and abs(r.mean() - 2.0) <= 0.1),
    RandomCase("randperm", C, lambda o: o.randperm(10),
               lambda r: r.dtype == np.int32
               and sorted(r.tolist()) == list(range(10))),
    RandomCase("rand", C, lambda o: o.rand([4000]),
               lambda r: r.min() >= 0 and r.max() < 1
               and _mean_var(r, 0.5, 1 / 12, 0.02, 0.005)),
    RandomCase("randn", C, lambda o: o.randn([4000]),
               lambda r: _mean_var(r, 0.0, 1.0, 0.06, 0.08)),
    RandomCase("standard_normal", C, lambda o: o.standard_normal([4000]),
               lambda r: _mean_var(r, 0.0, 1.0, 0.06, 0.08)),
    RandomCase("uniform", C, lambda o: o.uniform([4000], min=2.0, max=4.0),
               lambda r: r.min() >= 2 and r.max() < 4
               and _mean_var(r, 3.0, 1 / 3, 0.04, 0.02)),
    RandomCase("normal", C, lambda o: o.normal(1.0, 2.0, [4000]),
               lambda r: _mean_var(r, 1.0, 4.0, 0.12, 0.32)),
    RandomCase("poisson", E, lambda o: o.poisson(o.full([4000], 4.0)),
               lambda r: _mean_var(r, 4.0, 4.0, 0.15, 0.4)),
    RandomCase("gumbel_softmax", F, _keyed(lambda o: o.gumbel_softmax(
        o.to_tensor(x((500, 4))))),
        lambda r: np.allclose(r.sum(-1), 1.0, atol=1e-5) and r.min() >= 0),
    RandomCase("dropout", F, _keyed(lambda o: o.dropout(
        o.ones([4000]), p=0.5, training=True)),
        lambda r: set(np.unique(r)) <= {0.0, 2.0}
        and abs((r == 0).mean() - 0.5) <= 0.03),
]


# --------------------------------------------------------------------------- #
# running a case on the port
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def on_device(device):
    """The port's default device set to `device` inside (restored on
    exit)."""
    from .. import core
    prev = core._current_device
    core.set_device(device)
    try:
        yield
    finally:
        core._current_device = prev


def port_namespace():
    from .. import ops
    from ..nn import functional
    return namespace(ops, functional)


def to_port(arg, device, dtype=None):
    """A case input as a port tensor on `device` (numpy arrays), or as
    it is (Python values)."""
    if isinstance(arg, np.ndarray):
        from ..ops import to_tensor
        t = to_tensor(arg, place=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t
    return arg


def leaves(res) -> list:
    """The tensors and Python values of a result, flattened."""
    if isinstance(res, (list, tuple)):
        return [v for r in res for v in leaves(r)]
    return [res]


class Run:
    """A case's result on the port: `values` (numpy), `dtypes` (names),
    `grad` (numpy, or None) and `devices` (the device types of the
    tensor leaves)."""
    __slots__ = ("values", "dtypes", "grad", "devices")

    def __init__(self, values, dtypes, grad, devices):
        self.values, self.dtypes = values, dtypes
        self.grad, self.devices = grad, devices


def port_run(case: Case, device, first_dtype=None, grad=False) -> Run:
    """`case` on the port at `device`; with `first_dtype` the first
    floating input is cast to it, with `grad` the gradient of
    sum(result) with respect to the first input is taken too."""
    import torch

    from .. import core
    o = port_namespace()
    first_dtype = None if first_dtype is None else core.resolve_dtype(
        first_dtype)
    with on_device(device):
        args = [to_port(v, device, first_dtype if i == 0 else None)
                for i, v in enumerate(case.inputs())]
        if grad:
            args[0] = args[0].detach().requires_grad_()
        res = leaves(case.call(o, *args))
        g = None
        if grad:
            total = sum(v.float().sum() for v in res
                        if isinstance(v, torch.Tensor)
                        and v.is_floating_point())
            g, = torch.autograd.grad(total, [args[0]])
            g = g.detach().cpu().float().numpy()
    return Run([to_numpy(v) for v in res], [dtype_name(v) for v in res], g,
               {v.device.type for v in res if isinstance(v, torch.Tensor)})


def dtype_name(v) -> str:
    """A result's dtype as numpy names it ("bfloat16" for bf16)."""
    import torch
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return np.asarray(v).dtype.name


def to_numpy(v):
    import torch
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.resolve_conj().numpy()
    return np.asarray(v)


def compare(got, want, rtol, atol, what=""):
    """Shape, then values within (rtol, atol), NaN equal to NaN; None
    when they agree, else the message."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return f"{what}: shape {got.shape} != {want.shape}"
    if got.dtype == bool or want.dtype == bool or got.dtype.kind in "iu":
        if not np.array_equal(got, want):
            return f"{what}: values differ"
        return None
    try:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   equal_nan=True)
    except AssertionError as e:
        return f"{what}: {str(e).strip().splitlines()[-3:]}"
    return None


# --------------------------------------------------------------------------- #
# phase 10a's main-path sizes (GPT-small: vocab 50304, width 768, bs 18 x
# 1024 tokens)
# --------------------------------------------------------------------------- #

VOCAB, WIDTH, TOKENS, ROWS = 50304, 768, 18 * 1024, 18


def main_path_cases(torch, device, seed: int = 0):
    """[(name, fn(o, *inputs), inputs on `device`, rtol, atol)] at the
    main path's sizes, inputs drawn on `device` from `seed`. Each runs
    on the card and, with the inputs copied, on the CPU."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dev = torch.device(device)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    logits = randn(TOKENS, VOCAB)
    last = randn(ROWS, VOCAB)
    table = randn(VOCAB, WIDTH)
    ids = torch.randint(0, VOCAB, (TOKENS,), generator=g, device=dev,
                        dtype=torch.int32)
    rows = torch.randperm(VOCAB, generator=g, device=dev)[:TOKENS].int()
    upd = randn(TOKENS, WIDTH)
    return [
        ("matmul 4096x4096", lambda o, u, v: o.matmul(u, v),
         (randn(4096, 4096), randn(4096, 4096)), 1e-4, 1e-3),
        ("logsumexp (18432, 50304)", lambda o, v: o.logsumexp(v, axis=-1),
         (logits,), 1e-5, 1e-5),
        ("log_softmax (18432, 50304)", lambda o, v: o.log_softmax(v),
         (logits,), 1e-5, 1e-5),
        ("softmax (18432, 50304)", lambda o, v: o.softmax(v),
         (logits,), 1e-5, 1e-9),
        ("topk 50 of (18, 50304)", lambda o, v: o.topk(v, 50), (last,),
         0, 0),
        ("sort (18, 50304)", lambda o, v: o.sort(v, axis=-1), (last,), 0, 0),
        ("argsort (18, 50304)", lambda o, v: o.argsort(v, axis=-1,
                                                       descending=True),
         (last,), 0, 0),
        ("gather 18432 rows of 50304 x 768", lambda o, t, i: o.gather(t, i),
         (table, ids), 0, 0),
        ("index_select 18432 rows of 50304 x 768",
         lambda o, t, i: o.index_select(t, i, axis=0), (table, ids), 0, 0),
        ("scatter 18432 distinct rows into 50304 x 768",
         lambda o, t, i, u: o.scatter(t, i, u), (table, rows, upd), 0, 0),
        ("cumsum over 1M", lambda o, v: o.cumsum(v),
         (randn(1 << 20),), 0, 2e-3),
    ]
