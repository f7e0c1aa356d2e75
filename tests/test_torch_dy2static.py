"""The port's dy2static (`paddle_tpu_torch/jit/dy2static.py`) against
the JAX package's, case by case from `tests/test_dy2static.py`.

One Python function per case, written with operators both array types
take (`x[i]`, `x.sum()`, comparisons, arithmetic), goes through JAX's
`jit.to_static` (jax.jit of the converted function: `lax.cond` /
`lax.while_loop`) on jnp arrays and through the port's `jit.to_static`
(`torch.export` of the converted function: `torch.cond` /
`while_loop`) on tensors made from the same numpy inputs; the results
agree within rtol 1e-6 (fp32, the same operations in both), and the
port's program holds a `cond` / `while_loop` node where the condition
was traced. Cases that never trace (Python values) run the two
converters' functions directly and must agree exactly. Stepped ranges
are here (TestForRangeStep); loops with break / continue are in
`test_torch_dy2static_loops.py`; early returns in
`test_torch_dy2static_return.py`, their tails and the error
attribution in `test_torch_dy2static_tails.py` (`dy2static_cases`
holds the shared helpers).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import jit as jjit
from paddle_tpu.jit import dy2static as jd2s
from paddle_tpu_torch import jit as pjit
from paddle_tpu_torch.jit import dy2static as pd2s
from dy2static_cases import F32, python_path, same
from port_threads import one_torch_thread  # noqa: F401


class TestRuntimeHelpers:
    def test_ifelse_python_path(self):
        for conv in (jd2s.convert_ifelse, pd2s.convert_ifelse):
            assert conv(True, lambda s: (s[0] + 1,),
                        lambda s: (s[0] - 1,), (1,)) == (2,)
            assert conv(False, lambda s: (s[0] + 1,),
                        lambda s: (s[0] - 1,), (1,)) == (0,)
        # an eager tensor takes the Python path too
        assert pd2s.convert_ifelse(torch.tensor(True), lambda s: (1,),
                                   lambda s: (2,), (0,)) == (1,)

    def test_while_python_path(self):
        for conv in (jd2s.convert_while, pd2s.convert_while):
            assert conv(lambda s: s[0] < 5, lambda s: (s[0] + 1, s[1] * 2),
                        (0, 1)) == (5, 32)

    def test_traced_helpers(self):
        def f(x):
            conv = pd2s.convert_ifelse if isinstance(x, torch.Tensor) \
                else jd2s.convert_ifelse
            return conv(x > 0, lambda s: (s[0] * 2,),
                        lambda s: (s[0] - 1,), (x,))[0]
        same(f, (F32(3.0),), (F32(-3.0),))


class TestConversion:
    def test_if_over_traced_value(self):
        def f(x):
            if x.sum() > 0:
                y = x * 2
            else:
                y = x - 1
            return y
        same(f, (F32([1.0, 2.0]),), (F32([-1.0, -2.0]),))

    def test_elif_chain(self):
        def f(x):
            if x > 10:
                y = 1.0
            elif x > 0:
                y = 2.0
            else:
                y = 3.0
            return y
        same(f, (F32(20.0),), (F32(5.0),), (F32(-5.0),))

    def test_while_over_traced_value(self):
        def f(n):
            total = n * 0.0
            i = n * 0
            while i < n:
                total = total + i
                i = i + 1
            return total
        same(f, (np.int64(5),), (np.int64(8),))

    def test_for_range_traced_bound(self):
        def f(n, x):
            acc = x * 0.0
            for i in range(n):
                acc = acc + x * i
            return acc
        same(f, (np.int64(4), F32([1.0, 1.0])))

    def test_python_semantics_preserved_outside_capture(self):
        def f(flag, x):
            if flag:
                out = x + 1
            else:
                out = x - 1
            k = 0
            while k < 3:
                out = out * 2
                k += 1
            return out
        python_path(f, (True, 1.0), (False, 1.0))

    def test_read_modify_write_in_branch(self):
        def f(x):
            y = x * 1.0
            if x.sum() > 0:
                y = y + 1
            else:
                y = y - 1
            return y
        same(f, (F32([2.0]),), (F32([-2.0]),))

    def test_one_sided_if_python_path(self):
        def f(flag, x):
            y = x
            if flag:
                y = y * 10
            return y
        python_path(f, (True, 2.0), (False, 2.0))

    def test_uninitialized_traced_branch_raises(self):
        def g(x):
            if x.sum() > 0:
                w = x * 2
            return x
        with pytest.raises(jd2s.Dy2StaticError, match="initialized"):
            jjit.to_static(g)(jnp.ones(1))
        with pytest.raises(pd2s.Dy2StaticError, match="initialized"):
            pjit.to_static(g)(torch.ones(1))

    def test_for_loop_var_value_after_loop(self):
        def f(x):
            for i in range(3):
                x = x + 1
            return x * i
        python_path(f, (3.0,))

    def test_undefined_use_raises_on_python_path(self):
        def f(flag, x):
            if flag:
                y = x + 1
            return y * 2
        python_path(f, (True, 1.0))
        for conv in (jd2s, pd2s):
            with pytest.raises(conv.Dy2StaticError,
                               match="before assignment"):
                conv.convert_to_static(f)(False, 1.0)

    def test_empty_range_preserves_existing_binding(self):
        def f(n):
            i = 99
            for i in range(n):
                pass
            return i
        python_path(f, (0,), (3,))

    def test_wrapped_and_nonlocal_functions_left_alone(self):
        def deco(fn):
            @functools.wraps(fn)
            def inner(*a):
                return fn(*a)
            return inner

        @deco
        def f(x):
            if x > 0:
                y = 1.0
            else:
                y = -1.0
            return y

        assert pd2s.convert_to_static(f) is f

        def outer():
            count = 0

            def fwd(flag):
                nonlocal count
                count += 1
                if flag:
                    z = 1
                else:
                    z = 2
                return z
            return fwd

        h = outer()
        assert pd2s.convert_to_static(h) is h
        assert h(True) == 1

    def test_tuple_for_target_inside_branch(self):
        def f(flag, xs):
            y = 0.0
            i = -1
            if flag:
                for i, x in enumerate(xs):
                    y = y + x
            return y, i
        python_path(f, (True, [1.0, 2.0]), (False, [1.0, 2.0]))

    def test_for_range_inside_traced_branch(self):
        def f(flag, n, x):
            i = 0
            if flag:
                for i in range(n):
                    x = x + 1.0
            else:
                x = x - 1.0
            return x + 0.0 * i
        same(f, (np.bool_(True), np.int64(3), F32(0.0)),
             (np.bool_(False), np.int64(3), F32(0.0)))

    def test_undefined_equality_raises(self):
        def f(flag, x):
            if flag:
                y = 1
            if y == 1:
                return x
            return -x
        python_path(f, (True, 2.0))
        for conv in (jd2s, pd2s):
            with pytest.raises(conv.Dy2StaticError,
                               match="before assignment"):
                conv.convert_to_static(f)(False, 2.0)

    def test_early_exit_left_untouched(self):
        def f(xs):
            for x in xs:
                if x > 2:
                    return x
            return -1
        python_path(f, ([1, 5, 2],))


class TestForRangeStep:
    def test_positive_step_traced_values(self):
        def f(x):
            acc = x[0] * 0.0
            for i in range(0, 8, 2):
                acc = acc + x[i]
            return acc + i
        same(f, (np.arange(8, dtype=np.float32),), traced=False)

    def test_negative_step(self):
        def f(x):
            acc = x[0] * 0.0
            for i in range(7, -1, -2):
                acc = acc * 2.0 + x[i]
            return acc
        same(f, (np.arange(8, dtype=np.float32),), traced=False)

    def test_step_with_break(self):
        def f(x):
            total = x[0] * 0.0
            for i in range(0, 16, 3):
                if total > 5.0:
                    break
                total = total + x[i]
            return total
        same(f, (np.arange(16, dtype=np.float32),))

    def test_dynamic_step_left_python(self):
        def f(n, s):
            acc = 0
            for i in range(0, n, s):
                acc += i
            return acc
        python_path(f, (10, 3))

    def test_empty_stepped_range(self):
        def f(n):
            i = 42
            for i in range(5, n, 2):
                pass
            return i
        python_path(f, (5,), (10,))

    def test_unary_plus_step_converts(self):
        def f(x, n):
            acc = x[0] * 0.0
            for i in range(0, n, +2):
                acc = acc + x[i]
            return acc
        same(f, (np.arange(8, dtype=np.float32), np.int64(8)))


def test_to_static_integration_decorator():
    @pjit.to_static
    def f(x):
        if x.sum() > 0:
            y = x * 10
        else:
            y = -x
        return y

    x = torch.tensor([1.0, -0.5])
    torch.testing.assert_close(f(x), torch.tensor([10.0, -5.0]))
    torch.testing.assert_close(f(-x), torch.tensor([1.0, -0.5]))
    assert len(f._programs) == 1          # one signature, one program


def test_traced_index_reads_rows():
    """`x[i]` with a traced index is `index_select`; a negative index
    counts from the end, as jnp's dynamic index."""
    def f(x, i):
        return x[i] * 1.0
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    same(f, (x, np.int64(2)), (x, np.int64(-1)), traced=False)


def test_weak_int_carry_made_float_raises():
    """A carry that begins as a Python int and becomes a float in a
    traced loop is refused (JAX promotes it; the port asks for a float
    start)."""
    def f(n, x):
        acc = 0
        i = n * 0
        while i < n:
            acc = acc + x
            i = i + 1
        return acc
    with pytest.raises(pd2s.Dy2StaticError, match="initialize it"):
        pjit.to_static(f)(torch.tensor(3), torch.tensor(0.5))
