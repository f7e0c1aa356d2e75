"""The port's dy2static against the JAX package's: `while` loops with
break and continue (`tests/test_dy2static.py`'s TestBreakContinue,
its `while` cases, and TestLoopTestShortCircuit), through both
packages' `jit.to_static` on the same numpy inputs within rtol 1e-6
(`dy2static_cases.same`), or both converters on Python values,
exactly: a loop entered on a traced condition, or whose break flag
turns traced, becomes a `while_loop`; after a concrete `break` the
loop's test is not evaluated again, and a side-effecting test runs as
often as in Python."""
import numpy as np

from paddle_tpu.jit import dy2static as jd2s
from paddle_tpu_torch.jit import dy2static as pd2s
from dy2static_cases import F32, python_path, same
from port_threads import one_torch_thread  # noqa: F401


class TestBreakContinue:
    def test_break_in_while(self):
        def f(x):
            i = 0
            s = x * 0.0
            while i < 100:
                s = s + x * i
                if s.sum() > 20.0:
                    break
                i = i + 1
            return s
        same(f, (np.ones(3, np.float32),))

    def test_continue_in_traced_entry_while(self):
        def g(x):
            while x.sum() > 0:
                if x[0] > 5.0:
                    x = x - 2.0
                    continue
                x = x - 1.0
            return x
        same(g, (F32([3.0, 1.0]),), (F32([8.0, 0.0]),))

    def test_condition_not_reevaluated_after_break(self):
        def f(x):
            i = 0
            while x[i] > 0:
                i = i + 1
                if i == len(x):
                    break
            return i
        python_path(f, ([1, 2, 3],))

    def test_side_effecting_condition_eval_count(self):
        calls = []

        def f(limit):
            i = 0
            while (calls.append(1) or True) and i < limit:
                i = i + 1
                if i >= 2:
                    break
            return i
        for conv in (jd2s, pd2s):
            calls.clear()
            want = f(5)
            n_want = len(calls)
            calls.clear()
            assert conv.convert_to_static(f)(5) == want
            assert len(calls) == n_want
