"""The port's dy2static against the JAX package's: `for range` loops
with break and continue (`tests/test_dy2static.py`'s TestBreakContinue;
its `while` cases and TestLoopTestShortCircuit are in
`test_torch_dy2static_while.py`, its TestForRangeStep in
`test_torch_dy2static.py`), through both packages' `jit.to_static` on
the same numpy inputs, within rtol 1e-6 (`dy2static_cases.same`). A
loop whose condition turns traced mid-way (a break flag set by a
traced comparison) is lowered to `while_loop` from the state its
unrolled iterations left."""
import numpy as np

from dy2static_cases import F32, same
from port_threads import one_torch_thread  # noqa: F401


class TestBreakContinue:
    def test_break_in_for(self):
        def f(x):
            total = x[0] * 0.0
            for i in range(8):
                if total > 6.0:
                    break
                total = total + x[i]
            return total
        same(f, (np.arange(8, dtype=np.float32),), traced=False)

    def test_continue_in_for(self):
        # a literal range whose test never turns traced is unrolled: one
        # torch.cond per `if` and iteration, so 4 iterations, not 8
        def f(x):
            total = x[0] * 0.0
            for i in range(4):
                if x[i] % 2.0 == 0.0:
                    continue
                total = total + x[i]
            return total
        same(f, (np.arange(4, dtype=np.float32),))

    def test_break_and_continue_mixed(self):
        def f(x):
            total = x[0] * 0.0
            count = 0
            for i in range(8):
                if x[i] < 0:
                    continue
                if total > 10.0:
                    break
                total = total + x[i]
                count = count + 1
            return total + count
        same(f, (F32([1.0, -2.0, 3.0, 4.0, -1.0, 5.0, 6.0, 7.0]),))

    def test_statements_after_break_guard(self):
        def f(x):
            hits = 0
            for i in range(6):
                if x[i] > 2.5:
                    break
                hits = hits + 1
            return hits
        same(f, (np.arange(6, dtype=np.float32),))

    def test_loop_var_after_break(self):
        def f(x):
            j = 0
            for i in range(10):
                j = i
                if x[i] > 3.0:
                    break
            return j
        same(f, (np.arange(10, dtype=np.float32),))
