"""The port's dy2static against the JAX package's: early returns inside
loops and branches (`tests/test_dy2static.py`'s TestEarlyReturn, its
first cases; the tails, the review regressions and the error
attribution are in `test_torch_dy2static_tails.py`): per-site flags,
the rest of the function as a tail, and `select_return` merging them
(by `torch.where` once a flag is traced), through both packages'
`jit.to_static` on the same numpy inputs within rtol 1e-6
(`dy2static_cases.same`)."""
import numpy as np

from dy2static_cases import F32, same
from port_threads import one_torch_thread  # noqa: F401


class TestEarlyReturn:
    def test_return_in_loop(self):
        def f(x):
            total = x[0] * 0.0
            for i in range(8):
                total = total + x[i]
                if total > 5.0:
                    return total
            return total - 1.0
        same(f, (np.arange(8, dtype=np.float32),),
             (np.zeros(8, np.float32),))

    def test_return_in_branch(self):
        def f(x):
            if x.sum() > 0:
                return x * 2.0
            return x - 1.0
        same(f, (np.ones(3, np.float32),), (-np.ones(3, np.float32),))

    def test_return_in_nested_loop(self):
        def f(x):
            acc = x[0, 0] * 0.0
            for i in range(3):
                for j in range(3):
                    acc = acc + x[i, j]
                    if acc > 7.0:
                        return acc
            return acc * 0.5
        same(f, (np.arange(9, dtype=np.float32).reshape(3, 3),),
             (np.zeros((3, 3), np.float32),))

    def test_multiple_return_sites(self):
        def f(x):
            for i in range(4):
                if x[i] > 10.0:
                    return x[i] * 2.0
                if x[i] < -10.0:
                    return x[i] * -1.0
            return x.sum()
        same(f, (F32([0.0, 20.0, 1.0, 1.0]),),
             (F32([0.0, -20.0, 1.0, 1.0]),), (np.ones(4, np.float32),))
