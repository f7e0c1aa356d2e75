"""The port's dy2static against the JAX package's: early returns whose
tail rebinds the function's names (`nonlocal` / `global` in the tail
closure, the replayed return expressions reading the values from
before the tail), the review regressions and the error attribution
(`tests/test_dy2static.py`'s TestEarlyReturn, TestReturnReviewRegressions
and TestErrorSourceMapping), through both packages' `jit.to_static` on
the same numpy inputs within rtol 1e-6 (`dy2static_cases.same`). The
error cases raise in both: a capture-time failure inside converted
code names the user's file and line, and a traced condition that
reaches Python control flow the converter left alone raises
`Dy2StaticError` with the framework's message."""
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import jit as jjit
from paddle_tpu.jit import dy2static as jd2s
from paddle_tpu_torch import jit as pjit
from paddle_tpu_torch.jit import dy2static as pd2s
from dy2static_cases import F32, same
from port_threads import one_torch_thread  # noqa: F401

_G_FOR_DY2S_TEST = 2.0  # module global for the `global`-in-tail test


class TestTails:
    def test_return_none_function_still_works(self):
        def f(x):
            y = x + 1
            return y
        assert pd2s.convert_to_static(f) is f

    def test_tail_rebinds_param(self):
        def f(x):
            if x.sum() > 10.0:
                return x * 2.0
            x = x + 1.0
            return x
        same(f, (np.ones(3, np.float32),), (np.full(3, 10.0, np.float32),))

    def test_tail_augassign_rebinds_local_after_loop(self):
        def f(x):
            total = x[0] * 0.0
            for i in range(4):
                total = total + x[i]
                if total > 100.0:
                    return total
            total = total * 2.0
            return total
        same(f, (np.arange(4, dtype=np.float32),),
             (np.full(4, 50.0, np.float32),))

    def test_nested_tails_rebind_same_param(self):
        def f(x):
            if x.sum() > 100.0:
                return x * 3.0
            x = x + 1.0
            if x.sum() < -100.0:
                return x * -1.0
            x = x * 2.0
            return x
        same(f, (np.ones(3, np.float32),), (np.full(3, 50.0, np.float32),),
             (np.full(3, -50.0, np.float32),))

    def test_tail_fresh_local_needs_no_nonlocal(self):
        def f(x):
            if x.sum() > 10.0:
                return x * 2.0
            z = x + 3.0
            return z
        same(f, (np.ones(3, np.float32),), (np.full(3, 10.0, np.float32),))

    def test_tail_rebinds_global_declared_name(self):
        def f(x):
            global _G_FOR_DY2S_TEST
            if x.sum() > 10.0:
                return x * 2.0
            _G_FOR_DY2S_TEST = _G_FOR_DY2S_TEST + 1.0
            return x * _G_FOR_DY2S_TEST
        # each converted function runs in a copy of the globals: the
        # tail reads the pre-call 2.0 and rebinds its own copy to 3.0
        for conv in (jd2s.convert_to_static, pd2s.convert_to_static):
            np.testing.assert_allclose(np.asarray(conv(f)(np.ones(3))),
                                       np.full(3, 3.0), rtol=1e-6)
            np.testing.assert_allclose(
                np.asarray(conv(f)(np.full(3, 10.0))), np.full(3, 20.0),
                rtol=1e-6)

    def test_tail_rebind_feeds_replayed_expression(self):
        def f(x, y):
            if x.sum() > 0.0:
                return y
            y = y + 100.0
            return y
        same(f, (np.ones(2, np.float32), np.full(2, 7.0, np.float32)),
             (-np.ones(2, np.float32), np.full(2, 7.0, np.float32)))


class TestReturnReviewRegressions:
    def test_statements_after_nested_return_if_guarded(self):
        def f(x):
            if x.sum() > 0:
                y = x * 2.0
                if x[0] > 0:
                    return y
                y = y + 100.0
            else:
                y = x
            return y
        same(f, (np.ones(3, np.float32),), (F32([-1.0, 5.0, 5.0]),),
             (-np.ones(3, np.float32),))


class TestErrorSourceMapping:
    def test_shape_error_names_user_source(self):
        def buggy(x):
            total = x * 0.0
            for i in range(3):
                total = total + x.new_ones((4, 4))  # shape bug: THIS line
            return total

        with pytest.raises(Exception) as info:
            pjit.to_static(buggy)(torch.ones(2))
        tb = "".join(traceback.format_exception(info.type, info.value,
                                                info.tb))
        assert __file__.rstrip("c") in tb, "user file missing from tb"
        assert "total + x.new_ones((4, 4))" in tb, \
            "user source line missing from traceback"

    def test_unconverted_control_flow_targeted_message(self):
        def f(x):
            items = [x, x * 2]
            while x.sum() > 0:   # a loop with an else: left unconverted
                x = x - 1
            else:
                x = x + 1
            return x, items

        with pytest.raises(jd2s.Dy2StaticError, match="un-converted Python"):
            jjit.to_static(f)(jnp.ones((3,)))
        with pytest.raises(pd2s.Dy2StaticError, match="un-converted Python"):
            pjit.to_static(f)(torch.ones(3))
