"""Helpers of the port's dy2static tests: one function through the JAX
package's `jit.to_static` and the port's on the same numpy inputs, and
both converters on Python values."""
import functools

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu import jit as jjit
from paddle_tpu.jit import dy2static as jd2s
from paddle_tpu_torch import jit as pjit
from paddle_tpu_torch.jit import dy2static as pd2s

RTOL = 1e-6


def same(fn, *argsets, traced=True):
    """`fn` through each package's `to_static` (one each: an argset of
    the same signature reuses the captured program) on the same numpy
    inputs; the results agree within RTOL, and the port's program holds
    converted control flow when `traced`."""
    jax_static, static = jjit.to_static(fn), pjit.to_static(fn)
    for args in argsets:
        arrays = [np.asarray(a) for a in args]
        want = jax_static(*[jnp.asarray(a) for a in arrays])
        pargs = [torch.from_numpy(a) for a in arrays]
        got = static(*pargs)
        if traced:
            assert pjit.has_control_flow(static.program(*pargs))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=RTOL, atol=0)


def python_path(fn, *argsets):
    """Both converters' functions on Python values agree exactly."""
    j, p = jd2s.convert_to_static(fn), pd2s.convert_to_static(fn)
    assert getattr(p, "__wrapped_dy2static__", False) == \
        getattr(j, "__wrapped_dy2static__", False)
    for args in argsets:
        assert p(*args) == j(*args) == fn(*args)


F32 = functools.partial(np.asarray, dtype=np.float32)
