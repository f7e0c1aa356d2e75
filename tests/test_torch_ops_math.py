"""The port's `ops.math` against the JAX package's, case by case
(`paddle_tpu_torch/testing/op_cases.py`): the same seeded numpy inputs
through both, each result's value (fp32: rtol 1e-5, atol 1e-6 for
elementwise ops and reductions; 1e-4 for decompositions, compared by
reconstruction or invariants), shape and dtype; torch's gradient of
sum(result) against `jax.grad`'s (rtol 1e-5, atol 1e-6) for the ops the
reference sweep differentiates; a bf16 forward within 5e-2 of the fp32
one; the random ops reproducible under `seed` and within their law.
The completeness gate mirrors `tests/test_op_sweep.py`'s."""
import pytest

from port_ops import (cases, check_bf16, check_complete, check_forward,
                      check_grad, check_random, ids, port_on_cpu)  # noqa: F401
from port_threads import one_torch_thread  # noqa: F401

MODULES = ("ops.math",)
CASES = cases(MODULES)


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_forward_matches_jax(case):
    check_forward(case)


@pytest.mark.parametrize("case", [c for c in CASES if c.grad], ids=ids)
def test_grad_matches_jax(case):
    check_grad(case)


@pytest.mark.parametrize("case", [c for c in CASES if c.bf16], ids=ids)
def test_bf16_tracks_fp32(case):
    check_bf16(case)


def test_every_implemented_op_has_a_case():
    check_complete(MODULES)
