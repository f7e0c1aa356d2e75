"""The port's `core` helpers against the JAX package's: `convert_dtype`
over every alias of the reference's table (64-bit names canonicalised
to 32-bit, as with x64 off), the dtype predicates and the default
dtype; `set_device` / `get_device` (the previous default restored) and
`device_count`; the default `Generator`'s state, `seed`
reproducibility, and the initializers drawing from it; `no_grad`; the
five flags, their `FLAGS_` environment bridge and `check_numerics`."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import core as jcore
from paddle_tpu_torch import core
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.testing.op_cases import on_device
from port_threads import one_torch_thread  # noqa: F401


def _name(dtype):
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("alias", sorted(jcore._DTYPE_ALIASES))
def test_convert_dtype_matches_jax(alias):
    want = np.dtype(jcore.convert_dtype(alias)).name
    assert _name(core.convert_dtype(alias)) == want
    # a torch or numpy dtype of the same name converts the same way
    assert core.convert_dtype(core._as_torch_dtype(alias)) == \
        core.convert_dtype(alias)


def test_convert_dtype_takes_numpy_dtypes_and_none():
    assert core.convert_dtype(np.float64) == torch.float32
    assert core.convert_dtype(np.dtype("int64")) == torch.int32
    assert core.convert_dtype(None) is None
    with pytest.raises(ValueError):
        core.convert_dtype("float128")


@pytest.mark.parametrize("alias", sorted(jcore._DTYPE_ALIASES))
def test_dtype_predicates_match_jax(alias):
    assert core.is_floating_dtype(alias) == jcore.is_floating_dtype(
        jcore._DTYPE_ALIASES[alias])
    assert core.is_integer_dtype(alias) == jcore.is_integer_dtype(
        jcore._DTYPE_ALIASES[alias])


def test_dtype_names_and_default_dtype():
    for n in ("bfloat16", "float16", "float32", "float64", "int8", "int16",
              "int32", "int64", "uint8", "complex64", "complex128"):
        assert _name(getattr(core, n)) == n
    assert core.bool_ is torch.bool
    assert core.get_default_dtype() == torch.float32
    core.set_default_dtype("float16")
    try:
        assert core.get_default_dtype() == torch.float16
        with on_device("cpu"):
            assert core.get_default_dtype() == torch.float16
            from paddle_tpu_torch import ops
            assert ops.zeros([2]).dtype == torch.float16
    finally:
        core.set_default_dtype("float32")


def test_set_device_and_get_device():
    assert core.default_device() == "cuda" and core.get_device() == "gpu:0"
    prev = core._current_device
    try:
        assert core.set_device("cpu") == torch.device("cpu")
        assert core.get_device() == "cpu" and core.default_device() == "cpu"
        assert core.resolve_device(None) == torch.device("cpu")
        with pytest.raises(ValueError, match="not a TPU"):
            core.set_device("tpu:0")
        with pytest.raises(ValueError):
            core.set_device("npu")
        if not torch.cuda.is_available():
            # a card asked for where there is none raises; the CPU stays
            with pytest.raises(RuntimeError, match="is_available"):
                core.set_device("gpu:0")
            assert core.get_device() == "cpu"
    finally:
        core._current_device = prev
    assert core.default_device() == "cuda"


def test_device_count_and_compiled_with():
    assert core.device_count("cpu") == 1
    assert core.device_count() == torch.cuda.device_count()
    assert core.is_compiled_with_tpu() == torch.cuda.is_available()


def test_default_device_stays_the_card_without_one():
    """No entry point of the flat surface runs on the CPU unless asked:
    a creation op with the default device raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from paddle_tpu_torch import ops
    with pytest.raises(RuntimeError, match="is_available"):
        ops.zeros([2])
    with pytest.raises(RuntimeError, match="is_available"):
        ops.to_tensor(np.ones(2))


def test_generator_state_and_seed():
    g = core.Generator(5)
    assert g.initial_seed == 5 and g.get_state() == (5, 0)
    a = torch.rand(3, generator=g.next_generator("cpu"))
    st = g.get_state()
    assert st == (5, 1)
    b = torch.rand(3, generator=g.next_generator("cpu"))
    g.set_state(st)
    assert torch.equal(torch.rand(3, generator=g.next_generator("cpu")), b)
    assert not torch.equal(a, b)
    g.manual_seed(5)
    assert torch.equal(torch.rand(3, generator=g.next_generator("cpu")), a)
    assert g._epoch == 1
    assert core.seed(11) is core.default_generator()
    assert core.default_generator().get_state() == (11, 0)


def test_seed_makes_the_ops_and_initializers_reproducible():
    from paddle_tpu_torch import ops
    with on_device("cpu"):
        core.seed(3)
        a = (ops.randn([4]), I.XavierUniform()((3, 5)), I.Normal(0, 2)((4,)))
        core.seed(3)
        b = (ops.randn([4]), I.XavierUniform()((3, 5)), I.Normal(0, 2)((4,)))
        c = ops.randn([4])                    # the counter moved on
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], c)
    # an explicit generator behaves as before
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    assert torch.equal(I.Normal()((5,), g1), I.Normal()((5,), g2))


def test_no_grad_and_grad_mode():
    assert core.is_grad_enabled()
    x = torch.ones(2, requires_grad=True)
    with core.no_grad():
        assert not core.is_grad_enabled()
        assert not (x * 2).requires_grad
    assert core.is_grad_enabled()
    with jcore.no_grad():
        assert not jcore.is_grad_enabled()


def test_flags_are_the_reference_five():
    assert core.get_flags() == jcore.get_flags()
    assert set(core.get_flags()) == {"check_nan_inf", "benchmark",
                                     "jit_compile", "deterministic",
                                     "matmul_precision"}
    with pytest.raises(KeyError):
        core.set_flags({"nope": 1})
    prev = torch.get_float32_matmul_precision()
    try:
        core.set_flags({"matmul_precision": "high"})
        assert torch.get_float32_matmul_precision() == "high"
        assert core.get_flags("matmul_precision") == {
            "matmul_precision": "high"}
    finally:
        core.set_flags({"matmul_precision": "default"})
        torch.set_float32_matmul_precision(prev)


def test_environment_seeds_the_generator_and_sets_the_flags():
    """`PTPU_SEED` seeds the default generator and `FLAGS_<name>` sets a
    flag at import, as in the reference."""
    code = ("import paddle_tpu_torch.core as c; "
            "print(c.default_generator().get_state()); "
            "print(c.get_flags(['check_nan_inf', 'matmul_precision', "
            "'benchmark']))")
    env = {**os.environ, "PTPU_SEED": "42", "FLAGS_check_nan_inf": "true",
           "FLAGS_matmul_precision": "highest", "FLAGS_benchmark": "0"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split("\n")[:2] == [
        "(42, 0)", "{'check_nan_inf': True, 'matmul_precision': 'highest', "
        "'benchmark': False}"], out.stderr[-2000:]


def test_check_numerics():
    bad = torch.tensor([1.0, float("nan")])
    assert core.check_numerics(bad) is bad        # the flag is off
    core.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="loss"):
            core.check_numerics(bad, "loss")
        with pytest.raises(FloatingPointError):
            core.check_numerics(np.array([np.inf], np.float32))
        ok = torch.ones(3)
        assert core.check_numerics(ok) is ok
        assert core.check_numerics(torch.arange(3)) is not None
        jpt.set_flags({"check_nan_inf": True})
        with pytest.raises(FloatingPointError):
            jcore.check_numerics(np.array([np.nan]), "loss")
    finally:
        core.set_flags({"check_nan_inf": False})
        jpt.set_flags({"check_nan_inf": False})
