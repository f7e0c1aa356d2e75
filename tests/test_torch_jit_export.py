"""The port's capture, export and load (`paddle_tpu_torch.jit`,
`paddle_tpu_torch.static`) against the JAX package's
(`tests/test_jit_export.py`'s cases).

An MLP with batch norm (JAX's `_mlp`: Linear(8, 16), BatchNorm1D(16),
Linear(16, 4) from `paddle_tpu.seed(7)`) is built in JAX and carried
into its port twin by `load_jax_state`; the same seeded numpy inputs go
through both. fp32 on the CPU, where the port's programs run PyTorch's
CPU kernels: outputs within rtol 2e-5 / atol 2e-6 (the JAX tests'
limits), BatchNorm buffers and gradients within 1e-5 of their largest
magnitude. ResNet-18 is in `test_torch_export_resnet.py`.

Covered: `to_static` on a function and on a Layer (eval; train mode
with the BatchNorm statistics landing in the layer's own buffers, as
JAX's `load_raw_buffers`; the layer's current parameters read after an
update; gradients to them), one program per signature, `.code`,
`get_concrete_function`; `save` / `load` with a dynamic batch (a fresh
process with `jax` blocked is `test_torch_jit_reload.py`), fine-tuning
the loaded layer (its gradient
against JAX's through its loaded program), a pure function, the
`static` shims; `.params` both ways (bf16 included); a JAX artifact
refused by name; `batch_buckets` refused naming item 13.2b; loading
unpickles nothing.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import jit as jjit
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch import jit, static
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.static import InputSpec
from port_export import PortMLP, jax_mlp, mlps, x8  # noqa: F401
from port_resnet import rel_err
from port_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-6)


def _jax_out(jm, x):
    return np.asarray(jm(jnp.asarray(x)))


def _save_mlp(pm, tmp_path, name="mlp"):
    prefix = str(tmp_path / name)
    jit.save(pm, prefix, input_spec=[InputSpec([None, 8], "float32")])
    return prefix


class TestToStatic:
    def test_function_decorator(self):
        @jit.to_static
        def f(x):
            return x * 2 + 1

        x = np.arange(6, dtype="float32")
        want = jjit.to_static(lambda a: a * 2 + 1)(jnp.asarray(x))
        np.testing.assert_allclose(f(torch.from_numpy(x)).numpy(),
                                   np.asarray(want))

    def test_entry_points_default_to_the_card(self, mlps, tmp_path,
                                              monkeypatch):
        """With no tensor or Layer naming a device, a function's numpy
        inputs, `save` of a function and `load` go to the card, and
        raise without one."""
        _, pm = mlps
        prefix = _save_mlp(pm, tmp_path)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        f = jit.to_static(lambda a: a * 2 + 1)
        with pytest.raises(RuntimeError, match="cuda"):
            f(np.arange(6, dtype="float32"))
        with pytest.raises(RuntimeError, match="cuda"):
            jit.save(lambda a: a + 1, str(tmp_path / "fn"),
                     input_spec=[InputSpec([3])])
        with pytest.raises(RuntimeError, match="cuda"):
            jit.load(prefix)
        with pytest.raises(RuntimeError, match="cuda"):
            static.load_inference_model(prefix)

    def test_layer_eval_matches_jax(self, mlps):
        jm, pm = mlps
        x = x8(4)
        static = jit.to_static(pm)
        np.testing.assert_allclose(static(x).detach().numpy(),
                                   _jax_out(jm, x), **TOL)
        static(x * 2)
        assert len(static._programs) == 1     # one signature, one program
        static(x8(5))
        assert len(static._programs) == 2

    def test_layer_train_updates_bn_buffers_as_jax(self, mlps):
        jm, pm = mlps
        jm.train()
        pm.train()
        x = x8(16, seed=1, shift=3.0)
        want = np.asarray(jjit.to_static(jm)(jnp.asarray(x)))
        static = jit.to_static(pm)
        before = pm.bn._mean.clone()
        got = static(x)
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
        assert not torch.equal(before, pm.bn._mean)
        for name in ("_mean", "_variance"):
            assert rel_err(getattr(pm.bn, name),
                           jm.bn._buffers[name]) <= 1e-5

    def test_current_parameters_and_gradients(self, mlps):
        _, pm = mlps
        static = jit.to_static(pm)
        x = torch.from_numpy(x8(4))
        static(x)
        with torch.no_grad():                 # an update between calls
            pm.fc2.weight.add_(0.5)
        got = static(x)
        want = pm(x)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        g_got = torch.autograd.grad(got.square().sum(), pm.fc1.weight)[0]
        g_want = torch.autograd.grad(want.square().sum(),
                                     pm.fc1.weight)[0]
        torch.testing.assert_close(g_got, g_want, rtol=1e-5, atol=1e-6)

    def test_code_and_concrete_function(self, mlps):
        _, pm = mlps
        static = jit.to_static(pm, input_spec=[InputSpec([None, 8])])
        assert "aten.matmul" in static.code
        x = torch.from_numpy(x8(3))
        call = static.get_concrete_function(x)
        torch.testing.assert_close(call(x), pm(x))


class TestSaveLoad:
    def test_roundtrip_dynamic_batch(self, mlps, tmp_path):
        jm, pm = mlps
        prefix = _save_mlp(pm, tmp_path)
        for ext in (".pt2", ".params", ".meta.json"):
            assert os.path.exists(prefix + ext)
        with open(prefix + ".meta.json") as f:
            meta = json.load(f)
        assert meta["framework"] == "paddle_tpu_torch"
        assert meta["input_specs"] == [{"shape": [None, 8],
                                        "dtype": "float32", "name": "x0"}]
        loaded = jit.load(prefix, device="cpu")
        assert sorted(n for n, _ in loaded.named_parameters()) == sorted(
            k.replace(".", "__") for k in jm.raw_parameters())
        for bs in (1, 2, 5):
            x = x8(bs, seed=bs)
            np.testing.assert_allclose(loaded(x).detach().numpy(),
                                       _jax_out(jm, x), **TOL)

    def test_finetune_loaded_model_as_jax(self, mlps, tmp_path):
        """The loaded layer's gradient equals the gradient of JAX's
        loaded program (its serialized VJP) on the same loss, and one
        step lowers the loss."""
        jm, pm = mlps
        jprefix = str(tmp_path / "jmlp")
        jjit.save(jm, jprefix, input_spec=[pt.static.InputSpec([None, 8])])
        jloaded = jjit.load(jprefix)
        loaded = jit.load(_save_mlp(pm, tmp_path), device="cpu")
        x = x8(8)
        y = np.random.RandomState(1).randn(8, 4).astype("float32")
        jparams = jloaded.raw_parameters()

        def jloss(params):
            out, _ = jax_functional_call(jloaded, params, jnp.asarray(x))
            return jnp.mean((out - jnp.asarray(y)) ** 2)

        jl0, jgrads = jax.value_and_grad(jloss)(jparams)
        params = dict(loaded.named_parameters())
        loss = ((loaded(x) - torch.from_numpy(y)) ** 2).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        np.testing.assert_allclose(float(loss.detach()), float(jl0),
                                   rtol=1e-5)
        for (k, g) in zip(params, grads):
            assert rel_err(g, jgrads[k]) <= 1e-5, k
        assert sum(float(g.square().sum()) for g in grads) > 0
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p.sub_(0.05 * g)
        l1 = ((loaded(x) - torch.from_numpy(y)) ** 2).mean()
        assert float(l1.detach()) < float(loss.detach())

    def test_save_pure_function(self, tmp_path):
        def f(x):
            return x @ x.T

        prefix = str(tmp_path / "fn")
        jit.save(f, prefix, input_spec=[InputSpec([3, 5], "float32")],
                 device="cpu")
        loaded = jit.load(prefix, device="cpu")
        x = np.random.RandomState(0).randn(3, 5).astype("float32")
        np.testing.assert_allclose(loaded(x).numpy(), x @ x.T, rtol=1e-5)
        assert list(loaded.parameters()) == []

    def test_static_io_shims(self, mlps, tmp_path):
        jm, pm = mlps
        prefix = str(tmp_path / "m")
        static.save_inference_model(prefix, pm,
                                    input_spec=[InputSpec([None, 8])])
        loaded = static.load_inference_model(prefix, device="cpu")
        x = x8(2)
        np.testing.assert_allclose(loaded(x).detach().numpy(),
                                   _jax_out(jm, x), **TOL)

    def test_input_spec(self):
        a = InputSpec([None, 8], "float32", "a")
        assert a == InputSpec((None, 8), np.float32, "b")
        assert hash(a) == hash(InputSpec([None, 8], torch.float32))
        assert a != InputSpec([None, 8], "bfloat16")
        assert InputSpec.from_tensor(torch.zeros(2, 3, dtype=torch.int64)
                                     ) == InputSpec([2, 3], "int64")
        assert InputSpec.from_tensor(np.zeros((2,), ml_dtypes.bfloat16)
                                     ).dtype == torch.bfloat16
        assert InputSpec([None, 4], "torch.float16").example(3).shape == \
            (3, 4)

    def test_params_both_ways_bf16_included(self, tmp_path):
        """The port's .params is read by JAX's `_load_state` and JAX's by
        the port's reader, which feeds `load_jax_state`; bf16 bit for
        bit."""
        rs = np.random.RandomState(0)
        w = rs.randn(3, 4).astype(np.float32)
        state = {"params": {"a.w": torch.from_numpy(w).to(torch.bfloat16),
                            "a.b": torch.from_numpy(w[0])},
                 "buffers": {"bn._mean": torch.arange(4.0)}}
        path = str(tmp_path / "port.params")
        jit._save_state(state, path)
        back = jjit._load_state(path)
        assert back["params"]["a.w"].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(
            back["params"]["a.w"].view(np.int16),
            state["params"]["a.w"].view(torch.int16).numpy())
        np.testing.assert_array_equal(back["params"]["a.b"], w[0])
        np.testing.assert_array_equal(back["buffers"]["bn._mean"],
                                      np.arange(4.0, dtype=np.float32))
        # JAX's file (its MLP, weights cast to bf16) into the port
        jm = jax_mlp()
        jstate = {"params": {k: jnp.asarray(v, jnp.bfloat16)
                             for k, v in jm.raw_parameters().items()},
                  "buffers": jm.raw_buffers()}
        jpath = str(tmp_path / "jax.params")
        jjit._save_state(jstate, jpath)
        got = jit._load_state(jpath)
        pm = PortMLP().to(torch.bfloat16)
        pm.bn._mean = pm.bn._mean.float()
        pm.bn._variance = pm.bn._variance.float()
        load_jax_state(pm, got["params"], got["buffers"])
        for k, v in jstate["params"].items():
            np.testing.assert_array_equal(
                dict(pm.named_parameters())[k].detach().view(
                    torch.int16).numpy(), np.asarray(v).view(np.int16))

    def test_jax_artifact_refused_by_name(self, tmp_path):
        jm = jax_mlp()
        jm.eval()
        prefix = str(tmp_path / "j")
        jjit.save(jm, prefix, input_spec=[pt.static.InputSpec([None, 8])],
                  native=False)
        with pytest.raises(ValueError, match="JAX package artifact"):
            jit.load(prefix, device="cpu")

    def test_native_items_raise(self, mlps, tmp_path):
        _, pm = mlps
        with pytest.raises(NotImplementedError, match="13.2b"):
            jit.save(pm, str(tmp_path / "b"),
                     input_spec=[InputSpec([None, 8])], batch_buckets=[1, 4])
        prefix = _save_mlp(pm, tmp_path)         # native=True by default
        assert sorted(os.listdir(tmp_path)) == [
            "mlp.meta.json", "mlp.params", "mlp.pt2"]
        assert prefix

    def test_load_unpickles_nothing(self, mlps, tmp_path, monkeypatch):
        _, pm = mlps
        prefix = _save_mlp(pm, tmp_path)

        def refuse(*a, **k):
            raise AssertionError("unpickled while loading")
        monkeypatch.setattr(torch, "load", refuse)
        monkeypatch.setattr(pickle, "load", refuse)
        monkeypatch.setattr(pickle, "loads", refuse)
        monkeypatch.setattr(pickle, "Unpickler", refuse)
        loaded = jit.load(prefix, device="cpu")
        assert loaded(x8(2)).shape == (2, 4)
