"""The port's serving runtime (`paddle_tpu_torch.inference`) against the
JAX package's (`tests/test_jit_export.py`'s TestPredictor), on the CPU
(`Config.disable_gpu()`; on the card an entry of `_compiled` is a CUDA
graph, held by `chip_smoke.py` phases 6n-6p).

The MLP with batch norm of `port_export` (JAX's `_mlp` and its port
twin) is saved by each package's `jit.save`; each package's Predictor
serves the same seeded inputs: outputs within rtol 2e-5 / atol 2e-6
(the JAX tests' limits). A 2-layer BERT classifier (hidden 32, 2 heads:
head dim 16, fp32) built in JAX and carried over by `load_jax_state`
is exported with specs [None, 16] x 2 (ids, token types): the
program holds one `paddle_tpu_torch::flash_attention_fwd` node per
layer, and the Predictor's and the loaded layer's logits equal JAX's
eval forward within 1e-5 of their largest magnitude; the loaded
layer's gradients (through the operator's registered backward) equal
the eager port model's within 1e-5. `create_llm_engine` over
`serving.save_for_serving` on `gpt_tiny` streams what an engine over
the model does, token for token.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import inference as jinference
from paddle_tpu import jit as jjit
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import inference, jit, serving
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models import gpt_tiny, load_jax_state
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.static import InputSpec
from port_export import jax_mlp, mlps, x8  # noqa: F401
from port_resnet import numpy_tree, rel_err
from port_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-6)
SPEC = [InputSpec([None, 8], "float32")]


def _saved(tmp_path, jm, pm):
    """Each package's artifact of the MLP pair: (JAX prefix, port
    prefix)."""
    jprefix, prefix = str(tmp_path / "jmlp"), str(tmp_path / "mlp")
    jjit.save(jm, jprefix, input_spec=[pt.static.InputSpec([None, 8])],
              native=False)
    jit.save(pm, prefix, input_spec=SPEC)
    return jprefix, prefix


def _predictor(mod, prefix):
    cfg = mod.Config(prefix)
    cfg.disable_gpu()
    return mod.create_predictor(cfg)


class TestPredictor:
    def test_handles_and_cache_as_jax(self, mlps, tmp_path):
        jm, pm = mlps
        jprefix, prefix = _saved(tmp_path, jm, pm)
        jpred, pred = _predictor(jinference, jprefix), _predictor(
            inference, prefix)
        assert pred.get_input_names() == jpred.get_input_names() == ["x0"]
        x = x8(4)
        for p in (jpred, pred):
            h = p.get_input_handle("x0")
            h.reshape([4, 8])
            h.copy_from_cpu(x.astype(np.float64))   # cast to the spec
            assert h.type() == "float32" and h.shape() == [4, 8]
            assert p.run() is True
        out = pred.get_output_handle(pred.get_output_names()[0])
        want = jpred.get_output_handle(jpred.get_output_names()[0])
        assert pred.get_output_names() == ["out0"]
        np.testing.assert_allclose(out.copy_to_cpu(), want.copy_to_cpu(),
                                   **TOL)
        pred.get_input_handle("x0").copy_from_cpu(x * 2)  # same signature
        pred.run()
        assert len(pred._compiled) == 1
        x2 = x8(7, seed=1)
        outs = pred.run([x2])
        assert len(pred._compiled) == 2
        np.testing.assert_allclose(outs[0], jpred.run([x2])[0], **TOL)
        assert pred.eager_reason is None
        assert all(e[1].graph is None for e in pred._compiled.values())

    def test_two_input_model_and_count_guard(self, tmp_path):
        class TwoIn(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.fc = Linear(8, 4, 0.5, torch.Generator().manual_seed(1))

            def forward(self, a, b):
                return self.fc(a) + b

        m = TwoIn()
        prefix = str(tmp_path / "two")
        jit.save(m, prefix, input_spec=[InputSpec([None, 8]),
                                        InputSpec([None, 4])])
        pred = _predictor(inference, prefix)
        assert pred.get_input_names() == ["x0", "x1"]
        a, b = x8(3), np.random.RandomState(1).randn(3, 4).astype("float32")
        outs = pred.run([a, b])
        want = m(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(outs[0], want.detach().numpy(), **TOL)
        # a short input list raises, not silently reuses stale tensors
        with pytest.raises(ValueError, match="takes 2 inputs"):
            pred.run([a])

    def test_positional_run_and_config(self, mlps, tmp_path, monkeypatch):
        jm, pm = mlps
        jprefix, prefix = _saved(tmp_path, jm, pm)
        for suffix in (".pt2", ".params", ".meta.json", ".stablehlo"):
            assert inference.Config(prefix + suffix).model_prefix == prefix
        x = x8(2, seed=5)
        outs = _predictor(inference, prefix + ".pt2").run([x])
        np.testing.assert_allclose(
            outs[0], _predictor(jinference, jprefix).run([x])[0], **TOL)
        cfg = inference.Config(prefix)
        assert cfg.device() == "cuda"              # the card by default
        cfg.switch_ir_optim(False)
        cfg.enable_tensorrt_engine()
        cfg.enable_mkldnn()
        assert len(cfg.ignored_knobs()) == 3
        cfg.enable_native_runtime(False)
        with pytest.raises(NotImplementedError, match="13.2b"):
            cfg.enable_native_runtime(True)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            inference.create_predictor(cfg)        # no fallback to the CPU

    def test_control_flow_program_runs_eagerly(self, tmp_path):
        def f(x):
            if x.sum() > 0:
                y = x * 2.0
            else:
                y = -x
            return y

        prefix = str(tmp_path / "cf")
        jit.save(f, prefix, input_spec=[InputSpec([3])], device="cpu")
        pred = _predictor(inference, prefix)
        assert pred.eager_reason is not None
        x = np.array([1.0, -0.5, 0.5], np.float32)     # sum > 0
        np.testing.assert_array_equal(pred.run([x])[0], x * 2.0)
        np.testing.assert_array_equal(pred.run([-x])[0], x)
        assert len(pred._compiled) == 1


BERT = dict(vocab_size=200, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64,
            hidden_dropout=0.0, attention_dropout=0.0)


def test_exported_bert_against_jax(tmp_path):
    pt.seed(0)
    jm = jbert.BertForSequenceClassification(jbert.BertConfig(**BERT), 2)
    jm.eval()
    pm = load_jax_state(pbert.BertForSequenceClassification(
        pbert.BertConfig(**BERT), 2, seed=3, device="cpu"),
        numpy_tree(jm.raw_parameters()))
    pm.eval()
    rs = np.random.RandomState(0)
    ids = rs.randint(0, BERT["vocab_size"], (4, 16))
    tt = rs.randint(0, 4, (4, 16))
    want = np.asarray(jjit.to_static(jm)(jnp.asarray(ids), jnp.asarray(tt)))
    prefix = str(tmp_path / "bert")
    jit.save(pm, prefix, input_spec=[InputSpec([None, 16], "int64"),
                                     InputSpec([None, 16], "int64")])
    with open(prefix + ".meta.json") as f:
        assert [s["dtype"] for s in json.load(f)["input_specs"]] == \
            ["int64", "int64"]
    loaded = jit.load(prefix, device="cpu")
    ops = [n for n in loaded.program.graph.nodes
           if "paddle_tpu_torch.flash_attention_fwd" in str(n.target)]
    assert len(ops) == BERT["num_layers"]
    assert rel_err(_predictor(inference, prefix).run([ids, tt])[0],
                   want) <= 1e-5
    assert rel_err(loaded(ids[:3], tt[:3]), want[:3]) <= 1e-5
    # the loaded layer fine-tunes through the backward operator
    y = torch.from_numpy(rs.randint(0, 2, (4,)))
    params = dict(loaded.named_parameters())
    loss = torch.nn.functional.cross_entropy(loaded(ids, tt), y)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    eager = torch.nn.functional.cross_entropy(
        pm(torch.from_numpy(ids), torch.from_numpy(tt)), y)
    own = dict(pm.named_parameters())
    eg = dict(zip(own, torch.autograd.grad(eager, list(own.values()))))
    for k, g in eg.items():
        assert rel_err(grads[k.replace(".", "__")], g) <= 1e-5, k


def test_create_llm_engine_over_save_for_serving(tmp_path):
    m = gpt_tiny(seed=0, device="cpu")
    prefix = str(tmp_path / "gpt")
    serving.save_for_serving(m, prefix)
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    eng = inference.create_llm_engine(cfg, max_slots=2, max_seq=64)
    assert eng.device.type == "cpu"
    ref = serving.LLMEngine(m, max_slots=2, max_seq=64, device="cpu")
    prompts = [np.arange(5), np.arange(3, 12)]
    sp = serving.SamplingParams(max_new_tokens=6)
    got = [r.token_ids for r in eng.generate(prompts, sp)]
    assert got == [r.token_ids for r in ref.generate(prompts, sp)]
    eng2 = inference.create_llm_engine(prefix, max_slots=2, max_seq=64,
                                       device="cpu")
    assert [r.token_ids for r in eng2.generate(prompts, sp)] == got
