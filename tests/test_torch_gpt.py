"""Port model module (`paddle_tpu_torch/models`) against the JAX GPT.

The JAX `gpt_tiny` parameters travel to the port as numpy arrays
through `from_jax_params` / `load_jax_params`; decode-forward logits
agree at atol = rtol = 1e-4 (fp32; torch and XLA reduce in different
orders), and greedy generation equals JAX `generate_compiled` token for
token once the reference stream's top-2 logit margin is shown to be
above 1e-3 at every step (so a float-order near-tie cannot flip it).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.gpt import _decode_forward as jax_decode_forward
from paddle_tpu.models.gpt import generate_compiled
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.models import (from_jax_params, gpt_tiny,
                                     load_jax_params)
from paddle_tpu_torch.models.weights import infer_config
from port_threads import one_torch_thread  # noqa: F401


TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_model():
    pt.seed(0)
    m = jax_gpt_tiny()
    m.eval()
    return m


@pytest.fixture(scope="module")
def np_params(jax_model):
    return {k: np.asarray(v) for k, v in jax_model.raw_parameters().items()}


@pytest.fixture(scope="module")
def port_model(np_params):
    return load_jax_params(gpt_tiny(seed=1, device="cpu"), np_params)


def _ids(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 1024, (b, s)).astype(
        np.int32)


class TestWeights:
    def test_names_and_shapes_equal_jax(self, np_params):
        cfg = gpt_tiny(device="cpu").cfg
        shapes = port_gpt.param_shapes(cfg)
        assert list(shapes) == list(np_params)
        assert {k: tuple(v.shape) for k, v in np_params.items()} == shapes

    def test_from_jax_params_copies_values(self, np_params):
        t = from_jax_params(np_params)
        for k, v in np_params.items():
            np.testing.assert_array_equal(t[k].numpy(), v)

    def test_infer_config(self, np_params):
        cfg = infer_config(np_params, num_heads=4)
        assert (cfg.vocab_size, cfg.max_seq_len, cfg.hidden_size,
                cfg.num_layers, cfg.tie_embeddings) == \
            (1024, 256, 128, 4, True)

    def test_mismatch_raises(self, np_params):
        missing = dict(np_params)
        missing.pop("blocks.1.attn.out.bias")
        with pytest.raises(KeyError, match="missing"):
            from_jax_params(missing)
        extra = dict(np_params, **{"blocks.0.attn.extra": np.zeros(3)})
        with pytest.raises(KeyError, match="unexpected"):
            from_jax_params(extra)
        transposed = dict(np_params)
        transposed["blocks.0.mlp.fc1.weight"] = \
            np_params["blocks.0.mlp.fc1.weight"].T
        with pytest.raises(ValueError, match="shapes differ"):
            from_jax_params(transposed)
        with pytest.raises(ValueError, match="shapes differ"):
            load_jax_params(gpt_tiny(device="cpu"), transposed)

    def test_bf16_arrays_carry_over_bitwise(self, np_params):
        import ml_dtypes
        a = np_params["ln_f.bias"] + np.linspace(-3, 3, 128, dtype=np.float32)
        b = a.astype(ml_dtypes.bfloat16)
        t = from_jax_params({**np_params, "ln_f.bias": b})["ln_f.bias"]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      b.astype(np.float32))


class TestInit:
    def test_seeded_and_reference_laws(self):
        a, b = gpt_tiny(seed=3, device="cpu"), gpt_tiny(seed=3, device="cpu")
        c = gpt_tiny(seed=4, device="cpu")
        pa, pb, pc = (m.raw_parameters() for m in (a, b, c))
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
        assert not torch.equal(pa["wte.weight"], pc["wte.weight"])
        L = a.cfg.num_layers
        assert abs(pa["wte.weight"].std().item() - 0.02) < 1e-3
        assert abs(pa["blocks.0.mlp.fc1.weight"].std().item() - 0.02) < 1e-3
        assert abs(pa["blocks.0.attn.out.weight"].std().item()
                   - 0.02 / math.sqrt(2 * L)) < 1e-3
        assert torch.equal(pa["blocks.2.ln1.weight"], torch.ones(128))
        assert torch.equal(pa["blocks.2.attn.qkv.bias"], torch.zeros(384))

    def test_dtype_and_device(self):
        m = gpt_tiny(device="cpu", dtype="bf16")
        assert m.dtype == torch.bfloat16 and m.device.type == "cpu"


class TestDecodeWiring:
    def test_decode_forward_logits_match_jax(self, jax_model, port_model,
                                             np_params):
        ids = _ids(2, 11)
        cfg = port_model.cfg
        total = 16
        jk = jnp.zeros((cfg.num_layers, 2, total, cfg.num_heads,
                        cfg.head_dim), jnp.float32)
        j_logits, _, _ = jax_decode_forward(
            jax_model.cfg, {k: jnp.asarray(v) for k, v in np_params.items()},
            jnp.asarray(ids), 0, jk, jnp.zeros_like(jk))
        pk = torch.zeros((cfg.num_layers, 2, total, cfg.num_heads,
                          cfg.head_dim))
        p_logits, pk, _ = port_gpt._decode_forward(
            cfg, port_model.raw_parameters(), torch.from_numpy(ids).long(),
            0, pk, torch.zeros_like(pk))
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(j_logits),
                                   **TOL)
        # the cache rows past the prompt stay untouched (written in place)
        assert torch.count_nonzero(pk[:, :, 11:]) == 0

    def test_greedy_generation_matches_generate_compiled(
            self, jax_model, port_model, np_params):
        ids = _ids(2, 9, seed=4)
        new = 12
        ref = np.asarray(generate_compiled(jax_model, jnp.asarray(ids),
                                           max_new_tokens=new,
                                           temperature=0.0))
        # the reference stream's logits at every step it decided
        cfg = jax_model.cfg
        total = ref.shape[1]
        jk = jnp.zeros((cfg.num_layers, 2, total, cfg.num_heads,
                        cfg.head_dim), jnp.float32)
        lg, _, _ = jax_decode_forward(
            cfg, {k: jnp.asarray(v) for k, v in np_params.items()},
            jnp.asarray(ref[:, :-1]), 0, jk, jnp.zeros_like(jk))
        steps = np.sort(np.asarray(lg)[:, ids.shape[1] - 1:], axis=-1)
        margin = steps[..., -1] - steps[..., -2]
        assert margin.min() > 1e-3, f"near-tie in the reference: {margin}"
        out = port_gpt.generate_greedy(port_model, ids, max_new_tokens=new)
        np.testing.assert_array_equal(out.numpy(), ref)

    def test_masked_and_ragged_slot_attend_agree(self, port_model):
        rng = np.random.RandomState(7)
        q = torch.from_numpy(rng.randn(4, 1, 4, 32).astype(np.float32))
        k = torch.from_numpy(rng.randn(4, 64, 4, 32).astype(np.float32))
        v = torch.from_numpy(rng.randn(4, 64, 4, 32).astype(np.float32))
        pos = torch.tensor([0, 12, 33, 63])
        a = port_gpt._slot_attend(q, k, v, pos, "masked")
        b = port_gpt._slot_attend(q, k, v, pos, "ragged")
        assert a.shape == b.shape == q.shape
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)

    def test_int8_weights_name_the_roadmap_item(self, port_model):
        """int8 PTQ weights are ported (ROADMAP Queue 1 item 10): a
        `.qweight` dispatches to `int8_linear`; a layer with neither
        weight format raises naming the missing weight."""
        from paddle_tpu_torch.quantization import int8_linear
        rng = np.random.RandomState(2)
        p = {"x.qweight": torch.from_numpy(
                rng.randint(-127, 128, (128, 256)).astype(np.int8)),
             "x.w_scale": torch.full((256,), 0.01),
             "x.act_scale": torch.tensor(0.02),
             "x.bias": torch.ones(256)}
        x = torch.from_numpy(rng.randn(2, 1, 128).astype(np.float32))
        assert torch.equal(port_gpt._apply_linear(p, "x", x),
                           int8_linear(x, *(p["x." + k] for k in (
                               "qweight", "w_scale", "act_scale", "bias"))))
        with pytest.raises(KeyError, match="y.qweight"):
            port_gpt._apply_linear(p, "y", x)
