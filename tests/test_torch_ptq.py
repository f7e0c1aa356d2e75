"""Port QAT / PTQ and the int8 model (`paddle_tpu_torch/quantization`,
`models.weights.load_jax_int8_params`) against the JAX reference.

- PTQ over the port's gpt_tiny and over JAX's, with the same weights and
  the same calibration batches: the same layers become `Int8Linear`s
  under the same buffer names; `qweight`, `w_scale` and `bias` are equal
  bit for bit; `act_scale` equal to rtol 1e-6. The activation scales are
  observed maxima of each package's float forward, which agree to the
  last few fp32 ulps (logits to 1e-4, see test_torch_gpt.py), so a scale
  may differ by an ulp or two; the weights' codes and scales depend on
  the weights alone.
- `fake_quant`'s forward and straight-through gradient equal JAX's.
- A JAX PTQ model carried across by the bridge (codes and scales bit for
  bit) serves through the port's engine with the JAX engine's greedy
  streams at `max_slots=2`, where the reference's top-2 logit margin is
  above 1e-3 at every step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.quantization import PTQ as JaxPTQ
from paddle_tpu.quantization import QuantConfig as JaxQuantConfig
from paddle_tpu.quantization import fake_quant as jax_fake_quant
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import (gpt_tiny, load_jax_int8_params,
                                     load_jax_params)
from paddle_tpu_torch.quantization import (PTQ, QAT, Int8Linear,
                                           QuantedLinear, fake_quant)
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
from port_threads import one_torch_thread  # noqa: F401


def _calib(seed=10):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (1, 32)).astype(np.int32)
            for _ in range(2)]


def _jax_ptq(raw_params, algo):
    pt.seed(0)
    m = jax_gpt_tiny()
    m.eval()
    m.load_raw_parameters(raw_params)
    ptq = JaxPTQ(JaxQuantConfig(), algo=algo, percentile=0.5)
    ptq.quantize(m)
    ptq.sample(m, [jnp.asarray(b) for b in _calib()])
    ptq.convert(m)
    return m


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
def jax_int8(jax_model):
    return _jax_ptq(jax_model.raw_parameters(), "abs_max")


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("algo", ["abs_max", "percentile"])
def test_ptq_equals_jax(jax_model, np_params, jax_int8, algo):
    jm = jax_int8 if algo == "abs_max" else \
        _jax_ptq(jax_model.raw_parameters(), algo)
    pm = load_jax_params(gpt_tiny(device="cpu"), np_params)
    ptq = PTQ(algo=algo, percentile=0.5)
    ptq.quantize(pm)
    ptq.sample(pm, _calib())
    ptq.convert(pm)
    assert sum(isinstance(m, Int8Linear) for m in pm.modules()) == 16
    jb, pb = _np(jm.raw_buffers()), {k: v.numpy() for k, v in
                                     pm.raw_buffers().items()}
    assert list(pb) == list(jb)
    assert list(pm.raw_parameters()) == list(jm.raw_parameters())
    for k, want in jb.items():
        got = pb[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k.endswith(".act_scale"):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_fake_quant_forward_and_ste_gradient(dtype, per_channel):
    rng = np.random.RandomState(1)
    x = (rng.randn(6, 16) * 3).astype(np.float32)
    scale = (np.abs(rng.randn(1, 16)) * 0.02 + 0.005).astype(np.float32) \
        if per_channel else np.float32(0.0125)
    g = rng.randn(6, 16).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jout, vjp = jax.vjp(jax_fake_quant, jx, jnp.asarray(scale))
    jgx, jgs = vjp(jnp.asarray(g).astype(jout.dtype))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    ts = torch.from_numpy(np.array(scale)).requires_grad_()
    out = fake_quant(tx, ts)
    assert str(out.dtype).endswith(str(jout.dtype))
    gx, gs = torch.autograd.grad(out, (tx, ts), torch.from_numpy(
        np.asarray(jnp.asarray(g).astype(jout.dtype).astype(jnp.float32)))
        .to(out.dtype))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    # JAX hands the bf16 input an fp32 cotangent; torch gives a leaf its
    # own dtype, so the reference is rounded to it
    np.testing.assert_array_equal(
        gx.float().numpy(),
        np.asarray(jgx.astype(dtype).astype(jnp.float32)))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(jgs))
    assert (gx == 0).any() and (gx != 0).any()     # the clip range shows


def test_qat_moving_average_scale_and_convert(np_params):
    """QAT wraps every Linear, a training forward moves each activation
    scale to 0.9 * old + 0.1 * batch abs-max / 127, and convert gives
    Int8Linears that run the int8 forward."""
    pm = load_jax_params(gpt_tiny(device="cpu"), np_params)
    QAT().quantize(pm)
    layers = [m for m in pm.modules() if isinstance(m, QuantedLinear)]
    assert len(layers) == 16
    seen = {}

    def observe(mod, args):
        seen[id(mod)] = float(args[0].detach().abs().max())

    hooks = [m.register_forward_pre_hook(observe) for m in layers]
    pm.train()
    ids = torch.from_numpy(_calib()[0]).long()
    pm(ids)
    for h in hooks:
        h.remove()
    for m in layers:
        want = np.float32(0.9) * np.float32(1.0) \
            + np.float32(0.1) * np.float32(np.float32(seen[id(m)]) / 127.0)
        np.testing.assert_allclose(float(m._act_scale), want, rtol=1e-6)
    QAT().convert(pm)
    assert sum(isinstance(m, Int8Linear) for m in pm.modules()) == 16
    assert not pm.training
    assert torch.isfinite(pm(ids)).all()


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def test_bridged_int8_model_serves_jax_streams(jax_int8):
    prompts = _prompts((6, 10, 13), seed=11)
    new = 6
    jeng = JaxEngine(jax_int8, max_slots=2, max_seq=64, seed=12,
                     attend_impl="masked", prefix_cache=False,
                     register_stats=False)
    want = [r.token_ids for r in jeng.generate(
        prompts, JaxParams(max_new_tokens=new))]
    # the reference's top-2 margin along its own streams
    for p, toks in zip(prompts, want):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])
        lg = np.asarray(jax_int8(jnp.asarray(seq[None])))[0, p.size - 1:]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
    pm = load_jax_int8_params(gpt_tiny(device="cpu"),
                              _np(jax_int8.raw_parameters()),
                              _np(jax_int8.raw_buffers()))
    assert sum(isinstance(m, Int8Linear) for m in pm.modules()) == 16
    for k, v in pm.raw_buffers().items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jax_int8.raw_buffers()[k]), err_msg=k)
    got = LLMEngine(pm, max_slots=2, max_seq=64, seed=12,
                    device="cpu").generate(prompts,
                                           SamplingParams(max_new_tokens=new))
    assert [r.token_ids for r in got] == want


def test_bridge_checks_names_and_shapes(jax_int8):
    params = _np(jax_int8.raw_parameters())
    bufs = _np(jax_int8.raw_buffers())
    with pytest.raises(KeyError, match="qweight"):
        load_jax_int8_params(gpt_tiny(device="cpu"), params, {})
    bad = dict(bufs)
    del bad["blocks.0.attn.qkv.w_scale"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_int8_params(gpt_tiny(device="cpu"), params, bad)
    bad = dict(bufs, **{"blocks.0.attn.out.qweight":
                        bufs["blocks.0.attn.out.qweight"].T[:64]})
    with pytest.raises(ValueError, match="shapes"):
        load_jax_int8_params(gpt_tiny(device="cpu"), params, bad)
    bad = dict(bufs, **{"blocks.0.attn.out.qweight":
                        bufs["blocks.0.attn.out.qweight"].astype(np.int16)})
    with pytest.raises(TypeError, match="int8"):
        load_jax_int8_params(gpt_tiny(device="cpu"), params, bad)
    extra = dict(params, **{"blocks.0.attn.qkv.weight": np.zeros(
        (128, 384), np.float32)})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_int8_params(gpt_tiny(device="cpu"), extra, bufs)
