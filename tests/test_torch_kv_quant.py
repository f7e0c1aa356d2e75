"""Port int8 KV (`paddle_tpu_torch/quantization`, the int8 slabs of the
engine) against the JAX reference, and its invariants inside the port.

- `kv_quantize` equals JAX's bitwise (codes and scales) in fp32 and in
  bf16: the abs-max and the /127 run in the input's dtype before the
  scale widens, the divide in fp32, rounding half to even.
- The port's int8 engine (`kv_dtype="int8"`, "masked") gives the JAX
  engine's greedy streams (`prefix_cache=False`) on both layouts, token
  for token, on `gpt_tiny`, where the reference's top-2 logit margin
  over the dequantized cache is above 1e-3 at every step.
- Inside the port, bitwise: int8 greedy streams are identical across
  layouts, page sizes and `decode_block_size` (the JAX matrix of
  `tests/test_kv_quant.py` less the prefill-chunking variants, which
  are not ported), and the ragged path's plain K5/K6 agree with it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.gpt import _body_layers as jax_body_layers
from paddle_tpu.models.gpt import _head as jax_head
from paddle_tpu.models.gpt import _masked_attend as jax_masked_attend
from paddle_tpu.quantization import abs_max_scale as jax_abs_max_scale
from paddle_tpu.quantization import quantize_tensor as jax_quantize_tensor
from paddle_tpu.quantization.kv import kv_dequant as jax_kv_dequant
from paddle_tpu.quantization.kv import kv_quantize as jax_kv_quantize
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.serving.engine import _embed as jax_embed
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.quantization import (abs_max_scale,
                                           dequantize_tensor,
                                           quantize_tensor)
from paddle_tpu_torch.quantization import kv as port_kv
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
from port_threads import one_torch_thread  # noqa: F401


LENGTHS = (4, 9, 16, 23, 30, 12)


@pytest.fixture(scope="module")
def jax_model():
    pt.seed(0)
    m = jax_gpt_tiny()
    m.eval()
    return m


@pytest.fixture(scope="module")
def model(jax_model):
    np_params = {k: np.asarray(v)
                 for k, v in jax_model.raw_parameters().items()}
    return load_jax_params(gpt_tiny(device="cpu"), np_params)


def _prompts(lengths=LENGTHS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def _run(model, prompts, sp, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq", 64)
    eng = LLMEngine(model, device="cpu", **kw)
    return [r.token_ids for r in eng.generate(prompts, sp)]


def _kv_values(seed=0, shape=(32, 8, 4, 32)):
    """K/V-like rows with a per-row spread of magnitudes, an all-zero
    row (the eps floor) and values on rounding boundaries."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.rand(*shape[:-1], 1) * 4).astype(np.float32)
    rows = x.reshape(-1, shape[-1])               # a view of x
    rows[0] = 0.0
    rows[1, :3] = [127.0, 63.5, -0.5]             # exact halves
    return x


# ---------------------------------------------------------------------- #
# numerics against JAX
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bitwise_equal_to_jax(dtype):
    x = _kv_values()
    jq, js = jax_kv_quantize(jnp.asarray(x).astype(dtype))
    tq, ts = port_kv.kv_quantize(torch.from_numpy(x).to(getattr(torch,
                                                                dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_quantize_dequantize_match_jax(dtype):
    x = _kv_values(seed=1)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    js = jax_abs_max_scale(jx, axis=-1, keepdims=True)
    ts = abs_max_scale(tx, dim=-1, keepdim=True)
    # the scale stays in the input's dtype (bf16-rounded for bf16)
    assert ts.dtype == tx.dtype
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js).astype(np.float32))
    jcode = jax_quantize_tensor(jx, js)
    tcode = quantize_tensor(tx, ts)
    np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode))
    deq = dequantize_tensor(tcode, ts.float())
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jax_kv_dequant(jcode, js[..., 0],
                                               jnp.float32)))
    # a per-tensor scale, and the kv helpers' dequant to another dtype
    np.testing.assert_array_equal(
        abs_max_scale(tx).float().numpy(),
        np.asarray(jax_abs_max_scale(jx)).astype(np.float32))
    w = port_kv.kv_dequant(tcode, ts[..., 0].float(), torch.bfloat16)
    assert w.dtype == torch.bfloat16


def test_slab_helpers_and_in_place_update():
    slab = port_kv.make_slab((2, 8, 4, 16), torch.float32, True)
    assert port_kv.is_quantized(slab)
    assert port_kv.slab_shape(slab) == (2, 8, 4, 16)
    assert port_kv.slab_dtype_str(slab) == "int8"
    assert port_kv.slab_nbytes(slab) == 2 * 8 * 4 * (16 + 4)
    new = torch.from_numpy(_kv_values(seed=2, shape=(3, 4, 16)))
    port_kv.kv_update(slab, (1, slice(2, 5)), new)
    codes, scales = port_kv.kv_quantize(new)
    assert torch.equal(slab["q"][1, 2:5], codes)
    assert torch.equal(slab["s"][1, 2:5], scales)
    assert not slab["q"][0].any()
    dense = port_kv.dequant_slab(slab, torch.float32)
    assert torch.equal(dense[1, 2:5],
                       port_kv.kv_dequant(codes, scales, torch.float32))
    taken = port_kv.take_rows(slab, torch.tensor([1, 1, 0]), torch.float32)
    assert taken.shape == (3, 8, 4, 16) and torch.equal(taken[0], dense[1])
    fp = port_kv.make_slab((2, 8, 4, 16), torch.bfloat16, False)
    port_kv.kv_update(fp, (0, slice(0, 3)), new)
    assert torch.equal(fp[0, :3], new.bfloat16())
    assert port_kv.map_slab(slab, lambda a: a[:1])["s"].shape == (1, 8, 4)


@pytest.mark.parametrize("given,want", [
    (None, "float32"), ("bf16", "bfloat16"), ("fp32", "float32"),
    ("int8", "int8"), ("float16", "float16")])
def test_normalize_kv_dtype(given, want):
    assert port_kv.normalize_kv_dtype(given, torch.float32) == want


def test_normalize_kv_dtype_rejects_unknown():
    with pytest.raises(ValueError, match="kv_dtype"):
        port_kv.normalize_kv_dtype("int4", torch.float32)


# ---------------------------------------------------------------------- #
# the engine against the JAX engine
# ---------------------------------------------------------------------- #

def _jax_int8_logits(jax_model, seq):
    """JAX reference logits (L, vocab) at every position of `seq` over a
    cache holding the int8-dequantized K/V rows (what the int8 engine's
    prefill and decode steps attend)."""
    params = jax_model.raw_parameters()
    cfg = jax_model.cfg
    ids = jnp.asarray(np.asarray(seq, np.int32))[None]
    pos = jnp.arange(ids.shape[1])
    x = jax_embed(params, ids, pos[None])
    keep = (pos[None, :] <= pos[:, None])[None]

    def attn(i, q, kn, vn):
        kq, ks = jax_kv_quantize(kn)
        vq, vs = jax_kv_quantize(vn)
        return jax_masked_attend(q, jax_kv_dequant(kq, ks, q.dtype),
                                 jax_kv_dequant(vq, vs, q.dtype),
                                 keep[:, None])

    return np.asarray(jax_head(params, jax_body_layers(cfg, params, x,
                                                       attn))[0])


@pytest.fixture(scope="module")
def int8_margin(jax_model):
    """The reference's smallest top-2 logit margin along a (prompt,
    stream) pair, computed once per pair for the whole module (both
    layouts' JAX engines give the same streams)."""
    memo = {}

    def margin(p, toks):
        key = (tuple(p), tuple(toks))
        if key not in memo:
            lg = _jax_int8_logits(jax_model, np.concatenate(
                [p, np.asarray(toks[:-1], np.int32)]))[len(p) - 1:]
            top2 = np.sort(lg, axis=-1)[:, -2:]
            memo[key] = float((top2[:, 1] - top2[:, 0]).min())
        return memo[key]

    return margin


@pytest.mark.parametrize("layout", [
    dict(), dict(kv_layout="paged", page_size=8)], ids=["slotted", "paged"])
def test_int8_greedy_streams_match_jax_engine(jax_model, model, layout,
                                              int8_margin):
    prompts = _prompts((5, 13, 9, 21), seed=4)
    base = dict(max_slots=4, max_seq=64, decode_block_size=4,
                attend_impl="masked", kv_dtype="int8", **layout)
    jeng = JaxEngine(jax_model, seed=1, prefix_cache=False,
                     register_stats=False, **base)
    want = [r.token_ids for r in jeng.generate(
        prompts, JaxParams(max_new_tokens=12))]
    for p, toks in zip(prompts, want):
        margin = int8_margin(p, toks)
        assert margin > 1e-3, f"near-tie in the reference: {margin}"
    got = _run(model, prompts, SamplingParams(max_new_tokens=12), **base)
    assert got == want


# ---------------------------------------------------------------------- #
# determinism within the quantized world (bitwise, inside the port)
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def int8_streams(model):
    return _run(model, _prompts(), SamplingParams(max_new_tokens=10),
                kv_dtype="int8")


@pytest.mark.parametrize("extra", [
    dict(decode_block_size=2),
    dict(kv_layout="paged", page_size=8),
    dict(kv_layout="paged", page_size=16, decode_block_size=2),
    dict(kv_layout="paged", page_size=8, kv_pages=9),
], ids=["block2", "paged8", "paged16-block2", "paged8-pressure"])
def test_int8_greedy_identical_across_layouts_and_blocks(model, int8_streams,
                                                         extra):
    got = _run(model, _prompts(), SamplingParams(max_new_tokens=10),
               kv_dtype="int8", **extra)
    assert got == int8_streams


@pytest.mark.parametrize("layout", [dict(), dict(kv_layout="paged")],
                         ids=["K5", "K6"])
def test_int8_ragged_plain_kernels_agree_with_masked(model, int8_streams,
                                                     layout):
    """The ragged seam (plain K5 / K6 on CPU tensors, widening in fp32)
    gives the masked path's greedy streams on this model."""
    got = _run(model, _prompts(), SamplingParams(max_new_tokens=10),
               kv_dtype="int8", attend_impl="ragged", **layout)
    assert got == int8_streams


def test_int8_quality_against_fp_engine(model):
    """int8 streams are not pinned equal to fp streams: the bar is
    per-position greedy agreement (>= 0.9) on a prompt battery."""
    prompts = _prompts((4, 9, 16, 23, 30, 40), seed=3)
    sp = SamplingParams(max_new_tokens=24)
    fp = _run(model, prompts, sp, max_seq=96)
    q = _run(model, prompts, sp, max_seq=96, kv_dtype="int8")
    agree = [np.mean([a == b for a, b in zip(x, y)]) for x, y in zip(fp, q)]
    assert float(np.mean(agree)) >= 0.9, agree


def test_int8_bytes_per_token_and_gauges(model):
    eng = LLMEngine(model, max_slots=2, max_seq=64, device="cpu",
                    kv_dtype="int8")
    cfg = model.cfg
    st = eng.stats()
    # K and V, every layer: nh * hd int8 codes + nh f32 scales per row
    assert st["kv_bytes_per_token"] == \
        2 * cfg.num_layers * cfg.num_heads * (cfg.head_dim + 4)
    assert st["kv_quantized"] == 1.0 and eng.kv_dtype == "int8"
    fp = LLMEngine(model, max_slots=2, max_seq=64, device="cpu")
    assert fp.stats()["kv_bytes_per_token"] == \
        2 * cfg.num_layers * cfg.num_heads * cfg.head_dim * 4
    assert fp.kv_dtype == "float32"


def test_ragged_needs_cache_in_weights_dtype_or_int8(model):
    with pytest.raises(ValueError, match="ragged"):
        LLMEngine(model, max_slots=2, max_seq=64, device="cpu",
                  attend_impl="ragged", kv_dtype="bfloat16")
    with pytest.raises(ValueError, match="kv_dtype"):
        LLMEngine(model, max_slots=2, max_seq=64, device="cpu",
                  kv_dtype="int4")
