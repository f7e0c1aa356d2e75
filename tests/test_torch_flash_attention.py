"""Port flash attention (`paddle_tpu_torch/ops_cuda/flash_attention.py`)
against the JAX package.

The plain versions of K2 and K3 (`flash_forward_plain`,
`flash_backward_plain`) are held against the TPU kernels themselves:
`_flash_forward_flat` and `_flash_backward_flat` run in Pallas TPU
interpret mode (`pltpu.force_tpu_interpret_mode()`) on the CPU, in bf16,
at block sizes that cover the write-once and the accumulating dq
branch, block_q != block_k both ways, and sq < sk bottom-right causal
alignment. The port's autograd Function is held against
`_attention_reference` with `jax.grad` in fp32. The CUDA argument
checks run on CPU tensors (they look at shapes, dtypes and layout only);
the kernels themselves run in `chip_smoke.py` on the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.ops_pallas import flash_attention as jfa
from paddle_tpu_torch.models.weights import _to_tensor
from paddle_tpu_torch.ops_cuda import flash_attention as port
from port_threads import one_torch_thread  # noqa: F401


D = 64
SCALE = 1.0 / math.sqrt(D)


def _bf16(shape, seed):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape),
                       jnp.bfloat16)


def _t(a):
    """A JAX array as a torch tensor, bf16 carried bit for bit."""
    return _to_tensor("x", np.asarray(a))


def _port_layout(flat):
    """(bh, s, d) → (b = bh, s, h = 1, d): the port's layout with the
    same memory order as the JAX flat operand."""
    return _t(flat)[:, :, None, :]


# (sq, sk, block_q, block_k): both dq branches (sk / block_k <= 2 is
# write-once), block_q != block_k both ways, sq < sk
CASES = [(256, 256, 128, 128), (128, 256, 128, 128), (256, 384, 256, 128),
         (256, 256, 128, 256)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,bq,bk", CASES)
def test_plain_k2_k3_match_pallas_kernels(sq, sk, bq, bk, causal):
    """Both compute bf16 products with fp32 accumulation and an fp32
    softmax, in different orders: the TPU kernel goes block by block
    with an online max (p rounded to bf16 against a running max), the
    plain version in one pass against the row max. Tolerances (about
    5x the largest error seen over these cases): the logsumexp (fp32,
    |lse| ~ 6) within 1e-5 absolute; bf16 outputs within 1e-2 absolute
    and relative (one bf16 ulp at |x| in [1, 2) is 7.8e-3); each bf16
    gradient within 5e-3 x its largest magnitude (the two backwards
    recompute p from the same lse and round ds at the same point, but
    exp and the fp32 sums differ by an ulp, which can flip a bf16
    rounding)."""
    bh = 2
    qr, kr, vr = _bf16((bh, sq, D), 0), _bf16((bh, sk, D), 1), \
        _bf16((bh, sk, D), 2)
    gr = _bf16((bh, sq, D), 3)
    with pltpu.force_tpu_interpret_mode():
        out, lse = jfa._flash_forward_flat(qr, kr, vr, causal, SCALE, bq, bk)
        dq, dk, dv = jfa._flash_backward_flat(qr, kr, vr, out, lse, gr,
                                              causal, SCALE, bq, bk)
    q, k, v, g = (_port_layout(a) for a in (qr, kr, vr, gr))
    p_out, p_lse = port.flash_forward_plain(q, k, v, causal, SCALE)
    torch.testing.assert_close(p_lse, _t(lse), atol=1e-5, rtol=0)
    torch.testing.assert_close(p_out[:, :, 0].float(), _t(out).float(),
                               atol=1e-2, rtol=1e-2)
    # the backward alone: both sides get the Pallas forward's out and lse
    grads = port.flash_backward_plain(q, k, v, _port_layout(out), _t(lse),
                                      g, causal, SCALE)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
        assert got.dtype == torch.bfloat16, name
        want = _t(want).float()
        err = (got[:, :, 0].float() - want).abs().max().item()
        assert err <= 5e-3 * want.abs().max().item(), (name, err)


@pytest.mark.parametrize("causal,sq,sk", [(False, 48, 48), (True, 48, 48),
                                          (True, 32, 80), (False, 40, 24),
                                          (True, 48, 24), (True, 40, 30)])
def test_autograd_function_matches_jax_reference_fp32(causal, sq, sk):
    """The algorithm in fp32: `dot_product_attention` (the port's
    autograd Function, plain versions on CPU tensors) against
    `_attention_reference` and `jax.grad` of it; outputs and gradients
    within 1e-5 (fp32, different summation orders). Causal sq > sk
    leaves rows with no visible key: 24 of 48, and 10 of 40, where the
    first 16-row block mixes them with live rows."""
    rng = np.random.RandomState(7)
    b, h = 2, 3
    qn = rng.randn(b, sq, h, D).astype(np.float32)
    kn = rng.randn(b, sk, h, D).astype(np.float32)
    vn = rng.randn(b, sk, h, D).astype(np.float32)
    gn = rng.randn(b, sq, h, D).astype(np.float32)

    def f(q, k, v):
        return jfa._attention_reference(q, k, v, None, causal, SCALE)

    ref, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (qn, kn, vn)))
    jgrads = vjp(jnp.asarray(gn))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    out = port.dot_product_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(gn))
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_plain_forward_and_reference_agree_in_bf16():
    """`attention_reference` (the `_attention_reference` counterpart:
    scores rounded to bf16 before the fp32 softmax) and the plain K2
    (scores in fp32) differ only by that rounding."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(1, 64, 2, D).astype(np.float32))
               .bfloat16() for _ in range(3))
    ref = port.attention_reference(q, k, v, causal=True)
    out, _ = port.flash_forward_plain(q, k, v, True, SCALE)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2,
                               rtol=3e-2)


def test_cpu_path_counts_no_launch():
    port.FWD_LAUNCHES.reset()
    port.BWD_LAUNCHES.reset()
    q = torch.randn(1, 16, 2, D, requires_grad=True)
    out = port.dot_product_attention(q, q.detach(), q.detach(), causal=True)
    out.sum().backward()
    assert port.FWD_LAUNCHES.count == 0 and port.BWD_LAUNCHES.count == 0


def test_cuda_argument_checks_raise():
    """The checks the wrapper runs before a CUDA launch, exercised on
    CPU tensors: what neither kernel route takes raises, never a plain
    run; what they take returns its route (`test_routes`)."""
    bf = torch.bfloat16
    qkv = torch.zeros(2, 128, 3, 4, D, dtype=bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert port._check_cuda_args(q, k, v, causal=True) == port.WGMMA
    # causal sq > sk (rows with no visible key): taken, same route
    short_k = torch.zeros(2, 64, 4, D, dtype=bf)
    assert port._check_cuda_args(q, short_k, short_k, causal=True) \
        == port.WGMMA
    assert port._check_cuda_args(q, short_k, short_k, causal=False) \
        == port.WGMMA
    # head dim 32 in bf16: the wgmma kernels; fp32: the tf32x3 route
    small = torch.zeros(2, 128, 4, 32, dtype=bf)
    assert port._check_cuda_args(small, small, small, causal=True) \
        == port.WGMMA
    assert port._check_cuda_args(q.float(), k.float(), v.float(),
                                 causal=True) == port.TF32X3
    with pytest.raises(ValueError, match="head_dim"):
        wide = torch.zeros(2, 128, 4, 96, dtype=bf)
        port._check_cuda_args(wide, wide, wide, causal=True)
    with pytest.raises(TypeError, match="not supported"):
        port._check_cuda_args(q.half(), k.half(), v.half(), causal=True)
    with pytest.raises(TypeError, match="dtypes differ"):
        port._check_cuda_args(q, k.float(), v, causal=True)
    with pytest.raises(ValueError, match="contiguous head dim"):
        port._check_cuda_args(q.transpose(2, 3).contiguous().transpose(2, 3),
                              k, v, causal=True)
    odd = torch.zeros(2, 128, 4 * D + 4, dtype=bf)[..., :4 * D].reshape(
        2, 128, 4, D)
    with pytest.raises(ValueError, match="16-byte aligned"):
        port._check_cuda_args(odd, k, v, causal=True)
    with pytest.raises(ValueError, match="differ in batch"):
        port._check_cuda_args(q, k[:1], v[:1], causal=True)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "wgmma"), (torch.float32, 32, "tf32x3"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 128, "tf32x3")])
def test_routes(dtype, d, route):
    """The route is a fixed choice by dtype and head dim, the same for
    every shape: bf16 to the wgmma K2/K3, fp32 to their tf32x3 route.
    The tf32x3 route's split kernel needs only a contiguous head dim
    (plain loads), so an fp32 slice whose strides are no multiple of 16
    bytes is taken; the wgmma route reads through TMA and raises on it,
    at head dim 32 as at 64 and 128."""
    x = torch.zeros(2, 40, 3, d, dtype=dtype)
    for causal, k in ((False, x), (True, x), (True, x[:, :24])):
        assert port._check_cuda_args(x, k, k, causal) == route
    odd = torch.zeros(2, 40, 3 * d + 1, dtype=dtype)[..., :3 * d].unflatten(
        -1, (3, d))
    if route == "tf32x3":
        assert port._check_cuda_args(odd, x, x, False) == route
    else:
        with pytest.raises(ValueError, match="multiples of 8 elements"):
            port._check_cuda_args(odd, x, x, False)


def test_batch_times_heads_limit_is_the_32_bit_index():
    """b x h has no grid limit (the grids are persistent or flattened):
    66000 heads are taken; what remains is b x h x round_up(max(sq,
    sk), 128) < 2^31 (32-bit work items and lse rows), checked and
    named. Expanded views: no memory is allocated."""
    bf = torch.bfloat16
    x = torch.zeros(1, 1, 1, D, dtype=bf).expand(66000, 128, 1, D)
    assert port._check_cuda_args(x, x, x, causal=True) == port.WGMMA
    big = torch.zeros(1, 1, 1, D, dtype=bf).expand(1 << 17, 128, 128, D)
    with pytest.raises(ValueError, match="32-bit"):
        port._check_cuda_args(big, big, big, causal=False)
    tall = torch.zeros(1, 1, 1, D, dtype=bf).expand(1 << 10, 1 << 14, 128, D)
    with pytest.raises(ValueError, match="32-bit"):
        port._check_cuda_args(x[:1, :1].expand(1 << 10, 1, 128, D), tall,
                              tall, causal=False)


def test_plain_backward_alone_matches_jax_grad_on_empty_rows():
    """`flash_backward_plain` alone, causal sq 40 > sk 24 in fp32, on its
    own forward's residuals: the 16 rows with no visible key follow
    `jax.grad` of `_attention_reference` (dq = 0, no dk from them,
    dv += g / sk); every gradient within 1e-5. The forward gives such a
    row the mean of v and lse -1e30."""
    rng = np.random.RandomState(3)
    b, sq, sk, h = 1, 40, 24, 2
    qn, gn = (rng.randn(b, sq, h, D).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(b, sk, h, D).astype(np.float32) for _ in range(2))

    def f(q, k, v):
        return jfa._attention_reference(q, k, v, None, True, SCALE)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (qn, kn, vn)))
    jgrads = vjp(jnp.asarray(gn))
    q, k, v, g = (torch.from_numpy(a) for a in (qn, kn, vn, gn))
    out, lse = port.flash_forward_plain(q, k, v, True, SCALE)
    empty = port.empty_rows(sq, sk, True)
    assert int(empty.sum()) == sq - sk and bool(empty[:sq - sk].all())
    torch.testing.assert_close(out[:, :sq - sk],
                               v.mean(1, keepdim=True).expand(
                                   b, sq - sk, h, D), atol=1e-6, rtol=1e-6)
    assert bool((lse[:, :, :sq - sk] == -1e30).all())
    grads = port.flash_backward_plain(q, k, v, out, lse, g, True, SCALE)
    assert bool((grads[0][:, :sq - sk] == 0).all())
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_tma_layout_checks_raise():
    """What a TMA tensor map cannot take raises before any launch, on
    CPU tensors: a base that is not 16-byte aligned, a (batch, seq,
    head) stride that is not a multiple of 8 elements, a head dim that
    is not contiguous. The packed qkv (s-stride 3 h d) is taken, and so
    are `out` and `g` in the backward's layout check."""
    bf = torch.bfloat16
    qkv = torch.zeros(2, 64, 3, 4, D, dtype=bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    port._check_cuda_args(q, k, v, causal=False)
    port._check_tma_layout("out", torch.zeros(2, 64, 4, D, dtype=bf))
    # base 8 bytes past a 16-byte boundary, strides still multiples of 8
    flat = torch.zeros(2 * 64 * 4 * D + 4, dtype=bf)
    shifted = flat[4:].view(2, 64, 4, D)
    assert shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        port._check_cuda_args(shifted, k, v, causal=False)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        port._check_tma_layout("g", shifted)
    # a head stride of D + 4 elements (not a multiple of 8), base aligned
    wide = torch.zeros(2, 64, 4, D + 4, dtype=bf)[..., :D]
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        port._check_cuda_args(q, wide, v, causal=False)
    # a seq stride that is not a multiple of 8 (4 heads x D + 4)
    rows = torch.zeros(2, 64, 4 * D + 4, dtype=bf)[..., :4 * D].unflatten(
        -1, (4, D))
    assert rows.stride()[1] % 8 == 4
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        port._check_cuda_args(q, k, rows, causal=False)
    # the head dim strided (every other element)
    strided = torch.zeros(2, 64, 4, 2 * D, dtype=bf)[..., ::2]
    with pytest.raises(ValueError, match="contiguous head dim"):
        port._check_cuda_args(q, k, strided, causal=False)
    with pytest.raises(ValueError, match="contiguous head dim"):
        port._check_tma_layout("out", strided)


def test_lse_row_buffers_match_the_kernels_padding():
    """lse and the backward's delta rows live in rows padded to 128
    (`lse_rows` in csrc/flash_attention_common.cuh): the wrapper's
    buffers have that layout, and an lse in any other layout is not
    taken for one (the backward copies it first)."""
    for sq, rows in ((1, 128), (128, 128), (200, 256), (1024, 1024)):
        assert port._lse_rows(sq) == rows
        buf = port._row_buffer(2, 3, sq, "cpu")
        assert buf.shape == (2, 3, sq) and buf.stride() == (3 * rows, rows, 1)
        assert port._in_row_buffer(buf)
        assert port._bwd_rows(2, 3, sq, "cpu").shape == (2, 3, 2, rows)
    assert not port._in_row_buffer(torch.zeros(2, 3, 200))
    assert port._row_buffer(1, 1, 5, "cpu", zero=True).sum() == 0


@pytest.mark.parametrize("seed,b,s,h,d", [(0, 2, 48, 3, 64),
                                          (1, 1, 33, 2, 128)])
def test_delta_plain_matches_jax_rowsum(seed, b, s, h, d):
    """The delta kernel's plain version against the JAX computation in
    `_flash_backward_flat` (rowsum(out * g) in fp32 over the flattened
    (b * h, s, d) operands, reshaped to (b * h, 1, s)): bf16 inputs,
    fp32 on the CPU, within 1e-5 relative (summation order)."""
    rng = np.random.RandomState(seed)
    out = rng.randn(b, s, h, d).astype(np.float32)
    g = rng.randn(b, s, h, d).astype(np.float32)
    flat = [jnp.asarray(x, jnp.bfloat16).transpose(0, 2, 1, 3)
            .reshape(b * h, s, d) for x in (out, g)]
    want = jnp.sum(flat[0].astype(jnp.float32) * flat[1].astype(jnp.float32),
                   axis=-1).reshape(b * h, 1, s)
    got = port.flash_delta_plain(_t(jnp.asarray(out, jnp.bfloat16)),
                                 _t(jnp.asarray(g, jnp.bfloat16)))
    assert got.dtype == torch.float32 and got.shape == (b, h, s)
    np.testing.assert_allclose(got.reshape(b * h, 1, s).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mask_and_dropout_raise_on_every_device():
    q = torch.zeros(1, 8, 2, D)
    with pytest.raises(NotImplementedError, match="mask"):
        port.dot_product_attention(q, q, q, mask=torch.ones(8, 8, dtype=bool))
    with pytest.raises(NotImplementedError, match="dropout"):
        port.dot_product_attention(q, q, q, dropout_p=0.1)
