"""The fp16 route of K2/K3 (`wgmma_f16`) on the CPU: the plain versions
in fp16 against the TPU kernels in fp16, and the route's argument
checks.

`flash_forward_plain` / `flash_backward_plain` follow the input dtype:
fp16 products of exact operand values summed in fp32, p rounded to fp16
before p.v, ds = p (dp - delta) scale rounded to fp16. They are held
against `_flash_forward_flat` / `_flash_backward_flat` run in Pallas TPU
interpret mode on the CPU, in fp16, as `test_torch_flash_attention.py`
holds the bf16 ones. Tolerances (largest errors seen over these cases:
lse 9.5e-7, out 4.9e-4, gradients 6.5e-4 of their largest magnitude):
lse (fp32) within 1e-5 absolute; fp16 outputs within 2e-3
absolute and relative (one fp16 ulp at |x| in [1, 2) is 9.8e-4); each
fp16 gradient within 2e-3 x its largest magnitude (exp and the fp32
sums differ by an ulp between the two, which can flip an fp16
rounding). The kernels themselves run in `chip_smoke.py` (phase 3).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu.ops_pallas import flash_attention as jfa
from paddle_tpu_torch.ops_cuda import flash_attention as port
from port_threads import one_torch_thread  # noqa: F401

CASES = [(64, 256, 256, 128, 128), (64, 128, 256, 128, 128),
         (32, 256, 384, 256, 128), (128, 256, 256, 128, 256)]


def _f16(shape, seed):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape),
                       jnp.float16)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,sq,sk,bq,bk", CASES)
def test_plain_fp16_k2_k3_match_pallas_kernels(d, sq, sk, bq, bk, causal):
    bh, scale = 2, 1.0 / math.sqrt(d)
    qr, kr, vr = _f16((bh, sq, d), 0), _f16((bh, sk, d), 1), \
        _f16((bh, sk, d), 2)
    gr = _f16((bh, sq, d), 3)
    with pltpu.force_tpu_interpret_mode():
        out, lse = jfa._flash_forward_flat(qr, kr, vr, causal, scale, bq, bk)
        dq, dk, dv = jfa._flash_backward_flat(qr, kr, vr, out, lse, gr,
                                              causal, scale, bq, bk)
    q, k, v, g = (_t(a)[:, :, None, :] for a in (qr, kr, vr, gr))
    p_out, p_lse = port.flash_forward_plain(q, k, v, causal, scale)
    assert p_out.dtype == torch.float16
    torch.testing.assert_close(p_lse, _t(lse).reshape(bh, 1, sq),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(p_out[:, :, 0].float(), _t(out).float(),
                               atol=2e-3, rtol=2e-3)
    grads = port.flash_backward_plain(q, k, v, p_out, p_lse, g, causal,
                                      scale)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
        assert got.dtype == torch.float16
        w = _t(want).float()
        err = (got[:, :, 0].float() - w).abs().max().item()
        assert err <= 2e-3 * w.abs().max().item(), (name, err)


def test_autograd_function_fp16_on_cpu_counts_no_launch():
    port.FWD_LAUNCHES.reset()
    port.WGMMA_F16_BWD_LAUNCHES.reset()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 32, 2, 64, generator=gen).half().requires_grad_()
    out = port.dot_product_attention(q, q.detach(), q.detach(), causal=True)
    assert out.dtype == torch.float16
    out.float().sum().backward()
    assert q.grad.dtype == torch.float16 and torch.isfinite(q.grad).all()
    assert port.FWD_LAUNCHES.count == 0
    assert port.WGMMA_F16_BWD_LAUNCHES.count == 0


@pytest.mark.parametrize("d", [32, 64, 128])
def test_fp16_route_and_its_layout_checks(d):
    """fp16 takes the wgmma_f16 route at d 32, 64 and 128, through TMA
    (the bf16 route's layout rules: 16-byte aligned rows)."""
    x = torch.zeros(2, 40, 3, d, dtype=torch.float16)
    for causal, k in ((False, x), (True, x), (True, x[:, :24])):
        assert port._check_cuda_args(x, k, k, causal) == port.WGMMA_F16
    qkv = torch.zeros(2, 40, 3, 3, d, dtype=torch.float16)
    assert port._check_cuda_args(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                 True) == port.WGMMA_F16
    odd = torch.zeros(2, 40, 3 * d + 1, dtype=torch.float16)[
        ..., :3 * d].unflatten(-1, (3, d))
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        port._check_cuda_args(odd, x, x, False)
    with pytest.raises(TypeError, match="dtypes differ"):
        port._check_cuda_args(x, x.bfloat16(), x, False)
    assert port._DTYPE_CODE[torch.float16] == 2
