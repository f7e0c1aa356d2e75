"""The arithmetic of the tf32x3 flash route (fp32 attention on the
tensor cores, `paddle_tpu_torch/ops_cuda/flash_attention.py`) emulated
in plain torch on the CPU.

Every fp32 product of the route's kernels runs as three TF32 products:
each operand x splits into hi = x with its 13 low mantissa bits cleared
and lo = x - hi rounded to TF32 (`tf32_split`), and a . b = lo_a hi_b +
hi_a lo_b + hi_a hi_b, each part exact in TF32. Here the three products
are summed in fp64, the rest
of the forward and backward (masks, exp, the row sums, delta, the
rows with no visible key) runs as the plain versions run it, and the
result is held against `flash_forward_plain` / `flash_backward_plain`
in fp32 at `gpt_tiny`'s head shape (4 heads of 32): within 1e-5 of
max|plain|, the tolerance the card's phase 3 holds the kernels to. One
TF32 product per product, printed beside it, misses that by about two
orders of magnitude. A model of the tensor cores' truncating
accumulation shows why the backward sums each swept tile into a fresh
accumulator while the forward keeps one running sum. The kernels
themselves run in `chip_smoke.py`.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops_cuda import flash_attention as port
from port_threads import one_torch_thread  # noqa: F401

NEG_INF = -1e30


def _mm3(a, b):
    """a @ b as 3xTF32: the three products of the split parts summed in
    fp64, rounded to fp32 (the kernels sum them in the fp32
    accumulator)."""
    ah, al = port.tf32_split(a)
    bh, bl = port.tf32_split(b)
    f = torch.float64
    return (al.to(f) @ bh.to(f) + ah.to(f) @ bl.to(f)
            + ah.to(f) @ bh.to(f)).float()


def _mm1(a, b):
    """a @ b as one TF32 product (the operands' low 13 bits cleared, as
    the card reads raw fp32; chip_smoke's probe records its rule),
    summed in fp64."""
    ta, tb = port.tf32_split(a)[0], port.tf32_split(b)[0]
    return (ta.double() @ tb.double()).float()


def _attention(q, k, v, g, causal, scale, mm):
    """The route's forward and backward with the products through `mm`:
    (out, lse, dq, dk, dv) in the port's layouts. The backward takes the
    plain forward's out and lse, as the kernels' test on the card holds
    the backward on one forward's residuals."""
    sq, sk = q.shape[1], k.shape[1]
    qh, kh, vh, gh = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
    keep = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq) if causal \
        else torch.ones(sq, sk, dtype=torch.bool)
    empty = port.empty_rows(sq, sk, causal)[:, None]
    s = torch.where(keep, mm(qh, kh.transpose(-1, -2)) * scale, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_ = p.sum(-1, keepdim=True)
    out = (mm(p, vh) / l_).permute(0, 2, 1, 3)
    lse = torch.where(empty[:, 0], NEG_INF, (m + torch.log(l_))[..., 0])

    pout, plse = port.flash_forward_plain(q, k, v, causal, scale)
    p = torch.where(empty, 1.0 / sk, torch.exp(s - plse[..., None]))
    dv = mm(p.transpose(-1, -2), gh)
    dp = mm(gh, vh.transpose(-1, -2))
    delta = port.flash_delta_plain(pout, g)[..., None]
    ds = torch.where(empty, 0.0, p * (dp - delta) * scale)
    dq, dk = mm(ds, kh), mm(ds.transpose(-1, -2), qh)
    return (out, lse, *(x.permute(0, 2, 1, 3) for x in (dq, dk, dv)))


def test_split_parts_are_tf32_and_sum_to_x():
    """hi and lo carry no bit below TF32's 10 mantissa bits; hi + lo is
    x within 2^-21 |x| (lo rounded to nearest) for small, large and
    negative values, and exactly where x has at most 21 significant
    bits."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32)) * torch.logspace(-30, 30, 4096)
    hi, lo = port.tf32_split(x)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 8191) == 0).all())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -21).all())
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -10).all())
    short = (x.view(torch.int32) & -4).view(torch.float32)
    assert torch.equal(sum(port.tf32_split(short)), short)


@pytest.mark.parametrize("causal,sq,sk", [(False, 128, 128), (True, 128, 128),
                                          (True, 96, 64), (True, 64, 128)])
def test_tf32x3_attention_holds_the_fp32_tolerance(causal, sq, sk):
    """gpt_tiny's head shape (b 2, h 4, d 32), fp32, causal and not,
    causal sq > sk (32 rows with no visible key) and sq < sk: out, lse
    and each gradient of the 3xTF32 emulation within 1e-5 x max|plain|
    of the plain versions, where one TF32 product per product is
    printed for comparison (and asserted to miss)."""
    rng = np.random.RandomState(1)
    b, h, d = 2, 4, 32
    scale = 1.0 / math.sqrt(d)
    q, g = (torch.from_numpy(rng.randn(b, sq, h, d).astype(np.float32))
            for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, sk, h, d).astype(np.float32))
            for _ in range(2))
    pout, plse = port.flash_forward_plain(q, k, v, causal, scale)
    plain = (pout, plse,
             *port.flash_backward_plain(q, k, v, pout, plse, g, causal,
                                        scale))
    live = ~port.empty_rows(sq, sk, causal)
    worst = {}
    for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1)):
        got = _attention(q, k, v, g, causal, scale, mm)
        rel = []
        for i, (x, want) in enumerate(zip(got, plain)):
            if i == 1:      # lse: the rows that see a key (-1e30 elsewhere)
                x, want = x[:, :, live], want[:, :, live]
            rel.append(((x - want).abs().max() / want.abs().max()).item())
        worst[name] = max(rel)
        print(f"{name}: out, lse, dq, dk, dv max err / max|plain| "
              + ", ".join(f"{r:.2e}" for r in rel))
    assert worst["3xTF32"] <= 1e-5, worst
    assert worst["1xTF32"] > 1e-5, worst


def _toward_zero(x64):
    """fp64 -> fp32 rounded toward zero."""
    f = x64.float()
    bits = f.view(torch.int32)
    away = f.double().abs() > x64.abs()
    return torch.where(away, bits - 1, bits).view(torch.float32)


def _truncating_sums(a, b, tile: int, fresh: bool):
    """a @ b over k as the kernels' 3xTF32 k8 steps (lo.hi, hi.lo, hi.hi
    of every 8 k), each step added into the fp32 accumulator rounded
    toward zero, as the tensor cores add it: into one running
    accumulator, or into a fresh one per tile of `tile` k that is then
    added to the running sum with a rounding fp32 add."""
    ah, al = port.tf32_split(a)
    bh, bl = port.tf32_split(b)
    acc = torch.zeros(a.shape[:-1] + (b.shape[-1],))
    for t0 in range(0, a.shape[-1], tile):
        t = torch.zeros_like(acc) if fresh else acc
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            for k0 in range(t0, t0 + tile, 8):
                t = _toward_zero(t.double() + x[..., k0:k0 + 8].double()
                                 @ y[..., k0:k0 + 8, :].double())
        acc = acc + t if fresh else t
    return acc


@pytest.mark.parametrize("which,s,d,tile,running_holds", [
    ("dv", 1024, 64, 16, False), ("out", 2048, 128, 32, True)])
def test_truncating_accumulation_by_tile(which, s, d, tile, running_holds):
    """One head of causal fp32 attention (numpy seed 0) with the
    tensor cores' truncating accumulation. dV = P^T G at GPT-small's head
    dim, summed over the dk/dv kernel's 16-query tiles: one running sum
    misses 1e-5 of max|plain| (the card's dk and dv did at s 1024), a
    fresh sum per tile added in fp32, which the backward kernels do,
    holds it. out = P V / l at gpt_1p3b's head dim and longest rows,
    summed over the forward's 32-key tiles at d 128: both hold it, so the
    forward keeps one running sum (the model leaves out the online
    softmax's rescales, each one rounding fp32 multiply)."""
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(1, s, 1, d).astype(np.float32))
                  for _ in range(4))
    scale = 1 / math.sqrt(d)
    out, lse = port.flash_forward_plain(q, k, v, True, scale)
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    sc = torch.where(keep, (q[0, :, 0] @ k[0, :, 0].T) * scale, NEG_INF)
    if which == "dv":
        p = torch.exp(sc - lse[0, 0, :, None])
        a, b, l_ = p.T.contiguous(), g[0, :, 0].contiguous(), 1.0
        want = port.flash_backward_plain(q, k, v, out, lse, g, True,
                                         scale)[2][0, :, 0]
    else:
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        a, b, l_ = p, v[0, :, 0].contiguous(), p.sum(-1, keepdim=True)
        want = out[0, :, 0]
    rel = {}
    for fresh in (False, True):
        got = _truncating_sums(a, b, tile, fresh) / l_
        rel[fresh] = ((got - want).abs().max() / want.abs().max()).item()
    print(f"{which}, s {s}, d {d}, {tile}-row tiles, truncated steps: one "
          f"running sum {rel[False]:.2e}, a fresh sum per tile "
          f"{rel[True]:.2e} of max|plain| (limit 1e-5)")
    assert rel[True] <= 1e-5, rel
    assert (rel[False] <= 1e-5) == running_holds, rel
