"""K2/K3 as `torch.library` operators (`paddle_tpu_torch::
flash_attention_fwd` / `flash_attention_bwd`, `ops_cuda/flash_attention.py`)
on CPU tensors, where their implementations are the plain versions.

- `torch.library.opcheck` passes on both operators (schema, fake
  implementation against the real one, autograd registration, AOT
  dispatch), fp32 and bf16, causal and not, sq != sk;
- the forward returns the logsumexp as the whole (b, h,
  round_up(sq, 128)) row buffer K3 reads, the plain lse in its first sq
  columns and zeros after;
- attention through the operator (`dot_product_attention`) gives the
  plain versions' output and, through the registered autograd, their
  gradients, bitwise;
- an exported call holds one forward node, and running the program
  under autograd reaches the backward operator (the operators call the
  module's `flash_forward` / `flash_backward`, counted here).
"""
import pytest
import torch

from paddle_tpu_torch.ops_cuda import flash_attention as fa
from port_threads import one_torch_thread  # noqa: F401

SCALE = 0.3


def _qkv(dtype, sq=5, sk=7, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = lambda s: (2, s, 2, 32)           # noqa: E731
    return [torch.randn(shape(s), generator=g).to(dtype)
            for s in (sq, sk, sk)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_opcheck(dtype, causal):
    q, k, v = _qkv(dtype)
    torch.library.opcheck(fa.flash_attention_fwd,
                          (q.requires_grad_(), k, v, causal, SCALE))
    out, lse = fa.flash_attention_fwd(q.detach(), k, v, causal, SCALE)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    torch.library.opcheck(fa.flash_attention_bwd,
                          (q.detach(), k, v, out, lse, g, causal, SCALE))


def test_lse_row_buffer_and_plain_equality():
    q, k, v = _qkv(torch.float32)
    out, lse = fa.flash_attention_fwd(q, k, v, True, SCALE)
    p_out, p_lse = fa.flash_forward_plain(q, k, v, True, SCALE)
    assert lse.shape == (2, 2, 128) and lse.is_contiguous()
    torch.testing.assert_close(out, p_out, rtol=0, atol=0)
    torch.testing.assert_close(lse[..., :5], p_lse, rtol=0, atol=0)
    assert not lse[..., 5:].any()


def test_autograd_through_the_operator_is_the_plain_backward():
    q, k, v = [t.requires_grad_() for t in _qkv(torch.float32, 6, 6)]
    out = fa.dot_product_attention(q, k, v, causal=True, scale=SCALE)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    grads = torch.autograd.grad(out, (q, k, v), g)
    p_out, p_lse = fa.flash_forward_plain(q.detach(), k.detach(),
                                          v.detach(), True, SCALE)
    want = fa.flash_backward_plain(q.detach(), k.detach(), v.detach(),
                                   p_out, p_lse, g, True, SCALE)
    torch.testing.assert_close(out.detach(), p_out, rtol=0, atol=0)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_exported_program_runs_both_operators(monkeypatch):
    class Attn(torch.nn.Module):
        def forward(self, q, k, v):
            return fa.dot_product_attention(q, k, v, causal=False,
                                            scale=SCALE)

    q, k, v = _qkv(torch.float32, 4, 4)
    ep = torch.export.export(Attn(), (q, k, v), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert targets.count(
        "paddle_tpu_torch.flash_attention_fwd.default") == 1
    calls = {"fwd": 0, "bwd": 0}
    plain_fwd, plain_bwd = fa.flash_forward, fa.flash_backward

    def fwd(*a):
        calls["fwd"] += 1
        return plain_fwd(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return plain_bwd(*a)
    monkeypatch.setattr(fa, "flash_forward", fwd)
    monkeypatch.setattr(fa, "flash_backward", bwd)
    q.requires_grad_()
    out = ep.module()(q, k, v)
    torch.testing.assert_close(out, Attn()(q, k, v), rtol=0, atol=0)
    (g,) = torch.autograd.grad(out.square().sum(), q)
    assert calls == {"fwd": 2, "bwd": 1}     # the program's, eager's; K3
    (want,) = torch.autograd.grad(Attn()(q, k, v).square().sum(), q)
    torch.testing.assert_close(g, want, rtol=0, atol=0)
