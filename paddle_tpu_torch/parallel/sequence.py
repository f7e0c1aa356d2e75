"""Sequence (context) parallel attention over the "sp" mesh axis: the
counterpart of `paddle_tpu/parallel/sequence.py` (`ring_attention`,
`ulysses_attention`, `split_sequence`, `gather_sequence`).

Layout (b, s, h, d). Inside an SPMD run with sp > 1 (`Trainer(mesh=)`,
`parallel.spmd`) each sp rank passes its sequence chunk (b, S/sp, h, d)
and gets its chunk of the output; called outside a run with a mesh of
sp > 1, a function takes the global (b, S, h, d) tensors, runs the sp
ranks itself and returns the global output, as JAX's `shard_map`
entries do. At sp 1 both are plain attention.

- **Ulysses** (`ulysses_attention`): an `all_to_all` moves the
  sequence shards to head groups, each rank attends the whole sequence
  for its heads % sp == 0 heads through the flash kernels K2/K3, and a
  second `all_to_all` moves the result back.
- **Ring** (`ring_attention`): rank i's queries meet kv chunk j through
  K2 (`ops_cuda.flash_attention.flash_forward`), giving (out_ij,
  lse_ij): the diagonal pair causal, the pairs below it full, the pairs
  above it skipped when the attention is causal (all of them hidden).
  The pairs merge by log-sum-exp. K and V reach rank i over sp - 1
  `ppermute` hops around the ring, each counted. The backward runs K3
  per pair (`flash_backward(q, k, v, out, lse, g, ...)`) fed with the
  MERGED out and lse, which is the maths of JAX's custom VJP
  (`sequence.py:112-160`): dq sums over j, dk and dv over i.

Deviations. JAX computes each ring step and each Ulysses group with
`_attention_reference` (`sequence.py:175-178`, `:213-215`); the port
runs the flash kernels there, so the three routes (dense, Ulysses,
ring) all run K2/K3. JAX's ring backward rotates K/V again and sends
dk/dv home with them (its residuals are O(S/sp) per chip); here the
backward runs after the SPMD run, where ranks cannot meet, so a
rank's ring node holds the kv chunks its forward received (the ranks
share one device, where they are alive anyway) and its dk/dv reach
the owners' graphs through the hops' autograd edges.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..nn import ranks
from ..ops_cuda import flash_attention as fa
from .mesh import Mesh, get_mesh, mesh_shape

__all__ = ["ring_attention", "ulysses_attention", "split_sequence",
           "gather_sequence"]


def _sp_degree(mesh: Optional[Mesh], axis: str) -> int:
    mesh = mesh or get_mesh()
    return mesh_shape(mesh).get(axis, 1) if mesh is not None else 1


def _global_call(fn, q, k, v, axis: str, n: int):
    """`fn(q_chunk, k_chunk, v_chunk)` on each of n ranks of an SPMD run
    over `axis`, the global tensors split along the sequence and the
    ranks' outputs joined."""
    for t in (q, k, v):
        if t.shape[1] % n:
            raise ValueError(f"sequence {t.shape[1]} does not split over "
                             f"{axis}={n}")
    qs, ks, vs = (t.chunk(n, dim=1) for t in (q, k, v))
    outs = ranks.spmd([{axis: i} for i in range(n)],
                      lambda i: fn(qs[i], ks[i], vs[i]))
    return torch.cat(outs, dim=1)


class _RingAttention(torch.autograd.Function):
    """Rank i's queries against the kv chunks of ranks (i - r) % n,
    r = 0 .. n-1, given in that order: K2 per pair, merged by
    log-sum-exp; K3 per pair in the backward."""

    @staticmethod
    def forward(ctx, q, causal, scale, i, n, *kv):
        ks, vs = kv[:n], kv[n:]
        b, sq, h, d = q.shape
        outs, lses = [], []
        pairs = []
        for r in range(n):
            src = (i - r) % n
            if causal and src > i:
                continue
            diag = causal and src == i
            o, lse = fa.flash_forward(q, ks[r], vs[r], diag, scale)
            pairs.append((r, diag))
            outs.append(o)
            lses.append(lse)
        lse = torch.logsumexp(torch.stack(lses), dim=0)       # (b, h, sq)
        acc = None
        for o, l_ in zip(outs, lses):
            w = torch.exp(l_ - lse).permute(0, 2, 1)[..., None]
            t = o.float() * w
            acc = t if acc is None else acc + t
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, out, lse, *kv)
        ctx.pairs, ctx.scale, ctx.n = pairs, scale, n
        return out

    @staticmethod
    def backward(ctx, g):
        q, out, lse, *kv = ctx.saved_tensors
        n = ctx.n
        ks, vs = kv[:n], kv[n:]
        g = g.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dks = [torch.zeros_like(t) for t in ks]
        dvs = [torch.zeros_like(t) for t in vs]
        for r, diag in ctx.pairs:
            dq_r, dks[r], dvs[r] = fa.flash_backward(
                q, ks[r], vs[r], out, lse, g, diag, ctx.scale)
            dq += dq_r.float()
        return (dq.to(q.dtype), None, None, None, None, *dks, *dvs)


def _ring_chunk(q, k, v, axis: str, causal: bool, scale: float):
    """This rank's output chunk of ring attention inside an SPMD run."""
    from . import collective as C
    i, n = ranks.axis_info(axis)
    perm = [(j, (j + 1) % n) for j in range(n)]
    ks, vs = [k], [v]
    for _ in range(n - 1):
        ks.append(C.ppermute(ks[-1], perm, group=axis))
        vs.append(C.ppermute(vs[-1], perm, group=axis))
    return _RingAttention.apply(q, causal, scale, i, n, *ks, *vs)


def ring_attention(q, k, v, mesh: Optional[Mesh] = None, axis: str = "sp",
                   causal: bool = False, scale: Optional[float] = None):
    """Attention over a sequence split over `axis` (see the module
    docstring): a rank's chunk in, its chunk out inside an SPMD run;
    the global (b, S, h, d) tensors outside one."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _, n = ranks.axis_info(axis)
    if n > 1:
        return _ring_chunk(q, k, v, axis, causal, scale)
    n = _sp_degree(mesh, axis) if not ranks.in_run() else 1
    if n == 1:
        return fa.dot_product_attention(q, k, v, causal=causal, scale=scale)
    return _global_call(lambda a, b_, c: _ring_chunk(a, b_, c, axis, causal,
                                                     scale),
                        q, k, v, axis, n)


def _ulysses_chunk(q, k, v, axis: str, causal: bool, scale):
    from . import collective as C
    _, n = ranks.axis_info(axis)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"num_heads {h} % sp {n} != 0")

    def to_heads(x):            # (b, S/sp, h, d) -> (b, S, h/sp, d)
        return C.all_to_all(x, group=axis, split_axis=2, concat_axis=1)

    out = fa.dot_product_attention(to_heads(q), to_heads(k), to_heads(v),
                                   causal=causal, scale=scale)
    return C.all_to_all(out, group=axis, split_axis=1, concat_axis=2)


def ulysses_attention(q, k, v, mesh: Optional[Mesh] = None,
                      axis: str = "sp", causal: bool = False,
                      scale: Optional[float] = None):
    """DeepSpeed-Ulysses (see the module docstring); raises ValueError
    when the heads do not split over sp."""
    _, n = ranks.axis_info(axis)
    if n > 1:
        return _ulysses_chunk(q, k, v, axis, causal, scale)
    n = _sp_degree(mesh, axis) if not ranks.in_run() else 1
    if n == 1:
        return fa.dot_product_attention(q, k, v, causal=causal, scale=scale)
    if q.shape[2] % n:
        raise ValueError(f"num_heads {q.shape[2]} % sp {n} != 0")
    return _global_call(lambda a, b_, c: _ulysses_chunk(a, b_, c, axis,
                                                        causal, scale),
                        q, k, v, axis, n)


def split_sequence(x, mesh: Optional[Mesh] = None, axis: str = "sp",
                   dim: int = 1):
    """Inside an SPMD run with sp > 1, this rank's chunk of the whole
    `x` along `dim`; `x` itself elsewhere (a JAX sharding constraint
    changes no value)."""
    i, n = ranks.axis_info(axis)
    if n == 1:
        return x
    return x.chunk(n, dim=dim)[i]


def gather_sequence(x, mesh: Optional[Mesh] = None, axis: str = "sp",
                    dim: int = 1):
    """Inside an SPMD run with sp > 1, the ranks' chunks joined along
    `dim` by `all_gather`; `x` itself elsewhere."""
    _, n = ranks.axis_info(axis)
    if n == 1:
        return x
    from . import collective as C
    return C.all_gather(x, group=axis, axis=dim)
