"""Pipeline parallelism over the "pp" mesh axis: the counterpart of
`paddle_tpu/parallel/pipeline.py` (`stack_block_params`,
`unstack_block_params`, `interleave_order`, `bubble_fraction`,
`_num_ticks`, `pipeline_apply`, `LayerDesc`, `SegmentLayers`,
`PipelineStack`).

The schedule is JAX's tick loop (`pipeline.py:208-275`), run by each
pp rank of an SPMD run (`Trainer(mesh=)`, `parallel.spmd`), or, called
outside a run with a mesh of pp > 1, by the pp ranks the call runs
itself:

- every stage holds one in-flight activation and its hop count k;
  stage 0 injects the next microbatch into a dead slot (k = pp * v)
  while microbatches remain;
- a live slot runs the stage's chunk of layers (chunk k // pp of its
  v: with `virtual_degree` v > 1 the stacked layers are in
  `interleave_order`, stage s holding chunks s, s + pp, ...), and an
  activation makes v laps of the ring;
- each tick one `ppermute` over "pp" moves the activations to the
  next stage (a dead slot's zeros): `_num_ticks` ticks, `_num_ticks`
  ppermutes; the hop counts, which depend on the schedule only, each
  stage follows for all stages;
- the last stage emits an activation whose k reaches pp * v, in
  microbatch order; the (num_micro, mb, ...) outputs (zeros on the
  other stages) are reduce-scattered over "pp" when num_micro % pp ==
  0 (else all-reduced), and the scattered pieces all-gathered, so
  every rank returns the global (B, ...) output, as JAX's sharded
  global array holds it.

Deviation: a dead slot computes nothing here (JAX computes garbage
there and drops it); the schedule, its collectives and its outputs are
the same. The backward is one backward over the ranks' graphs (the
Trainer's joint backward), which runs the ticks in reverse as JAX's
autodiff of the scan does; the stages' parameters stay whole and
replicated, each stage's gradient reaching only its blocks, summed
over "pp" by the Trainer.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from ..nn import ranks
from .mesh import Mesh, get_mesh, mesh_shape

__all__ = ["stack_block_params", "unstack_block_params", "pipeline_apply",
           "PipelineStack", "LayerDesc", "SegmentLayers",
           "interleave_order", "bubble_fraction"]


def stack_block_params(blocks: List[nn.Module]) -> Dict[str, torch.Tensor]:
    """{param path: (L, ...)} across homogeneous blocks (differentiable:
    a stacked row's gradient reaches its block's parameter)."""
    per = [dict(b.named_parameters()) for b in blocks]
    keys = list(per[0])
    for p in per[1:]:
        if list(p) != keys:
            raise ValueError("pipeline blocks must be homogeneous")
    return {k: torch.stack([p[k] for p in per]) for k in keys}


def unstack_block_params(stacked: Dict[str, torch.Tensor],
                         blocks: List[nn.Module]):
    """Write row i of each stacked tensor into blocks[i]'s parameter."""
    with torch.no_grad():
        for i, b in enumerate(blocks):
            named = dict(b.named_parameters())
            for k, v in stacked.items():
                named[k].copy_(v[i])
    return blocks


def interleave_order(num_layers: int, pp: int, virtual_degree: int
                     ) -> List[int]:
    """The global layer order that puts stage s's v chunks contiguous
    (chunk c of the original order lives on stage c mod pp)."""
    chunks = pp * virtual_degree
    if num_layers % chunks:
        raise ValueError(f"layers {num_layers} % (pp*virtual) {chunks} != 0")
    lc = num_layers // chunks
    order = []
    for s in range(pp):
        for j in range(virtual_degree):
            c = j * pp + s
            order.extend(range(c * lc, (c + 1) * lc))
    return order


def bubble_fraction(num_micro: int, pp: int, virtual_degree: int = 1
                    ) -> float:
    """Idle fraction of the tick schedule (fill and drain over all)."""
    t = _num_ticks(num_micro, pp, virtual_degree)
    return 1.0 - num_micro * virtual_degree / t


def _num_ticks(num_micro: int, pp: int, v: int) -> int:
    # ceil(num_micro / pp) injection groups of pp * v ticks each, plus
    # the (pp - 1)-tick drain of the last group
    groups = -(-num_micro // pp)
    return groups * pp * v + (pp - 1)


def _schedule(layer: Callable, num_layers: int, x, num_micro: int,
              axis: str, out_fn: Optional[Callable], v: int):
    """This pp rank's part of the tick loop (see the module docstring);
    `layer(i, h)` applies row i of the stacked order."""
    from . import collective as C
    stage, pp = ranks.axis_info(axis)
    B = x.shape[0]
    mb = B // num_micro
    xm = x.reshape(num_micro, mb, *x.shape[1:])
    if num_layers % (pp * v):
        raise ValueError(f"layers {num_layers} % (pp*virtual) {pp * v} "
                         f"!= 0")
    lc = num_layers // (pp * v)
    hops = pp * v
    dead = hops
    perm = [(i, (i + 1) % pp) for i in range(pp)]
    # the hop counts are data-independent: every stage follows all of
    # them (JAX permutes them beside the activations)
    ks, injected = [dead] * pp, 0
    act = torch.zeros_like(xm[0])
    emitted: List[torch.Tensor] = []
    for _ in range(_num_ticks(num_micro, pp, v)):
        if ks[0] >= dead and injected < num_micro:
            ks[0] = 0
            if stage == 0:
                act = xm[injected]
            injected += 1
        k = ks[stage]
        y = act
        if k < dead:
            base = stage * (num_layers // pp) + min(k // pp, v - 1) * lc
            for j in range(lc):
                y = layer(base + j, y)
            if stage == pp - 1 and k + 1 == hops:
                emitted.append(y)
        ks = [min(ks[(i - 1) % pp] + 1, dead) for i in range(pp)]
        act = C.ppermute(y, perm, group=axis)
    if stage == pp - 1:
        out = torch.stack(emitted)
        if out_fn is not None:
            out = out_fn(out)
    else:
        proto = xm if out_fn is None else out_fn(xm)
        out = torch.zeros_like(proto)
    if num_micro % pp == 0:
        out = C.all_gather(C.reduce_scatter(out, group=axis, axis=0),
                           group=axis, axis=0)
    else:
        out = C.all_reduce(out, group=axis)
    return out.reshape(B, *out.shape[2:])


def _run(layer: Callable, num_layers: int, x, num_micro: int,
         mesh: Optional[Mesh], axis: str, out_fn, v: int):
    if x.shape[0] % num_micro:
        raise ValueError(f"batch {x.shape[0]} % microbatches {num_micro} "
                         f"!= 0")
    _, pp = ranks.axis_info(axis)
    if pp > 1:
        return _schedule(layer, num_layers, x, num_micro, axis, out_fn, v)
    if not ranks.in_run():
        mesh = mesh or get_mesh()
        pp = mesh_shape(mesh).get(axis, 1) if mesh is not None else 1
    if pp > 1:
        return ranks.spmd([{axis: s} for s in range(pp)],
                          lambda s: _schedule(layer, num_layers, x,
                                              num_micro, axis, out_fn,
                                              v))[0]
    out = x
    for i in range(num_layers):
        out = layer(i, out)
    if out_fn is not None:
        B = x.shape[0]
        out = out_fn(out.reshape(num_micro, B // num_micro,
                                 *out.shape[1:]))
        out = out.reshape(B, *out.shape[2:])
    return out


def pipeline_apply(block: nn.Module, stacked_params: Dict[str, torch.Tensor],
                   x, num_micro: int, mesh: Optional[Mesh] = None,
                   axis: str = "pp", rngs=None,
                   out_fn: Optional[Callable] = None,
                   virtual_degree: int = 1):
    """The pipelined stack: `block` applied with row i of every stacked
    (L, ...) parameter for i = 0 .. L-1 (rows in `interleave_order`
    when virtual_degree > 1, see `PipelineStack.stacked_params`), over
    the full (B, ...) batch `x` in `num_micro` microbatches; returns
    the full (B, ...) output. `out_fn` maps the last stage's (num_micro,
    mb, ...) outputs. `rngs` is accepted for parity (dropout draws from
    the installed key)."""
    L = next(iter(stacked_params.values())).shape[0]

    def layer(i, h):
        return torch.func.functional_call(
            block, {k: t[i] for k, t in stacked_params.items()}, (h,))

    return _run(layer, L, x, num_micro, mesh, axis, out_fn, virtual_degree)


class LayerDesc:
    """Deferred layer construction (the reference's pp_layers.py:58)."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SegmentLayers:
    """Split `num_items` layers into `num_parts` (uniform; the
    reference's pp_layers.py:90)."""

    def __init__(self, num_items, num_parts, method="uniform"):
        self.num_items = num_items
        self.num_parts = num_parts

    def do_segment(self):
        base = self.num_items // self.num_parts
        rem = self.num_items % self.num_parts
        bounds = [0]
        for i in range(self.num_parts):
            bounds.append(bounds[-1] + base + (1 if i < rem else 0))
        return bounds


def _pp_degree(mesh: Optional[Mesh], axis: str) -> int:
    _, n = ranks.axis_info(axis)
    if n > 1:
        return n
    mesh = mesh or get_mesh()
    return mesh_shape(mesh).get(axis, 1) if mesh is not None else 1


class PipelineStack(nn.Module):
    """A homogeneous pipelined stack of `num_layers` blocks
    (`block_factory(i)`): `forward` runs them in order;
    `pipeline_forward` runs the tick schedule over them (no stacked
    copy: a row of the order is its block). `num_micro` None resolves
    from the fleet strategy's `pipeline_configs.accumulate_steps` at
    call time."""

    def __init__(self, block_factory: Callable[[int], nn.Module],
                 num_layers: int, num_micro: Optional[int] = None,
                 axis: str = "pp", virtual_degree: int = 1):
        super().__init__()
        self.blocks = nn.ModuleList(block_factory(i)
                                    for i in range(num_layers))
        self.num_layers = num_layers
        self.num_micro = num_micro
        self.axis = axis
        self.virtual_degree = virtual_degree
        # the structure donor for `pipeline_apply` over stacked rows; a
        # submodule, as JAX's (its parameters, which no forward reads,
        # are in the state and get zero gradients there too)
        self._template = block_factory(0)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x

    def _resolve_micro(self, num_micro=None) -> int:
        if num_micro is not None:
            return num_micro
        if self.num_micro is not None:
            return self.num_micro
        from .fleet import get_strategy
        s = get_strategy()
        if s is not None and s.pipeline:
            return s.pipeline_configs.accumulate_steps
        return 1

    def _order(self, mesh: Optional[Mesh]) -> List[int]:
        pp = _pp_degree(mesh, self.axis)
        if self.virtual_degree > 1 and pp > 1:
            return interleave_order(self.num_layers, pp, self.virtual_degree)
        return list(range(self.num_layers))

    def stacked_params(self, mesh: Optional[Mesh] = None):
        """Stacked (L, ...) parameters, rows in `interleave_order` when
        virtual_degree > 1 and the mesh's pp > 1."""
        return stack_block_params([self.blocks[i]
                                   for i in self._order(mesh)])

    def load_stacked_params(self, stacked: Dict[str, torch.Tensor],
                            mesh: Optional[Mesh] = None):
        """Inverse of `stacked_params`: rows back into their blocks."""
        return unstack_block_params(stacked, [self.blocks[i]
                                              for i in self._order(mesh)])

    def pipeline_forward(self, x, stacked_params=None, mesh=None, rngs=None,
                         num_micro: Optional[int] = None):
        n = self._resolve_micro(num_micro)
        if stacked_params is not None:
            return pipeline_apply(self._template, stacked_params, x, n,
                                  mesh=mesh, axis=self.axis,
                                  virtual_degree=self.virtual_degree)
        order = self._order(mesh)
        return _run(lambda i, h: self.blocks[order[i]](h), self.num_layers,
                    x, n, mesh, self.axis, None, self.virtual_degree)
