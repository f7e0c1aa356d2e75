"""Mixture of experts with expert parallelism: the counterpart of
`paddle_tpu/parallel/moe.py` (`gshard_dispatch`, `TopKGate`,
`ExpertMLP`, `MoELayer`).

Two dispatch routes, as in JAX:

- **dense** (ep 1, or a custom gate or experts): gating builds the
  (tokens, experts, capacity) one-hot dispatch and combine tensors, and
  two einsums move the tokens to the experts and back;
- **expert parallel** (ep > 1 inside an SPMD run, or called outside one
  with a mesh of ep > 1, when the experts and tokens split evenly):
  each ep rank gates its 1/ep of the tokens, packs them per expert
  under a static capacity, an `all_to_all` over "ep" moves the
  (expert, capacity) slots to the rank that owns the expert (the
  reference's global_scatter), the rank runs its experts, a second
  `all_to_all` brings the outputs home (global_gather), and an
  `all_gather` over "ep" gives every rank the whole output, as JAX's
  `shard_map` returns the global array. The aux loss is the mean over
  the ep ranks.

Capacity and token drops are JAX's (`moe.py:17-19`): a token past
capacity_factor * tokens * top_k / experts of its expert's queue
(at least 4) falls through with zero output. The gate's noise (gshard,
training, noise_std > 0) is drawn from the installed key (`nn.rng`: a
generator seeded from the key the Trainer installs per step, so a
recomputed forward draws the same); under ep it is drawn once for all
tokens and each rank keeps its rows, so the two routes gate alike.

Experts are one stacked (experts, ...) tensor per weight with `.spec`
P("ep", ...): under `Trainer(mesh=)` an ep rank's weights are its
experts' block (`parallel.sharding.take_shard`); a layer called in a
run with the whole weights takes its block itself.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import functional as F
from ..nn import initializer as I
from ..nn import ranks, rng
from .mesh import P, get_mesh, mesh_shape

__all__ = ["TopKGate", "MoELayer", "ExpertMLP", "gshard_dispatch"]


def gshard_dispatch(x, weight, *, top_k: int, capacity: int,
                    gate_type: str = "gshard", noise_std: float = 0.0,
                    training: bool = False, rng=None, noise=None):
    """GShard gating of flat tokens x (s, m) with `weight` (m, e):
    (dispatch (s, e, c) bool, combine (s, e, c) fp32, aux_loss). The
    noise added to the gshard logits in training is `noise_std *
    noise / e`, `noise` an (s, e) standard normal (drawn from `rng`, a
    `torch.Generator`, when not given)."""
    s = x.shape[0]
    e = weight.shape[1]
    c = capacity
    logits = torch.matmul(x.float(), weight.float())
    if training and gate_type == "gshard" and noise_std > 0 and (
            noise is not None or rng is not None):
        if noise is None:
            noise = torch.randn(logits.shape, generator=rng,
                                device=logits.device)
        logits = logits + noise_std * noise / e
    probs = torch.softmax(logits, dim=-1)
    dev = x.device
    eye = torch.eye(e, device=dev)
    aux_me = probs.mean(dim=0)
    aux_ce = eye[probs.argmax(dim=-1)].mean(dim=0)
    aux_loss = (aux_me * aux_ce).sum() * e

    dispatch = torch.zeros((s, e, c), dtype=torch.bool, device=dev)
    combine = torch.zeros((s, e, c), dtype=torch.float32, device=dev)
    remaining = probs
    pos_counter = torch.zeros((e,), dtype=torch.int64, device=dev)
    slots = torch.arange(c, device=dev)
    for _ in range(top_k):
        idx = remaining.argmax(dim=-1)                       # (s,)
        gate_val = probs.gather(1, idx[:, None])[:, 0]
        onehot = (idx[:, None] == torch.arange(e, device=dev)).long()
        prio = torch.cumsum(onehot, dim=0) - onehot          # before me
        mypos = (prio * onehot).sum(-1) + (pos_counter * onehot).sum(-1)
        keep = mypos < c
        disp_k = (onehot.bool() & keep[:, None])[..., None] & \
            (mypos.clamp(0, c - 1)[:, None] == slots)[:, None, :]
        dispatch = dispatch | disp_k
        combine = combine + disp_k.float() * gate_val[:, None, None]
        pos_counter = pos_counter + onehot.sum(dim=0)
        remaining = remaining * (1.0 - onehot.float())
    if top_k > 1:
        denom = combine.sum(dim=(1, 2), keepdim=True)
        combine = combine / torch.clamp_min(denom, 1e-9)
    return dispatch, combine, aux_loss


class TopKGate(nn.Module):
    """gshard (top-k, noisy, load-balancing aux loss), switch (top-1)
    and naive gates; the noise is drawn from the installed key."""

    def __init__(self, d_model: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 eval_capacity_factor: float = 2.0,
                 gate_type: str = "gshard", noise_std: float = 1.0,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = 1 if gate_type == "switch" else top_k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.gate_type = gate_type
        self.noise_std = noise_std
        self.weight = nn.Parameter(I.XavierUniform()((d_model, num_experts),
                                                     gen))

    def capacity(self, num_tokens: int) -> int:
        f = self.capacity_factor if self.training else \
            self.eval_capacity_factor
        return max(4, int(f * num_tokens * self.top_k / self.num_experts))

    def noisy(self) -> bool:
        return self.training and self.gate_type == "gshard" and \
            self.noise_std > 0

    def noise(self, num_tokens: int, device):
        """The (tokens, experts) standard normals of one forward, or
        None for a gate without noise."""
        if not self.noisy():
            return None
        return rng.normal((num_tokens, self.num_experts), device)

    def forward(self, x, noise=None):
        """x (s, m) → (dispatch (s, e, c), combine (s, e, c), aux_loss)."""
        if noise is None:
            noise = self.noise(x.shape[0], x.device)
        return gshard_dispatch(
            x, self.weight, top_k=self.top_k,
            capacity=self.capacity(x.shape[0]), gate_type=self.gate_type,
            noise_std=self.noise_std, training=self.training, noise=noise)


def _expert_block(t, num_experts: int):
    """The ep rank's experts of a stacked (experts, ...) weight: `t`
    when it is that block already, else its rows."""
    i, n = ranks.axis_info("ep")
    if n == 1 or t.shape[0] != num_experts:
        return t
    return t.narrow(0, i * (num_experts // n), num_experts // n)


class ExpertMLP(nn.Module):
    """E experts' FFNs as stacked weights split over "ep" (w1 (e, m, h),
    b1 (e, h), w2 (e, h, m), b2 (e, m); XavierUniform, zero biases)."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 activation: str = "gelu",
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        init = I.XavierUniform()
        self.num_experts = num_experts
        self.w1 = nn.Parameter(init((num_experts, d_model, d_hidden), gen))
        self.b1 = nn.Parameter(torch.zeros(num_experts, d_hidden))
        self.w2 = nn.Parameter(init((num_experts, d_hidden, d_model), gen))
        self.b2 = nn.Parameter(torch.zeros(num_experts, d_model))
        for p in (self.w1, self.w2):
            p.spec = P("ep", None, None)
        for p in (self.b1, self.b2):
            p.spec = P("ep", None)
        self.act = getattr(F, activation)

    def weights(self):
        """(w1, b1, w2, b2) of this rank's experts."""
        return tuple(_expert_block(t, self.num_experts)
                     for t in (self.w1, self.b1, self.w2, self.b2))

    def forward(self, x, weights=None):
        """x (e, c, m) dispatched tokens → (e, c, m)."""
        w1, b1, w2, b2 = weights or (self.w1, self.b1, self.w2, self.b2)
        h = torch.einsum("ecm,emh->ech", x, w1) + b1[:, None]
        h = self.act(h)
        return torch.einsum("ech,ehm->ecm", h, w2) + b2[:, None]


class MoELayer(nn.Module):
    """Gate, experts and dispatch (the reference's moe_layer.py:233):
    forward(x (b, s, m)) → (b, s, m); `aux_loss` is the forward's
    load-balancing loss, for the training loss to add. Under a mesh
    the ranks' module replicas share the loss function's closure, so
    the aux loss is kept in the rank's context (`nn.ranks.rank_store`)
    and read back from there."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 gate: Optional[nn.Module] = None, gate_type: str = "gshard",
                 experts: Optional[nn.Module] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.num_experts = num_experts
        self.gate = gate or TopKGate(d_model, num_experts, top_k,
                                     capacity_factor, gate_type=gate_type,
                                     gen=gen)
        self.experts = experts or ExpertMLP(d_model, d_hidden, num_experts,
                                            gen=gen)
        self._key = object()        # shared with the ranks' replicas
        self._aux = None

    @property
    def aux_loss(self):
        store = ranks.rank_store()
        if store is not None and self._key in store:
            return store[self._key]
        return self._aux

    def _ep(self, tokens: int) -> int:
        _, n = ranks.axis_info("ep")
        if n == 1 and not ranks.in_run():
            mesh = get_mesh()
            n = mesh_shape(mesh).get("ep", 1) if mesh is not None else 1
        if n > 1 and self.num_experts % n == 0 and tokens % n == 0 and \
                isinstance(self.gate, TopKGate) and \
                isinstance(self.experts, ExpertMLP):
            return n
        return 1

    def forward(self, x):
        b, s, m = x.shape
        flat = x.reshape(b * s, m)
        ep = self._ep(b * s)
        if ep == 1:
            out, aux = self._forward_dense(flat)
        else:
            noise = self.gate.noise(b * s, x.device)
            if ranks.axis_info("ep")[1] > 1:
                out, aux = self._forward_ep(flat, noise)
            else:                      # the ep ranks, run here
                out, aux = ranks.spmd(
                    [{"ep": i} for i in range(ep)],
                    lambda i: self._forward_ep(flat, noise))[0]
        store = ranks.rank_store()
        if store is not None:
            store[self._key] = aux
        else:
            self._aux = aux
        return out.reshape(b, s, m)

    def _forward_dense(self, flat):
        dispatch, combine, aux = self.gate(flat)
        expert_in = torch.einsum("sec,sm->ecm", dispatch.to(flat.dtype),
                                 flat)
        expert_out = self.experts(expert_in)
        out = torch.einsum("sec,ecm->sm", combine.to(flat.dtype),
                           expert_out)
        return out, aux

    def _forward_ep(self, flat, noise):
        """This ep rank's share of the expert-parallel route (see the
        module docstring), `noise` the gate's over all tokens (or None);
        returns the whole output and the mean aux."""
        from . import collective as C
        g = self.gate
        i, ep = ranks.axis_info("ep")
        s_local = flat.shape[0] // ep
        cap = g.capacity(s_local)          # per rank, per expert
        if noise is not None:
            noise = noise[i * s_local:(i + 1) * s_local]
        x_l = flat[i * s_local:(i + 1) * s_local]
        dispatch, combine, aux = gshard_dispatch(
            x_l, g.weight, top_k=g.top_k, capacity=cap,
            gate_type=g.gate_type, noise_std=g.noise_std,
            training=g.training, noise=noise)
        slots = torch.einsum("sec,sm->ecm", dispatch.to(x_l.dtype), x_l)
        # (e, cap, m) -> (e/ep, ep*cap, m): this rank's experts' slots
        # from every rank
        inbox = C.all_to_all(slots, group="ep", split_axis=0, concat_axis=1)
        outbox = self.experts(inbox, self.experts.weights())
        back = C.all_to_all(outbox, group="ep", split_axis=1, concat_axis=0)
        out_l = torch.einsum("sec,ecm->sm", combine.to(x_l.dtype), back)
        aux = C.all_reduce(aux, op="avg", group="ep")
        return C.all_gather(out_l, group="ep", axis=0), aux
