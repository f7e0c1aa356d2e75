"""Weight bridge: JAX model parameters, buffers and train states (as
numpy arrays) → the port.

The JAX package's `GPT.raw_parameters()` is a flat {dotted name:
array} dict whose names and (in, out) linear layout the port's `GPT`
keeps verbatim, so the bridge is a checked copy: names and shapes must
match exactly, and any mismatch raises instead of loading a partial or
transposed model. Arrays travel as numpy (`np.asarray(jax_array)`);
bfloat16 arrays (numpy's `bfloat16` extension dtype) are carried over
bit for bit; CPU tensors (a state-dict file read by `framework.io`) are
taken as they are. An int8 model (PTQ- or QAT-converted) crosses with
`load_jax_int8_params`: its `raw_buffers()` carry each `Int8Linear`'s
codes and scales, and the port model's Linears there become
`Int8Linear`s. Any other port module whose names mirror its JAX model's
(the ResNet family) crosses with `load_jax_state` (parameters and
buffers, such as BatchNorm's running statistics), and its train state
with `from_jax_train_state(tree, model=...)`.

Under a mesh the values are those of the unsharded state: a JAX state
trained with `Trainer(mesh=)` holds global arrays, whose
`np.asarray` is the whole tensor, so `from_jax_train_state` reads it
as any other (a port `Trainer(mesh=)` then splits what it loads for
its ZeRO stage), and `train_state_numpy` gives a port state, its split
entries (`parallel.sharding.Sharded`) joined, in the same numpy tree
for comparison.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..core import host_tensor
from ..framework.trainer import TrainState
from .gpt import BLOCK_LINEARS, GPT, GPTConfig, param_shapes

__all__ = ["from_jax_params", "load_jax_params", "load_jax_int8_params",
           "load_jax_state", "infer_config", "from_jax_train_state",
           "train_state_numpy"]

# the slots of each optimizer rule (JAX's names), beside the optional
# fp32 `master_weight`
RULE_SLOTS = {
    "SGD": (), "Momentum": ("velocity",), "LarsMomentum": ("velocity",),
    "Adam": ("moment1", "moment2"), "AdamW": ("moment1", "moment2"),
    "Lamb": ("moment1", "moment2"), "Adamax": ("moment", "inf_norm"),
    "Adagrad": ("moment",),
    "Adadelta": ("avg_squared_grad", "avg_squared_update"),
    "RMSProp": ("mean_square", "momentum_acc"),
    "RMSProp(centered)": ("mean_square", "momentum_acc", "mean_grad"),
}
_SCALER_KEYS = ("scale", "good_steps", "bad_steps")

_BLOCK = re.compile(r"^blocks\.(\d+)\.")


def _to_tensor(name: str, a) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        dt = np.asarray(a).dtype
        if dt.name != "bfloat16" and dt.kind not in "fiu":
            raise TypeError(f"{name}: unsupported dtype {dt}")
    return host_tensor(a)


def infer_config(np_params: Mapping[str, np.ndarray],
                 num_heads: int = 1) -> GPTConfig:
    """The GPTConfig a parameter dict describes (widths, depth, vocab,
    context, tied head). Head count does not show in the shapes, so it
    is taken from `num_heads`."""
    if "wte.weight" not in np_params or "wpe.weight" not in np_params:
        raise KeyError("not a GPT parameter dict: wte.weight / wpe.weight "
                       "missing")
    vocab, h = np.shape(np_params["wte.weight"])
    max_seq = np.shape(np_params["wpe.weight"])[0]
    blocks = {int(m.group(1)) for k in np_params
              if (m := _BLOCK.match(k))}
    ffn_key = "blocks.0.mlp.fc1.weight"
    ffn = np.shape(np_params[ffn_key])[1] if ffn_key in np_params else 4 * h
    return GPTConfig(vocab_size=int(vocab), max_seq_len=int(max_seq),
                     hidden_size=int(h), num_layers=len(blocks),
                     num_heads=int(num_heads),
                     intermediate_size=int(ffn) if ffn != 4 * h else None,
                     tie_embeddings="lm_head.weight" not in np_params)


def _check(np_params: Mapping[str, np.ndarray],
           expected: Dict[str, tuple]):
    got = set(np_params)
    missing = sorted(set(expected) - got)
    extra = sorted(got - set(expected))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}, unexpected "
                       f"{extra[:8]}{'...' if len(extra) > 8 else ''}")
    bad = [(k, tuple(np.shape(np_params[k])), tuple(s))
           for k, s in expected.items()
           if tuple(np.shape(np_params[k])) != tuple(s)]
    if bad:
        raise ValueError(f"parameter shapes differ (name, got, expected): "
                         f"{bad[:8]}")


def from_jax_params(np_params: Mapping[str, np.ndarray],
                    cfg: Optional[GPTConfig] = None
                    ) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} from a JAX GPT parameter dict. Checks the full
    name set and every shape against `cfg` (or the config the dict
    itself implies) and raises on any mismatch."""
    cfg = cfg or infer_config(np_params)
    _check(np_params, param_shapes(cfg))
    return {k: _to_tensor(k, v) for k, v in np_params.items()}


@torch.no_grad()
def load_jax_params(model: GPT,
                    np_params: Mapping[str, np.ndarray]) -> GPT:
    """Copy a JAX GPT parameter dict into `model` in place (each value
    converted to the model's device and dtype). Names and shapes must
    equal the model's own; raises on any mismatch before copying
    anything."""
    own = dict(model.named_parameters())
    _check(np_params, {k: tuple(p.shape) for k, p in own.items()})
    for k, v in np_params.items():
        own[k].copy_(_to_tensor(k, v))
    return model


@torch.no_grad()
def load_jax_state(model: torch.nn.Module,
                   np_params: Mapping[str, np.ndarray],
                   np_buffers: Optional[Mapping[str, np.ndarray]] = None
                   ) -> torch.nn.Module:
    """Copy a JAX model's `raw_parameters()` and `raw_buffers()` into a
    port module whose names mirror it (each value converted to the
    model's device and the tensor's dtype; bf16 carried bit for bit).
    Parameter names and shapes must equal the model's, and so must the
    buffers' when `np_buffers` is given; any mismatch raises before
    anything is copied."""
    own = dict(model.named_parameters())
    _check(np_params, {k: tuple(p.shape) for k, p in own.items()})
    bufs = dict(model.named_buffers())
    if np_buffers is not None:
        _check(np_buffers, {k: tuple(b.shape) for k, b in bufs.items()})
    for k, v in np_params.items():
        own[k].copy_(_to_tensor(k, v))
    for k, v in (np_buffers or {}).items():
        bufs[k].copy_(_to_tensor(k, v))
    return model


def _linear_prefixes(cfg: GPTConfig):
    out = [f"blocks.{i}.{t}" for i in range(cfg.num_layers)
           for t in BLOCK_LINEARS]
    return out if cfg.tie_embeddings else out + ["lm_head"]


@torch.no_grad()
def load_jax_int8_params(model: GPT, np_params: Mapping[str, np.ndarray],
                         np_buffers: Mapping[str, np.ndarray]) -> GPT:
    """Carry a PTQ- or QAT-converted JAX GPT into `model` in place: the
    JAX `raw_parameters()` (embeddings and LayerNorms, and any Linear
    left in float) and `raw_buffers()` (each `Int8Linear`'s `qweight`,
    `w_scale`, `act_scale` and `bias`). Every Linear whose `qweight` the
    buffers carry becomes a `quantization.Int8Linear` in the same place;
    its buffers are carried bit for bit in their own dtypes (int8 codes,
    the scales' dtype as saved). Names and shapes are checked against
    the model's config, and any mismatch raises before anything is
    copied."""
    from ..quantization import Int8Linear
    shapes = param_shapes(model.cfg)
    quant = sorted(k[:-len(".qweight")] for k in np_buffers
                   if k.endswith(".qweight"))
    if not quant:
        raise KeyError("no <prefix>.qweight buffer: not an int8 model "
                       "(use load_jax_params)")
    unknown = sorted(set(quant) - set(_linear_prefixes(model.cfg)))
    if unknown:
        raise KeyError(f"qweight for layers that are no Linear of this "
                       f"model: {unknown[:8]}")
    want_params = {k: v for k, v in shapes.items()
                   if k.rsplit(".", 1)[0] not in quant}
    want_bufs = {}
    for pre in quant:
        k_in, n = shapes[pre + ".weight"]
        want_bufs.update({pre + ".qweight": (k_in, n),
                          pre + ".w_scale": (n,), pre + ".act_scale": ()})
        if pre + ".bias" in shapes:
            want_bufs[pre + ".bias"] = (n,)
    _check(np_params, want_params)
    _check(np_buffers, want_bufs)
    bad = [k for k in quant if np.asarray(np_buffers[k + ".qweight"]).dtype
           != np.int8]
    if bad:
        raise TypeError(f"qweight must be int8: {bad[:8]}")
    dev = model.device
    for pre in quant:
        parent, _, name = pre.rpartition(".")
        bufs = {t: _to_tensor(f"{pre}.{t}", np_buffers[f"{pre}.{t}"]).to(dev)
                for t in ("qweight", "w_scale", "act_scale", "bias")
                if f"{pre}.{t}" in np_buffers}
        setattr(model.get_submodule(parent) if parent else model, name,
                Int8Linear(bufs["qweight"], bufs["w_scale"],
                           bufs["act_scale"], bufs.get("bias")))
    return load_jax_params(model, np_params)


def _expected_slots(jax_slots: Mapping, optimizer) -> tuple:
    """The rule's slot names: those `optimizer` makes, or else the one
    rule of RULE_SLOTS whose names the first parameter's slots carry."""
    if optimizer is not None:
        return tuple(optimizer.init_slots(torch.zeros(1)))
    first = set(next(iter(jax_slots.values()))) - {"master_weight"}
    for names in RULE_SLOTS.values():
        if first == set(names):
            return names
    raise KeyError(f"slots {sorted(first)} are no optimizer rule's; known: "
                   f"{RULE_SLOTS}")


def from_jax_train_state(state_tree: Mapping, cfg: Optional[GPTConfig] = None,
                         optimizer=None,
                         model: Optional[torch.nn.Module] = None):
    """A port `TrainState` (CPU tensors) from a JAX `TrainState.tree()`:
    of a GPT by default (names and shapes checked as in
    `from_jax_params`), or of any port `model` whose names mirror the
    JAX model's (its parameters' names and shapes, and its buffers',
    such as BatchNorm's statistics, checked against the model's own;
    the buffers carried in their dtype); the optimizer's step and every
    parameter's slots (any rule of `optimizer/__init__.py`: the names
    checked against `optimizer`'s rule when it is given, else against
    the rule the slots name, the same for every parameter, plus an
    optional `master_weight`; each slot's shape checked against the
    parameter),
    the GradScaler's state (`scale`, `good_steps`, `bad_steps`, or
    none) and the train step. `Trainer.load_state` then resumes the run
    on the model's device."""
    np_params = state_tree["params"]
    buffers = {}
    if model is None:
        params = from_jax_params(np_params, cfg)
    else:
        _check(np_params, {k: tuple(p.shape)
                           for k, p in model.named_parameters()
                           if p.requires_grad})
        params = {k: _to_tensor(k, v) for k, v in np_params.items()}
        np_buffers = state_tree.get("buffers") or {}
        _check(np_buffers, {k: tuple(b.shape)
                            for k, b in model.named_buffers()})
        buffers = {k: _to_tensor(k, v) for k, v in np_buffers.items()}
    opt = state_tree["opt_state"]
    jax_slots = opt["slots"]
    if set(jax_slots) != set(params):
        raise KeyError(f"optimizer slots and parameters differ: "
                       f"{sorted(set(jax_slots) ^ set(params))[:8]}")
    want = _expected_slots(jax_slots, optimizer)
    slots = {}
    for k, sl in jax_slots.items():
        if set(sl) - {"master_weight"} != set(want):
            raise KeyError(f"{k}: slots {sorted(sl)}, expected "
                           f"{sorted(want)} and optionally master_weight")
        shape = tuple(params[k].shape)
        for sk, v in sl.items():
            if tuple(np.shape(v)) != shape:
                raise ValueError(f"{k}.{sk}: shape {tuple(np.shape(v))} "
                                 f"!= parameter shape {shape}")
        slots[k] = {sk: _to_tensor(f"{k}.{sk}", v) for sk, v in sl.items()}
    jax_scaler = state_tree.get("scaler_state") or {}
    if jax_scaler and set(jax_scaler) != set(_SCALER_KEYS):
        raise KeyError(f"scaler_state keys {sorted(jax_scaler)}, expected "
                       f"{list(_SCALER_KEYS)}")
    scaler = {sk: _to_tensor(f"scaler_state.{sk}", v).reshape(())
              for sk, v in jax_scaler.items()}
    return TrainState(params, buffers,
                      {"step": int(np.asarray(opt["step"])), "slots": slots},
                      scaler, 0, int(np.asarray(state_tree["step"])))


def _numpy(t):
    if hasattr(t, "full"):                      # a Sharded: join it
        t = t.full()
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def train_state_numpy(state: TrainState) -> Dict:
    """A port `TrainState` as the numpy tree of a JAX `TrainState.tree()`
    (params, buffers, opt_state {step, slots}, scaler_state, step), its
    split entries joined; bf16 comes out as fp32."""
    return {"params": {k: _numpy(v) for k, v in state.params.items()},
            "buffers": {k: _numpy(v) for k, v in state.buffers.items()},
            "opt_state": {"step": int(state.opt_state["step"]),
                          "slots": {k: {sk: _numpy(sv)
                                        for sk, sv in s.items()}
                                    for k, s in
                                    state.opt_state["slots"].items()}},
            "scaler_state": {k: _numpy(v)
                             for k, v in state.scaler_state.items()},
            "step": int(state.step)}
