"""Weight bridge: JAX GPT parameters and train states (as numpy
arrays) → the port.

The JAX package's `GPT.raw_parameters()` is a flat {dotted name:
array} dict whose names and (in, out) linear layout the port's `GPT`
keeps verbatim, so the bridge is a checked copy: names and shapes must
match exactly, and any mismatch raises instead of loading a partial or
transposed model. Arrays travel as numpy (`np.asarray(jax_array)`);
bfloat16 arrays (numpy's `bfloat16` extension dtype) are carried over
bit for bit. An int8 model (PTQ- or QAT-converted) crosses with
`load_jax_int8_params`: its `raw_buffers()` carry each `Int8Linear`'s
codes and scales, and the port model's Linears there become
`Int8Linear`s.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..framework.trainer import TrainState
from .gpt import BLOCK_LINEARS, GPT, GPTConfig, param_shapes

__all__ = ["from_jax_params", "load_jax_params", "load_jax_int8_params",
           "infer_config", "from_jax_train_state"]

_SLOTS = ("moment1", "moment2", "master_weight")

_BLOCK = re.compile(r"^blocks\.(\d+)\.")


def _to_tensor(name: str, a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.kind not in "fiu":
        raise TypeError(f"{name}: unsupported dtype {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a).copy())


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


def from_jax_train_state(state_tree: Mapping, cfg: Optional[GPTConfig] = None):
    """A port `TrainState` (CPU tensors) from a JAX `TrainState.tree()`
    of a GPT trained with Adam/AdamW: the parameters (names and shapes
    checked as in `from_jax_params`), the optimizer's step and every
    parameter's `moment1` / `moment2` / `master_weight` slots (the slot
    names per parameter and each slot's shape checked against the
    parameter), and the train step. `Trainer.load_state` then resumes
    the run on the model's device."""
    np_params = state_tree["params"]
    params = from_jax_params(np_params, cfg)
    opt = state_tree["opt_state"]
    jax_slots = opt["slots"]
    if set(jax_slots) != set(params):
        raise KeyError(f"optimizer slots and parameters differ: "
                       f"{sorted(set(jax_slots) ^ set(params))[:8]}")
    slots = {}
    for k, sl in jax_slots.items():
        bad = sorted(set(sl) - set(_SLOTS))
        if bad or not {"moment1", "moment2"} <= set(sl):
            raise KeyError(f"{k}: slots {sorted(sl)}, expected moment1, "
                           f"moment2 and optionally master_weight")
        shape = tuple(params[k].shape)
        for sk, v in sl.items():
            if tuple(np.shape(v)) != shape:
                raise ValueError(f"{k}.{sk}: shape {tuple(np.shape(v))} "
                                 f"!= parameter shape {shape}")
        slots[k] = {sk: _to_tensor(f"{k}.{sk}", v) for sk, v in sl.items()}
    return TrainState(params, {}, {"step": int(np.asarray(opt["step"])),
                                   "slots": slots},
                      {}, 0, int(np.asarray(state_tree["step"])))
