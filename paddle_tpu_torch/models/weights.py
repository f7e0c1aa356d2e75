"""Weight bridge: JAX GPT parameters (as numpy arrays) → the port.

The JAX package's `GPT.raw_parameters()` is a flat {dotted name:
array} dict whose names and (in, out) linear layout the port's `GPT`
keeps verbatim, so the bridge is a checked copy: names and shapes must
match exactly, and any mismatch raises instead of loading a partial or
transposed model. Arrays travel as numpy (`np.asarray(jax_array)`);
bfloat16 arrays (numpy's `bfloat16` extension dtype) are carried over
bit for bit.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .gpt import GPT, GPTConfig, param_shapes

__all__ = ["from_jax_params", "load_jax_params", "infer_config"]

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
