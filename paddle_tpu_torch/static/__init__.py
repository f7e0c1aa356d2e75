"""Static-graph entry points, collapsed onto `jit`: the counterpart of
`paddle_tpu/static/__init__.py`.

`InputSpec` names an input's shape (None for a dynamic dimension), dtype
and name; `save_inference_model` / `load_inference_model` are thin
wrappers over `jit.save` / `jit.load`. Capture is `torch.export`, so
`static` reduces to the spec type and the two shims, as in the JAX
package (there capture is trace-to-StableHLO).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["InputSpec", "save_inference_model", "load_inference_model",
           "torch_dtype", "dtype_name"]

_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_BY_NAME = {v: k for k, v in _NAMES.items()}
_BY_NAME.update({"fp32": torch.float32, "bf16": torch.bfloat16,
                 "fp16": torch.float16, "float": torch.float32,
                 "double": torch.float64, "half": torch.float16,
                 "int": torch.int64, "long": torch.int64})


def torch_dtype(dtype) -> torch.dtype:
    """A `torch.dtype` from a torch dtype, a numpy dtype or type, or a
    name ("float32", "torch.int64", "bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise ValueError(f"unsupported dtype {dtype}")
        return dtype
    if isinstance(dtype, str):
        name = dtype[len("torch."):] if dtype.startswith("torch.") \
            else dtype
    else:
        name = np.dtype(dtype).name
    try:
        return _BY_NAME[name.lower()]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None


def dtype_name(dtype) -> str:
    """The numpy-style name of a dtype ("float32", "bfloat16", ...)."""
    return _NAMES[torch_dtype(dtype)]


class InputSpec:
    """Shape, dtype and name of one model input. `None` dims are dynamic:
    `jit.save` exports them as symbolic dimensions, so one artifact
    serves any batch size. Equality and hash take the shape and dtype,
    not the name, as the JAX package's."""

    def __init__(self, shape, dtype="float32", name: Optional[str] = None):
        self.shape = tuple(None if d is None else int(d) for d in shape)
        self.dtype = torch_dtype(dtype)
        self.name = name

    @classmethod
    def from_tensor(cls, x, name: Optional[str] = None):
        """The spec of a tensor or a numpy array."""
        return cls(tuple(x.shape), x.dtype, name)

    def example(self, batch_size: int = 2, device="cpu") -> torch.Tensor:
        """A zero tensor of this spec, `None` dims at `batch_size`."""
        shape = tuple(batch_size if d is None else d for d in self.shape)
        return torch.zeros(shape, dtype=self.dtype, device=device)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={dtype_name(self.dtype)}"
                f", name={self.name!r})")

    def __eq__(self, other):
        return (isinstance(other, InputSpec) and self.shape == other.shape
                and self.dtype == other.dtype)

    def __hash__(self):
        return hash((self.shape, dtype_name(self.dtype)))


def save_inference_model(path_prefix: str, layer, input_spec:
                         Optional[Sequence[InputSpec]] = None, **kwargs):
    """Export `layer` for inference: `jit.save`'s `.pt2` program,
    `.params` weights and `.meta.json`."""
    from .. import jit
    return jit.save(layer, path_prefix, input_spec=input_spec, **kwargs)


def load_inference_model(path_prefix: str, **kwargs):
    """`jit.load` of an artifact `save_inference_model` wrote."""
    from .. import jit
    return jit.load(path_prefix, **kwargs)
