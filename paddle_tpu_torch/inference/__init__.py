"""Serving runtime: Config → create_predictor → run, the counterpart of
`paddle_tpu/inference/__init__.py`.

Reference: `paddle/fluid/inference/api/analysis_predictor.h:93`
(AnalysisPredictor: load program and params, run IR passes, execute
with zero-copy tensors) and `paddle_inference_api.h` (Config /
PaddlePredictor).

The artifact is `jit.save`'s `torch.export` program (`.pt2`) beside its
`.params` weights, so the "analysis + IR passes" stage collapses, as in
the JAX package (there into XLA AOT compilation). `Predictor` loads the
program once and stages the weights on the device once. Its `_compiled`
cache holds one entry per input signature (shapes and dtypes): on the
card an entry is a CUDA graph of the program over static input buffers
(the counterpart of XLA's AOT executable: `run()` copies the inputs in
and replays), captured once after a warm-up run. The graphs of one
Predictor share one memory pool: a run replays one entry at a time, and
an entry's outputs are copied out of the pool. A program that holds a
`torch.cond` or `while_loop` node (dy2static control flow over traced
values) reads its condition on the host every time it runs, which a
CUDA graph cannot hold: such a program runs eagerly, one entry per
signature all the same. That is decided once, at load, from the
program's nodes (`eager_reason`); any other failed capture raises.
Input and output handles mirror the zero-copy API: `copy_from_cpu`
casts to the spec's dtype and stages the data on the device (one
transfer), `copy_to_cpu` fetches results.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Config", "Predictor", "create_predictor", "PredictorTensor",
           "create_llm_engine"]

_SUFFIXES = (".pt2", ".stablehlo", ".meta.json", ".params", ".pdmodel")


class Config:
    """Reference: `paddle_infer.Config`. Its device defaults to the card
    ("cuda"; the Predictor raises without one); `disable_gpu()` means
    the CPU. Knobs of other runtimes (TensorRT, MKLDNN, IR passes) are
    accepted and recorded in `ignored_knobs()`, as in the JAX
    package."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        # paddle passes (model_file, params_file); one prefix here
        prefix = model_path or ""
        for ext in _SUFFIXES:
            if prefix.endswith(ext):
                prefix = prefix[: -len(ext)]
        self.model_prefix = prefix
        self._device = "cuda"
        self._ignored: List[str] = []
        self.memory_optim = True
        self.batch_dim_hint: Optional[int] = None

    def enable_native_runtime(self, flag: bool = True):
        """The native C++ runtime is ROADMAP item 13.2b: `True` raises."""
        if flag:
            from ..jit import NATIVE_ITEM
            raise NotImplementedError(f"enable_native_runtime: "
                                      f"{NATIVE_ITEM}")

    # --- device selection ---------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0):
        self._device = f"cuda:{device_id}" if device_id else "cuda"

    def disable_gpu(self):
        self._device = "cpu"

    def set_device(self, device: str):
        self._device = device

    def device(self) -> str:
        return self._device

    # --- accepted-and-collapsed knobs ----------------------------------------
    def enable_memory_optim(self, flag: bool = True):
        self.memory_optim = flag

    def switch_ir_optim(self, flag: bool = True):
        self._ignored.append(f"switch_ir_optim({flag}) — the program is "
                             f"served as exported (a CUDA graph per "
                             f"signature)")

    def enable_tensorrt_engine(self, *a, **k):
        self._ignored.append("tensorrt — n/a (the exported program's own "
                             "kernels, replayed as a CUDA graph)")

    def enable_mkldnn(self, *a, **k):
        self._ignored.append("mkldnn — n/a (PyTorch's CPU kernels)")

    def ignored_knobs(self) -> List[str]:
        return list(self._ignored)


class PredictorTensor:
    """Zero-copy-style handle (reference: ZeroCopyTensor).
    `copy_from_cpu` casts to the spec's dtype and is the one
    host → device transfer; results stay on the device until
    `copy_to_cpu`."""

    def __init__(self, name: str, spec: dict, device):
        self.name = name
        self._spec = spec
        self._device = device
        self._value: Optional[torch.Tensor] = None

    def reshape(self, shape: Sequence[int]):
        # shape declaration before copy_from_cpu, paddle-style
        self._declared_shape = tuple(shape)

    def copy_from_cpu(self, data):
        from ..static import torch_dtype
        from ..jit import _as_tensor
        self._value = _as_tensor(data, self._device,
                                 torch_dtype(self._spec["dtype"]))

    def share_external_data(self, data: torch.Tensor):
        """A device tensor passed through without a copy."""
        self._value = data

    def set_value(self, v):
        self._value = v

    def copy_to_cpu(self) -> np.ndarray:
        if self._value is None:
            raise RuntimeError(f"tensor {self.name!r} has no value")
        v = self._value.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()

    def value(self):
        return self._value

    def shape(self):
        v = self._value
        return list(v.shape) if v is not None else list(self._spec["shape"])

    def type(self):
        return self._spec["dtype"]


class Predictor:
    """The serving executor (AnalysisPredictor analog).

    Load = read the program and the weights, stage the weights on the
    device once. The first `run()` per input signature builds its entry
    in `_compiled` (on the card: a warm-up run and a CUDA graph capture
    over static input buffers; a program with control flow nodes, or
    the CPU: the program itself); later runs copy the inputs in and
    replay it."""

    def __init__(self, config: Config):
        from ..core import resolve_device
        from ..jit import has_control_flow, read_artifacts
        self.config = config
        self._device = resolve_device(config.device())
        self._exported, state, self._meta = read_artifacts(
            config.model_prefix, self._device)
        self._program = self._exported.module()
        # weights stay resident on the device for the predictor's life
        self._state = {g: {k: t.to(self._device) for k, t in d.items()}
                       for g, d in state.items()}
        self._specs = self._meta["input_specs"]
        self._inputs: Dict[str, PredictorTensor] = {
            sp["name"]: PredictorTensor(sp["name"], sp, self._device)
            for sp in self._specs}
        self._outputs: Dict[str, PredictorTensor] = {}
        self._compiled: Dict[tuple, object] = {}
        self.eager_reason: Optional[str] = None
        if has_control_flow(self._exported):
            self.eager_reason = ("the program holds torch.cond / while_loop "
                                 "nodes, whose conditions are read on the "
                                 "host: it runs eagerly")
        self._graphed = (self._device.type == "cuda"
                         and self.eager_reason is None)
        self._pool = torch.cuda.graph_pool_handle() if self._graphed \
            else None

    # --- handle API ---------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return [sp["name"] for sp in self._specs]

    def get_input_handle(self, name: str) -> PredictorTensor:
        return self._inputs[name]

    def get_output_names(self) -> List[str]:
        return list(self._outputs)

    def get_output_handle(self, name: str) -> PredictorTensor:
        return self._outputs[name]

    # --- execution ----------------------------------------------------------
    def _entry(self, args: Sequence[torch.Tensor]):
        """The `_compiled` entry of this input signature: (static input
        buffers, `serving.graphs.GraphedCall`)."""
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        entry = self._compiled.get(key)
        if entry is None:
            from ..serving.graphs import GraphedCall
            bufs = [a.clone() for a in args]
            program, state = self._program, self._state

            def fn():
                with torch.no_grad():
                    out = program(state, *bufs)
                return tuple(out) if isinstance(out, (tuple, list)) \
                    else (out,)
            entry = (bufs, GraphedCall(fn, self._graphed, pool=self._pool,
                                       what="predictor program"))
            self._compiled[key] = entry
        return entry

    def run(self, inputs: Optional[Sequence] = None):
        """Execute. Either pass `inputs` positionally (returns a list of
        numpy outputs, paddle_infer's newer API) or fill the input
        handles first and read the output handles (returns True)."""
        if inputs is not None:
            if len(inputs) != len(self._specs):
                raise ValueError(
                    f"model takes {len(self._specs)} inputs "
                    f"({[s['name'] for s in self._specs]}), got "
                    f"{len(inputs)}")
            for sp, a in zip(self._specs, inputs):
                self._inputs[sp["name"]].copy_from_cpu(a)
        args = []
        for sp in self._specs:
            h = self._inputs[sp["name"]]
            if h.value() is None:
                raise RuntimeError(f"input {sp['name']!r} not set")
            args.append(h.value())
        bufs, call = self._entry(args)
        for b, a in zip(bufs, args):
            b.copy_(a)
        outs = call.run()
        self._outputs = {}
        results = []
        for i, t in enumerate(outs):
            name = f"out{i}"
            h = PredictorTensor(name, {"shape": list(t.shape),
                                       "dtype": str(t.dtype)},
                                self._device)
            h.set_value(t)
            self._outputs[name] = h
            results.append(h.copy_to_cpu() if inputs is not None else t)
        return results if inputs is not None else True

    def clear_intermediate_tensor(self):
        pass  # nothing survives a run but the entries' buffers


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def create_llm_engine(config, snapshot=None, **engine_kwargs):
    """The serving engine entry of the inference surface: a
    `serving.LLMEngine` from a saved generation artifact
    (`serving.save_for_serving` writes `<prefix>.llm.json` and
    `<prefix>.llm.params`). `config` is a `Config` (its prefix is used;
    its device, when the caller passes none, is the engine's) or a
    bare path prefix. Engine kwargs pass through; `snapshot` resumes
    an `LLMEngine.snapshot()` dict, as `serving.load_engine`."""
    from .. import serving
    if isinstance(config, Config):
        prefix = config.model_prefix
        if snapshot is None:
            engine_kwargs.setdefault("device", config.device())
    else:
        prefix = Config(str(config)).model_prefix
    return serving.load_engine(prefix, snapshot=snapshot, **engine_kwargs)
