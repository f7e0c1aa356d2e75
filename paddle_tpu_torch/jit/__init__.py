"""Program capture, export and load: the counterpart of
`paddle_tpu/jit/__init__.py` (`to_static`, `save`, `load`,
`TranslatedLayer`).

Capture is `torch.export.export` (non-strict) of a pure function
`fn(state, *inputs)`, state = {"params": {name: tensor}, "buffers":
{name: tensor}}: a Layer runs through `torch.func.functional_call` over
the state, so the program holds no weights of its own, as the JAX
package's exported `fn(state, *inputs)`. The hand-written kernels are
operators (`ops_cuda.flash_attention`'s `paddle_tpu_torch::` K2/K3), so
a program holds one node per call and launches them again when it runs.
Python `if`/`while`/`for range` over traced tensors are rewritten onto
`torch.cond` / `while_loop` first (`dy2static`).

`to_static(fn_or_layer)` keeps one program per (training flag, input
signature), the analog of jax.jit's cache. A Layer call reads the
layer's current parameters and buffers (an optimizer step between two
calls is seen), gradients flow to them, and a train-mode BatchNorm's
new running statistics land in its own `_mean` / `_variance` (the
captured program writes them in place, as the eager BatchNorm does; JAX
returns them and `load_raw_buffers` installs them).

Artifacts for prefix ``p``: ``p.pt2`` (the program, `torch.export.save`,
written with no weights and no sample inputs, so loading it unpickles
nothing), ``p.params`` (the weights and buffers: the JAX package's
data-only npz, keys ``params/<name>`` and ``buffers/<name>``, bf16 as
raw 2-byte values named in ``__dtypes__``) and ``p.meta.json`` (input
specs, ``"framework": "paddle_tpu_torch"``, the device it was traced
on). A JAX artifact (``p.stablehlo``) is not loadable here, and `load`
says so.

Entry points run on the card unless the caller names another device: a
Layer is captured where its weights live, a function (or a Layer with
no weights) where its tensor inputs live, and otherwise (numpy arrays
or Python numbers alone, `save` of a function, `load`) on "cuda",
which raises without a card.
"""
from __future__ import annotations

import itertools
import json
import os
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core import resolve_device
from ..static import InputSpec, dtype_name, torch_dtype
from .dy2static import Dy2StaticError, convert_to_static

__all__ = ["InputSpec", "to_static", "save", "load", "StaticFunction",
           "TranslatedLayer", "Dy2StaticError", "read_artifacts",
           "has_control_flow"]

_META_VERSION = 1
FRAMEWORK = "paddle_tpu_torch"
NATIVE_ITEM = ("the native C++ runtime (jit.save(native=..., "
               "batch_buckets=...), Config.enable_native_runtime) is "
               "ROADMAP Queue 1 item 13.2b")


def _register_ops():
    """Import the modules that register the port's operators, so a
    fresh process can run a program holding `paddle_tpu_torch::`
    nodes."""
    from ..ops_cuda import flash_attention  # noqa: F401


# --------------------------------------------------------------------------- #
# input specs and the traced state
# --------------------------------------------------------------------------- #


def _normalize_input_spec(input_spec, example_args=None) -> List[InputSpec]:
    if input_spec is None:
        if example_args is None:
            raise ValueError("input_spec is required to export without "
                             "example inputs")
        return [InputSpec.from_tensor(_as_tensor(a)) for a in example_args]
    out = []
    for s in input_spec:
        if isinstance(s, InputSpec):
            out.append(s)
        elif hasattr(s, "shape"):
            out.append(InputSpec.from_tensor(s))
        else:  # a bare shape
            out.append(InputSpec(s))
    return out


def _dynamic_shapes(specs: Sequence[InputSpec]):
    """Each spec's `torch.export` dims: a `None` in dim 0 maps to one
    "batch" dim shared by every input (a dynamic batch); a `None`
    elsewhere gets a dim of its own (`_specs_to_avals` in JAX)."""
    from torch.export import Dim
    batch = None
    out = []
    for i, spec in enumerate(specs):
        dims = {}
        for j, d in enumerate(spec.shape):
            if d is not None:
                continue
            if j == 0:
                batch = batch or Dim("batch", min=1)
                dims[j] = batch
            else:
                dims[j] = Dim(f"d{i}_{j}", min=1)
        out.append(dims or None)
    return out


def _as_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """A tensor of `a` (numpy, a Python number or a tensor) on `device`
    in `dtype` (either None: as it is; a Python number takes bool,
    int64 or float32 by its kind, as jax.jit traces a weak scalar)."""
    if isinstance(a, torch.Tensor):
        t = a
    elif isinstance(a, (bool, int, float)):
        kind = torch.bool if isinstance(a, bool) else \
            torch.int64 if isinstance(a, int) else torch.float32
        t = torch.tensor(a, dtype=kind)
    else:
        from ..core import host_tensor
        t = host_tensor(np.asarray(a))
    return t.to(device=device if device is not None else t.device,
                dtype=dtype if dtype is not None else t.dtype)


def _layer_device(layer: nn.Module) -> Optional[torch.device]:
    """The device of the layer's weights (None: it has none)."""
    for t in itertools.chain(layer.parameters(), layer.buffers()):
        return t.device
    return None


def _layer_state(layer: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The layer's own parameters and buffers (the tensors themselves:
    gradients reach them, and in-place buffer writes land in them)."""
    return {"params": dict(layer.named_parameters()),
            "buffers": dict(layer.named_buffers())}


def _detached(state):
    """The state's tensors detached (what a capture traces over)."""
    return {g: {k: v.detach() for k, v in d.items()}
            for g, d in state.items()}


def _check_no_stat_sink(layer: nn.Module):
    live = [n for n, m in layer.named_modules()
            if getattr(m, "_stat_sink", None) is not None]
    if live:
        raise RuntimeError(f"a BatchNorm StatSink is live on {live[:3]} "
                           f"(a Trainer step in progress): capture runs "
                           f"outside it")


def _pure(obj) -> Callable:
    """`fn(state, *inputs, **kw)` of a Layer (over the state's tensors)
    or a function (the state is empty)."""
    if isinstance(obj, nn.Module):
        layer = obj

        def fn(state, *inputs, **kw):
            return torch.func.functional_call(
                layer, {**state["params"], **state["buffers"]}, inputs, kw,
                strict=True)
    else:
        f = obj

        def fn(state, *inputs, **kw):
            return f(*inputs, **kw)
    return fn


class _Program(nn.Module):
    """The module `torch.export` traces: `forward(state, *inputs)`."""

    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def forward(self, state, *inputs, **kw):
        return self._fn(state, *inputs, **kw)


def _export(fn, state, args, kwargs=None, dynamic_shapes=None):
    """`torch.export.export` of `fn(state, *args)`, non-strict. A traced
    condition that reached Python control flow the converter left
    alone raises `Dy2StaticError`."""
    try:
        return torch.export.export(
            _Program(fn), (state,) + tuple(args), kwargs or {},
            dynamic_shapes=dynamic_shapes, strict=False)
    except Exception as e:
        chain = _chain(e)
        for x in chain:
            # a converter error raised inside a torch.cond / while_loop
            # branch, which Dynamo traces: it re-raises the error as an
            # "observed" exception of its own class, message kept
            if isinstance(x, Dy2StaticError) or type(x).__name__ == \
                    f"Observed{Dy2StaticError.__name__}Error":
                raise Dy2StaticError(str(x)) from e
        if any(type(x).__name__ == "GuardOnDataDependentSymNode"
               for x in chain):
            raise Dy2StaticError(
                "a traced value reached un-converted Python control flow "
                "(see the frame above for the file:line). dy2static "
                "converts if/while/for-range (with break/continue/"
                "return); this statement stayed Python — usually a for "
                "over a non-range iterable, a loop with an else clause, a "
                "closure using `nonlocal`, or source that is unavailable. "
                "Restructure to a supported form or compute the condition "
                "outside the capture.") from e
        raise


def _chain(e):
    seen = []
    while e is not None and e not in seen:
        seen.append(e)
        e = e.__cause__ or e.__context__
    return seen


def has_control_flow(program) -> bool:
    """Whether an exported program (or its graph module) holds a
    `torch.cond` or `while_loop` node, in any subgraph."""
    gm = getattr(program, "graph_module", program)
    hops = (torch.ops.higher_order.cond, torch.ops.higher_order.while_loop)
    return any(n.op == "call_function" and n.target in hops
               for m in gm.modules() if isinstance(m, torch.fx.GraphModule)
               for n in m.graph.nodes)


# --------------------------------------------------------------------------- #
# to_static
# --------------------------------------------------------------------------- #


def _signature(args, kwargs):
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return ("T", tuple(a.shape), a.dtype, a.device)
        return ("C", type(a).__name__, repr(a))
    return (tuple(leaf(a) for a in args),
            tuple(sorted((k, leaf(v)) for k, v in kwargs.items())))


class StaticFunction:
    """Captured view of a function or Layer call.

    The cache holds one `torch.export` program per (training flag,
    input signature): shapes, dtypes and devices of the tensor inputs
    and the values of the others, the analog of jax.jit's aval cache
    (the reference's ProgramCache keyed on InputSpec). Numpy arrays and
    Python numbers among the positional inputs become tensors first, as
    jax.jit traces them: on a Layer's device, else on the device of the
    call's first tensor, else on the card (raising without one)."""

    def __init__(self, function: Callable, input_spec=None):
        self._input_spec = (None if input_spec is None
                            else _normalize_input_spec(input_spec))
        self._layer: Optional[nn.Module] = None
        if isinstance(function, nn.Module):
            self._layer = function
            fwd = function.forward
            conv = convert_to_static(getattr(fwd, "__func__", fwd))
            if getattr(conv, "__wrapped_dy2static__", False):
                # an instance attribute shadows the class's forward, so
                # the capture sees the converted control flow
                object.__setattr__(function, "forward",
                                   conv.__get__(function))
            self._function = function.forward
            self._pure = _pure(function)
        else:
            self._function = convert_to_static(function)
            self._pure = _pure(self._function)
        self._programs: Dict[Any, Any] = {}

    @property
    def input_spec(self):
        return self._input_spec

    def _device(self, args=()) -> torch.device:
        return ((self._layer is not None and _layer_device(self._layer))
                or next((a.device for a in args
                         if isinstance(a, torch.Tensor)), None)
                or resolve_device(None))

    def _inputs(self, args):
        if all(isinstance(a, torch.Tensor) or a is None for a in args):
            return tuple(args)
        device = self._device(args)
        return tuple(a if isinstance(a, torch.Tensor) or a is None
                     else _as_tensor(a, device) for a in args)

    def _state(self):
        if self._layer is None:
            return {"params": {}, "buffers": {}}
        return _layer_state(self._layer)

    def _training(self) -> bool:
        return bool(self._layer is not None and self._layer.training)

    def program(self, *args, **kwargs):
        """The captured program (`torch.export.ExportedProgram`) for
        these inputs, captured on first use."""
        return self._entry(self._inputs(args), kwargs)[0]

    def _entry(self, args, kwargs):
        """(program, its callable module) of this signature."""
        key = (self._training(), _signature(args, kwargs))
        entry = self._programs.get(key)
        if entry is None:
            if self._layer is not None:
                _check_no_stat_sink(self._layer)
            prog = _export(self._pure, _detached(self._state()), args,
                           kwargs)
            entry = self._programs[key] = (prog, prog.module())
        return entry

    def __call__(self, *args, **kwargs):
        args = self._inputs(args)
        return self._entry(args, kwargs)[1](self._state(), *args, **kwargs)

    @property
    def code(self) -> str:
        """The captured program's Python code for the declared
        input_spec (`None` dims at 2), traced on a Layer's device, else
        on the card."""
        if self._input_spec is None:
            raise ValueError("input_spec required to render code")
        device = self._device()
        args = [s.example(2, device) for s in self._input_spec]
        return self.program(*args).graph_module.code

    def get_concrete_function(self, *args):
        """A callable bound to the program captured for `args` (no
        capture on call); a Layer's call reads its current state."""
        args = self._inputs(args)
        mod = self._entry(args, {})[1]

        def call(*inner):
            return mod(self._state(), *self._inputs(inner))
        return call


def to_static(function=None, input_spec=None, full_graph=True, **kwargs):
    """`@paddle.jit.to_static` analog. Works as a decorator (with or
    without arguments) and as a direct wrapper over a function or
    Layer."""
    def wrap(f):
        return StaticFunction(f, input_spec=input_spec)
    if function is not None:
        return wrap(function)
    return wrap


# --------------------------------------------------------------------------- #
# save / load
# --------------------------------------------------------------------------- #


def save(obj, path_prefix: str, input_spec=None, *, training: bool = False,
         example_args=None, native: bool = True,
         batch_buckets: Optional[Sequence[int]] = None, device=None,
         **kwargs):
    """Export a Layer (or pure function) to a program + weights.

    The program is `fn(state, *inputs)` with the weights as its first
    argument (the .pdiparams split: weights stay swappable, and a loaded
    program stays trainable through autograd, K3 included). Every
    `None` in dim 0 of the specs is one shared symbolic batch; the
    capture traces a batch of 2 (`torch.export` specialises sizes 0 and
    1) unless `example_args` are given. The layer is traced in eval mode
    unless `training=True`, on the device of its weights; a function (or
    a Layer with no weights) is traced on `device` (default: the card,
    which raises without one).

    `native=True` writes nothing more: the native C++ runtime's sidecars
    come with ROADMAP item 13.2b; `batch_buckets` raises until then.
    The JAX package's other keywords (`platforms`, `vjp_order`) are
    accepted and ignored."""
    if batch_buckets:
        raise NotImplementedError(f"batch_buckets: {NATIVE_ITEM}")
    if isinstance(obj, StaticFunction):
        input_spec = input_spec or obj.input_spec
        obj = obj._layer if obj._layer is not None else obj._function
    specs = _normalize_input_spec(input_spec, example_args)
    if isinstance(obj, nn.Module):
        _check_no_stat_sink(obj)
        device = _layer_device(obj) or resolve_device(device)
        state = _detached(_layer_state(obj))
    else:
        device = resolve_device(device)
        obj = convert_to_static(obj)
        state = {"params": {}, "buffers": {}}
    if example_args is not None:
        args = [_as_tensor(a, device, s.dtype)
                for a, s in zip(example_args, specs)]
    else:
        args = [s.example(2, device) for s in specs]
    dyn = {"state": {g: {k: None for k in d} for g, d in state.items()},
           "inputs": tuple(_dynamic_shapes(specs))}
    was = obj.training if isinstance(obj, nn.Module) else None
    if was is not None:
        obj.train(training)
    try:
        ep = _export(_pure(obj), state, args, dynamic_shapes=dyn)
    finally:
        if was is not None:
            obj.train(was)
    ep.example_inputs = None       # no pickled sample inputs in the .pt2

    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    torch.export.save(ep, path_prefix + ".pt2")
    _save_state(state, path_prefix + ".params")
    meta = {
        "version": _META_VERSION,
        "framework": FRAMEWORK,
        "input_specs": [{"shape": [None if s is None else int(s)
                                   for s in sp.shape],
                         "dtype": dtype_name(sp.dtype),
                         "name": sp.name or f"x{i}"}
                        for i, sp in enumerate(specs)],
        "device": device.type,
        "training": bool(training),
    }
    with open(path_prefix + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return path_prefix


def _save_state(state, path):
    """The JAX package's data-only .params: an npz of flat arrays (no
    pickle: a serving artifact must never be code), keys
    `params/<name>` and `buffers/<name>`; bf16 saved as raw 2-byte
    values whose dtype name rides a JSON `__dtypes__` entry."""
    flat, ext_dtypes = {}, {}
    for group in ("params", "buffers"):
        for k, v in state.get(group, {}).items():
            key = f"{group}/{k}"
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                flat[key] = t.contiguous().view(torch.int16).numpy().view(
                    np.dtype("V2"))
                ext_dtypes[key] = "bfloat16"
            else:
                flat[key] = t.numpy()
    flat["__dtypes__"] = np.frombuffer(
        json.dumps(ext_dtypes).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def _load_state(path) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"params": {name: CPU tensor}, "buffers": {...}} of a .params
    file (the port's or the JAX package's), bf16 carried bit for bit.
    Refuses anything but an npz: nothing is unpickled."""
    with open(path, "rb") as f:
        if f.read(2) != b"PK":
            raise ValueError(f"{path} is not an npz .params file (a legacy "
                             f"pickle artifact is not loaded by the port)")
    state: Dict[str, Dict[str, torch.Tensor]] = {"params": {}, "buffers": {}}
    with np.load(path, allow_pickle=False) as data:
        ext = json.loads(bytes(data["__dtypes__"]).decode()) \
            if "__dtypes__" in data.files else {}
        for key in data.files:
            if key == "__dtypes__":
                continue
            group, name = key.split("/", 1)
            a = data[key]
            if key in ext:
                if ext[key] != "bfloat16":
                    raise ValueError(f"{key}: dtype {ext[key]} is not "
                                     f"supported by the port")
                t = torch.from_numpy(np.array(a).view(np.int16)).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(a))
            state.setdefault(group, {})[name] = t
    return state


def _check_archive(path):
    """Refuse a .pt2 whose loading would unpickle anything: sample
    inputs, or weights / constants stored as pickles."""
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            name = info.filename
            if "/data/sample_inputs/" in name and info.file_size:
                raise ValueError(f"{path}: holds pickled sample inputs "
                                 f"({name}); re-export with jit.save")
            if name.endswith("_config.json") and "/data/" in name:
                cfg = json.loads(z.read(name) or b"{}")
                entries = cfg.get("config", cfg)
                if any(isinstance(v, dict) and v.get("use_pickle")
                       for v in entries.values()):
                    raise ValueError(f"{path}: {name} names pickled "
                                     f"tensors; re-export with jit.save")


def read_artifacts(path_prefix: str, device: torch.device):
    """(program, state, meta) of one artifact, shared by `jit.load` and
    `inference.Predictor`. The program is moved to `device` when that
    differs from the device it was traced on."""
    _register_ops()
    if not os.path.exists(path_prefix + ".pt2"):
        if os.path.exists(path_prefix + ".stablehlo"):
            raise ValueError(
                f"{path_prefix}.stablehlo is a JAX package artifact "
                f"(serialized StableHLO); the port loads only its own "
                f"torch.export programs (<prefix>.pt2, written by "
                f"paddle_tpu_torch.jit.save). Re-export the model with "
                f"the port")
        raise FileNotFoundError(f"no exported model at {path_prefix!r} "
                                f"(expected <prefix>.pt2)")
    with open(path_prefix + ".meta.json") as f:
        meta = json.load(f)
    if meta.get("framework") != FRAMEWORK:
        raise ValueError(f"{path_prefix}.meta.json: framework "
                         f"{meta.get('framework')!r}, not {FRAMEWORK!r}")
    if meta.get("version", 0) > _META_VERSION:
        raise ValueError(f"artifact version {meta['version']} is newer than "
                         f"this framework ({_META_VERSION})")
    _check_archive(path_prefix + ".pt2")
    ep = torch.export.load(path_prefix + ".pt2")
    saved = meta.get("device", "cpu")
    target = torch.device(device)
    if target.type != saved:
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, str(target))
    state = _load_state(path_prefix + ".params")
    return ep, state, meta


class TranslatedLayer(nn.Module):
    """A loaded program, presented as a Layer (reference:
    TranslatedLayer, runs the loaded program and supports fine-tuning).

    Weights are Parameters and buffers of this module (dots in the
    original names flattened as ``__``, as in the JAX package), so
    optimizers and `state_dict` see them; `forward` rebuilds the state
    from them and calls the program, whose K2/K3 nodes reach the
    kernels again (the backward through the operator's registered
    autograd)."""

    def __init__(self, program, state, meta, device):
        super().__init__()
        self.__dict__["_exported"] = program
        self.__dict__["_module"] = program.module()
        self._meta = meta
        self._load_device = device      # inputs' device with no weights
        self._param_paths: Dict[str, str] = {}
        self._buffer_paths: Dict[str, str] = {}
        for path, t in state["params"].items():
            safe = path.replace(".", "__")
            self._param_paths[safe] = path
            self.register_parameter(safe, nn.Parameter(t.to(device)))
        for path, t in state["buffers"].items():
            safe = path.replace(".", "__")
            self._buffer_paths[safe] = path
            self.register_buffer(safe, t.to(device))
        self.eval()

    def _state(self):
        return {"params": {p: self._parameters[k]
                           for k, p in self._param_paths.items()},
                "buffers": {p: self._buffers[k]
                            for k, p in self._buffer_paths.items()}}

    def _device(self) -> torch.device:
        return _layer_device(self) or self._load_device

    def forward(self, *inputs):
        dev = self._device()
        args = [_as_tensor(a, dev, torch_dtype(sp["dtype"]))
                for a, sp in zip(inputs, self._meta["input_specs"])]
        return self._module(self._state(), *args)

    @property
    def input_specs(self):
        return [InputSpec(sp["shape"], sp["dtype"], sp["name"])
                for sp in self._meta["input_specs"]]

    @property
    def program(self):
        """The loaded `torch.export.ExportedProgram`."""
        return self._exported


def load(path_prefix: str, device=None) -> TranslatedLayer:
    """Reload an exported model as a `TranslatedLayer` on `device`
    (default: the card, which raises without one; pass "cpu" to run on
    the CPU), wherever it was saved from."""
    dev = resolve_device(device)
    ep, state, meta = read_artifacts(path_prefix, dev)
    return TranslatedLayer(ep, state, meta, dev)
