"""Core runtime helpers of the PyTorch/CUDA package: device resolution,
dtype names, the global seeded generator, grad mode and the flags.

The counterpart of `paddle_tpu/core.py`. Device policy: every entry
point takes an explicit `device`, defaulting to `default_device()`,
which is "cuda" until `set_device` names another. Asking for "cuda" on
a machine without a card raises — the port never drops quietly to the
CPU; the CPU runs only when the caller names it (`set_device("cpu")`
or `device="cpu"`, as the tests do).

dtypes: the reference's names (`float32` ... `complex128`, `bool_`) as
torch dtypes, and `convert_dtype` over the reference's alias table with
its contract: 64-bit names canonicalise to 32-bit (the JAX package runs
with x64 off, so "int64" means "the index dtype", int32).

Randomness: `Generator` is the reference's counter-based generator, a
(seed, counter) pair behind a lock; each draw hashes the pair into the
seed of a fresh `torch.Generator` on the draw's device
(`Generator.next_generator`), the idiom of `nn/rng.py`, so torch's
global RNG is never used. `next_generator()` is the counterpart of the
reference's `next_rng_key()`: the port hands out a seeded generator
where JAX hands out a key. `seed(s)` reseeds the default generator,
which `PTPU_SEED` seeds at import. Draws equal JAX's in law, not in
bits.

`host_tensor` turns a host array (a numpy array from the JAX package,
its `bfloat16` extension dtype included, or a tensor) into a CPU tensor.

Flags: `set_flags` / `get_flags` over the reference's five flags, with
the same `FLAGS_<name>` environment bridge; `matmul_precision` maps onto
`torch.set_float32_matmul_precision` ("default" leaves it as it is, as
the reference leaves JAX's), `check_nan_inf` arms `check_numerics` (and
the Trainer's numerics check).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = ["default_device", "resolve_device", "resolve_dtype",
           "make_generator", "cast_floating", "host_tensor", "set_flags",
           "get_flags", "foreach_groups", "fp32_norms", "mul_fp32",
           "bfloat16", "float16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "complex64", "complex128",
           "convert_dtype", "is_floating_dtype", "is_integer_dtype",
           "set_default_dtype", "get_default_dtype", "set_device",
           "get_device", "device_count", "is_compiled_with_tpu",
           "Generator", "seed", "default_generator", "next_generator",
           "hash_seed", "canonical_dtype", "no_grad", "is_grad_enabled",
           "check_numerics"]

_FLAG_DEFAULTS = {
    "check_nan_inf": False,          # the reference's FLAGS_check_nan_inf
    "benchmark": False,
    "jit_compile": True,
    "deterministic": False,
    "matmul_precision": "default",   # 'default' | 'high' | 'highest'
}
_flags = dict(_FLAG_DEFAULTS)
for _k, _d in _FLAG_DEFAULTS.items():
    _env = os.environ.get("FLAGS_" + _k)
    if _env is not None:
        _flags[_k] = _env.lower() in ("1", "true", "yes") \
            if isinstance(_d, bool) else _env


def set_flags(flags: dict) -> None:
    """Set flags by name; an unknown name raises `KeyError`."""
    for k in flags:
        if k not in _flags:
            raise KeyError(f"unknown flag {k!r}; known: {sorted(_flags)}")
    _flags.update(flags)
    if flags.get("matmul_precision", "default") != "default":
        torch.set_float32_matmul_precision(flags["matmul_precision"])


def get_flags(keys=None) -> dict:
    """{name: value} of `keys` (a name or a list of names; all flags for
    None)."""
    if keys is None:
        return dict(_flags)
    if isinstance(keys, str):
        keys = [keys]
    return {k: _flags[k] for k in keys}

_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16,
}

DeviceLike = Union[str, torch.device, None]


_device_lock = threading.Lock()
_current_device: Optional[torch.device] = None


def default_device() -> str:
    """The device an entry point uses when the caller names none: the
    one `set_device` named, else "cuda"."""
    dev = _current_device
    return "cuda" if dev is None else str(dev)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` (or the default) as a `torch.device`. Raises
    `RuntimeError` for a CUDA device when no card is present, instead
    of running somewhere the caller did not ask for."""
    dev = torch.device(device if device is not None else default_device())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU explicitly")
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype, None],
                  default: torch.dtype = torch.float32) -> torch.dtype:
    """A dtype given by name ("bf16", "float32", ...) or as a
    `torch.dtype`; None gives `default`."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype).lower()]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def make_generator(seed: int, device: Optional[DeviceLike] = "cpu"
                   ) -> torch.Generator:
    """An explicit seeded `torch.Generator` (the port keeps no global
    RNG state: every random draw names its generator)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor of `a`: a tensor as it is (moved to the CPU), a
    numpy array as a writable copy, numpy's `bfloat16` extension dtype
    carried bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def cast_floating(tree, dtype):
    """Cast every floating-point tensor of a nest of dicts, lists and
    tuples to `dtype`, passing everything else (token ids, masks)
    through. The single home of the AMP cast policy."""
    dtype = resolve_dtype(dtype)
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def foreach_groups(ts):
    """Indices of `ts` grouped by (device, dtype), so every
    `torch._foreach_*` call takes its fast path."""
    out: dict = {}
    for i, t in enumerate(ts):
        out.setdefault((t.device, t.dtype), []).append(i)
    return out.values()


def fp32_norms(ts, ord: float = 2):
    """The `ord` norm of each tensor, reduced in fp32 (0-d fp32
    tensors), one `torch._foreach_norm` per (device, dtype) group."""
    ts = list(ts)
    out = [None] * len(ts)
    for idx in foreach_groups(ts):
        for i, n in zip(idx, torch._foreach_norm([ts[i] for i in idx], ord,
                                                 dtype=torch.float32)):
            out[i] = n
    return out


def mul_fp32(tensors, scale: torch.Tensor):
    """Each tensor times the 0-d fp32 `scale`, the product taken in fp32
    and rounded once to the tensor's dtype (`(g.astype(f32) * s).
    astype(g.dtype)` in the JAX package). fp32 tensors in one
    `torch._foreach_mul` per device; the others one at a time."""
    tensors = list(tensors)
    out = [None] * len(tensors)
    f32: dict = {}
    for i, t in enumerate(tensors):
        if t.dtype == torch.float32:
            f32.setdefault(t.device, []).append(i)
        else:
            out[i] = (t.float() * scale.to(t.device)).to(t.dtype)
    for dev, idx in f32.items():
        for i, r in zip(idx, torch._foreach_mul([tensors[i] for i in idx],
                                                scale.to(dev))):
            out[i] = r
    return out


# --------------------------------------------------------------------------- #
# dtypes
# --------------------------------------------------------------------------- #

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_DTYPE_ALIASES = {
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "fp64": torch.float64, "double": torch.float64,
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8, "uint16": torch.uint16, "uint32": torch.uint32,
    "uint64": torch.uint64,
    "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
    "float8_e4m3": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
# x64 off: each 64-bit dtype stands for its 32-bit twin
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def _as_torch_dtype(dtype: Any) -> torch.dtype:
    """`dtype` (a name, a torch dtype, a numpy dtype or scalar type) as
    the torch dtype of the same name, not canonicalised."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _DTYPE_ALIASES[dtype]
        except KeyError:
            raise ValueError(f"unknown dtype {dtype!r}") from None
    name = np.dtype(dtype).name
    if name == "bool":
        return torch.bool
    try:
        return _DTYPE_ALIASES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


def canonical_dtype(dtype: torch.dtype) -> torch.dtype:
    """A 64-bit dtype's 32-bit twin; any other dtype as it is."""
    return _CANONICAL.get(dtype, dtype)


def convert_dtype(dtype: Any) -> Optional[torch.dtype]:
    """Normalise a dtype spec (a name from the reference's alias table,
    a torch or numpy dtype) to a torch dtype, 64-bit types canonicalised
    to 32-bit as the reference does with x64 off; None stays None."""
    if dtype is None:
        return None
    return canonical_dtype(_as_torch_dtype(dtype))


def is_floating_dtype(dtype) -> bool:
    return _as_torch_dtype(dtype).is_floating_point


def is_integer_dtype(dtype) -> bool:
    d = _as_torch_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


class _State(threading.local):
    def __init__(self):
        self.default_dtype = torch.float32


_state = _State()


def set_default_dtype(dtype) -> None:
    """The dtype creation ops use when given none (this thread)."""
    _state.default_dtype = convert_dtype(dtype)


def get_default_dtype() -> torch.dtype:
    return _state.default_dtype


# --------------------------------------------------------------------------- #
# device management
# --------------------------------------------------------------------------- #

def _parse_device(spec) -> torch.device:
    """Paddle's "gpu:0" (or "cuda:0", "gpu", "cpu", a `torch.device`) as
    a `torch.device`; the card is checked to exist."""
    if isinstance(spec, torch.device):
        spec = str(spec)
    kind, _, idx = str(spec).strip().lower().partition(":")
    if kind == "tpu":
        raise ValueError(
            "the PyTorch/CUDA port runs on an NVIDIA card, not a TPU: use "
            "set_device('gpu:0') (or 'cuda:0'), or 'cpu'")
    if kind not in ("gpu", "cuda", "cpu"):
        raise ValueError(f"unknown device {spec!r}; expected 'gpu:N', "
                         f"'cuda:N' or 'cpu'")
    if kind == "cpu":
        return torch.device("cpu")
    dev = resolve_device(f"cuda:{int(idx) if idx else 0}")
    if dev.index >= torch.cuda.device_count():
        raise ValueError(f"device index {dev.index} out of range "
                         f"({torch.cuda.device_count()} cards)")
    return dev


def set_device(spec) -> torch.device:
    """`paddle.set_device` analog: what `default_device()` returns from
    now on, process-wide. "gpu:N" and "cuda:N" name a card (raising when
    there is none), "cpu" the CPU; "tpu" raises."""
    global _current_device
    dev = _parse_device(spec)
    with _device_lock:
        _current_device = dev
    return dev


def get_device() -> str:
    """The default device in Paddle's spelling: "gpu:N" or "cpu"."""
    dev = torch.device(default_device())
    if dev.type == "cpu":
        return "cpu"
    return f"gpu:{dev.index or 0}"


def device_count(kind: str = "gpu") -> int:
    """The number of cards ("gpu", "cuda" or the reference's "tpu": the
    accelerators), or 1 for "cpu"."""
    if kind == "cpu":
        return 1
    return torch.cuda.device_count()


def is_compiled_with_tpu() -> bool:
    """Whether an accelerator is present: the reference's question,
    answered for this package's accelerator, a CUDA card."""
    return torch.cuda.is_available()


# --------------------------------------------------------------------------- #
# the global generator
# --------------------------------------------------------------------------- #

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def hash_seed(*words: int) -> int:
    """A 63-bit seed hashed from integers (splitmix64 over the words)."""
    h = 0
    for word in words:
        h = _splitmix64(h ^ (int(word) & _M64))
    return h & ((1 << 63) - 1)


class Generator:
    """Counter-based seeded generator: the reference's `Generator`
    (`paddle_tpu/core.py`), a (seed, counter) pair behind a lock. Each
    draw takes the next counter and seeds a fresh `torch.Generator` on
    the draw's device with a hash of the pair, so draws are
    reproducible under `manual_seed` and a recomputed forward that
    replays the counter draws the same."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._count = 0
        self._epoch = 0   # bumped per manual_seed, as in the reference
        self._lock = threading.Lock()

    def manual_seed(self, seed: int) -> "Generator":
        with self._lock:
            self._seed = int(seed)
            self._count = 0
            self._epoch += 1
        return self

    @property
    def initial_seed(self) -> int:
        return self._seed

    def next_seed(self) -> int:
        """The seed of the next draw (the counter then moves on)."""
        with self._lock:
            c = self._count
            self._count += 1
        return hash_seed(self._seed, c)

    def next_generator(self, device=None) -> torch.Generator:
        """A fresh `torch.Generator` on `device` (the default device for
        None) seeded for the next draw."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(self.next_seed())
        return g

    def get_state(self):
        return (self._seed, self._count)

    def set_state(self, state):
        with self._lock:
            self._seed, self._count = (int(v) for v in state)


_default_generator = Generator(seed=int(os.environ.get("PTPU_SEED", "0")))


def seed(value: int) -> Generator:
    """`paddle.seed` analog: reseed the default generator."""
    return _default_generator.manual_seed(value)


def default_generator() -> Generator:
    return _default_generator


def next_generator(device=None) -> torch.Generator:
    """The default generator's next draw as a seeded `torch.Generator`
    on `device` (the counterpart of the reference's `next_rng_key`)."""
    return _default_generator.next_generator(device)


# --------------------------------------------------------------------------- #
# grad mode and numerics
# --------------------------------------------------------------------------- #

def no_grad():
    """`paddle.no_grad`: torch's grad mode off inside (a context manager
    and a decorator)."""
    return torch.no_grad()


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def check_numerics(x, name: str = "tensor"):
    """FLAGS_check_nan_inf: raise `FloatingPointError` if a floating
    tensor holds a NaN or an Inf, with one host read; a no-op unless
    the flag is on. Returns x."""
    if not _flags["check_nan_inf"]:
        return x
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if (t.is_floating_point() or t.is_complex()) \
            and not bool(torch.isfinite(t).all()):
        raise FloatingPointError(f"NaN/Inf detected in {name}")
    return x
