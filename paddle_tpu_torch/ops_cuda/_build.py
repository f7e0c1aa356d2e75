"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library with a
plain C interface, loaded with `ctypes`. Sources include no PyTorch
header, so a build takes seconds. Libraries land in
`paddle_tpu_torch/_build/` (not tracked), named by a hash of the
sources and flags: an edited source builds anew, an unchanged one is
reused. Nothing builds at import; the first launch of a kernel builds
it, or a caller builds every kernel up front with `build()`, which
starts one `nvcc` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load_library",
           "library_path", "nvcc_path"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
_NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

Signature = Tuple[object, Sequence[object]]   # (restype, argtypes)


def nvcc_path() -> str:
    """The CUDA toolkit's nvcc, found the way
    `torch.utils.cpp_extension` finds the toolkit (CUDA_HOME /
    CUDA_PATH, nvcc on PATH)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return nvcc


def _digest() -> str:
    """Hash of every source and header under csrc/ plus the flags: a
    shared header edit rebuilds every kernel."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def kernel_names() -> Sequence[str]:
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, float]:
    """Compile the named kernels (default: every csrc/*.cu) that are not
    built yet, one nvcc process per source, all started together.
    Returns {name: seconds} for the kernels compiled now (a kernel
    already built is left out). `verbose` adds `-Xptxas -v` and prints
    what ptxas reports (registers, shared memory, spills)."""
    names = list(names) if names is not None else list(kernel_names())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        src = _CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(f"no kernel source {src.name}")
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS,
               *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True),
                      tmp, out, time.perf_counter())
    times, errors = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        try:
            stdout, stderr = proc.communicate(timeout=_NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            errors.append(f"{name}: nvcc timed out after "
                          f"{_NVCC_TIMEOUT_S} s")
            continue
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)     # atomic: a reader never sees half a file
        if verbose and (stdout or stderr):
            print(f"[nvcc {name}]\n{stdout}{stderr}", flush=True)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return times


def load_library(name: str,
                 signatures: Optional[Dict[str, Signature]] = None
                 ) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed.
    `signatures` ({function: (restype, argtypes)}) is applied on the
    first load; every pointer and the stream go as `c_void_p` so that
    ctypes never truncates them to 32 bits."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in (signatures or {}).items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = list(argtypes)
            _libs[name] = lib
        return lib
