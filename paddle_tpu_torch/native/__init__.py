"""Host C++ libraries of the port, built with g++ at first use.

The counterpart of the JAX package's `utils/cpp_extension.py` loader for
the one host library the port has, the sparse table behind `ps/`
(`ps_table.cc`). A source compiles with `g++ -O3 -shared -fPIC
-std=c++17 -pthread` into `paddle_tpu_torch/_build/` (not tracked, the
directory the CUDA kernels build into), named by a hash of the source
and flags, and loads with `ctypes`. Each build is counted in
`ops_cuda._build.BUILDS` under the source's name, so an engine's capture
watchdog sees it (its `native_build` kind, a budget of one per source).

The loader keeps the reference's rules: lazy, built once per process
behind a lock, and `None` (the caller's pure-Python fallback) when
`PTPU_NO_NATIVE` is set or the toolchain is missing or fails.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

from ..ops_cuda import _build

__all__ = ["HOST_FLAGS", "NATIVE_SOURCES", "host_library_path",
           "lazy_host_loader"]

_SRC_DIR = Path(__file__).resolve().parent
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# the host sources, by the name their builds are counted under
NATIVE_SOURCES = ("ps_table",)
_GXX_TIMEOUT_S = 180


def host_library_path(name: str) -> Path:
    """`_build/lib<name>-<hash of source and flags>.so`: an edited
    source builds anew, an unchanged one is reused."""
    src = _SRC_DIR / f"{name}.cc"
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(src.read_bytes())
    return _build.BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    out = host_library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *HOST_FLAGS, str(_SRC_DIR / f"{name}.cc"), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=_GXX_TIMEOUT_S)
        if r.returncode != 0:
            raise RuntimeError(f"compiling {name}.cc failed:\n"
                               f"{r.stderr[-4000:]}")
        os.replace(tmp, out)     # atomic: a reader never sees half a file
    finally:
        if tmp.exists():
            tmp.unlink()
    _build.BUILDS[name] = _build.BUILDS.get(name, 0) + 1
    return out


def lazy_host_loader(name: str,
                     bind: Optional[Callable[[ctypes.CDLL], None]] = None
                     ) -> Callable[[], Optional[ctypes.CDLL]]:
    """A zero-argument loader of host library `name`: the first call
    builds (if needed) and loads it and applies `bind(lib)` (argtypes);
    later calls return the same handle. Returns None when
    `PTPU_NO_NATIVE` is set or g++ is missing or fails; a `bind` error
    propagates (a programming error, not a missing toolchain)."""
    if name not in NATIVE_SOURCES:
        raise ValueError(f"unknown host source {name!r} "
                         f"(known: {', '.join(NATIVE_SOURCES)})")
    state = {"lib": None, "tried": False}
    lock = threading.Lock()

    def loader():
        if state["lib"] is not None or state["tried"]:
            return state["lib"]
        with lock:
            if state["lib"] is not None or state["tried"]:
                return state["lib"]
            state["tried"] = True
            if os.environ.get("PTPU_NO_NATIVE"):
                return None
            try:
                lib = ctypes.CDLL(str(_compile(name)))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                return None
            if bind is not None:
                bind(lib)
            state["lib"] = lib
            return lib

    return loader
