"""Compile and load the native (C++) components (the port's counterpart of
deftet_tpu/native/build.py).

``native/<name>.cpp`` is compiled by ``g++`` into a shared library at its
first use (never at import), into ``build/native/`` at the root of the
checkout, beside the CUDA kernels' ``build/kernels/``.  The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt.  The compiler writes a temporary file unique to its process,
renamed into place, so two processes building at once (test workers) do
not write over each other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

# No -march=native: the library lands in the checkout, and a checkout is
# copied between hosts (the CPU it was built on need not be the CPU that
# loads it; the hash names the source and flags, not the host).  The
# builders are sorts of 64-bit keys, which host-specific vector
# instructions hardly speed up.
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_CACHE: dict = {}
build_log: dict = {}  # name -> seconds of its last g++ run in this process


def native_available() -> bool:
    return shutil.which("g++") is not None


def library_path(name: str) -> Path:
    """Where ``native/<name>.cpp`` is built with the current flags."""
    src = SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_library(name: str = "topology", force: bool = False) -> Path:
    """Compile ``native/<name>.cpp`` unless it is built (always with
    ``force``); returns the library's path.  Raises without g++ or when
    the compiler fails."""
    out = library_path(name)
    if out.exists() and not force:
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([gxx, *FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o",
                           str(tmp)], capture_output=True, text=True)
    build_log[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on native/{name}.cpp "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library(name: str = "topology") -> Optional[ctypes.CDLL]:
    """The loaded library of ``native/<name>.cpp``, compiled if needed;
    None where there is no g++."""
    with _lock:
        if name not in _CACHE:
            _CACHE[name] = (ctypes.CDLL(str(build_library(name)))
                            if native_available() else None)
        return _CACHE[name]
