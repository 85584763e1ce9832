"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use (never at import), all sources at once in parallel,
into ``build/kernels/`` at the root of the checkout; a library's file
name carries a hash of its source and flags, so an edited source is
rebuilt.

Every wrapper that launches a kernel adds one to that kernel's entry in
the launch counter (``launch_counts``), and nowhere else.
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

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v"]

# name -> (source, extra nvcc flags).  The distance, hit-test,
# point-in-tet and grid-probe kernels compile with -fmad=false: every
# product and sum is rounded separately, in the order the plain PyTorch
# versions evaluate them, so argmin indices, hit lists, containing tets
# and probe rows agree with the plain versions bit for bit instead of
# flipping on FMA near-ties.
KERNELS = {
    "stencil": ("stencil.cu", []),
    "nearest": ("nearest.cu", ["-fmad=false"]),
    "tri_argmin": ("tri_argmin.cu", ["-fmad=false"]),
    "raster_hit": ("raster_hit.cu", ["-fmad=false"]),
    "point_tet": ("point_tet.cu", ["-fmad=false"]),
    "grid_probe": ("grid_probe.cu", ["-fmad=false"]),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {  # name -> {C function: argument types}; all return an int
    "stencil": {"deftet_stencil":
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "nearest": {"deftet_nearest":
                [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
                "deftet_nearest_plan": [_I, _I, _I, _P]},
    "tri_argmin": {"deftet_tri_argmin":
                   [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P]},
    "raster_hit": {"deftet_raster_hit":
                   [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L,
                    _L, _I, _P],
                   "deftet_raster_hit_max_buffered_k": []},
    "point_tet": {"deftet_point_tet_workspace_bytes": [_I, _L],
                  "deftet_point_tet_bin":
                  [_P, _P, _P, _P, _P, _I, _I, _L, _P],
                  "deftet_point_tet_query":
                  [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _P]},
    "grid_probe": {"deftet_grid_probe":
                   [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                    _P, _P]},
}

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}  # name -> {"seconds": float, "ptxas": str}
launch_counts = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> tuple[Path, list]:
    src, extra = KERNELS[name]
    src_path = CSRC_DIR / src
    flags = _ARCH + _COMMON + extra
    digest = hashlib.sha256(
        src_path.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so", flags


def build_all(names=None, force: bool = False) -> dict:
    """Compile every kernel not yet built (all of them with ``force``; one
    nvcc per source, started together); returns {name: library path}.
    Raises on any failure."""
    names = list(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    paths = {}
    for name in names:
        out, flags = _target(name)
        paths[name] = out
        if out.exists() and not force:
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags, "-o", str(tmp), str(CSRC_DIR / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.deftet_error_string.argtypes = [ctypes.c_int]
            lib.deftet_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if err != 0:
        msg = lib.deftet_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err}: {msg}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
