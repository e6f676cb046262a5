"""Build and load the CUDA kernels of ``csrc/`` (route: nvcc by hand into a
shared library with a plain C interface, loaded with ctypes).

``load()`` compiles at first use into ``build/repro_torch/`` at the repo
root (listed in ``.gitignore``), from the sources in the checkout only, and
caches the loaded library.  The library's name carries a hash of the
sources and flags, so an edited source is rebuilt.  A missing ``nvcc`` or
a failed build raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
SOURCES = ("shotgun_block.cu",)
HEADERS = ("shotgun_block.cuh",)
BUILD_DIR = PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# Filled by load(): seconds spent in nvcc (0.0 when the library was
# already built) and the compiler's stderr (the -Xptxas -v report).
build_info = {"seconds": None, "ptxas": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "sb_gather_block_matvec": [_P, _I, _P, _P, _P, _P, _L, _L, _I, _I, _I, _P],
    "sb_scatter_block_update": [_P, _I, _P, _P, _P, _P, _L, _L, _I, _P],
    "sb_fused_shotgun_rounds": [_P, _I, _I] + [_P] * 15
                               + [_L, _L, _I, _I, _I, _I, _P],
    "sb_fused_grid_blocks": [_I, _I],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources into the build directory (if not there yet) and
    return the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libshotgun_block-{_digest()}.so"
    if target.exists():
        build_info["seconds"] = 0.0
        return target
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["ptxas"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    # atomic rename: a concurrent build never sees half a file
    os.replace(tmp, target)
    return target


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
