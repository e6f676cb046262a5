"""Build and load the CUDA kernels of ``csrc/`` (route: nvcc by hand into a
shared library with a plain C interface, loaded with ctypes).

``load()`` compiles at first use into ``build/repro_torch/`` at the repo
root (listed in ``.gitignore``), from the sources in the checkout only, and
caches the loaded library.  Each source compiles in its own ``nvcc``, all
started together, and one more ``nvcc`` links the objects.  The library's
name carries a hash of the sources and flags, so an edited source is
rebuilt; the compiler's report (``-Xptxas -v``) is kept beside it under the
same hash (``report_path``).  A missing ``nvcc`` or
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
SOURCES = ("shotgun_block.cu", "shotgun_sparse.cu")
HEADERS = ("shotgun_block.cuh",)
BUILD_DIR = PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# Filled by load(): seconds spent in nvcc (0.0 when the library was
# already built) and the compiler's output (the -Xptxas -v report, read
# back from ``report_path`` when the library was already built).
build_info = {"seconds": None, "ptxas": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "sb_pair_slots": [_I, _I],
    "sb_gather_block_matvec": [_P, _I] + [_P] * 5 + [_L, _L, _I, _I, _P],
    "sb_scatter_block_update": [_P, _I] + [_P] * 4 + [_L, _L, _I, _I, _P],
    "sb_fused_shotgun_rounds": [_P, _I, _I] + [_P] * 15
                               + [_L, _L, _I, _I, _I, _I, _P, _P],
    "sb_fused_shotgun_delta_rounds": [_P, _I, _I] + [_P] * 14
                                     + [_L, _L, _I, _I, _I, _I, _P],
    "sb_fused_grid_blocks": [_I, _I],
    "sb_batched_fused_shotgun_rounds": [_P, _I, _I, _L] + [_P] * 15
                                       + [_L, _L, _I, _I, _I, _I, _I, _P],
    "sb_batched_grid_blocks": [_I, _I],
    "sp_gather_block_matvec": [_P, _P, _I, _P, _P, _P, _I, _I, _P],
    "sp_scatter_block_update": [_P, _P, _I] + [_P] * 7 + [_L, _I, _I, _P],
    "sp_range_rows": [],
    "sp_fused_shotgun_rounds": [_P, _P, _I, _I] + [_P] * 21
                               + [_L, _L, _I, _I, _I, _P],
    "sp_fused_shotgun_delta_rounds": [_P, _P, _I, _I] + [_P] * 16
                                     + [_L, _L, _I, _I, _I, _P],
    "sp_fused_shotgun_rounds_ovf": [_P, _P, _I, _I] + [_P] * 21
                                   + [_L, _L, _I, _I, _I] + [_P] * 10
                                   + [_I, _P],
    "sp_fused_grid_blocks": [_I, _I],
    "sp_batched_fused_shotgun_rounds": [_P, _P, _I, _I, _L] + [_P] * 21
                                       + [_L, _L, _I, _I, _I, _I, _P],
    "sp_batched_grid_blocks": [_I, _I],
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


def _run_all(cmds) -> list[tuple[list[str], int, str]]:
    """Start every command at once; wait for all; (cmd, rc, output)."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    return [(c, p.wait(), p.stdout.read()) for c, p in procs]


def report_path(lib: pathlib.Path) -> pathlib.Path:
    """The compilers' report kept beside the library ``lib``: the same
    name and digest, ``.ptxas.txt`` in place of ``.so``."""
    return lib.with_suffix(".ptxas.txt")


def compile_library(csrc: pathlib.Path, target: pathlib.Path) -> str:
    """Compile the sources of ``csrc`` with this module's flags (one nvcc
    per source, all started together) and link them into ``target``
    (written atomically, after its ``report_path``); return the compilers'
    output (the -Xptxas -v report); raise when a step fails."""
    tag = f"{target.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [target.parent / f"{pathlib.Path(s).stem}-{tag}.o"
            for s in SOURCES]
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(csrc / s)]
                        for s, o in zip(SOURCES, objs)])
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                              str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink(missing_ok=True)
    for cmd, rc, out in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    report = "".join(out for _, _, out in results)
    # atomic renames, the report first: a concurrent build never sees half
    # a file, nor a library without its report
    tmp_report = report_path(target).with_suffix(f".{os.getpid()}.tmp")
    tmp_report.write_text(report)
    os.replace(tmp_report, report_path(target))
    os.replace(tmp, target)
    return report


def build() -> pathlib.Path:
    """Compile the sources into the build directory (if not there yet) and
    return the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"librepro_torch-{_digest()}.so"
    if target.exists() and report_path(target).exists():
        build_info["seconds"] = 0.0
        build_info["ptxas"] = report_path(target).read_text()
        return target
    t0 = time.perf_counter()
    build_info["ptxas"] = compile_library(CSRC, target)
    build_info["seconds"] = time.perf_counter() - t0
    return target


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use; raises when its
    scatters' range width is not ``data/sparse.py::RANGE_ROWS`` (the
    range-start table would not fit them)."""
    global _lib
    if _lib is None:
        from repro_torch.data.sparse import RANGE_ROWS
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        if lib.sp_range_rows() != RANGE_ROWS:
            raise RuntimeError(f"the scatter kernels take ranges of "
                               f"{lib.sp_range_rows()} rows, the range-start "
                               f"table {RANGE_ROWS}")
        _lib = lib
    return _lib
