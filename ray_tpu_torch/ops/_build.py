"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled on first use by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, then
loaded with ``ctypes``. Pointers and the stream are passed as
``c_void_p``; every entry point returns ``cudaGetLastError()`` (or the
error of encoding a TMA tensor map), and ``check`` raises on a non-zero
code. The bf16 kernels K2, K3 and K4 encode their tensor maps with
``cuTensorMapEncodeTiled``, reached through ``cudaGetDriverEntryPoint``,
so no library links ``-lcuda``. Libraries go to ``_build/`` beside
this package (listed in ``.gitignore``) and are rebuilt when a source or
header is newer than the library. ``build_all`` starts one ``nvcc`` per
source at once and returns each one's ``-Xptxas -v`` report.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
SOURCES = {"paged_decode": "paged_decode.cu", "flash_fwd": "flash_fwd.cu",
           "flash_bwd": "flash_bwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)
# argtypes of each library's C entry points (see the sources' extern "C"
# functions); every one returns int
SIGNATURES = {
    "paged_decode": {
        "paged_decode": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _F, _P],
        "paged_decode_splits": [_I, _I],
        "paged_decode_supports": [_I, _I],
    },
    "flash_fwd": {
        "flash_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _S, _I, _F, _P],
        "flash_fwd_decode": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _I, _S, _I, _F, _I, _I, _P],
    },
    "flash_bwd": {
        "flash_bwd_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _S, _I, _F, _P],
        "flash_bwd_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _S, _I, _F, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    deps = [SOURCES[name], "common.cuh", "hopper.cuh"]
    return any(os.path.getmtime(os.path.join(_CSRC, f)) > built for f in deps)


def build_all(names=None, force: bool = False) -> Dict[str, str]:
    """Compile the named kernels (default: all) in parallel; returns each
    one's compiler report. Raises with the compiler's output on failure."""
    names = list(names or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports = {name: "up to date" for name in names if name not in procs}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(name: str, code: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {code}")
