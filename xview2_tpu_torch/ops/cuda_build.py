"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``; nothing includes PyTorch's headers, so
a build takes seconds.  Libraries go to ``xview2_tpu_torch/_build/`` (listed
in ``.gitignore``), named by a hash of the sources and flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is.  Nothing is
compiled at import: :func:`library` builds on first use, and
:func:`build_all` builds every kernel at once, one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SOURCES = ("relayout", "fused_conv", "fused_conv_bwd", "fused_head", "rowshift",
           "small_conv", "norm_act")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-lineinfo")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], Tuple[ctypes._CFuncPtr, tuple]] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(PATH, CUDA_HOME or /usr/local/cuda)")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp_path, final_path),
    or None when the library is already built."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, path = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, path)  # atomic: a reader never sees a half-written library


def build_all() -> float:
    """Build every kernel library that is not built yet, all nvcc processes
    in parallel.  Returns the wall seconds it took."""
    t0 = time.perf_counter()
    started = {name: _start_build(name) for name in SOURCES}
    try:
        for name, st in started.items():
            _finish_build(name, st)
    finally:
        for st in started.values():  # never leave a compiler running
            if st is not None and st[0].poll() is None:
                st[0].kill()
                st[0].wait()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of ``csrc/{name}.cu`` with its argument
    types declared; every entry point returns a cudaError_t as int.

    The bound entry point is kept per ``(name, symbol)``: the symbol is
    looked up and its ``argtypes`` set once, on the first call.  A later
    call that declares other ``argtypes`` raises ``ValueError``."""
    key = (name, symbol)
    hit = _FUNCS.get(key)
    if hit is not None:
        if hit[1] is not argtypes and hit[1] != tuple(argtypes):
            raise ValueError(f"{symbol} of csrc/{name}.cu was bound with argtypes {hit[1]}, "
                             f"not {tuple(argtypes)}")
        return hit[0]
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _FUNCS[key] = (fn, tuple(argtypes))
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
