"""ctypes binding of the native (C++) threaded PNG/JPEG decoder (port of
``xview2_tpu/data/native.py``).

``csrc/decoder.cpp`` decodes a batch of files in a pthread pool, with the GIL
released, straight into one preallocated numpy block.  It is built at first
use by ``g++ -O3 -shared -fPIC ... -lpng -ljpeg -lpthread`` into
``xview2_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags as ``ops/cuda_build.py`` names the kernels (no
``-march=native``: the build directory may be shared between machines).
Where it cannot be built or loaded (no ``g++``, no libpng or libjpeg
headers, a failed build, a library built on a machine whose shared libraries
this one lacks) :func:`is_available` is False, :func:`status` says why, and
the loader decodes with PIL, as the JAX package's does.  The decoder runs on
the host; it is no device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                      "decoder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SOURCE)), "_build")
FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lpng", "-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None  # why there is no library, once a build or load failed


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libxv2native-{h.hexdigest()[:16]}.so")


def _build(path: str) -> Optional[str]:
    """Compile the library to ``path``; returns None, or why it failed."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return "no g++ on PATH"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE, *LIBS], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        missing = [h for h in ("png.h", "jpeglib.h") if f"{h}: No such file" in proc.stderr]
        if missing:
            return f"the libpng/libjpeg headers are missing ({', '.join(missing)})"
        last = (proc.stderr.strip().splitlines() or ["no output"])[-1]
        return f"g++ failed (exit {proc.returncode}): {last}"
    os.replace(tmp, path)  # atomic: another process never loads half a library
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _reason
    if _lib is not None or _reason is not None:
        return _lib
    path = _lib_path()
    if not os.path.exists(path):
        _reason = _build(path)
        if _reason is not None:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:  # built on another machine, whose libpng/libjpeg this one lacks
        _reason = f"the built library does not load: {e}"
        return None
    lib.xv2_decode_image.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.xv2_decode_image.restype = ctypes.c_int
    lib.xv2_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.xv2_decode_batch.restype = ctypes.c_int
    lib.xv2_probe_png.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.xv2_probe_png.restype = ctypes.c_int
    _lib = lib
    return lib


def is_available() -> bool:
    """Whether the library is built (building it on first call)."""
    return _load() is not None


def status() -> str:
    """Which decoder the loader uses, and why: one line for the logs."""
    if _load() is not None:
        return f"native (csrc/decoder.cpp, {os.path.basename(_lib_path())})"
    return f"PIL: the native decoder is not available ({_reason})"


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder not available: {_reason}")
    return lib


def probe_png(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG from its header."""
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _need().xv2_probe_png(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"probe failed ({rc}) for {path}")
    return h.value, w.value


def decode_image(path: str, h: int, w: int, c: int) -> np.ndarray:
    """One file into a (h, w, c) uint8 array."""
    out = np.empty((h, w, c), np.uint8)
    rc = _need().xv2_decode_image(path.encode(),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c)
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    return out


def decode_batch(paths: Sequence[str], h: int, w: int, c: int,
                 n_threads: int = 8) -> np.ndarray:
    """Decode ``paths`` concurrently into a (N, h, w, c) uint8 array."""
    lib = _need()
    n = len(paths)
    out = np.empty((n, h, w, c), np.uint8)
    results = (ctypes.c_int * n)()
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.xv2_decode_batch(arr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              n, h, w, c, n_threads, results)
    if rc != 0:
        bad = [paths[i] for i in range(n) if results[i] != 0]
        raise IOError(f"native decode failed ({rc}) for {bad[:3]}")
    return out
