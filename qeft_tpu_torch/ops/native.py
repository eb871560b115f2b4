"""ctypes bindings of the host library ``csrc/qeft_host.cpp``: INT4 plane
packing and unpacking and the quantize-to-codes step in multi-threaded C++.
Counterpart of ``qeft_tpu/ops/native.py``, with its signatures.

The library is built at first use with ``native/Makefile``'s flags (``g++
-O3 -march=native -fPIC -shared -std=c++17 -pthread``; ``CXX`` names another
compiler) into ``build/native/<hash>/`` at the root of the checkout, then
loaded.  The hash covers the source, the compiler, the flags and what
``-march=native`` means on this host (`_host_id`), so a library built on
one CPU is never loaded on another, where it could die on an instruction
that CPU lacks.  A failed build raises with the compiler's
output: there is no NumPy fallback.  `available` says whether the library
is built or a compiler is there to build it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "qeft_host.cpp"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


@functools.lru_cache(maxsize=None)
def _host_id(cxx: str) -> str:
    """The target options ``-march=native`` enables on this host, as the
    compiler reports them (GCC's ``-Q --help=target``); where it cannot say,
    the machine's name, which only ever costs a rebuild."""
    try:
        proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True)
    except OSError:
        proc = None
    if proc is not None and proc.returncode == 0:
        return proc.stdout
    return f"{platform.machine()} {platform.node()}"


def library_path() -> Path:
    h = hashlib.sha256(" ".join((_cxx(),) + CXXFLAGS).encode())
    h.update(_host_id(_cxx()).encode())
    h.update(SOURCE.read_bytes())
    return SOURCE.parent.parent.parent / "build" / "native" / h.hexdigest()[:16] / \
        "libqeft_host.so"


def _build(so: Path) -> None:
    cxx = shutil.which(_cxx())
    if cxx is None:
        raise RuntimeError(f"no C++ compiler ({_cxx()!r}) to build {SOURCE}")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the host library failed:\n$ {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            i32p, f32p, long = (ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
                                ctypes.c_long)
            lib.qeft_pack_codes.argtypes = [i32p, i32p, long, long, long]
            lib.qeft_unpack_codes.argtypes = [i32p, i32p, long, long, long]
            lib.qeft_quantize_codes.argtypes = [f32p, f32p, f32p, i32p, long, long, long, long]
            for fn in (lib.qeft_pack_codes, lib.qeft_unpack_codes, lib.qeft_quantize_codes):
                fn.restype = None
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library is built, or a C++ compiler is there to build it."""
    return _lib is not None or library_path().exists() or shutil.which(_cxx()) is not None


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _check(k: int, n: int, group_size: int) -> int:
    g = group_size if group_size > 0 else k
    if g % 8 or k % g or n <= 0:
        raise ValueError(f"group size {group_size} does not tile K={k} in 8s (N={n})")
    return g


def pack_codes(codes: np.ndarray, group_size: int) -> np.ndarray:
    """[K, N] int32 codes (0..15) -> packed int32 [K/8, N]."""
    k, n = codes.shape
    _check(k, n, group_size)
    lib = _load()
    codes = np.ascontiguousarray(codes, np.int32)
    out = np.empty((k // 8, n), np.int32)
    lib.qeft_pack_codes(_i32p(codes), _i32p(out), k, n, group_size)
    return out


def unpack_codes(packed: np.ndarray, k: int, group_size: int) -> np.ndarray:
    """Packed int32 [K/8, N] -> codes [K, N]."""
    n = packed.shape[1]
    _check(k, n, group_size)
    if packed.shape[0] * 8 != k:
        raise ValueError(f"{packed.shape[0]} word rows do not hold K={k}")
    lib = _load()
    packed = np.ascontiguousarray(packed, np.int32)
    out = np.empty((k, n), np.int32)
    lib.qeft_unpack_codes(_i32p(packed), _i32p(out), k, n, group_size)
    return out


def quantize_codes(w_kn: np.ndarray, scales_gn: np.ndarray, zeros_gn: np.ndarray,
                   group_size: int, n_outlier: int) -> np.ndarray:
    """Codes ``clip(round(w / s + z), 0, 15)`` of ``w_kn`` [K, N] under the
    group scales and zero points [G, N] (halves rounded away from zero), the
    last ``n_outlier`` rows set to their zero point."""
    k, n = w_kn.shape
    g = _check(k, n, group_size)
    for name, a in (("scales_gn", scales_gn), ("zeros_gn", zeros_gn)):
        if a.shape != (k // g, n):
            raise ValueError(f"{name} is {a.shape}, expected {(k // g, n)}")
    lib = _load()
    w = np.ascontiguousarray(w_kn, np.float32)
    s = np.ascontiguousarray(scales_gn, np.float32)
    z = np.ascontiguousarray(zeros_gn, np.float32)
    out = np.empty((k, n), np.int32)
    lib.qeft_quantize_codes(_f32p(w), _f32p(s), _f32p(z), _i32p(out), k, n, group_size,
                            n_outlier)
    return out
