"""ctypes bindings for the native C++ host runtime (``ckks_native.cpp``).

Counterpart of ``toy_heaan_ckks_tpu/native``. Compiled with g++ at first
use into ``toy_heaan_ckks_tpu_torch/build/`` (one shared object per source
hash, nothing written into the package) and loaded with ctypes. Every
entry point has a pure-Python fallback in ``math/`` with the same results,
so without a compiler, or with ``CKKS_DISABLE_NATIVE`` set, ``available()``
is False and the library still works.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "ckks_native.cpp"
BUILD = _SRC.parents[1] / "build"

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD / f"_ckks_native_{digest}.so"


def _compile() -> Path | None:
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("CKKS_DISABLE_NATIVE"):
            return None
        path = _compile()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        u64, i64 = ctypes.c_uint64, ctypes.c_int64
        p_u64, p_i64 = ctypes.POINTER(u64), ctypes.POINTER(i64)
        p_f64 = ctypes.POINTER(ctypes.c_double)
        lib.ckks_is_prime_u64.restype = ctypes.c_int
        lib.ckks_is_prime_u64.argtypes = [u64]
        lib.ckks_first_prime_up.restype = u64
        lib.ckks_first_prime_up.argtypes = [u64, u64]
        lib.ckks_first_prime_down.restype = u64
        lib.ckks_first_prime_down.argtypes = [u64, u64]
        lib.ckks_reduce_coeffs.restype = None
        lib.ckks_reduce_coeffs.argtypes = [p_i64, i64, p_u64, i64, p_u64]
        lib.ckks_crt_reconstruct.restype = ctypes.c_int
        lib.ckks_crt_reconstruct.argtypes = [p_u64, i64, p_u64, i64, i64, p_u64]
        lib.ckks_crt_to_double.restype = ctypes.c_int
        lib.ckks_crt_to_double.argtypes = [p_u64, i64, p_u64, i64, i64, ctypes.c_double,
                                           p_f64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def is_prime_u64(n: int) -> bool:
    return bool(_load().ckks_is_prime_u64(n))


def first_prime_up(start: int, two_n: int) -> int:
    """Smallest prime p >= ``start`` with p == 1 (mod two_n), stepping up
    from ``start`` (itself == 1 mod two_n); 0 on u64 overflow."""
    return int(_load().ckks_first_prime_up(start, two_n))


def first_prime_down(bound: int, two_n: int) -> int:
    """Largest prime p < bound with p == 1 (mod two_n); 0 if none."""
    return int(_load().ckks_first_prime_down(bound, two_n))


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def reduce_coeffs(coeffs, moduli) -> np.ndarray:
    """int64 coefficient array -> (L, N) uint64 non-negative residues."""
    c = np.ascontiguousarray(coeffs, dtype=np.int64)
    m = np.ascontiguousarray(moduli, dtype=np.uint64)
    out = np.empty((len(m), c.shape[-1]), dtype=np.uint64)
    _load().ckks_reduce_coeffs(_p(c, ctypes.c_int64), c.shape[-1],
                               _p(m, ctypes.c_uint64), len(m), _p(out, ctypes.c_uint64))
    return out


def _words_for(moduli) -> int:
    bits = sum(int(m).bit_length() for m in moduli) + 2 + len(moduli).bit_length()
    return (bits + 63) // 64 + 1


def crt_reconstruct_centered(residues, moduli) -> np.ndarray:
    """(L, N) uint64 residues -> N exact centered Python ints."""
    r = np.ascontiguousarray(residues, dtype=np.uint64)
    m = np.ascontiguousarray(moduli, dtype=np.uint64)
    L, n = r.shape
    W = _words_for(moduli)
    out = np.empty((n, W), dtype=np.uint64)
    rc = _load().ckks_crt_reconstruct(_p(r, ctypes.c_uint64), n, _p(m, ctypes.c_uint64), L,
                                      W, _p(out, ctypes.c_uint64))
    if rc != 0:
        raise RuntimeError("ckks_crt_reconstruct failed")
    raw = out.tobytes()  # row-major: n coefficients x W little-endian words
    stride = W * 8
    return np.array([int.from_bytes(raw[j * stride:(j + 1) * stride], "little", signed=True)
                     for j in range(n)], dtype=object)


def crt_to_double(residues, moduli, scale: float) -> np.ndarray:
    """(L, N) uint64 residues -> N float64 centered values / scale."""
    r = np.ascontiguousarray(residues, dtype=np.uint64)
    m = np.ascontiguousarray(moduli, dtype=np.uint64)
    L, n = r.shape
    out = np.empty(n, dtype=np.float64)
    rc = _load().ckks_crt_to_double(_p(r, ctypes.c_uint64), n, _p(m, ctypes.c_uint64), L,
                                    _words_for(moduli), ctypes.c_double(scale),
                                    _p(out, ctypes.c_double))
    if rc != 0:
        raise RuntimeError("ckks_crt_to_double failed")
    return out
