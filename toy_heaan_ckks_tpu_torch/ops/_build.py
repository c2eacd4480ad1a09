"""Build and load the CUDA kernels (K1 NTT, K2 key switch, K3 mod-down).

The sources in ``toy_heaan_ckks_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, keyed by a hash of the sources, under
``toy_heaan_ckks_tpu_torch/build/``, and loaded with ctypes. Nothing is
built when the package is imported, so the CPU-only tests never need
``nvcc``. Every C entry returns ``cudaGetLastError()`` of its launch;
``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("ntt.cuh", "ntt.cu", "keyswitch.cu", "moddown.cu")
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

_SIGNATURES = {
    # x, x_stride, out, tw, twp, q, fin, finp, outer, channels, log_n,
    # inverse, stream
    "ckks_ntt": [_P, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # y, y_stride, d, d_stride, key_a, key_b, c, cs, q, qinv, tw, twp,
    # out0, out1, outer, base, ext, digits, digit_size, log_n, stream
    "ckks_keyswitch": [_P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm, pms, pinv,
    # pinvs, tw, twp, out, outer, dropped, kept, log_n, stream
    "ckks_moddown": [_P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    return BUILD / f"libckks_kernels_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    so = library_path()
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
            *[str(CSRC / s) for s in SOURCES if s.endswith(".cu")],
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-6000:]}"
            )
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.ckks_error_string.argtypes = [_I]
    lib.ckks_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().ckks_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel inputs: int32 tensors on one CUDA device (a CPU tensor never
    reaches here — the wrappers send it to the plain torch version)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected CUDA")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")


def planes(x: torch.Tensor, channels: int, n: int) -> torch.Tensor:
    """(..., channels, N) -> a 3-D (items, channels, N) view whose channel
    and coefficient strides are (N, 1); only the item stride may differ."""
    if x.shape[-2:] != (channels, n):
        raise ValueError(f"expected (..., {channels}, {n}), got {tuple(x.shape)}")
    x3 = x.reshape(-1, channels, n)
    if x3.stride(-1) != 1 or (channels > 1 and x3.stride(-2) != n):
        x3 = x3.contiguous()
    return x3
