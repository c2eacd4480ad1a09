"""Build and load the CUDA kernels (K1/K4/K5+K7/K5' NTT, K2/K6 key switch,
K3/K8 mod-down, K9 matrix-product NTT, K10/K11 coefficient-sharded NTT).

The sources in ``toy_heaan_ckks_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for ``sm_90a`` — one ``nvcc -c`` per ``.cu`` file, all started
together, then one link — into one shared library with a plain C
interface, keyed by a hash of the sources, under
``toy_heaan_ckks_tpu_torch/build/``, and loaded with ctypes. Nothing is
built when the package is imported, so the CPU-only tests never need
``nvcc``. Every C entry returns its launch's error code (0 on success; a
cluster launch that cannot be resident returns its own code, 100001);
``check`` raises on a non-zero code. Each kernel has a uint32 entry (small
chains, int32 tensors) and a uint64 entry with the suffix ``64`` (wide
chains, int64 tensors) of the same signature; ``parts`` is the number of
blocks per plane (``ntt_gpu.plane_split``). K9 (``ckks_ntt_mxu``) takes
uint32 words only (``ckks_ntt_mxu_info`` reports the kernel it picks). K10 / K11 (``ckks_coeff_tail`` / ``ckks_coeff_cross``, and K11's
one-launch form ``ckks_coeff_cross_stages``) take host arrays of slab
pointers (``ptr_array``, ``int_array``), K10 also a cluster flag
(``coeff_ntt_gpu.slab_form``);
``ckks_enable_peer_access`` lets one card read another's memory.
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
SOURCES = ("ntt.cuh", "ntt_reg.cuh", "ntt_cluster.cuh", "coeff_ntt.cuh", "ntt.cu",
           "keyswitch.cu", "moddown.cu", "ntt_mxu.cu", "coeff_ntt.cu", "coeff_ntt64.cu")
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

_SIGNATURES = {
    # x, x_stride, out, tw, twp, q, fin, finp, outer, channels, log_n,
    # parts, inverse, stream
    "ckks_ntt": [_P, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # y, y_stride, d, d_stride, key_a, key_b, c, cs, q, qinv, tw, twp,
    # out0, out1, outer, base, ext, digits, digit_size, log_n, parts, stream
    "ckks_keyswitch": [_P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm, pms, pinv,
    # pinvs, tw, twp, out, outer, dropped, kept, log_n, parts, stream
    "ckks_moddown": [_P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # in, out, ids, count, shards, tw, twp, q, fin, finp, planes, channels,
    # log_n, log_s, cluster, inverse, stream
    "ckks_coeff_tail": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _P],
    # the same with the stage in place of cluster
    "ckks_coeff_cross": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _P],
    # in, out, shards, tw, twp, q, fin, finp, planes, channels, log_n,
    # log_s, inverse, stream
    "ckks_coeff_cross_stages": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
_SIGNATURES.update({f"{name}64": sig for name, sig in list(_SIGNATURES.items())})
# x, x_stride, out, w_first, w_second, t, t_shoup, rs, q, qinv, outer,
# channels, rows, inverse, stream
_SIGNATURES["ckks_ntt_mxu"] = [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _P]
# outer, channels, rows, inverse, int info[8] (csrc/ntt_mxu.cu: the kernel
# ckks_ntt_mxu launches)
_SIGNATURES["ckks_ntt_mxu_info"] = [_I, _I, _I, _I, _P]
_SIGNATURES["ckks_enable_peer_access"] = [_I, _I]
# kernel id, int info[6] (csrc/ntt_cluster.cuh cluster_info)
_SIGNATURES["ckks_cluster_info"] = [_I, _P]
# form, wide, log_n, parts: blocks a plane of the form an entry launches
# (csrc/ntt_cluster.cuh plane_blocks)
_SIGNATURES["ckks_plane_blocks"] = [_I, _I, _I, _I]
# wide, log_s, cluster, inverse, int info[6] (csrc/coeff_ntt.cuh tail_info)
_SIGNATURES["ckks_coeff_tail_info"] = [_I, _I, _I, _I, _P]


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


def _compile(sources: list[Path], out: Path) -> None:
    """``nvcc -c`` each source in parallel, then link the objects."""
    flags = ["-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objs = [out.with_name(f"{out.stem}.{src.stem}.o") for src in sources]
    procs = [
        subprocess.Popen(
            [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    for src, proc, log in zip(sources, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} ({proc.returncode}):\n{log[-6000:]}"
            )
    link = subprocess.run(
        [_nvcc(), *flags, "-shared", "-o", str(out), *map(str, objs)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({link.returncode}):\n{link.stderr[-6000:]}"
        )
    out.with_suffix(".log").write_text("".join(logs) + link.stdout + link.stderr)
    for obj in objs:
        obj.unlink()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    so = library_path()
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        _compile([CSRC / s for s in SOURCES if s.endswith(".cu")], tmp)
        tmp.with_suffix(".log").replace(so.with_suffix(".log"))
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


def ptr_array(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_dtype(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Residue planes of a small chain are int32, of a wide chain int64."""
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")


def require_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Kernel inputs: ``dtype`` tensors on one CUDA device (a CPU tensor
    never reaches here — the wrappers send it to the plain torch version)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected CUDA")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    require_dtype(name, dtype, *tensors)


def planes(x: torch.Tensor, channels: int, n: int) -> torch.Tensor:
    """(..., channels, N) -> a 3-D (items, channels, N) view whose channel
    and coefficient strides are (N, 1); only the item stride may differ."""
    if x.shape[-2:] != (channels, n):
        raise ValueError(f"expected (..., {channels}, {n}), got {tuple(x.shape)}")
    x3 = x.reshape(-1, channels, n)
    if x3.stride(-1) != 1 or (channels > 1 and x3.stride(-2) != n):
        x3 = x3.contiguous()
    return x3
