"""K1: the whole-plane NTT as a CUDA kernel, with its plain torch twin.

Counterpart of ``toy_heaan_ckks_tpu/ops/ntt_pallas.py`` (``_ntt_kernel``,
``_ntt_planes_call``, ``ntt_pallas``). The kernel is ``csrc/ntt.cu``; the
twin is ``ops/ntt.py``'s int64 transform. ``ntt_planes`` sends a CPU tensor
to the twin and launches the kernel for a CUDA tensor — there is no
fallback from one to the other. One entry point serves the forward
transform, the inverse (final factor N^{-1}) and the inverse with folded
per-channel final constants (``small_fast.inv_ntt_fold``,
``moddown_gpu.inv_ntt_to_yhat``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .modular import u32_table
from .ntt import NttTables, compact_twiddles, forward_ntt, inverse_ntt

MAX_LOG_N = 15  # one plane in shared memory: 128 KiB at 2^15


@dataclasses.dataclass(frozen=True, eq=False)
class KernelTables:
    """Compact twiddles of one chain for the kernels: plain values and
    Shoup companions floor(w * 2^32 / q), int32 bit-views (L, N)."""

    q: torch.Tensor
    fwd: torch.Tensor
    fwd_shoup: torch.Tensor
    inv: torch.Tensor
    inv_shoup: torch.Tensor


def shoup(w: np.ndarray, q: np.ndarray) -> np.ndarray:
    """floor(w * 2^32 / q) for w < q < 2^31 (uint64 arithmetic is exact)."""
    return (np.asarray(w, np.uint64) << np.uint64(32)) // np.asarray(q, np.uint64)


@functools.lru_cache(maxsize=64)
def kernel_tables(moduli: tuple, degree: int, device: torch.device) -> KernelTables:
    fwd, inv = compact_twiddles(moduli, degree)
    q = np.array(moduli, np.uint64)[:, None]

    def dev(a):
        return u32_table(a).to(device)

    return KernelTables(
        q=dev(np.array(moduli, np.uint64)),
        fwd=dev(fwd), fwd_shoup=dev(shoup(fwd, q)),
        inv=dev(inv), inv_shoup=dev(shoup(inv, q)),
    )


@functools.lru_cache(maxsize=256)
def final_consts(moduli: tuple, final: tuple, device: torch.device):
    """Per-channel final factors as (int64 (L, 1) for the twin, int32
    values and Shoup companions (L,) for the kernel)."""
    vals = np.array([f % q for f, q in zip(final, moduli)], np.uint64)
    col = torch.tensor(vals.astype(np.int64), device=device)[:, None]
    fp = shoup(vals, np.array(moduli, np.uint64))
    return col, u32_table(vals).to(device), u32_table(fp).to(device)


def ntt_twin(x, moduli: tuple, degree: int, inverse: bool, final=None):
    """Plain int64 torch version of the kernel on any device."""
    moduli = tuple(int(m) for m in moduli)
    tabs = NttTables.build(moduli, degree, x.device)
    if not inverse:
        return forward_ntt(x, tabs)
    fin = None if final is None else final_consts(moduli, final, x.device)[0]
    return inverse_ntt(x, tabs, fin)


def ntt_planes(x: torch.Tensor, moduli, degree: int, inverse: bool,
               final: tuple | None = None) -> torch.Tensor:
    """NTT of int32 (..., L, N) planes over ``moduli``.

    ``final``: per-channel plain factors applied after the inverse
    butterflies (default N^{-1} mod q). Output canonical, contiguous."""
    moduli = tuple(int(m) for m in moduli)
    if final is not None and not inverse:
        raise ValueError("ntt_planes: a final factor needs inverse=True")
    if inverse and final is None:
        final = tuple(pow(degree, -1, q) for q in moduli)
    if x.device.type == "cpu":
        return ntt_twin(x, moduli, degree, inverse, final)
    log_n = degree.bit_length() - 1
    if degree != 1 << log_n or not 2 <= log_n <= MAX_LOG_N:
        raise ValueError(f"ntt_planes: N = {degree} outside [4, 2^{MAX_LOG_N}]")
    L = len(moduli)
    x3 = _build.planes(x, L, degree)
    _build.require_cuda("ntt_planes", x3)
    lib = _build.library()
    kt = kernel_tables(moduli, degree, x.device)
    fin = finp = None
    if inverse:
        _, fin, finp = final_consts(moduli, final, x.device)
    out = torch.empty((x3.shape[0], L, degree), dtype=torch.int32, device=x.device)
    if out.numel():
        tw, twp = (kt.inv, kt.inv_shoup) if inverse else (kt.fwd, kt.fwd_shoup)
        p = _build.ptr
        rc = lib.ckks_ntt(
            p(x3), x3.stride(0), p(out), p(tw), p(twp), p(kt.q), p(fin),
            p(finp), x3.shape[0], L, log_n, int(inverse),
            _build.stream(x.device),
        )
        _build.check(rc, "ntt_planes")
        ntt_planes.launches += 1
    return out.reshape(x.shape)


ntt_planes.launches = 0
