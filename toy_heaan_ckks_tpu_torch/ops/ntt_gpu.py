"""K1 and K5+K7: the whole-plane NTT as CUDA kernels, with the torch twin.

Counterpart of ``toy_heaan_ckks_tpu/ops/ntt_pallas.py`` (``_ntt_kernel``,
``_ntt_planes_call``, ``ntt_pallas``) for small chains and of
``ops/ntt_pallas_wide.py`` (``_ntt_kernel_wide``, ``ntt_pallas_wide``) plus
``ops/keyswitch_pallas_wide.py`` (``_inv_yhat_kernel_wide``,
``_inv_fold_call_wide``) for wide ones. The kernels are ``csrc/ntt.cu``:
``ckks_ntt`` on uint32 words (K1) and ``ckks_ntt64`` on uint64 words (K5,
and K7 when a folded final constant is given); the twin is ``ops/ntt.py``'s
int64 transform. ``ntt_planes`` takes int32 planes (small chains, Shoup
radix 2^32), ``ntt_planes_wide`` int64 planes (wide chains, radix 2^64).
Each sends a CPU tensor to the twin and launches its kernel for a CUDA
tensor — there is no fallback from one to the other. One entry point
serves the forward transform, the inverse (final factor N^{-1}) and the
inverse with folded per-channel final constants (``small_fast.inv_ntt_fold``,
``moddown_gpu.inv_ntt_to_yhat`` and their wide counterparts).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .modular import shoup, word_table
from .ntt import NttTables, compact_twiddles, forward_ntt, inverse_ntt

MAX_LOG_N = 15  # one uint32 plane in shared memory: 128 KiB at 2^15
MAX_LOG_N_WIDE = 14  # one uint64 plane: 128 KiB at 2^14


@dataclasses.dataclass(frozen=True, eq=False)
class KernelTables:
    """Compact twiddles of one chain for the kernels: plain values and
    Shoup companions floor(w * 2^bits / q), as word tables (L, N) (int32
    bits for radix 32, int64 bits for radix 64)."""

    q: torch.Tensor
    fwd: torch.Tensor
    fwd_shoup: torch.Tensor
    inv: torch.Tensor
    inv_shoup: torch.Tensor


@functools.lru_cache(maxsize=64)
def kernel_tables(moduli: tuple, degree: int, device: torch.device,
                  radix_bits: int) -> KernelTables:
    fwd, inv = compact_twiddles(moduli, degree)
    q = np.array(moduli, np.uint64)[:, None]

    def dev(a):
        return word_table(a, radix_bits).to(device)

    return KernelTables(
        q=dev(np.array(moduli, np.uint64)),
        fwd=dev(fwd), fwd_shoup=dev(shoup(fwd, q, radix_bits)),
        inv=dev(inv), inv_shoup=dev(shoup(inv, q, radix_bits)),
    )


@functools.lru_cache(maxsize=256)
def final_consts(moduli: tuple, final: tuple, device: torch.device,
                 radix_bits: int):
    """Per-channel final factors for the kernel: word-table values and
    Shoup companions (L,)."""
    vals = np.array([f % q for f, q in zip(final, moduli)], np.uint64)
    fp = shoup(vals, np.array(moduli, np.uint64), radix_bits)
    return word_table(vals, radix_bits).to(device), word_table(fp, radix_bits).to(device)


def ntt_twin(x, moduli: tuple, degree: int, inverse: bool, final=None):
    """Plain int64 torch version of the kernels on any device (small or
    wide arithmetic by x's dtype)."""
    moduli = tuple(int(m) for m in moduli)
    tabs = NttTables.build(moduli, degree, x.device)
    if not inverse:
        return forward_ntt(x, tabs)
    fin = None if final is None else torch.tensor(
        [f % q for f, q in zip(final, moduli)], dtype=torch.int64,
        device=x.device)[:, None]
    return inverse_ntt(x, tabs, fin)


def _ntt(x: torch.Tensor, moduli, degree: int, inverse: bool,
         final: tuple | None, wide: bool):
    """Shared body of the two entry points; returns (out, launched)."""
    moduli = tuple(int(m) for m in moduli)
    if final is not None and not inverse:
        raise ValueError("ntt_planes: a final factor needs inverse=True")
    if inverse and final is None:
        final = tuple(pow(degree, -1, q) for q in moduli)
    dtype, rbits, max_log_n = ((torch.int64, 64, MAX_LOG_N_WIDE) if wide
                               else (torch.int32, 32, MAX_LOG_N))
    log_n = degree.bit_length() - 1
    if wide and log_n > MAX_LOG_N_WIDE:
        raise NotImplementedError(
            f"wide NTT at N = {degree}: N > 2^{MAX_LOG_N_WIDE} needs the "
            "factored-twiddle kernel, which is not ported yet"
        )
    if x.device.type == "cpu":
        _build.require_dtype("ntt_planes", dtype, x)
        return ntt_twin(x, moduli, degree, inverse, final), False
    if degree != 1 << log_n or not 2 <= log_n <= max_log_n:
        raise ValueError(f"ntt_planes: N = {degree} outside [4, 2^{max_log_n}]")
    L = len(moduli)
    x3 = _build.planes(x, L, degree)
    _build.require_cuda("ntt_planes", dtype, x3)
    lib = _build.library()
    kt = kernel_tables(moduli, degree, x.device, rbits)
    fin = finp = None
    if inverse:
        fin, finp = final_consts(moduli, final, x.device, rbits)
    out = torch.empty((x3.shape[0], L, degree), dtype=dtype, device=x.device)
    launched = bool(out.numel())
    if launched:
        tw, twp = (kt.inv, kt.inv_shoup) if inverse else (kt.fwd, kt.fwd_shoup)
        p = _build.ptr
        entry = lib.ckks_ntt64 if wide else lib.ckks_ntt
        rc = entry(
            p(x3), x3.stride(0), p(out), p(tw), p(twp), p(kt.q), p(fin),
            p(finp), x3.shape[0], L, log_n, int(inverse),
            _build.stream(x.device),
        )
        _build.check(rc, "ntt_planes")
    return out.reshape(x.shape), launched


def ntt_planes(x: torch.Tensor, moduli, degree: int, inverse: bool,
               final: tuple | None = None) -> torch.Tensor:
    """K1: NTT of int32 (..., L, N) planes of a small chain over ``moduli``.

    ``final``: per-channel plain factors applied after the inverse
    butterflies (default N^{-1} mod q). Output canonical, contiguous."""
    out, launched = _ntt(x, moduli, degree, inverse, final, wide=False)
    ntt_planes.launches += launched
    return out


def ntt_planes_wide(x: torch.Tensor, moduli, degree: int, inverse: bool,
                    final: tuple | None = None) -> torch.Tensor:
    """K5 (forward, inverse) and K7 (inverse with a folded ``final``): NTT
    of int64 (..., L, N) planes of a wide chain (any q < 2^63), N <= 2^14."""
    out, launched = _ntt(x, moduli, degree, inverse, final, wide=True)
    ntt_planes_wide.launches += launched
    return out


ntt_planes.launches = 0
ntt_planes_wide.launches = 0
