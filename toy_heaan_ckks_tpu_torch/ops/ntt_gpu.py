"""K1/K4 and K5+K7/K5': the whole-plane NTT as CUDA kernels, with the twin.

Counterpart of ``toy_heaan_ckks_tpu/ops/ntt_pallas.py`` (``_ntt_kernel``,
``_ntt_kernel_fac``, ``_ntt_planes_call``, ``ntt_pallas``) for small
chains and of ``ops/ntt_pallas_wide.py`` (``_ntt_kernel_wide``,
``_ntt_kernel_fac_wide``, ``ntt_pallas_wide``) plus
``ops/keyswitch_pallas_wide.py`` (``_inv_yhat_kernel_wide``,
``_inv_fold_call_wide``) for wide ones. The kernels are ``csrc/ntt.cu``:
``ckks_ntt`` on uint32 words (K1; K4 at N = 2^16) and ``ckks_ntt64`` on
uint64 words (K5, K5' at N >= 2^15, and K7 when a folded final constant
is given); the twin is ``ops/ntt.py``'s int64 transform. Every kernel
holds a plane on chip: uint32 planes on one block up to 128 KiB and a
thread-block cluster above, uint64 planes on a cluster from N = 2^13 on
(each wrapper counts those launches in ``launches_cluster``, by the form
that ``launch_blocks`` reports): the cluster of
``csrc/ntt_cluster.cuh``, blocks of register passes a plane, for K4 on
uint32 planes at N = 2^16 (16 blocks) and for K5 / K5' / K7 on uint64
planes at N = 2^13 .. 2^16 (``WidePlan``'s C: 16 at 2^15 and 2^16). ``ntt_planes`` takes int32 planes (small chains, Shoup
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
from .ntt import NttTables, forward_ntt, inverse_ntt, prime_twiddles

MAX_LOG_N = 16  # the largest ring of the kernels, for both word sizes
SLICE_BYTES = 128 << 10  # the most of a plane one block holds


def plane_split(degree: int, wide: bool) -> tuple[int, int]:
    """(log2 N, P) for the kernels on a ring of ``degree``: P = 1 where one
    block holds a plane (up to 128 KiB: uint32 N <= 2^15, uint64 N <=
    2^14), else plane bytes / 128 KiB (2 or 4), and the kernels then run
    the cluster of ``csrc/ntt_cluster.cuh`` (16 blocks a plane) whatever P
    says. At P = 1 uint32 planes of 2^10 .. 2^15 run one block of register
    passes (K1, K2, K3) and uint32 planes below 2^10 and uint64 planes up
    to 2^12 the one-block templates; uint64 planes of 2^13 and 2^14 run
    on a cluster of ``WidePlan``'s C blocks, whatever P says (K5 / K7, K6
    and K8 / K8', each on its own C; ``launch_blocks`` reports the form
    an entry launches). K10 picks its own form per launch
    (``coeff_ntt_gpu.slab_form``). Raises unless N is a power of two in
    [4, 2^16], on every device."""
    log_n = degree.bit_length() - 1
    if degree != 1 << log_n or not 2 <= log_n <= MAX_LOG_N:
        raise ValueError(
            f"N = {degree}: the kernels take powers of two in [4, 2^{MAX_LOG_N}]")
    plane = (8 if wide else 4) << log_n
    return log_n, max(1, plane // SLICE_BYTES)


# the kernel forms of ``launch_blocks`` (csrc/ntt_cluster.cuh WideForm)
FORWARD, INVERSE, KEY_SWITCH, MOD_DOWN = range(4)


@functools.lru_cache(maxsize=None)
def launch_blocks(form: int, wide: bool, log_n: int, parts: int) -> int:
    """Blocks a plane of the form that the entry of ``form`` (FORWARD,
    INVERSE, KEY_SWITCH, MOD_DOWN) launches on uint64 (``wide``) or
    uint32 planes of 2^log_n at ``plane_split``'s P: above 1 a cluster, 1
    one block a plane, 0 refused (``ckks_plane_blocks``, the predicate
    the entries route by). Needs the built library."""
    return _build.library().ckks_plane_blocks(form, int(wide), log_n, parts)


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


@functools.lru_cache(maxsize=1024)
def _prime_rows(q: int, degree: int, device: torch.device,
                radix_bits: int) -> tuple[torch.Tensor, ...]:
    """One prime's word rows (N,) on ``device``: forward and inverse
    twiddles and their Shoup companions, cached per prime like
    ``prime_twiddles``, so the chains of every level and digit share them."""
    fwd, inv = prime_twiddles(q, degree)
    return tuple(word_table(a, radix_bits).to(device) for a in (
        fwd, shoup(fwd, q, radix_bits), inv, shoup(inv, q, radix_bits)))


@functools.lru_cache(maxsize=64)
def kernel_tables(moduli: tuple, degree: int, device: torch.device,
                  radix_bits: int) -> KernelTables:
    rows = [_prime_rows(q, degree, device, radix_bits) for q in moduli]
    fwd, fwd_shoup, inv, inv_shoup = (torch.stack([r[i] for r in rows])
                                      for i in range(4))
    return KernelTables(
        q=word_table(np.array(moduli, np.uint64), radix_bits).to(device),
        fwd=fwd, fwd_shoup=fwd_shoup, inv=inv, inv_shoup=inv_shoup,
    )


@functools.lru_cache(maxsize=256)
def final_consts(moduli: tuple, final: tuple, device: torch.device,
                 radix_bits: int):
    """Per-channel final factors for the kernel: word-table values and
    Shoup companions (L,)."""
    vals = np.array([f % q for f, q in zip(final, moduli)], np.uint64)
    fp = shoup(vals, np.array(moduli, np.uint64), radix_bits)
    return word_table(vals, radix_bits).to(device), word_table(fp, radix_bits).to(device)


def vector_aligned(x3: torch.Tensor) -> torch.Tensor:
    """``x3`` (items, channels, N), or a contiguous copy where its first
    word or its item stride would break the 16-byte vector loads of the
    register-pass inverses (``csrc/ntt_reg.cuh`` ``load_runs``: the uint32
    one-block and cluster forms, the uint64 cluster forms of 2^13 and
    up)."""
    if x3.data_ptr() % 16 or x3.stride(0) * x3.element_size() % 16:
        return x3.clone(memory_format=torch.contiguous_format)
    return x3


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
    """Shared body of the two entry points; returns (out, blocks): the
    blocks per plane of the form launched (``launch_blocks``), 0 where
    nothing was launched."""
    moduli = tuple(int(m) for m in moduli)
    if final is not None and not inverse:
        raise ValueError("ntt_planes: a final factor needs inverse=True")
    if inverse and final is None:
        final = tuple(pow(degree, -1, q) for q in moduli)
    dtype, rbits = (torch.int64, 64) if wide else (torch.int32, 32)
    log_n, parts = plane_split(degree, wide)
    if x.device.type == "cpu":
        _build.require_dtype("ntt_planes", dtype, x)
        return ntt_twin(x, moduli, degree, inverse, final), 0
    L = len(moduli)
    x3 = _build.planes(x, L, degree)
    _build.require_cuda("ntt_planes", dtype, x3)
    blocks = launch_blocks(INVERSE if inverse else FORWARD, wide, log_n, parts)
    # the uint32 inverses and the uint64 cluster inverses load 16-byte runs
    if inverse and (not wide or blocks > 1):
        x3 = vector_aligned(x3)
    lib = _build.library()
    kt = kernel_tables(moduli, degree, x.device, rbits)
    fin = finp = None
    if inverse:
        fin, finp = final_consts(moduli, final, x.device, rbits)
    out = torch.empty((x3.shape[0], L, degree), dtype=dtype, device=x.device)
    if not out.numel():
        return out.reshape(x.shape), 0
    tw, twp = (kt.inv, kt.inv_shoup) if inverse else (kt.fwd, kt.fwd_shoup)
    p = _build.ptr
    entry = lib.ckks_ntt64 if wide else lib.ckks_ntt
    rc = entry(
        p(x3), x3.stride(0), p(out), p(tw), p(twp), p(kt.q), p(fin),
        p(finp), x3.shape[0], L, log_n, parts, int(inverse),
        _build.stream(x.device),
    )
    _build.check(rc, "ntt_planes")
    return out.reshape(x.shape), blocks


def count_launch(fn, blocks: int) -> None:
    """Add a launch of ``blocks`` blocks per plane (0: none) to ``fn``'s
    counters: ``launches`` every launch, ``launches_cluster`` those on a
    thread-block cluster (above 1)."""
    fn.launches += blocks > 0
    fn.launches_cluster += blocks > 1


def ntt_planes(x: torch.Tensor, moduli, degree: int, inverse: bool,
               final: tuple | None = None) -> torch.Tensor:
    """K1 (N <= 2^15) / K4 (N = 2^16, a cluster of 16 blocks per plane): NTT
    of int32 (..., L, N) planes of a small chain over ``moduli``.

    ``final``: per-channel plain factors applied after the inverse
    butterflies (default N^{-1} mod q). Output canonical, contiguous."""
    out, blocks = _ntt(x, moduli, degree, inverse, final, wide=False)
    count_launch(ntt_planes, blocks)
    return out


def ntt_planes_wide(x: torch.Tensor, moduli, degree: int, inverse: bool,
                    final: tuple | None = None) -> torch.Tensor:
    """K5 (forward, inverse; K5' at N >= 2^15) and K7 (inverse with a
    folded ``final``): NTT of int64 (..., L, N) planes of a wide chain
    (any q < 2^63), N <= 2^16; at 2^13 .. 2^16 on a cluster of blocks of
    register passes per plane (``csrc/ntt_cluster.cuh`` ``WidePlan``:
    16 blocks at 2^15 and 2^16, ``kWideNttLogCluster13`` / ``14`` below),
    counted in ``launches_cluster``."""
    out, blocks = _ntt(x, moduli, degree, inverse, final, wide=True)
    count_launch(ntt_planes_wide, blocks)
    return out


ntt_planes.launches = ntt_planes.launches_cluster = 0
ntt_planes_wide.launches = ntt_planes_wide.launches_cluster = 0
