"""K3 / K8 (and K3' / K8' without t): fused RNS mod-down, kernel and twin.

Counterpart of ``toy_heaan_ckks_tpu/ops/moddown_pallas.py``
(``_down_consts``, ``inv_ntt_to_yhat``, ``_md_kernel_t`` /
``_md_kernel_no_t``, ``mod_down_combine_pallas``) for small chains, and of
``ops/keyswitch_pallas_wide.py`` (``_down_consts_wide``,
``_fold_consts_wide``, ``inv_ntt_to_yhat_wide``, ``inv_ntt_fold_wide``,
``_md_kernel_wide_t`` / ``_md_kernel_wide_no_t``,
``mod_down_combine_pallas_wide``) for wide ones. The fused multiply runs
the t form (K3, K8: relin + rescale, t scaled by the special product); a
key switch runs the t-less form (K3', K8': the division by P alone, the
child the whole base and the dropped moduli the specials).
Per kept channel j:

    ext_j  = sum_m  yhat_m * (Phat_m * R mod q_j)
    out_j  = ((t_j * t_scale if t) + ks_j - NTT(ext_j)) * P^{-1} mod q_j

``yhat`` (plain values of the dropped channels times (Phat_m)^{-1}) comes
from ``inv_ntt_to_yhat``: the inverse NTT (K1, or K7 on a wide chain) with
that factor folded into its final constant. The kernel is
``csrc/moddown.cu`` (``ckks_moddown`` on uint32 words with R = 2^32,
``ckks_moddown64`` on uint64 words with R = 2^64);
``mod_down_combine_twin`` is the plain int64 torch version of both. A CPU
tensor goes to the twin, a CUDA tensor to the kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .modular import arith, shoup, word_table
from .ntt import NttTables, forward_ntt
from .ntt_gpu import (
    MOD_DOWN, count_launch, kernel_tables, launch_blocks, ntt_planes, ntt_planes_wide,
    plane_split,
)


@functools.lru_cache(maxsize=128)
def _down_consts(child_moduli: tuple, dropped_moduli: tuple, degree: int,
                 t_scale: int = 0, radix_bits: int = 32):
    """Host tables, radix R = 2^bits: per (dropped m, kept j) extension
    weights c = Phat_m * R mod q_j with Shoup companions; per kept channel
    t_scale mod q_j and P^{-1} mod q_j with companions; and the inverse-NTT
    final constants N^{-1} * (Phat_m)^{-1} * R^{-1} mod p_m that emit yhat
    directly. ``t_scale`` multiplies the optional t term (0: no t term).
    Arrays are uint32 for radix 32, uint64 for radix 64."""
    p_total = 1
    for p in dropped_moduli:
        p_total *= p
    word = np.uint32 if radix_bits == 32 else np.uint64
    radix = 1 << radix_bits
    kept = np.array(child_moduli, dtype=object)
    c = np.array([[((p_total // pm) << radix_bits) % qj for qj in child_moduli]
                  for pm in dropped_moduli], dtype=object).reshape(
                      len(dropped_moduli), len(child_moduli))
    pmod = np.array([t_scale % qj for qj in child_moduli], dtype=object)
    pinv = np.array([pow(p_total % qj, -1, qj) for qj in child_moduli],
                    dtype=object)
    yfin = tuple(
        pow(degree, -1, pm) * pow((p_total // pm) % pm, -1, pm)
        * pow(radix, -1, pm) % pm
        for pm in dropped_moduli
    )
    return (c.astype(word), shoup(c, kept[None, :], radix_bits).astype(word),
            pmod.astype(word), shoup(pmod, kept, radix_bits).astype(word),
            pinv.astype(word), shoup(pinv, kept, radix_bits).astype(word),
            yfin)


def _down_consts_wide(child_moduli: tuple, dropped_moduli: tuple,
                      degree: int, t_scale: int = 0):
    """``_down_consts`` with R = 2^64 (the reference's
    ``_down_consts_wide``, as whole uint64 words)."""
    return _down_consts(child_moduli, dropped_moduli, degree, t_scale, 64)


@functools.lru_cache(maxsize=128)
def _fold_consts_wide(moduli: tuple, degree: int, post: tuple) -> tuple:
    """Folded inverse-NTT final constants N^{-1} * post_k * R^{-1} mod q_k
    with R = 2^64: one Harvey64 by them emits mont_mul(iNTT(x), post)."""
    return tuple(
        pow(degree, -1, q) * (p % q) * pow(1 << 64, -1, q) % q
        for q, p in zip(moduli, post)
    )


def inv_ntt_to_yhat(x_dropped, dropped_moduli: tuple, child_moduli: tuple,
                    degree: int):
    """Inverse NTT of the dropped channels emitting plain yhat directly
    (the (Phat_m)^{-1} multiply folded into K1's final constant).
    x: int32 (..., G, N) Montgomery NTT-domain planes."""
    yfin = _down_consts(tuple(child_moduli), tuple(dropped_moduli), degree)[6]
    return ntt_planes(x_dropped, dropped_moduli, degree, inverse=True, final=yfin)


def inv_ntt_to_yhat_wide(x_dropped, dropped_moduli: tuple, child_moduli: tuple,
                         degree: int):
    """``inv_ntt_to_yhat`` on int64 planes of a wide chain (K7)."""
    yfin = _down_consts_wide(tuple(child_moduli), tuple(dropped_moduli),
                             degree)[6]
    return ntt_planes_wide(x_dropped, dropped_moduli, degree, inverse=True,
                           final=yfin)


def inv_ntt_fold_wide(x, moduli: tuple, degree: int, post: tuple):
    """Wide inverse NTT with plain per-channel post-factors folded into the
    final constant: equals ``mont_mul(iNTT(x), post)`` (R = 2^64) in one
    K7 launch."""
    moduli = tuple(int(m) for m in moduli)
    final = _fold_consts_wide(moduli, degree, tuple(int(p) for p in post))
    return ntt_planes_wide(x, moduli, degree, inverse=True, final=final)


@dataclasses.dataclass(frozen=True, eq=False)
class _DeviceConsts:
    kernel: tuple  # c, cs, pmod, pmod_s, pinv, pinv_s as word tables
    c64: torch.Tensor  # int64 (G, L')
    pmod64: torch.Tensor  # int64 (L', 1)
    pinv64: torch.Tensor  # int64 (L', 1)


@functools.lru_cache(maxsize=128)
def _device_consts(child_moduli: tuple, dropped_moduli: tuple, degree: int,
                   t_scale: int, device: torch.device,
                   radix_bits: int) -> _DeviceConsts:
    c, cs, pmod, pmod_s, pinv, pinv_s, _ = _down_consts(
        child_moduli, dropped_moduli, degree, t_scale, radix_bits
    )

    def col(a):
        return torch.from_numpy(a.astype(np.int64)).to(device)

    return _DeviceConsts(
        kernel=tuple(word_table(a, radix_bits).to(device)
                     for a in (c, cs, pmod, pmod_s, pinv, pinv_s)),
        c64=col(c), pmod64=col(pmod)[:, None], pinv64=col(pinv)[:, None],
    )


def mod_down_combine_twin(yhat, ks, t, child_moduli: tuple,
                          dropped_moduli: tuple, degree: int, t_scale: int):
    """Plain int64 torch version of the kernels (any device): int32 planes
    take R = 2^32 and small arithmetic, int64 planes R = 2^64 and the
    overflow-free wide arithmetic."""
    rbits = 64 if yhat.dtype == torch.int64 else 32
    ar = arith(yhat.dtype)
    consts = _device_consts(child_moduli, dropped_moduli, degree, t_scale,
                            yhat.device, rbits)
    tabs = NttTables.build(child_moduli, degree, yhat.device)
    q = tabs.q
    ext = torch.zeros(ks.shape, dtype=torch.int64, device=yhat.device)
    for m in range(len(dropped_moduli)):
        ext = ar.add(ext, ar.mul(yhat[..., m, None, :].long(),
                                 consts.c64[m, :, None], q), q)
    ext_ntt = forward_ntt(ext.to(yhat.dtype), tabs).long()
    head = ks.long()
    if t is not None:
        head = ar.add(head, ar.mul(t.long(), consts.pmod64, q), q)
    return ar.mul(ar.sub(head, ext_ntt, q), consts.pinv64, q).to(yhat.dtype)


def _combine(yhat, ks, t, child_moduli, dropped_moduli, degree: int,
             t_scale: int, wide: bool):
    """Shared body of the two entry points; returns (out, blocks): the
    blocks per plane of the form launched (``launch_blocks``), 0 where
    nothing was launched."""
    child_moduli = tuple(int(m) for m in child_moduli)
    dropped_moduli = tuple(int(m) for m in dropped_moduli)
    G, Lc = len(dropped_moduli), len(child_moduli)
    dtype, rbits = (torch.int64, 64) if wide else (torch.int32, 32)
    log_n, parts = plane_split(degree, wide)
    if (t is None) != (t_scale == 0):
        raise ValueError("mod_down_combine: t and t_scale go together")
    if yhat.device.type == "cpu":
        _build.require_dtype("mod_down_combine", dtype, yhat, ks,
                             *([] if t is None else [t]))
        return mod_down_combine_twin(yhat, ks, t, child_moduli,
                                     dropped_moduli, degree, t_scale), 0
    lead = ks.shape[:-2]
    y3 = _build.planes(yhat, G, degree)
    k3 = _build.planes(ks, Lc, degree)
    t3 = None if t is None else _build.planes(t, Lc, degree)
    _build.require_cuda("mod_down_combine", dtype, y3, k3,
                        *([] if t3 is None else [t3]))
    outer = k3.shape[0]
    if y3.shape[0] != outer or (t3 is not None and t3.shape[0] != outer):
        raise ValueError("mod_down_combine: batch sizes differ")
    lib = _build.library()
    dev = ks.device
    c, cs, pm, pms, pinv, pinvs = _device_consts(
        child_moduli, dropped_moduli, degree, t_scale, dev, rbits
    ).kernel
    kt = kernel_tables(child_moduli, degree, dev, rbits)
    out = torch.empty((outer, Lc, degree), dtype=dtype, device=dev)
    if outer:
        p = _build.ptr
        entry = lib.ckks_moddown64 if wide else lib.ckks_moddown
        rc = entry(
            p(y3), y3.stride(0), p(k3), k3.stride(0),
            p(t3), 0 if t3 is None else t3.stride(0),
            p(c), p(cs), p(kt.q), p(pm), p(pms), p(pinv), p(pinvs),
            p(kt.fwd), p(kt.fwd_shoup), p(out), outer, G, Lc, log_n, parts,
            _build.stream(dev),
        )
        _build.check(rc, "mod_down_combine")
    blocks = launch_blocks(MOD_DOWN, wide, log_n, parts) if outer else 0
    return out.reshape(*lead, Lc, degree), blocks


def mod_down_combine(yhat, ks, t=None, *, child_moduli, dropped_moduli,
                     degree: int, t_scale: int = 0):
    """K3 (with t) / K3' (t None): out_j = ((t_j * t_scale if t) + ks_j -
    NTT(ext_j)) * P^{-1}.

    yhat: int32 (..., G, N) plain; ks/t: int32 (..., L', N) Montgomery
    NTT-domain planes (channel slices of larger stacks are read in place).
    P = prod(dropped_moduli). Returns int32 (..., L', N). ``launches``
    counts every launch, ``launches_no_t`` those without t (K3'),
    ``launches_cluster`` those on a cluster (N = 2^16: 16 blocks per plane,
    ``csrc/ntt_cluster.cuh``).
    """
    out, blocks = _combine(yhat, ks, t, child_moduli, dropped_moduli,
                           degree, t_scale, wide=False)
    count_launch(mod_down_combine, blocks)
    mod_down_combine.launches_no_t += blocks > 0 and t is None
    return out


def mod_down_combine_wide(yhat, ks, t=None, *, child_moduli, dropped_moduli,
                          degree: int, t_scale: int = 0):
    """K8 (with t) / K8' (t None): ``mod_down_combine`` on int64 planes of a
    wide chain (any q < 2^63, R = 2^64, N <= 2^16; at 2^13 .. 2^16 a
    cluster of blocks of register passes per plane,
    ``csrc/ntt_cluster.cuh`` ``WidePlan``: 16 blocks at 2^15 and 2^16,
    ``kWideNttLogCluster13`` / ``14`` below, counted in
    ``launches_cluster``)."""
    out, blocks = _combine(yhat, ks, t, child_moduli, dropped_moduli,
                           degree, t_scale, wide=True)
    count_launch(mod_down_combine_wide, blocks)
    mod_down_combine_wide.launches_no_t += blocks > 0 and t is None
    return out


mod_down_combine.launches = mod_down_combine.launches_no_t = 0
mod_down_combine_wide.launches = mod_down_combine_wide.launches_no_t = 0
mod_down_combine.launches_cluster = mod_down_combine_wide.launches_cluster = 0
