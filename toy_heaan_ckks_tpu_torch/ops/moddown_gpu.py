"""K3: fused RNS mod-down with combine, CUDA kernel and twin.

Counterpart of ``toy_heaan_ckks_tpu/ops/moddown_pallas.py``
(``_down_consts``, ``inv_ntt_to_yhat``, ``_md_kernel_t`` /
``_md_kernel_no_t``, ``mod_down_combine_pallas``). Per kept channel j:

    ext_j  = sum_m  yhat_m * (Phat_m * R mod q_j)
    out_j  = ((t_j * t_scale if t) + ks_j - NTT(ext_j)) * P^{-1} mod q_j

``yhat`` (plain values of the dropped channels times (Phat_m)^{-1}) comes
from ``inv_ntt_to_yhat``: the K1 inverse NTT with that factor folded into
its final constant. The kernel is ``csrc/moddown.cu``;
``mod_down_combine_twin`` is the plain int64 torch version. A CPU tensor
goes to the twin, a CUDA tensor to the kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .modular import u32_table
from .ntt import NttTables, forward_ntt
from .ntt_gpu import MAX_LOG_N, kernel_tables, ntt_planes


@functools.lru_cache(maxsize=128)
def _down_consts(child_moduli: tuple, dropped_moduli: tuple, degree: int,
                 t_scale: int = 0):
    """Host tables: per (dropped m, kept j) extension weights c = Phat_m * R
    mod q_j with Shoup companions; per kept channel t_scale mod q_j and
    P^{-1} mod q_j with companions; and the inverse-NTT final constants
    N^{-1} * (Phat_m)^{-1} * R^{-1} mod p_m that emit yhat directly.
    ``t_scale`` multiplies the optional t term (0: no t term)."""
    p_total = 1
    for p in dropped_moduli:
        p_total *= p
    G, L = len(dropped_moduli), len(child_moduli)

    def shoup(w, q):
        return (w << 32) // q

    c = np.zeros((G, L), dtype=np.uint32)
    cs = np.zeros((G, L), dtype=np.uint32)
    for m, pm in enumerate(dropped_moduli):
        phat = p_total // pm
        for j, qj in enumerate(child_moduli):
            w = (phat << 32) % qj
            c[m, j] = w
            cs[m, j] = shoup(w, qj)
    pmod = np.array([t_scale % qj for qj in child_moduli], dtype=np.uint32)
    pinv = np.array([pow(p_total % qj, -1, qj) for qj in child_moduli],
                    dtype=np.uint32)
    yfin = tuple(
        pow(degree, -1, pm) * pow((p_total // pm) % pm, -1, pm)
        * pow(1 << 32, -1, pm) % pm
        for pm in dropped_moduli
    )
    pmod_s = np.array([shoup(int(w), q) for w, q in zip(pmod, child_moduli)],
                      dtype=np.uint32)
    pinv_s = np.array([shoup(int(w), q) for w, q in zip(pinv, child_moduli)],
                      dtype=np.uint32)
    return c, cs, pmod, pmod_s, pinv, pinv_s, yfin


def inv_ntt_to_yhat(x_dropped, dropped_moduli: tuple, child_moduli: tuple,
                    degree: int):
    """Inverse NTT of the dropped channels emitting plain yhat directly
    (the (Phat_m)^{-1} multiply folded into K1's final constant).
    x: int32 (..., G, N) Montgomery NTT-domain planes."""
    yfin = _down_consts(tuple(child_moduli), tuple(dropped_moduli), degree)[6]
    return ntt_planes(x_dropped, dropped_moduli, degree, inverse=True, final=yfin)


@dataclasses.dataclass(frozen=True, eq=False)
class _DeviceConsts:
    kernel: tuple  # c, cs, pmod, pmod_s, pinv, pinv_s as int32 bit-views
    c64: torch.Tensor  # int64 (G, L')
    pmod64: torch.Tensor  # int64 (L', 1)
    pinv64: torch.Tensor  # int64 (L', 1)


@functools.lru_cache(maxsize=128)
def _device_consts(child_moduli: tuple, dropped_moduli: tuple, degree: int,
                   t_scale: int, device: torch.device) -> _DeviceConsts:
    c, cs, pmod, pmod_s, pinv, pinv_s, _ = _down_consts(
        child_moduli, dropped_moduli, degree, t_scale
    )

    def col(a):
        return torch.from_numpy(a.astype(np.int64)).to(device)

    return _DeviceConsts(
        kernel=tuple(u32_table(a).to(device)
                     for a in (c, cs, pmod, pmod_s, pinv, pinv_s)),
        c64=col(c), pmod64=col(pmod)[:, None], pinv64=col(pinv)[:, None],
    )


def mod_down_combine_twin(yhat, ks, t, child_moduli: tuple,
                          dropped_moduli: tuple, degree: int, t_scale: int):
    """Plain int64 torch version of the kernel (any device)."""
    consts = _device_consts(child_moduli, dropped_moduli, degree, t_scale,
                            yhat.device)
    tabs = NttTables.build(child_moduli, degree, yhat.device)
    q = tabs.q
    ext = torch.zeros(ks.shape, dtype=torch.int64, device=yhat.device)
    for m in range(len(dropped_moduli)):
        ext = (ext + yhat[..., m, None, :].long() * consts.c64[m, :, None]) % q
    ext_ntt = forward_ntt(ext.int(), tabs).long()
    head = ks.long()
    if t is not None:
        head = (head + t.long() * consts.pmod64) % q
    return ((head - ext_ntt) % q * consts.pinv64 % q).int()


def mod_down_combine(yhat, ks, t=None, *, child_moduli, dropped_moduli,
                     degree: int, t_scale: int = 0):
    """out_j = ((t_j * t_scale if t) + ks_j - NTT(ext_j)) * P^{-1}.

    yhat: int32 (..., G, N) plain; ks/t: int32 (..., L', N) Montgomery
    NTT-domain planes (channel slices of larger stacks are read in place).
    P = prod(dropped_moduli). Returns int32 (..., L', N).
    """
    child_moduli = tuple(int(m) for m in child_moduli)
    dropped_moduli = tuple(int(m) for m in dropped_moduli)
    G, Lc = len(dropped_moduli), len(child_moduli)
    if (t is None) != (t_scale == 0):
        raise ValueError("mod_down_combine: t and t_scale go together")
    if yhat.device.type == "cpu":
        return mod_down_combine_twin(yhat, ks, t, child_moduli,
                                     dropped_moduli, degree, t_scale)
    log_n = degree.bit_length() - 1
    if degree != 1 << log_n or not 2 <= log_n <= MAX_LOG_N:
        raise ValueError(f"mod_down_combine: N = {degree} unsupported")
    lead = ks.shape[:-2]
    y3 = _build.planes(yhat, G, degree)
    k3 = _build.planes(ks, Lc, degree)
    t3 = None if t is None else _build.planes(t, Lc, degree)
    _build.require_cuda("mod_down_combine", y3, k3, *([] if t3 is None else [t3]))
    outer = k3.shape[0]
    if y3.shape[0] != outer or (t3 is not None and t3.shape[0] != outer):
        raise ValueError("mod_down_combine: batch sizes differ")
    lib = _build.library()
    dev = ks.device
    c, cs, pm, pms, pinv, pinvs = _device_consts(
        child_moduli, dropped_moduli, degree, t_scale, dev
    ).kernel
    kt = kernel_tables(child_moduli, degree, dev)
    out = torch.empty((outer, Lc, degree), dtype=torch.int32, device=dev)
    if outer:
        p = _build.ptr
        rc = lib.ckks_moddown(
            p(y3), y3.stride(0), p(k3), k3.stride(0),
            p(t3), 0 if t3 is None else t3.stride(0),
            p(c), p(cs), p(kt.q), p(pm), p(pms), p(pinv), p(pinvs),
            p(kt.fwd), p(kt.fwd_shoup), p(out), outer, G, Lc, log_n,
            _build.stream(dev),
        )
        _build.check(rc, "mod_down_combine")
        mod_down_combine.launches += 1
    return out.reshape(*lead, Lc, degree)


mod_down_combine.launches = 0
