"""K2 / K6: fused hybrid gadget key-switch accumulation, CUDA kernel and twin.

Counterpart of ``toy_heaan_ckks_tpu/ops/keyswitch_pallas.py``
(``_switch_consts``, ``_ks_kernel``, ``_ks_kernel_base``,
``gadget_accumulate_pallas``) for small chains, and of
``ops/keyswitch_pallas_wide.py`` (``_switch_consts_wide``,
``_ks_kernel_wide``, ``_ks_kernel_wide_base``,
``gadget_accumulate_pallas_wide``) for wide ones. Per extended channel j
and item, for each digit t: alpha = sum_{k in t} y_k * (Qhat_tk * R mod
q_j), forward NTT, then ks0 += REDC(alpha, key_b[t, j]) and
ks1 += REDC(alpha, key_a[t, j]). With ``d_ntt`` given, a base channel's
own digit uses d directly (the raised own digit *is* d mod q_j): the
skip-own-tower shortcut.

The kernel is ``csrc/keyswitch.cu`` (``ckks_keyswitch`` on uint32 words
with R = 2^32, ``ckks_keyswitch64`` on uint64 words with R = 2^64);
``gadget_accumulate_twin`` is the plain int64 torch version of both. A CPU
tensor goes to the twin, a CUDA tensor to the kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .modular import arith, mont_mul, shoup, word_table
from .ntt import NttTables, forward_ntt
from .ntt_gpu import (
    KEY_SWITCH, count_launch, kernel_tables, launch_blocks, plane_split,
)


@functools.lru_cache(maxsize=64)
def _switch_consts(base_moduli: tuple, ext_moduli: tuple, digit_size: int,
                   radix_bits: int = 32):
    """Host tables for the in-kernel basis extension, radix R = 2^bits.

    c[k, j]  = (Qhat_{t(k),k} * R) mod q_j  (maps the plain y_k straight
               to the Montgomery form of its alpha term)
    cs[k, j] = Shoup companion floor(c * R / q_j)
    plus per-ext-channel q and -q^{-1} mod R. Rows are t*digit_size + gi
    (zero-padded for a short last group). uint32 arrays for radix 32,
    uint64 for radix 64.
    """
    from ..keys import digit_groups

    L = len(base_moduli)
    E = len(ext_moduli)
    digit_size = min(digit_size, L)
    groups = digit_groups(L, digit_size)
    c = np.zeros((len(groups) * digit_size, E), dtype=object)
    for t, grp in enumerate(groups):
        for gi, k in enumerate(grp):
            qhat = 1
            for k2 in grp:
                if k2 != k:
                    qhat *= base_moduli[k2]
            for j, qj in enumerate(ext_moduli):
                c[t * digit_size + gi, j] = (qhat << radix_bits) % qj
    word = np.uint32 if radix_bits == 32 else np.uint64
    radix = 1 << radix_bits
    cs = shoup(c, np.array(ext_moduli, dtype=object)[None, :], radix_bits)
    q = np.array(ext_moduli, dtype=word)
    qinv = np.array([(-pow(m, -1, radix)) % radix for m in ext_moduli],
                    dtype=object).astype(word)
    return c.astype(word), cs.astype(word), q, qinv, digit_size


def _switch_consts_wide(base_moduli: tuple, ext_moduli: tuple, digit_size: int):
    """``_switch_consts`` with R = 2^64 (the reference's
    ``_switch_consts_wide``, as whole uint64 words)."""
    return _switch_consts(base_moduli, ext_moduli, digit_size, 64)


@dataclasses.dataclass(frozen=True, eq=False)
class _DeviceConsts:
    c: torch.Tensor  # word table (D*ds, E), kernel
    cs: torch.Tensor
    qinv: torch.Tensor  # word table (E,), kernel
    c64: torch.Tensor  # int64 (D*ds, E), twin


@functools.lru_cache(maxsize=64)
def _device_consts(base_moduli: tuple, ext_moduli: tuple, digit_size: int,
                   device: torch.device, radix_bits: int) -> _DeviceConsts:
    c, cs, _, qinv, _ = _switch_consts(base_moduli, ext_moduli, digit_size,
                                       radix_bits)
    return _DeviceConsts(
        c=word_table(c, radix_bits).to(device),
        cs=word_table(cs, radix_bits).to(device),
        qinv=word_table(qinv, radix_bits).to(device),
        c64=torch.from_numpy(c.astype(np.int64)).to(device),
    )


def gadget_accumulate_twin(y, key_a, key_b, base_moduli: tuple,
                           ext_moduli: tuple, degree: int, digit_size: int,
                           d_ntt=None):
    """Plain int64 torch version of the kernels (any device): int32
    planes take R = 2^32 and small arithmetic, int64 planes R = 2^64 and
    the overflow-free wide arithmetic."""
    L, E = len(base_moduli), len(ext_moduli)
    D = key_a.shape[0]
    rbits = 64 if y.dtype == torch.int64 else 32
    ar = arith(y.dtype)
    ds = min(digit_size, L)
    consts = _device_consts(base_moduli, ext_moduli, digit_size, y.device,
                            rbits)
    tabs = NttTables.build(ext_moduli, degree, y.device)
    q = tabs.q  # (E, 1)
    rinv = torch.tensor(
        [pow(1 << rbits, -1, m) for m in ext_moduli], dtype=torch.int64,
        device=y.device,
    )[:, None]
    y64 = y.long()
    if d_ntt is not None:
        pad = torch.zeros(
            d_ntt.shape[:-2] + (E - L, degree), dtype=y.dtype, device=y.device
        )
        d_ext = torch.cat([d_ntt, pad], dim=-2)
    ks0 = ks1 = None
    for t in range(D):
        alpha = torch.zeros(y.shape[:-2] + (E, degree), dtype=torch.int64,
                            device=y.device)
        for k in range(t * ds, min((t + 1) * ds, L)):
            alpha = ar.add(alpha, ar.mul(y64[..., k, None, :],
                                         consts.c64[k, :, None], q), q)
        alpha = forward_ntt(alpha.to(y.dtype), tabs)
        if d_ntt is not None:
            own = torch.tensor(
                [j < L and j // ds == t for j in range(E)], device=y.device
            )[:, None]
            alpha = torch.where(own, d_ext, alpha)
        v0 = mont_mul(alpha, key_b[t], q, rinv)
        v1 = mont_mul(alpha, key_a[t], q, rinv)
        ks0 = v0 if ks0 is None else ar.add(ks0.long(), v0.long(), q).to(y.dtype)
        ks1 = v1 if ks1 is None else ar.add(ks1.long(), v1.long(), q).to(y.dtype)
    return ks0, ks1


def digit_channels(num_channels: int, digit_size: int, digits: tuple) -> tuple:
    """The base channels [k0, k1) of the digit range ``digits`` = (t0, t1)
    of a chain of ``num_channels`` channels; raises ``ValueError`` unless
    0 <= t0 < t1 <= D."""
    ds = min(digit_size, num_channels)
    t0, t1 = digits
    if not 0 <= t0 < t1 <= -(-num_channels // ds):
        raise ValueError(f"digit range {digits} outside the "
                         f"{-(-num_channels // ds)} digits")
    return t0 * ds, min(t1 * ds, num_channels)


def _accumulate(y_plain, key_a, key_b, base_moduli, ext_moduli, degree: int,
                digit_size: int, d_ntt, wide: bool, digits=None):
    """Shared body of the two entry points; returns ((ks0, ks1), blocks):
    the blocks per plane of the form launched (``launch_blocks``), 0 where
    nothing was launched. A digit range (t0, t1) is the sub-problem of
    its digits: y's channels [k0, k1) over those base moduli, whose digit
    groups are the whole chain's from t0 on (the kernel and the twin need
    no offset); the skip-own input must then start at digit 0, where the
    sub-problem's base channels are the extended chain's first ones."""
    if digits is not None:
        k0, k1 = digit_channels(len(base_moduli), digit_size, digits)
        if d_ntt is not None and k0:
            raise ValueError("gadget_accumulate: the skip-own input d_ntt "
                             "needs a digit range from digit 0")
        if d_ntt is not None and d_ntt.shape[-2] != k1:
            raise ValueError("gadget_accumulate: d_ntt must hold the digit "
                             "range's channels")
        digit_size = min(digit_size, len(base_moduli))
        y_plain = y_plain[..., k0:k1, :]
        base_moduli = tuple(base_moduli)[k0:k1]
    base_moduli = tuple(int(m) for m in base_moduli)
    ext_moduli = tuple(int(m) for m in ext_moduli)
    L, E = len(base_moduli), len(ext_moduli)
    D = key_a.shape[0]
    ds = min(digit_size, L)
    dtype, rbits = (torch.int64, 64) if wide else (torch.int32, 32)
    log_n, parts = plane_split(degree, wide)
    if D != -(-L // ds) or tuple(key_a.shape) != (D, E, degree):
        raise ValueError("key digit count does not match digit_size")
    if y_plain.device.type == "cpu":
        _build.require_dtype("gadget_accumulate", dtype, y_plain, key_a, key_b)
        return gadget_accumulate_twin(y_plain, key_a, key_b, base_moduli,
                                      ext_moduli, degree, digit_size,
                                      d_ntt), 0
    lead = y_plain.shape[:-2]
    y3 = _build.planes(y_plain, L, degree)
    d3 = None if d_ntt is None else _build.planes(d_ntt, L, degree)
    ka = key_a.contiguous()
    kb = key_b.contiguous()
    tensors = [y3, ka, kb] + ([] if d3 is None else [d3])
    _build.require_cuda("gadget_accumulate", dtype, *tensors)
    if d3 is not None and d3.shape[0] != y3.shape[0]:
        raise ValueError("gadget_accumulate: d_ntt batch differs from y")
    lib = _build.library()
    dev = y_plain.device
    consts = _device_consts(base_moduli, ext_moduli, digit_size, dev, rbits)
    kt = kernel_tables(ext_moduli, degree, dev, rbits)
    outer = y3.shape[0]
    out0 = torch.empty((outer, E, degree), dtype=dtype, device=dev)
    out1 = torch.empty_like(out0)
    if outer:
        p = _build.ptr
        entry = lib.ckks_keyswitch64 if wide else lib.ckks_keyswitch
        rc = entry(
            p(y3), y3.stride(0), p(d3), 0 if d3 is None else d3.stride(0),
            p(ka), p(kb), p(consts.c), p(consts.cs), p(kt.q), p(consts.qinv),
            p(kt.fwd), p(kt.fwd_shoup), p(out0), p(out1),
            outer, L, E, D, ds, log_n, parts, _build.stream(dev),
        )
        _build.check(rc, "gadget_accumulate")
    blocks = launch_blocks(KEY_SWITCH, wide, log_n, parts) if outer else 0
    outs = out0.reshape(*lead, E, degree), out1.reshape(*lead, E, degree)
    return outs, blocks


def gadget_accumulate(y_plain, key_a, key_b, *, base_moduli, ext_moduli,
                      degree: int, digit_size: int = 1, d_ntt=None,
                      digits=None):
    """K2: fused decompose + raise + NTT + key inner product (small chains;
    at N = 2^16 on a thread-block cluster of 16 blocks per plane,
    ``csrc/ntt_cluster.cuh``).

    y_plain: int32 (..., L, N) plain digit values (the inverse NTT of d
             times the digit-local CRT inverses).
    key_a/key_b: int32 (D, E, N) Montgomery NTT-domain key stacks.
    d_ntt: optional int32 (..., L, N) NTT-domain planes of the switched
             polynomial (enables the skip-own-tower shortcut).
    digits: optional (t0, t1), the digits [t0, t1) alone (a shard's share
             of the digit sum): y over every base channel, the keys
             (t1 - t0, E, N), d_ntt (t0 = 0 only) over [0, k1), the
             range's channels; ``digit_ranges`` lists each such launch's
             range.
    Returns (ks0, ks1): int32 (..., E, N) digit inner products over QP.
    """
    outs, blocks = _accumulate(y_plain, key_a, key_b, base_moduli,
                               ext_moduli, degree, digit_size, d_ntt,
                               wide=False, digits=digits)
    count_launch(gadget_accumulate, blocks)
    if blocks and digits is not None:
        gadget_accumulate.digit_ranges.append(tuple(digits))
    return outs


def gadget_accumulate_wide(y_plain, key_a, key_b, *, base_moduli, ext_moduli,
                           degree: int, digit_size: int = 1, d_ntt=None,
                           digits=None):
    """K6: ``gadget_accumulate`` on int64 planes of a wide chain (any
    q < 2^63, R = 2^64, N <= 2^16; at 2^13 .. 2^16 a cluster of blocks of
    register passes per plane, ``csrc/ntt_cluster.cuh`` ``WidePlan``: 16
    blocks at 2^15 and 2^16, 8 at 2^14, 4 at 2^13, counted in
    ``launches_cluster``)."""
    outs, blocks = _accumulate(y_plain, key_a, key_b, base_moduli,
                               ext_moduli, degree, digit_size, d_ntt,
                               wide=True, digits=digits)
    count_launch(gadget_accumulate_wide, blocks)
    if blocks and digits is not None:
        gadget_accumulate_wide.digit_ranges.append(tuple(digits))
    return outs


gadget_accumulate.launches = gadget_accumulate.launches_cluster = 0
gadget_accumulate_wide.launches = gadget_accumulate_wide.launches_cluster = 0
gadget_accumulate.digit_ranges = []
gadget_accumulate_wide.digit_ranges = []
