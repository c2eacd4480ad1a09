"""State carried between the JAX reference package and this port.

The reference stores residues as uint32 limb pairs (..., L, 2, N). The port
stores one word per residue (..., L, N): on small chains (all q < 2^31) the
hi limbs are zero and the lo limbs go into int32 planes with the same
bits; on wide chains (some q >= 2^31, every q < 2^63) each residue
``lo | hi << 32`` is below 2^63 and goes into an int64 plane. These
functions convert numpy arrays of the reference's layout to the port's
objects and back; they take numpy arrays, never reference objects, so the
port does not import the reference. The device is always explicit.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import CkksContext
from .keys import PublicKey, RnsGadgetRelinKey, SecretKey
from .ops.poly import Poly
from .types import Ciphertext


def from_reference(arr, device, wide: bool = False) -> torch.Tensor:
    """uint32 (..., L, 2, N) -> int32 (..., L, N) (small: the hi limbs must
    be zero and the lo limbs below 2^31) or, with ``wide``, int64
    (..., L, N) (each lo | hi << 32 below 2^63), on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint32 or arr.ndim < 3 or arr.shape[-2] != 2:
        raise ValueError(f"expected uint32 (..., L, 2, N), got {arr.dtype} {arr.shape}")
    lo = np.ascontiguousarray(arr[..., 0, :])
    hi = np.ascontiguousarray(arr[..., 1, :])
    if wide:
        if np.any(hi >= np.uint32(1 << 31)):
            raise ValueError("from_reference: residue >= 2^63")
        words = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
        return torch.from_numpy(words.view(np.int64).copy()).to(device)
    if np.any(hi):
        raise ValueError("from_reference: non-zero hi limbs (wide chain)")
    if np.any(lo >= np.uint32(1 << 31)):
        raise ValueError("from_reference: residue >= 2^31")
    return torch.from_numpy(lo.view(np.int32).copy()).to(device)


def to_reference(t: torch.Tensor) -> np.ndarray:
    """int32 (..., L, N) -> uint32 (..., L, 2, N) with zero hi limbs, or
    int64 (..., L, N) -> uint32 (lo, hi) limb pairs."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.int64:
        w = a.view(np.uint64)
        lo = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (w >> np.uint64(32)).astype(np.uint32)
        return np.stack([lo, hi], axis=-2)
    lo = a.view(np.uint32)
    return np.stack([lo, np.zeros_like(lo)], axis=-2)


def _planes(arr, ctx: CkksContext) -> torch.Tensor:
    return from_reference(arr, ctx.device, wide=not ctx.chain.small)


def secret_key_from_reference(data, coeffs, ctx: CkksContext) -> SecretKey:
    """Reference ``SecretKey``: ``poly.data`` (L, 2, N) and ``coeffs``."""
    return SecretKey(
        poly=Poly(_planes(data, ctx), ctx, True),
        coeffs=None if coeffs is None else np.asarray(coeffs, dtype=np.int64),
    )


def public_key_from_reference(a, b, ctx: CkksContext) -> PublicKey:
    """Reference ``PublicKey``: ``a.data`` and ``b.data``, NTT domain."""
    return PublicKey(
        a=Poly(_planes(a, ctx), ctx, True),
        b=Poly(_planes(b, ctx), ctx, True),
    )


def relin_key_from_reference(a, b, moduli, ext_moduli, digit_size: int,
                             degree: int, device,
                             a_seed: int | None = None) -> RnsGadgetRelinKey:
    """Reference ``RnsGadgetRelinKey`` stacks (D, E, 2, N) -> the port's,
    on ``device``."""
    ctx = CkksContext.build(moduli, degree, device)
    ext_ctx = CkksContext.build(ext_moduli, degree, device)
    special = 1
    for p in ext_ctx.moduli[ctx.num_channels:]:
        special *= p
    return RnsGadgetRelinKey(
        a=_planes(a, ext_ctx), b=_planes(b, ext_ctx),
        ctx=ctx, ext_ctx=ext_ctx, special=special, digit_size=digit_size,
        a_seed=a_seed,
    )


def ciphertext_from_reference(c0, c1, ctx: CkksContext, logp: int, logq: int,
                              scale: float | None = None,
                              ntt_domain: bool = True) -> Ciphertext:
    """Reference ``Ciphertext`` components (L, 2, N) -> the port's."""
    return Ciphertext(
        c0=Poly(_planes(c0, ctx), ctx, ntt_domain),
        c1=Poly(_planes(c1, ctx), ctx, ntt_domain),
        logp=logp, logq=logq, scale=scale,
    )


def ciphertext_to_reference(ct: Ciphertext) -> tuple[np.ndarray, np.ndarray]:
    return to_reference(ct.c0.data), to_reference(ct.c1.data)


def relin_key_to_reference(rlk: RnsGadgetRelinKey) -> tuple[np.ndarray, np.ndarray]:
    return to_reference(rlk.a), to_reference(rlk.b)
