"""State carried between the JAX reference package and this port.

The reference stores residues as uint32 limb pairs (..., L, 2, N); on
small chains (all q < 2^31) the hi limbs are zero. The port stores the lo
planes as int32 (..., L, N) with the same bits. These functions convert
numpy arrays of the reference's layout to the port's objects and back;
they take numpy arrays, never reference objects, so the port does not
import the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import CkksContext
from .keys import PublicKey, RnsGadgetRelinKey, SecretKey
from .ops.poly import Poly
from .types import Ciphertext


def from_reference(arr, device="cpu") -> torch.Tensor:
    """uint32 (..., L, 2, N) -> int32 (..., L, N); the hi limbs must be zero
    and the lo limbs below 2^31."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint32 or arr.ndim < 3 or arr.shape[-2] != 2:
        raise ValueError(f"expected uint32 (..., L, 2, N), got {arr.dtype} {arr.shape}")
    if np.any(arr[..., 1, :]):
        raise ValueError("from_reference: non-zero hi limbs (wide chain)")
    lo = np.ascontiguousarray(arr[..., 0, :])
    if np.any(lo >= np.uint32(1 << 31)):
        raise ValueError("from_reference: residue >= 2^31")
    return torch.from_numpy(lo.view(np.int32).copy()).to(device)


def to_reference(t: torch.Tensor) -> np.ndarray:
    """int32 (..., L, N) -> uint32 (..., L, 2, N) with zero hi limbs."""
    lo = t.detach().cpu().numpy().view(np.uint32)
    return np.stack([lo, np.zeros_like(lo)], axis=-2)


def secret_key_from_reference(data, coeffs, ctx: CkksContext) -> SecretKey:
    """Reference ``SecretKey``: ``poly.data`` (L, 2, N) and ``coeffs``."""
    return SecretKey(
        poly=Poly(from_reference(data, ctx.device), ctx, True),
        coeffs=None if coeffs is None else np.asarray(coeffs, dtype=np.int64),
    )


def public_key_from_reference(a, b, ctx: CkksContext) -> PublicKey:
    """Reference ``PublicKey``: ``a.data`` and ``b.data``, NTT domain."""
    return PublicKey(
        a=Poly(from_reference(a, ctx.device), ctx, True),
        b=Poly(from_reference(b, ctx.device), ctx, True),
    )


def relin_key_from_reference(a, b, moduli, ext_moduli, digit_size: int,
                             degree: int, device="cpu",
                             a_seed: int | None = None) -> RnsGadgetRelinKey:
    """Reference ``RnsGadgetRelinKey`` stacks (D, E, 2, N) -> the port's."""
    ctx = CkksContext.build(moduli, degree, device)
    ext_ctx = CkksContext.build(ext_moduli, degree, device)
    special = 1
    for p in ext_ctx.moduli[ctx.num_channels:]:
        special *= p
    return RnsGadgetRelinKey(
        a=from_reference(a, ctx.device), b=from_reference(b, ctx.device),
        ctx=ctx, ext_ctx=ext_ctx, special=special, digit_size=digit_size,
        a_seed=a_seed,
    )


def ciphertext_from_reference(c0, c1, ctx: CkksContext, logp: int, logq: int,
                              scale: float | None = None,
                              ntt_domain: bool = True) -> Ciphertext:
    """Reference ``Ciphertext`` components (L, 2, N) -> the port's."""
    return Ciphertext(
        c0=Poly(from_reference(c0, ctx.device), ctx, ntt_domain),
        c1=Poly(from_reference(c1, ctx.device), ctx, ntt_domain),
        logp=logp, logq=logq, scale=scale,
    )


def ciphertext_to_reference(ct: Ciphertext) -> tuple[np.ndarray, np.ndarray]:
    return to_reference(ct.c0.data), to_reference(ct.c1.data)


def relin_key_to_reference(rlk: RnsGadgetRelinKey) -> tuple[np.ndarray, np.ndarray]:
    return to_reference(rlk.a), to_reference(rlk.b)
