"""RNS polynomial layer: the ``Poly`` wrapper and host <-> device conversion.

Counterpart of ``toy_heaan_ckks_tpu/ops/poly.py``. ``Poly.data`` is an
(L, N) tensor of Montgomery-form residues on the context's device, one
word per residue: int32 on a small chain (the reference's (L, 2, N) uint32
limb pairs without the zero hi limb), int64 on a wide chain (lo | hi << 32).
Domain changes go through ``ntt_gpu``: the CUDA kernel K1 (small) or K5
(wide) for a tensor on the card, the torch twin for one on the CPU.
Samplers draw from the caller's numpy Generator in the reference's order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..context import CkksContext
from ..math import sampling
from ..math.crt import reconstruct_centered, to_residues
from . import modular as mm
from .ntt_gpu import ntt_planes, ntt_planes_wide


def _ntt(ctx: CkksContext):
    return ntt_planes if ctx.chain.small else ntt_planes_wide


def to_ntt(a: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    return _ntt(ctx)(a, ctx.moduli, ctx.degree, inverse=False)


def to_coeff(a: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    return _ntt(ctx)(a, ctx.moduli, ctx.degree, inverse=True)


def residues_to_device(res: np.ndarray, ctx: CkksContext) -> torch.Tensor:
    """Plain residues (L, N) in [0, q) (int64/uint64/object) -> Montgomery
    residues of the chain's dtype on the context's device."""
    plain = torch.from_numpy(np.asarray(res).astype(np.int64))
    return mm.to_mont(plain.to(ctx.device, ctx.chain.dtype), ctx.chain)


def encode_coeffs_to_device(coeffs, ctx: CkksContext) -> torch.Tensor:
    """Signed integer coefficients (exact) -> Montgomery residues on device."""
    coeffs = np.asarray(coeffs)
    if coeffs.shape[-1] != ctx.degree:
        raise ValueError(
            f"expected {ctx.degree} coefficients, got {coeffs.shape[-1]}"
        )
    return residues_to_device(to_residues(coeffs, list(ctx.moduli)), ctx)


def decode_device_to_coeffs(data: torch.Tensor, ctx: CkksContext) -> np.ndarray:
    """Montgomery residues (coeff domain) -> centered exact ints (host)."""
    plain = mm.from_mont(data, ctx.chain).cpu().numpy()
    return reconstruct_centered(plain, list(ctx.moduli))


@dataclasses.dataclass(frozen=True, eq=False)
class Poly:
    """Immutable RNS polynomial bound to a context.

    ``data``: (L, N) Montgomery-form residues on ``ctx.device``, of the
    chain's dtype (int32 small, int64 wide).
    ``ntt_domain``: True when data is in NTT (tree) order.
    """

    data: torch.Tensor
    ctx: CkksContext
    ntt_domain: bool

    # ── constructors ─────────────────────────────────────────────────────

    @staticmethod
    def from_coeffs(coeffs, ctx: CkksContext) -> "Poly":
        return Poly(encode_coeffs_to_device(coeffs, ctx), ctx, False)

    @staticmethod
    def from_residues(residues, ctx: CkksContext, ntt_domain: bool = False) -> "Poly":
        """Plain (non-Montgomery) residue matrix (L, N) -> Poly."""
        return Poly(residues_to_device(residues, ctx), ctx, ntt_domain)

    # ── samplers (host RNG; deterministic via a seeded numpy Generator) ──

    @staticmethod
    def sample_uniform(ctx: CkksContext, rng: np.random.Generator) -> "Poly":
        res = np.stack([
            sampling.uniform_coefficients(ctx.degree, q, rng)
            for q in ctx.moduli
        ])
        return Poly.from_residues(res, ctx)

    @staticmethod
    def sample_gaussian(
        ctx: CkksContext, std_dev: float, rng: np.random.Generator
    ) -> "Poly":
        coeffs = sampling.gaussian_coefficients(ctx.degree, std_dev, rng)
        return Poly.from_coeffs(coeffs, ctx)

    @staticmethod
    def sample_tribits(
        ctx: CkksContext, hamming_weight: int, rng: np.random.Generator
    ) -> "Poly":
        coeffs = sampling.ternary_coefficients(ctx.degree, hamming_weight, rng)
        return Poly.from_coeffs(coeffs, ctx)

    # ── domain conversion ────────────────────────────────────────────────

    def to_ntt_domain(self) -> "Poly":
        if self.ntt_domain:
            return self
        return Poly(to_ntt(self.data, self.ctx), self.ctx, True)

    def to_coeff_domain(self) -> "Poly":
        if not self.ntt_domain:
            return self
        return Poly(to_coeff(self.data, self.ctx), self.ctx, False)

    # ── arithmetic ───────────────────────────────────────────────────────

    def _check(self, other: "Poly"):
        if self.ctx is not other.ctx and (
            self.ctx.moduli != other.ctx.moduli
            or self.ctx.degree != other.ctx.degree
        ):
            from ..errors import ChannelCountMismatch

            raise ChannelCountMismatch("Poly context mismatch")
        if self.ntt_domain != other.ntt_domain:
            from ..errors import CkksError

            raise CkksError("Poly domain mismatch")

    def __add__(self, other: "Poly") -> "Poly":
        self._check(other)
        data = mm.add_mod(self.data, other.data, self.ctx.chain.q)
        return Poly(data, self.ctx, self.ntt_domain)

    def __sub__(self, other: "Poly") -> "Poly":
        self._check(other)
        data = mm.sub_mod(self.data, other.data, self.ctx.chain.q)
        return Poly(data, self.ctx, self.ntt_domain)

    def __neg__(self) -> "Poly":
        return Poly(mm.neg_mod(self.data, self.ctx.chain.q), self.ctx, self.ntt_domain)

    def __mul__(self, other: "Poly") -> "Poly":
        """Negacyclic product of NTT-domain operands: a pointwise
        Montgomery product (the only form the ported path uses)."""
        self._check(other)
        if not self.ntt_domain:
            from ..errors import CkksError

            raise CkksError("Poly product needs NTT-domain operands")
        chain = self.ctx.chain
        data = mm.mont_mul(self.data, other.data, chain.q, chain.rinv)
        return Poly(data, self.ctx, True)

    # ── level ops ────────────────────────────────────────────────────────

    def mod_drop_last(self, count: int = 1) -> "Poly":
        child_ctx = self.ctx.drop_last(count)
        return Poly(self.data[:-count], child_ctx, self.ntt_domain)

    # ── export ───────────────────────────────────────────────────────────

    def to_coeffs(self) -> np.ndarray:
        """Centered exact integer coefficients (host, object array)."""
        return decode_device_to_coeffs(self.to_coeff_domain().data, self.ctx)
