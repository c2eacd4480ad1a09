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


def rescale_ntt(a: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    """Exact RNS rescale with NTT-domain input and output: drop q_last and
    divide by it, (..., L, N) -> (..., L-1, N). Only the dropped channel is
    inverse-transformed (its de-Montgomery folded into the inverse's final
    constant); the correction q_last-residue is re-read mod each kept q_i
    and forward-transformed there."""
    num = a.shape[-2]
    if num < 2:
        raise ValueError("rescale_ntt: need at least two channels")
    chain, n = ctx.chain, ctx.degree
    moduli = ctx.moduli
    q_last, kept = moduli[-1], moduli[:-1]
    fold = pow(n, -1, q_last) * pow(1 << chain.radix_bits, -1, q_last) % q_last
    plain_last = _ntt(ctx)(a[..., num - 1 :, :], (q_last,), n, inverse=True,
                           final=(fold,))
    q, rmod = chain.q[:-1], chain.rmod[:-1]
    mont_x = mm.mul_mod(plain_last.expand(*a.shape[:-2], num - 1, n), rmod, q)
    x_ntt = _ntt(ctx)(mont_x, kept, n, inverse=False)
    diff = mm.sub_mod(a[..., : num - 1, :], x_ntt, q)
    qlast_inv = mm.column(tuple(pow(q_last % qi, -1, qi) for qi in kept),
                          a.device)
    return mm.mul_mod(diff, qlast_inv, q)


def automorphism(a: torch.Tensor, src: torch.Tensor, negate: torch.Tensor,
                 ctx: CkksContext) -> torch.Tensor:
    """X -> X^e on coefficient-domain planes: out[..., j] = +/- a[..., src[j]]
    with ``(src, negate) = ctx.automorphism_table(e)``."""
    gathered = a.index_select(-1, src)
    return torch.where(negate, mm.neg_mod(gathered, ctx.chain.q), gathered)


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

    def rescale_ntt(self) -> "Poly":
        """Drop q_last and divide by it, staying in the NTT domain."""
        ntt = self.to_ntt_domain()
        return Poly(rescale_ntt(ntt.data, self.ctx), self.ctx.drop_last(1), True)

    # ── automorphisms ────────────────────────────────────────────────────

    def automorphism(self, exponent: int) -> "Poly":
        """X -> X^e. In the NTT domain this is a pure slot permutation (a
        gather, no negation); in the coefficient domain a gather plus
        negation."""
        e = exponent % (2 * self.ctx.degree)
        if e == 1:
            return self
        if self.ntt_domain:
            perm = self.ctx.automorphism_table_ntt(e)
            return Poly(self.data.index_select(-1, perm), self.ctx, True)
        src, negate = self.ctx.automorphism_table(e)
        return Poly(automorphism(self.data, src, negate, self.ctx), self.ctx, False)

    def rotate_slots(self, k: int) -> "Poly":
        """Rotate the slots left by k: X -> X^{5^k mod 2N}. A negative k is
        reduced mod N/2 (the order of 5 mod 2N), so 5^k is always the exact
        inverse power: the reference's departure from the Rust original,
        whose k < 0 composes the positive automorphism with conjugation."""
        half = self.ctx.degree // 2
        return self.automorphism(pow(5, k % half, 2 * self.ctx.degree))

    def conjugate(self) -> "Poly":
        """Complex-conjugate the slots: X -> X^{2N-1}."""
        return self.automorphism(2 * self.ctx.degree - 1)

    # ── export ───────────────────────────────────────────────────────────

    def to_coeffs(self) -> np.ndarray:
        """Centered exact integer coefficients (host, object array)."""
        return decode_device_to_coeffs(self.to_coeff_domain().data, self.ctx)
