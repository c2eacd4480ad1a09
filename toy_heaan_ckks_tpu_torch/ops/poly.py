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


def add(a: torch.Tensor, b: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    return mm.add_mod(a, b, ctx.chain.q)


def sub(a: torch.Tensor, b: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    return mm.sub_mod(a, b, ctx.chain.q)


def neg(a: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    return mm.neg_mod(a, ctx.chain.q)


def mul_pointwise(a: torch.Tensor, b: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    """Pointwise Montgomery product: the negacyclic product of NTT-domain
    planes."""
    return mm.mont_mul(a, b, ctx.chain.q, ctx.chain.rinv)


def mod_drop_last(a: torch.Tensor, count: int = 1) -> torch.Tensor:
    keep = a.shape[-2] - count
    if keep < 1:
        raise ValueError("mod_drop_last: cannot drop all channels")
    return a[..., :keep, :]


def to_ntt(a: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    return _ntt(ctx)(a, ctx.moduli, ctx.degree, inverse=False)


def to_coeff(a: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    return _ntt(ctx)(a, ctx.moduli, ctx.degree, inverse=True)


def rescale(a: torch.Tensor, ctx: CkksContext) -> torch.Tensor:
    """Exact RNS rescale in the coefficient domain: drop q_last and divide
    by it, (..., L, N) -> (..., L-1, N):
    new_i = (c_i - (c_last mod q_i)) * q_last^{-1} mod q_i."""
    num = a.shape[-2]
    if num < 2:
        raise ValueError("rescale: need at least two channels")
    chain = ctx.chain
    q_last, kept = ctx.moduli[-1], ctx.moduli[:-1]
    plain_last = mm.mul_mod(a[..., num - 1 :, :], chain.rinv[-1:], chain.q[-1:])
    q = chain.q[:-1]
    mont_x = mm.mul_mod(plain_last.expand(*a.shape[:-2], num - 1, a.shape[-1]),
                        chain.rmod[:-1], q)
    diff = mm.sub_mod(a[..., : num - 1, :], mont_x, q)
    qlast_inv = mm.column(tuple(pow(q_last % qi, -1, qi) for qi in kept), a.device)
    return mm.mul_mod(diff, qlast_inv, q)


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
    """Signed integer coefficients (exact) -> Montgomery residues on device.
    Fixed-width integers, and object arrays of Python ints that all fit in
    int64 (the constants of the models), are reduced on the device
    (``torch.remainder`` by a positive q is non-negative, as numpy's
    ``%``); wider ones through exact Python ints on the host."""
    coeffs = np.asarray(coeffs)
    if coeffs.shape[-1] != ctx.degree:
        raise ValueError(
            f"expected {ctx.degree} coefficients, got {coeffs.shape[-1]}"
        )
    if coeffs.dtype == object:
        try:
            narrow = coeffs.astype(np.int64)
        except OverflowError:
            narrow = None
        if narrow is None or not (narrow.astype(object) == coeffs).all():
            return residues_to_device(to_residues(coeffs, list(ctx.moduli)), ctx)
        coeffs = narrow
    c = torch.from_numpy(np.ascontiguousarray(coeffs, dtype=np.int64)).to(ctx.device)
    plain = torch.remainder(c.unsqueeze(-2), ctx.chain.q)
    return mm.to_mont(plain.to(ctx.chain.dtype), ctx.chain)


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
    def zero(ctx: CkksContext, ntt_domain: bool = False) -> "Poly":
        data = torch.zeros((ctx.num_channels, ctx.degree), dtype=ctx.chain.dtype,
                           device=ctx.device)
        return Poly(data, ctx, ntt_domain)

    @staticmethod
    def from_coeffs(coeffs, ctx: CkksContext) -> "Poly":
        return Poly(encode_coeffs_to_device(coeffs, ctx), ctx, False)

    @staticmethod
    def from_residues(residues, ctx: CkksContext, ntt_domain: bool = False) -> "Poly":
        """Plain (non-Montgomery) residue matrix (L, N) -> Poly."""
        return Poly(residues_to_device(residues, ctx), ctx, ntt_domain)

    @staticmethod
    def from_residues_u64(residues: np.ndarray, ctx: CkksContext,
                          ntt_domain: bool = False) -> "Poly":
        """Plain uint64 residue matrix (L, N) -> Poly (the same words as
        ``from_residues`` on the same values)."""
        res = np.ascontiguousarray(residues, dtype=np.uint64)
        return Poly(residues_to_device(res, ctx), ctx, ntt_domain)

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
        return Poly(add(self.data, other.data, self.ctx), self.ctx, self.ntt_domain)

    def __sub__(self, other: "Poly") -> "Poly":
        self._check(other)
        return Poly(sub(self.data, other.data, self.ctx), self.ctx, self.ntt_domain)

    def __neg__(self) -> "Poly":
        return Poly(neg(self.data, self.ctx), self.ctx, self.ntt_domain)

    def __mul__(self, other: "Poly") -> "Poly":
        """Negacyclic product of NTT-domain operands: a pointwise
        Montgomery product (the only form the ported paths use)."""
        self._check(other)
        if not self.ntt_domain:
            from ..errors import CkksError

            raise CkksError("Poly product needs NTT-domain operands")
        return Poly(mul_pointwise(self.data, other.data, self.ctx), self.ctx, True)

    # ── level ops ────────────────────────────────────────────────────────

    def mod_drop_last(self, count: int = 1) -> "Poly":
        return Poly(mod_drop_last(self.data, count), self.ctx.drop_last(count),
                    self.ntt_domain)

    def rescale(self) -> "Poly":
        """Drop q_last and divide by it; the result is in the coefficient
        domain (the same words as ``rescale_ntt`` taken back there)."""
        coeff = self.to_coeff_domain()
        return Poly(rescale(coeff.data, self.ctx), self.ctx.drop_last(1), False)

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

    def residues(self) -> np.ndarray:
        """Plain (non-Montgomery) residues as an exact (L, N) object array."""
        return mm.from_mont(self.data, self.ctx.chain).cpu().numpy().astype(object)
