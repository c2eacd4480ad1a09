"""Modular arithmetic over an RNS chain of small primes, on torch tensors.

Counterpart of ``toy_heaan_ckks_tpu/ops/modular.py`` for chains whose
primes are all below 2^31 (Montgomery radix R = 2^32). Residues are stored
as ``torch.int32`` lo planes (..., L, N): every residue is below 2^31, so
each stored int32 is non-negative and its bits equal the reference's
uint32 lo limb. The reference's hi limb, identically zero on such chains,
is not stored.

Arithmetic runs in int64, because torch on the CPU implements no add,
shift or compare on uint32: the product of two residues is below 2^62,
and ``a * b % q`` is the exact canonical residue. A Montgomery product
``a*b*R^{-1} mod q`` is therefore ``(a*b % q) * (R^{-1} mod q) % q`` — the
same bits as the reference's REDC, which also emits canonical residues.
Wide chains (any q >= 2^31) raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

RADIX_BITS = 32
R = 1 << RADIX_BITS
SMALL_BOUND = 1 << 31


def u32_table(values) -> torch.Tensor:
    """Host values < 2^32 -> int32 tensor carrying the same bits (the CUDA
    kernels reinterpret it as uint32)."""
    arr = np.asarray(values, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy())


@dataclasses.dataclass(frozen=True, eq=False)
class ModulusChain:
    """Per-channel constants of one chain on one device.

    ``q``, ``rmod`` (R mod q), ``rinv`` (R^{-1} mod q) are int64 (L, 1)
    columns that broadcast against (..., L, N) planes. ``qinv`` is
    -q^{-1} mod 2^32 as an int32 bit-view (L,), for the kernels' REDC.
    """

    moduli: tuple[int, ...]
    q: torch.Tensor
    rmod: torch.Tensor
    rinv: torch.Tensor
    qinv: torch.Tensor

    @staticmethod
    def build(moduli, device) -> "ModulusChain":
        from ..errors import EmptyBasis, NonNttFriendlyModulus

        moduli = tuple(int(m) for m in moduli)
        if not moduli:
            raise EmptyBasis("modulus chain must contain at least one prime")
        for m in moduli:
            if m % 2 == 0 or m >= (1 << 63):
                raise NonNttFriendlyModulus(f"modulus {m} must be odd and < 2^63")
            if m >= SMALL_BOUND:
                raise NotImplementedError(
                    f"modulus {m} >= 2^31: wide chains are not ported yet"
                )

        def col(vals):
            return torch.tensor(vals, dtype=torch.int64, device=device)[:, None]

        return ModulusChain(
            moduli=moduli,
            q=col(moduli),
            rmod=col([R % m for m in moduli]),
            rinv=col([pow(R, -1, m) for m in moduli]),
            qinv=u32_table([(-pow(m, -1, R)) % R for m in moduli]).to(device),
        )

    def total_bits(self) -> int:
        """Sum of floor(log2 q_i)."""
        return sum(m.bit_length() - 1 for m in self.moduli)


# ── int64 primitives on tensors (q, consts broadcast as (L, 1) columns) ──


def add_mod(a, b, q):
    s = a.long() + b.long()
    return torch.where(s >= q, s - q, s).int()


def sub_mod(a, b, q):
    d = a.long() - b.long()
    return torch.where(d < 0, d + q, d).int()


def neg_mod(a, q):
    a = a.long()
    return torch.where(a == 0, a, q - a).int()


def mul_mod(a, w, q):
    """a * w mod q (plain multiply: the reference's Harvey/Shoup product)."""
    return (a.long() * w % q).int()


def mont_mul(a, b, q, rinv):
    """Montgomery product a*b*R^{-1} mod q, canonical in [0, q)."""
    return (a.long() * b.long() % q * rinv % q).int()


def to_mont(a, chain: ModulusChain):
    """Plain residues in [0, q) -> Montgomery form."""
    return mul_mod(a, chain.rmod, chain.q)


def from_mont(a, chain: ModulusChain):
    """Montgomery form -> plain residues in [0, q)."""
    return mul_mod(a, chain.rinv, chain.q)
