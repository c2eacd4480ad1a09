"""Modular arithmetic over an RNS prime chain, on torch tensors.

Counterpart of ``toy_heaan_ckks_tpu/ops/modular.py``. The reference picks
the Montgomery radix per chain: R = 2^32 when every prime is below 2^31
(``small``), else R = 2^64 (any prime < 2^63). The port stores the
residues of a chain in one word per residue, and the dtype follows the
chain:

- small chains: ``torch.int32`` planes (..., L, N). Every residue is
  below 2^31, so each stored int32 is non-negative and its bits equal the
  reference's uint32 lo limb (the zero hi limb is not stored).
- wide chains: ``torch.int64`` planes (..., L, N). Every residue is below
  2^63, so each stored int64 is non-negative and its bits equal
  ``lo | hi << 32`` of the reference's limb pair.

The primitives below pick their arithmetic from the dtype of their first
operand. Torch on the CPU has no add, shift or compare on uint32/uint64,
so both compute in int64 and never overflow:

- small: a product of two residues is below 2^62, and ``a * b % q`` is
  the exact canonical residue.
- wide: ``a * b`` of two 61-bit residues overflows int64, and so does
  ``a + b`` for the 63-bit special primes of a 62-bit chain. Sums are
  formed as ``a - (q - b)`` (plus q where negative), and a product is a
  bit-serial double-and-add over those sums.

Either way the result is the exact canonical residue every reference
kernel emits, so a Montgomery product ``a*b*R^{-1} mod q`` is simply
``(a*b mod q) * (R^{-1} mod q) mod q`` — the reference's REDC bits.
The reference's 16-bit half-word emulation (``ops/u64.py``) is not ported.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

SMALL_BOUND = 1 << 31


def radix_bits_of(moduli) -> int:
    """Montgomery radix of a chain: 32 when every q < 2^31, else 64."""
    return 32 if all(int(m) < SMALL_BOUND for m in moduli) else 64


def word_table(values, radix_bits: int) -> torch.Tensor:
    """Host values < 2^radix_bits -> a tensor carrying the same bits in one
    word each: int32 for radix 32, int64 for radix 64 (the CUDA kernels
    reinterpret them as uint32 / uint64)."""
    arr = np.asarray(values, dtype=object).astype(np.uint64)
    if radix_bits == 32:
        return torch.from_numpy(arr.astype(np.uint32).view(np.int32).copy())
    return torch.from_numpy(arr.view(np.int64).copy())


@functools.lru_cache(maxsize=512)
def column(values: tuple, device) -> torch.Tensor:
    """Host ints < 2^63 -> a cached int64 column (..., 1) on ``device``
    that broadcasts against (..., L, N) planes (nested tuples give more
    leading axes)."""
    return torch.tensor(values, dtype=torch.int64, device=device)[..., None]


def shoup(w, q, radix_bits: int) -> np.ndarray:
    """Shoup companions floor(w * 2^radix_bits / q), exact (Python ints),
    as a uint64 array of w's shape."""
    w = np.asarray(w, dtype=object)
    q = np.asarray(q, dtype=object)
    return ((w << radix_bits) // q).astype(np.uint64)


@dataclasses.dataclass(frozen=True, eq=False)
class ModulusChain:
    """Per-channel constants of one chain on one device.

    ``q``, ``rmod`` (R mod q), ``rinv`` (R^{-1} mod q) are int64 (L, 1)
    columns that broadcast against (..., L, N) planes. ``qinv`` is
    -q^{-1} mod R as a word table (L,): int32 bits for R = 2^32, int64
    bits for R = 2^64 (values up to 2^64 - 1), for the kernels' REDC.
    """

    moduli: tuple[int, ...]
    q: torch.Tensor
    rmod: torch.Tensor
    rinv: torch.Tensor
    qinv: torch.Tensor
    small: bool

    @staticmethod
    def build(moduli, device) -> "ModulusChain":
        from ..errors import EmptyBasis, NonNttFriendlyModulus

        moduli = tuple(int(m) for m in moduli)
        if not moduli:
            raise EmptyBasis("modulus chain must contain at least one prime")
        for m in moduli:
            if m % 2 == 0 or m >= (1 << 63):
                raise NonNttFriendlyModulus(f"modulus {m} must be odd and < 2^63")
        rbits = radix_bits_of(moduli)
        radix = 1 << rbits

        def col(vals):
            return torch.tensor(vals, dtype=torch.int64, device=device)[:, None]

        return ModulusChain(
            moduli=moduli,
            q=col(moduli),
            rmod=col([radix % m for m in moduli]),
            rinv=col([pow(radix, -1, m) for m in moduli]),
            qinv=word_table([(-pow(m, -1, radix)) % radix for m in moduli],
                            rbits).to(device),
            small=rbits == 32,
        )

    @property
    def radix_bits(self) -> int:
        return 32 if self.small else 64

    @property
    def dtype(self) -> torch.dtype:
        """The word type of this chain's residue planes."""
        return torch.int32 if self.small else torch.int64

    def total_bits(self) -> int:
        """Sum of floor(log2 q_i)."""
        return sum(m.bit_length() - 1 for m in self.moduli)


# ── int64 arithmetic on canonical residues (q broadcasts as (L, 1)) ─────


def _add_small(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def _sub(a, b, q):
    d = a - b
    return torch.where(d < 0, d + q, d)


def _mul_small(a, b, q):
    return a * b % q


def _add_wide(a, b, q):
    """a + b mod q for a, b in [0, q), q < 2^63: never forms a + b."""
    r = a - (q - b)
    return torch.where(r < 0, r + q, r)


def _mul_wide(a, b, q):
    """a * b mod q for 0 <= a, b < 2^63, q < 2^63: double-and-add over the
    bits of b (every intermediate stays in [0, q)). Put a per-channel
    constant second: its bits are then a column, not a plane."""
    a = a % q  # int64 remainder is exact; a may be >= q (any residue)
    nbits = int(b.max()).bit_length() if b.numel() else 0
    r = torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                    dtype=torch.int64, device=a.device)
    for i in range(nbits - 1, -1, -1):
        r = _add_wide(r, r, q)
        r = _add_wide(r, a * ((b >> i) & 1), q)
    return r


class Arith(NamedTuple):
    """Exact canonical mod-q ops on int64 tensors holding residues."""

    add: Callable
    sub: Callable
    mul: Callable


SMALL = Arith(_add_small, _sub, _mul_small)
WIDE = Arith(_add_wide, _sub, _mul_wide)


def arith(dtype: torch.dtype) -> Arith:
    """The arithmetic of planes of ``dtype``: int32 small, int64 wide."""
    return WIDE if dtype == torch.int64 else SMALL


# ── primitives on residue planes (int32 small / int64 wide in and out) ──


def add_mod(a, b, q):
    return arith(a.dtype).add(a.long(), b.long(), q).to(a.dtype)


def sub_mod(a, b, q):
    return arith(a.dtype).sub(a.long(), b.long(), q).to(a.dtype)


def neg_mod(a, q):
    x = a.long()
    return torch.where(x == 0, x, q - x).to(a.dtype)


def mul_mod(a, w, q):
    """a * w mod q (plain product: the reference's Harvey/Shoup multiply)."""
    return arith(a.dtype).mul(a.long(), w.long(), q).to(a.dtype)


def mont_mul(a, b, q, rinv):
    """Montgomery product a*b*R^{-1} mod q, canonical in [0, q)."""
    ar = arith(a.dtype)
    return ar.mul(ar.mul(a.long(), b.long(), q), rinv, q).to(a.dtype)


def to_mont(a, chain: ModulusChain):
    """Plain residues (any value < 2^63 on a wide chain) -> Montgomery form."""
    return mul_mod(a, chain.rmod, chain.q)


def from_mont(a, chain: ModulusChain):
    """Montgomery form -> plain residues in [0, q)."""
    return mul_mod(a, chain.rinv, chain.q)
