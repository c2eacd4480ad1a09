"""Plaintext / Ciphertext containers.

Counterpart of ``toy_heaan_ckks_tpu/types.py``: a plaintext carries its
scale bits, slot count and exact scale; a ciphertext carries ``logp``
(precision), ``logq`` (modulus budget) and its exact scale, and drops
channels without dividing (``mod_switch``).
"""

from __future__ import annotations

import dataclasses

from .ops.poly import Poly


@dataclasses.dataclass(frozen=True, eq=False)
class Plaintext:
    poly: Poly
    scale_bits: int
    slots: int
    scale: float | None = None  # exact Delta; None -> 2^scale_bits

    @property
    def ctx(self):
        return self.poly.ctx

    @property
    def true_scale(self) -> float:
        return float(self.scale) if self.scale else float(2.0 ** self.scale_bits)


@dataclasses.dataclass(frozen=True, eq=False)
class Ciphertext:
    c0: Poly
    c1: Poly
    logp: int
    logq: int
    scale: float | None = None  # exact Delta; None -> 2^logp

    @property
    def true_scale(self) -> float:
        return float(self.scale) if self.scale else float(2.0 ** self.logp)

    @property
    def ctx(self):
        return self.c0.ctx

    @property
    def level(self) -> int:
        return self.c0.ctx.num_channels

    def mod_switch(self, levels: int = 1) -> "Ciphertext":
        """Drop the top ``levels`` RNS channels without dividing (a modulus
        switch): logq shrinks by the dropped primes' bits, logp and the
        scale stay."""
        ctx = self.ctx
        if levels < 1 or levels >= ctx.num_channels:
            raise ValueError("mod_switch: invalid level count")
        dropped_bits = sum(m.bit_length() for m in ctx.moduli[-levels:])
        return Ciphertext(
            c0=self.c0.mod_drop_last(levels),
            c1=self.c1.mod_drop_last(levels),
            logp=self.logp,
            logq=self.logq - dropped_bits,
            scale=self.scale,
        )
