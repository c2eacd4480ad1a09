"""Plaintext / Ciphertext containers.

Counterpart of ``toy_heaan_ckks_tpu/types.py``: a plaintext carries its
scale bits, slot count and exact scale; a ciphertext carries ``logp``
(precision), ``logq`` (modulus budget) and its exact scale.
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
