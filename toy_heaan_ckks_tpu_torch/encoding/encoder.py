"""CKKS encoder/decoder: float slot values <-> RNS plaintext polynomials.

Counterpart of ``toy_heaan_ckks_tpu/encoding/encoder.py`` (dense and
sparse packing). Encode scales by Delta = 2^scale_bits, builds the
conjugate-symmetric slot vector, applies the inverse embedding (numpy FFT,
float64), rounds and reduces the coefficients per channel exactly; decode
reconstructs the centered coefficients by exact CRT (``math/crt.py``) and
applies the forward embedding. Torch appears only at the boundary: the
residues go to the context's device, and decode brings them back.
"""

from __future__ import annotations

import numpy as np

from ..context import CkksContext
from ..ops.poly import Poly
from ..types import Plaintext
from .embedding import build_conjugate_slots, embed_decode, embed_encode


class CkksEncoder:
    def __init__(self, degree: int, scale_bits: int):
        from ..errors import EncodingError, InvalidDegree

        if degree & (degree - 1) or degree < 2:
            raise InvalidDegree("CkksEncoder: degree must be a power of two")
        if scale_bits <= 0:
            raise EncodingError("CkksEncoder: scale_bits must be positive")
        self.degree = degree
        self.scale_bits = scale_bits

    @property
    def scale_factor(self) -> float:
        return float(2.0 ** self.scale_bits)

    @property
    def max_slots(self) -> int:
        return self.degree // 2

    def encode(self, values, ctx: CkksContext) -> Plaintext:
        """Encode real values (one per complex slot, imaginary = 0)."""
        values = np.asarray(values, dtype=np.float64)
        return self._encode_inner(
            values.astype(np.complex128) * self.scale_factor, len(values), ctx
        )

    def encode_complex(self, values, ctx: CkksContext) -> Plaintext:
        """Encode complex values, one per slot."""
        values = np.asarray(values, dtype=np.complex128)
        return self._encode_inner(values * self.scale_factor, len(values), ctx)

    def _encode_inner(self, scaled, slots: int, ctx: CkksContext) -> Plaintext:
        from ..errors import EncodingError

        if len(scaled) > self.max_slots:
            raise EncodingError(
                f"encode: {len(scaled)} values exceed max slots {self.max_slots}"
            )
        if ctx.degree != self.degree:
            raise EncodingError("encode: context degree mismatch")
        coeffs = embed_encode(build_conjugate_slots(scaled, self.degree), self.degree)
        rounded = np.round(coeffs.real)
        if np.all(np.abs(rounded) < 2**62):
            ints = rounded.astype(np.int64)
        else:
            ints = np.array([int(c) for c in rounded], dtype=object)
        return Plaintext(
            poly=Poly.from_coeffs(ints, ctx),
            scale_bits=self.scale_bits,
            slots=slots,
        )

    def encode_sparse(self, values, ctx: CkksContext) -> Plaintext:
        """Sparse packing: n < N/2 slots through the subring X -> X^gap.

        The n values are encoded in the degree-2n mini-ring and its
        coefficients spread at stride gap = N/(2n); the full-width slot
        reading is the n values repeated N/(2n) times, and decoding with
        pt.slots = n recovers them."""
        values = np.asarray(values, dtype=np.complex128)
        n_slots = values.shape[-1]
        if n_slots & (n_slots - 1) or n_slots < 1:
            raise ValueError("encode_sparse: slot count must be a power of two")
        if 2 * n_slots > self.degree:
            raise ValueError("encode_sparse: too many slots for this degree")
        mini_deg = 2 * n_slots
        gap = self.degree // mini_deg
        slot_vec = build_conjugate_slots(values * self.scale_factor, mini_deg)
        mini = np.round(embed_encode(slot_vec, mini_deg).real)
        int_coeffs = np.zeros(self.degree, dtype=object)
        int_coeffs[::gap] = [int(c) for c in mini]
        return Plaintext(
            poly=Poly.from_coeffs(int_coeffs, ctx),
            scale_bits=self.scale_bits,
            slots=n_slots,
        )

    def decode(self, pt: Plaintext) -> np.ndarray:
        return self.decode_complex(pt).real

    def decode_complex(self, pt: Plaintext) -> np.ndarray:
        int_coeffs = pt.poly.to_coeffs()
        scaled = np.asarray(
            [float(x) for x in int_coeffs], dtype=np.float64
        ) / pt.true_scale
        return embed_decode(scaled, self.degree)[: pt.slots]
