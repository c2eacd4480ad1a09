"""Homomorphic slot algorithms: rotation trees, Horner evaluation, sqrt.

Counterpart of ``toy_heaan_ckks_tpu/models/algorithms.py``:

- ``sum_slots``: binary rotation tree; after log2(slots) rotations every
  slot holds the sum of all slots. ``sum_slots_hoisted``: the same sum from
  one hoisted decomposition and one division by P.
- ``align_level``: bring a ciphertext down to a target level by
  multiply-by-1.0 + rescale steps; ``normalize_scale``: move a
  ciphertext's exact scale onto a target, spending one level.
- ``eval_poly_horner``: Horner polynomial evaluation, one ct x ct multiply
  + rescale per degree.
- ``sqrt_poly_coeffs`` / ``encrypted_std_dev``: the std-dev pipeline
  (sum -> mean -> center -> square -> variance -> polynomial sqrt).

Every step runs on the device of the ciphertext's context, through the
engine's entry points.
"""

from __future__ import annotations

import functools

import numpy as np

from ..engine import CkksEngine, CkksParams
from ..keys import KeyLadder
from ..ops.poly import Poly
from ..types import Ciphertext, Plaintext


def sum_slots(ct: Ciphertext, ladder: KeyLadder, slots: int) -> Ciphertext:
    """Binary rotation tree: every slot ends up holding sum(all slots).

    Needs rotation keys for offsets 1, 2, 4, ..., slots/2 at ct's level.
    Level-free.
    """
    if slots & (slots - 1):
        raise ValueError("sum_slots: slots must be a power of two")
    keys = ladder.at_level(ct.level)
    acc = ct
    offset = 1
    while offset < slots:
        rotated = CkksEngine.rotate_ciphertext(acc, keys.rot[offset])
        acc = CkksEngine.add_ciphertexts(acc, rotated)
        offset *= 2
    return acc


def sum_slots_hoisted(ct: Ciphertext, rot_keys) -> Ciphertext:
    """ct + sum_j rot_j(ct), j = 1..slots-1, from ONE gadget decomposition
    of c1 and one division by P for the whole sum (``rot_keys``: a key for
    every offset 1..slots-1, sharing the extended basis and digit size).
    Level-free; decode-equal to ``sum_slots`` within key-switch noise, not
    residue-equal."""
    rotated_sum = CkksEngine.rotate_sum_hoisted(ct, rot_keys)
    return CkksEngine.add_ciphertexts(ct, rotated_sum)


def align_level(
    engine: CkksEngine, ct: Ciphertext, target_level: int
) -> Ciphertext:
    """Drop ``ct`` to ``target_level`` by multiply-by-1.0 + rescale steps,
    each consuming one prime like the path the other operand took."""
    acc = ct
    while acc.level > target_level:
        acc = CkksEngine.rescale_ciphertext(engine.mul_plain_scalar(acc, 1.0))
    return acc


def normalize_scale(
    engine: CkksEngine, ct: Ciphertext, target_scale: float
) -> Ciphertext:
    """Bring ``ct.true_scale`` to ``target_scale``, consuming one level.

    Multiplies by the constant 1.0 encoded at the adjusted scale
    Delta' = target_scale * q_top / ct.true_scale (the plaintext's declared
    scale is its rounded integer, so it represents exactly 1.0), then
    rescales by q_top: the tracked scale lands on target_scale within
    2^-31 relative.
    """
    ctx = ct.ctx
    if ctx.num_channels < 2:
        raise ValueError("normalize_scale: no level left to consume")
    q_top = ctx.moduli[-1]
    dp = target_scale * q_top / ct.true_scale
    enc = int(round(dp))
    if enc < 1:
        raise ValueError(
            f"normalize_scale: adjustment {dp:.3g} not encodable"
        )
    coeffs = np.zeros(ctx.degree, dtype=object)
    coeffs[0] = enc
    pt = Plaintext(
        poly=Poly.from_coeffs(coeffs, ctx),
        scale_bits=engine.params.scale_bits,
        slots=ctx.degree // 2,
        scale=float(enc),  # the constant is exactly 1.0 at this scale
    )
    return CkksEngine.rescale_ciphertext(CkksEngine.mul_plain(ct, pt))


def eval_poly_horner(
    ladder: KeyLadder,
    params: CkksParams,
    ct: Ciphertext,
    coeffs: list[float],
) -> Ciphertext:
    """Evaluate a_0 + a_1 x + ... + a_d x^d on an encrypted x via Horner:
    d levels (one ct x ct multiply + rescale per step, the plain
    coefficient added as a constant polynomial). ``coeffs[k]`` multiplies
    x^k."""
    coeffs = [float(c) for c in coeffs]
    d = len(coeffs) - 1
    if d < 1:
        raise ValueError("eval_poly_horner: need degree >= 1")

    def engine_at(level):
        return CkksEngine(ladder.at_level(level).ctx, params)

    # r = a_d * x + a_{d-1}
    eng = engine_at(ct.level)
    r = CkksEngine.rescale_ciphertext(eng.mul_plain_scalar(ct, coeffs[d]))
    r = _add_const(engine_at(r.level), r, coeffs[d - 1])
    x = ct
    for k in range(d - 2, -1, -1):
        x = align_level(engine_at(x.level), x, r.level)
        rlk = ladder.at_level(r.level).rlk
        r = CkksEngine.mul_rescale(r, x, rlk)
        r = _add_const(engine_at(r.level), r, coeffs[k])
    return r


def _add_const(engine: CkksEngine, ct: Ciphertext, value) -> Ciphertext:
    """Add a plain constant to every slot, encoded at the ciphertext's
    EXACT scale (no scale-drift error deep in a chain). Complex constants
    ride the X^{N/2} monomial, which evaluates to i at every first-half
    slot root."""
    ctx = ct.ctx
    v = complex(value)
    coeffs = np.zeros(ctx.degree, dtype=object)
    coeffs[0] = int(round(v.real * ct.true_scale))
    if v.imag:
        coeffs[ctx.degree // 2] = int(round(v.imag * ct.true_scale))
    pt = Plaintext(
        poly=Poly.from_coeffs(coeffs, ctx), scale_bits=ct.logp,
        slots=ctx.degree // 2, scale=ct.true_scale,
    )
    return CkksEngine.add_plain(ct, pt)


@functools.lru_cache(maxsize=8)
def sqrt_poly_coeffs(degree: int = 3, lo: float = 0.0, hi: float = 0.25):
    """Least-squares polynomial fit of sqrt(x) on [lo, hi] (monomial
    coefficients, lowest first)."""
    x = np.linspace(lo + 1e-6, hi, 2048)
    fit = np.polynomial.chebyshev.Chebyshev.fit(x, np.sqrt(x), degree)
    return tuple(fit.convert(kind=np.polynomial.Polynomial).coef)


def encrypted_std_dev(
    ladder: KeyLadder,
    params: CkksParams,
    ct: Ciphertext,
    slots: int,
) -> Ciphertext:
    """Homomorphic standard deviation over ``slots`` values in one ct.

    sum_slots -> mean -> center -> square -> variance -> polynomial sqrt.
    Inputs normalised to [0, 1], so the variance lies in [0, 0.25].
    Consumes 3 + deg(sqrt) - 1 levels.
    """

    def engine_at(level):
        return CkksEngine(ladder.at_level(level).ctx, params)

    # mean in every slot
    sum_ct = sum_slots(ct, ladder, slots)
    mean = CkksEngine.rescale_ciphertext(
        engine_at(sum_ct.level).mul_plain_scalar(sum_ct, 1.0 / slots)
    )

    # center the original
    x = align_level(engine_at(ct.level), ct, mean.level)
    centered = CkksEngine.sub_ciphertexts(x, mean)

    # squared deviations (the squaring form: the same residues, one
    # pointwise product fewer)
    rlk = ladder.at_level(centered.level).rlk
    sq = CkksEngine.rescale_ciphertext(
        CkksEngine.square_ciphertext(centered, rlk)
    )

    # variance in every slot
    sq_sum = sum_slots(sq, ladder, slots)
    variance = CkksEngine.rescale_ciphertext(
        engine_at(sq_sum.level).mul_plain_scalar(sq_sum, 1.0 / slots)
    )

    # sqrt via degree-3 polynomial
    return eval_poly_horner(
        ladder, params, variance, list(sqrt_poly_coeffs())
    )
