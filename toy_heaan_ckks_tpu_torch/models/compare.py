"""Encrypted comparison: sign, compare, abs, max/min, ReLU.

Counterpart of ``toy_heaan_ckks_tpu/models/compare.py``. CKKS has no
branching, so sign(x) is a composition of small odd polynomials (Cheon,
Kim and Kim, Asiacrypt 2020):

    f_n(x) = sum_{i=0}^{n} 4^{-i} C(2i, i) x (1 - x^2)^i
    g_3(x)   a steeper degree-7 variant that pushes |x| >= delta toward 1,

so that (f_n^{d_f} o g_3^{d_g})(x) ~= sign(x) on [-1, -delta] u [delta, 1].
Each iteration is one odd degree-7 Paterson-Stockmeyer evaluation
(``funceval.eval_chebyshev_ps``: ~4 ct x ct multiplies, ~4 levels) on the
engine's entry points, so it runs on the device of the ladder's contexts.
The polynomial families and ``plan_sign_iterations`` are host numpy,
copied from the reference.

Domain contract: sign / abs need x in [-1, 1] with |x| >= delta; compare /
max / min / relu need the difference of their operands there.
"""

from __future__ import annotations

from math import comb

import numpy as np

from ..engine import CkksEngine, CkksParams
from ..keys import KeyLadder
from ..types import Ciphertext
from .algorithms import _add_const, align_level
from .bootstrap import _mul_const
from .funceval import _combine, eval_chebyshev_ps

__all__ = [
    "sign_f_coeffs",
    "SIGN_G3",
    "plan_sign_iterations",
    "eval_sign",
    "eval_abs",
    "compare",
    "eval_max",
    "eval_min",
    "eval_relu",
]


def sign_f_coeffs(n: int = 3) -> np.ndarray:
    """Monomial coefficients of f_n (degree 2n+1, odd): f_n maps [-1, 1]
    into itself, fixes +-1, and f_n(x) - sign(x) = O((1-x^2)^{n+1})."""
    if n < 1:
        raise ValueError("sign_f_coeffs: need n >= 1")
    p = np.polynomial.Polynomial([0.0])
    x = np.polynomial.Polynomial([0.0, 1.0])
    base = np.polynomial.Polynomial([1.0, 0.0, -1.0])  # 1 - x^2
    for i in range(n + 1):
        p = p + (comb(2 * i, i) / 4.0**i) * x * base**i
    return p.coef


#: CKK20's g_3 (degree 7, odd), steep near 0: the paper's constants
#: quantized to 10 fractional bits.
SIGN_G3 = np.array(
    [0.0, 4589.0, 0.0, -16577.0, 0.0, 25614.0, 0.0, -12860.0]
) / 1024.0


def _compose_sign(x: np.ndarray, d_g: int, d_f: int, n: int) -> np.ndarray:
    f = np.polynomial.Polynomial(sign_f_coeffs(n))
    g = np.polynomial.Polynomial(SIGN_G3)
    y = x
    for _ in range(d_g):
        y = g(y)
    for _ in range(d_f):
        y = f(y)
    return y


def plan_sign_iterations(delta: float, eps: float,
                         n: int = 3) -> tuple[int, int]:
    """Smallest (d_g, d_f) with max_{delta<=|x|<=1} |composition - sign(x)|
    <= eps, by simulating the composition on a host grid. Raises if not
    reachable within 8 iterations of each."""
    if not 0 < delta < 1:
        raise ValueError("plan_sign_iterations: need 0 < delta < 1")
    xs = np.linspace(delta, 1.0, 4001)
    for total in range(1, 17):
        for d_g in range(0, total + 1):
            d_f = total - d_g
            if d_g > 8 or d_f > 8:
                continue
            if np.abs(_compose_sign(xs, d_g, d_f, n) - 1.0).max() <= eps:
                return d_g, d_f
    raise ValueError(
        f"plan_sign_iterations: (delta={delta}, eps={eps}) unreachable"
    )


def _eval_odd_poly(ladder: KeyLadder, params: CkksParams, ct: Ciphertext,
                   mono_coeffs: np.ndarray) -> Ciphertext:
    """One composition step: the odd monomial polynomial in the Chebyshev
    basis (exact change on the host) through Paterson-Stockmeyer."""
    cheb = np.polynomial.chebyshev.poly2cheb(np.asarray(mono_coeffs))
    return eval_chebyshev_ps(ladder, params, ct, cheb)


def eval_sign(ladder: KeyLadder, params: CkksParams, ct: Ciphertext,
              *, g_iters: int = 2, f_iters: int = 2,
              n: int = 3) -> Ciphertext:
    """sign(x) on an encrypted x in [-1, 1] with |x| >= delta: g_3 applied
    ``g_iters`` times, then f_n ``f_iters`` times (~4 levels each)."""
    if g_iters < 0 or f_iters < 0 or g_iters + f_iters == 0:
        raise ValueError("eval_sign: need at least one iteration")
    y = ct
    for _ in range(g_iters):
        y = _eval_odd_poly(ladder, params, y, SIGN_G3)
    f = sign_f_coeffs(n)
    for _ in range(f_iters):
        y = _eval_odd_poly(ladder, params, y, f)
    return y


def _engine_at(ladder: KeyLadder, params: CkksParams, level: int):
    return CkksEngine(ladder.at_level(level).ctx, params)


def _mul_cts(ladder: KeyLadder, params: CkksParams, a: Ciphertext,
             b: Ciphertext) -> Ciphertext:
    """a * b, both aligned down to the lower level, through the fused
    multiply with the ladder's relin key there."""
    lvl = min(a.level, b.level)
    a = align_level(_engine_at(ladder, params, a.level), a, lvl)
    b = align_level(_engine_at(ladder, params, b.level), b, lvl)
    return CkksEngine.mul_rescale(a, b, ladder.at_level(lvl).rlk)


def eval_abs(ladder: KeyLadder, params: CkksParams, ct: Ciphertext,
             **sign_kw) -> Ciphertext:
    """|x| = x * sign(x) for x in [-1, 1], |x| >= delta."""
    s = eval_sign(ladder, params, ct, **sign_kw)
    return _mul_cts(ladder, params, ct, s)


def compare(ladder: KeyLadder, params: CkksParams, ct_a: Ciphertext,
            ct_b: Ciphertext, **sign_kw) -> Ciphertext:
    """(sign(a - b) + 1) / 2: slot-wise 1 where a > b, 0 where a < b.
    Operands at the same level with a - b in [-1, 1], |a - b| >= delta."""
    d = CkksEngine.sub_ciphertexts(ct_a, ct_b)
    s = eval_sign(ladder, params, d, **sign_kw)
    eng = _engine_at(ladder, params, s.level)
    half = CkksEngine.rescale_ciphertext(_mul_const(eng, s, 0.5))
    return _add_const(_engine_at(ladder, params, half.level), half, 0.5)


def _avg(ladder: KeyLadder, params: CkksParams, a: Ciphertext,
         b: Ciphertext, sub: bool) -> Ciphertext:
    """(a -+ b) / 2 at the operands' level (one rescale)."""
    d = (CkksEngine.sub_ciphertexts if sub else CkksEngine.add_ciphertexts)(a, b)
    eng = _engine_at(ladder, params, d.level)
    return CkksEngine.rescale_ciphertext(_mul_const(eng, d, 0.5))


def _minmax(ladder: KeyLadder, params: CkksParams, ct_a: Ciphertext,
            ct_b: Ciphertext, sub: bool, sign_kw) -> Ciphertext:
    avg = _avg(ladder, params, ct_a, ct_b, sub=False)
    # sign sees the full difference (margin delta); the halving rides the
    # (a - b) / 2 product operand, derived from the same d
    d = CkksEngine.sub_ciphertexts(ct_a, ct_b)
    s = eval_sign(ladder, params, d, **sign_kw)
    eng = _engine_at(ladder, params, d.level)
    half_d = CkksEngine.rescale_ciphertext(_mul_const(eng, d, 0.5))
    half_abs = _mul_cts(ladder, params, half_d, s)
    return _combine(lambda lvl: _engine_at(ladder, params, lvl), avg, half_abs,
                    sub=sub)


def eval_max(ladder: KeyLadder, params: CkksParams, ct_a: Ciphertext,
             ct_b: Ciphertext, **sign_kw) -> Ciphertext:
    """max(a, b) = (a + b)/2 + (a - b)/2 * sign(a - b), slot-wise (the
    contract of ``compare``)."""
    return _minmax(ladder, params, ct_a, ct_b, False, sign_kw)


def eval_min(ladder: KeyLadder, params: CkksParams, ct_a: Ciphertext,
             ct_b: Ciphertext, **sign_kw) -> Ciphertext:
    """min(a, b) = (a + b)/2 - (a - b)/2 * sign(a - b), slot-wise."""
    return _minmax(ladder, params, ct_a, ct_b, True, sign_kw)


def eval_relu(ladder: KeyLadder, params: CkksParams, ct: Ciphertext,
              **sign_kw) -> Ciphertext:
    """ReLU(x) = (x + x * sign(x)) / 2 for x in [-1, 1]; slots with
    |x| < delta land within ~delta of the hinge."""
    s = eval_sign(ladder, params, ct, **sign_kw)
    xs = _mul_cts(ladder, params, ct, s)  # |x|
    x_down = align_level(_engine_at(ladder, params, ct.level), ct, xs.level)
    tot = _combine(lambda lvl: _engine_at(ladder, params, lvl), x_down, xs)
    eng = _engine_at(ladder, params, tot.level)
    return CkksEngine.rescale_ciphertext(_mul_const(eng, tot, 0.5))
