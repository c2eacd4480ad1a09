"""Homomorphic evaluation of arbitrary smooth functions.

Counterpart of ``toy_heaan_ckks_tpu/models/funceval.py``: fit f on an
interval with a Chebyshev interpolant (host side, numpy), then evaluate
the interpolant on the encrypted input with the Paterson-Stockmeyer
(baby-step/giant-step) Chebyshev algorithm, ~2*sqrt(deg) ct x ct
multiplies and ceil(log2 deg) + O(1) levels instead of the linear
recurrence's deg (``bootstrap.eval_chebyshev``).

The split is the Chebyshev division identity: with
2*T_a*T_b = T_{a+b} + T_{|a-b|},

    p = q * T_g + r,   q_{i-g} = 2*c_i (i > g),  q_0 += c_g,
                       r_j = c_j (j < g),        r_{2g-i} -= c_i (i > g)

which is exact whenever deg(p) < 2g (splitting at the largest giant
<= deg).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..engine import CkksEngine, CkksParams
from ..keys import KeyLadder
from ..types import Ciphertext
from .algorithms import _add_const, align_level
from .bootstrap import _mul_const, eval_chebyshev

__all__ = [
    "chebyshev_fit",
    "eval_chebyshev_ps",
    "eval_function",
    "eval_sigmoid",
    "eval_exp",
    "eval_inverse",
]

_EPS = 1e-12  # drop fit coefficients below this (pure noise)


def chebyshev_fit(f, a: float, b: float, degree: int) -> np.ndarray:
    """Chebyshev interpolation coefficients of f on [a, b]: returns c with
    f(x) ~= sum_k c[k] * T_k(u), u = (2x - a - b) / (b - a)."""
    cheb = np.polynomial.chebyshev.Chebyshev.interpolate(
        lambda u: f((u * (b - a) + (a + b)) / 2.0), degree
    )
    return cheb.coef


def _combine(engine_at, a: Ciphertext, b: Ciphertext,
             sub: bool = False) -> Ciphertext:
    """Level-align and add/sub two evaluation branches.

    Branches that reach one level through different multiply/rescale
    histories carry diverged integer ``logp`` claims while their exact
    scales agree (``_check_scale_match`` is the authority): reconcile logp
    to the smaller claim before the engine-level add. Where the exact
    scales differ by more than SCALE_MATCH_TOL, spend ONE level bringing
    both branches to an identical exact scale (align a, normalize b onto
    a's new scale) instead of raising."""
    lvl = min(a.level, b.level)
    a = align_level(engine_at(a.level), a, lvl)
    b = align_level(engine_at(b.level), b, lvl)
    from ..engine import SCALE_MATCH_TOL

    if (
        lvl >= 2
        and abs(a.true_scale - b.true_scale)
        > SCALE_MATCH_TOL * max(a.true_scale, b.true_scale)
    ):
        from .algorithms import normalize_scale

        a = align_level(engine_at(lvl), a, lvl - 1)
        b = normalize_scale(engine_at(lvl), b, a.true_scale)
    CkksEngine._check_scale_match(a.true_scale, b.true_scale, "funceval")
    logp = min(a.logp, b.logp)
    a = dataclasses.replace(a, logp=logp)
    b = dataclasses.replace(b, logp=logp)
    if sub:
        return CkksEngine.sub_ciphertexts(a, b)
    return CkksEngine.add_ciphertexts(a, b)


class _ChebBasis:
    """Memoized encrypted Chebyshev polynomials T_i(x) of one input."""

    def __init__(self, ladder: KeyLadder, params: CkksParams,
                 ct: Ciphertext):
        self.ladder = ladder
        self.params = params
        self.memo = {1: ct}

    def engine_at(self, level):
        return CkksEngine(self.ladder.at_level(level).ctx, self.params)

    def t(self, i: int) -> Ciphertext:
        """T_i(x), built as 2*T_a*T_b - T_{a-b} with a = ceil(i/2)
        (depth ceil(log2 i); shared subtrees are memoized)."""
        if i in self.memo:
            return self.memo[i]
        a = (i + 1) // 2
        b = i - a  # a - b in {0, 1}
        ta, tb = self.t(a), self.t(b)
        lvl = min(ta.level, tb.level)
        ta = align_level(self.engine_at(ta.level), ta, lvl)
        tb = align_level(self.engine_at(tb.level), tb, lvl)
        rlk = self.ladder.at_level(lvl).rlk
        prod = CkksEngine.mul_rescale(ta, tb, rlk)
        twice = CkksEngine.add_ciphertexts(prod, prod)
        if a == b:  # T_{2a} = 2 T_a^2 - T_0, T_0 = 1
            out = _add_const(self.engine_at(twice.level), twice, -1.0)
        else:  # T_{a+b} = 2 T_a T_b - T_1
            out = _combine(self.engine_at, twice, self.memo[1], sub=True)
        self.memo[i] = out
        return out


def _trim(c: list[complex]) -> list[complex]:
    last = 0
    for i, v in enumerate(c):
        if abs(v) > _EPS:
            last = i
    return c[: last + 1]


def eval_chebyshev_ps(ladder: KeyLadder, params: CkksParams,
                      ct: Ciphertext, coeffs) -> Ciphertext:
    """Paterson-Stockmeyer evaluation of sum_k coeffs[k] * T_k(x) on an
    encrypted x in [-1, 1]: ~2*sqrt(deg) ct-ct multiplies, depth
    ~log2(deg) levels. Coefficients may be complex. Needs params.scale_bits
    equal to the chain's prime size, so that branches reaching one level
    through different histories keep their exact scales within the
    engine's 1% match tolerance."""
    coeffs = _trim([complex(c) for c in coeffs])
    deg = len(coeffs) - 1
    if deg < 1:
        raise ValueError("eval_chebyshev_ps: need degree >= 1")
    if deg <= 3:
        return eval_chebyshev(ladder, params, ct, coeffs)

    m = 1 << max(1, (deg.bit_length() + 1) // 2)  # ~sqrt(deg), power of 2
    basis = _ChebBasis(ladder, params, ct)

    def direct(c: list[complex]) -> Ciphertext:
        """sum c_i T_i, i < m: scalar multiplies only (one rescale)."""
        acc = None
        for i in range(len(c) - 1, 0, -1):
            if abs(c[i]) <= _EPS:
                continue
            term = CkksEngine.rescale_ciphertext(
                _mul_const(
                    basis.engine_at(basis.t(i).level), basis.t(i), c[i]
                )
            )
            acc = term if acc is None else _combine(
                basis.engine_at, acc, term
            )
        if acc is None:  # constant polynomial: 0 * x + c_0
            acc = CkksEngine.rescale_ciphertext(
                _mul_const(basis.engine_at(ct.level), ct, 0.0)
            )
        return _add_const(basis.engine_at(acc.level), acc, c[0])

    def rec(c: list[complex]) -> Ciphertext:
        c = _trim(c)
        d = len(c) - 1
        if d < m:
            return direct(c)
        g = m
        while 2 * g <= d:
            g *= 2
        # p = q * T_g + r  (exact: d < 2g)
        q = [0j] * (d - g + 1)
        r = list(c[:g]) + [0j]  # slot g unused; kept for index safety
        q[0] += c[g]
        for i in range(g + 1, d + 1):
            q[i - g] += 2 * c[i]
            r[2 * g - i] -= c[i]
        q_ct = rec(q)
        tg = basis.t(g)
        lvl = min(q_ct.level, tg.level)
        q_ct = align_level(basis.engine_at(q_ct.level), q_ct, lvl)
        tg = align_level(basis.engine_at(tg.level), tg, lvl)
        rlk = ladder.at_level(lvl).rlk
        prod = CkksEngine.mul_rescale(q_ct, tg, rlk)
        return _combine(basis.engine_at, prod, rec(r[:g]))

    return rec(coeffs)


def eval_function(ladder: KeyLadder, params: CkksParams, ct: Ciphertext,
                  f, interval: tuple[float, float], degree: int = 31,
                  method: str = "ps") -> Ciphertext:
    """Evaluate a smooth scalar function f on an encrypted input: a
    degree-``degree`` Chebyshev interpolant of f on ``interval``, the input
    mapped affinely to [-1, 1] first (one scalar multiply + rescale).
    ``method``: "ps" (Paterson-Stockmeyer, default) or "linear" (one level
    per degree)."""
    a, b = float(interval[0]), float(interval[1])
    if not b > a:
        raise ValueError("eval_function: need interval (a, b) with b > a")
    coeffs = chebyshev_fit(f, a, b, degree)

    def engine_at(level):
        return CkksEngine(ladder.at_level(level).ctx, params)

    # u = (2x - (a+b)) / (b - a)
    eng = engine_at(ct.level)
    u = CkksEngine.rescale_ciphertext(
        eng.mul_plain_scalar(ct, 2.0 / (b - a))
    )
    u = _add_const(engine_at(u.level), u, -(a + b) / (b - a))
    if method == "ps":
        return eval_chebyshev_ps(ladder, params, u, coeffs)
    return eval_chebyshev(ladder, params, u, coeffs)


def eval_sigmoid(ladder, params, ct, interval=(-8.0, 8.0),
                 degree: int = 31) -> Ciphertext:
    """1 / (1 + e^{-x}) on an encrypted x in ``interval``."""
    return eval_function(
        ladder, params, ct, lambda x: 1.0 / (1.0 + np.exp(-x)),
        interval, degree,
    )


def eval_exp(ladder, params, ct, interval=(-1.0, 1.0),
             degree: int = 15) -> Ciphertext:
    """e^x on an encrypted x in ``interval``."""
    return eval_function(ladder, params, ct, np.exp, interval, degree)


def eval_inverse(ladder, params, ct, interval=(0.2, 2.0),
                 degree: int = 31) -> Ciphertext:
    """1 / x on an encrypted x in ``interval`` (must exclude 0)."""
    a, b = interval
    if a <= 0 <= b:
        raise ValueError("eval_inverse: interval must exclude 0")
    return eval_function(
        ladder, params, ct, lambda x: 1.0 / x, interval, degree
    )
