"""Modulus-chain construction (host-side, exact Python integers).

Counterpart of ``toy_heaan_ckks_tpu/utils/params.py``: a first prime
~2^first_bits (decryption headroom), then ``depth`` primes as close to
2^scale_bits as possible, alternating just above and just below so that
the running product tracks q0 * Delta^i, plus the homomorphic-encryption
standard's 128-bit ceilings on log2(QP) per ring degree. Prime searches
are the pure-Python walks of ``math/primes.py``, so the same arguments give
the reference's primes.
"""

from __future__ import annotations

import dataclasses

from ..math.primes import _snap_up_to_congruence, get_first_prime_down, is_prime

# Homomorphic-encryption-standard max log2(QP) for 128-bit security
# (ternary secret).
MAX_LOGQP_128 = {
    1024: 27,
    2048: 54,
    4096: 109,
    8192: 218,
    16384: 438,
    32768: 881,
}


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    moduli: tuple[int, ...]  # first prime + depth scale primes
    scale_bits: int
    total_bits: int

    @property
    def depth(self) -> int:
        return len(self.moduli) - 1


def build_modulus_chain(
    degree: int,
    scale_bits: int,
    depth: int,
    first_bits: int | None = None,
    enforce_security: bool = False,
) -> ChainPlan:
    """Scale-matched modulus chain: [q0 ~ 2^first_bits, p1..p_depth ~ 2^scale].

    Intermediate primes alternate just-above / just-below 2^scale_bits; all
    primes are NTT-friendly for ``degree`` and distinct.
    """
    if first_bits is None:
        first_bits = min(scale_bits + 10, 60)
    used: set[int] = set()

    def take(p: int | None) -> int:
        if p is None or p == 0:
            raise ValueError("build_modulus_chain: prime search exhausted")
        return p

    q0 = take(get_first_prime_down(1 << first_bits, degree))
    used.add(q0)

    mids: list[int] = []
    go_up = True
    while len(mids) < depth:
        p = _next_distinct(scale_bits, degree, used, prefer_up=go_up)
        used.add(p)
        mids.append(p)
        go_up = not go_up

    moduli = (q0, *mids)
    total = sum(m.bit_length() for m in moduli)
    if enforce_security:
        cap = MAX_LOGQP_128.get(degree)
        if cap is not None and total > cap:
            raise ValueError(
                f"build_modulus_chain: logQ={total} exceeds the 128-bit "
                f"security cap {cap} for N={degree}"
            )
    return ChainPlan(moduli=moduli, scale_bits=scale_bits, total_bits=total)


def _next_up(start: int, degree: int) -> int | None:
    """Smallest NTT-friendly prime above ``start``, or None past 2^64."""
    cand = _snap_up_to_congruence(start + 1, 2 * degree)
    while cand < (1 << 64):
        if is_prime(cand):
            return cand
        cand += 2 * degree
    return None


def _next_distinct(scale_bits: int, degree: int, used: set,
                   prefer_up: bool) -> int:
    """Closest unused NTT prime to 2^scale_bits on the preferred side."""
    if prefer_up:
        p = _next_up(1 << scale_bits, degree)
        while p is not None and p in used:
            p = _next_up(p, degree)
        if p is not None:
            return p
    p = get_first_prime_down(1 << scale_bits, degree)
    while p is not None and p in used:
        p = get_first_prime_down(p, degree)
    if p is None:
        # fall back to the other side
        p = _next_up(1 << scale_bits, degree)
        while p is not None and p in used:
            p = _next_up(p, degree)
    if p is None:
        raise ValueError("no NTT primes available near the requested scale")
    return p
