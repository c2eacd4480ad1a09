"""NTT-friendly prime search (host-side, exact Python integers).

Counterpart of ``toy_heaan_ckks_tpu/math/primes.py``. ``is_prime`` and the
prime searches run through the native C++ runtime (``native/``) where it is
built, else through the pure-Python bodies here, with the same results.
The searches are the same deterministic walks, so the same arguments give
the same primes and the same primitive roots — the NTT domain depends on
both.
"""

from __future__ import annotations

_MILLER_RABIN_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)

_U64_MAX = (1 << 64) - 1


def _check_u64(n: int, name: str = "n") -> None:
    if not (0 <= n <= _U64_MAX):
        raise ValueError(f"{name} must fit in u64, got {n}")


def _native():
    from .. import native

    return native if native.available() else None


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin primality test for u64 inputs."""
    _check_u64(n)
    nat = _native()
    if nat is not None:
        return nat.is_prime_u64(n)
    if n in (0, 1):
        return False
    if n in (2, 3):
        return True
    if n % 2 == 0:
        return False
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MILLER_RABIN_BASES:
        if a >= n:
            continue
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def is_prime_reference(n: int) -> bool:
    """Slow-but-clear 6k +/- 1 trial-division oracle (for tests)."""
    _check_u64(n)
    if n < 2:
        return False
    if n in (2, 3):
        return True
    if n % 2 == 0 or n % 3 == 0:
        return False
    i = 5
    while i * i <= n:
        if n % i == 0 or n % (i + 2) == 0:
            return False
        i += 6
    return True


def is_ntt_friendly_prime(p: int, n: int) -> bool:
    """True when ``p`` is prime and p == 1 (mod 2n): Z_p then holds a
    primitive 2n-th root of unity, which the negacyclic NTT needs."""
    if n <= 0:
        raise ValueError("is_ntt_friendly_prime: n must be positive")
    _check_u64(2 * n, "2*n")
    return p % (2 * n) == 1 and is_prime(p)


def _snap_up_to_congruence(value: int, modulus: int) -> int:
    """Smallest v >= value with v == 1 (mod modulus)."""
    if modulus <= 1:
        raise ValueError("snap_up_to_congruence: modulus must be > 1")
    remainder = value % modulus
    if remainder == 1:
        return value
    return value + (modulus + 1 - remainder) % modulus


def _snap_down_to_congruence(value: int, modulus: int) -> int:
    delta = (value % modulus + modulus - 1) % modulus
    if delta > value:
        raise ValueError("snap_down_to_congruence: underflow")
    return value - delta


def get_first_prime_up(logq: int, n: int) -> int:
    """Smallest NTT-friendly prime p >= 2^logq (p == 1 mod 2n)."""
    if not (0 <= logq < 64):
        raise ValueError("get_first_prime_up: logq must be in [0, 64)")
    if n <= 0:
        raise ValueError("get_first_prime_up: n must be positive")
    step = 2 * n
    candidate = _snap_up_to_congruence((1 << logq) + 1, step)
    nat = _native()
    if nat is not None:
        if is_prime(candidate):
            return candidate
        p = nat.first_prime_up(candidate, step)
        if p == 0:
            raise ValueError("get_first_prime_up: u64 overflow")
        return p
    while True:
        _check_u64(candidate, "candidate")
        if is_prime(candidate):
            return candidate
        candidate += step


def get_first_prime_down(bound: int, n: int) -> int | None:
    """Largest NTT-friendly prime p < bound (p == 1 mod 2n), or None."""
    if n <= 0:
        raise ValueError("get_first_prime_down: n must be positive")
    if bound <= 2:
        return None
    step = 2 * n
    nat = _native()
    if nat is not None:
        return nat.first_prime_down(bound, step) or None
    candidate = _snap_down_to_congruence(bound - 1, step)
    while candidate > 2:
        if is_prime(candidate):
            return candidate
        candidate -= step
    return None


def generate_primes(bit_size: int, count: int, degree: int) -> list[int]:
    """``count`` distinct NTT-friendly primes of exactly ``bit_size`` bits,
    walking down from 2^bit_size - 1 in steps of 2*degree."""
    if not (4 <= bit_size <= 63):
        raise ValueError("generate_primes: bit_size must be in [4, 63]")
    if count <= 0:
        raise ValueError("generate_primes: count must be positive")
    if degree <= 0:
        raise ValueError("generate_primes: degree must be positive")
    lower_bound = 1 << (bit_size - 1)
    primes: list[int] = []
    cursor = get_first_prime_down(1 << bit_size, degree)
    while cursor is not None and cursor >= lower_bound and len(primes) < count:
        primes.append(cursor)
        cursor = get_first_prime_down(cursor, degree)
    if len(primes) != count:
        raise ValueError(
            f"generate_primes: unable to find {count} NTT primes with "
            f"{bit_size}-bit ceiling for degree {degree}"
        )
    return primes


def mod_inverse(a: int, m: int) -> int:
    """Modular inverse by Python's exact pow (raises if not coprime)."""
    return pow(a, -1, m)


def distinct_prime_factors(value: int) -> list[int]:
    factors = []
    d = 2
    v = value
    while d * d <= v:
        if v % d == 0:
            factors.append(d)
            while v % d == 0:
                v //= d
        d += 1
    if v > 1:
        factors.append(v)
    return factors


def find_primitive_root(modulus: int, order: int) -> int:
    """Primitive ``order``-th root of unity in Z_modulus (order | modulus-1).

    Deterministic: scans candidates 2, 3, ... exactly as the reference."""
    if (modulus - 1) % order != 0:
        raise ValueError(
            f"find_primitive_root: {order} does not divide {modulus} - 1"
        )
    exponent = (modulus - 1) // order
    factors = distinct_prime_factors(order)
    for candidate in range(2, modulus):
        root = pow(candidate, exponent, modulus)
        if root == 1:
            continue
        if all(pow(root, order // f, modulus) != 1 for f in factors):
            return root
    raise ValueError(
        f"find_primitive_root: no root for modulus {modulus}, order {order}"
    )
