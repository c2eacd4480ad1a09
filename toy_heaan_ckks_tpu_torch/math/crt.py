"""Exact CRT reconstruction (host-side, arbitrary precision).

Counterpart of ``toy_heaan_ckks_tpu/math/crt.py``, pure-Python path only:
numpy object arrays of Python ints, so there is no ceiling on Q. It runs at
the encode/decode boundary, never on the device path.
"""

from __future__ import annotations

import numpy as np


def crt_garner_coefficients(moduli: list[int]) -> list[tuple[int, int]]:
    """(Q_i, Q_i^{-1} mod q_i) for direct CRT over ``moduli``."""
    q = 1
    for m in moduli:
        q *= m
    return [(q // m, pow((q // m) % m, -1, m)) for m in moduli]


def reconstruct_centered(residues: np.ndarray, moduli: list[int]) -> np.ndarray:
    """CRT-reconstruct each coefficient of an (L, N) residue matrix,
    centered in (-Q/2, Q/2]. Returns an object array of N Python ints."""
    moduli = [int(m) for m in moduli]
    big_q = 1
    for m in moduli:
        big_q *= m
    acc = np.zeros(residues.shape[1], dtype=object)
    for i, (qi, qi_inv) in enumerate(crt_garner_coefficients(moduli)):
        r = np.asarray(residues[i]).astype(object)
        acc = (acc + (r * qi_inv) % moduli[i] * qi) % big_q
    return np.where(acc > big_q // 2, acc - big_q, acc)


def to_residues(coeffs: np.ndarray, moduli: list[int]) -> np.ndarray:
    """Signed integer coefficients -> (L, N) residues in [0, q_i).

    int64 input stays int64 (numpy's ``%`` by a positive modulus is
    non-negative, like the reference's rem_euclid); anything wider goes
    through exact Python ints."""
    coeffs = np.asarray(coeffs)
    if coeffs.dtype != object:
        c = coeffs.astype(np.int64)
        return np.stack([c % np.int64(m) for m in moduli])
    out = np.empty((len(moduli), coeffs.shape[0]), dtype=object)
    for i, m in enumerate(moduli):
        out[i] = coeffs % int(m)
    return out
