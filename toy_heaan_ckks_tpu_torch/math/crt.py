"""Exact CRT reconstruction (host-side, arbitrary precision).

Counterpart of ``toy_heaan_ckks_tpu/math/crt.py``: numpy object arrays of
Python ints, so there is no ceiling on Q. As in the reference, both
functions run through the native C++ runtime (``native/``) where it is
built; the pure-Python bodies are the fallback and the oracle, with the
same results. They run at the encode/decode boundary, never on the device
path.
"""

from __future__ import annotations

import numpy as np


def _native():
    from .. import native

    return native if native.available() else None


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
    residues = np.asarray(residues)
    nat = _native()
    if nat is not None and all(m < (1 << 63) for m in moduli):
        if residues.dtype == object:
            residues = np.array([[int(x) for x in row] for row in residues],
                                dtype=np.uint64)
        return nat.crt_reconstruct_centered(residues.astype(np.uint64), moduli)
    big_q = 1
    for m in moduli:
        big_q *= m
    acc = np.zeros(residues.shape[1], dtype=object)
    for i, (qi, qi_inv) in enumerate(crt_garner_coefficients(moduli)):
        r = residues[i].astype(object)
        acc = (acc + (r * qi_inv) % moduli[i] * qi) % big_q
    return np.where(acc > big_q // 2, acc - big_q, acc)


def to_residues(coeffs: np.ndarray, moduli: list[int]) -> np.ndarray:
    """Signed integer coefficients -> (L, N) residues in [0, q_i).

    Coefficients within int64 reduce through the native runtime (uint64
    out) where it is built, else with numpy's ``%`` by a positive modulus
    (int64 out; non-negative, like the reference's rem_euclid); wider ones
    through exact Python ints (object out)."""
    coeffs = np.asarray(coeffs)
    if coeffs.dtype == object:
        try:
            narrow = coeffs.astype(np.int64)
        except OverflowError:
            narrow = None
        if narrow is not None and (narrow.astype(object) == coeffs).all():
            coeffs = narrow
    if coeffs.dtype != object:
        c = coeffs.astype(np.int64)
        nat = _native()
        if nat is not None and all(int(m) < (1 << 63) for m in moduli):
            return nat.reduce_coeffs(c, [int(m) for m in moduli])
        return np.stack([c % np.int64(m) for m in moduli])
    out = np.empty((len(moduli), coeffs.shape[0]), dtype=object)
    for i, m in enumerate(moduli):
        out[i] = coeffs % int(m)
    return out
