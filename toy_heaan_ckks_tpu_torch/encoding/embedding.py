"""Canonical-embedding transforms for CKKS encoding (numpy, host-side).

Counterpart of ``toy_heaan_ckks_tpu/encoding/embedding.py``: slot k < N/2
evaluates at psi^{5^k mod 2N} and slot N-1-k at the conjugate root
(psi = e^{i*pi/N}); encode and decode are one length-N FFT plus a twist
and a permutation each. ``special_idft`` / ``special_dft`` are the
O(N^2) Vandermonde transforms, kept as the correctness oracle.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=32)
def j_exponents(degree: int) -> np.ndarray:
    """J-ordered odd exponents e_k (k = 0..N-1) mod 2N."""
    n = degree
    two_n = 2 * n
    exps = np.empty(n, dtype=np.int64)
    val = 1
    for h in range(n // 2):
        exps[h] = val
        exps[n - 1 - h] = two_n - val
        val = (val * 5) % two_n
    return exps


@functools.lru_cache(maxsize=32)
def _fft_tables(degree: int):
    n = degree
    idx = (j_exponents(n) - 1) // 2  # position of each slot's root among odd powers
    psi_pow = np.exp(1j * np.pi * np.arange(n) / n)  # psi^i
    return idx, psi_pow


def build_conjugate_slots(values: np.ndarray, degree: int) -> np.ndarray:
    """Conjugate-symmetric N-slot vector: slot k = v_k, slot N-1-k = conj(v_k)."""
    n = degree
    values = np.asarray(values, dtype=np.complex128)
    if values.shape[-1] > n // 2:
        raise ValueError("input exceeds slot capacity")
    slots = np.zeros(n, dtype=np.complex128)
    slots[: values.shape[-1]] = values
    slots[n // 2 :] = np.conj(slots[: n // 2][::-1])
    return slots


def embed_encode(slots: np.ndarray, degree: int) -> np.ndarray:
    """Full conjugate-symmetric slot vector -> real coefficient vector."""
    n = degree
    idx, psi_pow = _fft_tables(n)
    e = np.zeros(n, dtype=np.complex128)
    e[idx] = slots
    return np.fft.fft(e) / (n * psi_pow)


def embed_decode(coeffs: np.ndarray, degree: int) -> np.ndarray:
    """Coefficient vector -> slot values (evaluations at J-ordered roots)."""
    n = degree
    idx, psi_pow = _fft_tables(n)
    evals = np.fft.ifft(np.asarray(coeffs, dtype=np.complex128) * psi_pow) * n
    return evals[idx]


def special_idft(slots: np.ndarray, degree: int) -> np.ndarray:
    """O(N^2) inverse embedding (the oracle of ``embed_encode``)."""
    n = degree
    psi = np.exp(1j * np.pi / n)
    roots = psi ** j_exponents(n)  # slot_roots[k]
    permuted = np.asarray(slots, dtype=np.complex128)[::-1]
    powers = roots[:, None] ** np.arange(n)[None, :]  # (slot, coeff)
    return (permuted @ powers) / n


def special_dft(coeffs: np.ndarray, degree: int) -> np.ndarray:
    """O(N^2) forward embedding (the oracle of ``embed_decode``)."""
    n = degree
    psi = np.exp(1j * np.pi / n)
    roots_inv = np.conj(psi ** j_exponents(n))
    powers = roots_inv[:, None] ** np.arange(n)[None, :]
    slots = powers @ np.asarray(coeffs, dtype=np.complex128)
    return slots[::-1]


def expected_dft(raised_coeffs, scale: float, degree: int) -> tuple:
    """The slots a bootstrap's CoeffToSlot leaves, and those SlotToCoeff
    then restores, for a raised plaintext of exact coefficients c:
    t_j = (c_j + i c_{j + N/2}) / scale in bit-reversed slot order, and
    the canonical embedding of c / scale (the first N/2 slots of each)."""
    n = degree
    c = np.array([float(int(v)) for v in raised_coeffs]) / scale
    n2 = n // 2
    bits = n2.bit_length() - 1
    rev = np.array([int(format(i, f"0{bits}b")[::-1], 2) for i in range(n2)])
    t = (c[:n2] + 1j * c[n2:])[rev]
    return t, embed_decode(c, n)[:n2]
