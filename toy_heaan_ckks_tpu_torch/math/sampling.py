"""Seeded coefficient samplers (host-side numpy, exact).

Counterpart of ``toy_heaan_ckks_tpu/math/sampling.py``. Randomness is an
explicit ``numpy.random.Generator`` (PCG64) passed in by the caller; the
draws are the reference's draws in the reference's order, so keys and
ciphertexts made from one seed are bit-identical in both packages.
"""

from __future__ import annotations

import numpy as np


def make_rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(seed))


def uniform_coefficients(
    degree: int, max_value: int, rng: np.random.Generator
) -> np.ndarray:
    """Uniform coefficients in [0, max_value). Returns uint64[degree]."""
    if max_value <= 0:
        raise ValueError("uniform_coefficients: max_value must be positive")
    return rng.integers(0, max_value, size=degree, dtype=np.uint64)


def gaussian_coefficients(
    degree: int, std_dev: float, rng: np.random.Generator
) -> np.ndarray:
    """Rounded Gaussian N(0, std_dev) coefficients. Returns int64[degree]."""
    if not (np.isfinite(std_dev) and std_dev > 0):
        raise ValueError("gaussian_coefficients: std_dev must be positive")
    return np.round(rng.normal(0.0, std_dev, size=degree)).astype(np.int64)


def ternary_coefficients(
    degree: int, hamming_weight: int, rng: np.random.Generator
) -> np.ndarray:
    """Ternary {-1,0,1} coefficients with exactly ``hamming_weight`` nonzeros."""
    if hamming_weight > degree:
        raise ValueError("ternary_coefficients: hamming_weight must be <= degree")
    out = np.zeros(degree, dtype=np.int64)
    support = rng.permutation(degree)[:hamming_weight]
    signs = rng.integers(0, 2, size=hamming_weight, dtype=np.int64) * 2 - 1
    out[support] = signs
    return out
