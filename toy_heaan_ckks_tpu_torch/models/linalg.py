"""Encrypted linear algebra: matrix x vector and matrix x matrix.

Counterpart of ``toy_heaan_ckks_tpu/models/linalg.py``, on the diagonal
matvec machinery of the bootstrap's homomorphic DFTs
(``models/bootstrap.py``): any dense n x n complex matrix (n = N/2 slots)
applied to an encrypted vector in one level, dense double-hoisted (O(n)
rotation keys) or baby-step/giant-step (O(sqrt n) keys, ``giant="auto"``).

Also fully encrypted d x d matrix products (both operands packed row-major
into d^2 = N/2 slots), Jiang-Kim-Lauter-Song (CCS 2018): permute A by sigma
and B by tau (sparse diagonal maps, one level each), then

    C = sum_{k=0}^{d-1} phi^k(sigma(A)) * psi^k(tau(B))

with phi^k a column shift (two masked rotations) and psi^k a row shift
(one rotation by k*d): d ct x ct multiplies, depth 3. Every rotation fan
shares one hoisted gadget decomposition
(``CkksEngine.rotate_hoisted`` / ``rotate_weighted_sum_hoisted``). The
rotation keys of a fan are drawn together (``BootstrapKeys.rot_keys``),
in the order the reference draws them one by one.
"""

from __future__ import annotations

import math

import numpy as np

from ..engine import SCALE_MATCH_TOL, CkksEngine
from ..errors import CkksError
from ..types import Ciphertext
from .algorithms import align_level
from .bootstrap import BootstrapKeys, _matvec

__all__ = [
    "matrix_diagonals",
    "encrypted_matvec",
    "encrypted_matmul",
    "encrypted_transpose",
    "MatvecKeys",
]

# the rotation-key supplier of a matvec is the bootstrap's key set
MatvecKeys = BootstrapKeys


def matrix_diagonals(m: np.ndarray) -> list[np.ndarray]:
    """Generalized diagonals of a square matrix: diag_r[i] = m[i, (i+r)%n]."""
    m = np.asarray(m)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError("matrix_diagonals: need a square matrix")
    idx = np.arange(n)
    return [m[idx, (idx + r) % n] for r in range(n)]


def encrypted_matvec(ct: Ciphertext, matrix: np.ndarray, keys: MatvecKeys,
                     encoder, giant="auto") -> Ciphertext:
    """m @ v on an encrypted v (N/2 slots = the matrix dimension), one level
    (the rescale included). ``giant``: "auto" (BSGS above 16 slots), a
    giant-step size dividing N/2, or None for the dense path."""
    n2 = ct.ctx.degree // 2
    m = np.asarray(matrix, dtype=np.complex128)
    if m.shape != (n2, n2):
        raise ValueError(
            f"encrypted_matvec: matrix must be {n2}x{n2} (N/2 slots)"
        )
    out = _matvec(ct, keys, matrix_diagonals(m), encoder, giant)
    return CkksEngine.rescale_ciphertext(out)


# ── encrypted matrix x matrix (JKLS, CCS 2018) ──────────────────────────────


def _square_dim(n2: int) -> int:
    d = math.isqrt(n2)
    if d * d != n2 or d < 2:
        raise CkksError(
            f"encrypted matmul needs d^2 = N/2 slots (got N/2 = {n2})"
        )
    return d


def _sigma_diagonals(d: int) -> dict[int, np.ndarray]:
    """sigma: out[i,j] = in[i, (i+j) mod d] on the row-major packing — 2d-1
    nonzero diagonals (offsets i and n2-d+i)."""
    n2 = d * d
    i, j = np.divmod(np.arange(n2), d)
    diags: dict[int, np.ndarray] = {}
    for off in range(d):  # rows with i + j < d sit on diagonal i
        diags[off] = ((i == off) & (i + j < d)).astype(np.float64)
    for off in range(1, d):  # wrapped half: i + j >= d
        diags[n2 - d + off] = ((i == off) & (i + j >= d)).astype(np.float64)
    return {r: v for r, v in diags.items() if v.any()}


def _tau_diagonals(d: int) -> dict[int, np.ndarray]:
    """tau: out[i,j] = in[(i+j) mod d, j] — d diagonals, offset j*d with a
    column-j indicator."""
    n2 = d * d
    j = np.arange(n2) % d
    return {col * d: (j == col).astype(np.float64) for col in range(d)}


def _transpose_diagonals(d: int) -> dict[int, np.ndarray]:
    """Transpose: out[i,j] = in[j,i] — 2d-1 diagonals at offsets
    t*(d-1) mod d^2 for t = j - i in (-(d-1), d-1)."""
    n2 = d * d
    i, j = np.divmod(np.arange(n2), d)
    return {
        (t * (d - 1)) % n2: (j - i == t).astype(np.float64)
        for t in range(-(d - 1), d)
        if ((j - i) == t).any()
    }


def _sparse_matvec(ct: Ciphertext, keys: MatvecKeys, diags: dict,
                   encoder) -> Ciphertext:
    """sum_r diag_r o rot_r(ct) over a sparse diagonal set: one hoisted
    decomposition for every nonzero offset, the r = 0 diagonal a plain
    multiply. Rescaled."""
    offs = sorted(r for r in diags if r != 0)
    acc = None
    if offs:
        rotks = keys.rot_keys(ct.level, offs)
        ext_ctx = rotks[0].ext_ctx
        pts = [encoder.encode_complex(diags[r], ext_ctx) for r in offs]
        acc = CkksEngine.rotate_weighted_sum_hoisted(ct, rotks, pts)
    if 0 in diags:
        t0 = CkksEngine.mul_plain(ct, encoder.encode_complex(diags[0], ct.ctx))
        acc = t0 if acc is None else CkksEngine.add_ciphertexts(acc, t0)
    return CkksEngine.rescale_ciphertext(acc)


def encrypted_transpose(ct: Ciphertext, keys: MatvecKeys,
                        encoder) -> Ciphertext:
    """Transpose of an encrypted row-major d x d matrix (d^2 = N/2 slots):
    one sparse diagonal permutation, one level."""
    d = _square_dim(ct.ctx.degree // 2)
    return _sparse_matvec(ct, keys, _transpose_diagonals(d), encoder)


def encrypted_matmul(ct_a: Ciphertext, ct_b: Ciphertext,
                     keys: MatvecKeys, encoder) -> Ciphertext:
    """A @ B with both d x d matrices encrypted (row-major, d^2 = N/2
    slots): depth 3, d ct x ct multiplies, each rotation fan (sigma, tau,
    the 2(d-1) column shifts, the d-1 row shifts) on one hoisted
    decomposition. Operands at the same level with matching scales."""
    if ct_a.level != ct_b.level:
        raise CkksError(
            "encrypted_matmul: operands must sit at the same level "
            f"(got {ct_a.level} and {ct_b.level}); align_level first"
        )
    if abs(ct_a.true_scale - ct_b.true_scale) > SCALE_MATCH_TOL * max(
        ct_a.true_scale, ct_b.true_scale
    ):
        raise CkksError(
            "encrypted_matmul: operand scales differ "
            f"({ct_a.true_scale:.6g} vs {ct_b.true_scale:.6g})"
        )
    n2 = ct_a.ctx.degree // 2
    d = _square_dim(n2)
    ladder, params = keys.ladder, keys.params

    a_s = _sparse_matvec(ct_a, keys, _sigma_diagonals(d), encoder)
    b_t = _sparse_matvec(ct_b, keys, _tau_diagonals(d), encoder)

    # column shifts phi^k(a_s): rotations by k (slots j < d-k) and n2-d+k
    # (slots j >= d-k), all off one decomposition
    lvl = a_s.level
    lo_off = list(range(1, d))
    hi_off = [n2 - d + k for k in range(1, d)]
    rots = CkksEngine.rotate_hoisted(a_s, keys.rot_keys(lvl, lo_off + hi_off))
    rot_lo = dict(zip(lo_off, rots[: d - 1]))
    rot_hi = dict(zip(hi_off, rots[d - 1:]))

    j = np.arange(n2) % d

    def phi(k: int) -> Ciphertext:
        if k == 0:  # a uniform one-level mask keeps the scales aligned
            t = CkksEngine.mul_plain(
                a_s, encoder.encode_complex(np.ones(n2), a_s.ctx)
            )
        else:
            m_lo = (j < d - k).astype(np.float64)
            m_hi = (j >= d - k).astype(np.float64)
            t = CkksEngine.add_ciphertexts(
                CkksEngine.mul_plain(rot_lo[k], encoder.encode_complex(m_lo, a_s.ctx)),
                CkksEngine.mul_plain(rot_hi[n2 - d + k],
                                     encoder.encode_complex(m_hi, a_s.ctx)),
            )
        return CkksEngine.rescale_ciphertext(t)

    # row shifts psi^k(b_t): one rotation by k*d each, from b_t aligned down
    # to the masked level once
    b_dn = align_level(CkksEngine(ladder.at_level(b_t.level).ctx, params), b_t,
                       lvl - 1)
    psis = [b_dn] + CkksEngine.rotate_hoisted(
        b_dn, keys.rot_keys(b_dn.level, [k * d for k in range(1, d)])
    )

    acc = None
    for k in range(d):
        pk = phi(k)
        prod = CkksEngine.mul_ciphertexts_gadget(pk, psis[k],
                                                 ladder.at_level(pk.level).rlk)
        acc = prod if acc is None else CkksEngine.add_ciphertexts(acc, prod)
    return CkksEngine.rescale_ciphertext(acc)
