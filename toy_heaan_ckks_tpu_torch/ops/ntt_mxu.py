"""K9's host side: the matrix-product (4-step) NTT's tables and its twin.

Counterpart of ``toy_heaan_ckks_tpu/ops/ntt_mxu.py`` (``supported_mxu``,
``_mxu_tables``, ``_fold_redc``, ``ntt_mxu``). The tree-order negacyclic
NTT of an N-point plane, viewed as (R, C) = ``layout(N)`` row-major, is
two modular matrix products around a twiddle twist:

    forward:  A = Wr @ X   (contract rows)    B = A (.) T    out = B @ Wc^T
    inverse:  A = X @ Wc*^T (contract lanes)  B = A (.) T*   out = Wr* @ B

with N^{-1} (and, for ``post``, the fold post * R^{-1} of
``small_fast.inv_ntt_fold``) folded into Wr*. The factorization is exact
because the tree-order exponent E_j of slot j = j1*C + j2 splits (checked
when the tables are built). Each modular product splits the data and the
matrix into 8-bit limbs, sums the limb products by limb weight,

    P_s = sum_{i+j=s} W_j @ X_i,   s = 0 .. 6   (each < 4*K*255^2 < 2^27)

and folds them as acc = sum_s P_s * (2^{8s} * 2^32 mod q) (< 2^61), then
one Montgomery reduction: the result is W @ X mod q, kept in Montgomery
form. The CUDA kernel (``csrc/ntt_mxu.cu``, wrapper
``ntt_mxu_gpu.ntt_mxu_planes``) takes the P_s from u8 tensor-core
products with s32 accumulation; ``ntt_mxu`` is the plain torch version.
Small chains only (every q < 2^31); the words equal K1's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .modular import SMALL_BOUND, shoup, word_table
from .ntt import _psi_powers, tree_leaf_exponents

LIMBS = 4  # 8-bit limbs per uint32 residue
FOLDS = 2 * LIMBS - 1  # limb weights s = i + j of the products
LANES = 128
MIN_K = 32  # the u8 MMA's depth: a row contraction pads R up to it


def layout(n: int) -> tuple[int, int]:
    """(rows, cols) of an N-point plane, cols a multiple of 128 (the
    reference's ``ntt_pallas._layout``)."""
    c = LANES
    while n // c > 512 and c < 1024:
        c *= 2
    return n // c, c


def supported_mxu(degree: int, moduli) -> bool:
    """The reference's envelope: a small chain and a power-of-two N whose
    layout has 8 <= R, C <= 256 (N in [2^10, 2^15])."""
    small = all(int(m) < SMALL_BOUND for m in moduli)
    r, c = layout(degree)
    return (small and degree == r * c and (degree & (degree - 1)) == 0
            and max(r, c) <= 256 and min(r, c) >= 8)


@dataclasses.dataclass(frozen=True, eq=False)
class MxuTables:
    """Per-channel tables of one transform on one device.

    ``w_first`` / ``w_second``: uint8 (L, LIMBS, K, K) limbs of the first
    and second product's matrix, W[out, contracted] with limb j = bits
    [8j, 8j+8); the row contraction's (Wr forward, Wr* inverse) is padded
    with zeros to K = max(R, 32), the lane contraction's is 128 x 128.
    ``t`` / ``t_shoup``: int32 (L, R*C) mid twist and Shoup companions
    floor(t * 2^32 / q); ``rs``: int32 (L, FOLDS) fold constants
    2^{8s+32} mod q; ``q``, ``qinv`` (= -q^{-1} mod 2^32): int32 (L,).
    int32 tensors carry the uint32 bits. ``rinv``: int64 (L, 1, 1)
    2^{-32} mod q (the twin's reduction)."""

    rows: int
    w_first: torch.Tensor
    w_second: torch.Tensor
    t: torch.Tensor
    t_shoup: torch.Tensor
    rs: torch.Tensor
    q: torch.Tensor
    qinv: torch.Tensor
    rinv: torch.Tensor


def _limbs(w: np.ndarray, k: int) -> torch.Tensor:
    """uint32-valued (L, a, b) -> uint8 (L, LIMBS, k, k), zero-padded."""
    out = np.zeros((w.shape[0], LIMBS, k, k), np.uint8)
    for j in range(LIMBS):
        out[:, j, : w.shape[1], : w.shape[2]] = (w >> np.uint64(8 * j)) & 0xFF
    return torch.from_numpy(out)


@functools.lru_cache(maxsize=64)
def _host_tables(moduli: tuple, degree: int, inverse: bool,
                 post: tuple | None):
    """The reference's ``_mxu_tables`` as uint64 numpy arrays:
    (w_first, w_second, t, t_shoup, rs, q, qinv)."""
    n, two_n = degree, 2 * degree
    r, c = layout(n)
    L = len(moduli)
    e = np.array(tree_leaf_exponents(n), dtype=np.int64).reshape(r, c)
    g = (e[:, 0] * c) % two_n            # Wr exponent per j1
    delta = (e[:, 0] - e[0, 0]) % two_n  # T exponent per j1
    h = e[0, :] % two_n                  # Wc exponent per j2
    # the factorization's exactness (holds for every power-of-two degree)
    assert np.all((e * c) % two_n == ((e[:, :1] * c) % two_n))
    assert np.all((e - e[0:1, :]) % two_n == ((e[:, :1] - e[0, 0]) % two_n))

    u64 = np.uint64
    wr = np.zeros((L, r, r), u64)
    wc = np.zeros((L, c, c), u64)
    t = np.zeros((L, r, c), u64)
    rs = np.zeros((L, FOLDS), u64)
    qinv = np.zeros(L, u64)
    rows, lanes = np.arange(r), np.arange(c)
    for k, qk in enumerate(moduli):
        pw = _psi_powers(qk, n)  # psi^e for e in [0, 2N)
        if not inverse:
            wr[k] = pw[(g[:, None] * rows[None, :]) % two_n]
            wc[k] = pw[(h[:, None] * lanes[None, :]) % two_n]
            t[k] = pw[(delta[:, None] * lanes[None, :]) % two_n]
        else:
            # x[n1, n2] = N^{-1} sum_j1 psi^{-g(j1) n1} T*[j1, n2]
            #             (sum_j2 psi^{-h(j2) n2} out[j1, j2]); with post the
            # output is plain mont_mul(iNTT(x), post), else Montgomery
            fold = pow(n, -1, qk)
            if post is not None:
                fold = fold * (int(post[k]) % qk) * pow(1 << 32, -1, qk) % qk
            wc[k] = pw[(-h[None, :] * lanes[:, None]) % two_n]
            wr[k] = pw[(-g[None, :] * rows[:, None]) % two_n] * u64(fold) % u64(qk)
            t[k] = pw[(-delta[:, None] * lanes[None, :]) % two_n]
        for s in range(FOLDS):
            rs[k, s] = (1 << (8 * s + 32)) % qk
        qinv[k] = (-pow(qk, -1, 1 << 32)) % (1 << 32)
    q = np.array(moduli, u64)
    t_sh = shoup(t, q[:, None, None], 32)
    w_first, w_second = (wc, wr) if inverse else (wr, wc)
    return w_first, w_second, t, t_sh, rs, q, qinv


@functools.lru_cache(maxsize=64)
def mxu_tables(moduli: tuple, degree: int, inverse: bool,
               post: tuple | None, device: torch.device) -> MxuTables:
    """K9's tables for ``moduli`` (a tuple of ints < 2^31) on ``device``,
    cached per device. ``post`` (inverse only): plain per-channel factors
    folded as in ``small_fast.inv_ntt_fold``."""
    r, _ = layout(degree)
    w1, w2, t, t_sh, rs, q, qinv = _host_tables(moduli, degree, inverse, post)
    k_rows = max(r, MIN_K)
    k1, k2 = (LANES, k_rows) if inverse else (k_rows, LANES)
    L = len(moduli)
    return MxuTables(
        rows=r,
        w_first=_limbs(w1, k1).to(device),
        w_second=_limbs(w2, k2).to(device),
        t=word_table(t.reshape(L, -1), 32).to(device),
        t_shoup=word_table(t_sh.reshape(L, -1), 32).to(device),
        rs=word_table(rs, 32).to(device),
        q=word_table(q, 32).to(device),
        qinv=word_table(qinv, 32).to(device),
        rinv=torch.tensor([pow(1 << 32, -1, m) for m in moduli],
                          dtype=torch.int64, device=device)[:, None, None],
    )


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding their uint32 values."""
    return words.long() & 0xFFFFFFFF


def _limb_planes(x: torch.Tensor) -> list:
    """int64 residues -> LIMBS float64 planes of their 8-bit limbs."""
    return [((x >> (8 * i)) & 0xFF).double() for i in range(LIMBS)]


def _fold_redc(p: list, tabs: MxuTables) -> torch.Tensor:
    """The limb-weight sums P_s (exact float64 integers < 2^27) -> the
    Montgomery residue of acc = sum_s P_s * rs[s] (< 2^61, exact in int64):
    REDC's canonical output, acc * 2^{-32} mod q."""
    rs, q = _u32(tabs.rs), _u32(tabs.q)[:, None, None]
    acc = sum(p[s].long() * rs[:, s, None, None] for s in range(FOLDS))
    return acc % q * tabs.rinv % q


def _mod_matmul(w: torch.Tensor, x: torch.Tensor, rows: bool,
                tabs: MxuTables) -> torch.Tensor:
    """W @ X mod q of int64 planes (..., L, R, C): ``rows`` contracts the
    row axis (out[a, c] = sum_b W[a, b] X[b, c]), else the lane axis
    (out[r, a] = sum_b X[r, b] W[a, b]). Every limb product is a float64
    matrix product of 8-bit integers, exact (sums < 2^53); CUDA has no
    integer matrix product for torch to call."""
    r = x.shape[-2]
    wl = [w[:, j, :r, :r].double() if rows else w[:, j].double()
          for j in range(LIMBS)]
    xl = _limb_planes(x)
    p = [None] * FOLDS
    for i in range(LIMBS):
        for j in range(LIMBS):
            d = (torch.matmul(wl[j], xl[i]) if rows
                 else torch.matmul(xl[i], wl[j].transpose(-1, -2)))
            p[i + j] = d if p[i + j] is None else p[i + j] + d
    return _fold_redc(p, tabs)


def ntt_mxu(x: torch.Tensor, moduli, degree: int, inverse: bool,
            post: tuple | None = None) -> torch.Tensor:
    """Plain torch version of K9 on any device: int32 (..., L, N) planes
    of a small chain (uint32 bits) -> the same shape, word-equal to K1
    (``ntt_gpu.ntt_planes``; with ``post``, to ``small_fast.inv_ntt_fold``).
    """
    moduli = tuple(int(m) for m in moduli)
    if post is not None:
        post = tuple(int(p) for p in post)
    tabs = mxu_tables(moduli, degree, inverse, post, x.device)
    r, c = layout(degree)
    L = len(moduli)
    lead = x.shape[:-2]
    planes = x.long().reshape(*lead, L, r, c)
    q = _u32(tabs.q)[:, None, None]
    t = _u32(tabs.t).reshape(L, r, c)
    a = _mod_matmul(tabs.w_first, planes, not inverse, tabs)
    b = a * t % q
    out = _mod_matmul(tabs.w_second, b, inverse, tabs)
    return out.reshape(*lead, L, degree).to(torch.int32)
