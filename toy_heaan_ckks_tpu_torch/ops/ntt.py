"""Negacyclic NTT over Z_q[X]/(X^N + 1): tables and the plain torch transform.

Counterpart of ``toy_heaan_ckks_tpu/ops/ntt.py``. The transform is the
reference's CRT-tree ("tree order") NTT with the psi twist merged into the
stage twiddles: stage s (s = 0 .. log2 N - 1) runs distance-d butterflies,
d = N >> (s+1), and group g (positions [2dg, 2d(g+1))) uses the twiddle
psi^{e_s[g]} where e_s = ``tree_exponent_stages(N)[s]``. The forward
transform emits tree order; the inverse consumes it and emits natural
order. Multiplying a Montgomery-form residue by a *plain* twiddle keeps it
in Montgomery form, so the transform is transparent to the Montgomery
pipeline, exactly as in the reference.

Twiddles are kept compact: one (L, N) table per direction whose entries
[2^s, 2^{s+1}) are stage s's 2^s twiddles (entry 0 is unused). The
reference's Pallas kernel expands them to one full plane per stage only
because the TPU has no gather; a CUDA block reads the compact table.

``forward_ntt`` / ``inverse_ntt`` here are the plain int64 torch version
(the staged reshape formulation of the reference's jnp oracle) for small
(int32) and wide (int64) planes alike, through ``modular.arith``; the
CUDA kernels that replace the Pallas NTTs live in ``ntt_gpu.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..math.primes import find_primitive_root
from . import modular as mm


def tree_exponent_stages(degree: int) -> list[list[int]]:
    """Per-stage twiddle exponents e (twiddle = psi^e), tree order."""
    stages = []
    d = [degree]
    while len(d) < degree:
        stages.append([x // 2 for x in d])
        d = [e for x in d for e in (x // 2, (x // 2 + degree) % (2 * degree))]
    return stages


@functools.lru_cache(maxsize=64)
def tree_leaf_exponents(degree: int) -> tuple[int, ...]:
    """Tree-order evaluation exponents: NTT slot k holds p(psi^{E_k})."""
    d = [degree]
    while len(d) < degree:
        d = [e for x in d for e in (x // 2, (x // 2 + degree) % (2 * degree))]
    return tuple(d)


def _psi_powers(q: int, degree: int) -> np.ndarray:
    """psi^k mod q for k in [0, 2N), psi the reference's primitive 2N-th root."""
    psi = find_primitive_root(q, 2 * degree)
    out = np.empty(2 * degree, dtype=np.uint64)
    v = 1
    for k in range(2 * degree):
        out[k] = v
        v = v * psi % q
    return out


@functools.lru_cache(maxsize=4)
def _tree_exponents(degree: int) -> np.ndarray:
    """Entry 2^s + g of the compact tables: the exponent e_s[g]."""
    exps = np.zeros(degree, dtype=np.int64)
    for s, es in enumerate(tree_exponent_stages(degree)):
        exps[1 << s : 2 << s] = es
    return exps


@functools.lru_cache(maxsize=512)
def prime_twiddles(q: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """One prime's rows of the compact tables (fwd, inv), uint64 (N,):
    cached per prime, so the chains of every level share them."""
    exps = _tree_exponents(degree)
    powers = _psi_powers(q, degree)
    fwd = np.zeros(degree, dtype=np.uint64)
    inv = np.zeros(degree, dtype=np.uint64)
    fwd[1:] = powers[exps[1:]]
    inv[1:] = powers[(2 * degree - exps[1:]) % (2 * degree)]
    return fwd, inv


@functools.lru_cache(maxsize=64)
def compact_twiddles(moduli: tuple[int, ...], degree: int):
    """Host tables (fwd, inv): uint64 (L, N), entry 2^s + g = psi^{+-e_s[g]}."""
    rows = [prime_twiddles(q, degree) for q in moduli]
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


@dataclasses.dataclass(frozen=True, eq=False)
class NttTables:
    """Plain twiddles of one chain on one device, for the torch transform.

    ``fwd`` / ``inv``: int64 (L, N) compact tables; ``q``: int64 (L, 1);
    ``n_inv``: int64 (L, 1) plain N^{-1} mod q (the inverse's final factor).
    """

    degree: int
    moduli: tuple[int, ...]
    fwd: torch.Tensor
    inv: torch.Tensor
    q: torch.Tensor
    n_inv: torch.Tensor

    @staticmethod
    @functools.lru_cache(maxsize=128)
    def build(moduli: tuple[int, ...], degree: int,
              device: torch.device) -> "NttTables":
        """Tables for ``moduli`` (a tuple of ints), cached per device."""
        from ..errors import InvalidDegree, NonNttFriendlyModulus

        if degree & (degree - 1) or degree < 2:
            raise InvalidDegree("NTT degree must be a power of two >= 2")
        for q in moduli:
            if (q - 1) % (2 * degree) != 0:
                raise NonNttFriendlyModulus(
                    f"modulus {q} is not NTT-friendly for degree {degree}"
                )
        fwd, inv = compact_twiddles(moduli, degree)

        def dev(a):
            return torch.from_numpy(a.astype(np.int64)).to(device)

        return NttTables(
            degree=degree,
            moduli=moduli,
            fwd=dev(fwd),
            inv=dev(inv),
            q=dev(np.array(moduli, dtype=np.int64)[:, None]),
            n_inv=dev(
                np.array([pow(degree, -1, q) for q in moduli], np.int64)[:, None]
            ),
        )


def forward_ntt(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """Coefficient domain (natural order) -> NTT domain (tree order).

    ``x``: (..., L, N) residues (Montgomery form), int32 on a small chain
    or int64 on a wide one; the output has x's dtype. Pure function."""
    ar = mm.arith(x.dtype)
    n = tables.degree
    lead = x.shape[:-2]
    L = x.shape[-2]
    q = tables.q[:, :, None]  # (L, 1, 1)
    a = x.long().reshape(*lead, L, 1, n)
    m, t = 1, n
    while m < n:
        half = t // 2
        a4 = a.reshape(*lead, L, m, 2, half)
        w = tables.fwd[:, m : 2 * m, None]  # (L, m, 1)
        u = a4[..., 0, :]
        v = ar.mul(a4[..., 1, :], w, q)
        a = torch.stack([ar.add(u, v, q), ar.sub(u, v, q)],
                        dim=-2).reshape(*lead, L, 2 * m, half)
        m, t = 2 * m, half
    return a.reshape(*lead, L, n).to(x.dtype)


def inverse_ntt(x: torch.Tensor, tables: NttTables, final=None) -> torch.Tensor:
    """NTT domain (tree order) -> coefficient domain (natural order).

    ``final``: int64 (L, 1) plain per-channel factor applied after the
    butterflies (default N^{-1}; the fused paths fold more into it)."""
    ar = mm.arith(x.dtype)
    n = tables.degree
    lead = x.shape[:-2]
    L = x.shape[-2]
    q = tables.q[:, :, None]
    a = x.long().reshape(*lead, L, n, 1)
    m, t = n, 1
    while m > 1:
        m //= 2
        a4 = a.reshape(*lead, L, m, 2, t)
        c0 = a4[..., 0, :]
        c1 = a4[..., 1, :]
        u = ar.add(c0, c1, q)
        v = ar.mul(ar.sub(c0, c1, q), tables.inv[:, m : 2 * m, None], q)
        a = torch.cat([u, v], dim=-1)
        t *= 2
    fin = tables.n_inv if final is None else final
    return ar.mul(a.reshape(*lead, L, n), fin, tables.q).to(x.dtype)
