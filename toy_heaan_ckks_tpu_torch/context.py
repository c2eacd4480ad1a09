"""CkksContext: the static parameters of one RNS level on one device.

Counterpart of ``toy_heaan_ckks_tpu/context.py``. A context holds the
chain's constants and NTT tables as tensors on its device (the card unless
the caller asks for the CPU); ``build`` caches
one context per (moduli, degree, device), and dropping a level gives the
(cached) context of the shorter chain on the same device. The
automorphism tables of rotations and conjugation are built on the host
and cached per exponent as index tensors on the context's device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .ops.modular import ModulusChain
from .ops.ntt import NttTables


def canonical_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, raising where there is none;
    ``"cuda"`` -> ``cuda:<current>``, so cache keys match tensor devices."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class CkksContext:
    """All static data needed to operate on polynomials at one RNS level."""

    degree: int
    moduli: tuple[int, ...]
    device: torch.device
    chain: ModulusChain
    ntt: NttTables

    @staticmethod
    @functools.lru_cache(maxsize=128)
    def _build_cached(moduli: tuple[int, ...], degree: int,
                      device: torch.device) -> "CkksContext":
        return CkksContext(
            degree=degree,
            moduli=moduli,
            device=device,
            chain=ModulusChain.build(moduli, device),
            ntt=NttTables.build(moduli, degree, device),
        )

    @staticmethod
    def build(moduli, degree: int, device=None) -> "CkksContext":
        """Context for ``moduli`` (NTT-friendly primes < 2^63) at ``degree``
        with its tables on ``device`` (default: the current CUDA device;
        there is no fallback to the CPU, which must be asked for)."""
        return CkksContext._build_cached(
            tuple(int(m) for m in moduli), degree, canonical_device(device)
        )

    @property
    def num_channels(self) -> int:
        return len(self.moduli)

    def drop_last(self, count: int = 1) -> "CkksContext":
        from .errors import InvalidModDrop

        if count >= len(self.moduli):
            raise InvalidModDrop("drop_last: cannot drop all channels")
        return CkksContext.build(self.moduli[:-count], self.degree, self.device)

    def slice_channels(self, start: int, stop: int) -> "CkksContext":
        """Context for a contiguous channel slice, same device."""
        return CkksContext.build(self.moduli[start:stop], self.degree, self.device)

    def total_bits(self) -> int:
        return self.chain.total_bits()

    # ── automorphism tables (host-built, cached per exponent) ────────────

    @functools.lru_cache(maxsize=256)
    def automorphism_table(self, exponent: int):
        """(src, negate) for X -> X^exponent on coefficient-domain data:
        out[j] = (-1)^negate[j] * in[src[j]]; int64 (N,) and bool (N,)
        tensors on the context's device."""
        src, neg = _automorphism_gather(self.degree, exponent)
        return (torch.from_numpy(src).to(self.device),
                torch.from_numpy(neg).to(self.device))

    @functools.lru_cache(maxsize=256)
    def automorphism_table_ntt(self, exponent: int) -> torch.Tensor:
        """NTT-domain automorphism as a pure slot permutation: slot k of the
        tree-order NTT holds p(psi^{E_k}), and sigma_e(p) there is
        p(psi^{e*E_k}), another slot. out[k] = in[perm[k]]; int64 (N,)
        on the context's device."""
        return torch.from_numpy(_automorphism_perm(self.degree, exponent)).to(
            self.device)


def _odd_exponent(degree: int, exponent: int) -> int:
    e = exponent % (2 * degree)
    if e % 2 == 0:
        raise ValueError("automorphism exponent must be odd")
    return e


@functools.lru_cache(maxsize=256)
def _automorphism_gather(degree: int, exponent: int):
    """Host (src, negate) arrays of X -> X^exponent (the reference's
    scatter i -> i*e mod 2N, inverted into a gather)."""
    n, e = degree, _odd_exponent(degree, exponent)
    i = np.arange(n, dtype=np.int64)
    jf = i * e % (2 * n)
    src = np.empty(n, np.int64)
    neg = np.empty(n, bool)
    src[jf % n] = i
    neg[jf % n] = jf >= n
    return src, neg


@functools.lru_cache(maxsize=256)
def _automorphism_perm(degree: int, exponent: int) -> np.ndarray:
    """Host NTT-domain permutation of X -> X^exponent (tree order)."""
    from .ops.ntt import tree_leaf_exponents

    n, e = degree, _odd_exponent(degree, exponent)
    exps = np.array(tree_leaf_exponents(n), dtype=np.int64)
    idx_of = np.empty(2 * n, np.int64)
    idx_of[exps] = np.arange(n)
    return idx_of[exps * e % (2 * n)]
