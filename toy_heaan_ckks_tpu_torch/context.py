"""CkksContext: the static parameters of one RNS level on one device.

Counterpart of ``toy_heaan_ckks_tpu/context.py``. A context holds the
chain's constants and NTT tables as tensors on its device (the card unless
the caller asks for the CPU); ``build`` caches
one context per (moduli, degree, device), and dropping a level gives the
(cached) context of the shorter chain on the same device.
"""

from __future__ import annotations

import dataclasses
import functools

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
