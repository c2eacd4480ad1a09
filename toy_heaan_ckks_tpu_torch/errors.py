"""Typed error hierarchy of the PyTorch port.

Counterpart of ``toy_heaan_ckks_tpu/errors.py``: the same conditions raise
the same exception names; each subclasses ValueError so ``except
ValueError`` call sites keep working.
"""

from __future__ import annotations


class CkksError(ValueError):
    """Base class for all library errors."""


class InvalidDegree(CkksError):
    """Ring degree is not a power of two."""


class EmptyBasis(CkksError):
    """No RNS moduli supplied."""


class NonNttFriendlyModulus(CkksError):
    """q != 1 (mod 2N)."""


class InvalidModDrop(CkksError):
    """Dropping too many RNS channels."""


class ChannelCountMismatch(CkksError):
    """Operands built over different bases."""


class EncodingError(CkksError):
    """Encoder misuse: too many slots / degree mismatch."""


class NonReducedCoefficient(CkksError):
    """A residue >= its modulus."""


class KeyError_(CkksError):
    """Key parameter validation failures."""
