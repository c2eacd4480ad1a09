"""toy_heaan_ckks_tpu_torch — the PyTorch/CUDA port of ``toy_heaan_ckks_tpu``.

Ported so far: keygen, encrypt and decrypt; the fused CKKS multiply
(hybrid gadget relinearization and rescale); rotations, conjugation and
hoisted rotation sums with hybrid key switching; the plaintext and level
ops around them; on small-prime chains (all q < 2^31: int32 planes,
R = 2^32) and wide ones (q < 2^63: int64 planes, R = 2^64). Module paths
and names follow the JAX package; each module's docstring names its
counterpart. Residues are Montgomery-form planes (..., L, N), NTT-resident
in the reference's tree order, bit-identical to the reference's uint32
limbs. The TPU kernels of these paths are CUDA kernels for sm_90a
(``csrc/``), each with a plain torch twin that CPU tensors use.
"""

from .context import CkksContext
from .encoding.encoder import CkksEncoder
from .engine import CkksEngine, CkksParams
from .keys import (
    PublicKey,
    RnsGadgetConjugationKey,
    RnsGadgetRelinKey,
    RnsGadgetRotationKey,
    SecretKey,
    SecretKeyParams,
)
from .math.primes import generate_primes
from .ops.poly import Poly
from .types import Ciphertext, Plaintext

__all__ = [
    "CkksContext",
    "CkksEncoder",
    "CkksEngine",
    "CkksParams",
    "Ciphertext",
    "Plaintext",
    "Poly",
    "PublicKey",
    "RnsGadgetConjugationKey",
    "RnsGadgetRelinKey",
    "RnsGadgetRotationKey",
    "SecretKey",
    "SecretKeyParams",
    "generate_primes",
]
