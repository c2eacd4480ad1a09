"""toy_heaan_ckks_tpu_torch — the PyTorch/CUDA port of ``toy_heaan_ckks_tpu``.

Ported: the whole public surface of the JAX package but
``utils/serialization``, ``batching``, ``noise`` and ``profiling`` —
keygen, encrypt and decrypt; the fused CKKS multiply (hybrid gadget
relinearization and rescale) and the legacy single-pair multiply with
``CkksEngineBuilder``; rotations, conjugation and hoisted rotation sums
with hybrid key switching; the plaintext and level ops around them; the
per-level ``KeyLadder``; the batch x channel and coefficient meshes with
their sharded multiply and rotation; the models ``algorithms``,
``funceval``, ``bootstrap``, ``compare`` and ``linalg`` (``models/``);
the prime searches and the native C++ host runtime (``native``); on
small-prime chains (all q < 2^31: int32 planes, R = 2^32) and wide ones
(q < 2^63: int64 planes, R = 2^64). Module paths
and names follow the JAX package; each module's docstring names its
counterpart. Residues are Montgomery-form planes (..., L, N), NTT-resident
in the reference's tree order, bit-identical to the reference's uint32
limbs. The TPU kernels of these paths are CUDA kernels for sm_90a
(``csrc/``), each with a plain torch twin that CPU tensors use.
"""

from .context import CkksContext
from .encoding.encoder import CkksEncoder
from .engine import CkksEngine, CkksEngineBuilder, CkksParams
from .keys import (
    KeyLadder,
    PublicKey,
    RelinearizationKey,
    RnsGadgetConjugationKey,
    RnsGadgetRelinKey,
    RnsGadgetRotationKey,
    RotationKey,
    SecretKey,
    SecretKeyParams,
)
from .math.primes import (
    generate_primes,
    get_first_prime_down,
    get_first_prime_up,
    is_ntt_friendly_prime,
    is_prime,
)
from .ops.poly import Poly
from .types import Ciphertext, Plaintext
from . import native
from .utils.params import build_modulus_chain

__version__ = "0.1.0"

__all__ = [
    "CkksContext",
    "CkksEncoder",
    "CkksEngine",
    "CkksEngineBuilder",
    "CkksParams",
    "Ciphertext",
    "KeyLadder",
    "Plaintext",
    "Poly",
    "PublicKey",
    "RelinearizationKey",
    "RnsGadgetConjugationKey",
    "RnsGadgetRelinKey",
    "RnsGadgetRotationKey",
    "RotationKey",
    "SecretKey",
    "SecretKeyParams",
    "build_modulus_chain",
    "generate_primes",
    "get_first_prime_down",
    "get_first_prime_up",
    "is_ntt_friendly_prime",
    "is_prime",
    "native",
]
