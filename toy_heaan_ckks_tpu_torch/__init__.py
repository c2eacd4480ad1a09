"""toy_heaan_ckks_tpu_torch — the PyTorch/CUDA port of ``toy_heaan_ckks_tpu``.

First slice: the fused CKKS multiply (keygen -> encrypt -> multiply with
hybrid gadget relinearization and rescale -> decrypt) on small-prime
chains (all q < 2^31). Module paths and names follow the JAX package;
each module's docstring names its counterpart. Residues are int32 lo
planes (..., L, N) in Montgomery form (R = 2^32), NTT-resident in the
reference's tree order, bit-identical to the reference's uint32 limbs.
The three TPU kernels of the path are CUDA kernels for sm_90a
(``csrc/``), each with a plain torch twin that CPU tensors use.
"""

from .context import CkksContext
from .encoding.encoder import CkksEncoder
from .engine import CkksEngine, CkksParams
from .keys import PublicKey, RnsGadgetRelinKey, SecretKey, SecretKeyParams
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
    "RnsGadgetRelinKey",
    "SecretKey",
    "SecretKeyParams",
    "generate_primes",
]
