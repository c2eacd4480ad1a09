"""Model-level algorithms built on the engine.

Counterpart of ``toy_heaan_ckks_tpu/models``:

- ``algorithms``: slot sums, level and scale alignment, Horner
  evaluation, encrypted std-dev.
- ``bootstrap``: modulus raising, CoeffToSlot/SlotToCoeff, EvalMod, the
  full ciphertext refresh.
- ``funceval``: smooth functions on encrypted inputs via Chebyshev fits +
  Paterson-Stockmeyer evaluation.
- ``compare``: encrypted sign / compare / abs / max / min / ReLU via
  CKK20 composite polynomials.
- ``linalg``: encrypted matrix-vector products (diagonal method,
  double-hoisted or BSGS), encrypted matrix-matrix products (JKLS, both
  operands encrypted) and transpose.
"""

from .algorithms import (  # noqa: F401
    align_level,
    encrypted_std_dev,
    eval_poly_horner,
    normalize_scale,
    sum_slots,
    sum_slots_hoisted,
)
from .bootstrap import (  # noqa: F401
    BootstrapKeys,
    bootstrap,
    coeff_to_slot,
    eval_chebyshev,
    eval_mod,
    raise_modulus,
    slot_to_coeff,
)
from .compare import (  # noqa: F401
    compare,
    eval_abs,
    eval_max,
    eval_min,
    eval_relu,
    eval_sign,
    plan_sign_iterations,
)
from .funceval import (  # noqa: F401
    chebyshev_fit,
    eval_chebyshev_ps,
    eval_exp,
    eval_function,
    eval_inverse,
    eval_sigmoid,
)
from .linalg import (  # noqa: F401
    encrypted_matmul,
    encrypted_matvec,
    encrypted_transpose,
    matrix_diagonals,
)
