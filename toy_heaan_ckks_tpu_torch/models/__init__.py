"""Model-level algorithms built on the engine.

Counterpart of ``toy_heaan_ckks_tpu/models`` (so far ``algorithms``,
``bootstrap`` and ``funceval``):

- ``algorithms``: slot sums, level and scale alignment, Horner
  evaluation, encrypted std-dev.
- ``bootstrap``: modulus raising, CoeffToSlot/SlotToCoeff, EvalMod, the
  full ciphertext refresh.
- ``funceval``: smooth functions on encrypted inputs via Chebyshev fits +
  Paterson-Stockmeyer evaluation.
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
from .funceval import (  # noqa: F401
    chebyshev_fit,
    eval_chebyshev_ps,
    eval_exp,
    eval_function,
    eval_inverse,
    eval_sigmoid,
)
