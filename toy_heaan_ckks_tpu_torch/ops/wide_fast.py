"""The fused multiply + relinearize + rescale on wide chains (q < 2^63).

Counterpart of ``toy_heaan_ckks_tpu/ops/wide_fast.py`` (``_y_fold_wide``,
``mul_relin_rescale_wide``) on int64 planes (..., L, N) with R = 2^64. The
kernels of the path are K7 (``moddown_gpu.inv_ntt_fold_wide`` and
``inv_ntt_to_yhat_wide``: the inverse NTTs with folded constants, on
``ntt_gpu.ntt_planes_wide``), K6 (``keyswitch_gpu.gadget_accumulate_wide``)
and K8 (``moddown_gpu.mod_down_combine_wide``); the tensor product and the
combine glue are ``small_fast.fused_mul_relin_rescale``'s elementwise torch
ops (``ops/modular.py``'s overflow-free int64 arithmetic on these planes),
as they are plain jnp in the reference.
"""

from __future__ import annotations

from ..context import CkksContext
from .keyswitch_gpu import gadget_accumulate_wide
from .moddown_gpu import (
    inv_ntt_fold_wide, inv_ntt_to_yhat_wide, mod_down_combine_wide,
)
from .small_fast import _dec_inv_ints, fused_mul_relin_rescale


def _y_fold_wide(d_ntt, ctx: CkksContext, plan):
    """Plain decomposition residues y = mont_mul(iNTT(d), dec_inv) with
    the dec_inv multiply folded into the wide iNTT's final constant."""
    moduli = tuple(int(m) for m in ctx.moduli)
    return inv_ntt_fold_wide(d_ntt, moduli, ctx.degree,
                             _dec_inv_ints(moduli, plan.digit_size))


def mul_relin_rescale_wide(c0a, c1a, c0b, c1b, key_a, key_b,
                           ctx: CkksContext, ext_ctx: CkksContext, plan):
    """Batched multiply + hybrid gadget relin + rescale on wide planes.

    Inputs int64 (..., L, N) NTT-domain Montgomery planes; keys (D, E, N).
    Returns (out0, out1) with L-1 channels, NTT domain. The relin mod-down
    and the rescale are one division by P * q_last.
    """
    return fused_mul_relin_rescale(
        c0a, c1a, c0b, c1b, key_a, key_b, ctx, ext_ctx, plan,
        y_fold=_y_fold_wide, accumulate=gadget_accumulate_wide,
        to_yhat=inv_ntt_to_yhat_wide, mod_down=mod_down_combine_wide,
    )
