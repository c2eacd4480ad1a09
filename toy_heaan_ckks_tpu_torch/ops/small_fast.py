"""The fused multiply + relinearize + rescale on lo planes (all q < 2^31).

Counterpart of ``toy_heaan_ckks_tpu/ops/small_fast.py`` (``_fold_consts``,
``inv_ntt_fold``, ``_dec_inv_ints``, ``mul_relin_rescale_lo``). The three
kernels of the path are K1 (``ntt_gpu.ntt_planes``: the inverse NTTs with
folded constants), K2 (``keyswitch_gpu.gadget_accumulate``) and K3
(``moddown_gpu.mod_down_combine``); the tensor product and the combine
glue are elementwise int64 torch, as they are plain jnp in the reference.
``fused_mul_relin_rescale`` is that glue around any chain's kernels: the
wide composite (``wide_fast.py``) runs it too.
"""

from __future__ import annotations

import functools

import torch

from ..context import CkksContext
from . import modular as mm
from .keyswitch_gpu import gadget_accumulate
from .moddown_gpu import inv_ntt_to_yhat, mod_down_combine
from .ntt_gpu import ntt_planes


@functools.lru_cache(maxsize=128)
def _fold_consts(moduli: tuple, degree: int, post: tuple) -> tuple:
    """Folded inverse-NTT final constants N^{-1} * post_k * R^{-1} mod q_k:
    the pre-final accumulator is Mont(c * N), so one multiply emits
    mont_mul(iNTT(x), post) directly."""
    return tuple(
        pow(degree, -1, q) * (p % q) * pow(1 << 32, -1, q) % q
        for q, p in zip(moduli, post)
    )


def inv_ntt_fold(x, moduli: tuple, degree: int, post: tuple):
    """Inverse NTT with plain per-channel post-factors folded into the final
    constant: equals ``mont_mul(iNTT(x), post)`` in one K1 launch."""
    moduli = tuple(int(m) for m in moduli)
    final = _fold_consts(moduli, degree, tuple(int(p) for p in post))
    return ntt_planes(x, moduli, degree, inverse=True, final=final)


@functools.lru_cache(maxsize=128)
def _dec_inv_ints(moduli: tuple, digit_size: int) -> tuple:
    """Plain (Qhat_{t,k})^{-1} mod q_k per channel (see keys.dec_inv_ints)."""
    from ..keys import dec_inv_ints

    return dec_inv_ints(moduli, digit_size)


def _y_fold(d_ntt, ctx: CkksContext, plan):
    """Plain decomposition residues y = mont_mul(iNTT(d), dec_inv) with
    the dec_inv multiply folded into K1's final constant."""
    moduli = tuple(int(m) for m in ctx.moduli)
    return inv_ntt_fold(d_ntt, moduli, ctx.degree,
                        _dec_inv_ints(moduli, plan.digit_size))


def fused_mul_relin_rescale(c0a, c1a, c0b, c1b, key_a, key_b,
                            ctx: CkksContext, ext_ctx: CkksContext, plan, *,
                            y_fold, accumulate, to_yhat, mod_down):
    """The composite shared by small and wide chains: elementwise tensor
    product and combine glue around the chain's kernels (``y_fold``:
    decomposition inverse NTT; ``accumulate``: gadget key switch;
    ``to_yhat``: yhat inverse NTT; ``mod_down``: fused mod-down)."""
    from ..engine import _combined_down_consts

    q, rinv = ctx.chain.q, ctx.chain.rinv
    L = len(ctx.moduli)
    t0 = mm.mont_mul(c0a, c0b, q, rinv)
    t1 = mm.add_mod(mm.mont_mul(c0a, c1b, q, rinv),
                    mm.mont_mul(c1a, c0b, q, rinv), q)
    t2 = mm.mont_mul(c1a, c1b, q, rinv)

    y = y_fold(t2, ctx, plan)
    ks0, ks1 = accumulate(
        y, key_a, key_b, base_moduli=ctx.moduli, ext_moduli=ext_ctx.moduli,
        degree=ctx.degree, digit_size=plan.digit_size, d_ntt=t2,
    )

    p_mont = _combined_down_consts(ctx.moduli, ext_ctx.moduli)
    child_moduli = ctx.moduli[:-1]
    dropped = ext_ctx.moduli[L - 1 :]  # (q_last, specials...)
    Lc = L - 1
    q_last, rinv_last = q[Lc:L], rinv[Lc:L]
    p_last = torch.tensor([[p_mont[Lc]]], dtype=torch.int64, device=q.device)
    p_specials = 1
    for p in ext_ctx.moduli[L:]:
        p_specials *= p

    def combine(t, ks):
        # the dropped q_last channel of the combined numerator carries the
        # tensor term scaled by P; the special channels do not (P = 0 there)
        t_last_p = mm.mont_mul(t[..., Lc:L, :], p_last, q_last, rinv_last)
        x_drop = torch.cat(
            [mm.add_mod(t_last_p, ks[..., Lc:L, :], q_last), ks[..., L:, :]],
            dim=-2,
        )
        yhat = to_yhat(x_drop, dropped, child_moduli, ctx.degree)
        return mod_down(
            yhat, ks[..., :Lc, :], t[..., :Lc, :],
            child_moduli=child_moduli, dropped_moduli=dropped,
            degree=ctx.degree, t_scale=p_specials,
        )

    return combine(t0, ks0), combine(t1, ks1)


def mul_relin_rescale_lo(c0a, c1a, c0b, c1b, key_a, key_b,
                         ctx: CkksContext, ext_ctx: CkksContext, plan):
    """Batched multiply + hybrid gadget relin + rescale on lo planes.

    Inputs int32 (..., L, N) NTT-domain Montgomery planes; keys (D, E, N).
    Returns (out0, out1) with L-1 channels, NTT domain. The relin mod-down
    and the rescale are one division by P * q_last.
    """
    return fused_mul_relin_rescale(
        c0a, c1a, c0b, c1b, key_a, key_b, ctx, ext_ctx, plan,
        y_fold=_y_fold, accumulate=gadget_accumulate,
        to_yhat=inv_ntt_to_yhat, mod_down=mod_down_combine,
    )
