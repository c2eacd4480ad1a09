"""The fused multiply and the key switch on lo planes (all q < 2^31).

Counterpart of ``toy_heaan_ckks_tpu/ops/small_fast.py`` (``_use_mxu``,
``ntt_lo``, ``_fold_consts``, ``inv_ntt_fold``, ``_dec_inv_ints``,
``rescale_ntt_lo``, ``mod_down_lo``, ``mul_relin_rescale_lo``,
``key_switch_lo``). The kernels are K1 (``ntt_gpu.ntt_planes``: the
inverse NTTs with folded constants), K2 (``keyswitch_gpu.gadget_accumulate``)
and K3 / K3' (``moddown_gpu.mod_down_combine`` with / without t); the
tensor product and the combine glue are elementwise int64 torch, as they
are plain jnp in the reference. With ``CKKS_NTT_MXU=1`` (read on every
call) ``ntt_lo`` and ``inv_ntt_fold`` run K9
(``ntt_mxu_gpu.ntt_mxu_planes``) instead of K1 where ``supported_mxu``
holds, as the reference routes them to its matrix-product kernel; the
words are the same. ``fused_mul_relin_rescale``, ``key_switch`` and
``mod_down_by_p`` are that glue around any chain's kernels: the wide
composites (``wide_fast.py``) and the engine's hoisted rotations run them
too. ``mod_down_lo`` (the staged division by P: inverse fold, Phat sum,
forward NTT) gives the same words as ``mod_down_by_p`` on K1 and K3'; the
engine's mod-down runs it under ``CKKS_NTT_MXU=1`` only.
"""

from __future__ import annotations

import functools
import os

import torch

from ..context import CkksContext
from . import modular as mm
from .keyswitch_gpu import gadget_accumulate
from .moddown_gpu import inv_ntt_to_yhat, mod_down_combine
from .ntt_gpu import ntt_planes
from .ntt_mxu import supported_mxu
from .ntt_mxu_gpu import ntt_mxu_planes


def _use_mxu(moduli, degree: int) -> bool:
    """The opt-in matrix-product NTT (``CKKS_NTT_MXU=1``, read on every
    call) where ``supported_mxu`` holds."""
    return (os.environ.get("CKKS_NTT_MXU") == "1"
            and supported_mxu(degree, moduli))


def ntt_lo(x, moduli: tuple, degree: int, inverse: bool):
    """NTT of int32 (..., L, N) planes: forward, or inverse with N^{-1}
    (Montgomery out). K9 under ``_use_mxu``, else K1."""
    moduli = tuple(int(m) for m in moduli)
    if _use_mxu(moduli, degree):
        return ntt_mxu_planes(x, moduli, degree, inverse)
    return ntt_planes(x, moduli, degree, inverse)


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
    constant: equals ``mont_mul(iNTT(x), post)`` in one launch (K9 under
    ``_use_mxu``, else K1)."""
    moduli = tuple(int(m) for m in moduli)
    post = tuple(int(p) for p in post)
    if _use_mxu(moduli, degree):
        return ntt_mxu_planes(x, moduli, degree, True, post)
    final = _fold_consts(moduli, degree, post)
    return ntt_planes(x, moduli, degree, inverse=True, final=final)


@functools.lru_cache(maxsize=128)
def _dec_inv_ints(moduli: tuple, digit_size: int) -> tuple:
    """Plain (Qhat_{t,k})^{-1} mod q_k per channel (see keys.dec_inv_ints)."""
    from ..keys import dec_inv_ints

    return dec_inv_ints(moduli, digit_size)


def _y_fold(d_ntt, ctx: CkksContext, plan):
    """Plain decomposition residues y = mont_mul(iNTT(d), dec_inv) with
    the dec_inv multiply folded into the inverse (``inv_ntt_fold``)."""
    moduli = tuple(int(m) for m in ctx.moduli)
    return inv_ntt_fold(d_ntt, moduli, ctx.degree,
                        _dec_inv_ints(moduli, plan.digit_size))


def rescale_ntt_lo(x, ctx: CkksContext):
    """NTT-domain exact rescale of int32 planes, (..., L, N) ->
    (..., L-1, N): the dropped channel's inverse NTT with its
    de-Montgomery folded in (post 1), read back as Montgomery residues of
    each kept channel, their forward NTT, then (x - that) * q_last^{-1}."""
    num = x.shape[-2]
    moduli = tuple(int(m) for m in ctx.moduli[:num])
    q_last, kept = moduli[-1], moduli[:-1]
    chain = ctx.chain
    q, rmod = chain.q[: num - 1], chain.rmod[: num - 1]
    plain = inv_ntt_fold(x[..., num - 1 :, :], (q_last,), ctx.degree, (1,))
    mont = mm.mul_mod(plain.expand(*x.shape[:-2], num - 1, x.shape[-1]), rmod, q)
    x_ntt = ntt_lo(mont, kept, ctx.degree, False)
    diff = mm.sub_mod(x[..., : num - 1, :], x_ntt, q)
    qlast_inv = mm.column(tuple(pow(q_last % qi, -1, qi) for qi in kept),
                          x.device)
    return mm.mul_mod(diff, qlast_inv, q)


def mod_down_lo(x, ctx: CkksContext, ext_ctx: CkksContext):
    """Divide NTT-domain int32 planes over QP by P, (..., E, N) ->
    (..., L, N), staged as the reference's: yhat = mont_mul(iNTT(x_sp),
    (Phat_m)^{-1}) (one fold launch), ext_j = sum_m yhat_m * Phat_m mod q_j
    in Montgomery form, its forward NTT, then (x_j - that) * P^{-1}. The
    Phat and P^{-1} constants are those of the fused mod-down
    (``moddown_gpu._device_consts``)."""
    from ..keys import sp_inv_ints
    from .moddown_gpu import _device_consts

    L = len(ctx.moduli)
    base = tuple(int(m) for m in ctx.moduli)
    specials = tuple(int(m) for m in ext_ctx.moduli[L:])
    q = ctx.chain.q
    consts = _device_consts(base, specials, ctx.degree, 0, x.device, 32)
    yhat = inv_ntt_fold(x[..., L:, :], specials, ctx.degree,
                        sp_inv_ints(specials))
    acc = None
    for m in range(len(specials)):
        term = mm.mul_mod(yhat[..., m : m + 1, :], consts.c64[m, :, None], q)
        acc = term if acc is None else mm.add_mod(acc, term, q)
    ext_ntt = ntt_lo(acc, base, ctx.degree, False)
    diff = mm.sub_mod(x[..., :L, :], ext_ntt, q)
    return mm.mul_mod(diff, consts.pinv64, q)


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


def mod_down_by_p(x, ctx: CkksContext, ext_ctx: CkksContext, *, to_yhat,
                  mod_down):
    """Divide NTT-domain planes over QP by P, (..., E, N) -> (..., L, N):
    the specials' yhat inverse NTT (``to_yhat``) and the t-less fused
    mod-down (``mod_down``), whose child is the whole base."""
    L = len(ctx.moduli)
    specials = ext_ctx.moduli[L:]
    yhat = to_yhat(x[..., L:, :], specials, ctx.moduli, ctx.degree)
    return mod_down(yhat, x[..., :L, :], None, child_moduli=ctx.moduli,
                    dropped_moduli=specials, degree=ctx.degree)


def key_switch(d, key_a, key_b, ctx: CkksContext, ext_ctx: CkksContext,
               plan, *, y_fold, accumulate, to_yhat, mod_down):
    """The hybrid gadget key switch shared by small and wide chains: the
    decomposition inverse NTT (``y_fold``), the gadget accumulation over QP
    with the skip-own shortcut (``accumulate``), then ``mod_down_by_p`` of
    ks0 and ks1."""
    y = y_fold(d, ctx, plan)
    ks0, ks1 = accumulate(
        y, key_a, key_b, base_moduli=ctx.moduli, ext_moduli=ext_ctx.moduli,
        degree=ctx.degree, digit_size=plan.digit_size, d_ntt=d,
    )
    return tuple(mod_down_by_p(ks, ctx, ext_ctx, to_yhat=to_yhat,
                               mod_down=mod_down) for ks in (ks0, ks1))


def key_switch_lo(d, key_a, key_b, ctx: CkksContext, ext_ctx: CkksContext,
                  plan):
    """Hybrid gadget key switch of int32 NTT-domain planes (..., L, N) over
    Q: K1 (or K9) fold -> K2 -> (K1 yhat -> K3' no-t) for ks0 and ks1. Keys
    (D, E, N); returns (ks0, ks1), int32 (..., L, N)."""
    return key_switch(
        d, key_a, key_b, ctx, ext_ctx, plan, y_fold=_y_fold,
        accumulate=gadget_accumulate, to_yhat=inv_ntt_to_yhat,
        mod_down=mod_down_combine,
    )

