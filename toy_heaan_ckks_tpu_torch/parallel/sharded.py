"""Batched homomorphic step functions (single device).

Counterpart of ``toy_heaan_ckks_tpu/parallel/sharded.py``:
``_mul_relin_rescale_arrays``, ``batched_mul_relin_rescale`` and the
single-device body of ``build_rotate`` (``_rotate_arrays``, with
``batched_rotate`` as its batched entry point). The batch is a leading
axis that flows through every kernel; the reference's mesh sharding is a
later slice.
"""

from __future__ import annotations

from ..context import CkksContext


def _mul_relin_rescale_arrays(c0a, c1a, c0b, c1b, key_a, key_b,
                              ctx: CkksContext, ext_ctx: CkksContext,
                              child_ctx: CkksContext, digit_size: int = 1):
    """One fused (batched) multiply + relinearize + rescale on raw planes.

    Input: (B, L, N) NTT-domain Montgomery residues; keys (D, E, N); all
    of the extended chain's dtype. Output: (B, L-1, N) over ``child_ctx``.
    The relinearization mod-down and the ciphertext rescale are one
    division by P * q_last. The chain's width picks the composite: small
    (every prime < 2^31, int32, R = 2^32) -> ``small_fast``, wide (int64,
    R = 2^64) -> ``wide_fast``.
    """
    from ..engine import _check_key_compat, _switch_plan
    from ..ops import small_fast as sf
    from ..ops import wide_fast as wf

    _check_key_compat(ctx, key_a, digit_size)
    if child_ctx.moduli != ctx.moduli[:-1]:
        raise ValueError("child_ctx must be ctx without its last prime")
    plan = _switch_plan(ctx.moduli, ext_ctx.moduli, digit_size)
    fused = (sf.mul_relin_rescale_lo if ext_ctx.chain.small
             else wf.mul_relin_rescale_wide)
    return fused(c0a, c1a, c0b, c1b, key_a, key_b, ctx, ext_ctx, plan)


def batched_mul_relin_rescale(ct_batch_a, ct_batch_b, rlk, ctx, child_ctx):
    """Unsharded batched step: ``ct_batch_*`` = (c0 stack, c1 stack)."""
    return _mul_relin_rescale_arrays(
        *ct_batch_a, *ct_batch_b, rlk.a, rlk.b, ctx, rlk.ext_ctx, child_ctx,
        digit_size=rlk.digit_size,
    )


def _rotate_arrays(c0, c1, key_a, key_b, perm, ctx: CkksContext,
                   ext_ctx: CkksContext, digit_size: int = 1):
    """One (batched) rotation on raw planes: the NTT-domain automorphism as a
    slot gather (``perm`` = ``ctx.automorphism_table_ntt(5^k mod 2N)``),
    the gadget key switch of the gathered c1, and c0' = sigma(c0) + ks0.
    Planes (B, L, N); keys (D, E, N). Returns (c0', c1'), (B, L, N)."""
    from ..engine import _gadget_key_switch
    from ..ops import modular as mm

    c0_rot = c0.index_select(-1, perm)
    c1_rot = c1.index_select(-1, perm)
    ks0, ks1 = _gadget_key_switch(c1_rot, key_a, key_b, ctx, ext_ctx, digit_size)
    return mm.add_mod(c0_rot, ks0, ctx.chain.q), ks1


def batched_rotate(ct_batch, rotk, ctx: CkksContext):
    """Unsharded batched rotation by ``rotk.rotation``: ``ct_batch`` =
    (c0 stack, c1 stack) of NTT-domain planes (B, L, N)."""
    half, two_n = ctx.degree // 2, 2 * ctx.degree
    perm = ctx.automorphism_table_ntt(pow(5, rotk.rotation % half, two_n))
    return _rotate_arrays(*ct_batch, rotk.a, rotk.b, perm, ctx, rotk.ext_ctx,
                          digit_size=rotk.digit_size)
