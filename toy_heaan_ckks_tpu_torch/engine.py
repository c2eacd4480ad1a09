"""CkksEngine: keygen, encrypt/decrypt, the fused multiply, rotations.

Counterpart of ``toy_heaan_ckks_tpu/engine.py`` without the legacy
single-pair relinearization and rotation keys and without the generic
``_mod_down_ntt`` (every ported chain is small or wide, and each has its
fused mod-down). Ciphertexts are NTT-resident, and the noise-sigma
conventions are the reference's (encrypt noise sigma = error_variance,
public-key sigma 3.2, gadget-key sigma = sqrt(error_variance)).

Key switching (relinearization, rotation, conjugation) goes through
``_gadget_key_switch``, which dispatches by chain width to the fused
composites of ``ops/small_fast.py`` and ``ops/wide_fast.py``; hoisted
rotations run the generic decomposition (``_decompose_alpha``) once and
the chain's t-less fused mod-down (``_mod_down_dispatch``) per rotation or
per sum.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .context import CkksContext
from .keys import (
    PublicKey,
    RnsGadgetConjugationKey,
    RnsGadgetRelinKey,
    RnsGadgetRotationKey,
    SecretKey,
    SecretKeyParams,
)
from .ops import modular as mm
from .ops.poly import Poly, to_coeff, to_ntt
from .types import Ciphertext, Plaintext

# Relative tolerance for adding or subtracting operands whose exact
# tracked scales differ (CkksEngine._check_scale_match).
SCALE_MATCH_TOL = 1e-2


@dataclasses.dataclass(frozen=True)
class CkksParams:
    error_variance: float = 3.2
    hamming_weight: int = 0
    scale_bits: int = 30


def _mod_sum(stack: torch.Tensor, q: torch.Tensor, axis: int = -3) -> torch.Tensor:
    """Modular tree reduction over ``axis`` (the digit or rotation axis of
    (..., D, E, N) stacks)."""
    n = stack.shape[axis]
    while n > 1:
        half = n // 2
        paired = mm.add_mod(stack.narrow(axis, 0, half),
                            stack.narrow(axis, half, half), q)
        if n % 2:
            paired = torch.cat([paired, stack.narrow(axis, 2 * half, 1)], axis)
        stack, n = paired, paired.shape[axis]
    return stack.squeeze(axis)


@dataclasses.dataclass(frozen=True)
class _SwitchPlan:
    """Constants of one hybrid key-switch configuration, as host ints.

    Digit t covers prime group G_t (size <= g); its decomposition is the
    approximate basis extension y_k = d_k * (Qhat_tk)^{-1} mod q_k,
    alpha_t[j] = sum_{k in G_t} y_k * (Qhat_tk mod q_j); the division by
    P = prod(specials) is the same extension applied to the specials (the
    fused mod-down kernels build its tables themselves). The fields carry
    the reference's decomposition constants without its limb axis:

    dec_inv  (L,)        plain (Qhat_tk)^{-1} mod q_k
    ext_c    (D, g, E)   (Qhat_tk * R^2) mod q_j, zero-padded

    ``mm.column`` turns a field into a cached device column.
    """

    digit_size: int
    num_digits: int
    dec_inv: tuple
    ext_c: tuple


@functools.lru_cache(maxsize=128)
def _switch_plan(base_moduli: tuple[int, ...], ext_moduli: tuple[int, ...],
                 digit_size: int) -> _SwitchPlan:
    """Plan keyed by the key's stored ``digit_size`` (never inferred from
    the digit count: ceil(L / D) does not round-trip every digit size)."""
    from .keys import dec_inv_ints, digit_groups

    L = len(base_moduli)
    digit_size = min(digit_size, L)
    groups = digit_groups(L, digit_size)
    rbits = mm.radix_bits_of(ext_moduli)
    r2 = {q: pow(1 << rbits, 2, q) for q in ext_moduli}
    ext_c = [[[0] * len(ext_moduli) for _ in range(digit_size)] for _ in groups]
    for t, grp in enumerate(groups):
        for gi, k in enumerate(grp):
            qhat = 1
            for k2 in grp:
                if k2 != k:
                    qhat *= base_moduli[k2]
            for j, qj in enumerate(ext_moduli):
                ext_c[t][gi][j] = qhat % qj * r2[qj] % qj
    return _SwitchPlan(
        digit_size=digit_size,
        num_digits=len(groups),
        dec_inv=dec_inv_ints(base_moduli, digit_size),
        ext_c=tuple(tuple(map(tuple, rows)) for rows in ext_c),
    )


@functools.lru_cache(maxsize=128)
def _combined_down_consts(base_moduli: tuple[int, ...],
                          ext_moduli: tuple[int, ...]) -> tuple[int, ...]:
    """Montgomery(P mod q_j) per base channel (host ints), P the special
    product: the fused relin+rescale scales the tensor terms by P so they
    share the key-switch accumulator's scale before the one division by
    P * q_last. (The reference also returns a mod-down plan that only its
    generic path reads.) The Montgomery radix is the extended chain's:
    2^32 when all its primes are below 2^31, else 2^64."""
    from .ops.modular import radix_bits_of

    rbits = radix_bits_of(ext_moduli)
    p_total = 1
    for p in ext_moduli[len(base_moduli):]:
        p_total *= p
    return tuple(((p_total % q) << rbits) % q for q in base_moduli)


def _check_key_compat(ctx: CkksContext, key_a, digit_size: int):
    """The key's digit layout must match the ciphertext basis."""
    from .errors import ChannelCountMismatch
    from .keys import digit_groups

    L = len(ctx.moduli)
    groups = digit_groups(L, min(digit_size, L))
    if len(groups) != key_a.shape[-3]:
        raise ChannelCountMismatch(
            f"gadget key has {key_a.shape[-3]} digits but the ciphertext "
            f"basis (L={L}) with digit_size={digit_size} needs {len(groups)}"
        )


def _gadget_key_switch(d_ntt, key_a, key_b, ctx: CkksContext,
                       ext_ctx: CkksContext, digit_size: int):
    """Hybrid gadget key switch of NTT-domain planes (..., L, N) over Q:
    decompose into digits, raise each to QP, accumulate the digit inner
    products against the key and divide by P. The chain's width picks the
    composite: small -> ``small_fast.key_switch_lo`` (K1, K2, K3'), wide ->
    ``wide_fast.key_switch_wide`` (K7, K6, K8')."""
    from .ops import small_fast as sf
    from .ops import wide_fast as wf

    _check_key_compat(ctx, key_a, digit_size)
    plan = _switch_plan(ctx.moduli, ext_ctx.moduli, digit_size)
    switch = sf.key_switch_lo if ext_ctx.chain.small else wf.key_switch_wide
    return switch(d_ntt, key_a, key_b, ctx, ext_ctx, plan)


def _decompose_alpha(d_ntt, ctx: CkksContext, ext_ctx: CkksContext,
                     plan: _SwitchPlan):
    """NTT-domain digit decomposition of (..., L, N) raised over QP:
    (..., D, E, N). The expensive half of a key switch; hoisting computes
    it once for many keys (the decomposition commutes with automorphisms
    up to multiples of Q_t that the keys' plaintexts absorb)."""
    L, n = d_ntt.shape[-2], d_ntt.shape[-1]
    D, g = plan.num_digits, plan.digit_size
    dev = d_ntt.device
    base, ext = ctx.chain, ext_ctx.chain
    d_coeff = to_coeff(d_ntt, ctx)
    y = mm.mont_mul(d_coeff, mm.column(plan.dec_inv, dev), base.q, base.rinv)
    if D * g > L:
        pad = torch.zeros(y.shape[:-2] + (D * g - L, n), dtype=y.dtype, device=dev)
        y = torch.cat([y, pad], dim=-2)
    yg = y.reshape(y.shape[:-2] + (D, g, n))
    ext_c = mm.column(plan.ext_c, dev)  # (D, g, E, 1)
    acc = None
    for k in range(g):
        term = mm.mont_mul(yg[..., :, k : k + 1, :], ext_c[:, k], ext.q, ext.rinv)
        acc = term if acc is None else mm.add_mod(acc, term, ext.q)
    return to_ntt(acc, ext_ctx)


def _gadget_accumulate(d_ntt, key_a, key_b, ctx: CkksContext,
                       ext_ctx: CkksContext, plan: _SwitchPlan):
    """Digit inner products over QP before the division by P. Keys
    (..., D, E, N) broadcast against the decomposition of one d (a stack of
    m keys gives (m, E, N))."""
    alpha = _decompose_alpha(d_ntt, ctx, ext_ctx, plan)
    q, rinv = ext_ctx.chain.q, ext_ctx.chain.rinv
    ks0 = _mod_sum(mm.mont_mul(alpha, key_b, q, rinv), q)
    ks1 = _mod_sum(mm.mont_mul(alpha, key_a, q, rinv), q)
    return ks0, ks1


def _mod_down_dispatch(x, ctx: CkksContext, ext_ctx: CkksContext):
    """Division by P of NTT-domain planes (..., E, N) over QP through the
    chain's kernels: small K1 yhat -> K3' no-t, wide K7 yhat -> K8' no-t
    (the words of the reference's staged small ``mod_down_lo``)."""
    from .ops import moddown_gpu as mdg
    from .ops.small_fast import mod_down_by_p

    if ext_ctx.chain.small:
        kernels = dict(to_yhat=mdg.inv_ntt_to_yhat, mod_down=mdg.mod_down_combine)
    else:
        kernels = dict(to_yhat=mdg.inv_ntt_to_yhat_wide,
                       mod_down=mdg.mod_down_combine_wide)
    return mod_down_by_p(x, ctx, ext_ctx, **kernels)


def _gather_slots(x, perms):
    """out[i, ..., k] = x[i, ..., perms[i, k]] for (m, ..., N) planes."""
    idx = perms.reshape(perms.shape[:1] + (1,) * (x.dim() - 2) + perms.shape[1:])
    return torch.take_along_dim(x, idx, dim=-1)


def _hoisted_rotate_core(c0, c1, perms, keys_a_inv, keys_b_inv,
                         ctx: CkksContext, ext_ctx: CkksContext,
                         digit_size: int):
    """Hoisted rotations: one gadget decomposition of c1 for m keys.

    perm(a) * k == perm(a * perm^{-1}(k)) pointwise, and the division by P
    commutes with NTT-domain automorphisms, so the digit inner products run
    against inverse-permuted keys and each rotation pays one output gather.
    c0/c1: (L, N); perms: int64 (m, N) forward NTT-domain permutations;
    keys_*_inv: (m, D, E, N). Returns (out0, out1), (m, L, N). The
    reference's lo-plane and generic branches compute the same residues;
    here the chain's width picks the mod-down (``_mod_down_dispatch``).
    """
    _check_key_compat(ctx, keys_a_inv[0], digit_size)
    plan = _switch_plan(ctx.moduli, ext_ctx.moduli, digit_size)
    ks0, ks1 = _gadget_accumulate(c1, keys_a_inv, keys_b_inv, ctx, ext_ctx, plan)
    ks0 = _mod_down_dispatch(ks0, ctx, ext_ctx)
    ks1 = _mod_down_dispatch(ks1, ctx, ext_ctx)
    s0 = mm.add_mod(ks0, c0, ctx.chain.q)
    return _gather_slots(s0, perms), _gather_slots(ks1, perms)


def _hoisted_rotate_sum_core(c0, c1, perms, keys_a_inv, keys_b_inv,
                             ctx: CkksContext, ext_ctx: CkksContext,
                             digit_size: int, weights=None):
    """Double-hoisted rotation sum: sum_i w_i * rot_i(ct) with one gadget
    decomposition and one division by P.

    The per-rotation accumulators stay over QP, the gathers (and the
    optional weights, (m, E, N) Montgomery NTT-domain plaintexts over the
    extended basis) apply there, and one mod-down divides the sum. c0 joins
    as c0 * P on the base channels, so the result is sum_i perm_i(c0) +
    moddown(sum_i perm_i(ks0_i)). Returns (out0, out1), (L, N).
    """
    _check_key_compat(ctx, keys_a_inv[0], digit_size)
    plan = _switch_plan(ctx.moduli, ext_ctx.moduli, digit_size)
    ks0, ks1 = _gadget_accumulate(c1, keys_a_inv, keys_b_inv, ctx, ext_ctx, plan)
    L = c0.shape[-2]
    base, ext = ctx.chain, ext_ctx.chain
    p_mont = mm.column(_combined_down_consts(ctx.moduli, ext_ctx.moduli),
                       c0.device)
    c0p = mm.mont_mul(c0, p_mont, base.q, base.rinv)
    ks0 = torch.cat([mm.add_mod(ks0[..., :L, :], c0p, base.q), ks0[..., L:, :]],
                    dim=-2)

    def gsum(ks):
        g = _gather_slots(ks, perms)
        if weights is not None:
            g = mm.mont_mul(g, weights, ext.q, ext.rinv)
        return _mod_sum(g, ext.q)

    return (_mod_down_dispatch(gsum(ks0), ctx, ext_ctx),
            _mod_down_dispatch(gsum(ks1), ctx, ext_ctx))


def _relinearize(t0, t1, t2, key_a, key_b, ctx: CkksContext,
                 ext_ctx: CkksContext, digit_size: int):
    """(t0 + ks0, t1 + ks1), the key switch of t2 (the s^2 term) to s."""
    q = ctx.chain.q
    ks0, ks1 = _gadget_key_switch(t2, key_a, key_b, ctx, ext_ctx, digit_size)
    return mm.add_mod(t0, ks0, q), mm.add_mod(t1, ks1, q)


def _mul_gadget_core(c0, c1, d0, d1, key_a, key_b, ctx: CkksContext,
                     ext_ctx: CkksContext, digit_size: int):
    """Tensor product + gadget relinearization, all NTT domain."""
    q, rinv = ctx.chain.q, ctx.chain.rinv
    t1 = mm.add_mod(mm.mont_mul(c0, d1, q, rinv), mm.mont_mul(c1, d0, q, rinv), q)
    return _relinearize(mm.mont_mul(c0, d0, q, rinv), t1,
                        mm.mont_mul(c1, d1, q, rinv), key_a, key_b, ctx,
                        ext_ctx, digit_size)


def _square_gadget_core(c0, c1, key_a, key_b, ctx: CkksContext,
                        ext_ctx: CkksContext, digit_size: int):
    """Squaring form of ``_mul_gadget_core``: t1 = 2 * c0 * c1 as one
    product and one modular double (the same residues)."""
    q, rinv = ctx.chain.q, ctx.chain.rinv
    cross = mm.mont_mul(c0, c1, q, rinv)
    return _relinearize(mm.mont_mul(c0, c0, q, rinv), mm.add_mod(cross, cross, q),
                        mm.mont_mul(c1, c1, q, rinv), key_a, key_b, ctx,
                        ext_ctx, digit_size)


class CkksEngine:
    """Homomorphic engine bound to a context + parameter set."""

    def __init__(self, context: CkksContext, params: CkksParams):
        self.context = context
        self.params = params

    # ── key generation ───────────────────────────────────────────────────

    def generate_secret_key(self, rng: np.random.Generator) -> SecretKey:
        return SecretKey.generate(
            SecretKeyParams(self.params.hamming_weight), self.context, rng
        )

    def generate_public_key(self, sk: SecretKey,
                            rng: np.random.Generator) -> PublicKey:
        return PublicKey.generate(sk, 3.2, self.context, rng)

    def generate_gadget_relin_key(self, sk: SecretKey, rng: np.random.Generator,
                                  digit_size: int = 1) -> RnsGadgetRelinKey:
        return RnsGadgetRelinKey.generate(
            sk, float(np.sqrt(self.params.error_variance)), self.context, rng,
            digit_size=digit_size,
        )

    def generate_gadget_rotation_key(self, sk: SecretKey, rotation: int,
                                     rng: np.random.Generator,
                                     digit_size: int = 1) -> RnsGadgetRotationKey:
        return RnsGadgetRotationKey.generate(
            sk, rotation, float(np.sqrt(self.params.error_variance)),
            self.context, rng, digit_size=digit_size,
        )

    def generate_conjugation_key(self, sk: SecretKey, rng: np.random.Generator,
                                 digit_size: int = 1) -> RnsGadgetConjugationKey:
        return RnsGadgetConjugationKey.generate(
            sk, float(np.sqrt(self.params.error_variance)), self.context, rng,
            digit_size=digit_size,
        )

    # ── encryption / decryption ──────────────────────────────────────────

    def encrypt(self, plaintext: Plaintext, public_key: PublicKey, logq: int,
                rng: np.random.Generator) -> Ciphertext:
        ctx = self.context
        u = Poly.sample_tribits(ctx, self.params.hamming_weight, rng).to_ntt_domain()
        e0 = Poly.sample_gaussian(ctx, self.params.error_variance, rng).to_ntt_domain()
        e1 = Poly.sample_gaussian(ctx, self.params.error_variance, rng).to_ntt_domain()
        m = plaintext.poly.to_ntt_domain()
        return Ciphertext(
            c0=public_key.b * u + e0 + m,
            c1=public_key.a * u + e1,
            logp=plaintext.scale_bits, logq=logq, scale=plaintext.true_scale,
        )

    @staticmethod
    def decrypt(ciphertext: Ciphertext, secret_key: SecretKey) -> Plaintext:
        m = (ciphertext.c1.to_ntt_domain() * secret_key.poly
             + ciphertext.c0.to_ntt_domain())
        return Plaintext(
            poly=m, scale_bits=ciphertext.logp,
            slots=ciphertext.ctx.degree // 2, scale=ciphertext.true_scale,
        )

    # ── level-free homomorphic ops ───────────────────────────────────────

    @staticmethod
    def _check_scale_match(s1: float, s2: float, op: str):
        """Operands may share integer logp yet carry different exact scales
        (a rescaled ciphertext against a fresh one); adding them needs
        scales equal within SCALE_MATCH_TOL."""
        from .errors import CkksError

        if abs(s1 - s2) > SCALE_MATCH_TOL * max(abs(s1), abs(s2)):
            raise CkksError(
                f"true-scale mismatch in {op}: {s1!r} vs {s2!r} — rescale "
                f"or mul_plain_scalar one operand to match scales first"
            )

    @staticmethod
    def _check_levels(ct1: Ciphertext, ct2: Ciphertext, op: str):
        if ct1.logp != ct2.logp or ct1.logq != ct2.logq:
            raise ValueError(f"logp/logq mismatch in {op}")
        CkksEngine._check_scale_match(ct1.true_scale, ct2.true_scale, op)

    @staticmethod
    def add_ciphertexts(ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        CkksEngine._check_levels(ct1, ct2, "add_ciphertexts")
        return Ciphertext(c0=ct1.c0 + ct2.c0, c1=ct1.c1 + ct2.c1,
                          logp=ct1.logp, logq=ct1.logq, scale=ct1.scale)

    @staticmethod
    def neg_ciphertext(ct: Ciphertext) -> Ciphertext:
        return Ciphertext(c0=-ct.c0, c1=-ct.c1, logp=ct.logp, logq=ct.logq,
                          scale=ct.scale)

    @staticmethod
    def sub_ciphertexts(ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        CkksEngine._check_levels(ct1, ct2, "sub_ciphertexts")
        return Ciphertext(c0=ct1.c0 - ct2.c0, c1=ct1.c1 - ct2.c1,
                          logp=ct1.logp, logq=ct1.logq, scale=ct1.scale)

    # ── multiplication ───────────────────────────────────────────────────

    @staticmethod
    def mul_ciphertexts_gadget(ct1: Ciphertext, ct2: Ciphertext,
                               rlk: RnsGadgetRelinKey) -> Ciphertext:
        """Tensor product + hybrid gadget relinearization (no rescale);
        logp = logp1 + logp2."""
        if ct1.logq != ct2.logq:
            raise ValueError("logq mismatch in gadget multiplication")
        ctx = ct1.ctx
        c0, c1 = _mul_gadget_core(
            ct1.c0.to_ntt_domain().data, ct1.c1.to_ntt_domain().data,
            ct2.c0.to_ntt_domain().data, ct2.c1.to_ntt_domain().data,
            rlk.a, rlk.b, ctx, rlk.ext_ctx, rlk.digit_size,
        )
        return Ciphertext(
            c0=Poly(c0, ctx, True), c1=Poly(c1, ctx, True),
            logp=ct1.logp + ct2.logp, logq=ct1.logq,
            scale=ct1.true_scale * ct2.true_scale,
        )

    @staticmethod
    def square_ciphertext(ct: Ciphertext, rlk: RnsGadgetRelinKey) -> Ciphertext:
        """ct * ct with t1 = 2 * c0 * c1: the residues of
        ``mul_ciphertexts_gadget(ct, ct, rlk)`` with one product fewer."""
        ctx = ct.ctx
        c0, c1 = _square_gadget_core(
            ct.c0.to_ntt_domain().data, ct.c1.to_ntt_domain().data,
            rlk.a, rlk.b, ctx, rlk.ext_ctx, rlk.digit_size,
        )
        return Ciphertext(
            c0=Poly(c0, ctx, True), c1=Poly(c1, ctx, True),
            logp=2 * ct.logp, logq=ct.logq,
            scale=ct.true_scale * ct.true_scale,
        )

    @staticmethod
    def mul_rescale(ct1: Ciphertext, ct2: Ciphertext,
                    rlk: RnsGadgetRelinKey) -> Ciphertext:
        """Fused multiply + relinearize + rescale: one division by
        P * q_last (the engine-surface form of the batched composite)."""
        if ct1.logq != ct2.logq:
            raise ValueError("logq mismatch in gadget multiplication")
        from .parallel.sharded import _mul_relin_rescale_arrays

        ctx = ct1.ctx
        child = ctx.drop_last(1)
        o0, o1 = _mul_relin_rescale_arrays(
            ct1.c0.to_ntt_domain().data, ct1.c1.to_ntt_domain().data,
            ct2.c0.to_ntt_domain().data, ct2.c1.to_ntt_domain().data,
            rlk.a, rlk.b, ctx, rlk.ext_ctx, child, digit_size=rlk.digit_size,
        )
        q_last = ctx.moduli[-1]
        bits_dropped = q_last.bit_length()
        return Ciphertext(
            c0=Poly(o0, child, True), c1=Poly(o1, child, True),
            logp=ct1.logp + ct2.logp - bits_dropped,
            logq=ct1.logq - bits_dropped,
            scale=ct1.true_scale * ct2.true_scale / q_last,
        )

    # ── rescale ──────────────────────────────────────────────────────────

    @staticmethod
    def rescale_ciphertext(ct: Ciphertext) -> Ciphertext:
        """Drop q_last and divide by it; logp and logq lose
        bit_length(q_last) (the reference's bookkeeping)."""
        q_last = ct.ctx.moduli[-1]
        bits_dropped = q_last.bit_length()
        return Ciphertext(
            c0=ct.c0.rescale_ntt(), c1=ct.c1.rescale_ntt(),
            logp=ct.logp - bits_dropped, logq=ct.logq - bits_dropped,
            scale=ct.true_scale / q_last,
        )

    # ── rotation and conjugation ─────────────────────────────────────────

    @staticmethod
    def _automorphed(ct: Ciphertext, key, exponent: int) -> Ciphertext:
        """(sigma(c0) + ks0, ks1) for sigma: X -> X^exponent, the key switch
        of sigma(c1) back to s under ``key`` (level-free), through the
        batched rotation's body (``sharded._rotate_arrays``)."""
        from .parallel.sharded import _rotate_arrays

        ctx = ct.ctx
        c0, c1 = _rotate_arrays(
            ct.c0.to_ntt_domain().data, ct.c1.to_ntt_domain().data, key.a,
            key.b, ctx.automorphism_table_ntt(exponent), ctx, key.ext_ctx,
            key.digit_size,
        )
        return Ciphertext(c0=Poly(c0, ctx, True), c1=Poly(c1, ctx, True),
                          logp=ct.logp, logq=ct.logq, scale=ct.scale)

    @staticmethod
    def rotate_ciphertext(ct: Ciphertext, rotk: RnsGadgetRotationKey) -> Ciphertext:
        """Rotate the slots left by ``rotk.rotation``: the automorphism
        X -> X^{5^k} (k reduced mod N/2, as ``Poly.rotate_slots``) and a
        gadget key switch."""
        n = ct.ctx.degree
        return CkksEngine._automorphed(ct, rotk,
                                       pow(5, rotk.rotation % (n // 2), 2 * n))

    @staticmethod
    def conjugate_ciphertext(ct: Ciphertext,
                             cjk: RnsGadgetConjugationKey) -> Ciphertext:
        """Complex-conjugate every slot: X -> X^{2N-1} and a gadget key
        switch (Re(x) = (x + conj(x)) / 2)."""
        return CkksEngine._automorphed(ct, cjk, 2 * ct.ctx.degree - 1)

    @staticmethod
    def _hoist_prep(ct: Ciphertext, rotks):
        """Forward NTT-domain permutations (m, N) and the inverse-permuted
        key stacks (m, D, E, N), each key's pair cached in its
        ``hoist_cache``. All keys must share the extended basis and the
        digit size."""
        from .errors import CkksError

        ext_ctx = rotks[0].ext_ctx
        ds = rotks[0].digit_size
        for k in rotks[1:]:
            if k.ext_ctx.moduli != ext_ctx.moduli or k.digit_size != ds:
                raise CkksError(
                    "hoisted rotation: keys must share ext basis + digit_size"
                )
        ctx = ct.ctx
        half, two_n = ctx.degree // 2, 2 * ctx.degree
        exps = [pow(5, k.rotation % half, two_n) for k in rotks]
        perms = torch.stack([ctx.automorphism_table_ntt(e) for e in exps])

        def inv_keys(k, e):
            cached = k.hoist_cache.get("inv")
            if cached is None:
                inv_perm = ctx.automorphism_table_ntt(pow(e, -1, two_n))
                cached = (k.a.index_select(-1, inv_perm),
                          k.b.index_select(-1, inv_perm))
                k.hoist_cache["inv"] = cached
            return cached

        pairs = [inv_keys(k, e) for k, e in zip(rotks, exps)]
        keys_a = torch.stack([p[0] for p in pairs])
        keys_b = torch.stack([p[1] for p in pairs])
        return perms, keys_a, keys_b, ext_ctx, ds

    @staticmethod
    def rotate_hoisted(ct: Ciphertext, rotks) -> list[Ciphertext]:
        """Rotate one ciphertext by many offsets with one hoisted gadget
        decomposition; outputs in the order of ``rotks``. Decode-equal to
        ``rotate_ciphertext`` per key, not residue-equal."""
        rotks = list(rotks)
        if not rotks:
            return []
        ctx = ct.ctx
        perms, keys_a, keys_b, ext_ctx, ds = CkksEngine._hoist_prep(ct, rotks)
        out0, out1 = _hoisted_rotate_core(
            ct.c0.to_ntt_domain().data, ct.c1.to_ntt_domain().data,
            perms, keys_a, keys_b, ctx, ext_ctx, ds,
        )
        return [
            Ciphertext(c0=Poly(out0[i], ctx, True), c1=Poly(out1[i], ctx, True),
                       logp=ct.logp, logq=ct.logq, scale=ct.scale)
            for i in range(len(rotks))
        ]

    @staticmethod
    def rotate_sum_hoisted(ct: Ciphertext, rotks) -> Ciphertext:
        """sum_i rotate(ct, k_i) with one gadget decomposition and one
        division by P (double hoisting)."""
        rotks = list(rotks)
        if not rotks:
            raise ValueError("rotate_sum_hoisted: need at least one key")
        ctx = ct.ctx
        perms, keys_a, keys_b, ext_ctx, ds = CkksEngine._hoist_prep(ct, rotks)
        out0, out1 = _hoisted_rotate_sum_core(
            ct.c0.to_ntt_domain().data, ct.c1.to_ntt_domain().data,
            perms, keys_a, keys_b, ctx, ext_ctx, ds,
        )
        return Ciphertext(c0=Poly(out0, ctx, True), c1=Poly(out1, ctx, True),
                          logp=ct.logp, logq=ct.logq, scale=ct.scale)

    @staticmethod
    def rotate_weighted_sum_hoisted(ct: Ciphertext, rotks,
                                    pts_ext) -> Ciphertext:
        """sum_i pt_i * rotate(ct, k_i) with one decomposition and one
        division by P: the double-hoisted diagonal-method matrix-vector
        product. ``pts_ext``: one Plaintext per key, encoded over the keys'
        extended basis and sharing scale_bits. Follow with
        ``rescale_ciphertext``."""
        from .errors import CkksError

        rotks, pts_ext = list(rotks), list(pts_ext)
        if not rotks or len(rotks) != len(pts_ext):
            raise ValueError(
                "rotate_weighted_sum_hoisted: need one plaintext per key"
            )
        ctx = ct.ctx
        perms, keys_a, keys_b, ext_ctx, ds = CkksEngine._hoist_prep(ct, rotks)
        sb = pts_ext[0].scale_bits
        for pt in pts_ext:
            if pt.poly.ctx.moduli != ext_ctx.moduli:
                raise CkksError(
                    "rotate_weighted_sum_hoisted: plaintexts must be "
                    "encoded over the keys' extended basis"
                )
            if pt.scale_bits != sb:
                raise CkksError(
                    "rotate_weighted_sum_hoisted: plaintext scales differ"
                )
        weights = torch.stack([pt.poly.to_ntt_domain().data for pt in pts_ext])
        out0, out1 = _hoisted_rotate_sum_core(
            ct.c0.to_ntt_domain().data, ct.c1.to_ntt_domain().data,
            perms, keys_a, keys_b, ctx, ext_ctx, ds, weights=weights,
        )
        return Ciphertext(
            c0=Poly(out0, ctx, True), c1=Poly(out1, ctx, True),
            logp=ct.logp + sb, logq=ct.logq,
            scale=ct.true_scale * pts_ext[0].true_scale,
        )

    # ── plaintext operands ───────────────────────────────────────────────

    @staticmethod
    def mul_plain(ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        """ct x plaintext (no relinearization); logp adds."""
        p = pt.poly.to_ntt_domain()
        return Ciphertext(
            c0=ct.c0.to_ntt_domain() * p, c1=ct.c1.to_ntt_domain() * p,
            logp=ct.logp + pt.scale_bits, logq=ct.logq,
            scale=ct.true_scale * pt.true_scale,
        )

    def mul_plain_scalar(self, ct: Ciphertext, scalar: float) -> Ciphertext:
        """Multiply every slot by ``scalar``: round(scalar * 2^scale_bits) as
        the constant polynomial. Follow with ``rescale_ciphertext``."""
        ctx = ct.ctx
        coeffs = np.zeros(ctx.degree, dtype=object)
        coeffs[0] = int(round(scalar * 2.0 ** self.params.scale_bits))
        pt = Plaintext(poly=Poly.from_coeffs(coeffs, ctx),
                       scale_bits=self.params.scale_bits, slots=ctx.degree // 2)
        return self.mul_plain(ct, pt)

    @staticmethod
    def add_plain(ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        if ct.logp != pt.scale_bits:
            raise ValueError("scale mismatch in add_plain")
        CkksEngine._check_scale_match(ct.true_scale, pt.true_scale, "add_plain")
        return Ciphertext(
            c0=ct.c0.to_ntt_domain() + pt.poly.to_ntt_domain(), c1=ct.c1,
            logp=ct.logp, logq=ct.logq, scale=ct.scale,
        )
