"""Coefficient-sharded fused multiply + relinearize + rescale, and rotation.

Counterpart of ``toy_heaan_ckks_tpu/parallel/coeff_composite.py``
(``build_mul_relin_rescale_coeff`` with its small branch and
``_build_wide``, ``build_rotate_coeff``): the composites over a ring whose
coefficient axis is split into the P slabs of a coefficient mesh
(``parallel/mesh.py``) for the whole call. The tensor product, the gadget
decomposition's basis extension, the key products and the mod-down's
combine are pointwise, so they run on each slab with ``ops/modular``'s
operations (jnp under GSPMD in the reference); keys are sharded on N like
the data, so each shard holds its N/P slice of the key material. The channel
NTTs are the coefficient-sharded NTT of ``coeff_ntt.py`` (the K11 cross
stages, one launch on one card, and one K10 tail per transform). The rotation's NTT-domain automorphism
permutes the whole N axis: it gathers the plane and takes each shard's
slice of the permutation (the reference's ``jnp.take``), torch glue.

The arithmetic is that of ``parallel/sharded.py``'s
``_mul_relin_rescale_arrays`` and ``_rotate_arrays`` (one division by
P * q_last in the multiply, by P in the rotation), and every residue is
canonical, so the outputs equal theirs word for word. As there, the inverse
NTTs fold the decomposition's (Qhat)^{-1} and the mod-down's (Phat)^{-1}
into their final factors. Small chains (every prime < 2^31) take int32
slabs, wide chains int64 slabs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..context import CkksContext
from ..engine import _check_key_compat, _combined_down_consts, _mod_sum, _switch_plan
from ..ops import modular as mm
from ..ops.moddown_gpu import _device_consts, _down_consts, _fold_consts_wide
from ..ops.small_fast import _dec_inv_ints, _fold_consts
from .coeff_ntt import coeff_ntt
from .mesh import CoeffMesh, unshard_planes

__all__ = ["build_mul_relin_rescale_coeff", "build_rotate_coeff"]


@dataclasses.dataclass(frozen=True)
class _Chains:
    """Host constants of one key-switch configuration on a coefficient mesh."""

    degree: int
    base: tuple  # the ciphertext's moduli (L)
    ext: tuple  # base + specials (E)
    plan: object  # engine._switch_plan
    radix_bits: int
    dec_fold: tuple  # final factors: mont_mul(iNTT(d), dec_inv) in one pass

    @staticmethod
    def build(ctx: CkksContext, ext_ctx: CkksContext, digit_size: int) -> "_Chains":
        base = tuple(int(m) for m in ctx.moduli)
        ext = tuple(int(m) for m in ext_ctx.moduli)
        if ext[: len(base)] != base:
            raise ValueError("ext_ctx must extend ctx's moduli")
        plan = _switch_plan(base, ext, digit_size)
        rbits = mm.radix_bits_of(ext)
        fold = _fold_consts if rbits == 32 else _fold_consts_wide
        return _Chains(ctx.degree, base, ext, plan, rbits,
                       fold(base, ctx.degree, _dec_inv_ints(base, plan.digit_size)))

    def chain(self, moduli: tuple, device) -> mm.ModulusChain:
        return CkksContext.build(moduli, self.degree, device).chain

    def accumulate(self, d, key_a, key_b) -> tuple:
        """Digit inner products over QP of NTT-domain slabs d (..., L, S)
        against key slabs (D, E, S): decomposition (iNTT with the dec_inv
        fold, basis extension per digit, forward NTT over QP), then
        sum_t alpha_t * key_t. Returns (ks0, ks1) slabs (..., E, S)."""
        plan, n = self.plan, self.degree
        D, g, L = plan.num_digits, plan.digit_size, len(self.base)
        y = coeff_ntt(d, self.base, n, True, self.dec_fold)
        acc = []
        for yp in y:
            ext = self.chain(self.ext, yp.device)
            if D * g > L:
                pad = yp.new_zeros(yp.shape[:-2] + (D * g - L, yp.shape[-1]))
                yp = torch.cat([yp, pad], dim=-2)
            yg = yp.reshape(yp.shape[:-2] + (D, g, yp.shape[-1]))
            ext_c = mm.column(plan.ext_c, yp.device)  # (D, g, E, 1)
            a = None
            for k in range(g):
                term = mm.mont_mul(yg[..., :, k : k + 1, :], ext_c[:, k], ext.q, ext.rinv)
                a = term if a is None else mm.add_mod(a, term, ext.q)
            acc.append(a.contiguous())
        alpha = coeff_ntt(tuple(acc), self.ext, n, False)
        ks0, ks1 = [], []
        for al, ka, kb in zip(alpha, key_a, key_b):
            ext = self.chain(self.ext, al.device)
            ks0.append(_mod_sum(mm.mont_mul(al, kb, ext.q, ext.rinv), ext.q))
            ks1.append(_mod_sum(mm.mont_mul(al, ka, ext.q, ext.rinv), ext.q))
        return tuple(ks0), tuple(ks1)

    def mod_down(self, x, kept: int) -> tuple:
        """Divide NTT-domain slabs (..., E, S) over the extended chain by the
        product of its channels [kept, E) (the specials, or q_last and the
        specials): yhat = iNTT of the dropped channels with (Phat_m)^{-1}
        folded, ext_j = sum_m yhat_m * Phat_m (Montgomery), its forward NTT,
        then (x_j - that) * P^{-1}. Returns slabs (..., kept, S)."""
        n = self.degree
        child, dropped = self.ext[:kept], self.ext[kept:]
        yfin = _down_consts(child, dropped, n, 0, self.radix_bits)[6]
        yhat = coeff_ntt(tuple(t[..., kept:, :].contiguous() for t in x),
                         dropped, n, True, yfin)
        acc = []
        for yp in yhat:
            q = self.chain(child, yp.device).q
            c64 = _device_consts(child, dropped, n, 0, yp.device, self.radix_bits).c64
            a = None
            for m in range(len(dropped)):
                term = mm.mul_mod(yp[..., m : m + 1, :], c64[m, :, None], q)
                a = term if a is None else mm.add_mod(a, term, q)
            acc.append(a.contiguous())
        ext_ntt = coeff_ntt(tuple(acc), child, n, False)
        out = []
        for xp, ep in zip(x, ext_ntt):
            q = self.chain(child, xp.device).q
            pinv = _device_consts(child, dropped, n, 0, xp.device, self.radix_bits).pinv64
            out.append(mm.mul_mod(mm.sub_mod(xp[..., :kept, :], ep, q), pinv, q))
        return tuple(out)


def _check(mesh: CoeffMesh, dtype: torch.dtype, *sharded) -> list:
    out = []
    for slabs in sharded:
        slabs = mesh.check(slabs)
        for t in slabs:
            if t.dtype != dtype:
                raise TypeError(f"slab dtype {t.dtype}, the chain's is {dtype}")
        out.append(slabs)
    return out


def build_mul_relin_rescale_coeff(mesh: CoeffMesh, ctx: CkksContext,
                                  ext_ctx: CkksContext, digit_size: int = 1):
    """fn(c0a, c1a, c0b, c1b, key_a, key_b) -> (out0, out1): the fused
    multiply + hybrid gadget relinearization + rescale on a coefficient
    mesh. Each argument is a sharded value (``mesh.shards`` slabs):
    ciphertext components (..., L, S) in the NTT domain, relin key parts
    (D, E, S); the outputs are (..., L-1, S) over ``ctx.drop_last(1)``,
    word for word ``_mul_relin_rescale_arrays`` of the whole planes."""
    ch = _Chains.build(ctx, ext_ctx, digit_size)
    L = len(ch.base)
    if L < 2:
        raise ValueError("the fused multiply needs at least two primes to rescale")
    dtype = ext_ctx.chain.dtype
    p_mont = _combined_down_consts(ch.base, ch.ext)

    def combine(t, ks):
        """(t * P + ks) / (P * q_last) on the child basis."""
        x = []
        for tp, kp in zip(t, ks):
            base = ch.chain(ch.base, tp.device)
            t_p = mm.mont_mul(tp, mm.column(p_mont, tp.device), base.q, base.rinv)
            head = mm.add_mod(t_p, kp[..., :L, :], base.q)
            x.append(torch.cat([head, kp[..., L:, :]], dim=-2))
        return ch.mod_down(tuple(x), L - 1)

    def fn(c0a, c1a, c0b, c1b, key_a, key_b):
        c0a, c1a, c0b, c1b, key_a, key_b = _check(
            mesh, dtype, c0a, c1a, c0b, c1b, key_a, key_b)
        _check_key_compat(ctx, key_a[0], ch.plan.digit_size)
        t0, t1, t2 = [], [], []
        for a0, a1, b0, b1 in zip(c0a, c1a, c0b, c1b):
            base = ch.chain(ch.base, a0.device)
            q, rinv = base.q, base.rinv
            t0.append(mm.mont_mul(a0, b0, q, rinv))
            t1.append(mm.add_mod(mm.mont_mul(a0, b1, q, rinv),
                                 mm.mont_mul(a1, b0, q, rinv), q))
            t2.append(mm.mont_mul(a1, b1, q, rinv).contiguous())
        ks0, ks1 = ch.accumulate(tuple(t2), key_a, key_b)
        return combine(t0, ks0), combine(t1, ks1)

    return fn


def build_rotate_coeff(mesh: CoeffMesh, ctx: CkksContext, ext_ctx: CkksContext,
                       perm, digit_size: int = 1):
    """fn(c0, c1, key_a, key_b) -> (c0', c1'): the rotation whose NTT-domain
    automorphism is ``perm`` (out[k] = in[perm[k]], e.g.
    ``ctx.automorphism_table_ntt(5^k mod 2N)``) followed by the gadget key
    switch of the rotated c1 with the rotation key (D, E, S) slabs; c0' =
    sigma(c0) + ks0, c1' = ks1, (..., L, S) slabs, word for word
    ``_rotate_arrays`` of the whole planes. The rotation is level-free: the
    key switch divides by P alone."""
    ch = _Chains.build(ctx, ext_ctx, digit_size)
    L = len(ch.base)
    dtype = ext_ctx.chain.dtype
    perm = torch.as_tensor(perm, dtype=torch.int64).reshape(-1)
    if perm.numel() != ctx.degree:
        raise ValueError(f"perm has {perm.numel()} entries for N = {ctx.degree}")
    s = ctx.degree // mesh.shards
    perms = tuple(perm[p * s : (p + 1) * s].to(dev) for p, dev in enumerate(mesh.devices))

    def gather(slabs):
        whole = unshard_planes(slabs)
        return tuple(whole.to(pp.device).index_select(-1, pp).contiguous()
                     for pp in perms)

    def fn(c0, c1, key_a, key_b):
        c0, c1, key_a, key_b = _check(mesh, dtype, c0, c1, key_a, key_b)
        _check_key_compat(ctx, key_a[0], ch.plan.digit_size)
        c0_rot, c1_rot = gather(c0), gather(c1)
        ks0, ks1 = ch.accumulate(c1_rot, key_a, key_b)
        ks0, ks1 = ch.mod_down(ks0, L), ch.mod_down(ks1, L)
        out0 = tuple(mm.add_mod(cp, kp, ch.chain(ch.base, cp.device).q)
                     for cp, kp in zip(c0_rot, ks0))
        return out0, ks1

    return fn
