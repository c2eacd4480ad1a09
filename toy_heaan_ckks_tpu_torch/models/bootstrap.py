"""CKKS bootstrapping: refresh an exhausted ciphertext.

Counterpart of ``toy_heaan_ckks_tpu/models/bootstrap.py``, built from the
engine's entry points, so each step runs on the device of the contexts it
is given (the card's kernels on CUDA tensors, their plain versions on CPU
ones):

1. ``raise_modulus`` — exact re-interpretation of a level-1 ciphertext
   over a fresh full basis; decryption then yields m + q0*I with a small
   integer overflow polynomial I (|I| bounded by the secret's 1-norm).
2. ``eval_chebyshev`` — Chebyshev-basis polynomial evaluation by the
   three-term recurrence (one ct x ct multiply + rescale per degree).
3. ``coeff_to_slot`` / ``slot_to_coeff`` — the homomorphic DFTs between
   coefficient and slot representations. With complex packing
   (t = c_lo + i*c_hi) each is a single linear diagonal matvec, dense
   (double-hoisted), baby-step/giant-step, or factored into FFT-stage
   groups of sparse hoisted matvecs (one level each).
4. ``eval_mod`` — approximate mod-q0 reduction by the double-angle
   exponential method: a low-degree Chebyshev fit of e^{i a u}, r
   squarings, and a conjugation to take the imaginary part (sine), with
   the optional arcsine cubic correction.
5. ``bootstrap`` — raise -> CtS -> EvalMod on the real and imaginary
   packed halves -> StC: the same message at a higher level.

The DFT matrices and fits are host numpy, copied from the reference so the
encoded diagonals come out word-equal; keys draw from the caller's
Generator in the reference's order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..context import CkksContext
from ..engine import CkksEngine
from ..errors import CkksError
from ..ops import modular as mm
from ..ops.poly import Poly
from ..types import Ciphertext

__all__ = [
    "raise_modulus",
    "eval_chebyshev",
    "BootstrapKeys",
    "coeff_to_slot",
    "slot_to_coeff",
    "eval_mod",
    "bootstrap",
]


def _raise_lo(x_plain, q0: int, target_ctx: CkksContext) -> torch.Tensor:
    """Centered lift of plain residues mod q0 into every target channel.

    x: int32 (1, N) plain values in [0, q0). Returns int64 (Lt, N) plain
    residues of the centered representative v in (-q0/2, q0/2]:
    v = x - q0 when 2x > q0 else x, reduced mod each q_j. Requires every
    q_j > q0/2 so the reduction is one conditional add (checked by the
    caller).
    """
    x = x_plain.long()  # broadcasts (1, N) against (Lt, 1)
    q_t = target_ctx.chain.q
    neg = x + (q_t - q0)  # x > q0/2: in [0, q_j)
    return torch.where(2 * x > q0, neg, x.expand(q_t.shape[0], -1))


def raise_modulus(ct: Ciphertext, target_ctx: CkksContext) -> Ciphertext:
    """Re-interpret a level-1 ciphertext over a fresh full basis.

    The coefficients of c0/c1 are lifted centered from Z_q0 to Z and
    reduced into ``target_ctx``'s RNS basis, an EXACT integer operation.
    Decrypting the result under the (extended) secret yields m + q0*I,
    |I|_inf <= (1 + ||s||_1)/2 + 1 (Cheon et al., EUROCRYPT'18, §3).
    Small chains whose every q_j exceeds q0/2 lift on the device (one
    conditional add); any other chain goes through the exact host big-int
    CRT.
    """
    ctx = ct.ctx
    if ctx.num_channels != 1:
        raise CkksError("raise_modulus: ciphertext must be at level 1")
    if target_ctx.degree != ctx.degree:
        raise CkksError("raise_modulus: ring degree mismatch")
    q0 = ctx.moduli[0]
    fast = (
        ctx.chain.small
        and target_ctx.chain.small
        and all(2 * q > q0 for q in target_ctx.moduli)
    )

    def lift(poly: Poly) -> Poly:
        if not fast:
            # to_coeffs on a level-1 poly IS the centered representative
            # in (-q0/2, q0/2]; from_coeffs reduces it into every target
            # channel exactly
            coeffs = poly.to_coeffs()
            return Poly.from_coeffs(coeffs, target_ctx).to_ntt_domain()
        data = poly.to_coeff_domain().data  # (1, N) Montgomery
        plain = mm.from_mont(data, ctx.chain)  # (1, N)
        v = _raise_lo(plain, q0, target_ctx).to(target_ctx.chain.dtype)
        mont = mm.to_mont(v, target_ctx.chain)
        return Poly(mont, target_ctx, False).to_ntt_domain()

    return Ciphertext(
        c0=lift(ct.c0),
        c1=lift(ct.c1),
        logp=ct.logp,
        logq=target_ctx.total_bits(),
        scale=ct.scale,
    )


def _mul_const(engine: CkksEngine, ct: Ciphertext, value) -> Ciphertext:
    """Multiply every slot by a (possibly complex) constant.

    Real part on the constant coefficient, imaginary part on X^{N/2}
    (which evaluates to i at every first-half slot root — see
    algorithms._add_const). Follow with ``rescale_ciphertext``."""
    from ..types import Plaintext

    ctx = ct.ctx
    v = complex(value)
    delta = 2.0 ** engine.params.scale_bits
    coeffs = np.zeros(ctx.degree, dtype=object)
    coeffs[0] = int(round(v.real * delta))
    if v.imag:
        coeffs[ctx.degree // 2] = int(round(v.imag * delta))
    pt = Plaintext(
        poly=Poly.from_coeffs(coeffs, ctx),
        scale_bits=engine.params.scale_bits,
        slots=ctx.degree // 2,
    )
    return CkksEngine.mul_plain(ct, pt)


def eval_chebyshev(ladder, params, ct: Ciphertext, coeffs) -> Ciphertext:
    """Evaluate sum_k coeffs[k] * T_k(x) on an encrypted x in [-1, 1].

    Chebyshev basis with the three-term recurrence
    T_{k+1} = 2 x T_k - T_{k-1} — numerically stable where the monomial
    conversion of a high-degree fit catastrophically cancels. One
    ct x ct multiply + rescale per degree (depth = deg, like Horner —
    ``models/algorithms.eval_poly_horner`` is the monomial twin).
    Coefficients may be complex (used by ``eval_mod``'s e^{i a u} fit).

    ``ladder``: KeyLadder covering ct's level down to level-deg.
    """
    from .algorithms import _add_const, align_level
    from .funceval import _combine

    coeffs = [complex(c) for c in coeffs]
    deg = len(coeffs) - 1
    if deg < 1:
        raise ValueError("eval_chebyshev: need degree >= 1")

    def engine_at(level):
        return CkksEngine(ladder.at_level(level).ctx, params)

    # acc = c0 + c1*x at x's scale. Branch adds/subs go through
    # funceval._combine: on mixed-width scale-matched chains
    # (build_modulus_chain) different multiply histories reach a level
    # with diverged integer logp claims even though the exact tracked
    # scales agree — _combine reconciles logp and lets the true-scale
    # check be the authority.
    t_prev = None  # T_{k-1}(x) ciphertext
    t_cur = ct  # T_1 = x
    acc = CkksEngine.rescale_ciphertext(
        _mul_const(engine_at(ct.level), ct, coeffs[1])
    )
    acc = _add_const(engine_at(acc.level), acc, coeffs[0])

    for k in range(2, deg + 1):
        # T_k = 2 x T_{k-1} - T_{k-2}
        x_al = align_level(engine_at(ct.level), ct, t_cur.level)
        rlk = ladder.at_level(t_cur.level).rlk
        t_next = CkksEngine.mul_rescale(x_al, t_cur, rlk)
        eng = engine_at(t_next.level)
        t_next = CkksEngine.add_ciphertexts(t_next, t_next)  # 2xT
        if t_prev is not None:
            t_next = _combine(engine_at, t_next, t_prev, sub=True)
        else:
            t_next = _add_const(eng, t_next, -1.0)  # T_0 = 1
        t_prev, t_cur = t_cur, t_next

        term = CkksEngine.rescale_ciphertext(
            _mul_const(engine_at(t_cur.level), t_cur, coeffs[k])
        )
        acc = _combine(engine_at, acc, term)
    return acc


# ── Stage 3: homomorphic DFTs (CoeffToSlot / SlotToCoeff) ────────────────────


@functools.lru_cache(maxsize=8)
def _cts_diagonals(degree: int):
    """Diagonals of the CtS and StC matrices (complex packing form).

    With t = c_lo + i*c_hi (all N real coefficients packed into N/2
    complex slots) both homomorphic DFTs collapse to SINGLE linear
    matvecs — the conjugate (anti-linear) half vanishes identically:

      CtS:  t = P z,   P[j,k] = 2 * zeta_k^{-j} / N      (Q = 0)
      StC:  z = A t,   A[k,j] = zeta_k^{j}

    where zeta_k = psi^{J(k)} are the first-half J-ordered slot roots
    (the encoder's slot ordering; the identity uses
    zeta_k^{N/2} = i^{J(k)} = i since J(k) = 5^k = 1 mod 4).

    Returns (P_diags, A_diags), each (N/2, N/2) complex128 with
    diags[r][k] = M[k, (k+r) mod N/2] — the rotation-r diagonal of the
    diagonal (BSGS-free) matvec method.
    """
    from ..encoding.embedding import j_exponents

    n = degree
    n2 = n // 2
    e = j_exponents(n)[:n2]
    zeta = np.exp(1j * np.pi * e / n)
    j = np.arange(n2)
    P = 2.0 * zeta[None, :] ** (-j[:, None]) / n  # (row j, col k)
    A = zeta[:, None] ** j[None, :]  # (row k, col j)
    k = np.arange(n2)

    def diags(M):
        return np.stack([M[k, (k + r) % n2] for r in range(n2)])

    return diags(P), diags(A)


class BootstrapKeys:
    """Bootstrapping key material on top of a KeyLadder.

    The dense homomorphic DFTs need rotation keys for EVERY offset
    1..N/2-1 at the two matvec levels, plus conjugation keys at the
    real/imag split and sine-extraction levels; generating those at
    every ladder level eagerly would be wasteful, so they are created
    lazily per level here (mirroring KeyLadder's lazy mode).
    """

    def __init__(self, ladder, params, rng, digit_size: int = 1,
                 evict: bool = True):
        from ..keys import KeyLadder  # noqa: F401 (typing aid)

        self.ladder = ladder
        self.params = params
        self._rng = rng
        self._std = float(params.error_variance) ** 0.5
        self.digit_size = digit_size
        # evict=True frees each matvec level's rotation keys after use
        # (minimum memory, keys regenerated per refresh); evict=False
        # keeps them for repeated refreshes, which makes warm refreshes
        # keygen-free at the cost of holding every matvec level's keys.
        self.evict = evict
        self._rot: dict[tuple[int, int], object] = {}
        self._conj: dict[int, object] = {}

    def rot_key(self, level: int, offset: int):
        """Rotation key for one ``offset`` at ``level`` (lazily cached)."""
        return self.rot_keys(level, [offset])[0]

    def rot_keys(self, level: int, offsets) -> list:
        """Rotation keys for ``offsets`` at ``level`` (lazily cached). The
        keys not cached yet draw what one ``rot_key`` call after another
        would, their uniform halves in threads
        (``RnsGadgetRotationKey.generate_many``)."""
        offsets = list(offsets)
        todo = list(dict.fromkeys(r for r in offsets if (level, r) not in self._rot))
        if todo:
            from ..keys import RnsGadgetRotationKey

            lvl = self.ladder.at_level(level)
            keys = RnsGadgetRotationKey.generate_many(
                lvl.sk, todo, self._std, lvl.ctx, self._rng,
                digit_size=self.digit_size,
            )
            self._rot.update({(level, r): k for r, k in zip(todo, keys)})
        return [self._rot[(level, r)] for r in offsets]

    def evict_level(self, level: int) -> None:
        """Drop cached rotation keys at ``level`` (no-op when
        ``evict=False``). A single factored-DFT bootstrap visits each
        matvec level once; holding every level's key set alive would
        dominate device memory at production N unless the caller opted
        into key reuse."""
        if not self.evict:
            return
        for key in [k for k in self._rot if k[0] == level]:
            del self._rot[key]

    def encoded_diags(self, diag_map: dict, offs, target_ctx, encoder):
        """Encode (and cache) the diagonal plaintexts of one matvec.

        Per-diagonal encodes are host-side big-int CRT — at N=2^13 a
        refresh touches ~150 of them across 6 matvec levels, so warm
        refresh latency is dominated by re-encoding unless cached. The
        diag dicts come from lru-cached factorizations (stable object
        identity) and target contexts from the ladder, so the cache key
        is (id(diag_map), moduli) and entries live as long as this
        BootstrapKeys object."""
        cache = getattr(self, "_pt_cache", None)
        if cache is None:
            cache = self._pt_cache = {}
        key = (id(diag_map), target_ctx.moduli, tuple(offs))
        if key not in cache:
            cache[key] = [
                encoder.encode_complex(diag_map[r], target_ctx)
                for r in offs
            ]
        return cache[key]

    def rot_map(self, level: int) -> dict:
        """Rotation keys {offset: key} for offsets 1..N/2-1 at ``level``.

        Dense-matvec key set — O(N/2) keys; the BSGS path
        (``_matvec_bsgs``) needs only O(sqrt(N)) of them via ``rot_key``.
        """
        n2 = self.ladder.at_level(level).ctx.degree // 2
        return dict(zip(range(1, n2), self.rot_keys(level, range(1, n2))))

    def conj(self, level: int):
        """Conjugation key at ``level``."""
        if level not in self._conj:
            from ..keys import RnsGadgetConjugationKey

            lvl = self.ladder.at_level(level)
            self._conj[level] = RnsGadgetConjugationKey.generate(
                lvl.sk, self._std, lvl.ctx, self._rng,
                digit_size=self.digit_size,
            )
        return self._conj[level]


def _matvec_hoisted(ct: Ciphertext, rot_map: dict, diags, encoder) -> Ciphertext:
    """sum_r diag_r o rot_r(ct): dense diagonal matvec, double-hoisted.

    All N/2-1 nonzero-offset rotations share ONE gadget decomposition
    and ONE P mod-down (engine.rotate_weighted_sum_hoisted); the r=0
    diagonal is a plain multiply folded in at matching scale. Follow
    with ``rescale_ciphertext``.
    """
    n2 = ct.ctx.degree // 2
    rotks = [rot_map[r] for r in range(1, n2)]
    ext_ctx = rotks[0].ext_ctx
    pts = [
        encoder.encode_complex(diags[r], ext_ctx) for r in range(1, n2)
    ]
    acc = CkksEngine.rotate_weighted_sum_hoisted(ct, rotks, pts)
    pt0 = encoder.encode_complex(diags[0], ct.ctx)
    return CkksEngine.add_ciphertexts(acc, CkksEngine.mul_plain(ct, pt0))


def _matvec_bsgs(
    ct: Ciphertext, bkeys: BootstrapKeys, diags, encoder, giant: int
) -> Ciphertext:
    """Baby-step/giant-step diagonal matvec: O(sqrt(n)) rotation keys.

    sum_r diag_r o rot_r(ct) regrouped as (Halevi-Shoup BSGS)

        sum_j rot_{g j}( sum_b roll(diag_{g j + b}, g j) o rot_b(ct) )

    with g = ``giant`` dividing n = N/2. The g-1 baby rotations share ONE
    hoisted gadget decomposition; each of the n/g - 1 giant steps is one
    full key switch on its inner sum. Key material drops from n-1 keys
    (dense ``_matvec_hoisted``) to (g-1) + (n/g - 1) — the difference
    between an infeasible and a practical bootstrap key set for N >= 2^10
    (at N=2^14, 8191 keys -> 180 with g=64). Follow with
    ``rescale_ciphertext``.
    """
    n2 = ct.ctx.degree // 2
    if giant <= 0 or n2 % giant:
        raise CkksError(
            f"_matvec_bsgs: giant step {giant} must divide N/2 = {n2}"
        )
    nj = n2 // giant
    level = ct.level
    baby_keys = bkeys.rot_keys(level, range(1, giant))
    babies = [ct] + CkksEngine.rotate_hoisted(ct, baby_keys)

    acc = None
    for j in range(nj):
        inner = None
        for b in range(giant):
            d = np.roll(diags[giant * j + b], giant * j)
            pt = encoder.encode_complex(d, ct.ctx)
            term = CkksEngine.mul_plain(babies[b], pt)
            inner = (
                term if inner is None
                else CkksEngine.add_ciphertexts(inner, term)
            )
        if j:
            inner = CkksEngine.rotate_ciphertext(
                inner, bkeys.rot_key(level, giant * j)
            )
        acc = inner if acc is None else CkksEngine.add_ciphertexts(acc, inner)
    return acc


def _auto_giant(n2: int, giant) -> int | None:
    """Resolve the giant-step policy: None = dense for small n2, else
    the power-of-two split nearest sqrt(n2)."""
    if giant != "auto":
        return giant
    if n2 <= 16:
        return None  # dense double-hoisted matvec is cheaper
    return 1 << ((n2.bit_length() - 1 + 1) // 2)


def _matvec(ct, bkeys, diags, encoder, giant) -> Ciphertext:
    g = _auto_giant(ct.ctx.degree // 2, giant)
    if g is None:
        return _matvec_hoisted(ct, bkeys.rot_map(ct.level), diags, encoder)
    return _matvec_bsgs(ct, bkeys, diags, encoder, g)


def coeff_to_slot(
    ct: Ciphertext, bkeys: BootstrapKeys, encoder, giant="auto",
    levels: int | None = None,
) -> Ciphertext:
    """Homomorphic CoeffToSlot: slots become t_j = (m_j + i*m_{j+N/2})/Delta.

    The decryption coefficients m_j land in the slots, complex-packed
    (real parts = low half, imaginary parts = high half). With
    ``levels=None`` (default): one hoisted diagonal matvec + one rescale
    (consumes 1 level); ``giant``: "auto" picks dense vs BSGS by N; an
    int forces that BSGS giant-step size; None forces the dense
    double-hoisted matvec. With ``levels=k``: the factored FFT-stage
    path — k sparse hoisted matvecs (~2^{m/k+1} diagonals each,
    m = log2(N/2)), consuming k levels, with the packed coefficients
    landing BIT-REVERSED in the slots (slot-wise EvalMod is unaffected;
    ``slot_to_coeff`` with the same ``levels`` undoes it).
    """
    if levels is not None:
        cts_groups, _ = _grouped_dft_diagonals(ct.ctx.degree, levels)
        return _matvec_grouped(ct, bkeys, cts_groups, encoder)
    P_diags, _ = _cts_diagonals(ct.ctx.degree)
    out = _matvec(ct, bkeys, P_diags, encoder, giant)
    return CkksEngine.rescale_ciphertext(out)


def slot_to_coeff(
    ct: Ciphertext, bkeys: BootstrapKeys, encoder, giant="auto",
    levels: int | None = None, premul: complex = 1.0,
) -> Ciphertext:
    """Homomorphic SlotToCoeff: inverse of ``coeff_to_slot``.

    Input slots t_j = v_j + i*w_j; output ciphertext's decryption
    coefficients are (v | w) * Delta — i.e. slots return to the
    canonical embedding of that coefficient vector. Consumes 1 level
    (``levels=None``) or ``levels`` levels (factored path, consuming
    the bit-reversed order ``coeff_to_slot`` produced). ``giant``: as
    in ``coeff_to_slot``. ``premul``: free scalar folded into the first
    applied diagonal set (the matvec is linear) — used by ``bootstrap``
    to divide out the arcsine sqrt(c) factor without a level.
    """
    if levels is not None:
        stc_groups = _stc_groups_premul(
            ct.ctx.degree, levels, complex(premul)
        )
        return _matvec_grouped(ct, bkeys, stc_groups, encoder)
    _, A_diags = _cts_diagonals(ct.ctx.degree)
    if premul != 1.0:
        A_diags = premul * A_diags
    out = _matvec(ct, bkeys, A_diags, encoder, giant)
    return CkksEngine.rescale_ciphertext(out)


# ── Stage 3b: factored (multi-level) homomorphic DFTs ────────────────────────
#
# The dense CtS/StC matvec touches all N/2 diagonals at one level — fine
# for toy degrees, quadratic pain at production ones (N=2^13: 4096
# plaintext diagonals per matvec). Production bootstrap (HEAAN, Lattigo,
# SEAL) instead factors the special DFT into its FFT butterfly stages
# and groups them into a few sparse levels. The identity (the tests
# check it to machine precision):
#
#     A = F_1 @ F_2 @ ... @ F_m @ R,        m = log2(N/2)
#
# where A[k,j] = zeta_k^j is the StC matrix, R is the bit-reversal
# permutation, and each F_i is a 3-cyclic-diagonal butterfly (offsets
# {0, +-(N/2)/2^i}; stage 1's +-h coincide mod n2). Each group of s
# consecutive stages multiplies into a matrix with ~2^{s+1} cyclic
# diagonals. Because EvalMod acts slot-wise, the R between CtS and StC
# CANCELS: CtS evaluates F_m^{-1}...F_1^{-1} (packed coefficients land
# in slots bit-reversed), StC evaluates F_1...F_m on that same order.


def _stage_diagonals(degree: int, i: int, inverse: bool):
    """Cyclic diagonals {offset: vec(n2) complex} of butterfly stage F_i
    (or its inverse), i in 0..m-1. Stage i is I_{2^i} (x) B_{N/2^i}:
    out[k]      = in[k] + z_k in[k+h]          (local k < h)
    out[k+h]    = in[k] - z_k in[k+h]
    with h = (N/2^i)/4 and z_k = psi_M^{J_M(k)} the degree-M=N/2^i
    J-ordered roots. The inverse butterfly is likewise 3-diagonal."""
    from ..encoding.embedding import j_exponents

    n2 = degree // 2
    M = degree >> i
    m2, h = M // 2, M // 4
    z = np.exp(1j * np.pi * j_exponents(M)[:h] / M)
    k = np.arange(n2)
    loc = k % m2
    lo = loc < h
    zz = z[loc % h]
    if not inverse:
        d0 = np.where(lo, 1.0 + 0j, -zz)
        dp = np.where(lo, zz, 0)
        dm = np.where(lo, 0, 1.0 + 0j)
    else:
        d0 = np.where(lo, 0.5 + 0j, -0.5 / zz)
        dp = np.where(lo, 0.5 + 0j, 0)
        dm = np.where(lo, 0, 0.5 / zz)
    out: dict[int, np.ndarray] = {0: d0}
    for off, d in ((h % n2, dp), ((n2 - h) % n2, dm)):
        out[off] = out.get(off, 0) + d  # stage 1: +-h coincide mod n2
    return out


def _compose_diagonals(A: dict, B: dict, n2: int, tol: float = 1e-13) -> dict:
    """Cyclic diagonals of A @ B from those of A and B:
    (A@B) diag r = sum_{r1+r2=r} dA_{r1} * roll(dB_{r2}, -r1)."""
    out: dict[int, np.ndarray] = {}
    for r1, d1 in A.items():
        for r2, d2 in B.items():
            r = (r1 + r2) % n2
            v = d1 * np.roll(d2, -r1)
            out[r] = out.get(r, 0) + v
    top = max(np.abs(v).max() for v in out.values())
    return {r: v for r, v in out.items() if np.abs(v).max() > tol * top}


def _split_stages(m: int, levels: int) -> list[int]:
    """Partition m butterfly stages into ``levels`` contiguous groups,
    sizes as equal as possible (larger groups first — they carry the
    coarsest strides and smallest diagonal counts)."""
    if not (1 <= levels <= m):
        raise CkksError(f"dft levels must be in [1, {m}], got {levels}")
    base, extra = divmod(m, levels)
    return [base + (g < extra) for g in range(levels)]


@functools.lru_cache(maxsize=8)
def _grouped_dft_diagonals(degree: int, levels: int):
    """(cts_groups, stc_groups): per-level cyclic-diagonal dicts, each
    list in HOMOMORPHIC APPLICATION ORDER (apply groups[0] first).

    With group products G_g = F_{a_g}...F_{b_g}: StC computes
    z = G_1 ... G_glast t (innermost G_glast applied first), CtS
    computes t = G_glast^-1 ... G_1^-1 z (G_1^-1 applied first) — the
    shared bit-reversal cancels. Applying cts_groups then stc_groups in
    order is the identity. Each dict maps offset -> complex diagonal
    vector (length N/2)."""
    n2 = degree // 2
    m = n2.bit_length() - 1
    sizes = _split_stages(m, levels)
    stc_groups: list[dict] = []
    cts_groups: list[dict] = []
    i = 0
    for s in sizes:
        G = _stage_diagonals(degree, i, False)
        for j in range(i + 1, i + s):
            G = _compose_diagonals(G, _stage_diagonals(degree, j, False), n2)
        stc_groups.append(G)
        Gi = _stage_diagonals(degree, i + s - 1, True)
        for j in range(i + s - 2, i - 1, -1):
            Gi = _compose_diagonals(
                Gi, _stage_diagonals(degree, j, True), n2
            )
        cts_groups.append(Gi)
        i += s
    stc_groups.reverse()  # A = G_1 ... G_glast: innermost applied first
    return tuple(cts_groups), tuple(stc_groups)


@functools.lru_cache(maxsize=8)
def _stc_groups_premul(degree: int, levels: int, premul: complex):
    """StC groups with ``premul`` folded into the first applied set —
    cached so the dict objects are stable across refreshes (the
    plaintext-encode cache in BootstrapKeys keys on identity)."""
    _, stc_groups = _grouped_dft_diagonals(degree, levels)
    if premul == 1.0:
        return stc_groups
    first = {r: premul * d for r, d in stc_groups[0].items()}
    return (first,) + tuple(stc_groups[1:])


def _matvec_diagonal_map(
    ct: Ciphertext, bkeys: "BootstrapKeys", diag_map: dict, encoder
) -> Ciphertext:
    """One sparse diagonal matvec: sum_r diag_r o rot_r(ct), hoisted.

    All nonzero offsets share ONE gadget decomposition and ONE P
    mod-down (rotate_weighted_sum_hoisted); the r=0 diagonal is a plain
    multiply folded in. Follow with ``rescale_ciphertext``."""
    level = ct.level
    offs = sorted(r for r in diag_map if r != 0)
    rotks = bkeys.rot_keys(level, offs)
    acc = None
    if rotks:
        ext_ctx = rotks[0].ext_ctx
        pts = bkeys.encoded_diags(diag_map, offs, ext_ctx, encoder)
        acc = CkksEngine.rotate_weighted_sum_hoisted(ct, rotks, pts)
    if 0 in diag_map:
        (pt0,) = bkeys.encoded_diags(diag_map, (0,), ct.ctx, encoder)
        term = CkksEngine.mul_plain(ct, pt0)
        acc = term if acc is None else CkksEngine.add_ciphertexts(acc, term)
    return acc


def _matvec_grouped(
    ct: Ciphertext, bkeys: "BootstrapKeys", groups, encoder
) -> Ciphertext:
    """Apply the grouped-stage factored DFT: one hoisted sparse matvec +
    rescale per group (consumes len(groups) levels). Evicts each level's
    rotation keys after use — a production bootstrap visits each matvec
    level exactly once, and keeping ~2^{s+1} gadget keys per level alive
    across all levels would dominate device memory."""
    for diag_map in groups:
        level = ct.level
        ct = CkksEngine.rescale_ciphertext(
            _matvec_diagonal_map(ct, bkeys, diag_map, encoder)
        )
        bkeys.evict_level(level)
    return ct


# ── Stage 4: EvalMod (scaled sine) and the full bootstrap ────────────────────


def _exp_cheb_coeffs(a: float, deg: int):
    """Chebyshev coefficients of e^{i a u} on u in [-1, 1].

    Fitted as cos(a u) (even) + i sin(a u) (odd) with numpy's Chebyshev
    interpolation; coefficients decay like (a/2)^k / k!.
    """
    cos_c = np.polynomial.chebyshev.Chebyshev.interpolate(
        lambda u: np.cos(a * u), deg
    ).coef
    sin_c = np.polynomial.chebyshev.Chebyshev.interpolate(
        lambda u: np.sin(a * u), deg
    ).coef
    out = np.zeros(deg + 1, dtype=complex)
    out[: len(cos_c)] += cos_c
    out[: len(sin_c)] += 1j * sin_c
    return out


def _arcsine_c(rho: float) -> float:
    """Cubic arcsine-correction constant c = (2 pi / rho)^2 / 6."""
    return (2.0 * np.pi / rho) ** 2 / 6.0


def _mul_i(ct: Ciphertext) -> Ciphertext:
    """Multiply every slot by i, EXACTLY and scale-free.

    i is the value of the monomial X^{N/2} at every first-half slot root
    (zeta_k^{N/2} = i^{J(k)} = i since J(k) = 5^k = 1 mod 4), so the
    product is a plain multiply by an INTEGER plaintext (coefficient 1,
    scale_bits 0) — no scale growth, no rescale, no noise beyond the
    ring rotation itself."""
    from ..types import Plaintext

    ctx = ct.ctx
    coeffs = np.zeros(ctx.degree, dtype=object)
    coeffs[ctx.degree // 2] = 1
    pt = Plaintext(
        poly=Poly.from_coeffs(coeffs, ctx),
        scale_bits=0,
        slots=ctx.degree // 2,
    )
    return CkksEngine.mul_plain(ct, pt)


def eval_mod(
    ladder,
    params,
    bkeys: BootstrapKeys,
    ct: Ciphertext,
    rho: float,
    K: int,
    pre: complex,
    post: complex,
    r: int = 5,
    deg: int = 6,
    method: str = "linear",
    arcsine: bool = False,
) -> Ciphertext:
    """Approximate y -> (rho/2pi) sin(2pi y / rho) ~ y mod rho (centered).

    The double-angle exponential method (Cheon et al. EUROCRYPT'18 §4 /
    Han-Ki): evaluate w0 ~ e^{i a u} (a = 2 pi K / 2^r, u = pre*y in
    [-1,1], |y| <= rho*K) by a degree-``deg`` Chebyshev fit — the
    coefficients are tiny because a <= ~0.8 — then square r times so
    w = e^{2 pi i y / rho}, and extract (w - conj(w)) * post, with
    post = -i rho/(4 pi) * (extra factors the caller folds in). Depth:
    1 (pre) + deg (Chebyshev) + r (squarings) + 1 (post) levels.

    ``pre`` must equal c/(rho*K) with |c| = 1 (the caller uses it to
    fold in the real/imag-split constants 1/2 and -i/2 for free).

    ``arcsine=True`` appends the inverse-sine cubic correction
    y + c y^3, c = (2 pi / rho)^2 / 6 (2 more levels), cancelling the
    sine linearization error's cubic term — the output error drops from
    O((m/rho)^3) to O((m/rho)^5) + fit error (Lattigo's "Cos + ArcSine"
    refinement). To keep it at 2 levels the constant is folded into
    ``post`` as sqrt(c) (v = sqrt(c) y; v + v^3 = sqrt(c)(y + c y^3)),
    so the OUTPUT CARRIES A sqrt(c) FACTOR the caller must divide out —
    ``bootstrap`` folds 1/sqrt(c) into the SlotToCoeff diagonals for
    free. The branch output message must be real slot-wise for the
    cube, so ``post`` must put it on the real axis; the caller re-packs
    the imaginary branch with the exact ``_mul_i`` afterwards.
    """
    from .algorithms import align_level

    def engine_at(level):
        return CkksEngine(ladder.at_level(level).ctx, params)

    if arcsine:
        post = post * _arcsine_c(rho) ** 0.5
    u = CkksEngine.rescale_ciphertext(_mul_const(engine_at(ct.level), ct, pre))
    a = 2.0 * np.pi * K / (1 << r)
    if method == "ps":
        # Paterson-Stockmeyer: ~log2(deg) depth instead of deg — the
        # right choice for high-precision fits (deg >= 8); requires the
        # SCALE = prime-bit-width rule (models/funceval.py docstring)
        from .funceval import eval_chebyshev_ps

        w = eval_chebyshev_ps(ladder, params, u, _exp_cheb_coeffs(a, deg))
    else:
        w = eval_chebyshev(ladder, params, u, _exp_cheb_coeffs(a, deg))
    for _ in range(r):
        rlk = ladder.at_level(w.level).rlk
        w = CkksEngine.rescale_ciphertext(CkksEngine.square_ciphertext(w, rlk))
    w_conj = CkksEngine.conjugate_ciphertext(w, bkeys.conj(w.level))
    s = CkksEngine.sub_ciphertexts(w, w_conj)
    y = CkksEngine.rescale_ciphertext(
        _mul_const(engine_at(s.level), s, post)
    )
    if not arcsine:
        return y
    # v + v^3 on v = sqrt(c) y (c folded into post above): 2 levels
    from .funceval import _combine

    rlk = ladder.at_level(y.level).rlk
    sq = CkksEngine.rescale_ciphertext(CkksEngine.square_ciphertext(y, rlk))
    y_al = align_level(engine_at(y.level), y, sq.level)
    cube = CkksEngine.mul_rescale(
        y_al, sq, ladder.at_level(sq.level).rlk
    )
    return _combine(engine_at, y, cube)


def bootstrap(
    ct: Ciphertext,
    target_ctx: CkksContext,
    bkeys: BootstrapKeys,
    params,
    encoder,
    K: int | None = None,
    r: int = 5,
    deg: int = 6,
    giant="auto",
    method: str = "linear",
    dft_levels: int | None = None,
    arcsine: bool = False,
) -> Ciphertext:
    """Refresh a level-1 ciphertext: same message, higher level.

    Pipeline (Cheon-Han-Kim-Kim-Song, EUROCRYPT'18): raise_modulus ->
    CoeffToSlot -> EvalMod on the real and imaginary packed halves ->
    SlotToCoeff. Output level = target - (deg + r + 4) for the default
    single-level DFTs, or target - (deg + r + 2 + 2*dft_levels) with
    the factored path (``dft_levels`` sparse matvec levels per DFT —
    the production choice at N >= 2^10, where the dense matvec's N/2
    diagonals are infeasible); ``arcsine=True`` costs 2 more levels and
    drops the sine linearization error from O((m/q0)^2) to O((m/q0)^4)
    relative (see ``eval_mod``). Without it the message must satisfy
    |m|/q0 << 1 (error ~ (2 pi |m|/q0)^2 / 6 relative).
    """
    ladder = bkeys.ladder
    raised = raise_modulus(ct, target_ctx)
    q0 = ct.ctx.moduli[0]
    rho = q0 / raised.true_scale
    if K is None:
        hw = params.hamming_weight
        K = int(np.ceil((1 + hw) / 2 + 1)) + 1

    t = coeff_to_slot(raised, bkeys, encoder, giant=giant,
                      levels=dft_levels)
    t_conj = CkksEngine.conjugate_ciphertext(t, bkeys.conj(t.level))
    s_plus = CkksEngine.add_ciphertexts(t, t_conj)  # 2*Re(t)
    s_minus = CkksEngine.sub_ciphertexts(t, t_conj)  # 2i*Im(t)

    base_post = -1j * rho / (4.0 * np.pi)
    m_re = eval_mod(
        ladder, params, bkeys, s_plus, rho, K,
        pre=0.5 / (rho * K), post=base_post, r=r, deg=deg, method=method,
        arcsine=arcsine,
    )
    # fold the -i (un-2i) into pre: the imag branch evaluates on Im(t)
    # and contributes i * EvalMod(Im(t)). The re-packing i rides post
    # for free on the plain path; the arcsine path must cube a REAL
    # message, so it corrects first and re-packs with the exact
    # monomial multiply afterwards.
    m_im = eval_mod(
        ladder, params, bkeys, s_minus, rho, K,
        pre=-0.5j / (rho * K),
        post=base_post if arcsine else 1j * base_post, r=r, deg=deg,
        method=method, arcsine=arcsine,
    )
    if arcsine:
        m_im = _mul_i(m_im)
    from .funceval import _combine

    def engine_at(level):
        return CkksEngine(ladder.at_level(level).ctx, params)

    m_t = _combine(engine_at, m_re, m_im)
    premul = _arcsine_c(rho) ** -0.5 if arcsine else 1.0
    return slot_to_coeff(m_t, bkeys, encoder, giant=giant,
                         levels=dft_levels, premul=premul)
