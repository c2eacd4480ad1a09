"""RLWE key material: secret and public keys, and the hybrid gadget keys.

Counterpart of ``toy_heaan_ckks_tpu/keys.py``: the legacy single-pair
relinearization and rotation keys, the keys of the fused multiply,
rotations and conjugation (the gadget relin, rotation and conjugation
keys) and the per-level ``KeyLadder`` / ``LevelKeys``. The keys draw from
the caller's numpy Generator in the reference's order, so one seed gives
bit-identical keys in both packages.
Gadget keys are stored as (D, E, N) NTT-domain Montgomery stacks (digit,
channel incl. specials, coefficient) of the extended chain's dtype (int32
with R = 2^32 when every prime is below 2^31, else int64 with R = 2^64)
on the context's device.

Hybrid (special-prime) key switching: digit t of a relin key encodes
P * T_t * s^2 over Q*P, where P is the product of the special primes and
T_t the CRT indicator of digit t's prime group; after the digit inner
product one division by P shrinks the key-switch noise by 1/P.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .context import CkksContext
from .math import sampling
from .math.primes import get_first_prime_down
from .ops import modular as mm
from .ops.poly import Poly


@dataclasses.dataclass(frozen=True, eq=False)
class SecretKeyParams:
    hamming_weight: int

    def validate(self, degree: int):
        if not (0 <= self.hamming_weight <= degree):
            raise ValueError(
                f"hamming weight {self.hamming_weight} exceeds degree {degree}"
            )


@dataclasses.dataclass(frozen=True, eq=False)
class SecretKey:
    poly: Poly  # ternary secret, NTT domain
    coeffs: np.ndarray | None = None  # host copy of the ternary coefficients

    @staticmethod
    def generate(
        params: SecretKeyParams, ctx: CkksContext, rng: np.random.Generator
    ) -> "SecretKey":
        params.validate(ctx.degree)
        coeffs = sampling.ternary_coefficients(ctx.degree, params.hamming_weight, rng)
        return SecretKey(
            poly=Poly.from_coeffs(coeffs, ctx).to_ntt_domain(), coeffs=coeffs
        )

    def reduce_to(self, ctx: CkksContext) -> "SecretKey":
        """Truncate RNS channels to ``ctx`` (truncation commutes with the
        channel-local NTT)."""
        drop = self.poly.ctx.num_channels - ctx.num_channels
        if drop < 0:
            raise ValueError("reduce_to: target context has more channels")
        if drop == 0:
            return self
        return SecretKey(poly=self.poly.mod_drop_last(drop), coeffs=self.coeffs)

    def extend_to(self, ext_ctx: CkksContext) -> Poly:
        """The secret as an NTT-domain poly over an extended chain."""
        if self.coeffs is None:
            raise ValueError("extend_to: secret key lacks host coefficients")
        return Poly.from_coeffs(self.coeffs, ext_ctx).to_ntt_domain()


@dataclasses.dataclass(frozen=True, eq=False)
class PublicKey:
    a: Poly  # NTT domain
    b: Poly  # NTT domain

    @staticmethod
    def generate(
        sk: SecretKey, std_dev: float, ctx: CkksContext, rng: np.random.Generator
    ) -> "PublicKey":
        a = Poly.sample_uniform(ctx, rng).to_ntt_domain()
        e = Poly.sample_gaussian(ctx, std_dev, rng).to_ntt_domain()
        return PublicKey(a=a, b=-(a * sk.poly) + e)


@dataclasses.dataclass(frozen=True, eq=False)
class RelinearizationKey:
    """Legacy single-pair relin key: b = -(a*s) + e + s^2, NTT domain."""

    a: Poly
    b: Poly

    @staticmethod
    def generate(
        sk: SecretKey, std_dev: float, ctx: CkksContext, rng: np.random.Generator
    ) -> "RelinearizationKey":
        a = Poly.sample_uniform(ctx, rng).to_ntt_domain()
        e = Poly.sample_gaussian(ctx, std_dev, rng).to_ntt_domain()
        return RelinearizationKey(a=a, b=-(a * sk.poly) + e + sk.poly * sk.poly)


@dataclasses.dataclass(frozen=True, eq=False)
class RotationKey:
    """Legacy single-pair rotation key: b = -(a*s) + e + s(X^{5^k}), NTT
    domain."""

    a: Poly
    b: Poly
    rotation: int

    @staticmethod
    def generate(
        sk: SecretKey,
        rotation: int,
        std_dev: float,
        ctx: CkksContext,
        rng: np.random.Generator,
    ) -> "RotationKey":
        a = Poly.sample_uniform(ctx, rng).to_ntt_domain()
        e = Poly.sample_gaussian(ctx, std_dev, rng).to_ntt_domain()
        s_k = sk.poly.rotate_slots(rotation)
        return RotationKey(a=a, b=-(a * sk.poly) + e + s_k, rotation=rotation)


def default_special_primes(ctx: CkksContext, count: int = 1) -> tuple[int, ...]:
    """``count`` NTT-friendly special primes ~ max(q_i), distinct from the
    chain. A small chain keeps them small (below 2^30 for a chain below
    2^30, else below 2^31); a wide chain gets one extra bit, up to 2^63
    (so a 62-bit chain has 63-bit specials)."""
    bits = max(m.bit_length() for m in ctx.moduli)
    if ctx.chain.small and bits <= 30:
        bound, min_bits = 1 << 30, bits - 1
    elif ctx.chain.small:
        bound, min_bits = 1 << 31, bits
    else:
        bound, min_bits = 1 << min(63, bits + 1), bits
    out: list[int] = []
    p = get_first_prime_down(bound, ctx.degree)
    while p is not None and len(out) < count:
        if p not in ctx.moduli and p.bit_length() >= min_bits:
            out.append(p)
        p = get_first_prime_down(p, ctx.degree)
    if len(out) < count:
        raise ValueError("not enough special primes available for this chain")
    return tuple(out)


def default_special_prime(ctx: CkksContext) -> int:
    return default_special_primes(ctx, 1)[0]


def digit_groups(num_channels: int, digit_size: int) -> tuple[tuple[int, ...], ...]:
    """Contiguous RNS-channel groups of size <= digit_size (the hybrid
    key-switch decomposition digits)."""
    if digit_size < 1:
        raise ValueError("digit_size must be >= 1")
    return tuple(
        tuple(range(lo, min(lo + digit_size, num_channels)))
        for lo in range(0, num_channels, digit_size)
    )


def dec_inv_ints(moduli, digit_size: int) -> tuple:
    """Plain (Qhat_{t,k})^{-1} mod q_k per base channel, Qhat_{t,k} = product
    of digit t's other moduli."""
    moduli = tuple(int(m) for m in moduli)
    out = [0] * len(moduli)
    for grp in digit_groups(len(moduli), min(digit_size, len(moduli))):
        for k in grp:
            qhat = 1
            for k2 in grp:
                if k2 != k:
                    qhat *= moduli[k2]
            out[k] = pow(qhat % moduli[k], -1, moduli[k])
    return tuple(out)


def sp_inv_ints(special_moduli) -> tuple:
    """Plain (Phat_m)^{-1} mod p_m per special channel (Phat_m = P / p_m)."""
    specials = tuple(int(m) for m in special_moduli)
    p_total = 1
    for p in specials:
        p_total *= p
    return tuple(pow((p_total // pm) % pm, -1, pm) for pm in specials)


# gadget keys whose uniform halves are drawn at once, one thread each
# (numpy's bounded draws release the interpreter lock)
KEYGEN_THREADS = 8


def _gadget_stacks(sk: SecretKey, targets, std_dev: float, ctx: CkksContext,
                   rng: np.random.Generator, specials: tuple[int, ...],
                   digit_size: int = 1) -> list:
    """Stacked hybrid gadget pairs encoding each of ``targets``: digit t's
    plaintext over QP is (P mod q_j) * target_j on digit t's channels and
    zero elsewhere. Returns [(a, b, ext_ctx, a_seed)], a/b (D, E, N) of
    the extended chain's dtype.

    The caller's generator draws, key after key, the seed of the key's
    uniform halves and then one Gaussian error per digit: the draws of one
    single-key call after another. Each uniform half comes from its own
    seeded generator, so up to KEYGEN_THREADS of them are drawn at once in
    threads."""
    from concurrent.futures import ThreadPoolExecutor

    groups = digit_groups(ctx.num_channels, digit_size)
    ext_ctx = CkksContext.build(ctx.moduli + tuple(specials), ctx.degree, ctx.device)
    s_ext = sk.extend_to(ext_ctx)
    p_total = 1
    for p in specials:
        p_total *= p
    p_mod = torch.tensor(
        [p_total % q for q in ctx.moduli], dtype=torch.int64, device=ctx.device
    )[:, None]
    out = []
    with ThreadPoolExecutor(KEYGEN_THREADS) as pool:
        for lo in range(0, len(targets), KEYGEN_THREADS):
            batch = targets[lo:lo + KEYGEN_THREADS]
            draws = []
            for _ in batch:
                a_seed = int(rng.integers(0, 2**63))
                draws.append((a_seed, [
                    sampling.gaussian_coefficients(ctx.degree, std_dev, rng)
                    for _ in groups
                ]))
            uniform = pool.map(lambda d: _uniform_residues(ext_ctx, len(groups), d[0]),
                               draws)
            for target, (a_seed, errors), res in zip(batch, draws, uniform):
                t_scaled = mm.mul_mod(target.to_ntt_domain().data, p_mod, ctx.chain.q)
                plain = torch.zeros(
                    (len(groups), ext_ctx.num_channels, ctx.degree),
                    dtype=ext_ctx.chain.dtype, device=ctx.device,
                )
                for t, grp in enumerate(groups):
                    plain[t, grp[0] : grp[-1] + 1] = t_scaled[grp[0] : grp[-1] + 1]
                a_stack = _uniform_to_device(res, ext_ctx)
                b_list = []
                for t, e in enumerate(errors):
                    a_i = Poly(a_stack[t], ext_ctx, True)
                    e_i = Poly.from_coeffs(e, ext_ctx).to_ntt_domain()
                    b_list.append((-(a_i * s_ext) + e_i).data)
                b_stack = mm.add_mod(torch.stack(b_list), plain, ext_ctx.chain.q)
                out.append((a_stack, b_stack, ext_ctx, a_seed))
    return out


def _uniform_residues(ext_ctx: CkksContext, num_digits: int, a_seed: int) -> np.ndarray:
    """Host draws of a gadget key's uniform halves: (D, E, N) residues from
    ``make_rng(a_seed)``, digit after digit, channel after channel."""
    a_rng = sampling.make_rng(a_seed)
    return np.stack([
        np.stack([sampling.uniform_coefficients(ext_ctx.degree, q, a_rng)
                  for q in ext_ctx.moduli])
        for _ in range(num_digits)
    ])


def _uniform_to_device(res: np.ndarray, ext_ctx: CkksContext) -> torch.Tensor:
    """(D, E, N) plain residues -> NTT-domain Montgomery planes on device."""
    return torch.stack([Poly.from_residues(r, ext_ctx).to_ntt_domain().data
                        for r in res])


def regenerate_gadget_a(ext_ctx: CkksContext, num_digits: int,
                        a_seed: int) -> torch.Tensor:
    """Re-derive a gadget key's uniform ``a`` stack (D, E, N) from its seed."""
    return _uniform_to_device(_uniform_residues(ext_ctx, num_digits, a_seed), ext_ctx)


def _resolve_specials(ctx: CkksContext, special: int | None,
                      specials: tuple[int, ...] | None,
                      digit_size: int) -> tuple[int, ...]:
    """The special primes a key is built over: ``specials`` as given, else
    the one ``special``, else one default prime per channel of the largest
    digit group."""
    if specials is not None:
        return tuple(int(p) for p in specials)
    if special is not None:
        return (int(special),)
    groups = digit_groups(ctx.num_channels, digit_size)
    return default_special_primes(ctx, max(len(g) for g in groups))


def _gadget_key_fields(sk: SecretKey, targets, std_dev: float,
                       ctx: CkksContext, rng: np.random.Generator,
                       special, specials, digit_size: int) -> list:
    """The fields every gadget key shares, for keys encoding ``targets``."""
    sp = _resolve_specials(ctx, special, specials, digit_size)
    p_total = 1
    for p in sp:
        p_total *= p
    return [dict(a=a, b=b, ctx=ctx, ext_ctx=ext_ctx, special=p_total,
                 digit_size=digit_size, a_seed=a_seed)
            for a, b, ext_ctx, a_seed in _gadget_stacks(
                sk, targets, std_dev, ctx, rng, sp, digit_size)]


@dataclasses.dataclass(frozen=True, eq=False)
class RnsGadgetRelinKey:
    """Gadget relinearization key: digit t encodes P * T_t * s^2 over QP.

    a/b: (D, L+g', N) NTT-domain stacks of the extended chain's dtype;
    g' special primes, whose product is ``special``.
    """

    a: torch.Tensor
    b: torch.Tensor
    ctx: CkksContext
    ext_ctx: CkksContext
    special: int
    digit_size: int = 1
    a_seed: int | None = None

    @staticmethod
    def generate(sk: SecretKey, std_dev: float, ctx: CkksContext,
                 rng: np.random.Generator, special: int | None = None,
                 specials: tuple[int, ...] | None = None,
                 digit_size: int = 1) -> "RnsGadgetRelinKey":
        return RnsGadgetRelinKey(**_gadget_key_fields(
            sk, [sk.poly * sk.poly], std_dev, ctx, rng, special, specials,
            digit_size,
        )[0])


@dataclasses.dataclass(frozen=True, eq=False)
class RnsGadgetRotationKey:
    """Gadget rotation key: digit t encodes P * T_t * s(X^{5^k}) over QP.

    ``hoist_cache`` holds the inverse-permuted key planes of hoisted
    rotation, built on first use (the dict is mutable, the key frozen)."""

    a: torch.Tensor
    b: torch.Tensor
    rotation: int
    ctx: CkksContext
    ext_ctx: CkksContext
    special: int
    digit_size: int = 1
    a_seed: int | None = None
    hoist_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def generate(sk: SecretKey, rotation: int, std_dev: float,
                 ctx: CkksContext, rng: np.random.Generator,
                 special: int | None = None,
                 specials: tuple[int, ...] | None = None,
                 digit_size: int = 1) -> "RnsGadgetRotationKey":
        return RnsGadgetRotationKey.generate_many(
            sk, [rotation], std_dev, ctx, rng, special, specials, digit_size)[0]

    @staticmethod
    def generate_many(sk: SecretKey, rotations, std_dev: float,
                      ctx: CkksContext, rng: np.random.Generator,
                      special: int | None = None,
                      specials: tuple[int, ...] | None = None,
                      digit_size: int = 1) -> list:
        """Keys for ``rotations`` in order: the words and the generator's
        draws of one ``generate`` call after another, the keys' uniform
        halves drawn in threads (``_gadget_stacks``)."""
        targets = [sk.poly.rotate_slots(r) for r in rotations]
        return [RnsGadgetRotationKey(rotation=r, **fields) for r, fields in zip(
            rotations, _gadget_key_fields(sk, targets, std_dev, ctx, rng, special,
                                          specials, digit_size))]


@dataclasses.dataclass(frozen=True, eq=False)
class RnsGadgetConjugationKey:
    """Gadget key for slot conjugation: digit t encodes
    P * T_t * s(X^{2N-1}) over QP."""

    a: torch.Tensor
    b: torch.Tensor
    ctx: CkksContext
    ext_ctx: CkksContext
    special: int
    digit_size: int = 1
    a_seed: int | None = None

    @staticmethod
    def generate(sk: SecretKey, std_dev: float, ctx: CkksContext,
                 rng: np.random.Generator, special: int | None = None,
                 specials: tuple[int, ...] | None = None,
                 digit_size: int = 1) -> "RnsGadgetConjugationKey":
        return RnsGadgetConjugationKey(**_gadget_key_fields(
            sk, [sk.poly.conjugate()], std_dev, ctx, rng, special, specials,
            digit_size,
        )[0])


@dataclasses.dataclass(frozen=True, eq=False)
class LevelKeys:
    """Key material specialised to one RNS level."""

    ctx: CkksContext
    sk: SecretKey
    pk: PublicKey
    rlk: RnsGadgetRelinKey
    rot: dict  # rotation offset -> RnsGadgetRotationKey


class KeyLadder:
    """Per-level key ladder (eager or lazy).

    Level l's secret key is the channel-truncated master secret, and fresh
    pk / rlk / rotation keys are drawn for each level from the caller's
    Generator, in the reference's order (levels from the top down when
    eager, in the order of ``at_level`` calls when ``lazy``), so one seed
    gives the reference's keys word for word. ``lazy=True`` defers a
    level's keys to its first ``at_level`` call; ``memory_bytes()``
    reports the bytes the generated keys hold.
    """

    def __init__(self, master_ctx: CkksContext, sk: SecretKey,
                 error_variance: float, rng: np.random.Generator,
                 rotations: tuple = (), min_level: int = 1, lazy: bool = False,
                 digit_size: int = 1):
        self.levels: dict[int, LevelKeys] = {}
        self._std = float(error_variance) ** 0.5
        self._sk = sk
        self._rng = rng
        self._rotations = tuple(rotations)
        self.digit_size = digit_size
        self._min_level = max(1, min_level)
        self._ctxs: dict[int, CkksContext] = {}
        ctx = master_ctx
        while ctx.num_channels >= self._min_level:
            self._ctxs[ctx.num_channels] = ctx
            if ctx.num_channels == 1:
                break
            ctx = ctx.drop_last(1)
        if not lazy:
            for lvl in sorted(self._ctxs, reverse=True):
                self._generate(lvl)

    def _generate(self, num_channels: int) -> LevelKeys:
        ctx = self._ctxs[num_channels]
        sk_l = self._sk.reduce_to(ctx)
        pk_l = PublicKey.generate(sk_l, 3.2, ctx, self._rng)
        rlk_l = RnsGadgetRelinKey.generate(sk_l, self._std, ctx, self._rng,
                                           digit_size=self.digit_size)
        rot_l = {
            r: RnsGadgetRotationKey.generate(sk_l, r, self._std, ctx, self._rng,
                                             digit_size=self.digit_size)
            for r in self._rotations
        }
        keys = LevelKeys(ctx=ctx, sk=sk_l, pk=pk_l, rlk=rlk_l, rot=rot_l)
        self.levels[num_channels] = keys
        return keys

    def at_level(self, num_channels: int) -> LevelKeys:
        keys = self.levels.get(num_channels)
        if keys is None:
            if num_channels not in self._ctxs:
                raise KeyError(f"KeyLadder has no level {num_channels} "
                               f"(min_level={self._min_level})")
            keys = self._generate(num_channels)
        return keys

    def for_ctx(self, ctx: CkksContext) -> LevelKeys:
        return self.at_level(ctx.num_channels)

    def memory_bytes(self) -> int:
        """Bytes of the generated keys' tensors (the shared contexts and
        tables not counted): per level, sum of numel x element size over
        sk, pk a / b and the (D, E, N) a / b stacks of the relin and
        rotation keys, so 4 bytes a residue on a small chain and 8 on a
        wide one (the reference counts its (..., 2, N) uint32 limb pairs,
        8 bytes a residue on every chain)."""
        total = 0
        for keys in self.levels.values():
            arrs = [keys.pk.a.data, keys.pk.b.data, keys.sk.poly.data,
                    keys.rlk.a, keys.rlk.b]
            for rk in keys.rot.values():
                arrs += [rk.a, rk.b]
            total += sum(a.numel() * a.element_size() for a in arrs)
        return total
