"""CkksEngine: keygen, encrypt/decrypt and the fused multiply+rescale.

Counterpart of ``toy_heaan_ckks_tpu/engine.py``, cut to the main path:
``_switch_plan``, ``_combined_down_consts``, ``_check_key_compat`` and the
engine's ``generate_secret_key``, ``generate_public_key``,
``generate_gadget_relin_key``, ``encrypt``, ``decrypt`` and
``mul_rescale``. Ciphertexts are NTT-resident, and the noise-sigma
conventions are the reference's (encrypt noise sigma = error_variance,
public-key sigma 3.2, gadget-key sigma = sqrt(error_variance)).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .context import CkksContext
from .keys import PublicKey, RnsGadgetRelinKey, SecretKey, SecretKeyParams
from .ops.poly import Poly
from .types import Ciphertext, Plaintext


@dataclasses.dataclass(frozen=True)
class CkksParams:
    error_variance: float = 3.2
    hamming_weight: int = 0
    scale_bits: int = 30


@dataclasses.dataclass(frozen=True)
class _SwitchPlan:
    """The key's digit grouping. The reference's plan also packs the
    decomposition constants as device arrays for its generic path; the
    ported path derives its tables from the host-int helpers in keys.py."""

    digit_size: int


@functools.lru_cache(maxsize=128)
def _switch_plan(base_moduli: tuple[int, ...], ext_moduli: tuple[int, ...],
                 digit_size: int) -> _SwitchPlan:
    """Plan keyed by the key's stored ``digit_size`` (never inferred from
    the digit count)."""
    return _SwitchPlan(digit_size=min(digit_size, len(base_moduli)))


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

    # ── multiplication ───────────────────────────────────────────────────

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
