#!/usr/bin/env python3
"""Decode error of one rotation on the small main-path chain, for either
package, with a heuristic estimate of the noise beside it.

    python -m tools.rotation_noise --impl reference --log-n 12
    python -m tools.rotation_noise --impl port --log-n 12

Chain: 8 x 31-bit primes, digit_size 4 (4 special primes), h = N/2,
``CkksParams(3.2, N // 2, scale_bits)``, keys from ``make_rng(42)`` (sk,
pk, rotation key for offset 1), values from ``make_rng(43)``; one fresh
ciphertext and its rotation by 1 at each scale. The port runs on the CPU.
Each run imports one package only, so the two runs can be compared: the
printed SHA-256 of the rotated ciphertext's residues (the reference's
uint32 limb layout) is equal when the residues are.

The estimate has two parts. The zero-mean part treats every error
coefficient as independent: fresh noise u*e_pk + e0 + s*e1 (sigma 3.2),
key-switch noise sum_t d_t * e_t / P with d_t the approximate-extension
digit (g terms y_k * Qhat_k, y_k uniform in [0, q_k)) and e_t the gadget
key's error (variance 3.2), and the mod-down's extension overflow times s;
a slot's error is then complex Gaussian with E|z|^2 = N * var / scale^2,
and the largest of N/2 slots is about sqrt(N * var * ln(N/2)) / scale.
The mean part: the digits are not centered (mean g * Q_t / 2) and neither
is the overflow (mean (g' - 1) / 2), so the key switch adds
(mu_t / P) * e_t * A and the overflow (g' - 1) / 2 * (1 + s) * A, with
A = 1 + X + ... + X^{N-1}. A is ~1 per coefficient but 1 / sin(pi / 2N),
about 2N / pi, at the root exp(i pi / N) of slot 0, so this part lands on
slot 0 (and falls off as 1 / k on the slots of the roots exp(i k pi / N)).
``--estimate-only`` prints the estimate without running a package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math

import numpy as np

DIGIT_SIZE = 4
SIGMA2 = 3.2  # error_variance: the encryption sigma and the gadget key's variance


def _estimate(moduli, specials, degree: int, scale_bits: int) -> dict:
    """Heuristic max slot error of a fresh and of a rotated ciphertext
    (module docstring): the zero-mean part over all slots plus the mean
    part on slot 0."""
    h, scale = degree // 2, 2.0 ** scale_bits
    p_total = math.prod(specials)
    digits = [moduli[i:i + DIGIT_SIZE] for i in range(0, len(moduli), DIGIT_SIZE)]
    fresh = 2 * h * SIGMA2 ** 2 + SIGMA2 ** 2
    ks = mean2 = 0.0
    for grp in digits:
        g, ratio = len(grp), math.prod(grp) / p_total  # Q_t / P
        ks += degree * SIGMA2 * (g * g / 4 + g / 12) * ratio ** 2  # E[d_t^2] / P^2
        mean2 += (g / 2 * ratio) ** 2  # (mu_t / P)^2
    gp = len(specials)
    rnd = h * (gp * gp / 4 + gp / 12)
    slot = lambda var: math.sqrt(degree * var * math.log(degree // 2)) / scale
    a_slot0 = 1 / math.sin(math.pi / (2 * degree))  # |A| at exp(i pi / N)
    mean = a_slot0 * (math.sqrt(degree * SIGMA2 * mean2)
                      + (gp - 1) / 2 * math.sqrt(1 + h)) / scale
    return {"fresh": slot(fresh), "rotated_zero_mean": slot(fresh + ks + rnd),
            "rotated_mean_slot0": mean, "rotated": slot(fresh + ks + rnd) + mean}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("port", "reference"), required=True)
    ap.add_argument("--log-n", type=int, default=12)
    ap.add_argument("--scale-bits", type=int, nargs="+", default=[31, 45])
    ap.add_argument("--estimate-only", action="store_true")
    args = ap.parse_args()
    n = 1 << args.log_n

    if args.estimate_only:
        from toy_heaan_ckks_tpu_torch.keys import get_first_prime_down
        from toy_heaan_ckks_tpu_torch.math.primes import generate_primes

        moduli = tuple(generate_primes(31, 8, n))
        specials, p = [], get_first_prime_down(1 << 31, n)
        while len(specials) < DIGIT_SIZE:  # keys.default_special_primes
            if p not in moduli:
                specials.append(p)
            p = get_first_prime_down(p, n)
        for scale_bits in args.scale_bits:
            print(json.dumps({"N": n, "scale_bits": scale_bits, "estimate": _estimate(
                moduli, tuple(specials), n, scale_bits)}))
        return 0

    if args.impl == "port":
        import toy_heaan_ckks_tpu_torch as pkg
        from toy_heaan_ckks_tpu_torch.convert import to_reference
        from toy_heaan_ckks_tpu_torch.math.sampling import make_rng

        build = lambda m, n: pkg.CkksContext.build(m, n, device="cpu")
        words = to_reference
    else:
        import toy_heaan_ckks_tpu as pkg
        from toy_heaan_ckks_tpu.math.sampling import make_rng

        build = pkg.CkksContext.build
        words = lambda x: np.asarray(x, dtype=np.uint32)

    ctx = build(pkg.generate_primes(31, 8, n), n)
    for scale_bits in args.scale_bits:
        eng = pkg.CkksEngine(ctx, pkg.CkksParams(3.2, n // 2, scale_bits))
        rng = make_rng(42)
        sk = eng.generate_secret_key(rng)
        pk = eng.generate_public_key(sk, rng)
        rotk = eng.generate_gadget_rotation_key(sk, 1, rng, digit_size=DIGIT_SIZE)
        enc = pkg.CkksEncoder(n, scale_bits)
        va = make_rng(43).uniform(-1, 1, size=n // 2)
        ct = eng.encrypt(enc.encode(va, ctx), pk, ctx.total_bits(), rng)
        rot = pkg.CkksEngine.rotate_ciphertext(ct, rotk)
        errs = lambda c, want: np.abs(enc.decode(eng.decrypt(c, sk)) - want)
        rot_errs = errs(rot, np.roll(va, -1))
        digest = hashlib.sha256()
        for part in (rot.c0.data, rot.c1.data):
            digest.update(np.ascontiguousarray(words(part)).tobytes())
        specials = tuple(rotk.ext_ctx.moduli[len(ctx.moduli):])
        print(json.dumps({
            "impl": args.impl, "N": n, "scale_bits": scale_bits,
            "moduli_bits": [m.bit_length() for m in ctx.moduli],
            "special_bits": [m.bit_length() for m in specials],
            "fresh_err": float(np.max(errs(ct, va))),
            "rotated_err": float(np.max(rot_errs)),
            "rotated_worst_slot": int(np.argmax(rot_errs)),
            "estimate": _estimate(tuple(ctx.moduli), specials, n, scale_bits),
            "rotated_sha256": digest.hexdigest(),
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
