#!/usr/bin/env python3
"""Decode errors of chip_smoke.py's large-ring paths, for either package,
on the CPU.

    python -m tools.big_decode --impl reference --path big
    python -m tools.big_decode --impl port --path big-wide

Replays the decode checks of chip_smoke.py's phases 3 and 3b on one of its
big paths (``chip_smoke.BIG``: N = 2^16, 4 x 30-bit primes, digit_size 2;
``chip_smoke.BIG_WIDE``: N = 2^15, 3 x 61-bit, digit_size 1) with the
script's seeds and draw order: sk, pk and the relin key from make_rng(42),
2 x B encryptions of make_rng(43) values from the same stream, then the
rotation keys (the path's offsets, and -1 and the conjugation key where
its rotation surface is full) and B encryptions of make_rng(45) values at
the rotation scale; the hoisted weighted sum takes make_rng(44)
diagonals. Items 0 and 1 go through ``CkksEngine.mul_rescale`` (the
batched composite's items, word for word) and through the rotation
surface the script checks. Prints one JSON line with the max decode error
of each check and a SHA-256 of the multiplied and rotated residues (the
reference's limb layout), equal between the packages when their residues
are. The port runs its CPU twins. chip_smoke.py's multiply bounds are
twice the reference's errors.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np

import chip_smoke as smoke

PATHS = {"big": (smoke.BIG, smoke.BIG_ROT),
         "big-wide": (smoke.BIG_WIDE, smoke.BIG_WIDE_ROT)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("port", "reference"), required=True)
    ap.add_argument("--path", choices=tuple(PATHS), required=True)
    args = ap.parse_args()
    cfg, rot = PATHS[args.path]
    n, B, ds = cfg.degree, cfg.batch, cfg.digit_size

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
        words = np.asarray

    t0 = time.perf_counter()
    E = pkg.CkksEngine
    ctx = build(pkg.generate_primes(cfg.bits, cfg.count, n), n)
    eng = E(ctx, pkg.CkksParams(3.2, n // 2, cfg.scale_bits))
    key_rng = make_rng(smoke.SEED)
    sk = eng.generate_secret_key(key_rng)
    pk = eng.generate_public_key(sk, key_rng)
    rlk = eng.generate_gadget_relin_key(sk, key_rng, digit_size=ds)
    enc = pkg.CkksEncoder(n, cfg.scale_bits)
    val_rng = make_rng(smoke.SEED + 1)
    va = val_rng.uniform(-1, 1, size=(B, n // 2))
    vb = val_rng.uniform(-1, 1, size=(B, n // 2))
    cts_a = [eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), key_rng) for v in va]
    cts_b = [eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), key_rng) for v in vb]
    digest = hashlib.sha256()

    def err(ct, want, encoder):
        digest.update(np.ascontiguousarray(words(ct.c0.data)).tobytes())
        digest.update(np.ascontiguousarray(words(ct.c1.data)).tobytes())
        got = encoder.decode(eng.decrypt(ct, sk.reduce_to(ct.ctx)))[: n // 2]
        return float(np.max(np.abs(got - want)))

    errs = {"mul_rescale items 0..1": max(
        err(E.mul_rescale(cts_a[i], cts_b[i], rlk), va[i] * vb[i], enc)
        for i in range(2))}

    rotks = {k: eng.generate_gadget_rotation_key(sk, k, key_rng, digit_size=ds)
             for k in rot.offsets}
    if rot.full:
        rk_m1 = eng.generate_gadget_rotation_key(sk, -1, key_rng, digit_size=ds)
        cjk = eng.generate_conjugation_key(sk, key_rng, digit_size=ds)
    renc = pkg.CkksEncoder(n, rot.scale_bits)
    vr = make_rng(smoke.SEED + 3).uniform(-1, 1, size=(B, n // 2))
    cts = [eng.encrypt(renc.encode(v, ctx), pk, ctx.total_bits(), key_rng)
           for v in vr]
    k1 = rot.offsets[0]
    errs[f"batched_rotate({k1}) items 0..1"] = max(
        err(E.rotate_ciphertext(cts[i], rotks[k1]), np.roll(vr[i], -k1), renc)
        for i in range(2))
    if rot.full:
        keys = [rotks[k] for k in rot.offsets]
        diags = make_rng(smoke.SEED + 2).uniform(-0.5, 0.5, size=(len(keys), n // 2))
        pts = [renc.encode(d, keys[0].ext_ctx) for d in diags]
        errs["rotate(-1)"] = err(E.rotate_ciphertext(cts[0], rk_m1), np.roll(vr[0], 1), renc)
        errs["conjugate"] = err(E.conjugate_ciphertext(cts[0], cjk), vr[0], renc)
        errs["rotate_hoisted"] = max(
            err(c, np.roll(vr[0], -k), renc)
            for c, k in zip(E.rotate_hoisted(cts[0], keys), rot.offsets))
        errs["rotate_sum_hoisted"] = err(
            E.rotate_sum_hoisted(cts[0], keys),
            sum(np.roll(vr[0], -k) for k in rot.offsets), renc)
        errs["weighted_sum+rescale"] = err(
            E.rescale_ciphertext(E.rotate_weighted_sum_hoisted(cts[0], keys, pts)),
            sum(d * np.roll(vr[0], -k) for d, k in zip(diags, rot.offsets)), renc)
    print(json.dumps({
        "impl": args.impl, "path": cfg.name, "N": n,
        "moduli_bits": [m.bit_length() for m in ctx.moduli],
        "special_bits": [m.bit_length() for m in rlk.ext_ctx.moduli[len(ctx.moduli):]],
        "scale_bits": cfg.scale_bits, "rotation_scale_bits": rot.scale_bits,
        "errors": errs, "sha256": digest.hexdigest(),
        "seconds": round(time.perf_counter() - t0, 1),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
