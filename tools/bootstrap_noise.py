#!/usr/bin/env python3
"""Decode error of the small-prime bootstrap recipe, for either package, at
reduced rings, with its growth fitted over N.

    python -m tools.bootstrap_noise --impl reference --log-n 8 9 10 11 12
    python -m tools.bootstrap_noise --impl reference --chain matched --log-n 8 9 10
    python -m tools.bootstrap_noise --impl port --log-n 10 --stage refresh

The recipe is ``tests/test_bootstrap.py``'s factored-DFT one scaled to
the card's chains: h = 8 (so K = 7), ``KeyLadder(lazy=True,
digit_size=4)`` and ``BootstrapKeys(..., digit_size=4)``, keys from
``make_rng(33)`` (sk, the level-1 pk, then the ladder and the bootstrap
keys, lazily), values uniform in [-0.02, 0.02] from
``np.random.default_rng(9)``, one level-1 ciphertext of N/2 slots, on one
of two chains (``--chain``):

- ``generate``: ``generate_primes(31, 28, N)``, scale 2^31: the NTT primes
  of ring N walking down from 2^31, so their spread below 2^31 grows with N
  (3e-4 at 2^10, 1.9% at 2^16);
- ``matched``: the 37 primes of ``build_modulus_chain(2^16, 30, 36,
  first_bits=31)`` at every N (NTT primes of 2^16 serve every smaller
  ring), scale 2^30: q0 just below 2^31, then primes alternating above and
  below 2^30 (within 2.5%), the chain of the full-width refresh. The
  same primes give the same level path and scale heals at every N.

Each run imports one package for its words (the port on the CPU; the
expected DFT slots come from the port's numpy ``expected_dft``), and
prints one JSON line per N and stage, with the SHA-256 of the output's
residues (the reference's uint32 limb layout), equal when the words are.

Stages:

- ``refresh``: ``bootstrap(ct1, full, bkeys, params, enc, r=7, deg=8,
  dft_levels=3, arcsine=True)``: the output level, the number of
  ``_combine`` scale heals (each spends a level), the max decode error
  against the message and -log2(err / 0.02); or the error that stopped
  the refresh (the chain ran out of levels); where the output level is 2 or
  more, one square-and-rescale of the refreshed ciphertext against m^2 and
  against the square of the refresh's own decode.
- ``dft``: the refresh's linear stages on the raised ciphertext:
  ``coeff_to_slot(levels=3)`` against the packed coefficients of the
  raised plaintext (m + q0 * I, exact on the host) in bit-reversed slot
  order, and ``slot_to_coeff(levels=3)`` of that against the raised
  plaintext's slots, each decoded on its first 3 channels.

With two or more N, a last line fits log2(err) = a + b log2(N) to each
stage's errors by least squares and gives the prediction at --predict
(default 2^16) and twice it.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import math
import time

import numpy as np

from toy_heaan_ckks_tpu_torch.encoding.embedding import expected_dft

DIGIT_SIZE, HW = 4, 8
R, DEG, DFT_LEVELS, MMAX = 7, 8, 3, 0.02
KEY_SEED, VALUE_SEED = 33, 9
MATCHED_RING, MATCHED_DEPTH, MATCHED_SCALE, MATCHED_FIRST = 1 << 16, 36, 30, 31


def chain(p: dict, kind: str, n: int) -> tuple:
    """The recipe's primes at ring ``n`` and its scale bits."""
    if kind == "generate":
        return list(p["pkg"].generate_primes(31, 28, n)), 31
    plan = p["params"].build_modulus_chain(MATCHED_RING, MATCHED_SCALE, MATCHED_DEPTH,
                                           first_bits=MATCHED_FIRST)
    return list(plan.moduli), MATCHED_SCALE


def _package(impl: str) -> dict:
    """The package's entry points, and how to read its words."""
    if impl == "port":
        import toy_heaan_ckks_tpu_torch as pkg
        from toy_heaan_ckks_tpu_torch.convert import to_reference
        from toy_heaan_ckks_tpu_torch.math.sampling import make_rng

        name = "toy_heaan_ckks_tpu_torch"
        build = lambda m, n: pkg.CkksContext.build(m, n, device="cpu")
        words = to_reference
    else:
        import toy_heaan_ckks_tpu as pkg
        from toy_heaan_ckks_tpu.math.sampling import make_rng

        name = "toy_heaan_ckks_tpu"
        build = pkg.CkksContext.build
        words = lambda x: np.asarray(x, dtype=np.uint32)
    return dict(pkg=pkg, build=build, words=words, make_rng=make_rng,
                bt=importlib.import_module(f"{name}.models.bootstrap"),
                alg=importlib.import_module(f"{name}.models.algorithms"),
                params=importlib.import_module(f"{name}.utils.params"))


def setup(p: dict, n: int, kind: str) -> dict:
    """The recipe's keys, encoder and level-1 ciphertext at ring ``n``."""
    pkg = p["pkg"]
    primes, bits = chain(p, kind, n)
    full = p["build"](primes, n)
    ctx1 = full.slice_channels(0, 1)
    params = pkg.CkksParams(3.2, HW, bits)
    rng = p["make_rng"](KEY_SEED)
    sk = pkg.CkksEngine(full, params).generate_secret_key(rng)
    eng1 = pkg.CkksEngine(ctx1, params)
    pk1 = eng1.generate_public_key(sk.reduce_to(ctx1), rng)
    ladder = pkg.KeyLadder(full, sk, 3.2, rng, lazy=True, digit_size=DIGIT_SIZE)
    bkeys = p["bt"].BootstrapKeys(ladder, params, rng, digit_size=DIGIT_SIZE)
    enc = pkg.CkksEncoder(n, bits)
    m = np.random.default_rng(VALUE_SEED).uniform(-MMAX, MMAX, n // 2)
    ct1 = eng1.encrypt(enc.encode(m, ctx1), pk1, ctx1.total_bits(), rng)
    return dict(full=full, params=params, sk=sk, ladder=ladder, bkeys=bkeys,
                enc=enc, m=m, ct1=ct1)


def _digest(p: dict, ct) -> str:
    h = hashlib.sha256()
    for part in (ct.c0.data, ct.c1.data):
        h.update(np.ascontiguousarray(p["words"](part)).tobytes())
    return h.hexdigest()


def _low(ct, keep: int = 3):
    """``ct`` on its first ``keep`` channels: the same plaintext where its
    coefficients lie within (-Q_keep / 2, Q_keep / 2], decoded without the
    float overflow of a long chain's CRT (34 x 31 bits > 2^1024)."""
    drop = ct.level - keep
    if drop <= 0:
        return ct
    return type(ct)(c0=ct.c0.mod_drop_last(drop), c1=ct.c1.mod_drop_last(drop),
                    logp=ct.logp, logq=ct.logq, scale=ct.scale)


def _decode(p: dict, s: dict, ct) -> np.ndarray:
    pt = p["pkg"].CkksEngine.decrypt(ct, s["sk"].reduce_to(ct.ctx))
    return s["enc"].decode_complex(pt)


def refresh(p: dict, n: int, kind: str) -> dict:
    s = setup(p, n, kind)
    heals = []
    alg = p["alg"]
    normalize = alg.normalize_scale

    def counted(engine, ct, target):
        heals.append(ct.level)
        return normalize(engine, ct, target)

    alg.normalize_scale = counted
    t0 = time.perf_counter()
    try:
        out = p["bt"].bootstrap(s["ct1"], s["full"], s["bkeys"], s["params"], s["enc"],
                                r=R, deg=DEG, dft_levels=DFT_LEVELS, arcsine=True)
    except ValueError as exc:  # the chain ran out of levels
        return {"N": n, "stage": "refresh", "heals": len(heals), "heal_levels": heals,
                "failed": f"{type(exc).__name__}: {exc}"}
    finally:
        alg.normalize_scale = normalize
    seconds = time.perf_counter() - t0
    got = _decode(p, s, out)[: n // 2].real
    err = float(np.max(np.abs(got - s["m"])))
    row = {"N": n, "stage": "refresh", "output_level": out.level, "heals": len(heals),
           "heal_levels": heals, "max_err": err,
           "precision_bits": -math.log2(err / MMAX), "seconds": seconds,
           "sha256": _digest(p, out)}
    if out.level >= 2:  # one square-and-rescale of the refreshed ciphertext
        eng = p["pkg"].CkksEngine
        rlk = s["ladder"].at_level(out.level).rlk
        sq = eng.rescale_ciphertext(eng.square_ciphertext(out, rlk))
        got_sq = _decode(p, s, sq)[: n // 2].real
        row["square_max_err"] = float(np.max(np.abs(got_sq - s["m"] ** 2)))
        row["square_vs_refresh"] = float(np.max(np.abs(got_sq - got ** 2)))
    return row


def dft(p: dict, n: int, kind: str) -> dict:
    s = setup(p, n, kind)
    bt, pkg = p["bt"], p["pkg"]
    raised = bt.raise_modulus(s["ct1"], s["full"])
    c = pkg.CkksEngine.decrypt(raised, s["sk"]).poly.to_coeffs()
    t_want, back_want = expected_dft(c, raised.true_scale, n)
    t0 = time.perf_counter()
    t = bt.coeff_to_slot(raised, s["bkeys"], s["enc"], levels=DFT_LEVELS)
    back = bt.slot_to_coeff(t, s["bkeys"], s["enc"], levels=DFT_LEVELS)
    seconds = time.perf_counter() - t0
    n2 = n // 2
    return {"N": n, "stage": "dft", "cts_level": t.level, "stc_level": back.level,
            "cts_max_err": float(np.max(np.abs(_decode(p, s, _low(t))[:n2] - t_want))),
            "stc_max_err": float(np.max(np.abs(_decode(p, s, _low(back))[:n2]
                                               - back_want))),
            "seconds": seconds, "sha256": _digest(p, back)}


def fit(rows: list, predict_log_n: int) -> dict:
    """log2(err) = a + b log2(N) by least squares, per error key."""
    out = {}
    for key in ("max_err", "square_max_err", "square_vs_refresh", "cts_max_err",
                "stc_max_err"):
        pts = [(math.log2(r["N"]), math.log2(r[key])) for r in rows if r.get(key)]
        if len(pts) < 2:
            continue
        x, y = np.array(pts).T
        b, a = np.polyfit(x, y, 1)
        pred = 2.0 ** (a + b * predict_log_n)
        out[key] = {"slope": float(b), "points": len(pts), "predicted": pred,
                    "gate": 2 * pred}
    return {"fit": out, "predict_N": 1 << predict_log_n}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("port", "reference"), required=True)
    ap.add_argument("--log-n", type=int, nargs="+", default=[10])
    ap.add_argument("--stage", choices=("refresh", "dft", "both"), default="both")
    ap.add_argument("--chain", choices=("generate", "matched"), default="generate")
    ap.add_argument("--predict", type=int, default=16)
    args = ap.parse_args()
    p = _package(args.impl)
    rows = []
    for log_n in args.log_n:
        for stage in (("refresh", "dft") if args.stage == "both" else (args.stage,)):
            row = (refresh if stage == "refresh" else dft)(p, 1 << log_n, args.chain)
            row["impl"], row["chain"] = args.impl, args.chain
            print(json.dumps(row), flush=True)
            rows.append(row)
    if len(args.log_n) > 1:
        print(json.dumps(fit(rows, args.predict)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
