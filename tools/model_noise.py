#!/usr/bin/env python3
"""Decode error and level path of the encrypted comparison and matrix
product recipes, for either package, at reduced rings, with the error's
growth fitted over N.

    python -m tools.model_noise --impl reference --op compare --log-n 8 --depth 20
    python -m tools.model_noise --impl port --op compare --log-n 8 9 10 --depth 20 \\
        --chain-ring 65536
    python -m tools.model_noise --impl port --device cuda --op compare --log-n 8 ... 14
    python -m tools.model_noise --impl reference --op matmul --d 4 8 16 32

``compare`` is ``examples/encrypted_compare.py``'s recipe at ring N:
``build_modulus_chain(R, 30, depth)`` (q0 of the helper's default 40 bits,
then primes alternating around 2^30), ``CkksParams(3.2, N/2, 30)``, keys
from ``make_rng(42)`` with a lazy ``KeyLadder``, N/2 slots of a, b from
``np.random.default_rng(7)`` with |a - b| in [0.25, 0.95]; then
``compare``, ``eval_max`` and ``eval_relu`` (of a - b) with g_iters = 1,
f_iters = 2, each on the same two ciphertexts. R is N, or ``--chain-ring``:
NTT primes of a larger ring serve every smaller one, and the level path (the
levels each op consumes and the levels where ``funceval._combine`` heals a
scale mismatch) depends only on the primes, so a small ring on the primes
of 2^16 shows the level path of the full-width run.

``matmul`` is ``examples/encrypted_matmul.py``'s recipe at d x d, N = 2 d^2:
``generate_primes(30, 5, N)``, ``CkksParams(3.2, N/2, 30)``, keys from
``make_rng(42)``, a lazy ladder and ``MatvecKeys``, A and B uniform in
[-1, 1] / sqrt(d) from ``np.random.default_rng(7)``; then
``encrypted_matmul`` against A @ B and ``encrypted_transpose`` of A against
A.T.

Each run imports one package (the port on ``--device``, the CPU by
default) and prints one JSON line per N (or d) and op, with the output
level, the heals, the max decode error, the seconds and the SHA-256 of the
output's residues (the reference's uint32 limb layout), equal when the
words are. With two or more rings, a last line fits log2(err) = a + b
log2(N) per op by least squares and gives the prediction at --predict
(default N = 2^16 for compare, d = 64 for matmul) and twice it.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import math
import time

import numpy as np

SCALE, KEY_SEED, VALUE_SEED = 30, 42, 7
SIGN_KW = dict(g_iters=1, f_iters=2)
MATMUL_PRIMES = 5


def _package(impl: str, device: str) -> dict:
    """The package's entry points, and how to read its words."""
    if impl == "port":
        import torch

        import toy_heaan_ckks_tpu_torch as pkg
        from toy_heaan_ckks_tpu_torch.convert import to_reference
        from toy_heaan_ckks_tpu_torch.math.sampling import make_rng

        name = "toy_heaan_ckks_tpu_torch"
        build = lambda m, n: pkg.CkksContext.build(m, n, device=device)
        words = to_reference
        sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
    else:
        import toy_heaan_ckks_tpu as pkg
        from toy_heaan_ckks_tpu.math.sampling import make_rng

        name = "toy_heaan_ckks_tpu"
        build = pkg.CkksContext.build
        words = lambda x: np.asarray(x, dtype=np.uint32)
        sync = lambda: None
    return dict(pkg=pkg, build=build, words=words, make_rng=make_rng, sync=sync,
                cmp=importlib.import_module(f"{name}.models.compare"),
                la=importlib.import_module(f"{name}.models.linalg"),
                alg=importlib.import_module(f"{name}.models.algorithms"),
                params=importlib.import_module(f"{name}.utils.params"))


def digest(words, ct) -> str:
    h = hashlib.sha256()
    for part in (ct.c0.data, ct.c1.data):
        h.update(np.ascontiguousarray(words(part)).tobytes())
    return h.hexdigest()


def compare_inputs(slots: int) -> tuple:
    """a, b with the margin contract of examples/encrypted_compare.py."""
    m_rng = np.random.default_rng(VALUE_SEED)
    lo = m_rng.uniform(0.0, 0.35, slots)
    hi = lo + m_rng.uniform(0.25, 0.6, slots)
    swap = m_rng.uniform(size=slots) < 0.5
    return np.where(swap, lo, hi), np.where(swap, hi, lo)


def compare_setup(p: dict, n: int, depth: int, chain_ring: int) -> dict:
    pkg = p["pkg"]
    plan = p["params"].build_modulus_chain(chain_ring, SCALE, depth)
    ctx = p["build"](list(plan.moduli), n)
    params = pkg.CkksParams(3.2, n // 2, SCALE)
    eng = pkg.CkksEngine(ctx, params)
    enc = pkg.CkksEncoder(n, SCALE)
    rng = p["make_rng"](KEY_SEED)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    ladder = pkg.KeyLadder(ctx, sk, 3.2, rng, lazy=True)
    a, b = compare_inputs(n // 2)
    ct_a = eng.encrypt(enc.encode(a, ctx), pk, ctx.total_bits(), rng)
    ct_b = eng.encrypt(enc.encode(b, ctx), pk, ctx.total_bits(), rng)
    return dict(ctx=ctx, params=params, enc=enc, sk=sk, ladder=ladder, a=a, b=b,
                ct_a=ct_a, ct_b=ct_b)


def compare_ops(p: dict, s: dict) -> dict:
    """op name -> (the call, the plain result)."""
    cmp, eng = p["cmp"], p["pkg"].CkksEngine
    lad, prm, ca, cb, a, b = (s["ladder"], s["params"], s["ct_a"], s["ct_b"], s["a"],
                              s["b"])
    return {
        "compare": (lambda: cmp.compare(lad, prm, ca, cb, **SIGN_KW), (a > b).astype(float)),
        "eval_max": (lambda: cmp.eval_max(lad, prm, ca, cb, **SIGN_KW), np.maximum(a, b)),
        "eval_relu": (lambda: cmp.eval_relu(lad, prm, eng.sub_ciphertexts(ca, cb), **SIGN_KW),
                      np.maximum(a - b, 0.0)),
    }


class Heals:
    """Records the level of every ``normalize_scale`` (a scale heal of
    ``funceval._combine``, one level each) while active."""

    def __init__(self, alg):
        self.alg, self.levels = alg, []

    def __enter__(self):
        self.normalize = self.alg.normalize_scale

        def counted(engine, ct, target):
            self.levels.append(ct.level)
            return self.normalize(engine, ct, target)

        self.alg.normalize_scale = counted
        return self

    def __exit__(self, *exc):
        self.alg.normalize_scale = self.normalize
        return False


def decode(p: dict, s: dict, ct, slots: int) -> np.ndarray:
    pt = p["pkg"].CkksEngine.decrypt(ct, s["sk"].reduce_to(ct.ctx))
    return s["enc"].decode(pt)[:slots]


def run_compare(p: dict, n: int, depth: int, chain_ring: int) -> list:
    s = compare_setup(p, n, depth, chain_ring)
    rows = []
    for op, (call, want) in compare_ops(p, s).items():
        p["sync"]()
        t0 = time.perf_counter()
        with Heals(p["alg"]) as heals:
            try:
                out = call()
            except ValueError as exc:  # the chain ran out of levels
                rows.append({"N": n, "op": op, "depth": depth, "chain_ring": chain_ring,
                             "heal_levels": heals.levels,
                             "failed": f"{type(exc).__name__}: {exc}"})
                continue
        p["sync"]()
        seconds = time.perf_counter() - t0
        err = float(np.max(np.abs(decode(p, s, out, n // 2) - want)))
        rows.append({"N": n, "op": op, "depth": depth, "chain_ring": chain_ring,
                     "input_level": s["ct_a"].level, "output_level": out.level,
                     "heal_levels": heals.levels, "max_err": err, "seconds": seconds,
                     "sha256": digest(p["words"], out)})
    return rows


def matmul_setup(p: dict, d: int) -> dict:
    pkg = p["pkg"]
    n = 2 * d * d
    ctx = p["build"](pkg.generate_primes(SCALE, MATMUL_PRIMES, n), n)
    params = pkg.CkksParams(3.2, n // 2, SCALE)
    eng = pkg.CkksEngine(ctx, params)
    enc = pkg.CkksEncoder(n, SCALE)
    rng = p["make_rng"](KEY_SEED)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    ladder = pkg.KeyLadder(ctx, sk, 3.2, rng, lazy=True)
    keys = p["la"].MatvecKeys(ladder, params, rng)
    m_rng = np.random.default_rng(VALUE_SEED)
    a = m_rng.uniform(-1.0, 1.0, (d, d)) / np.sqrt(d)
    b = m_rng.uniform(-1.0, 1.0, (d, d)) / np.sqrt(d)
    ct_a = eng.encrypt(enc.encode(a.reshape(-1), ctx), pk, ctx.total_bits(), rng)
    ct_b = eng.encrypt(enc.encode(b.reshape(-1), ctx), pk, ctx.total_bits(), rng)
    return dict(ctx=ctx, enc=enc, sk=sk, keys=keys, a=a, b=b, ct_a=ct_a, ct_b=ct_b)


def run_matmul(p: dict, d: int) -> list:
    s = matmul_setup(p, d)
    la, n = p["la"], 2 * d * d
    ops = {"encrypted_matmul": (lambda: la.encrypted_matmul(s["ct_a"], s["ct_b"], s["keys"],
                                                            s["enc"]), s["a"] @ s["b"]),
           "encrypted_transpose": (lambda: la.encrypted_transpose(s["ct_a"], s["keys"],
                                                                  s["enc"]), s["a"].T)}
    rows = []
    for op, (call, want) in ops.items():
        p["sync"]()
        t0 = time.perf_counter()
        out = call()
        p["sync"]()
        seconds = time.perf_counter() - t0
        got = decode(p, s, out, d * d).reshape(d, d)
        rows.append({"N": n, "d": d, "op": op, "input_level": s["ct_a"].level,
                     "output_level": out.level,
                     "max_err": float(np.max(np.abs(got - want))), "seconds": seconds,
                     "sha256": digest(p["words"], out)})
    return rows


def fit(rows: list, x_key: str, predict: float) -> dict:
    """log2(err) = a + b log2(x) by least squares, per op."""
    out = {}
    for op in dict.fromkeys(r["op"] for r in rows):
        pts = [(math.log2(r[x_key]), math.log2(r["max_err"])) for r in rows
               if r["op"] == op and r.get("max_err")]
        if len(pts) < 2:
            continue
        x, y = np.array(pts).T
        b, a = np.polyfit(x, y, 1)
        pred = 2.0 ** (a + b * math.log2(predict))
        out[op] = {"slope": float(b), "points": len(pts), "predicted": pred,
                   "gate": 2 * pred}
    return {"fit": out, f"predict_{x_key}": predict}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("port", "reference"), required=True)
    ap.add_argument("--device", default="cpu", help="the port's device (cpu or cuda)")
    ap.add_argument("--op", choices=("compare", "matmul"), default="compare")
    ap.add_argument("--log-n", type=int, nargs="+", default=[8])
    ap.add_argument("--depth", type=int, nargs="+", default=[16])
    ap.add_argument("--chain-ring", type=int, default=None,
                    help="the ring whose NTT primes build the chain (default N)")
    ap.add_argument("--d", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--predict", type=float, default=None)
    args = ap.parse_args()
    p = _package(args.impl, args.device)
    rows = []
    if args.op == "compare":
        for depth in args.depth:
            for log_n in args.log_n:
                n = 1 << log_n
                for row in run_compare(p, n, depth, args.chain_ring or n):
                    row["impl"] = args.impl
                    print(json.dumps(row), flush=True)
                    rows.append(row)
        if len(args.log_n) > 1:
            print(json.dumps(fit(rows, "N", args.predict or 1 << 16)))
    else:
        for d in args.d:
            for row in run_matmul(p, d):
                row["impl"] = args.impl
                print(json.dumps(row), flush=True)
                rows.append(row)
        if len(args.d) > 1:
            print(json.dumps(fit(rows, "d", args.predict or 64)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
