#!/usr/bin/env python3
"""The small chain with and without ``CKKS_NTT_MXU=1`` on the card, in turns.

    python tools/mxu_ab.py [--rounds 6]

Builds ``chip_smoke.py``'s small path (N = 2^14, 8 x 31-bit, digit_size 4,
batch 32; a relin key and rotation keys 1..8 from its seed) and times, in
each round, every call below once with the variable unset (K1 folds, the
fused K3' mod-down) and once set (K9), the order alternating between
rounds: the batched multiply at batch 32 (10 calls) and batch 1 (20),
``batched_rotate`` at batch 32 and 1 (20 each) and ``rotate_sum_hoisted``
with the 8 keys (5). Then K1's and K9's inverse fold alone at the
multiply's batch-1 and batch-32 shapes (100 launches), and a profiler
split of each dispatch's batch-1 multiply. Every time is the mean ms per
call of one loop (CUDA events after 2 warm-up calls). Prints one JSON
line: the card's name and power limit, and per metric and dispatch the
rounds' times and their median.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("mxu_ab: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from toy_heaan_ckks_tpu_torch import (
        CkksContext, CkksEncoder, CkksEngine, CkksParams, generate_primes,
    )
    from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
    from toy_heaan_ckks_tpu_torch.ops.ntt_gpu import ntt_planes
    from toy_heaan_ckks_tpu_torch.ops.ntt_mxu_gpu import ntt_mxu_planes
    from toy_heaan_ckks_tpu_torch.ops.small_fast import _dec_inv_ints, _fold_consts
    from toy_heaan_ckks_tpu_torch.parallel.sharded import (
        batched_mul_relin_rescale, batched_rotate,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = smoke.SMALL
    n, B = cfg.degree, cfg.batch
    ctx = CkksContext.build(generate_primes(cfg.bits, cfg.count, n), n, device=dev)
    eng = CkksEngine(ctx, CkksParams(3.2, n // 2, cfg.scale_bits))
    rng = make_rng(smoke.SEED)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=cfg.digit_size)
    keys = [eng.generate_gadget_rotation_key(sk, k, rng, digit_size=cfg.digit_size)
            for k in smoke.SMALL_ROT.offsets]
    enc = CkksEncoder(n, cfg.scale_bits)
    values = make_rng(smoke.SEED + 1).uniform(-1, 1, size=(2, B, n // 2))
    cts = [[eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng) for v in side]
           for side in values]
    a0, a1, b0, b1 = (torch.stack([getattr(c, part).data for c in cts[side]])
                      for side, part in ((0, "c0"), (0, "c1"), (1, "c0"), (1, "c1")))
    child = ctx.drop_last(1)
    mul = lambda k: batched_mul_relin_rescale((a0[:k], a1[:k]), (b0[:k], b1[:k]),
                                              rlk, ctx, child)
    calls = {
        f"mul B{B}": (lambda: mul(B), 10),
        "mul B1": (lambda: mul(1), 20),
        f"batched_rotate B{B}": (lambda: batched_rotate((a0, a1), keys[0], ctx), 20),
        "batched_rotate B1": (lambda: batched_rotate((a0[:1], a1[:1]), keys[0], ctx), 20),
        f"rotate_sum_hoisted ({len(keys)} keys)": (
            lambda: CkksEngine.rotate_sum_hoisted(cts[0][0], keys), 5),
    }
    dispatch = {"K1": contextlib.nullcontext, "K9": smoke.mxu_env}
    runs = {name: {d: [] for d in dispatch} for name in calls}
    for r in range(args.rounds):
        for d in (("K1", "K9") if r % 2 == 0 else ("K9", "K1")):
            with dispatch[d]():
                for name, (fn, iters) in calls.items():
                    runs[name][d].append(smoke._cuda_ms(fn, iters, warmup=2))

    post = _dec_inv_ints(ctx.moduli, cfg.digit_size)
    fin = _fold_consts(ctx.moduli, n, post)
    kernels = {}
    for k in (1, B):
        x, shape = a1[:k], f"({k}, {cfg.count}, 2^{n.bit_length() - 1})"
        kernels[f"K1 inverse+fold {shape}"] = smoke._cuda_ms(
            lambda: ntt_planes(x, ctx.moduli, n, True, fin), 100, warmup=10)
        kernels[f"K9 inverse+fold {shape}"] = smoke._cuda_ms(
            lambda: ntt_mxu_planes(x, ctx.moduli, n, True, post), 100, warmup=10)
    for d, env in dispatch.items():
        with env():
            smoke.profile_composite(f"mul B1, {d}", lambda: mul(1), iters=20)

    median = {name: {d: statistics.median(t) for d, t in by.items()}
              for name, by in runs.items()}
    print(json.dumps({"card": smoke._smi("name,power.limit"), "rounds": args.rounds,
                      "median_ms": median, "runs_ms": runs, "kernel_ms": kernels}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
