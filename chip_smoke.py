#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``toy_heaan_ckks_tpu_torch/csrc`` and
runs, in order (every phase raises on failure):

1. the card (``nvidia-smi`` name and power limit), torch / CUDA / nvcc
   versions and the kernel build time;
2. each kernel against its plain torch twin on the same CUDA inputs at the
   main path's shapes (N = 2^14, 8 x 31-bit primes, digit_size 4, batch
   32): K1 forward, inverse with folded constants and yhat emission; K2;
   K3 — uint32 equality required;
3. the main path through the user entry points: generate_primes ->
   CkksEngine -> sk / pk / relin key (seed 42) -> encode + encrypt 2 x 32
   vectors -> ``batched_mul_relin_rescale`` on the batch and
   ``CkksEngine.mul_rescale`` on one pair -> decrypt + decode. The first 2
   items must equal the CPU twin's result bit for bit, the decoded error
   against a*b must stay <= 1e-3, and every kernel must have launched;
4. CUDA-event timings of each kernel and its twin, and of the composite
   (mults/s at batch 32, latency at batch 1).

The last line is ``{"ok": true, "device": {...}}``; the line before it is a
JSON summary of the kernels. Exits non-zero, printing no result, when no
CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

DEGREE = 1 << 14
NUM_PRIMES = 8
PRIME_BITS = 31
DIGIT_SIZE = 4
BATCH = 32
SCALE_BITS = 31  # the benchmark's CkksParams(3.2, N // 2, 31)
SEED = 42
MAX_DECODE_ERR = 1e-3


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _nvcc_line(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60)
    return next(l for l in out.stdout.splitlines() if "release" in l).strip()


def _cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _rand_planes(rng, lead: tuple, moduli, degree: int, device):
    import numpy as np
    import torch

    planes = np.stack(
        [rng.integers(0, q, size=lead + (degree,), dtype=np.int64) for q in moduli],
        axis=-2,
    )
    return torch.from_numpy(planes.astype(np.int32)).to(device)


def _same(name: str, got, want) -> int:
    """Require bit equality; returns the max |difference| (0)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = int((got.long() - want.long()).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from twin (max |diff| {err})")
    print(f"check {name}: kernel == twin (tolerance: exact, uint32 equality), "
          f"shape {tuple(got.shape)}")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import numpy as np

    from toy_heaan_ckks_tpu_torch import (
        CkksContext, CkksEncoder, CkksEngine, CkksParams, generate_primes,
    )
    from toy_heaan_ckks_tpu_torch.keys import default_special_primes
    from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
    from toy_heaan_ckks_tpu_torch.ops import _build
    from toy_heaan_ckks_tpu_torch.ops.keyswitch_gpu import (
        gadget_accumulate, gadget_accumulate_twin,
    )
    from toy_heaan_ckks_tpu_torch.ops.moddown_gpu import (
        _down_consts, mod_down_combine, mod_down_combine_twin,
    )
    from toy_heaan_ckks_tpu_torch.ops.ntt_gpu import ntt_planes, ntt_twin
    from toy_heaan_ckks_tpu_torch.ops.poly import Poly
    from toy_heaan_ckks_tpu_torch.ops.small_fast import _dec_inv_ints, _fold_consts
    from toy_heaan_ckks_tpu_torch.parallel.sharded import (
        _mul_relin_rescale_arrays, batched_mul_relin_rescale,
    )
    from toy_heaan_ckks_tpu_torch.types import Ciphertext

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    n = DEGREE

    # ── phase 1: card, versions, build ──────────────────────────────────
    print(_smi_line())  # the card's name and power limit, as nvidia-smi prints them
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, nvcc: {_nvcc_line(_build._nvcc())}")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # ── phase 2: kernels vs twins at main-path shapes ───────────────────
    primes = tuple(generate_primes(PRIME_BITS, NUM_PRIMES, n))
    ctx = CkksContext.build(primes, n, dev)
    specials = default_special_primes(ctx, DIGIT_SIZE)
    ext = primes + specials
    L, E = len(primes), len(ext)
    dropped = ext[L - 1:]
    child = primes[:-1]
    p_specials = int(np.prod([int(p) for p in specials], dtype=object))
    rng = np.random.Generator(np.random.PCG64(1234))
    lead = (BATCH,)

    x = _rand_planes(rng, lead, primes, n, dev)
    dec_fin = _fold_consts(primes, n, _dec_inv_ints(primes, DIGIT_SIZE))
    x_drop = _rand_planes(rng, lead, dropped, n, dev)
    yfin = _down_consts(child, dropped, n)[6]
    y = _rand_planes(rng, lead, primes, n, dev)
    d = _rand_planes(rng, lead, primes, n, dev)
    key_a = _rand_planes(rng, (2,), ext, n, dev)
    key_b = _rand_planes(rng, (2,), ext, n, dev)
    yhat = _rand_planes(rng, lead, dropped, n, dev)
    ks_full = _rand_planes(rng, lead, ext, n, dev)
    t_full = _rand_planes(rng, lead, primes, n, dev)
    ks, t = ks_full[..., : L - 1, :], t_full[..., : L - 1, :]
    ks_kw = dict(base_moduli=primes, ext_moduli=ext, degree=n,
                 digit_size=DIGIT_SIZE, d_ntt=d)
    md_kw = dict(child_moduli=child, dropped_moduli=dropped, degree=n,
                 t_scale=p_specials)

    cases = {
        "K1 forward": (lambda: ntt_planes(x, primes, n, False),
                       lambda: ntt_twin(x, primes, n, False)),
        "K1 inverse+fold": (lambda: ntt_planes(x, primes, n, True, dec_fin),
                            lambda: ntt_twin(x, primes, n, True, dec_fin)),
        "K1 inv_ntt_to_yhat": (lambda: ntt_planes(x_drop, dropped, n, True, yfin),
                               lambda: ntt_twin(x_drop, dropped, n, True, yfin)),
        "K2 gadget_accumulate": (
            lambda: gadget_accumulate(y, key_a, key_b, **ks_kw),
            lambda: gadget_accumulate_twin(y, key_a, key_b, primes, ext, n,
                                           DIGIT_SIZE, d)),
        "K3 mod_down_combine": (
            lambda: mod_down_combine(yhat, ks, t, **md_kw),
            lambda: mod_down_combine_twin(yhat, ks, t, child, dropped, n,
                                          p_specials)),
    }
    errs = {}  # max |kernel - twin| per kernel, over all its cases
    for name, (kern, twin) in cases.items():
        got, want = kern(), twin()
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        err = max(_same(f"{name}[{i}]", g, w) for i, (g, w) in enumerate(pairs))
        errs[name[:2]] = max(errs.get(name[:2], 0), err)

    # ── phase 3: the main path through the user entry points ────────────
    counters = (ntt_planes, gadget_accumulate, mod_down_combine)
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    ctx = CkksContext.build(generate_primes(PRIME_BITS, NUM_PRIMES, n), n,
                            device=dev)
    eng = CkksEngine(ctx, CkksParams(3.2, n // 2, SCALE_BITS))
    key_rng = make_rng(SEED)
    sk = eng.generate_secret_key(key_rng)
    pk = eng.generate_public_key(sk, key_rng)
    rlk = eng.generate_gadget_relin_key(sk, key_rng, digit_size=DIGIT_SIZE)
    torch.cuda.synchronize()
    print(f"keygen: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    enc = CkksEncoder(n, SCALE_BITS)
    val_rng = make_rng(SEED + 1)
    va = val_rng.uniform(-1, 1, size=(BATCH, n // 2))
    vb = val_rng.uniform(-1, 1, size=(BATCH, n // 2))
    cts_a = [eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), key_rng) for v in va]
    cts_b = [eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), key_rng) for v in vb]
    stack = lambda cts, part: torch.stack([getattr(c, part).data for c in cts])
    a0, a1, b0, b1 = (stack(cts_a, "c0"), stack(cts_a, "c1"),
                      stack(cts_b, "c0"), stack(cts_b, "c1"))
    torch.cuda.synchronize()
    print(f"encode+encrypt 2x{BATCH}: {time.perf_counter() - t0:.2f} s")

    child_ctx = ctx.drop_last(1)
    o0, o1 = batched_mul_relin_rescale((a0, a1), (b0, b1), rlk, ctx, child_ctx)
    single = CkksEngine.mul_rescale(cts_a[0], cts_b[0], rlk)
    torch.cuda.synchronize()
    if not (torch.equal(single.c0.data, o0[0]) and torch.equal(single.c1.data, o1[0])):
        raise AssertionError("CkksEngine.mul_rescale differs from batch item 0")
    if o0.shape != (BATCH, NUM_PRIMES - 1, n) or o0.dtype != torch.int32:
        raise AssertionError(f"unexpected output {tuple(o0.shape)} {o0.dtype}")

    sk_child = sk.reduce_to(child_ctx)
    max_err = 0.0
    for i in range(2):
        ct = Ciphertext(
            c0=Poly(o0[i], child_ctx, True), c1=Poly(o1[i], child_ctx, True),
            logp=single.logp, logq=single.logq, scale=single.scale,
        )
        got = enc.decode(eng.decrypt(ct, sk_child))
        if got.shape != (n // 2,) or not np.all(np.isfinite(got)):
            raise AssertionError(f"decode {i}: bad shape or non-finite values")
        max_err = max(max_err, float(np.max(np.abs(got - va[i] * vb[i]))))
    launches = {f.__name__: f.launches for f in counters}
    print(f"decode max |err| vs a*b over 2 items: {max_err:.3e} "
          f"(bound {MAX_DECODE_ERR})")
    print(f"main-path launches: {launches}")
    if max_err > MAX_DECODE_ERR:
        raise AssertionError(f"decode error {max_err} > {MAX_DECODE_ERR}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # the first 2 items again, through the twins on the CPU
    cpu = torch.device("cpu")
    ctx_cpu = CkksContext.build(ctx.moduli, n, cpu)
    ext_cpu = CkksContext.build(rlk.ext_ctx.moduli, n, cpu)
    c0, c1 = _mul_relin_rescale_arrays(
        a0[:2].cpu(), a1[:2].cpu(), b0[:2].cpu(), b1[:2].cpu(),
        rlk.a.cpu(), rlk.b.cpu(), ctx_cpu, ext_cpu, ctx_cpu.drop_last(1),
        digit_size=rlk.digit_size,
    )
    if not (torch.equal(c0, o0[:2].cpu()) and torch.equal(c1, o1[:2].cpu())):
        raise AssertionError("GPU composite differs from the CPU twin")
    print("check composite: GPU items 0..1 == CPU twin")

    # ── phase 4: timings (CUDA events, after warm-up) ───────────────────
    rows = []
    replaces = {
        "K1 inverse+fold": ("ntt_planes", "csrc/ntt.cu",
                            "toy_heaan_ckks_tpu/ops/ntt_pallas.py:550"),
        "K2 gadget_accumulate": ("gadget_accumulate", "csrc/keyswitch.cu",
                                 "toy_heaan_ckks_tpu/ops/keyswitch_pallas.py:157"),
        "K3 mod_down_combine": ("mod_down_combine", "csrc/moddown.cu",
                                "toy_heaan_ckks_tpu/ops/moddown_pallas.py:173"),
    }
    times = {}
    for name, (kern, twin) in cases.items():
        ms = _cuda_ms(kern, 20)
        plain_ms = _cuda_ms(twin, 5)
        times[name] = (ms, plain_ms)
        print(f"time {name}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms "
              f"({plain_ms / ms:.1f}x)")
    fwd_ms = times["K1 forward"][0]
    print(f"time per channel-NTT (K1 forward, {BATCH}x{NUM_PRIMES} planes): "
          f"{fwd_ms * 1000 / (BATCH * NUM_PRIMES):.3f} us")
    for name, (fn, src, rep) in replaces.items():
        rows.append({
            "name": fn, "route": "cuda",
            "source": f"toy_heaan_ckks_tpu_torch/{src}", "replaces": rep,
            "launches": launches[fn], "max_abs_err": errs[name[:2]],
            "ms": times[name][0], "plain_ms": times[name][1],
        })

    batch_ms = _cuda_ms(
        lambda: batched_mul_relin_rescale((a0, a1), (b0, b1), rlk, ctx, child_ctx), 10)
    one = (a0[:1], a1[:1], b0[:1], b1[:1])
    one_ms = _cuda_ms(
        lambda: batched_mul_relin_rescale(one[:2], one[2:], rlk, ctx, child_ctx), 20)
    print(f"time composite batch {BATCH}: {batch_ms:.4f} ms/batch = "
          f"{BATCH * 1000 / batch_ms:.1f} mults/s")
    print(f"time composite batch 1: {one_ms:.4f} ms latency")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
