#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``toy_heaan_ckks_tpu_torch/csrc`` and
runs, in order (every phase raises on failure), on two paths:

- small: N = 2^14, 8 x 31-bit primes, digit_size 4, batch 32 (kernels K1
  NTT, K2 key switch, K3 mod-down on uint32 words);
- wide: N = 2^13, 4 x 61-bit primes, digit_size 1, batch 8 (kernels K5/K7
  NTT, K6 key switch, K8 mod-down on uint64 words).

1. the card (``nvidia-smi`` name and power limit), torch / CUDA / nvcc
   versions and the kernel build time (one nvcc per source, in parallel);
2. each kernel against its plain torch twin on the same CUDA inputs at each
   path's shapes — forward, inverse with folded constants and yhat
   emission of the NTT, the key switch, the mod-down — plus the wide
   kernels once at N = 2^14, 3 x 62-bit, ds 1, batch 2 (63-bit special,
   128 KiB uint64 plane); word equality required;
3. each main path through the user entry points, with every launch count
   set to 0 just before it and read just after: generate_primes ->
   CkksEngine -> sk / pk / relin key (seed 42) -> encode + encrypt 2 x B
   vectors -> ``batched_mul_relin_rescale`` on the batch and
   ``CkksEngine.mul_rescale`` on one pair -> decrypt + decode. The first 2
   items must equal the CPU twin's result bit for bit, the decoded error
   against a*b must stay within the path's bound (1e-3 small, 1e-6 wide),
   and every kernel of the path must have launched;
4. CUDA-event timings of each kernel and its twin, the least time the card
   could take for the kernel's work (bytes over 3.35 TB/s, or integer
   operations over the int32 issue rate), the composite (mults/s at the
   path's batch, latency at batch 1) and a profiler split of each
   composite's device time into the kernels and the torch glue.

The last line is ``{"ok": true, "device": {...}}``; the line before it is a
JSON summary of the kernels. Exits non-zero, printing no result, when no
CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # INT32 lanes per SM per clock (Hopper white paper)

# Integer operations per modular primitive, counted from csrc/ntt.cuh as
# 32-bit integer instructions (a lower bound: a 64-bit add, subtract,
# compare or select is 2, a 64x64 low product 3 IMADs, __umul64hi 4).
OPS = {
    32: dict(harvey=6, add=3, sub=3, redc=5),
    64: dict(harvey=18, add=8, sub=8, redc=26),
}


@dataclasses.dataclass(frozen=True)
class PathConfig:
    name: str
    degree: int
    bits: int
    count: int
    digit_size: int
    batch: int
    scale_bits: int  # the benchmark's CkksParams(3.2, N // 2, bits)
    max_decode_err: float


SMALL = PathConfig("small", 1 << 14, 31, 8, 4, 32, 31, 1e-3)
WIDE = PathConfig("wide", 1 << 13, 61, 4, 1, 8, 61, 1e-6)
WIDE_62 = PathConfig("wide-62b", 1 << 14, 62, 3, 1, 2, 62, 1e-6)


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
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


def _rand_planes(rng, lead: tuple, moduli, degree: int, device, dtype):
    import numpy as np
    import torch

    planes = np.stack(
        [rng.integers(0, q, size=lead + (degree,), dtype=np.int64) for q in moduli],
        axis=-2,
    )
    return torch.from_numpy(planes).to(device, dtype)


def _same(name: str, got, want) -> int:
    """Require bit equality; returns the max |difference| (0)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = int((got.long() - want.long()).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from twin (max |diff| {err})")
    bits = 32 if got.dtype == torch.int32 else 64
    print(f"check {name}: kernel == twin (tolerance: exact, uint{bits} "
          f"equality), shape {tuple(got.shape)}")
    return err


@dataclasses.dataclass
class Case:
    """One kernel call at a path's shapes: the kernel, its twin, and the
    bytes and integer operations of the work (for the bound)."""

    kernel: object
    twin: object
    bytes: int
    ops: int


def kernel_cases(cfg: PathConfig, dev, wide: bool) -> dict:
    """The kernel/twin pairs of one path at its shapes, on random inputs."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch import CkksContext, generate_primes
    from toy_heaan_ckks_tpu_torch.keys import default_special_primes
    from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu as ksg
    from toy_heaan_ckks_tpu_torch.ops import moddown_gpu as mdg
    from toy_heaan_ckks_tpu_torch.ops.ntt_gpu import (
        ntt_planes, ntt_planes_wide, ntt_twin,
    )
    from toy_heaan_ckks_tpu_torch.ops.small_fast import _dec_inv_ints, _fold_consts

    n, B, ds = cfg.degree, cfg.batch, cfg.digit_size
    primes = tuple(generate_primes(cfg.bits, cfg.count, n))
    ctx = CkksContext.build(primes, n, dev)
    specials = default_special_primes(ctx, ds)
    ext = primes + specials
    L, E = len(primes), len(ext)
    dropped, child = ext[L - 1:], primes[:-1]
    G, Lc = len(dropped), len(child)
    D = -(-L // min(ds, L))
    p_specials = int(np.prod([int(p) for p in specials], dtype=object))
    dtype, rb = (torch.int64, 64) if wide else (torch.int32, 32)
    w = rb // 8  # bytes per word
    rng = np.random.Generator(np.random.PCG64(1234))
    planes = lambda lead, mod: _rand_planes(rng, lead, mod, n, dev, dtype)

    post = _dec_inv_ints(primes, ds)
    if wide:
        ntt, accumulate, mod_down = (ntt_planes_wide, ksg.gadget_accumulate_wide,
                                     mdg.mod_down_combine_wide)
        dec_fin = mdg._fold_consts_wide(primes, n, post)
        yfin = mdg._down_consts_wide(child, dropped, n)[6]
    else:
        ntt, accumulate, mod_down = (ntt_planes, ksg.gadget_accumulate,
                                     mdg.mod_down_combine)
        dec_fin = _fold_consts(primes, n, post)
        yfin = mdg._down_consts(child, dropped, n)[6]
    x, x_drop = planes((B,), primes), planes((B,), dropped)
    y, d = planes((B,), primes), planes((B,), primes)
    key_a, key_b = planes((D,), ext), planes((D,), ext)
    yhat = planes((B,), dropped)
    ks_full, t_full = planes((B,), ext), planes((B,), primes)
    ks, t = ks_full[..., :Lc, :], t_full[..., :Lc, :]
    ks_kw = dict(base_moduli=primes, ext_moduli=ext, degree=n,
                 digit_size=ds, d_ntt=d)
    md_kw = dict(child_moduli=child, dropped_moduli=dropped, degree=n,
                 t_scale=p_specials)

    op = OPS[rb]
    log_n = n.bit_length() - 1
    bfly = op["harvey"] + op["add"] + op["sub"]
    ntt_ops = n // 2 * log_n * bfly  # one plane
    plane = n * w

    def ntt_work(channels: int, final: bool):
        ops = B * channels * (ntt_ops + (n * op["harvey"] if final else 0))
        return 2 * B * channels * plane + 2 * channels * plane, ops

    ks_ops = 0  # per item; d is given, so a base channel skips its own digit
    for j in range(E):
        for t_ in range(D):
            k_count = min(ds, L - t_ * ds)
            if j < L and t_ == j // ds:
                ks_ops += n * 2 * op["redc"]
            else:
                ks_ops += (n * k_count * (op["harvey"] + op["add"]) + ntt_ops
                           + n * 2 * (op["redc"] + op["add"]))
    ks_bytes = (2 * B * L + 2 * D * E + 2 * E + 2 * B * E) * plane
    md_ops = B * Lc * (n * G * (op["harvey"] + op["add"]) + ntt_ops
                       + n * (2 * op["harvey"] + op["add"] + op["sub"]))
    md_bytes = (B * G + 2 * B * Lc + 2 * Lc + B * Lc) * plane

    return {
        "forward": Case(lambda: ntt(x, primes, n, False),
                        lambda: ntt_twin(x, primes, n, False),
                        *ntt_work(L, False)),
        "inverse+fold": Case(lambda: ntt(x, primes, n, True, dec_fin),
                             lambda: ntt_twin(x, primes, n, True, dec_fin),
                             *ntt_work(L, True)),
        "inv_ntt_to_yhat": Case(lambda: ntt(x_drop, dropped, n, True, yfin),
                                lambda: ntt_twin(x_drop, dropped, n, True, yfin),
                                *ntt_work(G, True)),
        "gadget_accumulate": Case(
            lambda: accumulate(y, key_a, key_b, **ks_kw),
            lambda: ksg.gadget_accumulate_twin(y, key_a, key_b, primes, ext, n,
                                               ds, d),
            ks_bytes, B * ks_ops),
        "mod_down_combine": Case(
            lambda: mod_down(yhat, ks, t, **md_kw),
            lambda: mdg.mod_down_combine_twin(yhat, ks, t, child, dropped, n,
                                              p_specials),
            md_bytes, md_ops),
    }


def check_cases(label: str, cases: dict) -> dict:
    """Every kernel against its twin; max |kernel - twin| per case."""
    import torch

    errs = {}
    for name, case in cases.items():
        got, want = case.kernel(), case.twin()
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        errs[name] = max(_same(f"{label} {name}[{i}]", g, w)
                         for i, (g, w) in enumerate(pairs))
    return errs


def run_path(cfg: PathConfig, dev, counters) -> dict:
    """Phase 3 on one path: the main path through the user entry points,
    checked against a*b, the CPU twin and the launch counts."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch import (
        CkksContext, CkksEncoder, CkksEngine, CkksParams, generate_primes,
    )
    from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
    from toy_heaan_ckks_tpu_torch.ops.poly import Poly
    from toy_heaan_ckks_tpu_torch.parallel.sharded import (
        _mul_relin_rescale_arrays, batched_mul_relin_rescale,
    )
    from toy_heaan_ckks_tpu_torch.types import Ciphertext

    n, B = cfg.degree, cfg.batch
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    ctx = CkksContext.build(generate_primes(cfg.bits, cfg.count, n), n,
                            device=dev)
    eng = CkksEngine(ctx, CkksParams(3.2, n // 2, cfg.scale_bits))
    key_rng = make_rng(SEED)
    sk = eng.generate_secret_key(key_rng)
    pk = eng.generate_public_key(sk, key_rng)
    rlk = eng.generate_gadget_relin_key(sk, key_rng, digit_size=cfg.digit_size)
    torch.cuda.synchronize()
    print(f"[{cfg.name}] keygen: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    enc = CkksEncoder(n, cfg.scale_bits)
    val_rng = make_rng(SEED + 1)
    va = val_rng.uniform(-1, 1, size=(B, n // 2))
    vb = val_rng.uniform(-1, 1, size=(B, n // 2))
    cts_a = [eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), key_rng) for v in va]
    cts_b = [eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), key_rng) for v in vb]
    stack = lambda cts, part: torch.stack([getattr(c, part).data for c in cts])
    a0, a1, b0, b1 = (stack(cts_a, "c0"), stack(cts_a, "c1"),
                      stack(cts_b, "c0"), stack(cts_b, "c1"))
    torch.cuda.synchronize()
    print(f"[{cfg.name}] encode+encrypt 2x{B}: {time.perf_counter() - t0:.2f} s")

    child_ctx = ctx.drop_last(1)
    o0, o1 = batched_mul_relin_rescale((a0, a1), (b0, b1), rlk, ctx, child_ctx)
    single = CkksEngine.mul_rescale(cts_a[0], cts_b[0], rlk)
    torch.cuda.synchronize()
    if not (torch.equal(single.c0.data, o0[0]) and torch.equal(single.c1.data, o1[0])):
        raise AssertionError(f"[{cfg.name}] CkksEngine.mul_rescale differs from batch item 0")
    if o0.shape != (B, cfg.count - 1, n) or o0.dtype != ctx.chain.dtype:
        raise AssertionError(f"[{cfg.name}] unexpected output {tuple(o0.shape)} {o0.dtype}")

    sk_child = sk.reduce_to(child_ctx)
    max_err = 0.0
    for i in range(2):
        ct = Ciphertext(
            c0=Poly(o0[i], child_ctx, True), c1=Poly(o1[i], child_ctx, True),
            logp=single.logp, logq=single.logq, scale=single.scale,
        )
        got = enc.decode(eng.decrypt(ct, sk_child))
        if got.shape != (n // 2,) or not np.all(np.isfinite(got)):
            raise AssertionError(f"[{cfg.name}] decode {i}: bad shape or non-finite values")
        max_err = max(max_err, float(np.max(np.abs(got - va[i] * vb[i]))))
    launches = {f.__name__: f.launches for f in counters}
    print(f"[{cfg.name}] decode max |err| vs a*b over 2 items: {max_err:.3e} "
          f"(bound {cfg.max_decode_err})")
    print(f"[{cfg.name}] main-path launches: {launches}")
    if max_err > cfg.max_decode_err:
        raise AssertionError(f"[{cfg.name}] decode error {max_err} > {cfg.max_decode_err}")
    if min(launches.values()) < 1:
        raise AssertionError(f"[{cfg.name}] a kernel of the path never launched: {launches}")

    # the first 2 items again, through the twins on the CPU
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    ctx_cpu = CkksContext.build(ctx.moduli, n, cpu)
    ext_cpu = CkksContext.build(rlk.ext_ctx.moduli, n, cpu)
    c0, c1 = _mul_relin_rescale_arrays(
        a0[:2].cpu(), a1[:2].cpu(), b0[:2].cpu(), b1[:2].cpu(),
        rlk.a.cpu(), rlk.b.cpu(), ctx_cpu, ext_cpu, ctx_cpu.drop_last(1),
        digit_size=rlk.digit_size,
    )
    if not (torch.equal(c0, o0[:2].cpu()) and torch.equal(c1, o1[:2].cpu())):
        raise AssertionError(f"[{cfg.name}] GPU composite differs from the CPU twin")
    print(f"check [{cfg.name}] composite: GPU items 0..1 == CPU twin "
          f"({time.perf_counter() - t0:.2f} s on the CPU)")
    return dict(launches=launches, ctx=ctx, child=child_ctx, rlk=rlk,
                batch=(a0, a1, b0, b1))


def time_path(cfg: PathConfig, cases: dict, errs: dict, run: dict, names: dict,
              int_ops_per_s: float, twin_iters: int) -> list:
    """Phase 4 on one path: kernel / twin times, bounds, the composite."""
    from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_mul_relin_rescale

    times = {}
    for name, case in cases.items():
        ms = _cuda_ms(case.kernel, 100, warmup=10)
        plain_ms = _cuda_ms(case.twin, twin_iters, warmup=1)
        bytes_ms = case.bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = case.ops / int_ops_per_s * 1e3
        times[name] = (ms, plain_ms, max(bytes_ms, ops_ms),
                       "bytes" if bytes_ms >= ops_ms else "operations")
        print(f"time [{cfg.name}] {name}: kernel {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms ({plain_ms / ms:.1f}x); bound "
              f"{times[name][2]:.4f} ms by {times[name][3]} "
              f"({case.bytes} B, {case.ops} int ops; {times[name][2] / ms:.1%} of it)")
    fwd_ms = times["forward"][0]
    print(f"time [{cfg.name}] per channel-NTT (forward, {cfg.batch}x{cfg.count} "
          f"planes): {fwd_ms * 1000 / (cfg.batch * cfg.count):.3f} us")

    rows = []
    for case_name, (fn, src, rep) in names.items():
        ms, plain_ms, bound_ms, bound_by = times[case_name]
        rows.append({
            "name": fn, "route": "cuda",
            "source": f"toy_heaan_ckks_tpu_torch/{src}", **rep,
            "launches": run["launches"][fn],
            "max_abs_err": max(e for k, e in errs.items()
                               if k in _same_kernel(case_name)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        })

    ctx, child, rlk = run["ctx"], run["child"], run["rlk"]
    a0, a1, b0, b1 = run["batch"]
    batch_ms = _cuda_ms(
        lambda: batched_mul_relin_rescale((a0, a1), (b0, b1), rlk, ctx, child), 10)
    one = (a0[:1], a1[:1], b0[:1], b1[:1])
    one_ms = _cuda_ms(
        lambda: batched_mul_relin_rescale(one[:2], one[2:], rlk, ctx, child), 20)
    print(f"time [{cfg.name}] composite batch {cfg.batch}: {batch_ms:.4f} ms/batch = "
          f"{cfg.batch * 1000 / batch_ms:.1f} mults/s")
    print(f"time [{cfg.name}] composite batch 1: {one_ms:.4f} ms latency")
    return rows


def _same_kernel(case_name: str) -> tuple:
    """The cases that run the kernel a JSON row stands for."""
    if case_name == "inverse+fold":
        return ("forward", "inverse+fold", "inv_ntt_to_yhat")
    return (case_name,)


def profile_composite(label: str, fn, iters: int = 5) -> None:
    """Device time of ``fn`` split into the port's kernels and the rest
    (torch elementwise glue), from torch.profiler over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    split = {"ntt_kernel": 0.0, "keyswitch_kernel": 0.0, "moddown_kernel": 0.0,
             "other": 0.0}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA or not us:
            continue
        key = next((k for k in split if k in ev.key), "other")
        split[key] += us / 1e3 / iters
    busy = sum(split.values())
    parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
    print(f"profile [{label}]: device ms/call: {parts}; busy {busy:.4f}, wall "
          f"{wall:.4f} (under the profiler), idle {1 - busy / wall:.1%}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from toy_heaan_ckks_tpu_torch.ops import _build
    from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu as ksg
    from toy_heaan_ckks_tpu_torch.ops import moddown_gpu as mdg
    from toy_heaan_ckks_tpu_torch.ops import ntt_gpu
    from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_mul_relin_rescale

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ── phase 1: card, versions, build ──────────────────────────────────
    print(_smi("name,power.limit"))  # the card's name and power limit
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    int_ops_per_s = INT32_LANES_PER_SM * torch.cuda.get_device_properties(0) \
        .multi_processor_count * clock_mhz * 1e6
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, nvcc: {_nvcc_line(_build._nvcc())}; "
          f"max SM clock {clock_mhz:.0f} MHz -> int32 issue "
          f"{int_ops_per_s / 1e12:.2f} Tops/s")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    small_counters = (ntt_gpu.ntt_planes, ksg.gadget_accumulate, mdg.mod_down_combine)
    wide_counters = (ntt_gpu.ntt_planes_wide, ksg.gadget_accumulate_wide,
                     mdg.mod_down_combine_wide)

    # ── phase 2: kernels vs twins at each path's shapes ─────────────────
    small_cases = kernel_cases(SMALL, dev, wide=False)
    small_errs = check_cases("K1-K3 small", small_cases)
    wide_cases = kernel_cases(WIDE, dev, wide=True)
    wide_errs = check_cases("K5-K8 wide", wide_cases)
    errs_62 = check_cases("K5-K8 wide 62b 2^14", kernel_cases(WIDE_62, dev, wide=True))
    for k, e in errs_62.items():
        wide_errs[k] = max(wide_errs[k], e)

    # ── phase 3: each main path through the user entry points ───────────
    small_run = run_path(SMALL, dev, small_counters)
    wide_run = run_path(WIDE, dev, wide_counters)

    # ── phase 4: timings (CUDA events, after warm-up) ───────────────────
    small_names = {
        "inverse+fold": ("ntt_planes", "csrc/ntt.cu",
                         {"replaces": "toy_heaan_ckks_tpu/ops/ntt_pallas.py:550"}),
        "gadget_accumulate": ("gadget_accumulate", "csrc/keyswitch.cu",
                              {"replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas.py:157"}),
        "mod_down_combine": ("mod_down_combine", "csrc/moddown.cu",
                             {"replaces": "toy_heaan_ckks_tpu/ops/moddown_pallas.py:173"}),
    }
    wide_names = {
        "inverse+fold": ("ntt_planes_wide", "csrc/ntt.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/ntt_pallas_wide.py:170",
            "also_replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:429"}),
        "gadget_accumulate": ("gadget_accumulate_wide", "csrc/keyswitch.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:144",
            "also_replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:184"}),
        "mod_down_combine": ("mod_down_combine_wide", "csrc/moddown.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:613"}),
    }
    rows = time_path(SMALL, small_cases, small_errs, small_run, small_names,
                     int_ops_per_s, twin_iters=5)
    rows += time_path(WIDE, wide_cases, wide_errs, wide_run, wide_names,
                      int_ops_per_s, twin_iters=2)
    for cfg, run in ((SMALL, small_run), (WIDE, wide_run)):
        ctx, child, rlk, (a0, a1, b0, b1) = (run["ctx"], run["child"], run["rlk"],
                                             run["batch"])
        profile_composite(f"{cfg.name} composite batch {cfg.batch}", lambda:
                          batched_mul_relin_rescale((a0, a1), (b0, b1), rlk, ctx, child))
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
