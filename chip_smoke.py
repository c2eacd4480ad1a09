#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``toy_heaan_ckks_tpu_torch/csrc`` and
runs, in order (every phase raises on failure), on four paths, and the
small one again with ``CKKS_NTT_MXU=1`` (K9, the matrix-product NTT, in
place of the K1 folds):

- small: N = 2^14, 8 x 31-bit primes, digit_size 4, batch 32 (kernels K1
  NTT, K2 key switch, K3 / K3' mod-down with / without t, on uint32
  words);
- wide: N = 2^13, 4 x 61-bit primes, digit_size 1, batch 8 (kernels K5/K7
  NTT, K6 key switch, K8 / K8' mod-down, on uint64 words, each plane on a
  thread-block cluster of register passes, csrc/ntt_cluster.cuh);
- big: N = 2^16, 4 x 30-bit primes, digit_size 2, batch 4 (bench.py's third
  configuration: K4 NTT, K2 key switch and K3 / K3', each plane over a
  thread-block cluster of 16 blocks of register passes,
  csrc/ntt_cluster.cuh, K2 one cluster NTT a digit);
- big-wide: N = 2^15, 3 x 61-bit primes, digit_size 1, batch 4
  (tools/ab_check.py's wide-2^15-61b-ds1: K5'/K7, K6 and K8 / K8' on the
  same cluster plan on uint64 words, 16 blocks a plane); its rotation
  phase runs ``batched_rotate`` and ``rotate_ciphertext`` only.

Every kernel of the small path must run with one block per plane, and
every launch of the wide paths (uint64 planes of 2^13 and 2^14, which one
block holds) and of the big paths on a cluster (``launches_cluster``
equal to ``launches``; ``read_counts``).

1. the card (``nvidia-smi`` name and power limit), torch / CUDA / nvcc
   versions and the kernel build time (one nvcc per source, in parallel);
2. each kernel against its plain torch twin on the same CUDA inputs at each
   path's shapes — forward, inverse with folded constants and yhat
   emission of the NTT, the key switch (on the small and big paths with
   and without the skip-own input d), the mod-down with t (multiply
   shapes) and without t (key-switch shapes: the whole base kept, the
   specials dropped) — plus the wide kernels once at N = 2^14, 3 x 62-bit,
   ds 1, batch 2 (63-bit special, 128 KiB uint64 plane) and once at
   N = 2^16, 2 x 61-bit, ds 1, batch 1 (K5'/K7, K6, K8 / K8' on
   clusters of 16 blocks); and K9 small,
   the matrix-product NTT (forward, inverse, inverse with the
   decomposition fold) against its twin and against K1 on the same
   inputs at (32, 8, 2^14), (1, 8, 2^14), (2, 2, 2^15) and (4, 3, 2^10)
   (``MXU_SHAPES``; the channel-run kernel up to R = 128, one block a
   plane at 2^15); and K10/K11
   coeff, the coefficient-sharded NTT (forward, inverse) on CUDA slabs,
   against its twin on the same slabs and the whole-plane kernel: K1 at
   (32, 8, 2^14) with P in {1, 2, 8} (P = 1: K10 alone), K4 at (4, 4, 2^16)
   with P in {4, 8}, K5' at (4, 3, 2^15) uint64 with P = 4, one K10
   launch per call and, for P >= 2, one K11 launch of its one-launch form
   (``coeff_cross_stages``: every cross stage at once, no per-stage
   launch), K10's on a cluster where ``coeff_ntt_gpu.slab_form`` picks
   one; and K10 (forward, inverse), K11 (one stage, and every stage of a
   transform in one launch, forward and inverse) and the sharded NTT
   against their twins at the three coeff case shapes that phase 4 times
   (``COEFF_CASES``); word equality required;
3. each multiply path through the user entry points, with every launch
   count set to 0 just before it and read just after: generate_primes ->
   CkksEngine -> sk / pk / relin key (seed 42) -> encode + encrypt 2 x B
   vectors -> ``batched_mul_relin_rescale`` on the batch and
   ``CkksEngine.mul_rescale`` on one pair -> decrypt + decode. The first 2
   items must equal the CPU twin's result bit for bit, the decoded error
   against a*b must stay within the path's bound (PathConfig), and every
   kernel of the path must have launched;
3b. each rotation path, counts again set to 0 just before and read just
   after: rotation keys for offsets 1..8 (wide: 1..3), -1 and a
   conjugation key from the same seed-42 stream -> ``batched_rotate`` of
   the batch by 1 (``rotate_ciphertext`` on item 0 must equal batch item
   0), ``rotate_ciphertext`` by -1, ``conjugate_ciphertext``,
   ``rotate_hoisted``, ``rotate_sum_hoisted`` and
   ``rotate_weighted_sum_hoisted`` + ``rescale_ciphertext`` -> decode
   within the path's bounds (RotateConfig); items 0..1 of the batched
   rotation equal to the CPU twin; K1, K2 and K3' (small) or K5/K7, K6 and
   K8' (wide) launched;
3c. small-mxu: the small path's multiply, rotation and hoisted calls of
   phases 3 and 3b again with ``CKKS_NTT_MXU=1`` (set for this phase
   only), on the same keys and ciphertexts: each output equal to the
   default path's word for word, ``ntt_lo`` (both directions),
   ``rescale_ntt_lo`` and ``mod_down_lo`` equal to their K1 forms, K9
   launched in every call (counts set to 0 just before, read just after),
   and the multiply's decomposition fold moved from K1 to K9;
3d. coeff: the coefficient-sharded multiply (``build_mul_relin_rescale_coeff``)
   and rotation (``build_rotate_coeff``) on a coefficient mesh whose shards
   all lie on the card, on phase 3's / 3b's batches and keys sharded with
   ``shard_planes``: big and big-wide on P = 4 (multiply and rotation by
   1), small on P = 8 (multiply); each output equal to the unsharded
   path's word for word, the multiply's decode within the path's bound,
   K10 and K11 launched in every call (counts set to 0 just before, read
   just after; one K11 launch of the one-launch form for each K10
   launch, none of the per-stage form), K10 on clusters on the big and
   big-wide paths (64 uint32
   slabs of 2^14 and 48 uint64 slabs of 2^13 a launch) and on none on the
   small one (2,048 slabs of 2^11), and no other kernel on a cluster;
3e. mesh: the batch x channel mesh (``make_ckks_mesh(8, batch)``, every
   grid point on the card) through ``build_mul_relin_rescale`` on phase
   3's batch and relin key, small on batch 2 (channels split over 4, keys
   and the 7-channel output replicated) and batch 4 (channels and keys
   split over 2, output replicated), wide on batch 2 (channels and keys
   split over 4), and ``build_rotate`` by 1 on phase 3b's small batch and
   key on batch 4; each output equal to the unsharded path's word for
   word with the builder's output spec, the multiplies' decode within the
   path's bound, and, with the counts set to 0 just before each call and
   read just after, every kernel of the path launched (K1, K2, K3 / K3'
   small; K5 / K7, K6, K8 wide), K2 / K6 on the digit ranges the plan
   deals at each batch point (``MESH_CALLS``), no K9, K10 or K11;
3f. bootstrap (``models/bootstrap.py``, the recipe of ``BootConfig``: the
   scale-matched chain of 37 primes near 2^30 with q0 near 2^31, ds 4, h 8,
   r 7, deg 8, dft_levels 3, arcsine): the whole refresh at N = 2^16
   through ``bootstrap`` (raise_modulus exact, CoeffToSlot's decode within
   BOOT_CTS_ERR, level 1 -> 4 on the level path of the 2^10 refresh on the
   same primes, EvalMod's first and last fused multiply equal to the CPU
   twin, the decode within BOOT_FULL_ERR and a square-and-rescale of the
   output within BOOT_SQUARE_ERR / BOOT_SQUARE_SELF_ERR; keygen, encode,
   stage and cold seconds and the peak device memory), and at N = 2^10
   (decode within BOOT_REFRESH_ERR, c0 / c1 equal to the port's CPU path
   from the same seeds, then a warm refresh with the keys kept); with the
   counts set to 0 just before each refresh and read just after, K1 / K4,
   K2, K3 and K3' launched (on clusters at 2^16, on none at 2^10) and no
   other kernel; phase 2 checks the four kernels at both rings' shapes
   (``boot_kernel_cases``);
3g. the last models, after phase 3f's rotation keys are freed and a line
   saying whether the native host runtime built: comparison
   (``models/compare.py``) at N = 2^16 on examples/encrypted_compare.py's
   recipe (``build_modulus_chain(2^16, 30, CMP_DEPTH)``, a wide chain with
   q0 of 40 bits, dense secret, g_iters 1, f_iters 2): ``compare``,
   ``eval_max`` and ``eval_relu`` cold and warm, each on the level path
   CMP_LEVELS, its decode within CMP_ERR, eval_sign's last fused multiply
   equal to the CPU twin, K5'/K7, K6 and K8 on clusters only and nothing
   else (no t-less mod-down: the comparison never rotates; counts set to 0
   just before each cold call, read just after), keygen seconds and peak
   device memory; ``compare`` at N = 2^10
   word-equal to the port's CPU path; linear algebra (``models/linalg.py``)
   at N = 2^13 on examples/encrypted_matmul.py's recipe (5 x 30-bit):
   ``encrypted_matmul`` of two encrypted 64 x 64 matrices,
   ``encrypted_transpose`` and a dense 4096 x 4096 ``encrypted_matvec``
   (BSGS), cold and warm with keygen, diagonal-encode and op seconds apart,
   each decode within LA_ERR of numpy, K1, K2 and K3' one block a plane and
   nothing else (its key switches and hoisted sums divide by P without t); ``encrypted_matmul`` at d = 16 (N = 2^9) word-equal to
   the CPU path;
4. the multiply composite (mults/s at the path's batch, latency at
   batch 1), timed first, before the process first runs torch.profiler;
   CUDA-event timings of each kernel (its device time from torch.profiler
   beside) and its twin, the least time the card could take for the
   kernel's work (bytes over 3.35 TB/s, or integer operations over the
   int32 instruction rate, or K9's u8 MACs over the dense int8 tensor
   rate), the batched rotation (rotations/s, batch-1
   latency), the hoisted calls, and profiler splits of the multiply
   composite and the batched rotation into the kernels and the torch glue;
   the same for the small path under ``CKKS_NTT_MXU=1`` (small-mxu), with
   K9 timed at (32, 8, 2^14) and (1, 8, 2^14) and the kernel it picks
   there (``ntt_mxu_gpu.mxu_form``: the channel-run kernel, planes a block,
   registers; the K9 row's ``shapes``); K10 and K11 (one stage, and every
   cross stage in one launch, the K11 row's form) against their twins and
   the whole sharded NTT against the
   whole-plane kernel at the big, small and big-wide coeff paths' planes
   (device time from the profiler: their wrappers' host work can outlast
   the kernels, so a loop of calls times the host), with K10's form at
   each (block or cluster, blocks a slab, registers, resident slabs; the
   K10 row's ``shapes``),
   and the big coeff
   multiply beside the unsharded one, with its profile; the small mesh
   multiplies of phase 3e at batch 32 beside the unsharded one (CUDA
   events, before the first profiler window, with the card's name and
   power limit) and their profiler splits. The small K1,
   K2, K3 and K3' rows also carry their register-pass kernel's registers,
   spill bytes, threads and shared memory a block, resident blocks an SM
   and SASS counts (beside the template's uint32 one-block form; K1's
   forward under ``forward``), and the K2 / K6 row of every path its time
   without d; the big K4, K2, K3 and K3' rows and the big-wide K5'/K7,
   K6, K8 and K8' rows name their cluster form and carry its registers,
   spill bytes, threads and shared memory a block, blocks a cluster (C),
   resident clusters and SASS counts (K4's and K5''s forward under
   ``forward``), as do the wide path's K5/K7, K6, K8 and K8' rows (their
   uint64 cluster forms at 2^13); the uint64 cluster forms are also timed
   at N = 2^16 (1, 2, 2^16), each with its form's registers and resident
   clusters, and those at 2^13 and 2^14 listed with theirs; the launches
   of phase 3f on the K1 / K4, K2, K3 and K3' rows, and profiler splits of
   the warm 2^10 refresh and the warm first level of the 2^16 CoeffToSlot;
   the launches of phase 3g's calls on the big-wide K5'/K7, K6, K8 and K8'
   rows (``launches_per_<op>_2^16``) and the small K1, K2, K3 and K3' rows
   (``launches_per_<op>_2^13``), and profiler splits of a warm fused
   multiply at the top of the comparison's chain and a warm encrypted_matmul
   at 2^13.

The last line is ``{"ok": true, "device": {...}}``; the line before it is a
JSON summary of the kernels. Exits non-zero, printing no result, when no
CUDA device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from typing import NamedTuple

SEED = 42
# decode bounds of the big paths' multiply: twice the JAX reference's max
# error on the CPU at the same N, seeds and draws, rounded up (python -m
# tools.big_decode --impl reference --path big: 8.755e-3 at N = 2^16 and
# scale 2^30, h = N/2; --path big-wide: 5.377e-13)
BIG_MUL_ERR = 1.8e-2
BIG_WIDE_MUL_ERR = 1.1e-12
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # INT32 lanes per SM per clock (Hopper white paper)
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores (NVIDIA data sheet)
PROFILE_CALLS = 50  # calls per profiler window of a kernel case's device time

# Integer operations per modular primitive, counted from csrc/ntt.cuh as
# 32-bit integer instructions (a lower bound: a 64-bit add, subtract,
# compare or select is 2, a 64x64 low product 3 IMADs, __umul64hi 4).
OPS = {
    32: dict(harvey=6, add=3, sub=3, redc=5),
    64: dict(harvey=18, add=8, sub=8, redc=26),
}
# K9 (csrc/ntt_mxu.cu) per output word, as 32-bit integer instructions:
# the limb split (8 byte permutes per 4 words), each product's fold (seven
# 32x32->64 multiply-adds, 2 each) and REDC (5), the twist (Harvey, 6) and
# the byte scatter of the middle limbs (4). Its u8 products count as MACs
# on the tensor cores (2 operations each at the dense int8 rate).
MXU_OPS_PER_WORD = 2 + 2 * (7 * 2 + OPS[32]["redc"]) + OPS[32]["harvey"] + 4


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
# bench.py:58-63
BIG = PathConfig("big", 1 << 16, 30, 4, 2, 4, 30, BIG_MUL_ERR)
# tools/ab_check.py:49 (wide-2^15-61b-ds1)
BIG_WIDE = PathConfig("big-wide", 1 << 15, 61, 3, 1, 4, 61, BIG_WIDE_MUL_ERR)
# uint64 planes at N = 2^16 (K5'/K7, K6, K8 / K8' on clusters of 16
# blocks): kernel checks and times only
WIDE_16 = PathConfig("wide-2^16", 1 << 16, 61, 2, 1, 1, 61, 0.0)


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


def _same(name: str, got, want, what: str = "kernel == twin") -> int:
    """Require bit equality; returns the max |difference| (0)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = int((got.long() - want.long()).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {what} fails (max |diff| {err})")
    bits = 32 if got.dtype == torch.int32 else 64
    print(f"check {name}: {what} (tolerance: exact, uint{bits} "
          f"equality), shape {tuple(got.shape)}")
    return err


def _pair(ct) -> tuple:
    """A ciphertext's (c0, c1) planes."""
    return ct.c0.data, ct.c1.data


def clustered(cfg: PathConfig, wide: bool) -> bool:
    """Whether the path's planes span a thread-block cluster."""
    from toy_heaan_ckks_tpu_torch.ops.ntt_gpu import plane_split

    return plane_split(cfg.degree, wide)[1] > 1


# uint64 rings whose planes run on a cluster though one block holds them
# (csrc/ntt_cluster.cuh wide_cluster_shape: K5 / K7, K6 and K8 / K8')
WIDE_CLUSTER_LOG_N = (13, 14)


def cluster_counters(cfg: PathConfig, wide: bool) -> set:
    """The counters whose kernels run on clusters on the path: every one
    where its planes span a cluster or, on uint64 planes of 2^13 / 2^14,
    where one block holds them (``WIDE_CLUSTER_LOG_N``); none else."""
    if clustered(cfg, wide) or (wide and cfg.degree.bit_length() - 1 in WIDE_CLUSTER_LOG_N):
        return {"ntt_planes", "gadget_accumulate", "mod_down_combine", "ntt_planes_wide",
                "gadget_accumulate_wide", "mod_down_combine_wide"}
    return set()


def zero_counts(counters) -> None:
    for f in counters:
        f.launches = f.launches_cluster = 0


def read_counts(cfg: PathConfig, counters, wide: bool) -> dict:
    """Each counter's launches, and for a kernel that runs on clusters on
    the path (``cluster_counters``) its cluster launches as
    ``name[cluster]``; raises if such a kernel launched a one-block form
    or another kernel ran on a cluster."""
    on_clusters = cluster_counters(cfg, wide)
    counts = {f.__name__: f.launches for f in counters}
    for f in counters:
        if f.__name__ in on_clusters:
            counts[f"{f.__name__}[cluster]"] = f.launches_cluster
            if f.launches_cluster != f.launches:
                raise AssertionError(f"[{cfg.name}] {f.__name__}: {f.launches_cluster} of "
                                     f"{f.launches} launches on clusters, where every "
                                     "plane runs on one")
        elif f.launches_cluster:
            raise AssertionError(f"[{cfg.name}] {f.__name__}: {f.launches_cluster} cluster "
                                 "launches where its planes run one block each")
    return counts


@dataclasses.dataclass
class Case:
    """One kernel call at a path's shapes: the kernel, its twin, and the
    bytes, integer operations and tensor-core MACs of the work (for the
    bound)."""

    kernel: object
    twin: object
    bytes: int
    ops: int
    macs: int = 0


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

    def ks_work(with_d: bool):
        ops = 0  # per item; with d a base channel skips its own digit
        for j in range(E):
            for t_ in range(D):
                k_count = min(ds, L - t_ * ds)
                if with_d and j < L and t_ == j // ds:
                    ops += n * 2 * op["redc"]
                else:
                    ops += (n * k_count * (op["harvey"] + op["add"]) + ntt_ops
                            + n * 2 * (op["redc"] + op["add"]))
        planes_in = 2 * B * L if with_d else B * L
        return (planes_in + 2 * D * E + 2 * E + 2 * B * E) * plane, B * ops

    md_ops = B * Lc * (n * G * (op["harvey"] + op["add"]) + ntt_ops
                       + n * (2 * op["harvey"] + op["add"] + op["sub"]))
    md_bytes = (B * G + 2 * B * Lc + 2 * Lc + B * Lc) * plane
    # K3' / K8' at key-switch shapes: the child is the whole base, the
    # dropped moduli the specials, and there is no t term
    Gs = len(specials)
    yhat_sp = planes((B,), specials)
    ks_base = ks_full[..., :L, :]
    nt_kw = dict(child_moduli=primes, dropped_moduli=specials, degree=n)
    nt_ops = B * L * (n * Gs * (op["harvey"] + op["add"]) + ntt_ops
                      + n * (op["harvey"] + op["sub"]))
    nt_bytes = (B * Gs + B * L + 2 * L + B * L) * plane

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
            *ks_work(True)),
        # K2 / K6 also without d (every digit raised)
        "gadget_accumulate[no_d]": Case(
            lambda: accumulate(y, key_a, key_b, **{**ks_kw, "d_ntt": None}),
            lambda: ksg.gadget_accumulate_twin(y, key_a, key_b, primes, ext, n,
                                               ds, None),
            *ks_work(False)),
        "mod_down_combine": Case(
            lambda: mod_down(yhat, ks, t, **md_kw),
            lambda: mdg.mod_down_combine_twin(yhat, ks, t, child, dropped, n,
                                              p_specials),
            md_bytes, md_ops),
        "mod_down_no_t": Case(
            lambda: mod_down(yhat_sp, ks_base, None, **nt_kw),
            lambda: mdg.mod_down_combine_twin(yhat_sp, ks_base, None, primes,
                                              specials, n, 0),
            nt_bytes, nt_ops),
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


def run_path(cfg: PathConfig, dev, counters, wide: bool) -> dict:
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
    zero_counts(counters)
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
    t0 = time.perf_counter()
    for i in range(2):
        ct = Ciphertext(
            c0=Poly(o0[i], child_ctx, True), c1=Poly(o1[i], child_ctx, True),
            logp=single.logp, logq=single.logq, scale=single.scale,
        )
        got = enc.decode(eng.decrypt(ct, sk_child))
        if got.shape != (n // 2,) or not np.all(np.isfinite(got)):
            raise AssertionError(f"[{cfg.name}] decode {i}: bad shape or non-finite values")
        max_err = max(max_err, float(np.max(np.abs(got - va[i] * vb[i]))))
    decode_s = time.perf_counter() - t0
    launches = read_counts(cfg, counters, wide)
    print(f"[{cfg.name}] decrypt + decode 2 items: {decode_s:.2f} s")
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
                batch=(a0, a1, b0, b1), eng=eng, sk=sk, pk=pk, enc=enc,
                key_rng=key_rng, values=va, values_b=vb, cts=cts_a, cts_b=cts_b,
                mul_ct=single, outputs=dict(batched=(o0, o1), single=_pair(single)))


@dataclasses.dataclass(frozen=True)
class RotateConfig:
    offsets: tuple  # rotation keys generated (the hoisted calls use them all)
    scale_bits: int  # encoder scale of the rotation path's batch
    rot_err: float  # decode bound of rotate / conjugate
    sum_err: float  # decode bound of the hoisted sums
    # the whole rotation surface; False: batched_rotate and
    # rotate_ciphertext by the first offset only (no -1 or conjugation key)
    full: bool = True


# At N = 2^14, h = N/2 and scale 2^31 a rotation decodes with ~2.5e-3 error
# on slot 0, in the JAX reference as in the port: the digits of the
# decomposition are not centered, and the key switch's mean error term
# lands on the slot whose root is exp(i pi / N), where 1 + X + ... + X^{N-1}
# is ~2N/pi (tools/rotation_noise.py estimates it). The reference tests'
# bounds (1e-4, 1e-3) do not allow that, so the small rotation path checks
# at 2^45, where the same absolute error is 2^14 times smaller; a rotation
# spends no level and the weighted sum's rescale leaves 2^59 on the 7-prime
# child. 2^45 is the check's scale only: a circuit that rescales on this
# chain keeps ~2^31.
SMALL_ROT = RotateConfig(tuple(range(1, 9)), 45, 1e-4, 1e-3)
# the wide hoisted path runs the generic decomposition and key products in
# bit-serial int64 torch, so it takes 3 keys
WIDE_ROT = RotateConfig((1, 2, 3), 61, 1e-6, 1e-6)
# N = 2^16, 4 x 30-bit, ds 2: at the multiply path's 2^30 the same
# non-centered key-switch term is ~4x the 2^14 chain's (2N / pi on slot 0)
# over a 2x smaller scale, so the rotation check runs at 2^45 as on the
# small path (the 120-bit chain holds 2^45 * 8 after the weighted sum's
# rescale); bounds: the reference tests' 1e-4 / 1e-3
BIG_ROT = RotateConfig((1, 2), 45, 1e-4, 1e-3)
# N = 2^15, 3 x 61-bit, ds 1: batched_rotate and rotate_ciphertext only;
# bound as for the wide path
BIG_WIDE_ROT = RotateConfig((1,), 61, 1e-6, 1e-6, full=False)


def run_rotation(cfg: PathConfig, rot: RotateConfig, run: dict, counters,
                 no_t, wide: bool) -> dict:
    """Phase 3b on one path: rotation keys (offsets, -1, conjugation) from
    the seed-42 stream of phase 3 and a batch encrypted at the rotation
    path's scale, then through the user entry points
    ``batched_rotate`` on the whole batch, ``rotate_ciphertext`` by 1 and
    -1, ``conjugate_ciphertext``, ``rotate_hoisted``,
    ``rotate_sum_hoisted`` and ``rotate_weighted_sum_hoisted`` +
    ``rescale_ciphertext`` (one baby-step block of a diagonal-method
    matrix-vector product), with every launch count set to 0 just before
    and read just after; decode bounds, item 0 against the batch, items
    0..1 against the CPU twin, and every kernel of the path launched. With
    ``rot.full`` False: the keys of ``rot.offsets`` and ``batched_rotate``
    and ``rotate_ciphertext`` by the first offset only."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch import CkksContext, CkksEncoder, CkksEngine
    from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
    from toy_heaan_ckks_tpu_torch.parallel.sharded import _rotate_arrays, batched_rotate

    E = CkksEngine
    eng, sk, ctx = run["eng"], run["sk"], run["ctx"]
    n, ds, B = cfg.degree, cfg.digit_size, cfg.batch
    zero_counts(counters)
    no_t.launches_no_t = 0
    t0 = time.perf_counter()
    key_rng = run["key_rng"]
    rotks = {k: eng.generate_gadget_rotation_key(sk, k, key_rng, digit_size=ds)
             for k in rot.offsets}
    if rot.full:
        rk_m1 = eng.generate_gadget_rotation_key(sk, -1, key_rng, digit_size=ds)
        cjk = eng.generate_conjugation_key(sk, key_rng, digit_size=ds)
    enc = CkksEncoder(n, rot.scale_bits)
    va = make_rng(SEED + 3).uniform(-1, 1, size=(B, n // 2))
    cts = [eng.encrypt(enc.encode(v, ctx), run["pk"], ctx.total_bits(), key_rng)
           for v in va]
    a0 = torch.stack([c.c0.data for c in cts])
    a1 = torch.stack([c.c1.data for c in cts])
    torch.cuda.synchronize()
    print(f"[{cfg.name} rotate] keygen {len(rotks)} + {2 * rot.full} keys, encode + "
          f"encrypt {B} at scale 2^{rot.scale_bits}: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    k1 = rot.offsets[0]
    keys = [rotks[k] for k in rot.offsets]
    o0, o1 = batched_rotate((a0, a1), rotks[k1], ctx)
    single = E.rotate_ciphertext(cts[0], rotks[k1])
    if rot.full:
        r_m1 = E.rotate_ciphertext(cts[0], rk_m1)
        conj = E.conjugate_ciphertext(cts[0], cjk)
        hoisted = E.rotate_hoisted(cts[0], keys)
        summed = E.rotate_sum_hoisted(cts[0], keys)
        diags = make_rng(SEED + 2).uniform(-0.5, 0.5, size=(len(keys), n // 2))
        pts = [enc.encode(d, keys[0].ext_ctx) for d in diags]
        wsum = E.rescale_ciphertext(E.rotate_weighted_sum_hoisted(cts[0], keys, pts))
    torch.cuda.synchronize()
    # the multiply path's first ciphertext (scale 2^scale_bits of phase 3)
    # rotated, for its error alone: no bound at that scale
    mul_ct = run["cts"][0]
    mul_rot = E.rotate_ciphertext(mul_ct, rotks[k1])
    torch.cuda.synchronize()
    launches = read_counts(cfg, counters, wide)
    launches[f"{no_t.__name__}[no_t]"] = no_t.launches_no_t
    print(f"[{cfg.name} rotate] path ({len(keys)} hoisted keys): "
          f"{time.perf_counter() - t0:.2f} s")
    print(f"[{cfg.name} rotate] main-path launches: {launches}")
    if not (torch.equal(single.c0.data, o0[0]) and torch.equal(single.c1.data, o1[0])):
        raise AssertionError(f"[{cfg.name}] rotate_ciphertext differs from batch item 0")
    if o0.shape != a0.shape or o0.dtype != ctx.chain.dtype:
        raise AssertionError(f"[{cfg.name}] unexpected rotation {tuple(o0.shape)}")

    def err(ct, want):
        got = enc.decode(eng.decrypt(ct, sk.reduce_to(ct.ctx)))
        if got.shape != (n // 2,) or not np.all(np.isfinite(got)):
            raise AssertionError(f"[{cfg.name}] decode: bad shape or non-finite values")
        return float(np.max(np.abs(got - want)))

    from toy_heaan_ckks_tpu_torch.ops.poly import Poly
    from toy_heaan_ckks_tpu_torch.types import Ciphertext

    batch_cts = [Ciphertext(c0=Poly(o0[i], ctx, True), c1=Poly(o1[i], ctx, True),
                            logp=single.logp, logq=single.logq, scale=single.scale)
                 for i in range(2)]
    errs = {
        f"batched_rotate({k1}) items 0..1": (max(err(c, np.roll(va[i], -k1))
                                                 for i, c in enumerate(batch_cts)), rot.rot_err),
    }
    if rot.full:
        errs.update({
            "rotate(-1)": (err(r_m1, np.roll(va[0], 1)), rot.rot_err),
            "conjugate": (err(conj, va[0]), rot.rot_err),
            "rotate_hoisted": (max(err(c, np.roll(va[0], -k))
                                   for c, k in zip(hoisted, rot.offsets)), rot.rot_err),
            "rotate_sum_hoisted": (err(summed, sum(np.roll(va[0], -k)
                                                   for k in rot.offsets)), rot.sum_err),
            "weighted_sum+rescale": (err(wsum, sum(d * np.roll(va[0], -k)
                                                   for d, k in zip(diags, rot.offsets))),
                                     rot.sum_err),
        })
    rot_errs = np.abs(enc.decode(eng.decrypt(mul_rot, sk))
                      - np.roll(run["values"][0], -k1))
    print(f"[{cfg.name} rotate] decode max |err| at the multiply path's scale "
          f"2^{cfg.scale_bits} (no bound): fresh ciphertext "
          f"{err(mul_ct, run['values'][0]):.3e}, rotated by {k1} "
          f"{rot_errs.max():.3e} (on slot {int(rot_errs.argmax())})")
    for name, (e, bound) in errs.items():
        print(f"[{cfg.name} rotate] decode max |err| {name}: {e:.3e} (bound {bound})")
        if e > bound:
            raise AssertionError(f"[{cfg.name}] {name} decode error {e} > {bound}")
    if min(launches.values()) < 1:
        raise AssertionError(f"[{cfg.name}] a kernel of the rotation path never "
                             f"launched: {launches}")

    # items 0..1 of the batched rotation again, through the twins on the CPU
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    rk = rotks[k1]
    ctx_cpu = CkksContext.build(ctx.moduli, n, cpu)
    ext_cpu = CkksContext.build(rk.ext_ctx.moduli, n, cpu)
    perm = ctx_cpu.automorphism_table_ntt(pow(5, k1, 2 * n))
    c0, c1 = _rotate_arrays(a0[:2].cpu(), a1[:2].cpu(), rk.a.cpu(), rk.b.cpu(),
                            perm, ctx_cpu, ext_cpu, ds)
    if not (torch.equal(c0, o0[:2].cpu()) and torch.equal(c1, o1[:2].cpu())):
        raise AssertionError(f"[{cfg.name}] GPU rotation differs from the CPU twin")
    print(f"check [{cfg.name} rotate] batched rotation: GPU items 0..1 == CPU twin "
          f"({time.perf_counter() - t0:.2f} s on the CPU)")
    outputs = dict(batched=(o0, o1), single=_pair(single))
    if rot.full:
        outputs.update(rotate_m1=_pair(r_m1), conjugate=_pair(conj),
                       hoisted=[_pair(c) for c in hoisted], summed=_pair(summed),
                       weighted=_pair(wsum))
    return dict(launches=launches, rotk=rk, keys=keys,
                pts=pts if rot.full else None, ct=cts[0], batch=(a0, a1),
                rk_m1=rk_m1 if rot.full else None, cjk=cjk if rot.full else None,
                outputs=outputs)


# K9 (items, channels, N, prime bits): the small path's shapes at batch 32
# and 1 (R = 128, the channel-run kernel), the envelope's largest plane (R =
# 256, 136 KiB of shared memory: one block a plane) and its smallest (R =
# 8, padded to the mma depth)
MXU_SHAPES = {"small": (SMALL.batch, SMALL.count, SMALL.degree, SMALL.bits),
              "small B 1": (1, SMALL.count, SMALL.degree, SMALL.bits),
              "2^15": (2, 2, 1 << 15, 31), "2^10": (4, 3, 1 << 10, 31)}


@contextlib.contextmanager
def mxu_env():
    """CKKS_NTT_MXU=1 for the block only (the small chain's folds, ntt_lo
    and the engine's mod-down run K9)."""
    import os

    os.environ["CKKS_NTT_MXU"] = "1"
    try:
        yield
    finally:
        os.environ.pop("CKKS_NTT_MXU", None)


def mxu_cases(dev, shape: str) -> tuple:
    """K9's kernel/twin pairs at one of MXU_SHAPES (forward, inverse,
    inverse + fold by the chain's decomposition factors), and K1 on the
    same inputs for each."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch import generate_primes
    from toy_heaan_ckks_tpu_torch.ops.ntt_gpu import ntt_planes
    from toy_heaan_ckks_tpu_torch.ops.ntt_mxu import layout, ntt_mxu
    from toy_heaan_ckks_tpu_torch.ops.ntt_mxu_gpu import ntt_mxu_planes
    from toy_heaan_ckks_tpu_torch.ops.small_fast import _dec_inv_ints, _fold_consts

    B, L, n, bits = MXU_SHAPES[shape]
    primes = tuple(generate_primes(bits, L, n))
    post = _dec_inv_ints(primes, SMALL.digit_size)
    fin = _fold_consts(primes, n, post)
    rng = np.random.Generator(np.random.PCG64(4321))
    x = _rand_planes(rng, (B,), primes, n, dev, torch.int32)
    r, c = layout(n)
    # each plane read and written once, and the tables: both matrices' limbs,
    # the twist and its companions, the per-channel constants
    work = dict(bytes=2 * B * L * n * 4 + L * (4 * (r * r + c * c) + 2 * n * 4 + 9 * 4),
                ops=B * L * n * MXU_OPS_PER_WORD, macs=16 * B * L * n * (r + c))
    modes = {"forward": (False, None, None), "inverse": (True, None, None),
             "inverse+fold": (True, post, fin)}
    cases, k1 = {}, {}
    for name, (inv, pst, final) in modes.items():
        cases[name] = Case(
            lambda inv=inv, pst=pst: ntt_mxu_planes(x, primes, n, inv, pst),
            lambda inv=inv, pst=pst: ntt_mxu(x, primes, n, inv, pst), **work)
        k1[name] = lambda inv=inv, final=final: ntt_planes(x, primes, n, inv, final)
    return cases, k1


def check_mxu(dev) -> tuple:
    """Phase 2, K9 small: K9 against its twin and against K1 at each of
    MXU_SHAPES; returns the small path's cases at batch 32 and 1 and the
    max |error|."""
    import torch

    errs, small = {}, {}
    for shape in MXU_SHAPES:
        cases, k1 = mxu_cases(dev, shape)
        B, L, n, _ = MXU_SHAPES[shape]
        label = f"K9 {shape} ({B}, {L}, 2^{n.bit_length() - 1})"
        for name, err in check_cases(label, cases).items():
            errs[name] = max(errs.get(name, 0), err)
        for name, case in cases.items():
            got, want = case.kernel(), k1[name]()
            torch.cuda.synchronize()
            _same(f"{label} {name}", got, want, "K9 == K1")
        if shape.startswith("small"):
            small[shape] = cases
    return small, errs


def run_mxu(cfg: PathConfig, run: dict, rot_run: dict, counters) -> dict:
    """Phase 3c, small-mxu: phase 3's and 3b's small calls again under
    CKKS_NTT_MXU=1 on the same keys and ciphertexts, each output equal to
    the default path's word for word; then ``ntt_lo`` (both directions),
    ``rescale_ntt_lo`` and ``mod_down_lo`` against their K1 forms. Every
    count is set to 0 just before and read just after; K9 must launch in
    each call, and the multiply's decomposition fold moves from K1 to K9."""
    import torch

    from toy_heaan_ckks_tpu_torch import CkksEngine as E
    from toy_heaan_ckks_tpu_torch.ops import moddown_gpu as mdg
    from toy_heaan_ckks_tpu_torch.ops import small_fast as sf
    from toy_heaan_ckks_tpu_torch.ops.ntt_gpu import ntt_planes
    from toy_heaan_ckks_tpu_torch.ops.ntt_mxu_gpu import ntt_mxu_planes
    from toy_heaan_ckks_tpu_torch.ops.poly import rescale_ntt
    from toy_heaan_ckks_tpu_torch.parallel.sharded import (
        batched_mul_relin_rescale, batched_rotate,
    )

    ctx, child, rlk = run["ctx"], run["child"], run["rlk"]
    ext_ctx, n = rlk.ext_ctx, cfg.degree
    a0, a1, b0, b1 = run["batch"]
    ct, keys, pts, rk = rot_run["ct"], rot_run["keys"], rot_run["pts"], rot_run["rotk"]
    calls = {
        "batched_mul_relin_rescale": (lambda: batched_mul_relin_rescale(
            (a0, a1), (b0, b1), rlk, ctx, child), run["outputs"]["batched"]),
        "mul_rescale": (lambda: _pair(E.mul_rescale(run["cts"][0], run["cts_b"][0], rlk)),
                        run["outputs"]["single"]),
        "batched_rotate": (lambda: batched_rotate(rot_run["batch"], rk, ctx),
                           rot_run["outputs"]["batched"]),
        "rotate_ciphertext": (lambda: _pair(E.rotate_ciphertext(ct, rk)),
                              rot_run["outputs"]["single"]),
        "rotate_ciphertext(-1)": (lambda: _pair(E.rotate_ciphertext(ct, rot_run["rk_m1"])),
                                  rot_run["outputs"]["rotate_m1"]),
        "conjugate_ciphertext": (lambda: _pair(E.conjugate_ciphertext(ct, rot_run["cjk"])),
                                 rot_run["outputs"]["conjugate"]),
        "rotate_hoisted": (lambda: [_pair(c) for c in E.rotate_hoisted(ct, keys)],
                           rot_run["outputs"]["hoisted"]),
        "rotate_sum_hoisted": (lambda: _pair(E.rotate_sum_hoisted(ct, keys)),
                               rot_run["outputs"]["summed"]),
        "rotate_weighted_sum_hoisted+rescale": (lambda: _pair(E.rescale_ciphertext(
            E.rotate_weighted_sum_hoisted(ct, keys, pts))), rot_run["outputs"]["weighted"]),
        # the staged entry points against their K1 forms (the multiply's
        # batch; the relin key's b digits as planes over QP)
        "ntt_lo forward": (lambda: sf.ntt_lo(a0, ctx.moduli, n, False),
                           lambda: ntt_planes(a0, ctx.moduli, n, False)),
        "ntt_lo inverse": (lambda: sf.ntt_lo(a0, ctx.moduli, n, True),
                           lambda: ntt_planes(a0, ctx.moduli, n, True)),
        "rescale_ntt_lo": (lambda: sf.rescale_ntt_lo(a0, ctx), lambda: rescale_ntt(a0, ctx)),
        "mod_down_lo": (lambda: sf.mod_down_lo(rlk.b, ctx, ext_ctx),
                        lambda: sf.mod_down_by_p(rlk.b, ctx, ext_ctx,
                                                 to_yhat=mdg.inv_ntt_to_yhat,
                                                 mod_down=mdg.mod_down_combine)),
    }
    k9 = ntt_mxu_planes
    flat = lambda out: [t for p in (out if isinstance(out, list) else [out])
                        for t in (p if isinstance(p, tuple) else (p,))]
    per_call = {}
    with mxu_env():
        zero_counts(counters + (k9,))
        t0 = time.perf_counter()
        for name, (fn, want) in calls.items():
            before = (k9.launches, ntt_planes.launches)
            got = fn()
            per_call[name] = (k9.launches - before[0], ntt_planes.launches - before[1])
            if callable(want):
                want = want()
            torch.cuda.synchronize()
            staged = name.startswith(("ntt_lo", "rescale", "mod_down"))
            for i, (g, w) in enumerate(zip(flat(got), flat(want))):
                _same(f"[{cfg.name}-mxu] {name}[{i}]", g, w,
                      "K9 form == K1 form" if staged else "K9 path == default path")
        launches = read_counts(cfg, counters + (k9,), wide=False)
    print(f"[{cfg.name}-mxu] path: {time.perf_counter() - t0:.2f} s")
    print(f"[{cfg.name}-mxu] main-path launches: {launches}")
    print(f"[{cfg.name}-mxu] (K9, K1) launches per call: {per_call}")
    if min(k for k, _ in per_call.values()) < 1:
        raise AssertionError(f"[{cfg.name}-mxu] a call ran no K9: {per_call}")
    if per_call["batched_mul_relin_rescale"] != (1, 2):
        raise AssertionError(f"[{cfg.name}-mxu] the multiply's fold did not move to K9: "
                             f"{per_call['batched_mul_relin_rescale']}")
    return dict(launches=launches, per_call=per_call)


# K10 / K11 phase 2 shapes: (label, batch, channels, degree, prime bits,
# shard counts); each sharded NTT is held to its twin on the same slabs and
# to the whole-plane kernel of the label (K1, K4 and K5' on clusters of
# 16); P = 1 is K10 alone
COEFF_SHAPES = (
    ("K1", 32, 8, 1 << 14, 31, (1, 2, 8)),
    ("K4", 4, 4, 1 << 16, 30, (4, 8)),
    ("K5'", 4, 3, 1 << 15, 61, (4,)),
)
# phase 3d: (path, shards, with the rotation, K10 on clusters)
COEFF_PATHS = ((BIG, 4, True, True), (BIG_WIDE, 4, True, True), (SMALL, 8, False, False))
# K10 / K11 case shapes (``coeff_cases``), checked in phase 2 and timed in
# phase 4: each coeff path's batch and chain on its shards; the first is
# the yardstick of the K10 / K11 rows
COEFF_CASES = (("K10/K11 (4, 4, 2^16) P 4", BIG, 4),
               ("K10/K11 (32, 8, 2^14) P 8", SMALL, 8),
               ("K10/K11 (4, 3, 2^15) uint64 P 4", BIG_WIDE, 4))


def coeff_twin(slabs, moduli, degree: int, inverse: bool) -> tuple:
    """The sharded NTT of ``parallel/coeff_ntt.coeff_ntt`` through the twins
    of K10 and K11 (any device)."""
    from toy_heaan_ckks_tpu_torch.ops.coeff_ntt_gpu import (
        coeff_cross_twin, coeff_tail_twin,
    )

    cross = len(slabs).bit_length() - 1
    if not inverse:
        for st in range(cross):
            slabs = coeff_cross_twin(slabs, moduli, degree, st, False)
        return coeff_tail_twin(slabs, moduli, degree, False)
    final = tuple(pow(degree, -1, q) for q in moduli)
    slabs = coeff_tail_twin(slabs, moduli, degree, True, final if cross == 0 else None)
    for st in range(cross - 1, -1, -1):
        slabs = coeff_cross_twin(slabs, moduli, degree, st, True,
                                 final if st == 0 else None)
    return slabs


def coeff_input(dev, batch: int, channels: int, degree: int, bits: int, shards: int):
    """Random planes of one phase 2 shape, their P slabs and the chain."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch import generate_primes
    from toy_heaan_ckks_tpu_torch.parallel.mesh import make_coeff_mesh, shard_planes

    moduli = tuple(generate_primes(bits, channels, degree))
    dtype = torch.int64 if bits > 31 else torch.int32
    rng = np.random.Generator(np.random.PCG64(degree + shards))
    x = _rand_planes(rng, (batch,), moduli, degree, dev, dtype)
    return moduli, x, shard_planes(x, make_coeff_mesh(shards, dev))


def check_coeff(dev) -> int:
    """Phase 2, K10/K11 coeff: the sharded NTT (forward, inverse) on CUDA
    slabs at each of COEFF_SHAPES, word-equal to its twin on the same slabs
    and to the whole-plane kernel; one K10 launch per call and, for P >=
    2, one launch of K11's one-launch form (none of the per-stage form),
    K10's on a cluster where ``slab_form`` picks one, K11's never."""
    import torch

    from toy_heaan_ckks_tpu_torch.ops.coeff_ntt_gpu import (
        coeff_cross, coeff_cross_stages, coeff_tail, slab_form,
    )
    from toy_heaan_ckks_tpu_torch.ops.ntt_gpu import ntt_planes, ntt_planes_wide
    from toy_heaan_ckks_tpu_torch.parallel.coeff_ntt import coeff_ntt
    from toy_heaan_ckks_tpu_torch.parallel.mesh import unshard_planes

    err = 0
    for kernel, B, L, n, bits, shard_counts in COEFF_SHAPES:
        whole_fn = ntt_planes_wide if bits > 31 else ntt_planes
        for shards in shard_counts:
            moduli, x, slabs = coeff_input(dev, B, L, n, bits, shards)
            label = f"K10/K11 coeff ({B}, {L}, 2^{n.bit_length() - 1}) P {shards}"
            cluster = slab_form(bits > 31, (n // shards).bit_length() - 1,
                                B * L * shards) == "cluster"
            for inverse in (False, True):
                counters = (coeff_tail, coeff_cross, coeff_cross_stages)
                zero_counts(counters)
                out = coeff_ntt(slabs, moduli, n, inverse)
                torch.cuda.synchronize()
                counts = [(f.launches, f.launches_cluster) for f in counters]
                if counts != [(1, int(cluster)), (0, 0), (int(shards > 1), 0)]:
                    raise AssertionError(f"{label}: (K10, K11 per stage, K11 one launch) "
                                         f"launches {counts}, K10 on a cluster: {cluster}")
                what = "inverse" if inverse else "forward"
                twin = coeff_twin(slabs, moduli, n, inverse)
                for p, (g, w) in enumerate(zip(out, twin)):
                    err = max(err, _same(f"{label} {what} slab {p}", g, w))
                err = max(err, _same(f"{label} {what}", unshard_planes(out),
                                     whole_fn(x, moduli, n, inverse),
                                     f"K10/K11 == {kernel} on the whole plane"))
    return err


def cross_stages(cg, slabs, moduli, n: int, inverse: bool, final=None, twin: bool = False):
    """Every cross stage of a transform: ``coeff_cross_stages`` (or its
    twin), or, in a checkout of the port without it (the parent in an
    A/B of ``tools/kernel_ab.py``), the same work as one ``coeff_cross``
    launch (or twin) a stage."""
    name = "coeff_cross_stages" + ("_twin" if twin else "")
    if hasattr(cg, name):
        return getattr(cg, name)(slabs, moduli, n, inverse, final)
    cross = len(slabs).bit_length() - 1
    stages = list(range(cross - 1, -1, -1) if inverse else range(cross))
    one = cg.coeff_cross_twin if twin else cg.coeff_cross
    for st in stages:
        slabs = one(slabs, moduli, n, st, inverse, final if st == stages[-1] else None)
    return slabs


def coeff_cases(dev, B: int, L: int, n: int, bits: int, shards: int) -> dict:
    """K10 (forward, inverse) and K11 (forward stage 0, and every cross
    stage of a transform, forward and inverse with N^-1) against their
    twins at one shape, the whole sharded NTT against its twins, and the
    whole-plane kernel on the same planes, with the work of each."""
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
    from toy_heaan_ckks_tpu_torch.ops.ntt_gpu import ntt_planes, ntt_planes_wide, ntt_twin
    from toy_heaan_ckks_tpu_torch.parallel.coeff_ntt import coeff_ntt

    moduli, x, slabs = coeff_input(dev, B, L, n, bits, shards)
    wide = bits > 31
    w, op = (8, OPS[64]) if wide else (4, OPS[32])
    log_n, cross = n.bit_length() - 1, shards.bit_length() - 1
    bfly = op["harvey"] + op["add"] + op["sub"]
    plane = B * L * n * w
    fin = tuple(pow(n, -1, q) for q in moduli)
    fin_cross = fin if cross == 0 else None
    tail_ops = B * L * (n // 2) * (log_n - cross) * bfly
    # each input word read and each output word written once; the twiddle
    # entries of the stages run (value and Shoup companion)
    tail_bytes = 2 * plane + 2 * L * n * w
    whole = ntt_planes_wide if wide else ntt_planes
    cases = {
        "coeff_tail forward": Case(lambda: cg.coeff_tail(slabs, moduli, n, False),
                                   lambda: cg.coeff_tail_twin(slabs, moduli, n, False),
                                   tail_bytes, tail_ops),
        "coeff_tail inverse": Case(
            lambda: cg.coeff_tail(slabs, moduli, n, True, fin_cross),
            lambda: cg.coeff_tail_twin(slabs, moduli, n, True, fin_cross),
            tail_bytes, tail_ops + (B * L * n * op["harvey"] if fin_cross else 0)),
        "coeff_ntt forward": Case(lambda: coeff_ntt(slabs, moduli, n, False),
                                  lambda: coeff_twin(slabs, moduli, n, False),
                                  tail_bytes, B * L * (n // 2) * log_n * bfly),
        "whole-plane forward": Case(lambda: whole(x, moduli, n, False),
                                    lambda: ntt_twin(x, moduli, n, False),
                                    tail_bytes, B * L * (n // 2) * log_n * bfly),
    }
    if cross:
        cases["coeff_cross forward"] = Case(
            lambda: cg.coeff_cross(slabs, moduli, n, 0, False),
            lambda: cg.coeff_cross_twin(slabs, moduli, n, 0, False),
            2 * plane + 2 * L * w, B * L * n * (op["harvey"] + op["add"]))
        # each word read and written once; the P - 1 twiddle entries of the
        # stages (value and Shoup companion) and, inverse, the final factors
        stage_ops = B * L * (n // 2) * cross * bfly
        for name, inverse, final in (("forward", False, None), ("inverse", True, fin)):
            cases[f"coeff_cross_stages {name}"] = Case(
                lambda inverse=inverse, final=final: cross_stages(cg, slabs, moduli, n,
                                                                  inverse, final),
                lambda inverse=inverse, final=final: cross_stages(cg, slabs, moduli, n,
                                                                  inverse, final, twin=True),
                2 * plane + 2 * L * (shards - 1 + inverse) * w,
                stage_ops + (B * L * n * op["harvey"] if inverse else 0))
    return cases


def tail_form(cfg: PathConfig, shards: int) -> dict:
    """K10's form at a coeff case shape (the path's batch, chain and
    shards): ``slab_form``'s pick and, for a register form, registers and
    spill bytes a thread, threads and shared bytes a block, blocks a slab
    and slabs resident at once (``ckks_coeff_tail_info``)."""
    import ctypes

    from toy_heaan_ckks_tpu_torch.ops import _build
    from toy_heaan_ckks_tpu_torch.ops.coeff_ntt_gpu import slab_form

    wide, log_s = cfg.bits > 31, (cfg.degree // shards).bit_length() - 1
    form = slab_form(wide, log_s, cfg.batch * cfg.count * shards)
    info = {"log2_slab": log_s, "form": form}
    if form != "template":
        buf = (ctypes.c_int * 6)()
        _build.check(_build.library().ckks_coeff_tail_info(
            int(wide), log_s, int(form == "cluster"), 0, buf), "ckks_coeff_tail_info")
        info.update(zip(("regs_per_thread", "local_bytes_per_thread", "threads_per_block",
                         "smem_bytes_per_block", "blocks_a_slab", "resident_slabs"), buf))
    return info


def run_coeff(cfg: PathConfig, shards: int, rotate: bool, tail_clusters: bool, dev,
              run: dict, rot_run: dict, counters) -> dict:
    """Phase 3d on one path: phase 3's batch and relin key (and phase 3b's
    rotation batch and key) sharded over a coefficient mesh of ``shards``
    shards of the card, through ``build_mul_relin_rescale_coeff`` (and
    ``build_rotate_coeff`` by the key's offset). Each output must equal the
    unsharded path's word for word, the multiply's decode stay within the
    path's bound; every count is set to 0 just before each call and read
    just after: K10 and K11 launched in each, K10 on clusters where
    ``tail_clusters`` says and nowhere else, no other kernel on a
    cluster."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch.ops.coeff_ntt_gpu import (
        coeff_cross, coeff_cross_stages, coeff_tail,
    )
    from toy_heaan_ckks_tpu_torch.ops.poly import Poly
    from toy_heaan_ckks_tpu_torch.parallel.coeff_composite import (
        build_mul_relin_rescale_coeff, build_rotate_coeff,
    )
    from toy_heaan_ckks_tpu_torch.parallel.mesh import (
        make_coeff_mesh, shard_planes, unshard_planes,
    )
    from toy_heaan_ckks_tpu_torch.types import Ciphertext

    ctx, child, rlk, n = run["ctx"], run["child"], run["rlk"], cfg.degree
    mesh = make_coeff_mesh(shards, dev)
    sh = lambda t: shard_planes(t, mesh)
    all_counters = counters + (coeff_tail, coeff_cross, coeff_cross_stages)
    label = f"[{cfg.name}-coeff P {shards}]"
    mul = build_mul_relin_rescale_coeff(mesh, ctx, rlk.ext_ctx, rlk.digit_size)
    mul_args = [sh(t) for t in run["batch"] + (rlk.a, rlk.b)]
    calls = {"build_mul_relin_rescale_coeff": (lambda: mul(*mul_args),
                                               run["outputs"]["batched"])}
    if rotate:
        rk = rot_run["rotk"]
        perm = ctx.automorphism_table_ntt(pow(5, rk.rotation % (n // 2), 2 * n))
        rot = build_rotate_coeff(mesh, ctx, rk.ext_ctx, perm, rk.digit_size)
        rot_args = [sh(t) for t in rot_run["batch"] + (rk.a, rk.b)]
        calls["build_rotate_coeff"] = (lambda: rot(*rot_args),
                                       rot_run["outputs"]["batched"])
    per_call, outs = {}, {}
    for name, (fn, want) in calls.items():
        zero_counts(all_counters)
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {f.__name__: f.launches for f in all_counters}
        cluster = {f.__name__: f.launches_cluster for f in all_counters if f.launches_cluster}
        counts["coeff_tail[cluster]"] = cluster.pop("coeff_tail", 0)
        per_call[name] = counts
        print(f"{label} {name}: {wall:.3f} s (first call); launches {counts}")
        if cluster:
            raise AssertionError(f"{label} {name}: cluster launches {cluster}")
        if (counts["coeff_tail[cluster]"] > 0) != tail_clusters:
            raise AssertionError(f"{label} {name}: K10 cluster launches "
                                 f"{counts['coeff_tail[cluster]']}, expected "
                                 f"{'some' if tail_clusters else 'none'}")
        if (counts["coeff_tail"] < 1 or counts["coeff_cross"] != 0
                or counts["coeff_cross_stages"] != counts["coeff_tail"]):
            raise AssertionError(f"{label} {name}: K10 must launch, and K11 once a "
                                 f"transform in its one-launch form: {counts}")
        for i, (g, w) in enumerate(zip(got, want)):
            _same(f"{label} {name}[{i}]", unshard_planes(g), w,
                  "sharded composite == unsharded path")
        outs[name] = got

    o0, o1 = (unshard_planes(t) for t in outs["build_mul_relin_rescale_coeff"])
    sk_child = run["sk"].reduce_to(child)
    enc, eng, single = run["enc"], run["eng"], run["mul_ct"]
    max_err = 0.0
    for i in range(2):
        ct = Ciphertext(c0=Poly(o0[i], child, True), c1=Poly(o1[i], child, True),
                        logp=single.logp, logq=single.logq, scale=single.scale)
        got = enc.decode(eng.decrypt(ct, sk_child))
        if got.shape != (n // 2,) or not np.all(np.isfinite(got)):
            raise AssertionError(f"{label} decode {i}: bad shape or non-finite values")
        max_err = max(max_err, float(np.max(np.abs(
            got - run["values"][i] * run["values_b"][i]))))
    print(f"{label} decode max |err| vs a*b over 2 items: {max_err:.3e} "
          f"(bound {cfg.max_decode_err})")
    if max_err > cfg.max_decode_err:
        raise AssertionError(f"{label} decode error {max_err} > {cfg.max_decode_err}")
    return dict(per_call=per_call, mul=lambda: mul(*mul_args),
                launches={k: sum(c[k] for c in per_call.values())
                          for k in ("coeff_tail", "coeff_cross", "coeff_cross_stages",
                                    "coeff_tail[cluster]")})


def time_coeff(run: dict, coeff_run: dict, shards: int) -> None:
    """Phase 4 of the big coeff path: ms per call and mults/s of the
    coefficient-sharded multiply at the path's batch beside the unsharded
    multiply in the same run, and a profiler split of the sharded one."""
    from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_mul_relin_rescale

    ctx, child, rlk = run["ctx"], run["child"], run["rlk"]
    a0, a1, b0, b1 = run["batch"]
    B = a0.shape[0]
    unsharded_ms = _cuda_ms(
        lambda: batched_mul_relin_rescale((a0, a1), (b0, b1), rlk, ctx, child), 10)
    coeff_ms = _cuda_ms(coeff_run["mul"], 10)
    print(f"time [{BIG.name}-coeff P {shards}] composite batch {B}: {coeff_ms:.4f} "
          f"ms/call = {B * 1000 / coeff_ms:.1f} mults/s; unsharded {BIG.name} in "
          f"this run {unsharded_ms:.4f} ms = {B * 1000 / unsharded_ms:.1f} mults/s")
    profile_composite(f"{BIG.name}-coeff P {shards} composite batch {B}", coeff_run["mul"])


# phase 3e: (path, batch axis of make_ckks_mesh(8, ...), the rotation
# instead of the multiply, the digit ranges K2 / K6 launch on at each batch
# point: D = 2 replicated over 4 channel points (batch 2), split over 2
# (batch 4); wide D = 4 split over 4)
MESH_CALLS = ((SMALL, 2, False, ((0, 1), (1, 2))),
              (SMALL, 4, False, ((0, 1), (1, 2))),
              (SMALL, 4, True, ((0, 1), (1, 2))),
              (WIDE, 2, False, ((0, 1), (1, 2), (2, 3), (3, 4))))


def run_mesh(cfg: PathConfig, batch_axis: int, rotate: bool, ranges: tuple, dev,
             run: dict, rot_run: dict, counters, wide: bool) -> dict:
    """Phase 3e on one call: phase 3's batch and relin key (or phase 3b's
    rotation batch and key) sharded on ``make_ckks_mesh(8, batch_axis)``
    with every grid point on the card, through ``build_mul_relin_rescale``
    (``ct_spec_for`` / ``key_spec_for`` in, ``ct_spec_for(mesh, L - 1)``
    out) or ``build_rotate`` by 1 (``ct_spec`` / ``key_spec``). The output
    must equal the unsharded path's word for word and carry its spec, the
    multiply's decode stay within the path's bound; every count is set to
    0 just before the call and read just after: every kernel of the path
    launched, K2 / K6 on the digit ranges ``ranges`` at each batch point,
    no K9, K10 or K11."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch.ops.coeff_ntt_gpu import (
        coeff_cross, coeff_cross_stages, coeff_tail,
    )
    from toy_heaan_ckks_tpu_torch.ops.ntt_mxu_gpu import ntt_mxu_planes
    from toy_heaan_ckks_tpu_torch.ops.poly import Poly
    from toy_heaan_ckks_tpu_torch.parallel.mesh import (
        ct_spec, ct_spec_for, key_spec, key_spec_for, make_ckks_mesh, shard, unshard,
    )
    from toy_heaan_ckks_tpu_torch.parallel.sharded import (
        build_mul_relin_rescale, build_rotate,
    )
    from toy_heaan_ckks_tpu_torch.types import Ciphertext

    ctx, child, n = run["ctx"], run["child"], cfg.degree
    L = ctx.num_channels
    mesh = make_ckks_mesh(8, batch=batch_axis, devices=dev)
    label = f"[{cfg.name}-mesh {batch_axis}x{8 // batch_axis}]"
    if rotate:
        rk = rot_run["rotk"]
        perm = ctx.automorphism_table_ntt(pow(5, rk.rotation % (n // 2), 2 * n))
        fn = build_rotate(mesh, ctx, rk.ext_ctx, perm, rk.digit_size)
        name, out_spec = "build_rotate", ct_spec(mesh)
        args = ([shard(t, ct_spec(mesh)) for t in rot_run["batch"]]
                + [shard(k, key_spec(mesh)) for k in (rk.a, rk.b)])
        want = rot_run["outputs"]["batched"]
    else:
        rlk = run["rlk"]
        fn = build_mul_relin_rescale(mesh, ctx, rlk.ext_ctx, rlk.digit_size)
        name, out_spec = "build_mul_relin_rescale", ct_spec_for(mesh, L - 1)
        args = ([shard(t, ct_spec_for(mesh, L)) for t in run["batch"]]
                + [shard(k, key_spec_for(mesh, rlk.a.shape[0])) for k in (rlk.a, rlk.b)])
        want = run["outputs"]["batched"]
    switch = counters[1]
    others = (ntt_mxu_planes, coeff_tail, coeff_cross, coeff_cross_stages)
    zero_counts(counters + others)
    switch.digit_ranges.clear()
    t0 = time.perf_counter()
    got = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(cfg, counters, wide)
    counts.update({f.__name__: f.launches for f in others})
    dealt = sorted(switch.digit_ranges)
    print(f"{label} {name}: {wall:.3f} s (first call); launches {counts}; "
          f"{switch.__name__} digit ranges {dealt}; in {args[0].spec.axes}, keys "
          f"{args[-1].spec.axes}, out {got[0].spec.axes}")
    if min(counts[f.__name__] for f in counters) < 1 or any(f.launches for f in others):
        raise AssertionError(f"{label} {name}: every kernel of the path must launch "
                             f"and no K9, K10 or K11: {counts}")
    if dealt != sorted(ranges * batch_axis):
        raise AssertionError(f"{label} {name}: digit ranges {dealt}, the plan deals "
                             f"{list(ranges)} at each of {batch_axis} batch points")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.spec != out_spec:
            raise AssertionError(f"{label} {name}[{i}]: out spec {g.spec.axes}")
        _same(f"{label} {name}[{i}]", unshard(g), w, "sharded composite == unsharded path")
    if not rotate:
        o0, o1 = (unshard(t) for t in got)
        sk_child = run["sk"].reduce_to(child)
        enc, eng, single = run["enc"], run["eng"], run["mul_ct"]
        max_err = 0.0
        for i in range(2):
            ct = Ciphertext(c0=Poly(o0[i], child, True), c1=Poly(o1[i], child, True),
                            logp=single.logp, logq=single.logq, scale=single.scale)
            dec = enc.decode(eng.decrypt(ct, sk_child))
            if dec.shape != (n // 2,) or not np.all(np.isfinite(dec)):
                raise AssertionError(f"{label} decode {i}: bad shape or non-finite values")
            max_err = max(max_err, float(np.max(np.abs(
                dec - run["values"][i] * run["values_b"][i]))))
        print(f"{label} decode max |err| vs a*b over 2 items: {max_err:.3e} "
              f"(bound {cfg.max_decode_err})")
        if max_err > cfg.max_decode_err:
            raise AssertionError(f"{label} decode error {max_err} > {cfg.max_decode_err}")
    return dict(call=lambda: fn(*args), launches=counts, label=label)


# phase 3f: the bootstrap path (models/bootstrap.py). The recipe is
# tests/test_bootstrap.py's factored-DFT one on the card's chain: h = 8
# (K = 7), KeyLadder(lazy=True, digit_size=4) and BootstrapKeys(digit_size=4),
# keys from make_rng(33), values uniform in [-0.02, 0.02] from
# np.random.default_rng(9), r 7, deg 8, dft_levels 3, arcsine.
#
# The chain. The 28 NTT primes of 2^16 below 2^31 (generate_primes(31, 28,
# 2^16)) spread 1.9% below the scale 2^31: each Chebyshev step heals a scale
# mismatch above 1% (funceval._combine spends a level), the r squarings then
# grow the scale out of the chain, and the refresh runs out of levels from
# N = 2^12 on, in the JAX reference as in the port (ROADMAP queue 3). So the
# refresh runs on the repo's scale-matched chain instead, lengthened within
# the 128-bit bound: build_modulus_chain(2^16, 30, 36, first_bits=31), q0
# just below 2^31 and 36 primes alternating above and below the scale 2^30
# (within 2.5%), 37 channels + 4 specials = 1,253 bits of log QP against
# 1,772 at 2^16. The refresh spends 33 of them (the formula's 25, plus 13
# heals on each packed half run side by side) and leaves level 4. NTT primes
# of 2^16 serve every smaller ring, so the same primes at N = 2^10 give the
# same level path and heals: the refresh there is held word for word to the
# port's CPU path, and the 2^16 one to its level path.
@dataclasses.dataclass(frozen=True)
class BootConfig:
    name: str
    degree: int
    depth: int = 36  # scale primes after q0
    scale_bits: int = 30
    first_bits: int = 31
    chain_ring: int = 1 << 16
    digit_size: int = 4
    hw: int = 8
    r: int = 7
    deg: int = 8
    dft_levels: int = 3
    mmax: float = 0.02

    @property
    def count(self) -> int:
        return self.depth + 1

    @property
    def bits(self) -> int:  # the widest prime's bits (kernel cases)
        return self.first_bits

    def primes(self) -> list:
        from toy_heaan_ckks_tpu_torch import build_modulus_chain

        return list(build_modulus_chain(self.chain_ring, self.scale_bits, self.depth,
                                        first_bits=self.first_bits).moduli)


BOOT_REFRESH = BootConfig("boot 2^10", 1 << 10)
BOOT_FULL = BootConfig("boot 2^16", 1 << 16)
BOOT_KEY_SEED, BOOT_VALUE_SEED = 33, 9
BOOT_LEVEL_OUT = 4
# the level of EvalMod's last fused multiply (the arcsine cube): 3 digits,
# the last of one channel, and K3 dropping the 4 specials and q_9
BOOT_LOW_LEVEL = 9
# the host decodes CoeffToSlot's output on 3 channels (2^92): its
# plaintext, the raised m + q0 I over 2^30, stays below 2^40
BOOT_LOW_CHANNELS = 3
# decode gates, from the JAX reference on the CPU on the same chain, seeds
# and draws (python -m tools.bootstrap_noise --impl reference --chain
# matched --log-n 8 9 10 11 12; the port's words are the same), rounded up.
# At 2^10 twice the reference's refresh error there, 3.599e-2. At 2^16 twice
# what the least-squares fit of log2(err) over N = 2^8 ... 2^12 predicts:
# the refresh against m 0.4666 (slope 0.61; 1.855e-2, 1.975e-2, 3.599e-2,
# 6.405e-2, 8.468e-2), the square-and-rescale of the output against the
# output's own decode squared 0.2934 (slope 1.36; 1.886e-4 ... 7.410e-3),
# CoeffToSlot against the raised plaintext's packed coefficients 7.538e-4
# (slope 1.30; 5.388e-7 ... 2.120e-5). The square against m^2 is held to
# what those two bounds allow: |y^2 - m^2| <= e (e + 2 mmax) for a refresh
# error e, plus the multiply's own. The refresh keeps no bit of the message
# at 2^16 on this chain (PERF.md, precision): its gates hold the port to the
# reference's growth, and the words and the level path to the CPU.
BOOT_REFRESH_ERR = 0.072
BOOT_FULL_ERR = 0.94
BOOT_SQUARE_SELF_ERR = 0.59
BOOT_SQUARE_ERR = BOOT_FULL_ERR * (BOOT_FULL_ERR + 2 * BOOT_FULL.mmax) + BOOT_SQUARE_SELF_ERR
BOOT_CTS_ERR = 1.6e-3


def boot_setup(cfg: BootConfig, dev) -> dict:
    """The recipe's chain, keys, encoder and level-1 ciphertext on ``dev``,
    drawn in the reference test's order."""
    import numpy as np

    from toy_heaan_ckks_tpu_torch import (
        CkksContext, CkksEncoder, CkksEngine, CkksParams, KeyLadder,
    )
    from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
    from toy_heaan_ckks_tpu_torch.models import BootstrapKeys

    n = cfg.degree
    full = CkksContext.build(cfg.primes(), n, dev)
    ctx1 = full.slice_channels(0, 1)
    params = CkksParams(3.2, cfg.hw, cfg.scale_bits)
    rng = make_rng(BOOT_KEY_SEED)
    sk = CkksEngine(full, params).generate_secret_key(rng)
    eng1 = CkksEngine(ctx1, params)
    sk1 = sk.reduce_to(ctx1)
    pk1 = eng1.generate_public_key(sk1, rng)
    ladder = KeyLadder(full, sk, 3.2, rng, lazy=True, digit_size=cfg.digit_size)
    bkeys = BootstrapKeys(ladder, params, rng, digit_size=cfg.digit_size)
    enc = CkksEncoder(n, cfg.scale_bits)
    m = np.random.default_rng(BOOT_VALUE_SEED).uniform(-cfg.mmax, cfg.mmax, n // 2)
    ct1 = eng1.encrypt(enc.encode(m, ctx1), pk1, ctx1.total_bits(), rng)
    return dict(full=full, params=params, sk=sk, sk1=sk1, ladder=ladder, bkeys=bkeys,
                enc=enc, m=m, ct1=ct1)


def boot_kernel_cases(cfg: BootConfig, dev) -> dict:
    """K1 / K4, K2, K3 and K3' at the refresh's shapes, at the top of the
    chain and at EvalMod's last fused multiply: the hoisted decomposition's
    forward NTT (10 digits x 41 channels), the key switch of one item (10
    digits, the last of one channel, E 41; 3 digits, E 13), with and without
    d, the fused multiply's mod-down (36 and 8 kept, 5 dropped) and the
    t-less one of 8 items (37 kept, the 4 specials dropped)."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch import CkksContext
    from toy_heaan_ckks_tpu_torch.keys import default_special_primes
    from toy_heaan_ckks_tpu_torch.ops.ntt_gpu import ntt_planes, ntt_twin

    path = PathConfig(cfg.name, cfg.degree, cfg.bits, cfg.count, cfg.digit_size, 1,
                      cfg.scale_bits, 0.0)
    top = kernel_cases(path, dev, wide=False)
    low = kernel_cases(dataclasses.replace(path, count=BOOT_LOW_LEVEL), dev, wide=False)
    eight = kernel_cases(dataclasses.replace(path, batch=8), dev, wide=False)
    n = cfg.degree
    primes = tuple(cfg.primes())
    ext = primes + default_special_primes(CkksContext.build(primes, n, dev),
                                          cfg.digit_size)
    digits = -(-cfg.count // cfg.digit_size)
    rng = np.random.Generator(np.random.PCG64(4321))
    x = _rand_planes(rng, (digits,), ext, n, dev, torch.int32)
    cases = {
        f"forward ({digits}, {len(ext)})": Case(lambda: ntt_planes(x, ext, n, False),
                                                lambda: ntt_twin(x, ext, n, False), 0, 0),
        "mod_down_no_t (8 items)": eight["mod_down_no_t"],
    }
    for label, shapes in (("", top), (f" level {BOOT_LOW_LEVEL}", low)):
        for name in ("gadget_accumulate", "gadget_accumulate[no_d]", "mod_down_combine"):
            cases[name + label] = shapes[name]
    return cases


def boot_counters():
    """Every kernel counter of the port: the path's own three and those that
    must not launch on it (K9, K10, K11, the uint64 kernels)."""
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
    from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu as ksg
    from toy_heaan_ckks_tpu_torch.ops import moddown_gpu as mdg
    from toy_heaan_ckks_tpu_torch.ops import ntt_gpu
    from toy_heaan_ckks_tpu_torch.ops.ntt_mxu_gpu import ntt_mxu_planes

    path = (ntt_gpu.ntt_planes, ksg.gadget_accumulate, mdg.mod_down_combine)
    others = (ntt_gpu.ntt_planes_wide, ksg.gadget_accumulate_wide,
              mdg.mod_down_combine_wide, ntt_mxu_planes, cg.coeff_tail, cg.coeff_cross,
              cg.coeff_cross_stages)
    return path, others


def boot_zero(path, others) -> None:
    zero_counts(path + others)
    path[2].launches_no_t = 0


def boot_counts(cfg: BootConfig, path, others) -> dict:
    """The path's launches (each on clusters where the ring spans one,
    ``read_counts``), K3' apart; raises if another kernel launched."""
    launches = read_counts(cfg, path, wide=False)
    launches["mod_down_combine[no_t]"] = path[2].launches_no_t
    stray = {f.__name__: f.launches for f in others if f.launches}
    if stray or min(launches.values()) < 1:
        raise AssertionError(f"[{cfg.name}] launches {launches}, other kernels {stray}")
    return launches


class _Spies:
    """Wrappers around the refresh's stages for one ``bootstrap`` call:
    the seconds and the last output of each stage of ``models.bootstrap``
    (``raise_modulus``, ``coeff_to_slot``, ``eval_mod``, ``slot_to_coeff``),
    the level of each scale heal (``algorithms.normalize_scale``), the
    first and the last fused multiply (``CkksEngine.mul_rescale``) with its
    inputs, and the keygen and encode seconds of ``bkeys``. Undone on
    exit."""

    STAGES = ("raise_modulus", "coeff_to_slot", "eval_mod", "slot_to_coeff")

    def __init__(self, bkeys):
        import importlib

        from toy_heaan_ckks_tpu_torch import CkksEngine

        self.bt = importlib.import_module("toy_heaan_ckks_tpu_torch.models.bootstrap")
        self.alg = importlib.import_module("toy_heaan_ckks_tpu_torch.models.algorithms")
        self.engine, self.bkeys = CkksEngine, bkeys
        self.seconds = dict.fromkeys(self.STAGES + ("keygen", "encodes"), 0.0)
        self.out, self.heals, self.muls = {}, [], []

    def __enter__(self):
        self.saved = {name: getattr(self.bt, name) for name in self.STAGES}
        for name, fn in self.saved.items():
            setattr(self.bt, name, self._stage(name, fn))
        self.normalize = self.alg.normalize_scale
        self.mul_rescale = self.engine.__dict__["mul_rescale"]
        self.alg.normalize_scale = self._heal
        self.engine.mul_rescale = staticmethod(self._mul)
        for name, total in (("rot_keys", "keygen"), ("conj", "keygen"),
                            ("encoded_diags", "encodes")):
            setattr(self.bkeys, name, self._timed(getattr(self.bkeys, name), total))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.bt, name, fn)
        self.alg.normalize_scale = self.normalize
        self.engine.mul_rescale = self.mul_rescale
        for name in ("rot_keys", "conj", "encoded_diags"):
            del self.bkeys.__dict__[name]
        return False

    def _timed(self, fn, total: str):
        import torch

        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[total] += time.perf_counter() - t0
            return out
        return wrapped

    def _stage(self, name: str, fn):
        timed = self._timed(fn, name)

        def wrapped(*args, **kw):
            out = self.out[name] = timed(*args, **kw)
            return out
        return wrapped

    def _heal(self, engine, ct, target):
        self.heals.append(ct.level)
        return self.normalize(engine, ct, target)

    def _mul(self, a, b, rlk):
        out = self.mul_rescale.__func__(a, b, rlk)
        call = (a, b, rlk, out)
        if not self.muls:
            self.muls.append(call)
        else:
            self.muls[1:] = [call]
        return out


def twin_mul(name: str, call, degree: int) -> int:
    """Holds one fused multiply made on the card (``CkksEngine.mul_rescale``)
    to the CPU twin on the same words; its level."""
    import torch

    from toy_heaan_ckks_tpu_torch import CkksContext
    from toy_heaan_ckks_tpu_torch.parallel.sharded import _mul_relin_rescale_arrays

    a, b, rlk, out = call
    cpu = torch.device("cpu")
    ctx_cpu = CkksContext.build(a.ctx.moduli, degree, cpu)
    ext_cpu = CkksContext.build(rlk.ext_ctx.moduli, degree, cpu)
    c0, c1 = _mul_relin_rescale_arrays(
        a.c0.data.cpu(), a.c1.data.cpu(), b.c0.data.cpu(), b.c1.data.cpu(),
        rlk.a.cpu(), rlk.b.cpu(), ctx_cpu, ext_cpu, ctx_cpu.drop_last(1),
        digit_size=rlk.digit_size)
    if not (torch.equal(c0, out.c0.data.cpu()) and torch.equal(c1, out.c1.data.cpu())):
        raise AssertionError(f"[{name}] GPU mul_rescale at level {a.level} differs from "
                             "the CPU twin")
    return a.level


def boot_refresh(cfg: BootConfig, s: dict, dev, keep_level: int | None = None) -> dict:
    """One cold ``bootstrap`` of ``s``'s ciphertext through ``_Spies``, the
    counts set to 0 just before it and read just after (the lazy keygen of
    the ladder's and the bootstrap's keys inside it included), the peak
    device memory over it. ``keep_level``: a DFT level whose rotation keys
    are kept."""
    import torch

    from toy_heaan_ckks_tpu_torch.models import bootstrap

    path, others = boot_counters()
    bkeys = s["bkeys"]
    if keep_level is not None:
        evict = bkeys.evict_level
        bkeys.evict_level = lambda level: None if level == keep_level else evict(level)
    kw = dict(r=cfg.r, deg=cfg.deg, dft_levels=cfg.dft_levels, arcsine=True)
    with _Spies(bkeys) as spies:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        boot_zero(path, others)
        t0 = time.perf_counter()
        out = bootstrap(s["ct1"], s["full"], bkeys, s["params"], s["enc"], **kw)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = boot_counts(cfg, path, others)
    if keep_level is not None:
        del bkeys.__dict__["evict_level"]
    return dict(out=out, cold=cold, launches=launches, spies=spies,
                peak=torch.cuda.max_memory_allocated(), kw=kw)


def decode_slots(cfg, s: dict, ct):
    """The first N/2 slots of ``ct``'s decode with ``s``'s secret key and
    encoder (finite, or this raises)."""
    import numpy as np

    from toy_heaan_ckks_tpu_torch import CkksEngine

    got = s["enc"].decode_complex(CkksEngine.decrypt(ct, s["sk"].reduce_to(ct.ctx)))
    got = got[: cfg.degree // 2]
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"[{cfg.name}] decode: non-finite values")
    return got


def run_boot_refresh(cfg: BootConfig, dev) -> dict:
    """Phase 3f at N = 2^10: the whole refresh through ``models.bootstrap``
    on the card (``boot_refresh``), word-equal to the port's CPU path from
    the same seeds, its decode within BOOT_REFRESH_ERR, K1, K2, K3 and K3'
    launched and nothing else; then, with the keys kept, a warm refresh.
    Returns the level path (output level, heal levels) the 2^16 refresh
    must follow."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch.models import bootstrap

    t0 = time.perf_counter()
    s = boot_setup(cfg, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    run = boot_refresh(cfg, s, dev)
    out, sp = run["out"], run["spies"]
    err = float(np.max(np.abs(decode_slots(cfg, s, out).real - s["m"])))
    print(f"[{cfg.name}] setup {setup_s:.2f} s; cold refresh {run['cold']:.2f} s (keygen "
          f"{sp.seconds['keygen']:.2f}, encodes {sp.seconds['encodes']:.2f}), level 1 -> "
          f"{out.level}, scale heals at levels {sp.heals}; launches {run['launches']}")
    print(f"[{cfg.name}] decode max |err| vs m: {err:.3e}, precision "
          f"{-np.log2(err / cfg.mmax):.2f} bits (bound {BOOT_REFRESH_ERR})")
    if err > BOOT_REFRESH_ERR:
        raise AssertionError(f"[{cfg.name}] refresh decode error {err} > {BOOT_REFRESH_ERR}")
    if out.level != BOOT_LEVEL_OUT:
        raise AssertionError(f"[{cfg.name}] refresh left level {out.level}, "
                             f"not {BOOT_LEVEL_OUT}")

    t0 = time.perf_counter()
    cpu = boot_setup(cfg, torch.device("cpu"))
    want = bootstrap(cpu["ct1"], cpu["full"], cpu["bkeys"], cpu["params"], cpu["enc"],
                     **run["kw"])
    if (want.level, want.logp, want.true_scale) != (out.level, out.logp, out.true_scale) or \
            not (torch.equal(out.c0.data.cpu(), want.c0.data)
                 and torch.equal(out.c1.data.cpu(), want.c1.data)):
        raise AssertionError(f"[{cfg.name}] GPU refresh differs from the CPU path")
    print(f"check [{cfg.name}] refresh: GPU c0 / c1 == CPU path, level {out.level} "
          f"({time.perf_counter() - t0:.2f} s on the CPU)")

    # keys and encodes kept: one refresh to make them, then a warm one
    bkeys = s["bkeys"]
    bkeys.evict = False
    refresh = lambda: bootstrap(s["ct1"], s["full"], bkeys, s["params"], s["enc"],
                                **run["kw"])
    refresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refresh()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"[{cfg.name}] warm refresh (keys and encodes kept): {warm:.3f} s "
          f"({_smi('name,power.limit')})")
    return dict(launches=run["launches"], err=err, level=out.level, heals=sp.heals,
                cold=run["cold"], warm=warm, refresh=refresh)


def run_boot_full(cfg: BootConfig, dev, twin: dict) -> dict:
    """Phase 3f at full width: the whole refresh at N = 2^16 through
    ``models.bootstrap`` on the card (``boot_refresh``, evicting each DFT
    level's keys but CoeffToSlot's first), counts set to 0 just before it
    and read just after, then its checks: raise_modulus exact (m + q0 I,
    |I| bounded), CoeffToSlot's decode within BOOT_CTS_ERR of the raised
    plaintext's packed coefficients, the level path (output level, scale
    heals) of the 2^10 refresh ``twin`` on the same primes, EvalMod's first
    and last fused multiply word-equal to the CPU twin, the refresh's decode
    within BOOT_FULL_ERR of m, and a square-and-rescale of it within
    BOOT_SQUARE_ERR of m^2 and BOOT_SQUARE_SELF_ERR of the refresh's own
    decode squared; K4, K2, K3 and K3' launched on clusters only, nothing
    else."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch import CkksEngine as E
    from toy_heaan_ckks_tpu_torch.encoding.embedding import expected_dft
    from toy_heaan_ckks_tpu_torch.models.bootstrap import (
        _grouped_dft_diagonals, _matvec_diagonal_map,
    )

    n, lv = cfg.degree, cfg.dft_levels
    t0 = time.perf_counter()
    s = boot_setup(cfg, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    run = boot_refresh(cfg, s, dev, keep_level=cfg.count)
    out, sp = run["out"], run["spies"]
    raised, t = sp.out["raise_modulus"], sp.out["coeff_to_slot"]

    t0 = time.perf_counter()
    q0 = s["full"].moduli[0]
    m1 = E.decrypt(s["ct1"], s["sk1"]).poly.to_coeffs()
    mr = E.decrypt(_low(raised), s["sk"].reduce_to(_low(raised).ctx)).poly.to_coeffs()
    if any(int(d) for d in (mr - m1) % q0):
        raise AssertionError(f"[{cfg.name}] raise_modulus: not congruent mod q0")
    big_i = max(abs(int(v)) for v in (mr - m1) // q0)
    if big_i > (cfg.hw + 3) // 2 + 1:
        raise AssertionError(f"[{cfg.name}] raise_modulus: |I| = {big_i}")
    t_want, _ = expected_dft(mr, raised.true_scale, n)
    cts_err = float(np.max(np.abs(decode_slots(cfg, s, _low(t)) - t_want)))
    got = decode_slots(cfg, s, out).real
    err = float(np.max(np.abs(got - s["m"])))
    rlk = s["ladder"].at_level(out.level).rlk
    sq = E.rescale_ciphertext(E.square_ciphertext(out, rlk))
    got_sq = decode_slots(cfg, s, sq).real
    sq_err = float(np.max(np.abs(got_sq - s["m"] ** 2)))
    sq_self = float(np.max(np.abs(got_sq - got ** 2)))
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mul_levels = [twin_mul(cfg.name, call, cfg.degree) for call in sp.muls]
    twin_s = time.perf_counter() - t0

    sec = sp.seconds
    print(f"check [{cfg.name}] raise_modulus: m + q0 I exact, |I| <= {big_i}; EvalMod's "
          f"fused multiplies at levels {mul_levels}: GPU == CPU twin ({twin_s:.2f} s)")
    print(f"[{cfg.name}] refresh level 1 -> {out.level} (CoeffToSlot {t.level}), scale "
          f"heals at levels {sp.heals}; {twin['level']} and {twin['heals']} at 2^10")
    print(f"[{cfg.name}] decode max |err|: CoeffToSlot {cts_err:.3e} (bound {BOOT_CTS_ERR}); "
          f"refresh vs m {err:.3e}, precision {-np.log2(err / cfg.mmax):.2f} bits (bound "
          f"{BOOT_FULL_ERR}); its square + rescale vs m^2 {sq_err:.3e} (bound "
          f"{BOOT_SQUARE_ERR}), vs its decode squared {sq_self:.3e} (bound "
          f"{BOOT_SQUARE_SELF_ERR})")
    print(f"[{cfg.name}] seconds ({_smi('name,power.limit')}): setup (ladder, level-1 key "
          f"and ciphertext) {setup_s:.2f}; cold refresh {run['cold']:.2f}: keygen "
          f"{sec['keygen']:.2f}, encodes {sec['encodes']:.2f}; raise_modulus "
          f"{sec['raise_modulus']:.3f}, CoeffToSlot {sec['coeff_to_slot']:.2f}, EvalMod "
          f"(both halves) {sec['eval_mod']:.2f}, SlotToCoeff {sec['slot_to_coeff']:.2f} "
          f"(keygen and encodes inside); host checks {host_s:.2f}")
    print(f"[{cfg.name}] peak device memory over the refresh {run['peak'] / 2**30:.2f} GiB; "
          f"launches {run['launches']}")
    if (out.level, sp.heals) != (twin["level"], twin["heals"]):
        raise AssertionError(f"[{cfg.name}] level path differs from the 2^10 refresh's")
    if mul_levels[-1] != BOOT_LOW_LEVEL:
        raise AssertionError(f"[{cfg.name}] EvalMod's last multiply at level "
                             f"{mul_levels[-1]}, not {BOOT_LOW_LEVEL}")
    for name, e, bound in (("CoeffToSlot", cts_err, BOOT_CTS_ERR),
                           ("refresh", err, BOOT_FULL_ERR),
                           ("square", sq_err, BOOT_SQUARE_ERR),
                           ("square vs refresh", sq_self, BOOT_SQUARE_SELF_ERR)):
        if e > bound:
            raise AssertionError(f"[{cfg.name}] {name} decode error {e} > {bound}")
    top = _grouped_dft_diagonals(n, lv)[0][0]  # CoeffToSlot's first level
    bkeys = s["bkeys"]
    return dict(launches=run["launches"], peak=run["peak"], cold=run["cold"],
                seconds=sec, err=err, bkeys=bkeys, top_keys=len(top) - 1,
                top_level=lambda: E.rescale_ciphertext(
                    _matvec_diagonal_map(raised, bkeys, top, s["enc"])))


def _low(ct, keep: int = BOOT_LOW_CHANNELS):
    """``ct`` on its first ``keep`` channels: the same plaintext wherever
    its coefficients lie within (-Q_keep / 2, Q_keep / 2], and a decrypt
    and decode of ``keep`` channels on the host instead of ct.level."""
    from toy_heaan_ckks_tpu_torch.types import Ciphertext

    drop = ct.level - keep
    if drop <= 0:
        return ct
    return Ciphertext(c0=ct.c0.mod_drop_last(drop), c1=ct.c1.mod_drop_last(drop),
                      logp=ct.logp, logq=ct.logq, scale=ct.scale)


# phase 3g: the last models (models/compare.py, models/linalg.py).
#
# Comparison: examples/encrypted_compare.py's recipe at full width:
# build_modulus_chain(2^16, 30, CMP_DEPTH) with the helper's default q0 of 40
# bits, so every level's chain is wide (R = 2^64, int64 planes: K5'/K7, K6 and
# K8 / K8' on clusters of 16 at 2^16, the glue the bit-serial int64 products),
# CkksParams(3.2, N/2, 30) (a dense secret), keys from make_rng(42) with a lazy
# KeyLadder, N/2 slots of a and b from np.random.default_rng(7) with |a - b|
# in [0.25, 0.95], g_iters 1, f_iters 2. On the NTT primes of 2^16 the chain's
# primes lie up to a few percent off 2^30, so nearly every Chebyshev step heals
# a scale mismatch (funceval._combine spends a level): CMP_DEPTH is the
# smallest depth at which compare, eval_max and eval_relu all end at level >= 1
# (python -m tools.model_noise --impl port --op compare --log-n 8 --depth 13 ...
# 24 --chain-ring 65536; NTT primes of 2^16 serve every smaller ring and give
# the same level path, so CMP_LEVELS is the full-width run's, and the
# reference's words at 2^8 on these primes are the port's).
CMP_RING, CMP_DEPTH, CMP_SCALE = 1 << 16, 24, 30
CMP_KEY_SEED, CMP_VALUE_SEED = 42, 7
CMP_SIGN = dict(g_iters=1, f_iters=2)
# (output level, the levels of the scale heals) of each op
CMP_HEALS = [23, 21, 21, 19, 16, 14, 14, 12, 9, 7, 7, 5]
CMP_LEVELS = {"compare": (3, CMP_HEALS), "eval_max": (2, CMP_HEALS + [3]),
              "eval_relu": (1, CMP_HEALS + [3])}
# decode gates: examples/encrypted_compare.py's 0.02 where the least-squares
# fit of log2(err) over N = 2^8 ... 2^14 on these primes keeps the error at
# 2^16 inside it, else twice the fitted error there (python -m
# tools.model_noise --impl port --device cuda --op compare --log-n 8 9 10 11
# 12 13 14 --depth 24 --chain-ring 65536 on an NVIDIA H100; the words equal
# the CPU path's at 2^8 ... 2^10 and the reference's at 2^8): compare
# 1.244e-6 ... 5.095e-4, slope 1.62, 0.0103 at 2^16; eval_max 5.578e-6 ...
# 6.580e-3, slope 1.64, 0.0794; eval_relu 3.629e-6 ... 3.504e-3, slope 1.61,
# 0.0398
CMP_ERR = {"compare": 0.02, "eval_max": 0.16, "eval_relu": 0.08}
# the word check at N = 2^10: compare on the card against the port's CPU path
# on the same recipe and primes, at depth 12 with one g_3 step and one f_1
# step (both branches, in the order of composition; level 13 -> 2): the CPU
# path's bit-serial int64 products take minutes over the full recipe there
CMP_WORDS_RING, CMP_WORDS_DEPTH = 1 << 10, 12
CMP_WORDS_SIGN = dict(g_iters=1, f_iters=1, n=1)
# Linear algebra: examples/encrypted_matmul.py's recipe at N = 2^13:
# generate_primes(30, 5, N), CkksParams(3.2, N/2, 30), keys from make_rng(42)
# with a lazy KeyLadder and MatvecKeys, d x d operands uniform in [-1, 1] /
# sqrt(d) from np.random.default_rng(7) with d^2 = N/2; and a dense N/2 x N/2
# matrix-vector product with giant="auto" (BSGS, 64 baby steps and 63 giant
# ones), the matrix uniform in [-1, 1] / sqrt(N/2) and the vector in [-1, 1]
# from np.random.default_rng(11). The gate is the example's 1e-3: the
# reference's errors on the CPU at d = 4, 8, 16 (python -m tools.model_noise
# --impl reference --op matmul --d 4 8 16: 1.345e-7, 8.958e-7, 4.132e-6 for
# the product) stay below it, and the port's fit over d = 4 ... 64 (the same
# words as the reference's at 4 ... 16) gives 1.5e-4 for the product and
# 1.7e-4 for the transpose at d = 64.
LA_RING, LA_PRIMES, LA_SCALE = 1 << 13, 5, 30
LA_ERR = 1e-3
LA_WORDS_D = 16  # the word check: d = 16 at N = 2^9


def model_counters():
    """Every kernel counter of the port."""
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
    from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu as ksg
    from toy_heaan_ckks_tpu_torch.ops import moddown_gpu as mdg
    from toy_heaan_ckks_tpu_torch.ops import ntt_gpu
    from toy_heaan_ckks_tpu_torch.ops.ntt_mxu_gpu import ntt_mxu_planes

    return {"small": (ntt_gpu.ntt_planes, ksg.gadget_accumulate, mdg.mod_down_combine),
            "wide": (ntt_gpu.ntt_planes_wide, ksg.gadget_accumulate_wide,
                     mdg.mod_down_combine_wide),
            "other": (ntt_mxu_planes, cg.coeff_tail, cg.coeff_cross, cg.coeff_cross_stages)}


class ModelRun:
    """Counts set to 0 just before a call of a model path and read just
    after (``launches``, K3' / K8' apart): the path's kernels (``small`` or
    ``wide``) on clusters where ``cfg`` says (``read_counts``), no other
    kernel. Which of the path's kernels one call needs depends on the call
    (a product without rotations runs no t-less mod-down, a transpose no key
    switch): ``require_launched`` checks them over a phase's calls."""

    def __init__(self, cfg: PathConfig, wide: bool):
        counters = model_counters()
        self.cfg, self.wide = cfg, wide
        self.path = counters["wide" if wide else "small"]
        self.others = counters["small" if wide else "wide"] + counters["other"]

    def __enter__(self):
        zero_counts(self.path + self.others)
        self.path[2].launches_no_t = 0
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:
            return False
        self.launches = read_counts(self.cfg, self.path, self.wide)
        self.launches[f"{self.path[2].__name__}[no_t]"] = self.path[2].launches_no_t
        stray = {f.__name__: f.launches for f in self.others if f.launches}
        if stray:
            raise AssertionError(f"[{self.cfg.name}] launches {self.launches}, other "
                                 f"kernels {stray}")
        return False


def require_launched(name: str, runs, wide: bool) -> None:
    """Each of the path's three kernels launched in at least one of ``runs``
    (dicts of ``ModelRun.launches``)."""
    path = model_counters()["wide" if wide else "small"]
    total = {f.__name__: sum(r[f.__name__] for r in runs) for f in path}
    if min(total.values()) < 1:
        raise AssertionError(f"[{name}] a kernel of the path never launched: {total}")


class _Recorder:
    """Host seconds of chosen callables (``timed``), the level of every scale
    heal (``algorithms.normalize_scale``) and the fused multiplies
    (``CkksEngine.mul_rescale``) made inside ``compare.eval_sign``, while
    active."""

    def __init__(self):
        import importlib

        from toy_heaan_ckks_tpu_torch import CkksEngine

        self.alg = importlib.import_module("toy_heaan_ckks_tpu_torch.models.algorithms")
        self.cmp = importlib.import_module("toy_heaan_ckks_tpu_torch.models.compare")
        self.engine = CkksEngine
        self.seconds, self.heals, self.sign_muls = {}, [], []
        self._in_sign, self._undo = False, []

    def timed(self, owner, name: str, total: str):
        import torch

        fn = getattr(owner, name)
        self.seconds.setdefault(total, 0.0)

        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[total] += time.perf_counter() - t0
            return out

        setattr(owner, name, wrapped)  # an instance attribute over the class's
        self._undo.append((owner, name))

    def __enter__(self):
        normalize, sign = self.alg.normalize_scale, self.cmp.eval_sign
        mul_rescale = self.engine.__dict__["mul_rescale"]

        def heal(engine, ct, target):
            self.heals.append(ct.level)
            return normalize(engine, ct, target)

        def in_sign(*args, **kw):
            self._in_sign = True
            try:
                return sign(*args, **kw)
            finally:
                self._in_sign = False

        def mul(a, b, rlk):
            out = mul_rescale.__func__(a, b, rlk)
            if self._in_sign:
                self.sign_muls[:] = [(a, b, rlk, out)]
            return out

        self.alg.normalize_scale, self.cmp.eval_sign = heal, in_sign
        self.engine.mul_rescale = staticmethod(mul)
        self._saved = (normalize, sign, mul_rescale)
        return self

    def __exit__(self, *exc):
        self.alg.normalize_scale, self.cmp.eval_sign, mul_rescale = self._saved
        self.engine.mul_rescale = mul_rescale
        for owner, name in reversed(self._undo):
            delattr(owner, name)
        return False


def cmp_setup(degree: int, depth: int, dev) -> dict:
    """The comparison recipe's chain, keys and two ciphertexts on ``dev``,
    drawn in the example's order."""
    import numpy as np

    from toy_heaan_ckks_tpu_torch import (
        CkksContext, CkksEncoder, CkksEngine, CkksParams, KeyLadder, build_modulus_chain,
    )
    from toy_heaan_ckks_tpu_torch.math.sampling import make_rng

    plan = build_modulus_chain(CMP_RING, CMP_SCALE, depth)
    ctx = CkksContext.build(list(plan.moduli), degree, dev)
    params = CkksParams(3.2, degree // 2, CMP_SCALE)
    eng = CkksEngine(ctx, params)
    enc = CkksEncoder(degree, CMP_SCALE)
    rng = make_rng(CMP_KEY_SEED)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    ladder = KeyLadder(ctx, sk, 3.2, rng, lazy=True)
    m_rng = np.random.default_rng(CMP_VALUE_SEED)
    slots = degree // 2
    lo = m_rng.uniform(0.0, 0.35, slots)
    hi = lo + m_rng.uniform(0.25, 0.6, slots)
    swap = m_rng.uniform(size=slots) < 0.5
    a, b = np.where(swap, lo, hi), np.where(swap, hi, lo)
    ct_a = eng.encrypt(enc.encode(a, ctx), pk, ctx.total_bits(), rng)
    ct_b = eng.encrypt(enc.encode(b, ctx), pk, ctx.total_bits(), rng)
    return dict(ctx=ctx, params=params, enc=enc, sk=sk, ladder=ladder, a=a, b=b,
                ct_a=ct_a, ct_b=ct_b)


def cmp_calls(s: dict, sign: dict) -> dict:
    """op -> (its call on the setup's ciphertexts, the plain result)."""
    import importlib

    import numpy as np

    from toy_heaan_ckks_tpu_torch import CkksEngine

    # the models package exports a function named ``compare``
    cmp = importlib.import_module("toy_heaan_ckks_tpu_torch.models.compare")
    lad, prm, ca, cb, a, b = (s["ladder"], s["params"], s["ct_a"], s["ct_b"], s["a"],
                              s["b"])
    return {"compare": (lambda: cmp.compare(lad, prm, ca, cb, **sign),
                        (a > b).astype(float)),
            "eval_max": (lambda: cmp.eval_max(lad, prm, ca, cb, **sign), np.maximum(a, b)),
            "eval_relu": (lambda: cmp.eval_relu(lad, prm, CkksEngine.sub_ciphertexts(ca, cb),
                                                **sign), np.maximum(a - b, 0.0))}


def run_compare_full(dev) -> dict:
    """Phase 3g, comparison at N = 2^16: compare, eval_max and eval_relu of the
    recipe, each cold (the ladder's keys drawn lazily inside the first) and
    warm, with the counts set to 0 just before each cold call and read just
    after; each op's level path equal to CMP_LEVELS, its decode within
    CMP_ERR, the last fused multiply inside eval_sign word-equal to the CPU
    twin; K5'/K7, K6 and K8 launched on clusters only, nothing else; the
    keygen seconds and the peak device memory."""
    import numpy as np
    import torch

    cfg = dataclasses.replace(WIDE_16, name="compare 2^16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    s = cmp_setup(CMP_RING, CMP_DEPTH, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rows = {}
    with _Recorder() as rec:
        rec.timed(s["ladder"], "_generate", "keygen")
        for op, (call, want) in cmp_calls(s, CMP_SIGN).items():
            heals0, keygen0 = len(rec.heals), rec.seconds["keygen"]
            with ModelRun(cfg, wide=True) as counted:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = call()
                torch.cuda.synchronize()
                cold = time.perf_counter() - t0
            heals = rec.heals[heals0:]
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            err = float(np.max(np.abs(decode_slots(cfg, s, out).real - want)))
            rows[op] = dict(level=out.level, heals=heals, cold=cold, warm=warm, err=err, launches=counted.launches,
                            keygen=rec.seconds["keygen"] - keygen0, out=out)
    require_launched(cfg.name, [r["launches"] for r in rows.values()], wide=True)
    twin_level = twin_mul(cfg.name, rec.sign_muls[0], CMP_RING)
    peak = torch.cuda.max_memory_allocated()
    smi = _smi("name,power.limit")
    print(f"[{cfg.name}] setup (chain of {CMP_DEPTH + 1} primes, keys, 2 ciphertexts) "
          f"{setup_s:.2f} s; peak device memory {peak / 2**30:.2f} GiB, "
          f"{resident / 2**30:.2f} of it resident before ({smi})")
    for op, r in rows.items():
        print(f"[{cfg.name}] {op}: level {CMP_DEPTH + 1} -> {r['level']}, scale heals at "
              f"levels {r['heals']}; cold {r['cold']:.2f} s (keygen {r['keygen']:.2f}), warm "
              f"{r['warm']:.2f} s; decode max |err| {r['err']:.3e} (bound {CMP_ERR[op]}); "
              f"launches {r['launches']}")
    print(f"check [{cfg.name}] eval_sign's last fused multiply (level {twin_level}): GPU == "
          "CPU twin")
    for op, r in rows.items():
        if (r["level"], r["heals"]) != CMP_LEVELS[op]:
            raise AssertionError(f"[{cfg.name}] {op}: level path {(r['level'], r['heals'])}, "
                                 f"not {CMP_LEVELS[op]}")
        if r["err"] > CMP_ERR[op]:
            raise AssertionError(f"[{cfg.name}] {op} decode error {r['err']} > {CMP_ERR[op]}")
    from toy_heaan_ckks_tpu_torch import CkksEngine

    rlk = s["ladder"].at_level(CMP_DEPTH + 1).rlk
    return dict(rows=rows, peak=peak, setup=setup_s,
                top_mul=lambda: CkksEngine.mul_rescale(s["ct_a"], s["ct_b"], rlk))


def run_compare_words(dev) -> dict:
    """Phase 3g, comparison at N = 2^10: ``compare`` on the card word-equal
    to the port's CPU path from the same seeds (CMP_WORDS_DEPTH,
    CMP_WORDS_SIGN), K5/K7, K6 and K8 launched and nothing else."""
    import torch

    cfg = PathConfig("compare 2^10", CMP_WORDS_RING, 61, CMP_WORDS_DEPTH + 1, 1, 1,
                     CMP_SCALE, 0.0)
    s = cmp_setup(CMP_WORDS_RING, CMP_WORDS_DEPTH, dev)
    with ModelRun(cfg, wide=True) as counted:
        out = cmp_calls(s, CMP_WORDS_SIGN)["compare"][0]()
        torch.cuda.synchronize()
    require_launched(cfg.name, [counted.launches], wide=True)
    t0 = time.perf_counter()
    cpu = cmp_setup(CMP_WORDS_RING, CMP_WORDS_DEPTH, torch.device("cpu"))
    want = cmp_calls(cpu, CMP_WORDS_SIGN)["compare"][0]()
    if (want.level, want.logp, want.true_scale) != (out.level, out.logp, out.true_scale) or \
            not (torch.equal(out.c0.data.cpu(), want.c0.data)
                 and torch.equal(out.c1.data.cpu(), want.c1.data)):
        raise AssertionError(f"[{cfg.name}] GPU compare differs from the CPU path")
    print(f"check [{cfg.name}] compare ({CMP_WORDS_SIGN}, depth {CMP_WORDS_DEPTH}): GPU c0 / "
          f"c1 == CPU path, level {out.level} ({time.perf_counter() - t0:.2f} s on the "
          f"CPU); launches {counted.launches}")
    return dict(launches=counted.launches)


def la_setup(d: int, dev) -> dict:
    """The matrix product recipe at d x d (N = 2 d^2) on ``dev``: chain,
    keys, the two encrypted operands and the matvec's matrix and vector."""
    import numpy as np

    from toy_heaan_ckks_tpu_torch import (
        CkksContext, CkksEncoder, CkksEngine, CkksParams, KeyLadder, generate_primes,
    )
    from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
    from toy_heaan_ckks_tpu_torch.models.linalg import MatvecKeys

    n = 2 * d * d
    ctx = CkksContext.build(generate_primes(LA_SCALE, LA_PRIMES, n), n, dev)
    params = CkksParams(3.2, n // 2, LA_SCALE)
    eng = CkksEngine(ctx, params)
    enc = CkksEncoder(n, LA_SCALE)
    rng = make_rng(42)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    ladder = KeyLadder(ctx, sk, 3.2, rng, lazy=True)
    keys = MatvecKeys(ladder, params, rng)
    m_rng = np.random.default_rng(7)
    a = m_rng.uniform(-1.0, 1.0, (d, d)) / np.sqrt(d)
    b = m_rng.uniform(-1.0, 1.0, (d, d)) / np.sqrt(d)
    ct_a = eng.encrypt(enc.encode(a.reshape(-1), ctx), pk, ctx.total_bits(), rng)
    ct_b = eng.encrypt(enc.encode(b.reshape(-1), ctx), pk, ctx.total_bits(), rng)
    return dict(ctx=ctx, eng=eng, enc=enc, sk=sk, pk=pk, rng=rng, keys=keys, a=a, b=b,
                ct_a=ct_a, ct_b=ct_b)


def run_linalg_full(dev) -> dict:
    """Phase 3g, linear algebra at N = 2^13: encrypted_matmul (d = 64, both
    operands encrypted), encrypted_transpose of A and a dense 4096 x 4096
    encrypted_matvec (giant="auto"), each cold (its rotation keys drawn
    inside) and warm, with the counts set to 0 just before each cold call and
    read just after; each decode within LA_ERR of numpy's a @ b, a.T and
    m @ v; K1, K2 and K3' launched, one block a plane, nothing else;
    keygen, diagonal-encode and op seconds apart."""
    import numpy as np
    import torch

    from toy_heaan_ckks_tpu_torch.models import linalg

    d = int(round((LA_RING // 2) ** 0.5))
    cfg = PathConfig("linalg 2^13", LA_RING, LA_SCALE, LA_PRIMES, 1, 1, LA_SCALE, 0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    s = la_setup(d, dev)
    n2 = LA_RING // 2
    v_rng = np.random.default_rng(11)
    m = v_rng.uniform(-1.0, 1.0, (n2, n2)) / np.sqrt(n2)
    v = v_rng.uniform(-1.0, 1.0, n2)
    ct_v = s["eng"].encrypt(s["enc"].encode(v, s["ctx"]), s["pk"], s["ctx"].total_bits(),
                            s["rng"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    keys, enc = s["keys"], s["enc"]
    calls = {
        "encrypted_matmul": (lambda: linalg.encrypted_matmul(s["ct_a"], s["ct_b"], keys, enc),
                             s["a"] @ s["b"]),
        "encrypted_transpose": (lambda: linalg.encrypted_transpose(s["ct_a"], keys, enc),
                                s["a"].T),
        "encrypted_matvec": (lambda: linalg.encrypted_matvec(ct_v, m, keys, enc,
                                                             giant="auto"), m @ v),
    }
    rows = {}
    with _Recorder() as rec:
        rec.timed(keys, "rot_keys", "keygen")  # the ladder's keys drawn inside
        rec.timed(enc, "encode_complex", "encodes")
        for op, (call, want) in calls.items():
            before = dict(rec.seconds)
            with ModelRun(cfg, wide=False) as counted:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = call()
                torch.cuda.synchronize()
                cold = time.perf_counter() - t0
            spent = {k: rec.seconds[k] - before.get(k, 0.0) for k in rec.seconds}
            before = dict(rec.seconds)
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            warm_encodes = rec.seconds["encodes"] - before["encodes"]
            got = decode_slots(cfg, s, out).real.reshape(np.shape(want))
            rows[op] = dict(level=out.level, cold=cold, warm=warm, err=float(
                np.max(np.abs(got - want))), launches=counted.launches,
                keygen=spent["keygen"], encodes=spent["encodes"], warm_encodes=warm_encodes)
    require_launched(cfg.name, [r["launches"] for r in rows.values()], wide=False)
    peak = torch.cuda.max_memory_allocated()
    smi = _smi("name,power.limit")
    print(f"[{cfg.name}] setup (5 x 30-bit chain, keys, 3 ciphertexts, the {n2} x {n2} "
          f"matrix) {setup_s:.2f} s; rotation keys drawn {len(keys._rot)}; peak device "
          f"memory {peak / 2**30:.2f} GiB, {resident / 2**30:.2f} of it resident before "
          f"({smi})")
    for op, r in rows.items():
        print(f"[{cfg.name}] {op}: level {LA_PRIMES} -> {r['level']}; cold {r['cold']:.2f} s "
              f"(keygen {r['keygen']:.2f}, diagonal encodes {r['encodes']:.2f}, the op "
              f"{r['cold'] - r['keygen'] - r['encodes']:.2f}), warm {r['warm']:.2f} s "
              f"(encodes {r['warm_encodes']:.2f}); decode max |err| {r['err']:.3e} (bound "
              f"{LA_ERR}); launches {r['launches']}")
    for op, r in rows.items():
        if r["err"] > LA_ERR:
            raise AssertionError(f"[{cfg.name}] {op} decode error {r['err']} > {LA_ERR}")
    want_levels = {"encrypted_matmul": LA_PRIMES - 3, "encrypted_transpose": LA_PRIMES - 1,
                   "encrypted_matvec": LA_PRIMES - 1}
    if {op: r["level"] for op, r in rows.items()} != want_levels:
        raise AssertionError(f"[{cfg.name}] levels {rows}, not {want_levels}")
    return dict(rows=rows, peak=peak, setup=setup_s, warm_call=calls["encrypted_matmul"][0])


def run_linalg_words(dev) -> dict:
    """Phase 3g, linear algebra at N = 2^9 (d = 16): encrypted_matmul on the
    card word-equal to the port's CPU path from the same seeds."""
    import torch

    from toy_heaan_ckks_tpu_torch.models import linalg

    n = 2 * LA_WORDS_D * LA_WORDS_D
    cfg = PathConfig(f"linalg 2^{n.bit_length() - 1}", n, LA_SCALE, LA_PRIMES, 1, 1,
                     LA_SCALE, 0.0)
    s = la_setup(LA_WORDS_D, dev)
    with ModelRun(cfg, wide=False) as counted:
        out = linalg.encrypted_matmul(s["ct_a"], s["ct_b"], s["keys"], s["enc"])
        torch.cuda.synchronize()
    require_launched(cfg.name, [counted.launches], wide=False)
    cpu = la_setup(LA_WORDS_D, torch.device("cpu"))
    want = linalg.encrypted_matmul(cpu["ct_a"], cpu["ct_b"], cpu["keys"], cpu["enc"])
    if (want.level, want.logp, want.true_scale) != (out.level, out.logp, out.true_scale) or \
            not (torch.equal(out.c0.data.cpu(), want.c0.data)
                 and torch.equal(out.c1.data.cpu(), want.c1.data)):
        raise AssertionError(f"[{cfg.name}] GPU encrypted_matmul differs from the CPU path")
    print(f"check [{cfg.name}] encrypted_matmul (d = {LA_WORDS_D}): GPU c0 / c1 == CPU path, "
          f"level {out.level}; launches {counted.launches}")
    return dict(launches=counted.launches)


def time_mesh(run: dict, mesh_runs: dict) -> None:
    """Phase 4: ms per call of the small mesh multiplies at the path's batch
    beside the unsharded multiply, CUDA events in one loop each, before the
    process's first profiler window."""
    from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_mul_relin_rescale

    ctx, child, rlk = run["ctx"], run["child"], run["rlk"]
    a0, a1, b0, b1 = run["batch"]
    unsharded_ms = _cuda_ms(
        lambda: batched_mul_relin_rescale((a0, a1), (b0, b1), rlk, ctx, child), 10)
    times = {label: _cuda_ms(call, 10) for label, call in mesh_runs.items()}
    parts = "; ".join(f"{label} {ms:.4f} ms = {SMALL.batch * 1000 / ms:.1f} mults/s"
                      for label, ms in times.items())
    print(f"time [{SMALL.name}-mesh] composite batch {SMALL.batch} ({_smi('name,power.limit')}): "
          f"{parts}; unsharded {unsharded_ms:.4f} ms = "
          f"{SMALL.batch * 1000 / unsharded_ms:.1f} mults/s")


def time_composite(cfg: PathConfig, run: dict) -> None:
    """mults/s of the batched multiply at the path's batch and its batch-1
    latency."""
    from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_mul_relin_rescale

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


class Timing(NamedTuple):
    """One case's times: ``ms`` per wrapper call (CUDA events over 100
    calls after 10 warm-up calls: the host's pace where the kernel is
    shorter than the wrapper's host work), ``device_ms`` per call
    (``device_split`` over PROFILE_CALLS calls), the twin's ms, and the bound of the
    work with what sets it."""

    ms: float
    device_ms: float
    plain_ms: float
    bound_ms: float
    bound_by: str


def time_cases(cfg: PathConfig, cases: dict, int_ops_per_s: float,
               twin_iters: int) -> dict:
    """name -> Timing of each case."""
    times = {}
    for name, case in cases.items():
        ms = _cuda_ms(case.kernel, 100, warmup=10)
        split, _ = device_split(case.kernel, PROFILE_CALLS)
        device_ms = sum(split.values())
        plain_ms = _cuda_ms(case.twin, twin_iters, warmup=1)
        bytes_ms = case.bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = max(case.ops / int_ops_per_s, 2 * case.macs / INT8_OPS_PER_S) * 1e3
        t = times[name] = Timing(ms, device_ms, plain_ms, max(bytes_ms, ops_ms),
                                 "bytes" if bytes_ms >= ops_ms else "operations")
        macs = f", {case.macs} u8 MACs" if case.macs else ""
        parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items() if v)
        print(f"time [{cfg.name}] {name}: kernel {ms:.4f} ms (CUDA events), device "
              f"{device_ms:.4f} ms per call (profiler: {parts}), twin {plain_ms:.4f} "
              f"ms ({plain_ms / ms:.1f}x); bound {t.bound_ms:.4f} ms by {t.bound_by} "
              f"({case.bytes} B, {case.ops} int ops{macs}; {t.bound_ms / ms:.1%} of "
              f"the kernel time, {t.bound_ms / device_ms:.1%} of the device time)")
    return times


def time_path(cfg: PathConfig, cases: dict, errs: dict, run: dict,
              rot_launches: dict, names: dict, int_ops_per_s: float,
              twin_iters: int) -> list:
    """Phase 4 on one path: kernel / twin times and bounds. A
    row's ``launches`` is its count in the multiply run (phase 3), or for
    the t-less mod-down in the rotation run (phase 3b), whose counts every
    row also carries as ``rotate_launches``; ``cluster_launches`` counts
    the launches on clusters in the run ``launches`` comes from. Rows of a
    clustered path are named ``kernel@path``."""
    times = time_cases(cfg, cases, int_ops_per_s, twin_iters)
    fwd_ms = times["forward"].ms
    print(f"time [{cfg.name}] per channel-NTT (forward, {cfg.batch}x{cfg.count} "
          f"planes): {fwd_ms * 1000 / (cfg.batch * cfg.count):.3f} us")

    rows = []
    cluster = clustered(cfg, cfg.bits > 31)
    for case_name, (fn, src, rep) in names.items():
        t = times[case_name]
        launches = run["launches"] if fn in run["launches"] else rot_launches
        rows.append({
            "name": f"{fn}@{cfg.name}" if cluster else fn, "route": "cuda",
            "source": f"toy_heaan_ckks_tpu_torch/{src}", **rep,
            "launches": launches[fn], "rotate_launches": rot_launches.get(fn, 0),
            "cluster_launches": launches.get(f"{fn.split('[')[0]}[cluster]", 0),
            "max_abs_err": max(e for k, e in errs.items()
                               if k in _same_kernel(case_name)),
            "ms": t.ms, "plain_ms": t.plain_ms, "bound_ms": t.bound_ms,
            "bound_by": t.bound_by, "library_ms": None, "device_ms": t.device_ms,
        })
    return rows


def time_rotation(cfg: PathConfig, run: dict, rot_run: dict, iters: int) -> None:
    """Phase 4 of the rotation path: batched rotations per second and the
    batch-1 latency, the hoisted calls, and a profiler split of the
    batched rotation."""
    from toy_heaan_ckks_tpu_torch import CkksEngine as E
    from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_rotate

    ctx, (a0, a1) = run["ctx"], rot_run["batch"]
    rk, keys, pts, ct = rot_run["rotk"], rot_run["keys"], rot_run["pts"], rot_run["ct"]
    batch_ms = _cuda_ms(lambda: batched_rotate((a0, a1), rk, ctx), 20)
    one_ms = _cuda_ms(lambda: batched_rotate((a0[:1], a1[:1]), rk, ctx), 20)
    print(f"time [{cfg.name}] batched_rotate batch {cfg.batch}: {batch_ms:.4f} ms/batch "
          f"= {cfg.batch * 1000 / batch_ms:.1f} rotations/s")
    print(f"time [{cfg.name}] batched_rotate batch 1: {one_ms:.4f} ms latency")
    hoisted_calls = () if pts is None else (
        ("rotate_hoisted", lambda: E.rotate_hoisted(ct, keys)),
        ("rotate_sum_hoisted", lambda: E.rotate_sum_hoisted(ct, keys)),
        ("rotate_weighted_sum_hoisted",
         lambda: E.rotate_weighted_sum_hoisted(ct, keys, pts)))
    for name, fn in hoisted_calls:
        ms = _cuda_ms(fn, iters, warmup=2)
        print(f"time [{cfg.name}] {name} ({len(keys)} keys): {ms:.4f} ms/call")
    profile_composite(f"{cfg.name} batched_rotate batch {cfg.batch}",
                      lambda: batched_rotate((a0, a1), rk, ctx))


def time_no_d(cfg: PathConfig, rows: list, case: Case, int_ops_per_s: float,
              twin_iters: int) -> None:
    """Phase 4: K2 / K6 without d (every digit raised) on the path, its
    times and bound added to the path's K2 / K6 row as ``no_d_*``."""
    t = time_cases(cfg, {"gadget_accumulate[no_d]": case}, int_ops_per_s,
                   twin_iters)["gadget_accumulate[no_d]"]
    row = next(r for r in rows if r["name"].split("@")[0] in ("gadget_accumulate",
                                                               "gadget_accumulate_wide"))
    row.update(no_d_ms=t.ms, no_d_device_ms=t.device_ms, no_d_plain_ms=t.plain_ms,
               no_d_bound_ms=t.bound_ms)


def _same_kernel(case_name: str) -> tuple:
    """The cases that run the kernel a JSON row stands for."""
    if case_name == "inverse+fold":
        return ("forward", "inverse+fold", "inv_ntt_to_yhat")
    if case_name == "gadget_accumulate":
        return ("gadget_accumulate", "gadget_accumulate[no_d]")
    return (case_name,)


SASS_OPS = ("LDS", "STS", "LDG", "STG", "BAR", "IMAD")


def sass_counts(lib_path, kernels: dict) -> dict:
    """{label: {"total": n, op: n for SASS_OPS}} of the kernels whose
    mangled names contain ``kernels[label]``, from ``cuobjdump -sass``."""
    import os

    from toy_heaan_ckks_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    counts, label = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            label = next((k for k, v in kernels.items() if v in mangled), None)
            if label:
                counts[label] = dict.fromkeys(("total",) + SASS_OPS, 0)
        elif label and "/*" in line and ";" in line:
            text = line.split("*/", 1)[1].split(";")[0].split()
            if text and text[0].startswith("@"):
                text = text[1:]
            if not text:
                continue
            counts[label]["total"] += 1
            op = text[0].split(".")[0]
            if op in SASS_OPS:
                counts[label][op] += 1
    missing = set(kernels) - set(counts)
    if missing:
        raise AssertionError(f"cuobjdump: no SASS for {sorted(missing)}")
    return counts


# The small path's rows that run a register-pass kernel on one block per
# plane: the kernel's name, the template whose uint32 one-block form it
# replaces (still built, for N < 2^10), and its forms: the key they go
# under in the row ("" the row itself), ckks_reg_info's kernel id, and the
# mangled and the printed template arguments after log2 N (K1's direction).
REG_KERNELS = {
    "ntt_planes": ("ntt_kernel_reg", "ntt_kernel",
                   {"": (3, "Lb1E", ",true"), "forward": (2, "Lb0E", ",false")}),
    "gadget_accumulate": ("keyswitch_kernel_reg", "keyswitch_kernel", {"": (0, "", "")}),
    "mod_down_combine": ("moddown_kernel_reg", "moddown_kernel", {"": (1, "", "")}),
    "mod_down_combine[no_t]": ("moddown_kernel_reg", "moddown_kernel",
                               {"": (1, "", "")}),
}


def reg_infos(cfg: PathConfig, rows: list) -> None:
    """Adds to each row of REG_KERNELS its register-pass kernel forms at
    the path's N as built and as they fit the card (``ckks_reg_info``:
    cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    with their SASS counts beside those of the template's uint32 one-block
    instantiation."""
    import ctypes

    from toy_heaan_ckks_tpu_torch.ops import _build

    log_n = cfg.degree.bit_length() - 1
    lib = _build.library()
    lib.ckks_reg_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ckks_reg_info.restype = ctypes.c_int
    needles = {}
    for name, template, forms in REG_KERNELS.values():
        needles[f"{template}[u32, one block]"] = f"{template}IjLb0E"
        for _, mangled, shown in forms.values():
            needles[f"{name}<{log_n}{shown}>"] = f"{name}ILi{log_n}E{mangled}"
    sass = sass_counts(_build.library_path(), needles)
    for row in rows:
        if row["name"] not in REG_KERNELS:
            continue
        name, template, forms = REG_KERNELS[row["name"]]
        for key, (kernel, _, shown) in forms.items():
            buf = (ctypes.c_int * 5)()
            _build.check(lib.ckks_reg_info(kernel, log_n, buf), "ckks_reg_info")
            regs, local, threads, smem, blocks = buf
            label = f"{name}<{log_n}{shown}>"
            info = {"kernel": label, "regs_per_thread": regs,
                    "local_bytes_per_thread": local, "threads_per_block": threads,
                    "smem_bytes_per_block": smem, "blocks_per_sm": blocks,
                    "sass": {label: sass[label],
                             f"{template}[u32, one block]":
                                 sass[f"{template}[u32, one block]"]}}
            print(f"[{cfg.name}] {row['name']} {key or 'kernel'}: {json.dumps(info)}")
            if key:
                row[key] = info
            else:
                row.update(info)


# The rows that run a cluster register-pass kernel (csrc/ntt_cluster.cuh):
# the big path's (uint32, N = 2^16), the big-wide path's (uint64, 2^15)
# and the wide paths' (uint64, 2^13 and 2^14): the key each form goes under
# ("" the row itself), ckks_cluster_info's kernel id, its printed name and
# the needle of its mangled name.
def wide_cluster_id(log_n: int, form: int) -> int:
    """``ckks_cluster_info``'s id of a uint64 cluster form, by the one rule
    of csrc/ntt_cluster.cuh: 4 + 4 (log2 N - 13) + form (0 forward NTT, 1
    inverse NTT, 2 key switch, 3 mod-down), log2 N = 13 .. 16."""
    return 4 + 4 * (log_n - 13) + form


def _wide_cluster_forms(log_n: int) -> dict:
    """The uint64 forms at 2^log_n (``wide_cluster_id``)."""
    mod_down = (wide_cluster_id(log_n, 3), f"moddown_kernel_cluster64<{log_n}>",
                f"moddown_kernel_cluster64ILi{log_n}EE")
    return {
        "ntt_planes_wide": {
            "": (wide_cluster_id(log_n, 1), f"ntt_kernel_cluster64<{log_n},true>",
                 f"ntt_kernel_cluster64ILi{log_n}ELb1E"),
            "forward": (wide_cluster_id(log_n, 0), f"ntt_kernel_cluster64<{log_n},false>",
                        f"ntt_kernel_cluster64ILi{log_n}ELb0E")},
        "gadget_accumulate_wide": {"": (wide_cluster_id(log_n, 2),
                                        f"keyswitch_kernel_cluster64<{log_n}>",
                                        f"keyswitch_kernel_cluster64ILi{log_n}EE")},
        "mod_down_combine_wide": {"": mod_down},
        "mod_down_combine_wide[no_t]": {"": mod_down},
    }


CLUSTER_KERNELS = {
    "ntt_planes": {"": (2, "ntt_kernel_cluster<true>", "ntt_kernel_clusterILb1E"),
                   "forward": (1, "ntt_kernel_cluster<false>", "ntt_kernel_clusterILb0E")},
    "gadget_accumulate": {"": (3, "keyswitch_kernel_cluster", "keyswitch_kernel_clusterEPKj")},
    "mod_down_combine": {"": (0, "moddown_kernel_cluster", "moddown_kernel_clusterEPKj")},
    "mod_down_combine[no_t]": {"": (0, "moddown_kernel_cluster",
                                    "moddown_kernel_clusterEPKj")},
    **_wide_cluster_forms(15),
}
# the uint64 forms at 2^16 (the wide-2^16 kernel checks and times)
WIDE_16_CLUSTER_KERNELS = _wide_cluster_forms(16)
# the uint64 forms at 2^13 (the wide path) and 2^14 (wide-62b)
WIDE_CLUSTER_KERNELS = {log_n: _wide_cluster_forms(log_n) for log_n in WIDE_CLUSTER_LOG_N}


def cluster_info(kernel: int) -> list:
    """A cluster form as built and as it fits the card (``ckks_cluster_info``
    of its id: cudaFuncGetAttributes, cudaOccupancyMaxActiveClusters):
    registers and spill bytes a thread, threads and shared bytes a block,
    blocks a cluster, resident clusters."""
    import ctypes

    from toy_heaan_ckks_tpu_torch.ops import _build

    buf = (ctypes.c_int * 6)()
    _build.check(_build.library().ckks_cluster_info(kernel, buf), "ckks_cluster_info")
    return list(buf)


def cluster_infos(cfg: PathConfig, rows: list, table: dict = CLUSTER_KERNELS) -> None:
    """Adds to each row of the path that ``table`` names (CLUSTER_KERNELS:
    the big and big-wide paths; WIDE_CLUSTER_KERNELS[13]: the wide path) the
    cluster form that ran
    (``cluster_info``), with its SASS counts."""
    from toy_heaan_ckks_tpu_torch.ops import _build

    sass = sass_counts(_build.library_path(), {
        shown: needle for forms in table.values()
        for _, shown, needle in forms.values()})
    for row in rows:
        forms = table.get(row["name"].split("@")[0])
        if forms is None:
            continue
        for key, (kernel, shown, _) in forms.items():
            regs, local, threads, smem, blocks, clusters = cluster_info(kernel)
            info = {"form": shown, "regs_per_thread": regs,
                    "local_bytes_per_thread": local, "threads_per_block": threads,
                    "smem_bytes_per_block": smem, "cluster_blocks": blocks,
                    "active_clusters": clusters, "sass": sass[shown]}
            print(f"[{cfg.name}] {row['name']} {key or 'kernel'}: {json.dumps(info)}")
            if key:
                row[key] = info
            else:
                row.update(info)


_SPIN_KEYS: set = set()  # device event keys of torch.cuda._sleep's kernel
# spin kernels that open and close a profiler window: a window loses its
# first records (up to 11, 3 spins and 8 kernels, late in a chip_smoke.py
# run on an NVIDIA H100 80GB HBM3), so the spins before the calls take them
LEAD_SPINS, TRAIL_SPINS = 64, 4


def _spin_keys() -> set:
    """The profiler's device event keys of ``torch.cuda._sleep``'s kernel,
    from a window of 8 such kernels alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not _SPIN_KEYS:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
        _SPIN_KEYS.update(ev.key for ev in prof.key_averages()
                          if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA)
        if not _SPIN_KEYS:
            raise AssertionError("torch.profiler recorded no torch.cuda._sleep kernel")
    return _SPIN_KEYS


def _spin(count: int) -> None:
    import torch

    for _ in range(count):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def _device_work(key: str) -> bool:
    """Whether a device event key of torch.profiler is work on the card (a
    kernel, named with its signature, or a copy or fill), not a record of
    the tracer's own overhead."""
    return "(" in key or key.startswith(("Memcpy", "Memset"))


def device_split(fn, iters: int, windows: int = 12) -> tuple:
    """Device ms per call of ``fn`` split into the port's kernels and the
    rest (torch elementwise glue), from torch.profiler over ``iters`` calls,
    and the wall ms per call under the profiler. torch.profiler loses
    device records, the first of a window above all, so that a window
    reads low or records nothing. So each window is the active
    step of a profiler schedule whose warm-up step (traced, not kept) runs
    one call, and it opens and closes with spin kernels
    (``torch.cuda._sleep``, not counted). A window is whole where every
    other kernel's event count is a whole multiple of ``iters``; the
    split is taken once two whole windows show the same counts, and after
    ``windows`` windows without that this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    spin = _spin_keys()
    fn()
    torch.cuda.synchronize()
    seen = set()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            _spin(LEAD_SPINS)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
            _spin(TRAIL_SPINS)
            prof.step()
        # (a kernel counts under the first key its name holds: "ntt_mxu" is
        # K9's two kernels, "cross_kernel" / "cross_stages_kernel" K11's)
        split = {"ntt_kernel": 0.0, "ntt_mxu": 0.0, "keyswitch_kernel": 0.0,
                 "moddown_kernel": 0.0, "tail_kernel": 0.0, "cross_kernel": 0.0,
                 "cross_stages_kernel": 0.0,
                 "other": 0.0}
        counts, spins = {}, 0
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA or not us:
                continue
            if ev.key in spin:
                spins += ev.count
            if ev.key in spin or not _device_work(ev.key):
                continue
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
            key = next((k for k in split if k in ev.key), "other")
            split[key] += us / 1e3 / iters
        signature = tuple(sorted(counts.items()))
        if counts and all(c % iters == 0 for c in counts.values()):
            if signature in seen:
                return split, wall
            seen.add(signature)
        else:
            short = {k[:48]: c for k, c in counts.items() if c % iters}
            print(f"profile: a window of {iters} calls lost device records "
                  f"({sum(counts.values())} events of {len(counts)} kernels, {spins} of "
                  f"{LEAD_SPINS} + {TRAIL_SPINS} spins; {short})")
    raise AssertionError(f"torch.profiler: no two of {windows} windows recorded every device "
                         f"event of {iters} calls alike")


def profile_composite(label: str, fn, iters: int = 5) -> None:
    """Device time of ``fn`` split into the port's kernels and the rest
    (torch elementwise glue), from torch.profiler over ``iters`` calls."""
    split, wall = device_split(fn, iters)
    busy = sum(split.values())
    parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
    print(f"profile [{label}]: device ms/call: {parts}; busy {busy:.4f}, wall "
          f"{wall:.4f} (under the profiler), idle {1 - busy / wall:.1%}")


def main() -> int:
    import torch

    start = time.perf_counter()
    laps = [start]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"time: {what} {now - laps[0]:.1f} s")
        laps[0] = now

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
    small_errs = check_cases("K1-K3' small", small_cases)
    wide_cases = kernel_cases(WIDE, dev, wide=True)
    wide_errs = check_cases("K5-K8' wide", wide_cases)
    # every uint64 kernel at 2^14 on its cluster: each check's launch counted
    zero_counts(wide_counters)
    errs_62 = check_cases("K5-K8' wide 62b 2^14", kernel_cases(WIDE_62, dev, wide=True))
    print(f"[{WIDE_62.name}] kernel-check launches: "
          f"{read_counts(WIDE_62, wide_counters, wide=True)}")
    for k, e in errs_62.items():
        wide_errs[k] = max(wide_errs[k], e)
    big_cases = kernel_cases(BIG, dev, wide=False)
    big_errs = check_cases("K4/K2/K3/K3' big 2^16 (clusters of 16)", big_cases)
    big_wide_cases = kernel_cases(BIG_WIDE, dev, wide=True)
    big_wide_errs = check_cases("K5'/K6/K7/K8/K8' big-wide 2^15 (clusters of 16)",
                                big_wide_cases)
    wide_16_cases = kernel_cases(WIDE_16, dev, wide=True)
    wide_16_errs = check_cases("K5'/K6/K7/K8/K8' wide 2^16 (clusters of 16)",
                               wide_16_cases)
    for k, e in wide_16_errs.items():
        big_wide_errs[k] = max(big_wide_errs[k], e)
    mxu_cases_small, mxu_errs = check_mxu(dev)
    coeff_err = check_coeff(dev)
    coeff_shape_cases = {label: coeff_cases(dev, cfg.batch, cfg.count, cfg.degree, cfg.bits,
                                            shards)
                         for label, cfg, shards in COEFF_CASES}
    for label, cases in coeff_shape_cases.items():
        coeff_err = max(coeff_err, *check_cases(label, cases).values())
    # K1 / K4, K2, K3 and K3' at the bootstrap's shapes (phase 3f)
    boot_errs = {}
    for cfg in (BOOT_REFRESH, BOOT_FULL):
        for name, e in check_cases(f"K1-K3' {cfg.name}", boot_kernel_cases(cfg, dev)).items():
            key = name.split(" (")[0].split(" level ")[0]
            boot_errs[key] = max(boot_errs.get(key, 0), e)

    lap("phases 1-2")
    # ── phase 3: each main path through the user entry points ───────────
    small_run = run_path(SMALL, dev, small_counters, wide=False)
    wide_run = run_path(WIDE, dev, wide_counters, wide=True)
    big_run = run_path(BIG, dev, small_counters, wide=False)
    big_wide_run = run_path(BIG_WIDE, dev, wide_counters, wide=True)

    # ── phase 3b: each rotation path through the user entry points ──────
    small_rot = run_rotation(SMALL, SMALL_ROT, small_run, small_counters,
                             mdg.mod_down_combine, wide=False)
    print(f"[{WIDE.name} rotate] the hoisted calls take {len(WIDE_ROT.offsets)} "
          f"keys: their decomposition and key products are bit-serial int64 torch")
    wide_rot = run_rotation(WIDE, WIDE_ROT, wide_run, wide_counters,
                            mdg.mod_down_combine_wide, wide=True)
    big_rot = run_rotation(BIG, BIG_ROT, big_run, small_counters,
                           mdg.mod_down_combine, wide=False)
    big_wide_rot = run_rotation(BIG_WIDE, BIG_WIDE_ROT, big_wide_run, wide_counters,
                                mdg.mod_down_combine_wide, wide=True)

    # ── phase 3c: the small paths again under CKKS_NTT_MXU=1 (K9) ────────
    small_mxu = run_mxu(SMALL, small_run, small_rot, small_counters)

    # ── phase 3d: the coefficient-sharded composites (K10, K11) ─────────
    runs = {SMALL.name: (small_run, small_rot), BIG.name: (big_run, big_rot),
            BIG_WIDE.name: (big_wide_run, big_wide_rot)}
    coeff_runs = {cfg.name: run_coeff(cfg, shards, rotate, tail_clusters, dev,
                                      *runs[cfg.name], small_counters + wide_counters)
                  for cfg, shards, rotate, tail_clusters in COEFF_PATHS}

    # ── phase 3e: the batch x channel mesh on the card ─────────────────
    t0 = time.perf_counter()
    paths = {SMALL.name: (small_run, small_rot, small_counters, False),
             WIDE.name: (wide_run, wide_rot, wide_counters, True)}
    mesh_runs = [run_mesh(cfg, batch_axis, rotate, ranges, dev, *paths[cfg.name])
                 for cfg, batch_axis, rotate, ranges in MESH_CALLS]
    print(f"phase 3e (mesh): {time.perf_counter() - t0:.1f} s")

    lap("phases 3-3e")
    # ── phase 3f: the bootstrap path (models/bootstrap.py) ──────────────
    t0 = time.perf_counter()
    boot_refresh = run_boot_refresh(BOOT_REFRESH, dev)
    boot_full = run_boot_full(BOOT_FULL, dev, boot_refresh)
    print(f"phase 3f (bootstrap): {time.perf_counter() - t0:.1f} s")
    lap("phase 3f")
    # ── phase 3g: the last models (models/compare.py, models/linalg.py) ──
    # phase 3f's rotation and conjugation keys are freed first (phase 4
    # draws its first DFT level's again before profiling it)
    t0 = time.perf_counter()
    boot_full["bkeys"]._rot.clear()
    boot_full["bkeys"]._conj.clear()
    torch.cuda.empty_cache()
    from toy_heaan_ckks_tpu_torch import native

    print(f"native host runtime available: {native.available()}")
    cmp_full = run_compare_full(dev)
    cmp_words = run_compare_words(dev)
    la_full = run_linalg_full(dev)
    la_words = run_linalg_words(dev)
    print(f"phase 3g (compare, linalg): {time.perf_counter() - t0:.1f} s")
    lap("phase 3g")

    # ── phase 4: timings (CUDA events, after warm-up) ───────────────────
    small_names = {
        "inverse+fold": ("ntt_planes", "csrc/ntt.cu",
                         {"replaces": "toy_heaan_ckks_tpu/ops/ntt_pallas.py:550"}),
        "gadget_accumulate": ("gadget_accumulate", "csrc/keyswitch.cu",
                              {"replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas.py:157"}),
        "mod_down_combine": ("mod_down_combine", "csrc/moddown.cu",
                             {"replaces": "toy_heaan_ckks_tpu/ops/moddown_pallas.py:173"}),
        "mod_down_no_t": ("mod_down_combine[no_t]", "csrc/moddown.cu",
                          {"replaces": "toy_heaan_ckks_tpu/ops/moddown_pallas.py:164"}),
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
        "mod_down_no_t": ("mod_down_combine_wide[no_t]", "csrc/moddown.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:604"}),
    }
    # the large rings: K4 and K5' are the factored kernels' ports; K2/K6,
    # K3/K8 and K7 run their factored branches (cluster launches)
    big_names = {
        "inverse+fold": ("ntt_planes", "csrc/ntt.cu",
                         {"replaces": "toy_heaan_ckks_tpu/ops/ntt_pallas.py:502"}),
        "gadget_accumulate": ("gadget_accumulate", "csrc/keyswitch.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas.py:157",
            "factored_branch": "toy_heaan_ckks_tpu/ops/keyswitch_pallas.py:117"}),
        "mod_down_combine": ("mod_down_combine", "csrc/moddown.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/moddown_pallas.py:173",
            "factored_branch": "toy_heaan_ckks_tpu/ops/moddown_pallas.py:140"}),
        "mod_down_no_t": ("mod_down_combine[no_t]", "csrc/moddown.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/moddown_pallas.py:164",
            "factored_branch": "toy_heaan_ckks_tpu/ops/moddown_pallas.py:140"}),
    }
    big_wide_names = {
        "inverse+fold": ("ntt_planes_wide", "csrc/ntt.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/ntt_pallas_wide.py:353",
            "also_replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:433"}),
        "gadget_accumulate": ("gadget_accumulate_wide", "csrc/keyswitch.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:144",
            "factored_branch": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:149"}),
        "mod_down_combine": ("mod_down_combine_wide", "csrc/moddown.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:613",
            "factored_branch": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:575"}),
        "mod_down_no_t": ("mod_down_combine_wide[no_t]", "csrc/moddown.cu", {
            "replaces": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:604",
            "factored_branch": "toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py:575"}),
    }
    # K2 / K6 without d, timed apart and reported in the K2 / K6 row
    small_no_d, wide_no_d, big_no_d, big_wide_no_d = (
        cases.pop("gadget_accumulate[no_d]")
        for cases in (small_cases, wide_cases, big_cases, big_wide_cases))
    # the multiplies before the kernel cases: once a process has run
    # torch.profiler, the host takes longer over each launch (PERF.md §6)
    for cfg, run in ((SMALL, small_run), (WIDE, wide_run), (BIG, big_run),
                     (BIG_WIDE, big_wide_run)):
        time_composite(cfg, run)
    lap("the composites")
    time_mesh(small_run, {r["label"]: r["call"] for (cfg, _, rotate, _), r
                          in zip(MESH_CALLS, mesh_runs) if cfg is SMALL and not rotate})
    rows = time_path(SMALL, small_cases, small_errs, small_run,
                     small_rot["launches"], small_names, int_ops_per_s, twin_iters=5)
    time_no_d(SMALL, rows, small_no_d, int_ops_per_s, twin_iters=2)
    reg_infos(SMALL, rows)
    wide_rows = time_path(WIDE, wide_cases, wide_errs, wide_run, wide_rot["launches"],
                          wide_names, int_ops_per_s, twin_iters=2)
    time_no_d(WIDE, wide_rows, wide_no_d, int_ops_per_s, twin_iters=1)
    cluster_infos(WIDE, wide_rows, WIDE_CLUSTER_KERNELS[13])
    rows += wide_rows
    big_rows = time_path(BIG, big_cases, big_errs, big_run, big_rot["launches"],
                         big_names, int_ops_per_s, twin_iters=3)
    time_no_d(BIG, big_rows, big_no_d, int_ops_per_s, twin_iters=2)
    cluster_infos(BIG, big_rows)
    rows += big_rows
    big_wide_rows = time_path(BIG_WIDE, big_wide_cases, big_wide_errs, big_wide_run,
                              big_wide_rot["launches"], big_wide_names, int_ops_per_s,
                              twin_iters=1)
    time_no_d(BIG_WIDE, big_wide_rows, big_wide_no_d, int_ops_per_s, twin_iters=1)
    cluster_infos(BIG_WIDE, big_wide_rows)
    rows += big_wide_rows
    # the uint64 cluster forms at 2^16: times, and each form as built
    time_cases(WIDE_16, {k: wide_16_cases[k] for k in (
        "forward", "inverse+fold", "inv_ntt_to_yhat", "gadget_accumulate",
        "gadget_accumulate[no_d]", "mod_down_combine", "mod_down_no_t")},
        int_ops_per_s, twin_iters=1)
    for kernel, shown in sorted({(kernel, shown) for forms in WIDE_16_CLUSTER_KERNELS.values()
                                 for kernel, shown, _ in forms.values()}):
        print(f"[{WIDE_16.name}] {shown}: registers, spill bytes, threads, shared "
              f"bytes, blocks a cluster, resident clusters {cluster_info(kernel)}")
    wide_forms = {(kernel, shown, needle) for table in WIDE_CLUSTER_KERNELS.values()
                  for forms in table.values() for kernel, shown, needle in forms.values()}
    wide_sass = sass_counts(_build.library_path(),
                            {shown: needle for _, shown, needle in wide_forms})
    for kernel, shown, _ in sorted(wide_forms):
        print(f"[{WIDE.name}, {WIDE_62.name}] {shown}: registers, spill bytes, threads, "
              f"shared bytes, blocks a cluster, resident clusters {cluster_info(kernel)}; "
              f"SASS {json.dumps(wide_sass[shown])}")
    lap("the kernel timings")
    for cfg, run in ((SMALL, small_run), (WIDE, wide_run), (BIG, big_run),
                     (BIG_WIDE, big_wide_run)):
        ctx, child, rlk, (a0, a1, b0, b1) = (run["ctx"], run["child"], run["rlk"],
                                             run["batch"])
        profile_composite(f"{cfg.name} composite batch {cfg.batch}", lambda:
                          batched_mul_relin_rescale((a0, a1), (b0, b1), rlk, ctx, child))
    for (cfg, _, rotate, _), r in zip(MESH_CALLS, mesh_runs):
        if cfg is SMALL and not rotate:
            profile_composite(f"{r['label'][1:-1]} composite batch {SMALL.batch}", r["call"])
    time_rotation(SMALL, small_run, small_rot, iters=5)
    time_rotation(WIDE, wide_run, wide_rot, iters=3)
    time_rotation(BIG, big_run, big_rot, iters=3)
    time_rotation(BIG_WIDE, big_wide_run, big_wide_rot, iters=3)

    # K9 at the small path's shapes (batch 32 and 1), and the small path
    # under CKKS_NTT_MXU=1
    from toy_heaan_ckks_tpu_torch.ops.ntt_mxu_gpu import mxu_form

    lap("the composite profiles, the rotations")
    mxu_times = {shape: time_cases(dataclasses.replace(SMALL, name=f"K9 {shape}"),
                                   cases, int_ops_per_s, twin_iters=5 if shape == "small" else 2)
                 for shape, cases in mxu_cases_small.items()}
    forms = {shape: mxu_form(*MXU_SHAPES[shape][:3], True) for shape in mxu_cases_small}
    print(f"[K9] kernel at the small shapes (inverse): {json.dumps(forms)}")
    t = mxu_times["small"]["inverse+fold"]
    rows.append({
        "name": "ntt_mxu_planes", "route": "cuda",
        "source": "toy_heaan_ckks_tpu_torch/csrc/ntt_mxu.cu",
        "replaces": "toy_heaan_ckks_tpu/ops/ntt_mxu.py:348",
        "launches": small_mxu["launches"]["ntt_mxu_planes"],
        "launches_per_mul": small_mxu["per_call"]["batched_mul_relin_rescale"][0],
        "cluster_launches": 0, "max_abs_err": max(mxu_errs.values()),
        "ms": t.ms, "plain_ms": t.plain_ms, "bound_ms": t.bound_ms,
        "bound_by": t.bound_by, "library_ms": None, "device_ms": t.device_ms,
        "forward_ms": mxu_times["small"]["forward"].ms,
        "inverse_ms": mxu_times["small"]["inverse"].ms,
        "shapes": {shape: {**forms[shape], **{f"{mode}_device_ms": times[mode].device_ms
                                              for mode in times},
                           "bound_ms": times["inverse+fold"].bound_ms}
                   for shape, times in mxu_times.items()},
    })
    mxu_cfg = dataclasses.replace(SMALL, name="small-mxu")
    with mxu_env():
        time_composite(mxu_cfg, small_run)
        ctx, child, rlk, (a0, a1, b0, b1) = (small_run["ctx"], small_run["child"],
                                             small_run["rlk"], small_run["batch"])
        profile_composite(f"{mxu_cfg.name} composite batch {SMALL.batch}", lambda:
                          batched_mul_relin_rescale((a0, a1), (b0, b1), rlk, ctx, child))
        time_rotation(mxu_cfg, small_run, small_rot, iters=5)

    # K10 / K11 at the big coeff path's planes (the yardstick shape), then at
    # the small and big-wide paths' planes, each with K10's form; the big
    # coeff composite
    shape_times, forms = {}, {}
    for label, cfg, shards in COEFF_CASES:
        shape_times[label] = time_cases(dataclasses.replace(cfg, name=label),
                                        coeff_shape_cases[label], int_ops_per_s,
                                        twin_iters=1 if cfg.bits > 31 else 2)
        forms[label] = tail_form(cfg, shards)
        print(f"[{label}] K10 form: {json.dumps(forms[label])}")
    coeff_times = shape_times[COEFF_CASES[0][0]]
    # K11's row is its one-launch form, the form of every coeff path's launches
    # on one card (the per-stage form's time beside it, under stage_*)
    for fn, case_name, line in (("coeff_tail", "coeff_tail forward", 53),
                                ("coeff_cross_stages", "coeff_cross_stages forward", 155)):
        t = coeff_times[case_name]
        row = {
            "name": fn, "route": "cuda",
            "source": "toy_heaan_ckks_tpu_torch/csrc/coeff_ntt.cuh",
            "replaces": f"toy_heaan_ckks_tpu/parallel/coeff_ntt.py:{line}",
            "launches": sum(r["launches"][fn] for r in coeff_runs.values()),
            "launches_per_mul": coeff_runs[BIG.name]["per_call"][
                "build_mul_relin_rescale_coeff"][fn],
            "cluster_launches": sum(r["launches"].get(f"{fn}[cluster]", 0)
                                    for r in coeff_runs.values()),
            "max_abs_err": coeff_err,
            "ms": t.device_ms, "plain_ms": t.plain_ms, "bound_ms": t.bound_ms,
            "bound_by": t.bound_by, "library_ms": None,
            "shape": "(4, 4, 2^16) uint32, P 4, forward",
            "ms_is": "profiler device time per call", "call_ms": t.ms,
        }
        if fn == "coeff_cross_stages":
            stage = coeff_times["coeff_cross forward"]
            row.update(stage_kernel_ms=stage.device_ms, stage_kernel_bound_ms=stage.bound_ms,
                       stage_kernel_launches=sum(r["launches"]["coeff_cross"]
                                                 for r in coeff_runs.values()),
                       shape="(4, 4, 2^16) uint32, P 4, every cross stage, forward")
            row["shapes"] = {label: {
                **{f"{d}_ms": times[f"coeff_cross_stages {d}"].device_ms
                   for d in ("forward", "inverse")},
                **{f"{d}_bound_ms": times[f"coeff_cross_stages {d}"].bound_ms
                   for d in ("forward", "inverse")},
                "stage_kernel_ms": times["coeff_cross forward"].device_ms}
                for label, times in shape_times.items()}
        if fn == "coeff_tail":
            row["shapes"] = {label: {
                **forms[label],
                **{f"{d}_ms": times[f"coeff_tail {d}"].device_ms for d in ("forward", "inverse")},
                **{f"{d}_bound_ms": times[f"coeff_tail {d}"].bound_ms
                   for d in ("forward", "inverse")}}
                for label, times in shape_times.items()}
        rows.append(row)
    time_coeff(big_run, coeff_runs[BIG.name], 4)

    lap("the K9 path, the coefficient-sharded kernels")
    # the bootstrap path: launches per refresh (2^10) and per stage run
    # (2^16) on the K1 / K4, K2, K3 and K3' rows, and profiler splits of
    # the warm refresh and the warm CoeffToSlot's first level
    for row in rows:
        fn, _, at = row["name"].partition("@")
        run = {"": boot_refresh, "big": boot_full}.get(at)
        if run is None or fn.split("[")[0] not in ("ntt_planes", "gadget_accumulate",
                                                   "mod_down_combine"):
            continue
        counts = run["launches"]
        n = counts[fn] - (counts["mod_down_combine[no_t]"] if fn == "mod_down_combine" else 0)
        row["launches_per_bootstrap_2^10" if at == "" else "launches_per_bootstrap_2^16"] = n
        key = {"ntt_planes": "forward", "mod_down_combine[no_t]": "mod_down_no_t"}.get(fn, fn)
        row["max_abs_err"] = max(row["max_abs_err"], boot_errs.get(key, 0))
    # one call a window: a warm 2^10 refresh is ~10^4 launches under the
    # profiler, and the script's time is kept near 550 s
    profile_composite(f"{BOOT_REFRESH.name} warm refresh", boot_refresh["refresh"], iters=1)
    profile_composite(f"{BOOT_FULL.name} warm CoeffToSlot level {BOOT_FULL.count} "
                      f"({boot_full['top_keys']} keys)", boot_full["top_level"], iters=1)
    boot_full["bkeys"]._rot.clear()
    lap("the bootstrap rows and profiles")
    # the last models: launches per call (phase 3g) on the K5'/K7, K6 and K8 /
    # K8' rows of big-wide (the same cluster kernels at 2^16) and the K1, K2,
    # K3 and K3' rows of small (the same register-pass kernels at 2^13), and
    # profiler splits of a warm compare at 2^16 and a warm matmul at 2^13
    for row in rows:
        fn, _, at = row["name"].partition("@")
        if at not in ("", "big-wide"):
            continue
        base = fn.split("[")[0]
        label, op_rows = ("2^16", cmp_full["rows"]) if at else ("2^13", la_full["rows"])
        for op, r in op_rows.items():
            counts = r["launches"]
            if base not in counts:
                continue
            n = counts[fn]
            if fn == base and base.startswith("mod_down"):
                n -= counts[f"{base}[no_t]"]  # K3 / K8 apart from K3' / K8'
            row[f"launches_per_{op}_{label}"] = n
    # a whole compare is ~10^5 launches of bit-serial glue, too many for a
    # profiler window to keep: its unit, the fused multiply at the top of
    # the chain, stands for it
    profile_composite(f"compare 2^16 warm fused multiply at level {CMP_DEPTH + 1}",
                      cmp_full["top_mul"], iters=1)
    profile_composite("linalg 2^13 warm encrypted_matmul (d = 64)", la_full["warm_call"],
                      iters=1)
    lap("the model rows and profiles")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"wall time: {time.perf_counter() - start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
