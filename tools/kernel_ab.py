#!/usr/bin/env python3
"""Kernel times of one checkout of the port on the card, for an A/B in turns.

    python tools/kernel_ab.py --root PATH [--label NAME] [--sass] [--composite]
                              [--paths NAME,...] [--k10-forms]

Imports ``chip_smoke.py`` and ``toy_heaan_ckks_tpu_torch`` from the
checkout at PATH (its kernels are built there at first use), makes the
kernel cases of each of its paths small, wide, wide-62b (N = 2^14, batch
2), big, big-wide and wide-2^16 that it has, or of those ``--paths``
names (``chip_smoke.kernel_cases``: the same seeded inputs and shapes in
every checkout that has the path; copy one ``chip_smoke.py`` into both
trees for the same cases, e.g. K2 / K6 with and without d on every
path), and K10 / K11 at the coeff paths' planes where it has them
(``chip_smoke.coeff_cases``: (4, 4, 2^16) on P = 4 under ``K10/K11
big``, (4, 3, 2^15) uint64 on P = 4 under ``K10/K11 big-wide``, (32, 8,
2^14) on P = 8 under ``K10/K11 small``; with ``--paths``, those of the
paths named: K11 there as one stage and as every cross stage of a
transform, forward and inverse, ``coeff_cross_stages``, which a checkout
without K11's one-launch form runs as its stage loop on the same work),
and K9 at ``K9_SHAPES`` (``chip_smoke.mxu_cases``, the shapes the
checkout's ``MXU_SHAPES`` lacks added to it: the small path's batch 32 and
1, and R = 8, 32, 64 and 256; ``--paths mxu``), with the kernel K9 picks
(``mxu``: ``ntt_mxu_gpu.mxu_form`` where the checkout has it), and
prints one JSON line: the card's name and power limit and, per case, the
mean ms of 100 launches after 10 warm-up launches (``ms``, CUDA events:
the pace of the wrapper calls, which the host sets where the kernel is
shorter than the wrapper's host work) and the device ms per call
(``device_ms``, torch.profiler over 50 calls: the kernels alone, by this
tool's own checkout's ``chip_smoke.device_split``, which takes windows
until two record every launch alike, whichever checkout is timed), and
the least time the card could take for the case's work (``bound_ms``:
the larger of its bytes over the memory rate and its integer operations
over the int32 issue rate at the card's maximum SM clock, K9's u8 MACs
over the int8 tensor rate, as ``chip_smoke.time_cases`` counts them). Run it
once per checkout in one command on one card, in turns (parent, change,
change, parent), to compare two commits; no twin is timed. ``--sass``
adds, per kernel of the built library (each instantiation under its own
name, ``kernel_names``), its SASS instruction count, the count of each
memory instruction (``cuobjdump -sass``; LDS/STS are shared-memory
accesses, LD/ST generic ones) and a hash of its instruction text
(``sha256``: equal hashes, equal SASS). ``--composite`` first times the small
multiply at batch 32 on phase 3's inputs and keys (``chip_smoke.run_path``),
CUDA-event ms per call over windows of 10 calls, before the process first
runs torch.profiler and again after one profiler window. Where the
checkout has the cluster forms of ``csrc/ntt_cluster.cuh``, ``cluster``
gives each form's registers, spill bytes, threads and shared bytes a
block, blocks a cluster and resident clusters (uint32 K4, K3, K2 at
2^16; uint64 K5 / K5' / K7, K6 and K8 / K8' at 2^13 .. 2^16; null for a
form the checkout's library does not have). ``--k10-forms`` times, in place
of all that, K10's two register forms (``coeff_ntt_gpu.slab_form``
patched to pick each: ``block``, one block a slab, and ``cluster``, the
slab's cluster of ``csrc/coeff_ntt.cuh`` ``kSlabLogCluster*`` blocks)
forward and inverse at each of ``K10_SHAPES`` where the slab has the
form, device ms under ``k10_forms``, with each form's registers and
resident slabs (``ckks_coeff_tail_info``): the times that set
``SLAB_FILL``. To time another C, build a copy with the constant changed.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import sys


MEMORY_OPS = ("LDS", "STS", "LD", "ST", "LDG", "STG", "BAR")
# (label, batch, channels, degree, prime bits, shards) of the coeff
# paths' K10 launches (chip_smoke.py phases 2 and 3d), two more slab
# sizes (P = 1 and 2 of the small chain, P = 2 of the big-wide one:
# uint64 slabs of 2^14), and 48 .. 128 slabs of 2^12 .. 2^14 around
# SLAB_FILL
K10_SHAPES = (
    ("small", 32, 8, 1 << 14, 31, 8), ("small P 1", 32, 8, 1 << 14, 31, 1),
    ("small P 2", 32, 8, 1 << 14, 31, 2), ("big", 4, 4, 1 << 16, 30, 4),
    ("big B 6", 6, 4, 1 << 16, 30, 4), ("big B 8", 8, 4, 1 << 16, 30, 4),
    ("big B 2 P 8", 2, 4, 1 << 16, 30, 8), ("big B 3 P 8", 3, 4, 1 << 16, 30, 8),
    ("big P 8", 4, 4, 1 << 16, 30, 8), ("big-wide", 4, 3, 1 << 15, 61, 4),
    ("big-wide P 2", 4, 3, 1 << 15, 61, 2), ("big-wide P 8", 4, 3, 1 << 15, 61, 8),
    ("big-wide B 2 P 8", 2, 3, 1 << 15, 61, 8),
)
COEFF_PATHS = {"small": "SMALL", "big": "BIG", "big-wide": "BIG_WIDE"}
# K9 (items, channels, N, prime bits) at every R = N / 128 of its envelope:
# the small path's batch 32 and 1 (R = 128), and R = 8, 32, 64 and 256
K9_SHAPES = {"small": (32, 8, 1 << 14, 31), "small B 1": (1, 8, 1 << 14, 31),
             "2^10": (4, 3, 1 << 10, 31), "2^12": (8, 4, 1 << 12, 31),
             "2^13": (16, 4, 1 << 13, 31), "2^15": (2, 2, 1 << 15, 31)}
PROFILE_CALLS = 50  # calls per profiler window of a case's device time
_TIMER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "chip_smoke.py")
COMPOSITE_WINDOWS = 10  # windows of 10 calls, before and after the profiler
_NAMES = ((r"\(anonymous namespace\)::|<unnamed>::", ""), (r"\(bool\)1", "true"),
          (r"\(bool\)0", "false"), (r"\((?:unsigned )?\w+\)(?=-?\d)", ""),
          (r"unsigned long(?: long)?", "u64"), (r"unsigned int", "u32"), (r", ", ","))


def device_split(fn, iters: int) -> tuple:
    """``chip_smoke.device_split`` of this tool's checkout (not of the
    checkout timed), so that every checkout's device times are read alike;
    its notes of windows that lost records go to standard error."""
    import contextlib
    import importlib.util

    if "chip_smoke_timer" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke_timer", _TIMER)
        module = sys.modules["chip_smoke_timer"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    with contextlib.redirect_stdout(sys.stderr):
        return sys.modules["chip_smoke_timer"].device_split(fn, iters)


def kernel_names(mangled: list) -> list:
    """A short name of each instantiation, unique in the library: the
    name ``cu++filt`` (the toolkit's demangler) gives it, without its
    anonymous namespace, return type and parameters, with ``u32`` / ``u64`` for
    the word types and no casts (``ntt_kernel<u32,true>``, ``keyswitch_kernel_reg<14>``,
    ``ntt_kernel_reg<14,true>``, ``tail_kernel<u64>``)."""
    import subprocess

    from toy_heaan_ckks_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    out = subprocess.run([tool], input="\n".join(mangled) + "\n", capture_output=True,
                         text=True, check=True).stdout.splitlines()
    if len(out) != len(mangled):
        raise AssertionError(f"cu++filt: {len(out)} names for {len(mangled)}")
    names = []
    for name in out:
        for pattern, short in _NAMES:
            name = re.sub(pattern, short, name)
        names.append(name.split("(")[0].split()[-1])
    return names


def _sass_counts() -> dict:
    """{kernel: {"total": n, op: n for MEMORY_OPS}} of the checkout's
    library, by ``kernel_names``."""
    import subprocess

    from toy_heaan_ckks_tpu_torch.ops import _build

    _build.library()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(_build.library_path())],
                         capture_output=True, text=True, check=True).stdout
    kernels = []  # (mangled name, its SASS lines)
    for line in out.splitlines():
        if "Function :" in line:
            kernels.append((line.split("Function :")[1].strip(), []))
        elif kernels and "/*" in line and ";" in line:
            kernels[-1][1].append(line)
    counts = {}
    for name, (_, lines) in zip(kernel_names([k for k, _ in kernels]), kernels):
        if name in counts:
            raise AssertionError(f"two kernels named {name}")
        counts[name] = dict.fromkeys(("total",) + MEMORY_OPS, 0)
        # the instruction text, without the addresses and encodings
        text = "\n".join(line.split("*/", 1)[1].split(";")[0].strip() for line in lines)
        counts[name]["sha256"] = hashlib.sha256(text.encode()).hexdigest()[:16]
        for line in lines:
            text = line.split("*/", 1)[1].split(";")[0].split()
            if text and text[0].startswith("@"):
                text = text[1:]
            if not text:
                continue
            counts[name]["total"] += 1
            op = text[0].split(".")[0]
            if op in MEMORY_OPS:
                counts[name][op] += 1
    return counts


def composite_times(smoke, dev) -> dict:
    """{"before_profiler": [ms], "after_profiler": [ms]}: the small
    multiply's CUDA-event ms per call, COMPOSITE_WINDOWS windows of 10
    calls each, in the order taken."""
    import contextlib

    from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu, moddown_gpu, ntt_gpu
    from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_mul_relin_rescale

    counters = (ntt_gpu.ntt_planes, keyswitch_gpu.gadget_accumulate,
                moddown_gpu.mod_down_combine)
    with contextlib.redirect_stdout(sys.stderr):
        run = smoke.run_path(smoke.SMALL, dev, counters, wide=False)
    a0, a1, b0, b1 = run["batch"]
    mul = lambda: batched_mul_relin_rescale((a0, a1), (b0, b1), run["rlk"], run["ctx"],
                                            run["child"])
    before = [smoke._cuda_ms(mul, 10) for _ in range(COMPOSITE_WINDOWS)]
    device_split(mul, 5)
    after = [smoke._cuda_ms(mul, 10) for _ in range(COMPOSITE_WINDOWS)]
    return {"before_profiler": before, "after_profiler": after}


def cluster_forms(smoke) -> dict | None:
    """{form: [registers, spill bytes, threads, shared bytes, blocks a
    cluster, resident clusters]} (``chip_smoke.cluster_info``), or None
    where the checkout has no cluster forms; a form whose id the
    checkout's library does not know (a newer ``chip_smoke.py`` in an
    older checkout) maps to None."""
    if not hasattr(smoke, "cluster_info"):
        return None
    forms = {}
    tables = (smoke.CLUSTER_KERNELS, getattr(smoke, "WIDE_16_CLUSTER_KERNELS", {}),
              *getattr(smoke, "WIDE_CLUSTER_KERNELS", {}).values())
    for entry in (e for table in tables for e in table.values()):
        for kernel, shown, _ in entry.values():
            try:
                forms[shown] = smoke.cluster_info(kernel)
            except RuntimeError:
                forms[shown] = None
    return forms


def k10_forms(smoke, dev) -> dict:
    """{shape: {"picked": form, form: {"forward": ms, "inverse": ms,
    "info": [...]}}}: the device ms of K10's ``block`` and ``cluster``
    forms at K10_SHAPES where the slab has each (the inverse with the
    final factor where P = 1), ``slab_form`` patched to pick it."""
    from toy_heaan_ckks_tpu_torch.ops import _build
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg

    lib = _build.library()
    picked = cg.slab_form
    out = {}
    try:
        for label, B, L, n, bits, shards in K10_SHAPES:
            moduli, _, slabs = smoke.coeff_input(dev, B, L, n, bits, shards)
            wide, log_s = bits > 31, (n // shards).bit_length() - 1
            fin = tuple(pow(n, -1, q) for q in moduli) if shards == 1 else None
            row = out[f"{label} ({B}, {L}, 2^{n.bit_length() - 1}) P {shards}"] = {
                "slabs": B * L * shards, "picked": picked(wide, log_s, B * L * shards)}
            for form in ("block", "cluster"):
                buf = (ctypes.c_int * 6)()
                if lib.ckks_coeff_tail_info(int(wide), log_s, int(form == "cluster"), 0, buf):
                    continue  # the slab has no such form
                cg.slab_form = lambda w, s, count, form=form: form
                times = {}
                for name, inverse, final in (("forward", False, None), ("inverse", True, fin)):
                    split, _ = device_split(
                        lambda: cg.coeff_tail(slabs, moduli, n, inverse, final), PROFILE_CALLS)
                    times[name] = sum(split.values())
                times["info"] = list(buf)
                row[form] = times
    finally:
        cg.slab_form = picked
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--composite", action="store_true")
    ap.add_argument("--paths", default=None,
                    help="comma-separated chip_smoke.py path names (e.g. wide,wide-62b)")
    ap.add_argument("--k10-forms", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = smoke._smi("name,power.limit")
    if args.k10_forms:
        print(json.dumps({"label": args.label or root, "card": card,
                          "k10_forms": k10_forms(smoke, dev)}))
        return 0
    sass = _sass_counts() if args.sass else None
    composite = composite_times(smoke, dev) if args.composite else None
    times, device = {}, {}
    paths = (("SMALL", False), ("WIDE", True), ("WIDE_62", True), ("BIG", False),
             ("BIG_WIDE", True), ("WIDE_16", True))
    chosen = [getattr(smoke, p) for p, _ in paths if hasattr(smoke, p)]
    if args.paths:
        names = args.paths.split(",")
        chosen = [cfg for cfg in chosen if cfg.name in names]
    cases = [(f"{cfg.name} {name}", case)
             for cfg, wide in ((cfg, cfg.bits > 31) for cfg in chosen)
             for name, case in smoke.kernel_cases(cfg, dev, wide=wide).items()]
    mxu = {}
    if hasattr(smoke, "mxu_cases") and (not args.paths or "mxu" in args.paths.split(",")):
        for shape, dims in K9_SHAPES.items():
            smoke.MXU_SHAPES.setdefault(shape, dims)
            cases += [(f"K9 {shape} {name}", case)
                      for name, case in smoke.mxu_cases(dev, shape)[0].items()]
            try:
                from toy_heaan_ckks_tpu_torch.ops.ntt_mxu_gpu import mxu_form
            except ImportError:
                continue
            mxu[shape] = mxu_form(*smoke.MXU_SHAPES[shape][:3], True)
    if hasattr(smoke, "coeff_cases"):
        for path, shards in (("big", 4), ("big-wide", 4), ("small", 8)):
            cfg = getattr(smoke, COEFF_PATHS[path])
            if args.paths and path not in args.paths.split(","):
                continue
            cases += [(f"K10/K11 {path} {name}", case) for name, case in smoke.coeff_cases(
                dev, cfg.batch, cfg.count, cfg.degree, cfg.bits, shards).items()]
    clock_mhz = float(smoke._smi("clocks.max.sm").split()[0])
    int_ops_per_s = (smoke.INT32_LANES_PER_SM * clock_mhz * 1e6
                     * torch.cuda.get_device_properties(dev).multi_processor_count)
    bound = {}
    for name, case in cases:
        times[name] = smoke._cuda_ms(case.kernel, args.iters, warmup=10)
        split, _ = device_split(case.kernel, PROFILE_CALLS)
        device[name] = sum(split.values())
        bound[name] = 1e3 * max(case.bytes / smoke.HBM_BYTES_PER_S, case.ops / int_ops_per_s,
                                2 * case.macs / smoke.INT8_OPS_PER_S)
    cluster = cluster_forms(smoke)
    print(json.dumps({"label": args.label or root, "card": card,
                      "ms": times, "device_ms": device, "bound_ms": bound,
                      **({"cluster": cluster} if cluster else {}),
                      **({"mxu": mxu} if mxu else {}),
                      **({"sass": sass} if sass else {}),
                      **({"composite": composite} if composite else {})}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
