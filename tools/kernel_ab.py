#!/usr/bin/env python3
"""Kernel times of one checkout of the port on the card, for an A/B in turns.

    python tools/kernel_ab.py --root PATH [--label NAME]

Imports ``chip_smoke.py`` and ``toy_heaan_ckks_tpu_torch`` from the
checkout at PATH (its kernels are built there at first use), makes the
kernel cases of each of its paths small, wide, big and big-wide that it
has (``chip_smoke.kernel_cases``: the same seeded inputs and shapes in
every checkout that has the path) and
prints one JSON line: the card's name and power limit and, per case, the
mean ms of 100 launches after 10 warm-up launches (CUDA events). Run it
once per checkout in one command on one card, in turns (parent, change,
change, parent), to compare two commits; no twin is timed. ``--sass``
adds, per kernel of the built library, its SASS instruction count and the
count of each memory instruction (``cuobjdump -sass``; LDS/STS are
shared-memory accesses, LD/ST generic ones).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


MEMORY_OPS = ("LDS", "STS", "LD", "ST", "LDG", "STG", "BAR")


def _sass_counts() -> dict:
    """{kernel: {"total": n, op: n for MEMORY_OPS}} of the checkout's
    library; kernels named ``<name><u32|u64>[cluster]``."""
    import subprocess

    from toy_heaan_ckks_tpu_torch.ops import _build

    _build.library()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(_build.library_path())],
                         capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            kind = next((k for k in ("ntt_kernel", "keyswitch_kernel", "moddown_kernel")
                         if k in mangled), mangled)
            word = "u64" if "Im" in mangled.split(kind)[-1][:3] else "u32"
            name = kind + word + ("[cluster]" if "Lb1" in mangled else "")
            counts[name] = dict.fromkeys(("total",) + MEMORY_OPS, 0)
        elif name and "/*" in line and ";" in line:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--sass", action="store_true")
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
    sass = _sass_counts() if args.sass else None
    times = {}
    paths = (("SMALL", False), ("WIDE", True), ("BIG", False), ("BIG_WIDE", True))
    for cfg, wide in ((getattr(smoke, p), wide) for p, wide in paths
                      if hasattr(smoke, p)):
        for name, case in smoke.kernel_cases(cfg, dev, wide=wide).items():
            times[f"{cfg.name} {name}"] = smoke._cuda_ms(case.kernel, args.iters,
                                                        warmup=10)
    print(json.dumps({"label": args.label or root, "card": smoke._smi("name,power.limit"),
                      "ms": times, **({"sass": sass} if sass else {})}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
