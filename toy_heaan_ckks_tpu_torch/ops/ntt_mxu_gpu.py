"""K9: the matrix-product NTT as a CUDA tensor-core kernel, with its twin.

Counterpart of ``toy_heaan_ckks_tpu/ops/ntt_mxu.py`` (``_mxu_kernel``,
``ntt_mxu_pallas``). The kernel is ``csrc/ntt_mxu.cu`` (``ckks_ntt_mxu``,
u8 x u8 -> s32 ``mma.sync``): for R = N / 128 <= 128 a block of 16 warps
owns one channel and a run of its planes, with both matrices' limbs in
shared memory once a block (``ntt_mxu_run_kernel``); at R = 256 one block
per (channel, item) plane (``ntt_mxu_kernel``); ``mxu_form`` reports which
and its launch shape. The twin is ``ntt_mxu.ntt_mxu``. ``ntt_mxu_planes``
sends a CPU tensor to the twin and launches the kernel for a CUDA tensor,
with no fallback from one to the other, and raises outside
``supported_mxu``.
"""

from __future__ import annotations

import torch

from . import _build
from .ntt_gpu import count_launch
from .ntt_mxu import mxu_tables, ntt_mxu, supported_mxu


def ntt_mxu_planes(x: torch.Tensor, moduli, degree: int, inverse: bool,
                   post: tuple | None = None) -> torch.Tensor:
    """K9: NTT of int32 (..., L, N) planes (the reference's uint32 bits) of
    a small chain over ``moduli``, N in [2^10, 2^15].

    Forward, or inverse with N^{-1} (Montgomery in, Montgomery out), or with
    ``post`` the plain ``mont_mul(iNTT(x), post)`` of
    ``small_fast.inv_ntt_fold``. Output canonical, contiguous, equal to
    K1's words. ``launches`` counts the kernel's launches;
    ``launches_cluster`` stays 0 (no kernel of K9 runs on a cluster)."""
    moduli = tuple(int(m) for m in moduli)
    if not supported_mxu(degree, moduli):
        raise ValueError(
            f"ntt_mxu_planes: N = {degree} over {len(moduli)} moduli is "
            "outside the matrix-product NTT's envelope (small chain, N in "
            "[2^10, 2^15])")
    if post is not None:
        if not inverse:
            raise ValueError("ntt_mxu_planes: post needs inverse=True")
        post = tuple(int(p) for p in post)
    if x.device.type == "cpu":
        _build.require_dtype("ntt_mxu_planes", torch.int32, x)
        return ntt_mxu(x, moduli, degree, inverse, post)
    L = len(moduli)
    x3 = _build.planes(x, L, degree)
    _build.require_cuda("ntt_mxu_planes", torch.int32, x3)
    out = torch.empty((x3.shape[0], L, degree), dtype=torch.int32,
                      device=x.device)
    if not out.numel():
        return out.reshape(x.shape)
    lib = _build.library()
    tabs = mxu_tables(moduli, degree, inverse, post, x.device)
    p = _build.ptr
    rc = lib.ckks_ntt_mxu(
        p(x3), x3.stride(0), p(out), p(tabs.w_first), p(tabs.w_second),
        p(tabs.t), p(tabs.t_shoup), p(tabs.rs), p(tabs.q), p(tabs.qinv),
        x3.shape[0], L, tabs.rows, int(inverse),
        _build.stream(x.device),
    )
    _build.check(rc, "ntt_mxu_planes")
    count_launch(ntt_mxu_planes, 1)
    return out.reshape(x.shape)


ntt_mxu_planes.launches = ntt_mxu_planes.launches_cluster = 0

MXU_INFO = ("run_kernel", "planes_a_block", "blocks", "regs_per_thread",
            "local_bytes_per_thread", "threads_per_block", "smem_bytes_per_block",
            "blocks_per_sm")


def mxu_form(outer: int, channels: int, degree: int, inverse: bool) -> dict:
    """The kernel ``ntt_mxu_planes`` launches on the current card for
    ``outer`` items of ``channels`` planes of N = ``degree``, as built
    (``ckks_ntt_mxu_info``): whether it is the channel-run kernel, its
    planes a block and blocks, and its registers, spill, threads, shared
    bytes and resident blocks an SM."""
    import ctypes

    from .ntt_mxu import layout

    buf = (ctypes.c_int * len(MXU_INFO))()
    _build.check(_build.library().ckks_ntt_mxu_info(
        outer, channels, layout(degree)[0], int(inverse), buf), "ckks_ntt_mxu_info")
    return dict(zip(MXU_INFO, buf))
