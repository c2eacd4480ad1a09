"""The coefficient-sharded negacyclic NTT (ring degree N over P shards).

Counterpart of ``toy_heaan_ckks_tpu/parallel/coeff_ntt.py``
(``build_coeff_sharded_ntt``, ``build_coeff_sharded_ntt_wide``). With P
shards of S = N / P contiguous coefficients, the in-place distance-d
butterfly stages split cleanly: the first log2 P stages (d >= S) pair slab p
with slab p ^ (d / S) at the same offset, and the rest (d < S) stay inside
a slab. The forward runs the cross stages first
(``coeff_ntt_gpu.coeff_cross_stages``: one K11 launch where every shard
lies on one card, else one a stage and card), then every local stage in
one K10 launch (``coeff_ntt_gpu.coeff_tail``); the inverse runs K10 first,
then the cross stages in reverse, and folds N^{-1} (or the caller's
per-channel factors) into its last launch. The words equal the unsharded transform's
(``ntt_gpu.ntt_planes`` / ``ntt_planes_wide``).

The reference's ``use_pallas``, ``interpret`` and ``remote_dma`` switches
have no counterpart: on the card K10 and K11 always run, on the CPU their
twins. Small chains (every q < 2^31) take int32 slabs, wide chains (any
q < 2^63) int64 slabs, through the same kernels on uint32 / uint64 words.
"""

from __future__ import annotations

import torch

from ..ops import _build as build
from ..ops import modular as mm
from ..ops.coeff_ntt_gpu import coeff_cross_stages, coeff_tail, slab_layout
from .mesh import CoeffMesh


def coeff_ntt(slabs, moduli, degree: int, inverse: bool, final=None) -> tuple:
    """NTT of a sharded value: P slabs (..., L, S) of planes over ``moduli``.
    Forward: natural order in, tree order out; inverse: the reverse, times
    ``final`` (per-channel plain factors, default N^{-1} mod q). Returns the
    P output slabs."""
    moduli = tuple(int(m) for m in moduli)
    log_n, log_s = slab_layout(len(slabs), degree)
    cross = log_n - log_s
    if not inverse:
        if final is not None:
            raise ValueError("coeff_ntt: a final factor needs inverse=True")
        if cross:
            slabs = coeff_cross_stages(slabs, moduli, degree, False)
        return coeff_tail(slabs, moduli, degree, False)
    if final is None:
        final = tuple(pow(degree, -1, q) for q in moduli)
    slabs = coeff_tail(slabs, moduli, degree, True, final if cross == 0 else None)
    return coeff_cross_stages(slabs, moduli, degree, True, final) if cross else slabs


def _build(mesh: CoeffMesh, moduli, degree: int, inverse: bool, wide: bool):
    moduli = tuple(int(m) for m in moduli)
    slab_layout(mesh.shards, degree)
    if not wide and mm.radix_bits_of(moduli) != 32:
        raise ValueError("build_coeff_sharded_ntt: a small chain needs every "
                         "q < 2^31 (build_coeff_sharded_ntt_wide takes any q < 2^63)")
    dtype = torch.int64 if wide else torch.int32

    def fn(slabs) -> tuple:
        slabs = mesh.check(slabs)
        build.require_dtype("coeff-sharded NTT", dtype, *slabs)
        return coeff_ntt(slabs, moduli, degree, inverse)

    return fn


def build_coeff_sharded_ntt(mesh: CoeffMesh, moduli, degree: int, inverse: bool):
    """fn(slabs) -> slabs: the NTT of int32 planes (..., L, N) of a small
    chain held as ``mesh.shards`` slabs (``mesh.shard_planes``), forward
    or inverse (with N^{-1}); bit-exact with the unsharded ``ntt_planes``."""
    return _build(mesh, moduli, degree, inverse, wide=False)


def build_coeff_sharded_ntt_wide(mesh: CoeffMesh, moduli, degree: int,
                                 inverse: bool):
    """``build_coeff_sharded_ntt`` for int64 slabs of a wide chain (any
    q < 2^63; R = 2^64 Shoup companions); bit-exact with
    ``ntt_planes_wide``."""
    return _build(mesh, moduli, degree, inverse, wide=True)
