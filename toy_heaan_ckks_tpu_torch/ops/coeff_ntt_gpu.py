"""K10 and K11: the coefficient-sharded NTT's kernels, with their twins.

Counterpart of ``toy_heaan_ckks_tpu/parallel/coeff_ntt.py``'s
``_tail_kernel`` / ``_local_tail_pallas`` (K10) and
``_cross_stage_remote_kernel`` / ``_cross_stage_remote`` (K11). A plane
(..., L, N) is held as P contiguous slabs (..., L, S), S = N / P, slab p on
shard p of a coefficient mesh (``parallel/mesh.py``); a sharded value is the
tuple of the P slab tensors. With log2 P cross stages:

- ``coeff_tail`` (K10) runs the stages [log2 P, log2 N) of every slab, whose
  butterflies never leave a slab: forward in increasing, inverse in
  decreasing order;
- ``coeff_cross`` (K11) runs one stage st < log2 P, whose distance
  d = N >> (st + 1) >= S pairs slab p with slab p ^ (d / S);
- ``coeff_cross_stages`` (K11) runs every cross stage of a transform: in
  one launch where all P slabs lie on one card and P <=
  ``STAGES_MAX_SHARDS`` (a thread holds an offset's P words in registers:
  each word read and written once), else one ``coeff_cross`` launch a
  stage and card.

Both take the whole plane's compact twiddles at the slab's global offset,
so their words equal the unsharded transform's, and an optional
per-channel ``final`` factor (the inverse's N^{-1}, or folded constants)
applied after their butterflies. The kernels are ``csrc/coeff_ntt.cuh``
(``ckks_coeff_tail`` / ``ckks_coeff_cross`` / ``ckks_coeff_cross_stages``
in ``coeff_ntt.cu`` on uint32 words for int32 slabs, the ``64`` entries in
``coeff_ntt64.cu`` on uint64 words for int64 slabs); the twins are the
staged torch butterflies of ``ops/ntt.py`` restricted to one slab and the
slab exchange ``slabs[p ^ shift]``. CPU slabs go to the twin and CUDA slabs to the
kernel, with no fallback either way. K10 runs a slab as a plane whose
twiddles start at the slab's lead, in the form ``slab_form`` picks: one
block of register passes a slab, or a thread-block cluster of them
(``csrc/ntt_cluster.cuh``), or, below 2^10 words, the one-barrier-a-stage
template. One launch covers the shards on one device; each wrapper counts
its launches in ``launches`` (so ``coeff_cross.launches`` counts the
per-stage form and ``coeff_cross_stages.launches`` the one-launch form),
K10 its cluster launches also in ``launches_cluster`` (K11 launches no
cluster).
"""

from __future__ import annotations

import functools

import torch

from . import _build
from . import modular as mm
from .ntt import NttTables
from .ntt_gpu import SLICE_BYTES, final_consts, kernel_tables

MAX_SHARDS = 64  # the kernels' Slabs parameter holds this many pointers
# fewer slabs than this in one launch take K10's cluster form where the
# slab has one: one block a slab would leave over half of the H100's 132
# SMs idle (64 uint32 slabs of 2^14: one block each 0.0150 ms, C = 4
# 0.0125; 128 of 2^13: one block each 0.0091, C = 4 0.0120; device time,
# tools/kernel_ab.py --k10-forms)
SLAB_FILL = 66
# the most shards K11's one-launch form takes (csrc/coeff_ntt.cuh
# kStagesMaxShards: a thread holds P words in registers)
STAGES_MAX_SHARDS = 16


def slab_form(wide: bool, log_s: int, slabs: int) -> str:
    """K10's form for ``slabs`` slabs of 2^log_s words in one launch:
    ``"template"`` below 2^10 words (``tail_kernel``), ``"cluster"``, a
    thread-block cluster of blocks of register passes a slab
    (``tail_kernel_cluster``, C by ``kSlabLogCluster*`` of
    ``csrc/coeff_ntt.cuh``, from 2^12 words on: slices of 2^10 or more),
    for every uint64 slab of 2^13 or 2^14, which three register passes of
    16 words do not hold, and for a slab of either word that has one where
    the launch has fewer than ``SLAB_FILL`` slabs; else ``"block"``, one
    block of register passes a slab (``tail_kernel_reg``: uint32 slabs of
    2^10 .. 2^15, uint64 slabs of 2^10 .. 2^12)."""
    if log_s < 10:
        return "template"
    if log_s >= 12 and ((wide and log_s >= 13) or slabs < SLAB_FILL):
        return "cluster"
    return "block"


def slab_layout(shards: int, degree: int) -> tuple[int, int]:
    """(log2 N, log2 S) of ``shards`` slabs of a ring of ``degree``; raises
    unless both are powers of two with 1 <= P <= min(N / 2, MAX_SHARDS)."""
    log_n = degree.bit_length() - 1
    log_p = shards.bit_length() - 1
    if degree != 1 << log_n or shards != 1 << log_p:
        raise ValueError(f"{shards} shards of N = {degree}: both must be "
                         "powers of two")
    if shards > MAX_SHARDS or log_p >= log_n:
        raise ValueError(f"{shards} shards of N = {degree}: need 1 <= P <= "
                         f"min(N / 2, {MAX_SHARDS})")
    return log_n, log_n - log_p


def _check(name: str, slabs, moduli: tuple, degree: int) -> tuple:
    """Validate P slabs of one sharded value; returns (log_n, log_s, wide,
    planes). Each slab: int32 (small chain: every q < 2^31) or int64 (wide)
    (..., L, S), contiguous, all of one shape and dtype, all on the CPU or
    all on CUDA devices."""
    if not slabs:
        raise ValueError(f"{name}: no slabs")
    log_n, log_s = slab_layout(len(slabs), degree)
    first = slabs[0]
    if first.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: dtype {first.dtype}, expected int32 or int64")
    wide = first.dtype == torch.int64
    if not wide and mm.radix_bits_of(moduli) != 32:
        raise ValueError(f"{name}: int32 slabs need every q < 2^31")
    shape = first.shape
    if len(shape) < 2 or shape[-2:] != (len(moduli), 1 << log_s):
        raise ValueError(f"{name}: slab shape {tuple(shape)}, expected "
                         f"(..., {len(moduli)}, {1 << log_s})")
    cuda = first.device.type == "cuda"
    for t in slabs:
        if t.dtype != first.dtype or t.shape != shape:
            raise ValueError(f"{name}: slabs differ in dtype or shape")
        if (t.device.type == "cuda") != cuda or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: slabs on {first.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: slab not contiguous")
    planes = first.numel() >> log_s
    return log_n, log_s, wide, planes


def _final_col(final, moduli: tuple, device) -> torch.Tensor | None:
    if final is None:
        return None
    return mm.column(tuple(int(f) % q for f, q in zip(final, moduli)), device)


def coeff_tail_twin(slabs, moduli, degree: int, inverse: bool, final=None):
    """Plain torch version of K10 on slabs on any device: per slab p, the
    staged butterflies of ``ops/ntt.py`` on groups [p*S/(2d), (p+1)*S/(2d))
    of each stage."""
    moduli = tuple(int(m) for m in moduli)
    log_n, log_s = slab_layout(len(slabs), degree)
    cross = log_n - log_s
    s_len = 1 << log_s
    out = []
    for p, x in enumerate(slabs):
        ar = mm.arith(x.dtype)
        tabs = NttTables.build(moduli, degree, x.device)
        q = tabs.q[:, :, None]
        table = tabs.inv if inverse else tabs.fwd
        lead, L = x.shape[:-2], x.shape[-2]
        a = x.long()
        stages = range(log_n - 1, cross - 1, -1) if inverse else range(cross, log_n)
        for st in stages:
            d = degree >> (st + 1)
            groups = s_len // (2 * d)
            k0 = (1 << st) + p * groups
            w = table[:, k0 : k0 + groups, None]  # (L, groups, 1)
            a4 = a.reshape(*lead, L, groups, 2, d)
            u, v = a4[..., 0, :], a4[..., 1, :]
            if inverse:
                pair = [ar.add(u, v, q), ar.mul(ar.sub(u, v, q), w, q)]
            else:
                wv = ar.mul(v, w, q)
                pair = [ar.add(u, wv, q), ar.sub(u, wv, q)]
            a = torch.stack(pair, dim=-2).reshape(*lead, L, s_len)
        fin = _final_col(final, moduli, x.device)
        if fin is not None:
            a = ar.mul(a, fin, tabs.q)
        out.append(a.to(x.dtype))
    return tuple(out)


def coeff_cross_twin(slabs, moduli, degree: int, stage: int, inverse: bool,
                     final=None):
    """Plain torch version of K11 on slabs on any device: slab p and its
    partner slabs[p ^ shift] through one butterfly stage."""
    moduli = tuple(int(m) for m in moduli)
    log_n, log_s = slab_layout(len(slabs), degree)
    log_d = log_n - 1 - stage
    if not 0 <= stage < log_n - log_s:
        raise ValueError(f"coeff_cross: stage {stage} is not a cross stage")
    shift = 1 << (log_d - log_s)
    out = []
    for p, x in enumerate(slabs):
        ar = mm.arith(x.dtype)
        tabs = NttTables.build(moduli, degree, x.device)
        table = tabs.inv if inverse else tabs.fwd
        g = (p << log_s) >> (log_d + 1)
        w = table[:, (1 << stage) + g, None]  # (L, 1)
        q = tabs.q
        a, b = x.long(), slabs[p ^ shift].to(x.device).long()
        if inverse:
            r = ar.add(a, b, q) if not p & shift else ar.mul(ar.sub(b, a, q), w, q)
        else:
            r = (ar.add(a, ar.mul(b, w, q), q) if not p & shift
                 else ar.sub(b, ar.mul(a, w, q), q))
        fin = _final_col(final, moduli, x.device)
        if fin is not None:
            r = ar.mul(r, fin, q)
        out.append(r.to(x.dtype))
    return tuple(out)


def coeff_cross_stages_twin(slabs, moduli, degree: int, inverse: bool,
                            final=None) -> tuple:
    """Plain torch version of K11's one-launch form: ``coeff_cross_twin``
    over every cross stage, forward 0 .. log2 P - 1, inverse in reverse,
    with ``final`` on the last stage's words."""
    stages = _cross_order("coeff_cross_stages", len(slabs), degree, inverse)
    for st in stages:
        slabs = coeff_cross_twin(slabs, moduli, degree, st, inverse,
                                 final if st == stages[-1] else None)
    return tuple(slabs)


def _cross_order(name: str, shards: int, degree: int, inverse: bool) -> range:
    """The cross stages of a transform in the order they run; raises at
    P = 1, which has none."""
    log_n, log_s = slab_layout(shards, degree)
    if log_n == log_s:
        raise ValueError(f"{name}: one shard has no cross stage")
    cross = log_n - log_s
    return range(cross - 1, -1, -1) if inverse else range(cross)


def _groups(slabs) -> dict:
    """Shard indices by device, in shard order."""
    groups: dict = {}
    for p, t in enumerate(slabs):
        groups.setdefault(t.device, []).append(p)
    return groups


@functools.lru_cache(maxsize=None)
def _enable_peer(device: int, peer: int) -> None:
    _build.check(_build.library().ckks_enable_peer_access(device, peer),
                 "enable peer access")


def _check_final(name: str, final, moduli: tuple) -> None:
    if final is not None and len(final) != len(moduli):
        raise ValueError(f"{name}: {len(final)} final factors for "
                         f"{len(moduli)} channels")


def _tables(moduli: tuple, degree: int, dev, wide: bool, inverse: bool, final) -> tuple:
    """(tw, twp, q, fin, finp) of a launch on ``dev``: the direction's
    compact twiddles, the moduli and the final factors (None without
    them)."""
    rbits = 64 if wide else 32
    kt = kernel_tables(moduli, degree, dev, rbits)
    tw, twp = (kt.inv, kt.inv_shoup) if inverse else (kt.fwd, kt.fwd_shoup)
    fin = finp = None
    if final is not None:
        fin, finp = final_consts(moduli, tuple(int(f) for f in final), dev, rbits)
    return tw, twp, kt.q, fin, finp


def _launch(wrapper, slabs, moduli, degree: int, inverse: bool, final,
            stage: int | None) -> tuple:
    """Shared body of K10's and K11's per-stage wrappers: validate, then
    the twin (CPU) or one kernel launch per device (CUDA), each counted on
    ``wrapper``."""
    name = wrapper.__name__
    slabs, moduli = tuple(slabs), tuple(int(m) for m in moduli)
    log_n, log_s, wide, planes = _check(name, slabs, moduli, degree)
    _check_final(name, final, moduli)
    if slabs[0].device.type == "cpu":
        if stage is None:
            return coeff_tail_twin(slabs, moduli, degree, inverse, final)
        return coeff_cross_twin(slabs, moduli, degree, stage, inverse, final)
    if stage is None and (8 if wide else 4) << log_s > SLICE_BYTES:
        raise ValueError(f"{name}: a slab of 2^{log_s} words exceeds "
                         f"{SLICE_BYTES} bytes of shared memory")
    if stage is not None and not 0 <= stage < log_n - log_s:
        raise ValueError(f"{name}: stage {stage} is not a cross stage")
    out = tuple(torch.empty_like(t) for t in slabs)
    if not planes:
        return out
    if stage is None and inverse:
        # the register forms' inverse reads each slab as 16-byte vectors
        slabs = tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in slabs)
    groups = _groups(slabs)
    if stage is not None and len(groups) > 1:
        # A partner slab on another card is read through its peer pointer.
        # The stages are ordered by synchronising every card around the
        # launches; an event per stage on each card's stream would order
        # them without stopping the host, and is not built untried.
        for a in groups:
            for b in groups:
                if a != b:
                    _enable_peer(a.index, b.index)
        for dev in groups:
            torch.cuda.synchronize(dev)
    entry = getattr(_build.library(), f"ckks_{name}{'64' if wide else ''}")
    ins, outs = _build.ptr_array(slabs), _build.ptr_array(out)
    channels = len(moduli)
    for dev, ids in groups.items():
        tabs = _tables(moduli, degree, dev, wide, inverse, final)
        args = [ins, outs, _build.int_array(ids), len(ids), len(slabs),
                *map(_build.ptr, tabs), planes, channels, log_n, log_s]
        cluster = stage is None and slab_form(wide, log_s, planes * len(ids)) == "cluster"
        args.append(stage if stage is not None else int(cluster))
        with torch.cuda.device(dev):
            rc = entry(*args, int(inverse), _build.stream(dev))
        _build.check(rc, name)
        wrapper.launches += 1
        wrapper.launches_cluster += cluster
    if stage is not None and len(groups) > 1:
        for dev in groups:
            torch.cuda.synchronize(dev)
    return out


def coeff_tail(slabs, moduli, degree: int, inverse: bool, final=None) -> tuple:
    """K10: the local stages [log2 P, log2 N) of P slabs (..., L, S) of a
    ring of ``degree`` over ``moduli`` (int32 slabs: a small chain; int64: a
    wide one), forward or inverse, then the optional per-channel plain
    ``final`` factors. Returns new slabs, each on its input's device. A slab
    must fit one block's shared memory (``ntt_gpu.SLICE_BYTES``: uint32
    S <= 2^15, uint64 S <= 2^14). At P = 1 this is the whole NTT. On CUDA
    slabs each device's launch runs the form ``slab_form`` picks for its
    slabs (a cluster launch also counts in ``launches_cluster``); an
    unaligned slab of the inverse is copied first."""
    return _launch(coeff_tail, slabs, moduli, degree, inverse, final, None)


def coeff_cross(slabs, moduli, degree: int, stage: int, inverse: bool,
                final=None) -> tuple:
    """K11: the cross stage ``stage`` (< log2 P) of P slabs, forward
    (Cooley-Tukey) or inverse (Gentleman-Sande), then the optional
    ``final`` factors. Returns new slabs (the kernel never writes in
    place: each shard reads its partner's input)."""
    return _launch(coeff_cross, slabs, moduli, degree, inverse, final, stage)


def coeff_cross_stages(slabs, moduli, degree: int, inverse: bool,
                       final=None) -> tuple:
    """K11 over every cross stage of a transform of P >= 2 slabs: forward
    stages 0 .. log2 P - 1, or inverse stages log2 P - 1 .. 0, then the
    optional ``final`` factors. Returns new slabs. On CUDA slabs that all
    lie on one card with P <= ``STAGES_MAX_SHARDS``: one launch of the
    one-launch form, counted in ``coeff_cross_stages.launches``; otherwise
    one ``coeff_cross`` launch a stage and card (counted there)."""
    name = "coeff_cross_stages"
    slabs, moduli = tuple(slabs), tuple(int(m) for m in moduli)
    log_n, log_s, wide, planes = _check(name, slabs, moduli, degree)
    stages = _cross_order(name, len(slabs), degree, inverse)
    _check_final(name, final, moduli)
    if slabs[0].device.type == "cpu":
        return coeff_cross_stages_twin(slabs, moduli, degree, inverse, final)
    groups = _groups(slabs)
    if len(groups) > 1 or len(slabs) > STAGES_MAX_SHARDS:
        for st in stages:
            slabs = coeff_cross(slabs, moduli, degree, st, inverse,
                                final if st == stages[-1] else None)
        return slabs
    out = tuple(torch.empty_like(t) for t in slabs)
    if not planes:
        return out
    dev = slabs[0].device
    entry = getattr(_build.library(), f"ckks_{name}{'64' if wide else ''}")
    tabs = _tables(moduli, degree, dev, wide, inverse, final)
    with torch.cuda.device(dev):
        rc = entry(_build.ptr_array(slabs), _build.ptr_array(out), len(slabs),
                   *map(_build.ptr, tabs), planes, len(moduli), log_n, log_s,
                   int(inverse), _build.stream(dev))
    _build.check(rc, name)
    coeff_cross_stages.launches += 1
    return out


coeff_tail.launches = coeff_tail.launches_cluster = 0
coeff_cross.launches = coeff_cross.launches_cluster = 0
coeff_cross_stages.launches = coeff_cross_stages.launches_cluster = 0
