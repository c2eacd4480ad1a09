"""The cluster register-pass plan of K4, K3 / K3' and K2 at N = 2^16, of
K5 / K5' / K7, K6 and K8 / K8' at N = 2^13 .. 2^16, and K10's forms on a
coefficient slab with its lead, in numpy.

``csrc/ntt_cluster.cuh`` spreads one plane of N words over a thread-block
cluster of C blocks (rank r holds the slice [r*M, (r+1)*M), M = N/C,
N/W/C threads of W words): uint32 planes with W = 32, uint64 planes with
the W and C that the header builds (``kLogWideWords``,
``kWideLogCluster13`` .. ``16`` for K6 and at 2^15 / 2^16 for every
form, ``kWideNttLogCluster13`` / ``14`` for K5 / K7 and K8 / K8', read
from it here). This file emulates
that plan index for index, with the kernels' own maps and, on uint64
words, their Harvey64 and REDC64 arithmetic (Shoup companions), and holds
it word for word to the port's twins (``ops/ntt.py``,
``moddown_gpu.mod_down_combine_twin``,
``keyswitch_gpu.gadget_accumulate_twin``): uint32 at N = 2^16 for C in
{4, 8, 16}, uint64 at 2^13 .. 2^16 for each form's C built; and at N = 2^12,
C = 4 to the JAX reference's staged NTT (``toy_heaan_ckks_tpu/ops/ntt.py``)
and, on uint32 words, its key switch (``ops/keyswitch_pallas.py``, in
interpret mode) on the CPU:

- forward cross pass: thread t of rank r holds groups h < W/C, group h
  the C words j + k*M (j = r*M/C + h*T + t), and runs stages 0 .. log2 C
  - 1 on them with twiddles tw[2^l + g] (``cross_groups``);
- the scatter: word k of group j to rank k's shared memory at pad(j),
  a permutation of the slots (``scatter_forward``); the pad is one word
  after every 128 bytes, which keeps the uint64 plan's shared-memory
  accesses free of bank conflicts (``_wavefronts``);
- the local passes: ``RegPass`` of a 2^(log2 N - log2 C) plane, the
  twiddle of local stage s' = kS + kL and group g at (C + r) * 2^s' +
  blk * 2^kL + g (``local_forward``), then pass 0's layout for a
  coalesced store;
- the inverse in reverse: the last local pass loaded as runs of adjacent
  words, the Gentleman-Sande passes down to pass 0, each word sent to its
  cross-pass owner at k * M/C + (j mod M/C) (``scatter_inverse``), the
  cross pass from stage log2 C - 1 down, and the final constant;
- K3 / K8: the Phat sum in the cross pass's loads, the combine in pass
  0's layout (without the t term for K3' / K8'), and a Phat weight of the
  wrong kept channel caught;
- K2 / K6: the grid's plane map (the special channels' planes first with
  d, every cluster on one plane), each digit's raise in the cross pass's
  loads, one forward plan per digit but the own one, the key products,
  the own-digit term and the digit sum in pass 0's layout; and a model of
  the cluster-barrier phases across the digits (``check_schedule``).
- K10: slab p of P as a plane of S = N/P words with lead P + p (the
  cross pass's entries (lead << l) + g, the slices' lead * C + r), on
  one block (log2 C = 0) or a cluster, word-equal to
  ``coeff_ntt_gpu.coeff_tail_twin``; the form ``slab_form`` picks, its
  bank conflicts, and a dropped lead caught.

The emulator lives here, not in the port; the card holds the CUDA kernels
to the same twins (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools
import re
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from toy_heaan_ckks_tpu import CkksContext as RefContext
from toy_heaan_ckks_tpu.ops import keyswitch_pallas as ref_ks
from toy_heaan_ckks_tpu.ops import ntt as ref_ntt

from toy_heaan_ckks_tpu_torch import CkksContext, convert, generate_primes
from toy_heaan_ckks_tpu_torch.keys import default_special_primes
from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu, moddown_gpu, ntt_gpu
from toy_heaan_ckks_tpu_torch.ops.modular import shoup
from toy_heaan_ckks_tpu_torch.ops.ntt import compact_twiddles
from toy_heaan_ckks_tpu_torch.ops.small_fast import _fold_consts


class Words:
    """The kernels' word (``csrc/ntt_reg.cuh`` ``RegWords``): its bits, the
    2^log_w words a thread holds, and one pad word after every 128 bytes."""

    def __init__(self, bits: int, log_w: int):
        self.bits, self.log_w = bits, log_w
        self.W = 1 << log_w
        self.bytes = bits // 8
        self.log_pad = 5 if bits == 32 else 4

    def pad(self, p):
        """Shared-memory word of slice position p."""
        return p + (p >> self.log_pad)


W32 = Words(32, 5)  # the uint32 forms: 32 words a thread


def _header_constant(name: str, header: str = "ntt_cluster.cuh") -> int | None:
    """An int constant of a header in ``csrc/`` (the plan as built), or
    None where the header has no such constant."""
    text = (Path(ntt_gpu.__file__).parent.parent / "csrc" / header).read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    return None if found is None else int(found.group(1))


# the uint64 cluster forms (ntt_cluster.cuh WideWords, WidePlan): words a
# thread and log2 C at N = 2^13 .. 2^16 of K6 ("ks") and of K5 / K7 and
# K8 / K8' ("ntt"; the same C at 2^15 and 2^16)
W64 = Words(64, _header_constant("kLogWideWords"))
WIDE_LOG_C = {n: _header_constant(f"kWideLogCluster{n}") for n in (13, 14, 15, 16)}
WIDE_FORM_LOG_C = {
    "ks": WIDE_LOG_C,
    "ntt": {**WIDE_LOG_C, **{n: _header_constant(f"kWideNttLogCluster{n}") for n in (13, 14)}},
}


class Plan:
    """The index maps of one plane of 2^log_n words on C = 2^log_c blocks
    (log_c = 0: one block, whose "cross pass" runs no stage and whose
    scatter places pass 0's words at their own slots). ``lead``: 1 on a
    whole plane; P + p on slab p of P (K10), the plane's stages log2 P and
    up, its groups p * 2^s' + g' (``RegPass::run``)."""

    def __init__(self, log_n: int, log_c: int, words: Words = W32, lead: int = 1):
        self.log_n, self.log_c, self.words, self.lead = log_n, log_c, words, lead
        self.log_p = lead.bit_length() - 1  # a slab of P = 2^log_p
        self.p = lead - (1 << self.log_p)
        self.pad = words.pad
        log_w, self.W = words.log_w, words.W
        self.C = 1 << log_c
        self.log_m = log_n - log_c
        self.M = 1 << self.log_m
        self.T = self.M >> log_w  # threads a block
        self.GX = self.W >> log_c  # cross-pass groups a thread
        self.MC = self.M >> log_c  # cross-pass groups a rank (T * GX)
        rest = self.log_m - log_w
        r1 = rest if rest <= log_w else (rest + 1) // 2
        # (kS, kR) of the local passes: RegPlan<log_m, words>
        self.passes = [(0, log_w), (log_w, r1)]
        if rest > r1:
            self.passes.append((log_w + r1, rest - r1))
        # rank, thread grids broadcast against (planes, C, T)
        self.r = np.arange(self.C)[:, None]
        self.t = np.arange(self.T)[None, :]

    # ── the cross pass ──────────────────────────────────────────────────
    def cross_j(self, h: int):
        """Group index j of (rank, thread, group h): (C, T)."""
        return self.r * self.MC + h * self.T + self.t

    def cross_positions(self):
        """Plane position of word (rank, thread, h * C + k): (C, T, W)."""
        out = np.empty((self.C, self.T, self.W), np.int64)
        for h in range(self.GX):
            for k in range(self.C):
                out[:, :, h * self.C + k] = self.cross_j(h) + k * self.M
        return out

    def cross_twiddle(self, l: int, g: int) -> int:
        """Table entry of cross stage l, group g (the same for every thread)."""
        return (self.lead << l) + g

    # ── the local passes: RegPass<log_m, kS, kR> ────────────────────────
    def gid(self, h: int, kR: int):
        return self.t + (h << (self.log_m - self.words.log_w))

    def slots(self, kS: int, kR: int):
        """Shared-memory word of (thread, h * 2^kR + m): RegPass::base +
        pad(m << kLogOff), (T, W)."""
        log_off = self.log_m - kS - kR
        out = np.empty((self.T, self.W), np.int64)
        for h in range(self.W >> kR):
            g = self.gid(h, kR)[0]
            base = self.pad(((g >> log_off) << (self.log_m - kS)) + (g & ((1 << log_off) - 1)))
            for m in range(1 << kR):
                out[:, (h << kR) + m] = base + self.pad(m << log_off)
        return out

    def local_twiddle(self, kS: int, kR: int, kL: int, h: int, g: int):
        """Table entry of local stage kS + kL, group g of group h: (C, T)."""
        log_off = self.log_m - kS - kR
        blk = self.gid(h, kR) >> log_off
        return ((self.lead * self.C + self.r) << (kS + kL)) + (blk << kL) + g


_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def _mulhi64(a, b):
    """The high word of the 128-bit product of uint64 arrays (``__umul64hi``)."""
    a0, a1, b0, b1 = a & _M32, a >> _S32, b & _M32, b >> _S32
    lo, m1, m2 = a0 * b0, a1 * b0, a0 * b1
    carry = ((lo >> _S32) + (m1 & _M32) + (m2 & _M32)) >> _S32
    return a1 * b1 + (m1 >> _S32) + (m2 >> _S32) + carry


def _harvey64(x, w, wp, q):
    """x * w mod q as ``ntt.cuh`` ``harvey`` on uint64 words (wp the Shoup
    companion floor(w * 2^64 / q)), on int64 arrays of values below 2^63."""
    x, w, wp, q = (np.asarray(v).astype(np.uint64) for v in (x, w, wp, q))
    r = x * w - _mulhi64(x, wp) * q
    return np.where(r >= q, r - q, r).astype(np.int64)


def _redc64(a, b, q, qinv):
    """a * b * 2^-64 mod q as ``ntt.cuh`` ``mont_redc`` on uint64 words
    (qinv = -q^-1 mod 2^64)."""
    a, b, q, qinv = (np.asarray(v).astype(np.uint64) for v in (a, b, q, qinv))
    t_lo = a * b
    r = _mulhi64(a, b) + _mulhi64(t_lo * qinv, q) + (t_lo != 0).astype(np.uint64)
    return np.where(r >= q, r - q, r).astype(np.int64)


def _mul(x, w, wp, q):
    """x * w mod q: exact in int64 for the uint32 forms' primes (wp None),
    the kernels' Harvey64 for the uint64 forms'."""
    return x * w % q if wp is None else _harvey64(x, w, wp, q)


def _stages(a, tabs, q, kR: int, twiddle, inverse: bool):
    """Butterflies of one register pass on a (planes, C, T, W): RegPass
    / RegPassInv's loops (the kernels' loop over i < half taken at once: the
    butterflies (u + i, u + half + i) of one twiddle), twiddle(kL, h, g)
    the table entry of tabs = (tw, twp), twp the Shoup companions of the
    uint64 forms (None for uint32)."""
    order = range(kR - 1, -1, -1) if inverse else range(kR)
    q = q.reshape(-1, 1, 1, 1)
    tw, twp = tabs
    gather = lambda t, idx: None if t is None else np.take_along_axis(
        t, idx, axis=-1).reshape(a.shape[:-1] + (1,))
    for h in range(a.shape[-1] >> kR):
        for kL in order:
            half = 1 << (kR - 1 - kL)
            for g in range(1 << kL):
                idx = _flat(twiddle(kL, h, g), a)
                w, wp = gather(tw, idx), gather(twp, idx)
                u = (h << kR) + 2 * half * g
                xu, xv = a[..., u:u + half].copy(), a[..., u + half:u + 2 * half].copy()
                if inverse:
                    a[..., u:u + half] = _add(xu, xv, q)
                    a[..., u + half:u + 2 * half] = _mul(_sub(xu, xv, q), w, wp, q)
                else:
                    xv = _mul(xv, w, wp, q)
                    a[..., u:u + half] = _add(xu, xv, q)
                    a[..., u + half:u + 2 * half] = _sub(xu, xv, q)


def _add(x, y, q):
    """(x + y) mod q for x, y in [0, q): one conditional subtract."""
    return _sub(x, q - y, q)


def _sub(x, y, q):
    """(x - y) mod q for x, y in [0, q]: q added where the difference is
    negative (its sign bit)."""
    r = x - y
    r += (r >> 63) & q
    return r


def _flat(index, a):
    """A twiddle index (scalar or (C, T)) as (planes, C*T) gather indices."""
    idx = np.broadcast_to(np.asarray(index), a.shape[1:3]).reshape(1, -1)
    return np.broadcast_to(idx, (a.shape[0], idx.shape[1]))


def scatter_forward(plan: Plan, pad=None):
    """(rank, slot) each cross-pass word (rank r, thread t, h * C + k) is
    written to: rank k's shared memory at pad(j) (the plan's pad unless
    one is given)."""
    pad = pad or plan.pad
    dst_rank = np.empty((plan.C, plan.T, plan.W), np.int64)
    dst_slot = np.empty_like(dst_rank)
    for h in range(plan.GX):
        for k in range(plan.C):
            dst_rank[:, :, h * plan.C + k] = k
            dst_slot[:, :, h * plan.C + k] = pad(plan.cross_j(h))
    return dst_rank, dst_slot


def scatter_inverse(plan: Plan):
    """(owner, slot) each word of the last inverse local pass (rank r,
    thread t, word m at slice position p = m * T + t) is written to: the
    rank that holds group p in the cross pass, at r * M/C + (p mod M/C)."""
    shape = (plan.C, plan.T, plan.W)
    p = np.arange(plan.W)[None, None, :] * plan.T + plan.t[:, :, None]
    owner = np.broadcast_to(p >> (plan.log_m - plan.log_c), shape)
    slot = plan.r[:, :, None] * plan.MC + (p & (plan.MC - 1))
    return owner, np.broadcast_to(slot, shape)


def _exchange(a, dst_rank, dst_slot, size: int):
    """Write a (planes, C, T, W) to per-rank buffers (planes, C, size),
    each slot written at most once."""
    buf = np.full((a.shape[0], a.shape[1], size), -1, np.int64)
    flat = (dst_rank * size + dst_slot).reshape(-1)
    assert len(np.unique(flat)) == flat.size, "two words to one slot"
    buf.reshape(a.shape[0], -1)[:, flat] = a.reshape(a.shape[0], -1)
    return buf


def _take(s, slot):
    """Words of the slices s (planes, C, slots) at slot (T, W)."""
    return np.take_along_axis(s, np.broadcast_to(slot.reshape(1, 1, -1), s.shape[:2] + (slot.size,)),
                              axis=-1).reshape(s.shape[:2] + slot.shape)


def _put(s, slot, a):
    np.put_along_axis(s, np.broadcast_to(slot.reshape(1, 1, -1), s.shape[:2] + (slot.size,)),
                      a.reshape(s.shape[:2] + (-1,)), axis=-1)


def _local_forward(plan: Plan, s, tabs, q):
    """The forward local passes from the scattered slices s (planes, C,
    pad(M)); returns a[] in pass 0's layout (word m at m * T + t)."""
    a = None
    for kS, kR in plan.passes:
        slot = plan.slots(kS, kR)
        a = _take(s, slot)
        assert (a >= 0).all(), "a slot read before it was written"
        _stages(a, tabs, q, kR, lambda kL, h, g, kS=kS, kR=kR:
                plan.local_twiddle(kS, kR, kL, h, g), inverse=False)
        s = s.copy()
        _put(s, slot, a)
    # the last pass's runs back to pass 0's layout
    return _take(s, plan.slots(*plan.passes[0]))


def _p0_positions(plan: Plan):
    """Plane position of pass 0's word (rank, thread, m): r*M + m*T + t."""
    return (plan.r[:, :, None] * plan.M + np.arange(plan.W)[None, None, :] * plan.T
            + plan.t[:, :, None])


def _unflatten(a, pos, n: int):
    """Per-plane words a (planes, C, T, W) at plane positions pos ->
    (planes, n), each position written once."""
    out = np.full((a.shape[0], n), -1, np.int64)
    flat = pos.reshape(-1)
    assert np.array_equal(np.sort(flat), np.arange(n)), "positions not a permutation"
    out[:, flat] = a.reshape(a.shape[0], -1)
    return out


def emulate_forward(plan: Plan, x, tabs, q, prologue=None):
    """Forward NTT of x (planes, N) with twiddle rows tabs = (tw, twp)
    (planes, N) and moduli q (planes, 1, 1, 1). ``prologue(pos)``: the
    cross pass's loads (default x at pos). Returns (planes, C, T, W) in
    pass 0's layout."""
    pos = plan.cross_positions()
    a = x[:, pos] if prologue is None else prologue(pos)
    _stages(a, tabs, q, plan.log_c, lambda kL, h, g: plan.cross_twiddle(kL, g),
            inverse=False)
    s = _exchange(a, *scatter_forward(plan), plan.pad(plan.M))
    return _local_forward(plan, s, tabs, q)


def emulate_inverse(plan: Plan, x, tabs, q, fin):
    """Inverse NTT of x (planes, N), final per-plane constant fin = (f,
    fp) (planes, 1, 1, 1), fp its Shoup companion (None for uint32), or
    no final factor (fin None); returns (planes, N)."""
    kS_last, kR_last = plan.passes[-1]
    # load_runs: group h of thread t, the run of 2^kR words at gid << kR
    run = np.empty((plan.C, plan.T, plan.W), np.int64)
    for h in range(plan.W >> kR_last):
        for i in range(1 << kR_last):
            run[:, :, (h << kR_last) + i] = (plan.r * plan.M
                                             + (plan.gid(h, kR_last) << kR_last) + i)
    assert np.array_equal(plan.slots(kS_last, kR_last)[None]
                          - plan.pad(run - plan.r[:, :, None] * plan.M),
                          np.zeros_like(run)), "runs are not the last pass's words"
    a = x[:, run]
    s = np.full(a.shape[:2] + (plan.pad(plan.M),), -1, np.int64)
    for idx, (kS, kR) in enumerate(reversed(plan.passes)):
        slot = plan.slots(kS, kR)
        if idx:
            a = _take(s, slot)
            assert (a >= 0).all()
        _stages(a, tabs, q, kR, lambda kL, h, g, kS=kS, kR=kR:
                plan.local_twiddle(kS, kR, kL, h, g), inverse=True)
        if kS:
            _put(s, slot, a)
    xs = _exchange(a, *scatter_inverse(plan), plan.M)
    # the cross pass: word k of group h at k * M/C + h * T + t
    b = np.empty_like(a)
    for h in range(plan.GX):
        for k in range(plan.C):
            b[:, :, :, h * plan.C + k] = xs[:, :, k * plan.MC + h * plan.T + plan.t[0]]
    _stages(b, tabs, q, plan.log_c, lambda kL, h, g: plan.cross_twiddle(kL, g),
            inverse=True)
    if fin is not None:
        b = _mul(b, *fin, q)
    return _unflatten(b, plan.cross_positions(), 1 << plan.log_n)


def _companions(w, moduli, words: Words):
    """Shoup companions of (..., L, N) int64 words w over ``moduli``
    (int64 bits of uint64 values), or None for uint32."""
    if words.bits == 32:
        return None
    q = np.array(moduli, dtype=object).reshape((-1,) + (1,) * (np.ndim(w) - 1))
    return shoup(w, q, 64).view(np.int64)


@functools.lru_cache(maxsize=None)
def _tables(moduli, degree, bits: int = 32):
    """Compact (fwd, fwd companions, inv, inv companions) of a chain, int64
    (L, N); the companions None for uint32."""
    fwd, inv = compact_twiddles(tuple(moduli), degree)
    words = W32 if bits == 32 else W64
    fwd, inv = fwd.astype(np.int64), inv.astype(np.int64)
    return fwd, _companions(fwd, moduli, words), inv, _companions(inv, moduli, words)


def _planes(seed, moduli, degree, batch):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=(batch, degree), dtype=np.int64)
                     for q in moduli], axis=1)  # (batch, L, N)


def _tile(table, B):
    return None if table is None else np.tile(table, (B, 1))


def _ntt(plan: Plan, x3, moduli, inverse: bool, final=None):
    """Emulated NTT of int64 (B, L, N) planes; returns torch planes of the
    plan's word (int32 or int64)."""
    B, L, n = x3.shape
    fwd, fwdp, inv, invp = _tables(tuple(moduli), n, plan.words.bits)
    tabs = (_tile(inv, B), _tile(invp, B)) if inverse else (_tile(fwd, B), _tile(fwdp, B))
    q = np.tile(np.array(moduli, np.int64), B)[:, None, None, None]
    x = x3.reshape(B * L, n)
    if inverse:
        f = final or tuple(pow(n, -1, m) for m in moduli)
        f = np.array([v % m for v, m in zip(f, moduli)], np.int64)
        fp = _companions(f, moduli, plan.words)
        col = lambda v: None if v is None else np.tile(v, B)[:, None, None, None]
        out = emulate_inverse(plan, x, tabs, q, (col(f), col(fp)))
    else:
        out = _unflatten(emulate_forward(plan, x, tabs, q), _p0_positions(plan), n)
    dtype = np.int32 if plan.words.bits == 32 else np.int64
    return torch.from_numpy(out.reshape(B, L, n).astype(dtype))


PLANS = [(16, 2), (16, 3), (16, 4)]  # C = 4, 8, 16 at N = 2^16


def _check_scatters(plan: Plan):
    """Each cross-pass word reaches one slot of one rank, every slot that
    the next pass reads is written, and no two words share one."""
    rank, slot = scatter_forward(plan)
    flat = rank * plan.pad(plan.M) + slot
    read = np.unique(plan.slots(*plan.passes[0]))
    assert np.array_equal(np.unique(flat), np.unique(
        np.arange(plan.C)[:, None] * plan.pad(plan.M) + read[None, :]))
    assert len(np.unique(flat)) == flat.size == 1 << plan.log_n
    owner, slot = scatter_inverse(plan)
    flat = (owner * plan.M + slot).reshape(-1)
    assert np.array_equal(np.sort(flat), np.arange(1 << plan.log_n))


def _check_local_twiddles(plan: Plan):
    """(lead * C + r) * 2^s' + blk * 2^kL + g is the whole plane's entry
    2^s + g of global stage s = log2 P + log2 C + s' for the butterfly's
    global group (slab p of P at plane offset p * 2^log_n; P = 1 on a
    plane); and the cross pass's (lead << l) + g that of stage log2 P +
    l."""
    log_total = plan.log_p + plan.log_n  # the whole plane's log2 N
    for kS, kR in plan.passes:
        log_off = plan.log_m - kS - kR
        for kL in range(kR):
            s = plan.log_p + plan.log_c + kS + kL
            for h in range(plan.W >> kR):
                gid = plan.gid(h, kR)
                blk = gid >> log_off
                for g in range(1 << kL):
                    # the butterfly's u word: local position of (blk, g, i=0)
                    local = ((blk << (plan.log_m - kS))
                             + (g << (plan.log_m - kS - kL)) + (gid & ((1 << log_off) - 1)))
                    glob = (plan.p << plan.log_n) + plan.r * plan.M + local
                    want = (1 << s) + (glob >> (log_total - s))
                    assert np.array_equal(plan.local_twiddle(kS, kR, kL, h, g), want)
    for l in range(plan.log_c):
        s = plan.log_p + l
        for g in range(1 << l):
            # group j's u word of butterfly group g: position j + k_u * M
            k_u = g << (plan.log_c - l)
            for h in range(plan.GX):
                glob = (plan.p << plan.log_n) + plan.cross_j(h) + k_u * plan.M
                want = (1 << s) + (glob >> (log_total - s))
                assert np.array_equal(np.broadcast_to(plan.cross_twiddle(l, g), want.shape),
                                      want)


@pytest.mark.parametrize("log_n,log_c", PLANS)
def test_scatters_are_permutations(log_n, log_c):
    """The scatters of the uint32 plans (``_check_scatters``)."""
    _check_scatters(Plan(log_n, log_c))


@pytest.mark.parametrize("log_n,log_c", PLANS)
def test_local_twiddles_are_the_planes(log_n, log_c):
    """The slice twiddles of the uint32 plans (``_check_local_twiddles``)."""
    _check_local_twiddles(Plan(log_n, log_c))


@pytest.mark.parametrize("log_n,log_c", PLANS)
@pytest.mark.parametrize("mode", ["forward", "inverse", "fold", "yhat"])
def test_ntt_plan_matches_twin(log_n, log_c, mode):
    """K4's plan, forward and inverse with each final constant, against
    ``ntt_gpu.ntt_twin`` word for word at the big chain's primes."""
    n = 1 << log_n
    moduli = tuple(generate_primes(30, 3, n))
    final = None
    if mode == "fold":
        final = _fold_consts(moduli, n, tuple((q - 1) // 3 for q in moduli))
    elif mode == "yhat":
        final = moddown_gpu._down_consts(moduli[:1], moduli[1:], n)[6]
        final = final + final[:1]
    x3 = _planes(log_c + 10 * log_n, moduli, n, 1)
    got = _ntt(Plan(log_n, log_c), x3, moduli, mode != "forward", final)
    want = ntt_gpu.ntt_twin(torch.from_numpy(x3.astype(np.int32)), moduli, n,
                            mode != "forward", final)
    assert torch.equal(got, want)


def phat_weight(m: int, j: int, kept: int) -> int:
    """Flat index of dropped channel m's Phat weight for kept channel j in
    the kernels' (G, L') table c: c[m * kept + j]."""
    return m * kept + j


def emulate_moddown(plan: Plan, yhat, ks, t, child, dropped, t_scale: int):
    """K3's / K8's cluster plan on int64 yhat (G, N) and ks, t (L', N) of
    one item (t None: K3' / K8'): per kept channel j the Phat sum
    sum_m Harvey(yhat_m, c[m, j]) in the cross pass's loads, the forward
    plan, then the combine Harvey((ks + Harvey(t, P mod q_j)) - ext,
    P^-1) in pass 0's layout; returns torch (L', N) planes of the plan's
    word (R = 2^32 / 2^64)."""
    n = 1 << plan.log_n
    bits = plan.words.bits
    kept = len(child)
    c, cs, pm, pms, pinv, pinvs, _ = moddown_gpu._down_consts(child, dropped, n, t_scale,
                                                               bits)
    c, pm, pinv = (v.astype(np.int64) for v in (c, pm, pinv))
    cs, pms, pinvs = (None if bits == 32 else v.view(np.int64) for v in (cs, pms, pinvs))
    q = np.array(child, np.int64)[:, None, None, None]
    fwd, fwdp = _tables(tuple(child), n, bits)[:2]

    def phat(pos):  # the cross pass's words of every kept channel
        acc = np.zeros((kept,) + pos.shape, np.int64)
        for j in range(kept):
            for m in range(len(dropped)):
                w = phat_weight(m, j, kept)
                term = _mul(yhat[m][pos], c.reshape(-1)[w],
                            None if cs is None else cs.reshape(-1)[w], child[j])
                acc[j] = _add(acc[j], term, child[j])
        return acc

    ext = emulate_forward(plan, None, (fwd, fwdp), q, prologue=phat)
    pos = _p0_positions(plan)
    col = lambda v: None if v is None else v[:, None, None, None]
    head = ks[:, pos]
    if t is not None:
        head = _add(head, _mul(t[:, pos], col(pm), col(pms), q), q)
    out = _mul(_sub(head, ext, q), col(pinv), col(pinvs), q)
    dtype = np.int32 if bits == 32 else np.int64
    return torch.from_numpy(_unflatten(out, pos, n).astype(dtype))


def _moddown_case(plan: Plan, bits: int, with_t: bool, kept: int, dropped: int):
    """(emulated, twin) of one item's mod-down: ``kept`` + ``dropped``
    seeded primes of ``bits`` bits, the last ``dropped`` of them dropped."""
    n = 1 << plan.log_n
    primes = tuple(generate_primes(bits, kept + dropped, n))
    child, drop = primes[:kept], primes[kept:]
    t_scale = 987654321 if with_t else 0
    yhat = _planes(1, drop, n, 1)[0]  # (G, N)
    ks = _planes(2, child, n, 1)[0]
    t = _planes(3, child, n, 1)[0] if with_t else None
    got = emulate_moddown(plan, yhat, ks, t, child, drop, t_scale)
    dtype = torch.int32 if plan.words.bits == 32 else torch.int64
    tt = lambda a: None if a is None else torch.from_numpy(a).to(dtype)
    want = moddown_gpu.mod_down_combine_twin(tt(yhat), tt(ks), tt(t), child, drop, n,
                                             t_scale)
    return got, want


@pytest.mark.parametrize("log_n,log_c", PLANS)
@pytest.mark.parametrize("with_t", [True, False])
def test_moddown_plan_matches_twin(log_n, log_c, with_t):
    """K3 (t) / K3' (no t): the Phat sum of G = 2 yhat planes in the cross
    pass's loads, the forward plan, the combine in pass 0's layout,
    against ``mod_down_combine_twin`` for 2 kept channels, batch 1."""
    got, want = _moddown_case(Plan(log_n, log_c), 30, with_t, 2, 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
def test_small_plan_matches_reference(inverse):
    """N = 2^12 on C = 4 (slices of 2^10: passes 5 + 5) against the JAX
    reference's staged NTT (``ops/ntt.py``) on the CPU."""
    n = 1 << 12
    moduli = tuple(generate_primes(31, 2, n))
    x3 = _planes(5, moduli, n, 1)
    got = _ntt(Plan(12, 2), x3, moduli, inverse)
    rctx = RefContext.build(moduli, n)
    fn = ref_ntt.inverse_ntt if inverse else ref_ntt.forward_ntt
    # one XLA compile of the whole transform (eager, each op compiles alone)
    want = jax.jit(lambda d: fn(d, rctx.ntt, rctx.chain))(
        jnp.asarray(convert.to_reference(torch.from_numpy(x3[0].astype(np.int32)))))
    np.testing.assert_array_equal(convert.to_reference(got[0]), np.asarray(want))


# ── K2: keyswitch_kernel_cluster ────────────────────────────────────────


def ks_plane_map(outer: int, base: int, ext: int, with_d: bool):
    """(item, j) of each plane of the grid, by keyswitch_kernel_cluster's
    map: with d the outer * (ext - base) special channels' planes first
    (they run one NTT digit more), then the base channels'; (planes, 2)."""
    spec = ext - base
    heavy = outer * spec if with_d else 0
    width = base if with_d else ext
    p = np.arange(outer * ext)
    rest = p - heavy
    item = np.where(p < heavy, p // max(spec, 1), rest // width)
    j = np.where(p < heavy, base + p % max(spec, 1), rest % width)
    return np.stack([item, j], axis=1)


def ks_blocks(log_c: int, outer: int, base: int, ext: int, with_d: bool):
    """(rank, item, j) of each block: rank blockIdx & (C - 1), plane
    blockIdx >> log2 C; (blocks, 3)."""
    blocks = np.arange(outer * ext << log_c)
    planes = ks_plane_map(outer, base, ext, with_d)[blocks >> log_c]
    return np.concatenate([(blocks & ((1 << log_c) - 1))[:, None], planes], axis=1)


def ks_schedule(digits: int, own: int, arrive_before_read: bool = False):
    """One block's cluster-barrier events in program order, as
    keyswitch_kernel_cluster and cluster_forward run them: an arrive at
    start if the plane runs an NTT digit; per NTT digit the wait, the
    scatter into every rank's slice, arrive and wait, the reads of its own
    slice (the local passes and the load back to pass 0's layout), and an
    arrive when another NTT digit follows; then the exit.
    ``arrive_before_read`` moves that arrive before the reads (a fault the
    model must catch)."""
    ntts = digits - (own >= 0)
    events = [("arrive",)] if ntts > 0 else []
    for dt in range(digits):
        if dt == own:
            continue
        ntts -= 1
        events += [("wait",), ("scatter", dt), ("arrive",), ("wait",)]
        tail = [("read", dt)] + ([("arrive",)] if ntts > 0 else [])
        events += tail[::-1] if arrive_before_read and ntts > 0 else tail
    return events + [("exit",)]


def check_schedule(ranks: list) -> None:
    """Asserts the barrier rules for the C ranks of one plane (each a list
    of events, ``ks_schedule``). Wait k of any rank returns only after arrive
    k of every rank, so an event after a rank's k-th wait follows every
    event before each peer's k-th arrive. Checked: each rank alternates
    arrive and wait and ends with none pending, all ranks pass the same
    number of phases; no rank stores to a peer that has not started; no
    scatter of a digit reaches a rank's slice before that rank's last read
    of its previous digit; no rank reads its slice before every rank's
    scatter of that digit; no rank's last store comes after a peer's exit."""
    def counts(events):
        """(arrives, waits) before each event."""
        a = w = 0
        out = []
        for ev in events:
            out.append((a, w))
            if ev[0] == "arrive":
                assert a == w, "two arrives without a wait"
                a += 1
            elif ev[0] == "wait":
                assert w == a - 1, "a wait without an arrive"
                w += 1
        assert a == w, "an arrive left pending at exit"
        return out

    before = [counts(ev) for ev in ranks]
    assert len({c[-1] for c in before}) == 1, "ranks pass different numbers of phases"

    def arrive_after(rank, index):
        """The arrive (1-based) that rank's event ``index`` precedes."""
        return before[rank][index][0] + 1

    for src, events in enumerate(ranks):
        for i, ev in enumerate(events):
            if ev[0] != "scatter":
                continue
            waits = before[src][i][1]
            assert waits >= 1, "a store before every rank has started"
            for dst, peer in enumerate(ranks):
                reads = [k for k, e in enumerate(peer) if e[0] == "read"]
                prev = [k for k in reads if peer[k][1] < ev[1]]
                if prev:
                    assert arrive_after(dst, prev[-1]) <= waits, (
                        f"rank {src}'s scatter of digit {ev[1]} may overwrite rank "
                        f"{dst}'s slice before its last read of digit {peer[prev[-1]][1]}")
                for k in reads:
                    if peer[k][1] == ev[1]:
                        assert before[dst][k][1] >= arrive_after(src, i), (
                            f"rank {dst} reads digit {ev[1]} before rank {src}'s scatter")
        stores = [i for i, e in enumerate(events) if e[0] == "scatter"]
        for dst, peer in enumerate(ranks):
            if stores:
                assert arrive_after(src, stores[-1]) <= before[dst][-1][1], (
                    f"rank {src}'s last store may come after rank {dst}'s exit")


def emulate_keyswitch(plan: Plan, y, d, key_a, key_b, base, ext, ds):
    """K2's / K6's cluster plan on int64 y (B, L, N) plain digits, d (B, L,
    N) or None and keys (D, E, N): the plane map, each NTT digit's raise in
    the cross pass's loads and forward plan (all of them as one stack of
    planes), then per plane the epilogue in pass 0's layout, digit by digit
    in the kernel's order; returns (ks0, ks1) as torch (B, E, N) planes of
    the plan's word (int32 / int64; R = 2^32 / 2^64)."""
    B, L, n = y.shape
    E, D = len(ext), key_a.shape[0]
    bits = plan.words.bits
    c, cs, _, qinv, _ = keyswitch_gpu._switch_consts(base, ext, ds, bits)  # (D*ds, E)
    c, cs = c.astype(np.int64), None if bits == 32 else cs.view(np.int64)
    fwd, fwdp = _tables(ext, n, bits)[:2]
    planes = ks_plane_map(B, L, E, d is not None)
    own = lambda j: j // ds if d is not None and j < L else -1
    jobs = [(item, j, dt) for item, j in planes for dt in range(D) if dt != own(j)]
    q = np.array([ext[j] for _, j, _ in jobs], np.int64)[:, None, None, None]

    def raise_digits(pos):  # sum_{k in dt} Harvey(y_k[pos], c[k, j]) per job
        acc = np.zeros((len(jobs),) + pos.shape, np.int64)
        for i, (item, j, dt) in enumerate(jobs):
            for k in range(dt * ds, min((dt + 1) * ds, L)):
                term = _mul(y[item, k][pos], c[k, j], None if cs is None else cs[k, j], ext[j])
                acc[i] = _add(acc[i], term, ext[j])
        return acc

    rows = [j for _, j, _ in jobs]
    tabs = (fwd[rows], None if fwdp is None else fwdp[rows])
    alpha = emulate_forward(plan, None, tabs, q, prologue=raise_digits) if jobs else None
    pos = _p0_positions(plan)
    ks = np.full((2, B, E, n), -1, np.int64)
    for item, j in planes:
        qj = ext[j]
        if bits == 32:  # mont_redc: a * b * 2^-32 mod q
            rinv = pow(1 << 32, -1, qj)
            redc = lambda a, b: a * b % qj * rinv % qj
        else:
            redc = lambda a, b: _redc64(a, b, qj, qinv[j])
        acc, first = None, True
        for dt in range(D):
            if dt == own(j):
                continue
            a = alpha[jobs.index((item, j, dt))]
            v = [redc(a, key[dt, j][pos]) for key in (key_b, key_a)]
            if first and own(j) >= 0:  # the own digit's term, with the first NTT digit
                v = [_add(x, redc(d[item, j][pos], key[own(j), j][pos]), qj)
                     for x, key in zip(v, (key_b, key_a))]
            if not first:
                v = [_add(x, o, qj) for x, o in zip(v, acc)]
            acc, first = v, False
        if first:  # D = 1 with d: the own digit alone
            acc = [redc(d[item, j][pos], key[own(j), j][pos]) for key in (key_b, key_a)]
        for o in range(2):
            ks[o, item, j] = _unflatten(acc[o][None], pos, n)[0]
    dtype = np.int32 if bits == 32 else np.int64
    return tuple(torch.from_numpy(k.astype(dtype)) for k in ks)


@functools.lru_cache(maxsize=None)
def _ks_inputs(log_n: int, bits: int, count: int, ds: int, batch: int, with_d: bool):
    """A chain's base and extended moduli and seeded int64 y, d, key_a,
    key_b, with the twin's (ks0, ks1) on them (computed once): int32
    planes below 32-bit primes, int64 planes (a wide chain) above."""
    n = 1 << log_n
    base = tuple(generate_primes(bits, count, n))
    ext = base + default_special_primes(CkksContext.build(base, n, device="cpu"), ds)
    D = -(-count // ds)
    y = _planes(20, base, n, batch)
    d = _planes(21, base, n, batch) if with_d else None
    key_a = _planes(22, ext, n, D)
    key_b = _planes(23, ext, n, D)
    dtype = np.int32 if bits < 32 else np.int64
    tt = lambda a: None if a is None else torch.from_numpy(a.astype(dtype))
    want = keyswitch_gpu.gadget_accumulate_twin(tt(y), tt(key_a), tt(key_b), base,
                                                ext, n, ds, tt(d))
    return base, ext, y, d, key_a, key_b, want


@pytest.mark.parametrize("outer,base,ext", [(4, 4, 6), (1, 4, 5), (3, 4, 8), (2, 3, 5)])
@pytest.mark.parametrize("with_d", [True, False])
@pytest.mark.parametrize("log_c", [2, 4])
def test_ks_plane_map_is_a_bijection(outer, base, ext, with_d, log_c):
    """Every (item, j) pair has one cluster, the C blocks of a cluster share
    its plane with ranks 0 .. C-1, and with d the special channels' planes
    come first."""
    blocks = ks_blocks(log_c, outer, base, ext, with_d)
    C = 1 << log_c
    clusters = blocks.reshape(-1, C, 3)
    assert (clusters[:, :, 0] == np.arange(C)).all()
    assert (clusters[:, :, 1:] == clusters[:, :1, 1:]).all(), "a cluster spans two planes"
    pairs = {tuple(p) for p in clusters[:, 0, 1:]}
    assert pairs == {(i, j) for i in range(outer) for j in range(ext)}
    assert len(clusters) == outer * ext
    if with_d:
        heavy = outer * (ext - base)
        assert (clusters[:heavy, 0, 2] >= base).all() and (clusters[heavy:, 0, 2] < base).all()


@pytest.mark.parametrize("digits,own", [(1, -1), (1, 0), (2, -1), (2, 0), (2, 1),
                                        (4, -1), (4, 0), (4, 3)])
def test_ks_barrier_schedule(digits, own):
    """The cluster-barrier phases of a plane's C = 16 ranks across the
    digits: no scatter before a peer's last read of the previous digit or
    after a peer's exit; with one NTT digit (D = 2 with d, or D = 1), or
    none (D = 1 with d: no barrier, no peer), the same rules hold."""
    check_schedule([ks_schedule(digits, own)] * 16)
    if digits - (own >= 0) > 1:  # the arrive before the last read must be caught
        with pytest.raises(AssertionError, match="overwrite"):
            check_schedule([ks_schedule(digits, own, arrive_before_read=True)] * 16)


@pytest.mark.parametrize("log_c", [2, 3, 4])
@pytest.mark.parametrize("ds", [2, 1])
@pytest.mark.parametrize("with_d", [True, False])
def test_keyswitch_plan_matches_twin(log_c, ds, with_d):
    """K2's cluster plan at N = 2^16 on the big path's 4 x 30-bit base (ds 2:
    D = 2, E = 6; ds 1: D = 4, E = 5), batch 1, against
    ``gadget_accumulate_twin`` word for word."""
    base, ext, y, d, key_a, key_b, want = _ks_inputs(16, 30, 4, ds, 1, with_d)
    got = emulate_keyswitch(Plan(16, log_c), y, d, key_a, key_b, base, ext, ds)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_keyswitch_plan_d1_runs_no_ntt_on_base():
    """D = 1 with d (ds 4 over 4 primes): the base planes take their own
    digit alone and run no NTT; the special planes one."""
    base, ext, y, d, key_a, key_b, want = _ks_inputs(16, 30, 4, 4, 1, True)
    got = emulate_keyswitch(Plan(16, 4), y, d, key_a, key_b, base, ext, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_small_keyswitch_plan_matches_reference():
    """N = 2^12 on C = 4, 3 x 31-bit base, ds 2 (a short last digit group)
    with d, against the JAX reference's K2 (``gadget_accumulate_pallas``)
    in interpret mode on the CPU."""
    base, ext, y, d, key_a, key_b, _ = _ks_inputs(12, 31, 3, 2, 1, True)
    got = emulate_keyswitch(Plan(12, 2), y, d, key_a, key_b, base, ext, 2)
    j = lambda a: jnp.asarray(a.astype(np.uint32))
    key = lambda a: jnp.asarray(convert.to_reference(torch.from_numpy(a.astype(np.int32))))
    want = ref_ks.gadget_accumulate_pallas(
        j(y), key(key_a), key(key_b), base_moduli=base, ext_moduli=ext, degree=1 << 12,
        digit_size=2, interpret=True, stack_limbs=False, d_ntt=j(d))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))


# ── K5 / K5' / K7, K6 and K8 / K8': the uint64 cluster forms ──────────


def _wide_plan(log_n: int, form: str = "ks") -> Plan:
    """The uint64 plan of ``form`` (WIDE_FORM_LOG_C) as built
    (``WidePlan<log_n, form>``)."""
    return Plan(log_n, WIDE_FORM_LOG_C[form][log_n], W64)


def _wavefronts(slots, words: Words) -> int:
    """Shared-memory wavefronts of one warp's access to word slots (32,):
    4-byte words in one phase of 32 threads over 32 banks, 8-byte words in
    two phases of 16 threads over 16 pairs of banks; a word that several
    threads of a phase touch is one access."""
    per = 128 // words.bytes
    return sum(int(np.bincount(np.unique(slots[p:p + per]) % per).max())
               for p in range(0, len(slots), per))


def _accesses(plan: Plan):
    """(name, slots (C, T)) of every shared-memory instruction of the
    plan: each pass's loads and stores (one instruction per word of a[],
    the same slots on every rank), the forward scatter into the peers'
    slices, and the inverse's stores into and loads from its buffer."""
    for kS, kR in plan.passes:
        slots = plan.slots(kS, kR)
        for m in range(plan.W):
            yield f"pass ({kS}, {kR}) word {m}", np.broadcast_to(slots[:, m], (plan.C, plan.T))
    for h in range(plan.GX):
        yield f"scatter group {h}", plan.pad(plan.cross_j(h))
        for k in range(plan.C):
            yield f"buffer store {k}, {h}", plan.r * plan.MC + plan.t + h * plan.T
            yield f"buffer load {k}, {h}", np.broadcast_to(k * plan.MC + h * plan.T + plan.t,
                                                          (plan.C, plan.T))


@pytest.mark.parametrize("log_n", [13, 14, 15, 16])
def test_wide_plan_shapes(log_n):
    """The built plan's scatters and slice twiddles (``_check_scatters``,
    ``_check_local_twiddles``)."""
    plan = _wide_plan(log_n)
    _check_scatters(plan)
    _check_local_twiddles(plan)


def _check_conflict_free(plan: Plan):
    """Every shared-memory access of the plan takes the least wavefronts a
    warp can (two half-warps of 8-byte words)."""
    phases = 32 * plan.words.bytes // 128
    for name, slots in _accesses(plan):
        for row in np.asarray(slots).reshape(plan.C, plan.T):
            for w in range(0, plan.T, 32):
                assert _wavefronts(row[w:w + 32], plan.words) == phases, name


@pytest.mark.parametrize("log_n", [13, 14, 15, 16])
def test_wide_plan_is_conflict_free(log_n):
    """Every shared-memory access of the built uint64 plan takes the least
    wavefronts a warp can: the pad of one word after every 16 keeps the
    exchanges and the scatter free of bank conflicts
    (``_check_conflict_free``)."""
    _check_conflict_free(_wide_plan(log_n))


@pytest.mark.parametrize("log_n", [13, 14])
def test_wide_ntt_form_plans(log_n):
    """K5 / K7's and K8 / K8''s plan as built at 2^13 and 2^14 (their own
    C there): scatters, slice twiddles and bank conflicts: none but the
    2-way ones of a slice of 2^10's middle pass (passes 4 + 3 + 3, as K10's
    uint64 slices of 2^10, TAIL_CONFLICTS)."""
    plan = _wide_plan(log_n, "ntt")
    assert plan.C == 1 << WIDE_FORM_LOG_C["ntt"][log_n] and plan.log_m >= 10
    _check_scatters(plan)
    _check_local_twiddles(plan)
    assert _conflicts(plan) == ({"pass (4, 3)": 2} if plan.log_m == 10 else {})


def _wide_ntt_case(log_n: int, mode: str, count: int = 1, bits: int = 61):
    """One wide chain's planes and final constants for ``mode``: forward,
    inverse (N^-1), fold (the decomposition fold's constants) or yhat (the
    mod-down's yhat emission, the last of ``count`` + 1 primes dropped),
    on ``bits``-bit primes."""
    n = 1 << log_n
    moduli = tuple(generate_primes(bits, count + (mode == "yhat"), n))
    final = None
    if mode == "fold":
        final = moddown_gpu._fold_consts_wide(moduli, n, tuple((q - 1) // 3 for q in moduli))
    elif mode == "yhat":
        final = moddown_gpu._down_consts_wide(moduli[:-1], moduli[-1:], n)[6]
        moduli = moduli[-1:]
    return moduli, final, _planes(log_n + len(mode), moduli, n, 1)


# forward and inverse at both rings; the final constants of the fold and
# the yhat emission (the same inverse passes) at 2^15; every mode at 2^13
# (the wide path) and 2^14 (wide-62b) on K5 / K7's C there, on 36-bit
# primes (the twin's bit-serial products cost time by the bit; the
# Harvey64 words are those of 61 bits, which 2^15 and 2^16 check)
WIDE_NTT = [(15, "forward"), (15, "inverse"), (15, "fold"), (15, "yhat"),
            (16, "forward"), (16, "inverse"),
            *((n, mode) for n in (13, 14) for mode in ("forward", "inverse", "fold", "yhat"))]


@pytest.mark.parametrize("log_n,mode", WIDE_NTT)
def test_wide_ntt_plan_matches_twin(log_n, mode):
    """K5 / K5' / K7 on the built uint64 plan (Harvey64 butterflies, Shoup
    companions) against ``ntt_gpu.ntt_twin`` word for word, one plane
    (61-bit at 2^15 and 2^16, 36-bit at 2^13 and 2^14)."""
    moduli, final, x3 = _wide_ntt_case(log_n, mode, bits=61 if log_n > 14 else 36)
    n = 1 << log_n
    got = _ntt(_wide_plan(log_n, "ntt"), x3, moduli, mode != "forward", final)
    want = ntt_gpu.ntt_twin(torch.from_numpy(x3), moduli, n, mode != "forward", final)
    assert torch.equal(got, want)


# (log2 N, digit_size, base primes, with d), batch 1: at 2^15 D = 2 with
# d and D = 1 with d (the base plane runs no NTT), at 2^16 D = 1 without d
# (both planes run one); at 2^13 (the wide path's ring) D = 2 with and
# without d, at 2^14 D = 1 with and without d; D = 2 without d at 2^12
# below. 36-bit primes
# (uint64 words, R = 2^64), as the twin's bit-serial products cost time by
# the bit (61-bit words in the NTT cases and the 2^12 key switch)
WIDE_KS = [(15, 1, 2, True), (15, 1, 1, True), (16, 1, 1, False), (13, 1, 2, True),
           (13, 1, 2, False), (14, 1, 1, True), (14, 1, 1, False)]


@pytest.mark.parametrize("log_n,ds,count,with_d", WIDE_KS)
def test_wide_keyswitch_plan_matches_twin(log_n, ds, count, with_d):
    """K6 on the built uint64 plan (Harvey64 raise, REDC64 key products)
    against ``gadget_accumulate_twin`` word for word."""
    base, ext, y, d, key_a, key_b, want = _ks_inputs(log_n, 36, count, ds, 1, with_d)
    got = emulate_keyswitch(_wide_plan(log_n), y, d, key_a, key_b, base, ext, ds)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _limbs(t: torch.Tensor):
    """int64 planes -> the reference's uint32 limb pairs."""
    return jnp.asarray(convert.to_reference(t))


def _limbs_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want, dtype=np.uint32)
    words = want[..., 0, :].astype(np.uint64) | (want[..., 1, :].astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), words)


def test_wide_small_plan_matches_reference():
    """N = 2^12 on C = 4 with the built words a thread (slices of 2^10),
    one 61-bit plane: the forward against the JAX reference's staged NTT
    (``ops/ntt.py``) on the CPU, which tests/test_torch_wide.py holds to
    its ``ntt_pallas_wide``, and the inverse against the twin (the staged
    NTT's XLA compile takes ~9 s a direction on one core here, and
    ``ntt_pallas_wide`` in interpret mode minutes)."""
    n = 1 << 12
    moduli = tuple(generate_primes(61, 1, n))
    x3 = _planes(7, moduli, n, 1)
    rctx = RefContext.build(moduli, n)
    want = jax.jit(lambda d: ref_ntt.forward_ntt(d, rctx.ntt, rctx.chain))(
        _limbs(torch.from_numpy(x3[0])))
    _limbs_equal(_ntt(Plan(12, 2, W64), x3, moduli, False)[0], want)
    inv = ntt_gpu.ntt_twin(torch.from_numpy(x3), moduli, n, True)
    assert torch.equal(_ntt(Plan(12, 2, W64), x3, moduli, True), inv)


# K8 / K8' on the built uint64 plan, batch 1: (log2 N, bits, with t,
# kept, dropped) at the big-wide path's shapes at 2^15 (K8: 2 kept, the
# last base prime and the special dropped; K8': 3 kept, the special
# dropped), at 2^16 (1, 1), at N = 2^12 on C = 4 (3 x 61-bit, 2 kept, 1
# dropped), at the wide path's shapes at 2^13 (K8: 3 kept, 2 dropped; K8':
# 4 kept, 1 dropped) and at wide-62b's K8 at 2^14 (2 kept, 2 dropped), these
# three on 36-bit primes (WIDE_NTT). tests/test_torch_wide.py and
# test_torch_rotate.py hold the twin to the reference's
# ``mod_down_combine_pallas_wide``.
WIDE_MD = [(15, 61, True, 2, 2), (15, 61, False, 3, 1), (16, 61, True, 1, 1),
           (12, 61, True, 2, 1), (13, 36, True, 3, 2), (13, 36, False, 4, 1),
           (14, 36, True, 2, 2)]


@pytest.mark.parametrize("log_n,bits,with_t,kept,dropped", WIDE_MD)
def test_wide_moddown_plan_matches_twin(log_n, bits, with_t, kept, dropped):
    """K8 (t) / K8' (no t) on the built uint64 plan (the Phat sum a Harvey64
    in the cross pass's loads, the combine Harvey64s in pass 0's layout)
    against ``mod_down_combine_twin`` word for word."""
    plan = Plan(12, 2, W64) if log_n == 12 else _wide_plan(log_n, "ntt")
    got, want = _moddown_case(plan, bits, with_t, kept, dropped)
    assert torch.equal(got, want)


def test_wide_moddown_plan_mutation_fails(monkeypatch):
    """The emulation catches the Phat weight of the wrong kept channel
    (c[m * kept + (j + 1) % kept] in place of c[m * kept + j])."""
    plan = Plan(12, 2, W64)
    got, want = _moddown_case(plan, 61, True, 2, 1)
    assert torch.equal(got, want)
    monkeypatch.setattr(sys.modules[__name__], "phat_weight",
                        lambda m, j, kept: m * kept + (j + 1) % kept)
    got, _ = _moddown_case(plan, 61, True, 2, 1)
    assert not torch.equal(got, want)


@pytest.mark.parametrize("with_d", [True, False])
def test_wide_small_keyswitch_plan_matches_twin(with_d):
    """K6 at N = 2^12 on C = 4, 3 x 61-bit, ds 2 (D = 2, a short last
    digit group) against ``gadget_accumulate_twin``, which
    tests/test_torch_wide.py holds to the reference's
    ``gadget_accumulate_pallas_wide`` (that kernel in interpret mode takes
    35 s at N = 2^10 on one core, about 10 min at 2^12)."""
    base, ext, y, d, key_a, key_b, want = _ks_inputs(12, 61, 3, 2, 1, with_d)
    got = emulate_keyswitch(Plan(12, 2, W64), y, d, key_a, key_b, base, ext, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wide_plan_mutations_fail(monkeypatch):
    """The emulation catches a slice twiddle without the rank's lead (r in
    place of C + r) and a scatter at the uint32 pad (one word after every
    32, where the uint64 passes read one after every 16)."""
    n = 1 << 12
    moduli = tuple(generate_primes(61, 1, n))
    x3 = _planes(8, moduli, n, 1)
    want = ntt_gpu.ntt_twin(torch.from_numpy(x3), moduli, n, False)
    assert torch.equal(_ntt(Plan(12, 2, W64), x3, moduli, False), want)
    bad = Plan(12, 2, W64)
    lead = bad.local_twiddle
    bad.local_twiddle = lambda kS, kR, kL, h, g: lead(kS, kR, kL, h, g) - (bad.C << (kS + kL))
    assert not torch.equal(_ntt(bad, x3, moduli, False), want)
    monkeypatch.setattr(sys.modules[__name__], "scatter_forward",
                        functools.partial(scatter_forward, pad=W32.pad))
    with pytest.raises(AssertionError, match="read before it was written"):
        _ntt(Plan(12, 2, W64), x3, moduli, False)


def test_wide_13_plan_mutations_fail():
    """At 2^13 on K5's built C, forward and inverse against the twin, the
    emulation catches the slice twiddles of a plan of half the ranks
    (lead * C/2 + r in place of lead * C + r: a wrong C) and a cross pass
    one stage off (the table entries (lead << (l + 1)) + g: a wrong stage
    lead)."""
    n = 1 << 13
    moduli = tuple(generate_primes(36, 1, n))
    x3 = _planes(9, moduli, n, 1)
    for inverse in (False, True):
        want = ntt_gpu.ntt_twin(torch.from_numpy(x3), moduli, n, inverse)
        assert torch.equal(_ntt(_wide_plan(13, "ntt"), x3, moduli, inverse), want)
        wrong_c = _wide_plan(13, "ntt")
        local = wrong_c.local_twiddle
        wrong_c.local_twiddle = lambda kS, kR, kL, h, g, p=wrong_c, f=local: (
            f(kS, kR, kL, h, g) - ((p.lead * p.C // 2) << (kS + kL)))
        assert not torch.equal(_ntt(wrong_c, x3, moduli, inverse), want)
        wrong_stage = _wide_plan(13, "ntt")
        wrong_stage.cross_twiddle = lambda l, g, p=wrong_stage: (p.lead << (l + 1)) + g
        assert not torch.equal(_ntt(wrong_stage, x3, moduli, inverse), want)


@pytest.mark.parametrize("log_n", [15, 16])
@pytest.mark.parametrize("digits,own", [(3, -1), (3, 0), (3, 2), (2, 1), (1, 0)])
def test_wide_ks_barrier_schedule(log_n, digits, own):
    """K6's digit loop (the big-wide chain's D = 3 at ds 1, with d a base
    plane skipping digit 0 or 2) on the built uint64 plan's C ranks: the
    barrier rules of ``check_schedule``, and the arrive before the last
    read caught."""
    C = _wide_plan(log_n).C
    check_schedule([ks_schedule(digits, own)] * C)
    if digits - (own >= 0) > 1:
        with pytest.raises(AssertionError, match="overwrite"):
            check_schedule([ks_schedule(digits, own, arrive_before_read=True)] * C)


# ── K10: a coefficient slab as a plane whose twiddles start at a lead ──


def emulate_tail(log_c: int, words: Words, slabs, moduli, degree: int, inverse: bool,
                 final=None):
    """K10's register forms on P int64 slabs (B, L, S): slab p on the plan
    of 2^log2 S words on C = 2^log_c blocks (0: one block) with lead P + p
    and the whole plane's tables (N = ``degree``), forward or inverse, then
    the optional per-channel ``final`` factors (on pass 0's words forward,
    on the cross pass's inverse); returns torch slabs of the plan's word."""
    P = len(slabs)
    B, L, S = slabs[0].shape
    fwd, fwdp, inv, invp = _tables(tuple(moduli), degree, words.bits)
    tabs = (_tile(inv, B), _tile(invp, B)) if inverse else (_tile(fwd, B), _tile(fwdp, B))
    q = np.tile(np.array(moduli, np.int64), B)[:, None, None, None]
    fin = None
    if final is not None:
        f = np.array([v % m for v, m in zip(final, moduli)], np.int64)
        col = lambda v: None if v is None else np.tile(v, B)[:, None, None, None]
        fin = (col(f), col(_companions(f, moduli, words)))
    dtype = np.int32 if words.bits == 32 else np.int64
    out = []
    for p, x in enumerate(slabs):
        plan = tail_plan(S.bit_length() - 1, log_c, words, P + p)
        x2 = x.reshape(B * L, S)
        if inverse:
            y = emulate_inverse(plan, x2, tabs, q, fin)
        else:
            a = emulate_forward(plan, x2, tabs, q)
            y = _unflatten(a if fin is None else _mul(a, *fin, q), _p0_positions(plan), S)
        out.append(torch.from_numpy(y.reshape(B, L, S).astype(dtype)))
    return tuple(out)


def tail_plan(log_s: int, log_c: int, words: Words, lead: int) -> Plan:
    """The plan of one K10 slab (a patchable seam for the mutation test)."""
    return Plan(log_s, log_c, words, lead)


def _tail_case(bits: int, shards: int, log_s: int, inverse: bool, final: bool, seed: int = 0):
    """One chain's P slabs of 2^log_s words (batch 1, one channel of a
    ``bits``-bit prime) as int64 numpy slabs, the torch slabs, the chain,
    N and the final factors (N^-1) or None."""
    degree = shards << log_s
    moduli = tuple(generate_primes(bits, 1, degree))
    x = _planes(seed + log_s + shards, moduli, degree, 1)
    S = 1 << log_s
    slabs = [x[..., p * S:(p + 1) * S].copy() for p in range(shards)]
    dtype = torch.int32 if bits < 32 else torch.int64
    fin = tuple(pow(degree, -1, q) for q in moduli) if final else None
    return slabs, tuple(torch.from_numpy(a).to(dtype) for a in slabs), moduli, degree, fin


# log2 C of K10's cluster form by log2 S, uint32 and uint64, as built
# (csrc/coeff_ntt.cuh kSlabLogCluster*; None where the size has none)
SLAB_LOG_C = {wide: {log_s: _header_constant(
    f"kSlabLogCluster{'Wide' if wide else ''}{log_s}", "coeff_ntt.cuh")
    for log_s in range(10, 16)} for wide in (False, True)}

# (word, log2 S, log2 C): one block on slabs of 2^10 (uint32 passes 5+5,
# uint64 4+3+3) and the built cluster on slabs of 2^12 (C = 4: slices of
# 2^10), for P = 1, 2, 4, 8: the slab's lead P + p in the cross pass and
# the slices
TAIL_FORMS = [(W32, 10, 0), (W32, 12, SLAB_LOG_C[False][12]), (W64, 10, 0),
              (W64, 12, SLAB_LOG_C[True][12])]


# (P, inverse, final): every direction with and without the final factor
# at P = 1 and 2, the coeff paths' forward without it and inverse with it
# at P = 4 and 8
TAIL_RUNS = [(shards, inverse, final) for shards in (1, 2, 4, 8)
             for inverse, final in ((False, False), (True, True), (True, False), (False, True))
             if shards <= 2 or inverse == final]


@pytest.mark.parametrize("words,log_s,log_c", TAIL_FORMS, ids=["u32-block", "u32-cluster4",
                                                               "u64-block", "u64-cluster4"])
@pytest.mark.parametrize("shards,inverse,final", TAIL_RUNS)
def test_tail_forms_match_twin(words, log_s, log_c, shards, inverse, final):
    """K10's one-block and cluster forms with each slab's lead against
    ``coeff_tail_twin`` word for word, forward and inverse, with and
    without the final factor (uint64 on 36-bit primes: the twin's
    bit-serial products cost time by the bit)."""
    slabs, tslabs, moduli, degree, fin = _tail_case(31 if words.bits == 32 else 36, shards,
                                                     log_s, inverse, final)
    got = emulate_tail(log_c, words, slabs, moduli, degree, inverse, fin)
    want = cg.coeff_tail_twin(tslabs, moduli, degree, inverse, fin)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_tail_lead_mutations_fail(monkeypatch):
    """The emulation catches a slice lead of C + r in place of (P + p) * C
    + r, and the cross pass's 2^l + g in place of ((P + p) << l) + g, at P
    = 4 on a cluster of 4 (uint64)."""
    slabs, tslabs, moduli, degree, _ = _tail_case(36, 4, 12, False, False)
    want = cg.coeff_tail_twin(tslabs, moduli, degree, False)
    assert all(torch.equal(g, w) for g, w in
               zip(emulate_tail(2, W64, slabs, moduli, degree, False), want))

    def slice_lead_dropped(log_s, log_c, words, lead):
        plan = Plan(log_s, log_c, words, lead)
        plan.local_twiddle = lambda kS, kR, kL, h, g: (
            ((plan.C + plan.r) << (kS + kL)) + ((plan.gid(h, kR) >> (plan.log_m - kS - kR))
                                                << kL) + g)
        return plan

    def cross_lead_dropped(log_s, log_c, words, lead):
        plan = Plan(log_s, log_c, words, lead)
        plan.cross_twiddle = lambda l, g: (1 << l) + g
        return plan

    for bad in (slice_lead_dropped, cross_lead_dropped):
        monkeypatch.setattr(sys.modules[__name__], "tail_plan", bad)
        got = emulate_tail(2, W64, slabs, moduli, degree, False)
        assert not all(torch.equal(g, w) for g, w in zip(got, want)), bad.__name__


# K10's form (``coeff_ntt_gpu.slab_form``) at the coeff paths' launches:
# (wide, log2 S, slabs in the launch, form, log2 C as built): (4, 4,
# 2^16) P 4 on clusters of 4, (4, 3, 2^15) uint64 P 4 on clusters of 8,
# (32, 8, 2^14) P 8 one block a slab; P 8 of the big chain and P 1 of the
# small one one block a slab (128 and 256 slabs); uint64 slabs of 2^14 on
# 8; below 2^10 the template
SLAB_FORMS = [(False, 14, 64, "cluster", 2), (True, 13, 48, "cluster", 3),
              (False, 11, 2048, "block", 0), (False, 13, 128, "block", 0),
              (False, 14, 256, "block", 0), (True, 14, 24, "cluster", 3),
              (False, 9, 8, "template", 0)]


@pytest.mark.parametrize("wide,log_s,slabs,form,log_c", SLAB_FORMS)
def test_slab_form_at_coeff_shapes(wide, log_s, slabs, form, log_c):
    assert cg.slab_form(wide, log_s, slabs) == form
    if form == "cluster":
        assert SLAB_LOG_C[wide][log_s] == log_c


def test_slab_form_mirror():
    """The rule in plain terms for every slab size and a range of launch
    sizes: the template below 2^10 words; a cluster for every uint64 slab
    of 2^13 or 2^14 (three passes of 16 words hold 12 stages) and for a
    slab of 2^12 words or more in a launch of fewer slabs than half of
    the card's 132 SMs; else one block a slab. Each form picked is built:
    a slab of at most 128 KiB; one block: at most what three passes hold;
    a cluster: the header's C (4 .. 16, at most the words a thread) for
    exactly the slabs of 2^12 words and up, slices of 2^10 words or more
    that three passes hold."""
    for wide in (False, True):
        words = W64 if wide else W32
        max_log_s = 14 if wide else 15
        for log_s in range(1, max_log_s + 1):
            log_c = SLAB_LOG_C[wide].get(log_s)
            assert (log_c is not None) == (log_s >= 12), (wide, log_s)
            for slabs in (1, 24, 48, 64, 65, 66, 67, 128, 132, 2048):
                if log_s < 10:
                    want = "template"
                elif log_s >= 12 and ((wide and log_s >= 13) or slabs < 132 // 2):
                    want = "cluster"
                else:
                    want = "block"
                got = cg.slab_form(wide, log_s, slabs)
                assert got == want, (wide, log_s, slabs)
                assert (words.bits // 8) << log_s <= 128 << 10
                if got == "block":
                    assert log_s <= 3 * words.log_w
                if got == "cluster":
                    assert 10 <= log_s - log_c <= 3 * words.log_w
                    assert 2 <= log_c and (1 << log_c) <= min(16, words.W)


def _conflicts(plan: Plan) -> dict:
    """{access kind: times the least wavefronts} of the plan's shared-memory
    accesses that take more than the least (``_wavefronts``); on one
    block (log2 C = 0) the passes alone: no scatter, no buffer."""
    phases = 32 * plan.words.bytes // 128
    worst = {}
    for name, slots in _accesses(plan):
        if plan.log_c == 0 and not name.startswith("pass"):
            continue
        kind = re.sub(r" (word|group|store|load) .*| \d+(, \d+)?$", "", name)
        for row in np.asarray(slots).reshape(plan.C, plan.T):
            for w in range(0, plan.T, 32):
                worst[kind] = max(worst.get(kind, 1), _wavefronts(row[w:w + 32], plan.words)
                                  // phases)
    return {k: v for k, v in worst.items() if v > 1}


# K10's forms at the coeff shapes and every uint64 form slab_form picks:
# (words, log2 S, log2 C, the accesses with bank conflicts and their ways).
# The uint32 middle passes keep ntt_reg.cuh's 2- to 4-way conflicts; a
# uint64 slice of 2^10 (passes 4 + 3 + 3) 2-way ones in its middle pass
TAIL_CONFLICTS = [(W32, 14, 2, {"pass (5, 4)": 2}), (W32, 11, 0, {"pass (5, 3)": 4}),
                  (W64, 13, 3, {"pass (4, 3)": 2}), (W64, 14, 3, {}),
                  (W64, 12, 2, {"pass (4, 3)": 2}), (W64, 12, 0, {}), (W64, 11, 0, {}),
                  (W64, 10, 0, {"pass (4, 3)": 2})]


@pytest.mark.parametrize("words,log_s,log_c,want", TAIL_CONFLICTS)
def test_tail_plan_bank_conflicts(words, log_s, log_c, want):
    assert _conflicts(Plan(log_s, log_c, words, lead=5)) == want


# ── K11: every cross stage of a transform in one launch ──

# the most shards the one-launch form takes, as built
STAGES_MAX_SHARDS = _header_constant("kStagesMaxShards", "coeff_ntt.cuh")


def stage_pairs(log_p: int, st: int) -> list:
    """(p, p + h, g) of cross stage st in ``cross_stages_kernel``: the
    slab pairs h = P >> (st + 1) apart, p & h == 0, and their twiddle's
    group g = p / (2h) (the per-stage kernel's (p S + i) >> (log2 d + 1))."""
    h = (1 << log_p) >> (st + 1)
    return [(p, p + h, p // (2 * h)) for p in range(1 << log_p) if not p & h]


def emulate_cross_stages(slabs, moduli, degree: int, inverse: bool, final=None,
                         words: Words = W32, pairs=stage_pairs, reverse: bool = False):
    """``cross_stages_kernel`` on P int64 numpy slabs (B, L, S): thread
    off = plane * S + i (every thread at once) holds x[p] = slab p's word
    off, runs stages 0 .. log2 P - 1 (inverse: log2 P - 1 .. 0; ``reverse``
    flips the order) on its registers with twiddle tw[ch, 2^st + g], ch =
    plane mod L, then the optional ``final`` factors, and writes x[p] to
    slab p; returns torch slabs of the word."""
    P = len(slabs)
    B, L, S = slabs[0].shape
    log_p, log_s = P.bit_length() - 1, S.bit_length() - 1
    fwd, fwdp, inv, invp = _tables(tuple(moduli), degree, words.bits)
    tw, twp = (inv, invp) if inverse else (fwd, fwdp)
    ch = (np.arange(B * L * S) >> log_s) % L
    q = np.array(moduli, np.int64)[ch]
    x = [s.reshape(-1).copy() for s in slabs]
    stages = list(range(log_p - 1, -1, -1) if inverse else range(log_p))
    for st in stages[::-1] if reverse else stages:
        for lo, hi, g in pairs(log_p, st):
            k = (1 << st) + g
            w, wp = tw[ch, k], None if twp is None else twp[ch, k]
            if inverse:
                x[lo], x[hi] = _add(x[lo], x[hi], q), _mul(_sub(x[lo], x[hi], q), w, wp, q)
            else:
                v = _mul(x[hi], w, wp, q)
                x[lo], x[hi] = _add(x[lo], v, q), _sub(x[lo], v, q)
    if final is not None:
        f = np.array([v % m for v, m in zip(final, moduli)], np.int64)
        fp = _companions(f, moduli, words)
        x = [_mul(a, f[ch], None if fp is None else fp[ch], q) for a in x]
    dtype = np.int32 if words.bits == 32 else np.int64
    return tuple(torch.from_numpy(a.reshape(B, L, S).astype(dtype)) for a in x)


def _stages_case(words: Words, shards: int, inverse: bool, final: bool):
    """P slabs of 2^4 words (batch 2, two channels of 31-bit or 36-bit
    primes) as int64 numpy and torch slabs, the chain, N and the final
    factors (N^-1) or None."""
    log_s = 4
    degree = shards << log_s
    moduli = tuple(generate_primes(31 if words.bits == 32 else 36, 2, degree))
    x = _planes(shards + 7 * inverse, moduli, degree, 2)
    S = 1 << log_s
    slabs = [x[..., p * S:(p + 1) * S].copy() for p in range(shards)]
    dtype = torch.int32 if words.bits == 32 else torch.int64
    fin = tuple(pow(degree, -1, q) for q in moduli) if final else None
    return slabs, tuple(torch.from_numpy(a).to(dtype) for a in slabs), moduli, degree, fin


# (P, inverse, final): every P the one-launch form takes, forward bare and
# inverse with the final factor (coeff_ntt's two calls), and the inverse
# bare and the forward with the factor at P = 4
STAGES_RUNS = [(shards, inverse, final) for shards in (2, 4, 8, 16)
               for inverse, final in ((False, False), (True, True), (True, False),
                                      (False, True))
               if shards == 4 or inverse == final]


def test_stages_bound_as_built():
    assert STAGES_MAX_SHARDS == cg.STAGES_MAX_SHARDS == 16


@pytest.mark.parametrize("words", [W32, W64], ids=["u32", "u64"])
@pytest.mark.parametrize("shards,inverse,final", STAGES_RUNS)
def test_cross_stages_plan_matches_per_stage_twins(words, shards, inverse, final):
    """K11's one-launch plan (a thread per offset, the P words in its
    registers, the stages' pairs, sides and twiddles, ``final`` on the
    last stage's words) word for word against the per-stage twins
    composed (``coeff_cross_twin`` stage by stage) and against
    ``coeff_cross_stages`` on CPU slabs."""
    slabs, tslabs, moduli, degree, fin = _stages_case(words, shards, inverse, final)
    got = emulate_cross_stages(slabs, moduli, degree, inverse, fin, words)
    want = tslabs
    log_p = shards.bit_length() - 1
    stages = list(range(log_p - 1, -1, -1) if inverse else range(log_p))
    for st in stages:
        want = cg.coeff_cross_twin(want, moduli, degree, st, inverse,
                                   fin if st == stages[-1] else None)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    wrapped = cg.coeff_cross_stages(tslabs, moduli, degree, inverse, fin)
    assert all(torch.equal(g, w) for g, w in zip(wrapped, want))


def test_cross_stages_plan_mutations_fail():
    """The emulation catches a twiddle group p / h for p / (2h), the
    sides of a butterfly swapped, the stages run in the wrong order and a
    dropped final factor, at P = 8 (uint64), forward and inverse."""
    wrong_group = lambda log_p, st: [(lo, hi, lo // (hi - lo)) for lo, hi, _ in
                                     stage_pairs(log_p, st)]
    swapped = lambda log_p, st: [(hi, lo, g) for lo, hi, g in stage_pairs(log_p, st)]
    for inverse in (False, True):
        slabs, tslabs, moduli, degree, fin = _stages_case(W64, 8, inverse, True)
        want = cg.coeff_cross_stages_twin(tslabs, moduli, degree, inverse, fin)
        good = emulate_cross_stages(slabs, moduli, degree, inverse, fin, W64)
        assert all(torch.equal(g, w) for g, w in zip(good, want))
        for name, kwargs in (("group", dict(pairs=wrong_group)),
                             ("sides", dict(pairs=swapped)), ("order", dict(reverse=True))):
            got = emulate_cross_stages(slabs, moduli, degree, inverse, fin, W64, **kwargs)
            assert not all(torch.equal(g, w) for g, w in zip(got, want)), (name, inverse)
        got = emulate_cross_stages(slabs, moduli, degree, inverse, None, W64)
        assert not all(torch.equal(g, w) for g, w in zip(got, want)), ("final", inverse)


def test_cross_stages_twin_refuses_one_shard():
    slabs, tslabs, moduli, degree, _ = _stages_case(W32, 2, False, False)
    one = (torch.cat(tslabs, dim=-1),)
    with pytest.raises(ValueError, match="no cross stage"):
        cg.coeff_cross_stages(one, moduli, degree, False)
    with pytest.raises(ValueError, match="no cross stage"):
        cg.coeff_cross_stages_twin(one, moduli, degree, True)
