"""The cluster register-pass plan of K4 and K3 / K3' at N = 2^16, in numpy.

``csrc/ntt_cluster.cuh`` spreads one uint32 plane of N words over a
thread-block cluster of C blocks (rank r holds the slice [r*M, (r+1)*M),
M = N/C, N/32/C threads of 32 words). This file emulates that plan index
for index, with the kernels' own maps, and holds it word for word to the
port's twins (``ops/ntt.py``, ``moddown_gpu.mod_down_combine_twin``) at
N = 2^16 for C in {4, 8, 16}, and at N = 2^12, C = 4 to the JAX
reference's staged NTT (``toy_heaan_ckks_tpu/ops/ntt.py``) on the CPU:

- forward cross pass: thread t of rank r holds groups h < 32/C, group h
  the C words j + k*M (j = r*M/C + h*T + t), and runs stages 0 .. log2 C
  - 1 on them with twiddles tw[2^l + g] (``cross_groups``);
- the scatter: word k of group j to rank k's shared memory at pad(j),
  a permutation of the slots (``scatter_forward``);
- the local passes: ``RegPass`` of a 2^(16 - log2 C) plane, the twiddle of
  local stage s' = kS + kL and group g at (C + r) * 2^s' + blk * 2^kL + g
  (``local_forward``), then pass 0's layout for a coalesced store;
- the inverse in reverse: the last local pass loaded as runs of adjacent
  words, the Gentleman-Sande passes down to pass 0, each word sent to its
  cross-pass owner at k * M/C + (j mod M/C) (``scatter_inverse``), the
  cross pass from stage log2 C - 1 down, and the final constant;
- K3: the Phat sum in the cross pass's loads, the combine in pass 0's
  layout (without the t term for K3').

The emulator lives here, not in the port; the card holds the CUDA kernels
to the same twins (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from toy_heaan_ckks_tpu import CkksContext as RefContext
from toy_heaan_ckks_tpu.ops import ntt as ref_ntt

from toy_heaan_ckks_tpu_torch import convert, generate_primes
from toy_heaan_ckks_tpu_torch.ops import moddown_gpu, ntt_gpu
from toy_heaan_ckks_tpu_torch.ops.ntt import compact_twiddles
from toy_heaan_ckks_tpu_torch.ops.small_fast import _fold_consts

LOG_WORDS = 5  # a thread holds 32 words


def pad(p):
    """Shared-memory word of slice position p: one pad word per 32."""
    return p + (p >> 5)


class Plan:
    """The index maps of one plane of 2^log_n words on C = 2^log_c blocks."""

    def __init__(self, log_n: int, log_c: int):
        self.log_n, self.log_c = log_n, log_c
        self.C = 1 << log_c
        self.log_m = log_n - log_c
        self.M = 1 << self.log_m
        self.T = self.M >> LOG_WORDS  # threads a block
        self.GX = 32 >> log_c  # cross-pass groups a thread
        self.MC = self.M >> log_c  # cross-pass groups a rank (T * GX)
        rest = self.log_m - LOG_WORDS
        r1 = rest if rest <= LOG_WORDS else (rest + 1) // 2
        # (kS, kR) of the local passes: RegPlan<log_m>
        self.passes = [(0, LOG_WORDS), (LOG_WORDS, r1)]
        if rest > r1:
            self.passes.append((LOG_WORDS + r1, rest - r1))
        # rank, thread grids broadcast against (planes, C, T)
        self.r = np.arange(self.C)[:, None]
        self.t = np.arange(self.T)[None, :]

    # ── the cross pass ──────────────────────────────────────────────────
    def cross_j(self, h: int):
        """Group index j of (rank, thread, group h): (C, T)."""
        return self.r * self.MC + h * self.T + self.t

    def cross_positions(self):
        """Plane position of word (rank, thread, h * C + k): (C, T, 32)."""
        out = np.empty((self.C, self.T, 32), np.int64)
        for h in range(self.GX):
            for k in range(self.C):
                out[:, :, h * self.C + k] = self.cross_j(h) + k * self.M
        return out

    def cross_twiddle(self, l: int, g: int) -> int:
        """Table entry of cross stage l, group g (the same for every thread)."""
        return (1 << l) + g

    # ── the local passes: RegPass<log_m, kS, kR> ────────────────────────
    def gid(self, h: int, kR: int):
        return self.t + (h << (self.log_m - LOG_WORDS))

    def slots(self, kS: int, kR: int):
        """Shared-memory word of (thread, h * 2^kR + m): RegPass::base +
        pad(m << kLogOff), (T, 32)."""
        log_off = self.log_m - kS - kR
        out = np.empty((self.T, 32), np.int64)
        for h in range(32 >> kR):
            g = self.gid(h, kR)[0]
            base = pad(((g >> log_off) << (self.log_m - kS)) + (g & ((1 << log_off) - 1)))
            for m in range(1 << kR):
                out[:, (h << kR) + m] = base + pad(m << log_off)
        return out

    def local_twiddle(self, kS: int, kR: int, kL: int, h: int, g: int):
        """Table entry of local stage kS + kL, group g of group h: (C, T)."""
        log_off = self.log_m - kS - kR
        blk = self.gid(h, kR) >> log_off
        return ((self.C + self.r) << (kS + kL)) + (blk << kL) + g


def _stages(a, tw, q, kR: int, twiddle, inverse: bool):
    """Butterflies of one register pass on a (planes, C, T, 32): RegPass
    / RegPassInv's loops, twiddle(kL, h, g) the table entry."""
    order = range(kR - 1, -1, -1) if inverse else range(kR)
    q = q.reshape(-1, 1, 1)
    for h in range(32 >> kR):
        for kL in order:
            half = 1 << (kR - 1 - kL)
            for g in range(1 << kL):
                w = np.take_along_axis(tw, _flat(twiddle(kL, h, g), a), axis=-1)
                w = w.reshape(a.shape[:-1])
                for i in range(half):
                    u = (h << kR) + 2 * half * g + i
                    xu, xv = a[..., u].copy(), a[..., u + half].copy()
                    if inverse:
                        a[..., u] = (xu + xv) % q
                        a[..., u + half] = (xu - xv) % q * w % q
                    else:
                        xv = xv * w % q
                        a[..., u] = (xu + xv) % q
                        a[..., u + half] = (xu - xv) % q


def _flat(index, a):
    """A twiddle index (scalar or (C, T)) as (planes, C*T) gather indices."""
    idx = np.broadcast_to(np.asarray(index), a.shape[1:3]).reshape(1, -1)
    return np.broadcast_to(idx, (a.shape[0], idx.shape[1]))


def scatter_forward(plan: Plan):
    """(rank, slot) each cross-pass word (rank r, thread t, h * C + k) is
    written to: rank k's shared memory at pad(j)."""
    dst_rank = np.empty((plan.C, plan.T, 32), np.int64)
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
    p = np.arange(32)[None, None, :] * plan.T + plan.t[:, :, None]
    owner = np.broadcast_to(p >> (plan.log_m - plan.log_c), (plan.C, plan.T, 32))
    slot = plan.r[:, :, None] * plan.MC + (p & (plan.MC - 1))
    return owner, np.broadcast_to(slot, (plan.C, plan.T, 32))


def _exchange(a, dst_rank, dst_slot, size: int):
    """Write a (planes, C, T, 32) to per-rank buffers (planes, C, size),
    each slot written at most once."""
    buf = np.full((a.shape[0], a.shape[1], size), -1, np.int64)
    flat = (dst_rank * size + dst_slot).reshape(-1)
    assert len(np.unique(flat)) == flat.size, "two words to one slot"
    buf.reshape(a.shape[0], -1)[:, flat] = a.reshape(a.shape[0], -1)
    return buf


def _local_forward(plan: Plan, s, tw, q):
    """The forward local passes from the scattered slices s (planes, C,
    pad(M)); returns a[] in pass 0's layout (word m at m * T + t)."""
    a = None
    for kS, kR in plan.passes:
        slot = plan.slots(kS, kR)
        a = np.take_along_axis(s, np.broadcast_to(slot.reshape(1, 1, -1), s.shape[:2] + (slot.size,)),
                               axis=-1).reshape(s.shape[:2] + slot.shape)
        assert (a >= 0).all(), "a slot read before it was written"
        _stages(a, tw, q, kR, lambda kL, h, g, kS=kS, kR=kR:
                plan.local_twiddle(kS, kR, kL, h, g), inverse=False)
        s = s.copy()
        np.put_along_axis(s, np.broadcast_to(slot.reshape(1, 1, -1), s.shape[:2] + (slot.size,)),
                          a.reshape(s.shape[:2] + (-1,)), axis=-1)
    # the last pass's runs back to pass 0's layout
    slot = plan.slots(*plan.passes[0])
    return np.take_along_axis(s, np.broadcast_to(slot.reshape(1, 1, -1), s.shape[:2] + (slot.size,)),
                              axis=-1).reshape(s.shape[:2] + slot.shape)


def _p0_positions(plan: Plan):
    """Plane position of pass 0's word (rank, thread, m): r*M + m*T + t."""
    return (plan.r[:, :, None] * plan.M + np.arange(32)[None, None, :] * plan.T
            + plan.t[:, :, None])


def _unflatten(a, pos, n: int):
    """Per-plane words a (planes, C, T, 32) at plane positions pos ->
    (planes, n), each position written once."""
    out = np.full((a.shape[0], n), -1, np.int64)
    flat = pos.reshape(-1)
    assert np.array_equal(np.sort(flat), np.arange(n)), "positions not a permutation"
    out[:, flat] = a.reshape(a.shape[0], -1)
    return out


def emulate_forward(plan: Plan, x, tw, q, prologue=None):
    """Forward NTT of x (planes, N) with twiddle rows tw (planes, N) and
    moduli q (planes, 1, 1, 1). ``prologue(pos)``: the cross pass's loads
    (default x at pos). Returns (planes, C, T, 32) in pass 0's layout."""
    pos = plan.cross_positions()
    a = x[:, pos] if prologue is None else prologue(pos)
    _stages(a, tw, q, plan.log_c, lambda kL, h, g: plan.cross_twiddle(kL, g),
            inverse=False)
    s = _exchange(a, *scatter_forward(plan), pad(plan.M))
    return _local_forward(plan, s, tw, q)


def emulate_inverse(plan: Plan, x, tw, q, fin):
    """Inverse NTT of x (planes, N), final per-plane constant fin
    (planes, 1, 1, 1); returns (planes, N)."""
    kS_last, kR_last = plan.passes[-1]
    # load_runs: group h of thread t, the run of 2^kR words at gid << kR
    run = np.empty((plan.C, plan.T, 32), np.int64)
    for h in range(32 >> kR_last):
        for i in range(1 << kR_last):
            run[:, :, (h << kR_last) + i] = (plan.r * plan.M
                                             + (plan.gid(h, kR_last) << kR_last) + i)
    assert np.array_equal(plan.slots(kS_last, kR_last)[None] - pad(run - plan.r[:, :, None] * plan.M),
                          np.zeros_like(run)), "runs are not the last pass's words"
    a = x[:, run]
    s = np.full(a.shape[:2] + (pad(plan.M),), -1, np.int64)
    for idx, (kS, kR) in enumerate(reversed(plan.passes)):
        slot = plan.slots(kS, kR)
        if idx:
            a = np.take_along_axis(s, np.broadcast_to(slot.reshape(1, 1, -1), s.shape[:2] + (slot.size,)),
                                   axis=-1).reshape(s.shape[:2] + slot.shape)
            assert (a >= 0).all()
        _stages(a, tw, q, kR, lambda kL, h, g, kS=kS, kR=kR:
                plan.local_twiddle(kS, kR, kL, h, g), inverse=True)
        if kS:
            np.put_along_axis(s, np.broadcast_to(slot.reshape(1, 1, -1), s.shape[:2] + (slot.size,)),
                              a.reshape(s.shape[:2] + (-1,)), axis=-1)
    xs = _exchange(a, *scatter_inverse(plan), plan.M)
    # the cross pass: word k of group h at k * M/C + h * T + t
    b = np.empty_like(a)
    for h in range(plan.GX):
        for k in range(plan.C):
            b[:, :, :, h * plan.C + k] = xs[:, :, k * plan.MC + h * plan.T + plan.t[0]]
    _stages(b, tw, q, plan.log_c, lambda kL, h, g: plan.cross_twiddle(kL, g),
            inverse=True)
    return _unflatten(b * fin % q, plan.cross_positions(), 1 << plan.log_n)


def _tables(moduli, degree):
    fwd, inv = compact_twiddles(tuple(moduli), degree)
    return fwd.astype(np.int64), inv.astype(np.int64)


def _planes(seed, moduli, degree, batch):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=(batch, degree), dtype=np.int64)
                     for q in moduli], axis=1)  # (batch, L, N)


def _ntt(plan: Plan, x3, moduli, inverse: bool, final=None):
    """Emulated NTT of int64 (B, L, N) planes; returns int32 torch."""
    B, L, n = x3.shape
    fwd, inv = _tables(moduli, n)
    tw = np.tile(inv if inverse else fwd, (B, 1))  # (B*L, N)
    q = np.tile(np.array(moduli, np.int64), B)[:, None, None, None]
    x = x3.reshape(B * L, n)
    if inverse:
        f = final or tuple(pow(n, -1, m) for m in moduli)
        fin = np.tile(np.array([v % m for v, m in zip(f, moduli)], np.int64), B)
        out = emulate_inverse(plan, x, tw, q, fin[:, None, None, None])
    else:
        out = _unflatten(emulate_forward(plan, x, tw, q), _p0_positions(plan), n)
    return torch.from_numpy(out.reshape(B, L, n).astype(np.int32))


PLANS = [(16, 2), (16, 3), (16, 4)]  # C = 4, 8, 16 at N = 2^16


@pytest.mark.parametrize("log_n,log_c", PLANS)
def test_scatters_are_permutations(log_n, log_c):
    """Each cross-pass word reaches one slot of one rank, every slot that
    the next pass reads is written, and no two words share one."""
    plan = Plan(log_n, log_c)
    rank, slot = scatter_forward(plan)
    flat = rank * pad(plan.M) + slot
    read = np.unique(plan.slots(*plan.passes[0]))
    assert np.array_equal(np.unique(flat), np.unique(
        np.arange(plan.C)[:, None] * pad(plan.M) + read[None, :]))
    assert len(np.unique(flat)) == flat.size == 1 << log_n
    owner, slot = scatter_inverse(plan)
    flat = (owner * plan.M + slot).reshape(-1)
    assert np.array_equal(np.sort(flat), np.arange(1 << log_n))


@pytest.mark.parametrize("log_n,log_c", PLANS)
def test_local_twiddles_are_the_planes(log_n, log_c):
    """(C + r) * 2^s' + blk * 2^kL + g is the whole plane's entry 2^s + g
    of global stage s = log2 C + s' for the butterfly's global group."""
    plan = Plan(log_n, log_c)
    for kS, kR in plan.passes:
        log_off = plan.log_m - kS - kR
        for kL in range(kR):
            s = log_c + kS + kL
            for h in range(32 >> kR):
                gid = plan.gid(h, kR)
                blk = gid >> log_off
                for g in range(1 << kL):
                    # the butterfly's u word: local position of (blk, g, i=0)
                    local = ((blk << (plan.log_m - kS))
                             + (g << (plan.log_m - kS - kL)) + (gid & ((1 << log_off) - 1)))
                    glob = plan.r * plan.M + local
                    want = (1 << s) + (glob >> (log_n - s))
                    assert np.array_equal(plan.local_twiddle(kS, kR, kL, h, g), want)


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


@pytest.mark.parametrize("log_n,log_c", PLANS)
@pytest.mark.parametrize("with_t", [True, False])
def test_moddown_plan_matches_twin(log_n, log_c, with_t):
    """K3 (t) / K3' (no t): the Phat sum of G = 2 yhat planes in the cross
    pass's loads, the forward plan, the combine in pass 0's layout,
    against ``mod_down_combine_twin`` for 2 kept channels, batch 1."""
    n = 1 << log_n
    plan = Plan(log_n, log_c)
    primes = tuple(generate_primes(30, 4, n))
    child, dropped = primes[:2], primes[2:]
    t_scale = 987654321 if with_t else 0
    c, _, pm, _, pinv, _, _ = moddown_gpu._down_consts(child, dropped, n, t_scale)
    c, pm, pinv = (v.astype(np.int64) for v in (c, pm, pinv))
    yhat = _planes(1, dropped, n, 1)[0]  # (G, N)
    ks = _planes(2, child, n, 1)[0]
    t = _planes(3, child, n, 1)[0]
    fwd, _ = _tables(child, n)
    q = np.array(child, np.int64)[:, None, None, None]

    def phat(pos):  # sum_m Harvey(yhat_m[pos], c[m, j]) per kept channel j
        acc = np.zeros((len(child),) + pos.shape, np.int64)
        for m in range(len(dropped)):
            acc = (acc + yhat[m][pos][None] * c[m][:, None, None, None]) % q
        return acc

    ext = emulate_forward(plan, None, fwd, q, prologue=phat)
    pos = _p0_positions(plan)
    head = ks[:, pos]
    if with_t:
        head = (head + t[:, pos] * pm[:, None, None, None]) % q
    out = (head - ext) % q * pinv[:, None, None, None] % q
    got = torch.from_numpy(_unflatten(out, pos, n).astype(np.int32))
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))
    want = moddown_gpu.mod_down_combine_twin(
        i32(yhat), i32(ks), i32(t) if with_t else None, child, dropped, n, t_scale)
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
