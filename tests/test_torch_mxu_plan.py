"""K9's channel-run plan (``csrc/ntt_mxu.cu`` ``ntt_mxu_run_kernel``) in
numpy, held word for word to the port's twin ``ntt_mxu.ntt_mxu``.

The kernel runs the matrix-product NTT of planes of N = R * 128 words (R
= 8 .. 128; R = 256 keeps the plane-per-block kernel) on blocks of 16
warps, each block one channel and a run of that channel's planes. This
file emulates it index for index, with the kernel's own maps:

- the grid: block b is channel b / runs and items [r * run, (r + 1) *
  run) of it, r = b mod runs (``block_planes``);
- shared memory: S + 2 slots of four 2048-byte limb planes (S = Rp / 16
  stripes, Rp = max(R, 32)), input stripe k in slot k + 2 and middle
  stripe k in slot k, then both matrices' u8 limbs, copied once a block
  (``matrix_offset``: 16-byte chunks XOR-permuted by the row, ``swz``);
- the first product, stripe by stripe: warp -> tile, the operand the warp
  uses in every stripe (the matrix rows of its tile) held in registers
  for the plane, the other read from the stripe's slot; the fold, REDC
  and twist; the middle limbs stored as 16-bit pairs (the inverse's
  after an exchange with lane ^ 4, ``pack_inverse``);
- the stripe hand-off without a block barrier: each warp arrives on
  mbarrier[g mod 2] after stripe g's products and, before it writes
  stripe g's middle limbs over stripe g - 2's input, waits for every
  warp's arrival on g - 2 (``stripe_wait``); the warps run in any order
  the barriers allow (a random schedule and one that lets the lowest warp
  run ahead), and an arrival on a phase before the last one completed is
  caught;
- the second product: warp -> column tile, its eight columns' operand held
  in registers across the row tiles, the other read from shared memory,
  two words a 64-bit store.

mma.sync m16n8k32 (u8 x u8 -> s32) is emulated on the registers' bytes
(A: row g / g + 8, k 4t .. 4t + 3 and + 16; B: k 4t .. 4t + 3 and + 16,
column g; C: row g / g + 8, column 2t, 2t + 1). The card holds the CUDA
kernel to the same twin and to K1 (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import functools
import random
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from toy_heaan_ckks_tpu_torch import generate_primes
from toy_heaan_ckks_tpu_torch.ops import ntt_mxu
from toy_heaan_ckks_tpu_torch.ops.small_fast import _dec_inv_ints

SOURCE = Path(ntt_mxu.__file__).parent.parent / "csrc" / "ntt_mxu.cu"


def _constant(name: str) -> int:
    """An int constant of ``csrc/ntt_mxu.cu`` (the plan as built)."""
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


LIMBS, FOLDS, LANES = 4, 7, 128
WARPS = _constant("kWarps")
STRIPE = _constant("kStripe")
SLOT = LIMBS * STRIPE
IN_SLOT = _constant("kInSlot")  # input stripe k sits in slot k + IN_SLOT
MAX_RUN_ROWS = _constant("kRunMaxRows")


def swz(row, col, width: int):
    """Byte of (row, col) in a limb plane of rows of ``width`` bytes (32 ..
    128): the row's 16-byte chunks XOR-permuted by the row, so that a
    fragment load (8 rows x 4 consecutive words) hits 32 distinct banks
    (the kernel's ``swz``)."""
    words = width >> 2
    x = (row & 7) << 2 if words >= 32 else ((row // (32 // words)) & ((words >> 2) - 1)) << 2
    return row * width + (((col >> 2) ^ x) << 2) + (col & 3)


def matrix_offset(row, col, k: int):
    """Byte of (row, col) of a K x K matrix limb in shared memory."""
    return swz(row, col, k)


def stripe_wait(g: int) -> int | None:
    """The stripe whose arrivals a warp waits for before it writes stripe
    g's middle limbs (None: the plane's first two stripes, ordered by the
    block barrier after the load)."""
    return g - 2


def block_planes(outer: int, channels: int, run: int) -> list:
    """[(channel, items)] of each block: ceil(outer / run) runs a channel,
    channel-major."""
    runs = -(-outer // run)
    return [(b // runs, range((b % runs) * run, min(outer, (b % runs + 1) * run)))
            for b in range(channels * runs)]


def run_planes(outer: int, channels: int, sms: int = 132) -> int:
    """Planes a block when the grid fills ``sms`` SMs: ceil(planes / SMs)."""
    return max(1, -(-outer * channels // sms))


# ── the warp's registers: mma.sync m16n8k32 fragments ──

LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


@functools.lru_cache(maxsize=None)
def a_coords(m0: int, kb: int):
    """(row, k) of each (lane, register, byte) of an A fragment."""
    rows = m0 + G[:, None] + 8 * (np.arange(4)[None, :] & 1)
    ks = kb + 4 * T[:, None] + 16 * (np.arange(4)[None, :] >> 1)
    return rows[:, :, None] + 0 * np.arange(4), ks[:, :, None] + np.arange(4)


@functools.lru_cache(maxsize=None)
def b_coords(n0: int, kb: int):
    """(n, k) of each (lane, register, byte) of a B fragment."""
    ns = n0 + G[:, None] + 0 * np.arange(2)[None, :]
    ks = kb + 4 * T[:, None] + 16 * np.arange(2)[None, :]
    return ns[:, :, None] + 0 * np.arange(4), ks[:, :, None] + np.arange(4)


def load_frag(smem, base: int, rows, ks, offset) -> np.ndarray:
    """The bytes (lane, register, byte) that lds32 / ldg32 at
    ``base + offset(row, k)`` puts in each register (4 consecutive k)."""
    addr = base + offset(rows[..., 0], ks[..., 0])
    assert np.all(addr % 4 == 0), "unaligned 32-bit load"
    return smem[addr[..., None] + np.arange(4)]


_A_ROWS, _A_KS = a_coords(0, 0)
_B_NS, _B_KS = b_coords(0, 0)


def mma(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> None:
    """acc[i + j] += A_i B_j for limbs i, j: ``mma_limbs``. a: (LIMBS, 32,
    4, 4) bytes, b: (LIMBS, 32, 2, 4); acc: (FOLDS, 32, 4) as the C
    fragment (row g / g + 8, column 2t, 2t + 1)."""
    A = np.zeros((LIMBS, 16, 32), np.int64)
    A[:, _A_ROWS, _A_KS] = a
    B = np.zeros((LIMBS, 8, 32), np.int64)
    B[:, _B_NS, _B_KS] = b
    C = np.einsum("iak,jck->ijac", A, B)
    frag = np.stack([C[..., G, 2 * T], C[..., G, 2 * T + 1], C[..., G + 8, 2 * T],
                     C[..., G + 8, 2 * T + 1]], axis=-1)  # (LIMBS, LIMBS, 32, 4)
    for i in range(LIMBS):
        acc[i:i + LIMBS] += frag[i]


def fold_redc(acc, rs, q: int, qinv: int) -> np.ndarray:
    """(32, 4) canonical residues of sum_s P_s rs[s] * 2^-32 mod q."""
    s = np.zeros(acc.shape[1:], np.uint64)
    for f in range(FOLDS):
        s += acc[f].astype(np.uint64) * np.uint64(rs[f])
    m = (s & np.uint64(0xFFFFFFFF)) * np.uint64(qinv) & np.uint64(0xFFFFFFFF)
    r = (s + m * np.uint64(q)) >> np.uint64(32)
    assert np.all(acc < 1 << 27) and np.all(s < np.uint64(1 << 61))
    return np.where(r >= q, r - q, r).astype(np.uint64)


def harvey(x, t, tp, q: int):
    h = (x * tp) >> np.uint64(32)
    r = (x * t - h * np.uint64(q)) & np.uint64(0xFFFFFFFF)
    return np.where(r >= q, r - q, r)


def pack_inverse(v: np.ndarray):
    """The inverse's middle words of a C fragment (32, 4) as (col offset,
    row base, lo, hi) pairs of adjacent rows: the even-g lane keeps column
    2t and takes rows g, g + 1 (g + 8, g + 9) from itself and lane ^ 4;
    the odd one column 2t + 1 (``__shfl_xor_sync(.., 4)``)."""
    odd = (G & 1).astype(bool)
    send0 = np.where(odd, v[:, 0], v[:, 1])
    send1 = np.where(odd, v[:, 2], v[:, 3])
    recv0, recv1 = send0[LANE ^ 4], send1[LANE ^ 4]
    lo0 = np.where(odd, recv0, v[:, 0])
    hi0 = np.where(odd, v[:, 1], recv0)
    lo1 = np.where(odd, recv1, v[:, 2])
    hi1 = np.where(odd, v[:, 3], recv1)
    return odd.astype(int), G & ~1, (lo0, hi0), (lo1, hi1)


def store16(smem, base, off, lo, hi) -> None:
    """A 16-bit store of each limb of a pair of words: byte i of lo, byte i
    of hi at limb i's ``off``."""
    assert np.all(off % 2 == 0), "unaligned 16-bit store"
    for i in range(LIMBS):
        smem[base + i * STRIPE + off] = (lo >> np.uint64(8 * i)) & np.uint64(0xFF)
        smem[base + i * STRIPE + off + 1] = (hi >> np.uint64(8 * i)) & np.uint64(0xFF)


class Block:
    """One block of the kernel: its shared memory and the programs of its
    warps (generators that yield at every point another warp may run)."""

    def __init__(self, x, out, tabs, ch: int, items, inverse: bool):
        self.x, self.out, self.ch, self.items, self.inverse = x, out, ch, items, inverse
        self.rows = tabs.rows
        self.rp = max(self.rows, 32)
        self.stripes = self.rp // 16
        self.width = STRIPE // self.rp  # the forward stripe's columns
        self.k1, self.k2 = (LANES, self.rp) if inverse else (self.rp, LANES)
        self.w1 = (self.stripes + IN_SLOT) * SLOT
        self.w2 = self.w1 + LIMBS * self.k1 * self.k1
        self.smem = np.zeros(self.w2 + LIMBS * self.k2 * self.k2, np.uint8)
        u32 = lambda t: t.numpy().view(np.uint32).astype(np.uint64)
        self.t, self.tp = u32(tabs.t[ch]), u32(tabs.t_shoup[ch])
        self.rs = u32(tabs.rs[ch])
        self.q, self.qinv = int(u32(tabs.q)[ch]), int(u32(tabs.qinv)[ch])
        # the matrices' limbs, copied once a block (16-byte chunks)
        for base, w, k in ((self.w1, tabs.w_first, self.k1), (self.w2, tabs.w_second, self.k2)):
            limbs = w[ch].numpy()
            r, c = np.meshgrid(np.arange(k), np.arange(0, k, 16), indexing="ij")
            for j in range(LIMBS):
                dst = base + j * k * k + matrix_offset(r, c, k)
                assert np.all(dst % 16 == 0)
                self.smem[dst[..., None] + np.arange(16)] = (
                    limbs[j][r[..., None], c[..., None] + np.arange(16)])
        self.arrived = {}  # stripe -> warps arrived on its mbarrier phase

    # ── a plane's input: split into limbs, in the first product's layout ──

    def load(self, warp: int, item: int) -> None:
        src = self.x[item, self.ch].astype(np.uint64)
        rows, rp = self.rows, self.rp
        for idx in range(warp * 32, 32 * rp, WARPS * 32):
            idx = idx + LANE
            if not self.inverse:  # X^T: four consecutive rows b of column c
                c, b = idx % LANES, 4 * (idx // LANES)
                wd = [np.where(b + i < rows, src[np.minimum(b + i, rows - 1) * LANES + c], 0)
                      for i in range(4)]
                slot, off = IN_SLOT + c // self.width, swz(c % self.width, b, rp)
            else:  # X: four consecutive lanes b of row r
                b, r = 4 * (idx % 32), idx // 32
                wd = [np.where(r < rows, src[np.minimum(r, rows - 1) * LANES + b + i], 0)
                      for i in range(4)]
                slot, off = IN_SLOT + r // 16, swz(r % 16, b, LANES)
            words = np.stack(wd, axis=-1)  # (lane, e): byte i of word e is limb i's byte e
            addr = (slot * SLOT + off)[:, None, None] + STRIPE * np.arange(LIMBS)[:, None] \
                + np.arange(4)
            self.smem[addr] = ((words[:, None, :] >> (np.uint64(8) * np.arange(
                LIMBS, dtype=np.uint64))[:, None]) & np.uint64(0xFF))

    # ── the first product's operand held for the plane, the streamed one ──

    def held_first(self, warp: int):
        if not self.inverse:  # the rows of Wr of the warp's tile
            m0 = (warp % (self.rp // 16)) * 16
            return [np.stack([load_frag(self.smem, self.w1 + j * self.k1 ** 2,
                                        *a_coords(m0, kb),
                                        lambda r, k: matrix_offset(r, k, self.k1))
                              for j in range(LIMBS)]) for kb in range(0, self.rp, 32)]
        n0 = warp * 8  # the rows of Wc* of the warp's eight columns
        return [np.stack([load_frag(self.smem, self.w1 + j * self.k1 ** 2, *b_coords(n0, kb),
                                    lambda r, k: matrix_offset(r, k, self.k1))
                          for j in range(LIMBS)]) for kb in range(0, LANES, 32)]

    def tile_first(self, warp: int) -> tuple:
        if not self.inverse:
            mtiles = self.rp // 16
            return (warp % mtiles) * 16, (warp // mtiles) * 8
        return 0, warp * 8

    def first(self, warp: int, k: int, held) -> np.ndarray:
        """Stripe k's products of the warp: the accumulators (FOLDS, 32, 4)."""
        acc = np.zeros((FOLDS, 32, 4), np.int64)
        base = (k + IN_SLOT) * SLOT
        m0, n0 = self.tile_first(warp)
        for kk, kb in enumerate(range(0, self.k1, 32)):
            if not self.inverse:
                b = np.stack([load_frag(self.smem, base + i * STRIPE, *b_coords(n0, kb),
                                        lambda r, c: swz(r, c, self.rp)) for i in range(LIMBS)])
                mma(acc, held[kk], b)
            else:
                a = np.stack([load_frag(self.smem, base + i * STRIPE, *a_coords(0, kb),
                                        lambda r, c: swz(r, c, LANES)) for i in range(LIMBS)])
                mma(acc, a, held[kk])
        return acc

    def epilogue_first(self, warp: int, k: int, acc) -> None:
        """Fold, twist and store stripe k's words as the second product's
        middle limbs in slot k."""
        v = fold_redc(acc, self.rs, self.q, self.qinv)
        m0, n0 = self.tile_first(warp)
        for e in range(4):
            lr, lc = m0 + G + 8 * (e >> 1), n0 + 2 * T + (e & 1)
            row = 16 * k + lr if self.inverse else lr
            col = lc if self.inverse else k * self.width + lc
            pos = np.minimum(row, self.rows - 1) * LANES + col
            v[:, e] = np.where(row < self.rows,
                               harvey(v[:, e], self.t[pos], self.tp[pos], self.q), v[:, e])
        mid = k * SLOT
        if not self.inverse:
            for half in range(2):
                off = (m0 + G + 8 * half) * self.width + n0 + 2 * T
                store16(self.smem, mid, off, v[:, 2 * half], v[:, 2 * half + 1])
        else:
            odd, gb, pair0, pair1 = pack_inverse(v)
            col = n0 + 2 * T + odd
            store16(self.smem, mid, col * 16 + gb, *pair0)
            store16(self.smem, mid, col * 16 + gb + 8, *pair1)

    # ── the second product ──

    def second(self, warp: int, item: int) -> None:
        n0 = warp * 8
        rows, rp, width = self.rows, self.rp, self.width
        kbs = list(range(0, LANES if not self.inverse else rp, 32))
        if not self.inverse:  # Wc's rows of the warp's columns
            held = [np.stack([load_frag(self.smem, self.w2 + j * LANES ** 2, *b_coords(n0, kb),
                                        lambda r, k: matrix_offset(r, k, LANES))
                              for j in range(LIMBS)]) for kb in kbs]
        else:  # Y^T's rows of the warp's columns: slot r / 16, c * 16 + r % 16
            y_off = lambda c, r: (r // 16) * SLOT + c * 16 + r % 16
            held = [np.stack([load_frag(self.smem, i * STRIPE, *b_coords(n0, kb), y_off)
                              for i in range(LIMBS)]) for kb in kbs]
        for m0 in range(0, rows, 16):
            acc = np.zeros((FOLDS, 32, 4), np.int64)
            for kk, kb in enumerate(kbs):
                if not self.inverse:  # Y: slot b / w, r * w + b % w
                    y_off = lambda r, b: (b // width) * SLOT + r * width + b % width
                    a = np.stack([load_frag(self.smem, i * STRIPE, *a_coords(m0, kb), y_off)
                                  for i in range(LIMBS)])
                else:  # Wr*'s rows of the tile
                    a = np.stack([load_frag(self.smem, self.w2 + j * rp * rp, *a_coords(m0, kb),
                                            lambda r, k: matrix_offset(r, k, rp))
                                  for j in range(LIMBS)])
                mma(acc, a, held[kk])
            v = fold_redc(acc, self.rs, self.q, self.qinv)
            for half in range(2):  # one 64-bit store of columns 2t, 2t + 1
                row = m0 + G + 8 * half
                ok = row < rows
                pos = row[ok] * LANES + n0 + 2 * T[ok]
                self.out[item, self.ch, pos] = v[ok, 2 * half]
                self.out[item, self.ch, pos + 1] = v[ok, 2 * half + 1]

    # ── one warp's program ──

    def warp(self, warp: int, counter: list):
        for n, item in enumerate(self.items):
            if n:
                yield ("sync",)  # the last plane's second product has read its slots
            self.load(warp, item)
            yield ("sync",)
            held = self.held_first(warp)
            for k in range(self.stripes):
                acc = self.first(warp, k, held)
                g = counter[warp]
                yield ("step",)
                if k >= 2 and stripe_wait(g) is not None:
                    yield ("wait", stripe_wait(g))
                yield ("arrive", g)
                counter[warp] += 1
                self.epilogue_first(warp, k, acc)
                yield ("step",)
            yield ("sync",)
            self.second(warp, item)
            yield ("step",)


def run_block(block: Block, schedule: str, seed: int = 0) -> None:
    """Run the block's warps to the end in the order ``schedule`` picks
    among the runnable ones ("random", or "ahead": the lowest warp first):
    a warp at a block barrier waits for every warp to reach it, a warp at
    a stripe wait for every warp's arrival on that stripe."""
    counter = [0] * WARPS
    progs = [block.warp(w, counter) for w in range(WARPS)]
    pending = [next(p) for p in progs]
    done = [False] * WARPS
    arrived = block.arrived
    rng = random.Random(seed)

    def advance(w):
        try:
            pending[w] = next(progs[w])
        except StopIteration:
            done[w] = True

    while not all(done):
        live = [w for w in range(WARPS) if not done[w]]
        if all(pending[w][0] == "sync" for w in live):
            for w in live:
                advance(w)
            continue
        ready = [w for w in live if pending[w][0] not in ("sync", "wait")
                 or (pending[w][0] == "wait" and arrived.get(pending[w][1], 0) == WARPS)]
        assert ready, "deadlock"
        w = rng.choice(ready) if schedule == "random" else ready[0]
        if pending[w][0] == "arrive":
            g = pending[w][1]
            # an arrival on mbarrier[g mod 2] counts toward its current
            # phase: stripe g - 2's must have completed
            assert g < 2 or arrived.get(g - 2, 0) == WARPS, f"early arrival on stripe {g}"
            arrived[g] = arrived.get(g, 0) + 1
        advance(w)


def emulate(x: torch.Tensor, moduli, degree: int, inverse: bool, post=None, run: int = 2,
            schedule: str = "random", seed: int = 0) -> torch.Tensor:
    """K9's channel-run kernel on int32 planes (outer, L, N), block by
    block (``block_planes``), each block's warps in ``schedule``'s order."""
    tabs = ntt_mxu.mxu_tables(tuple(moduli), degree, inverse, post, torch.device("cpu"))
    outer, L, n = x.shape
    xs = x.numpy().view(np.uint32)
    out = np.zeros((outer, L, n), np.uint64)
    for b, (ch, items) in enumerate(block_planes(outer, L, run)):
        run_block(Block(xs, out, tabs, ch, items, inverse), schedule, seed + b)
    return torch.from_numpy(out.astype(np.uint32).view(np.int32))


def _case(log_n: int, outer: int = 3, count: int = 1, seed: int = 0):
    degree = 1 << log_n
    moduli = tuple(generate_primes(31, count, degree))
    rng = np.random.default_rng(seed + log_n)
    x = np.stack([rng.integers(0, q, size=(outer, degree), dtype=np.int64) for q in moduli],
                 axis=1)
    return torch.from_numpy(x).to(torch.int32), moduli, degree


MODES = {"forward": (False, False), "inverse": (True, False), "inverse+fold": (True, True)}


def _twin(x, moduli, degree, mode):
    inverse, fold = MODES[mode]
    post = tuple(_dec_inv_ints(moduli, 1)) if fold else None
    return ntt_mxu.ntt_mxu(x, moduli, degree, inverse, post), inverse, post


def test_plan_constants_as_built():
    """Input stripes two slots above the middle ones (the stripe
    hand-off's distance), 16 warps, and the run kernel up to R = 128."""
    assert (IN_SLOT, WARPS, MAX_RUN_ROWS, STRIPE) == (2, 16, 128, 2048)


@pytest.mark.parametrize("outer,channels,run,blocks", [(32, 8, 2, 128), (1, 8, 1, 8),
                                                       (4, 3, 1, 12), (5, 2, 2, 6)])
def test_block_planes_cover_every_plane_once(outer, channels, run, blocks):
    """Every (item, channel) plane in exactly one block, channel-major; the
    run that fills the H100's 132 SMs at the small path's shapes."""
    plan = block_planes(outer, channels, run)
    assert len(plan) == blocks
    seen = sorted((i, ch) for ch, items in plan for i in items)
    assert seen == [(i, ch) for i in range(outer) for ch in range(channels)]
    assert [ch for ch, _ in plan] == sorted(ch for ch, _ in plan)
    if (outer, channels) in ((32, 8), (1, 8), (4, 3)):
        assert run_planes(outer, channels) == run


@pytest.mark.parametrize("width", [32, 64, 128])
def test_swizzle_is_conflict_free(width):
    """Every fragment load (8 rows g x 4 consecutive words t) of a plane of
    ``width``-byte rows hits 32 distinct banks, and the map permutes each
    row's 16-byte chunks."""
    for row0 in range(0, 64, 8):
        for kb in range(0, width, 16):
            addr = np.array([swz(row0 + g, kb + 4 * (t % 4), width) for g in range(8)
                             for t in range(4)])
            assert len(set((addr // 4) % 32)) == 32, (row0, kb)
    for row in range(16):
        chunks = sorted(swz(row, c, width) - row * width for c in range(0, width, 16))
        assert chunks == list(range(0, width, 16))


# (log2 N, mode): R = 8 (padded to the mma depth 32), 32 and 128 (the small
# path's N = 2^14) in every direction
PLANS = [(log_n, mode) for log_n in (10, 12, 14) for mode in MODES]


@pytest.mark.parametrize("log_n,mode", PLANS)
def test_run_plan_matches_twin(log_n, mode):
    """The emulated kernel (runs of 2 planes, the warps in a random order
    the barriers allow; two channels at R = 8 and 32, one at R = 128)
    word for word against ``ntt_mxu.ntt_mxu``."""
    x, moduli, degree = _case(log_n, outer=3, count=2) if log_n < 14 else _case(log_n, 2)
    want, inverse, post = _twin(x, moduli, degree, mode)
    got = emulate(x, moduli, degree, inverse, post, run=2, schedule="random", seed=log_n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", list(MODES))
def test_run_plan_with_a_warp_ahead(mode):
    """The lowest warp runs ahead as far as the barriers allow (R = 64:
    four stripes; runs of 2 planes): the stripe hand-off still orders
    every write after the reads it would clobber."""
    x, moduli, degree = _case(13, outer=2)
    want, inverse, post = _twin(x, moduli, degree, mode)
    assert torch.equal(emulate(x, moduli, degree, inverse, post, run=2, schedule="ahead"),
                       want)


def test_run_plan_mutations_fail(monkeypatch):
    """The emulation catches the input stripes one slot up (stripe k's
    middle limbs over stripe k - 1's input, which a warp behind may still
    read), no wait before a stripe's middle limbs overwrite stripe g - 2's
    input (an arrival before its phase ends), the matrix limbs copied
    without their swizzle and the inverse's pairs stored without the
    exchange, at R = 64 (four stripes)."""
    module = sys.modules[__name__]
    cases = {"forward": _case(13, outer=1), "inverse": _case(13, outer=1, seed=1)}
    wants = {m: _twin(*cases[m], m)[0] for m in cases}

    def fails(mode, **kw):
        inverse = mode == "inverse"
        try:
            got = emulate(*cases[mode], inverse, None, run=2, **kw)
        except AssertionError:
            return True
        return not torch.equal(got, wants[mode])

    for mode in cases:
        assert not fails(mode, schedule="ahead")
    monkeypatch.setattr(module, "IN_SLOT", 1)
    assert fails("forward", schedule="ahead") and fails("inverse", schedule="ahead")
    monkeypatch.setattr(module, "IN_SLOT", 2)
    monkeypatch.setattr(module, "stripe_wait", lambda g: None)
    assert fails("forward", schedule="ahead") and fails("inverse", schedule="ahead")
    monkeypatch.setattr(module, "stripe_wait", lambda g: g - 2)
    real = module.matrix_offset
    monkeypatch.setattr(module, "Block", _unswizzled_copy(real))
    assert fails("forward", schedule="ahead")
    monkeypatch.setattr(module, "Block", Block)
    monkeypatch.setattr(module, "pack_inverse", lambda v: (
        np.zeros(32, int), G, (v[:, 0], v[:, 1]), (v[:, 2], v[:, 3])))
    assert fails("inverse", schedule="ahead")


def _unswizzled_copy(offset):
    """A Block whose matrix copy skips the swizzle its loads assume."""

    class Unswizzled(Block):
        def __init__(self, *args, **kw):
            module = sys.modules[__name__]
            module.matrix_offset = lambda r, c, k: r * k + c
            try:
                super().__init__(*args, **kw)
            finally:
                module.matrix_offset = offset

    return Unswizzled
