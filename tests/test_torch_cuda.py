"""PyTorch port on the card: each CUDA kernel against its torch twin, and
the slice on the GPU against the slice on the CPU (uint32 equality on
small chains, uint64 equality on wide ones).

Marked ``cuda``; every test skips where no CUDA device is present. The
file imports neither jax nor the reference, so it also runs where only
torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch.keys import default_special_primes
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
from toy_heaan_ckks_tpu_torch.ops import (
    keyswitch_gpu, moddown_gpu, ntt_gpu, ntt_mxu, ntt_mxu_gpu, small_fast,
)
from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_mul_relin_rescale

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _planes(seed, moduli, degree, lead, device, dtype=torch.int32):
    rng = np.random.default_rng(seed)
    arr = np.stack(
        [rng.integers(0, q, size=lead + (degree,), dtype=np.int64) for q in moduli],
        axis=-2,
    )
    return torch.from_numpy(arr).to(device, dtype)


def _chain(count, digit_size, degree, bits=31):
    base = tuple(port.generate_primes(bits, count, degree))
    ctx = port.CkksContext.build(base, degree, device="cpu")
    return base, base + default_special_primes(ctx, digit_size)


def _on_cluster(degree, wide):
    """Whether the kernels run a plane of ``degree`` on a thread-block
    cluster: uint32 planes of 2^16, uint64 planes of 2^13 and up."""
    return int(degree >= 1 << 13 if wide else degree == 1 << 16)


def _counted(fn, call):
    """``call()`` and the (launches, launches_cluster) it added to ``fn``."""
    before = fn.launches, fn.launches_cluster
    out = call()
    return out, (fn.launches - before[0], fn.launches_cluster - before[1])


def _ntt_vs_twin(dev, x, moduli, degree, mode):
    """K1 (K4 at N = 2^16) against its twin on ``x``: one launch, on a
    cluster at 2^16 and none below, uint32-equal outputs. ``mode``:
    forward, inverse (final N^-1), fold (the inverse with the
    decomposition fold's final constants) or yhat (the mod-down's yhat
    emission: ``moduli`` dropped from a chain of 2 more)."""
    inverse = mode != "forward"
    final = None
    if mode == "fold":
        final = small_fast._fold_consts(moduli, degree,
                                        tuple((q - 1) // 3 for q in moduli))
    elif mode == "yhat":
        kept = tuple(port.generate_primes(29, 2, degree))
        final = moddown_gpu._down_consts(kept, moduli, degree)[6]
    got, counts = _counted(ntt_gpu.ntt_planes, lambda: ntt_gpu.ntt_planes(
        x, moduli, degree, inverse, final))
    assert counts == (1, int(degree == 1 << 16))
    assert torch.equal(got, ntt_gpu.ntt_twin(x, moduli, degree, inverse, final))


# 2^10 .. 2^15: ntt_kernel_reg (2 register passes at 2^10, 3 above);
# 2^16: ntt_kernel_cluster, register passes on a cluster of 16 blocks (K4)
NTT_DEGREES = [1 << k for k in range(10, 17)]


@pytest.mark.parametrize("degree", NTT_DEGREES)
@pytest.mark.parametrize("mode", ["forward", "inverse", "fold"])
def test_ntt_kernel_matches_twin(dev, degree, mode):
    """K1, and K4 at N = 2^16."""
    moduli, _ = _chain(3, 1, degree)
    x = _planes(degree, moduli, degree, (3,), dev)
    _ntt_vs_twin(dev, x, moduli, degree, mode)


@pytest.mark.parametrize("degree", NTT_DEGREES)
@pytest.mark.parametrize("mode", ["forward", "inverse", "fold"])
def test_ntt_kernel_reads_channel_slices(dev, degree, mode):
    """K1 / K4 on channels 2..4 of a 5-channel stack (item stride 5 N),
    as ``rescale_ntt_lo`` passes them."""
    moduli, _ = _chain(5, 1, degree)
    x = _planes(degree + 1, moduli, degree, (2,), dev)[..., 2:, :]
    _ntt_vs_twin(dev, x, moduli[2:], degree, mode)


@pytest.mark.parametrize("mode", ["forward", "inverse"])
def test_ntt_kernel_unaligned_input(dev, mode):
    """Planes one word off a 16-byte boundary."""
    degree = 1 << 12
    moduli, _ = _chain(3, 1, degree)
    x = _planes(7, moduli, degree, (2,), dev)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    flat[1:] = x.reshape(-1)
    _ntt_vs_twin(dev, flat[1:].view(x.shape), moduli, degree, mode)


# N = 2^16: batches of 1, 3 and 4 items of 1, 3 and 4 channels, the
# big path's 30-bit primes
@pytest.mark.parametrize("batch,channels", [(1, 1), (3, 3), (4, 4), (1, 4), (4, 3)])
@pytest.mark.parametrize("mode", ["forward", "inverse", "fold", "yhat"])
def test_ntt_cluster_form_matches_twin(dev, batch, channels, mode):
    """K4's cluster register-pass form in each mode."""
    degree = 1 << 16
    moduli = tuple(port.generate_primes(30, channels, degree))
    x = _planes(batch * 10 + channels, moduli, degree, (batch,), dev)
    _ntt_vs_twin(dev, x, moduli, degree, mode)


@pytest.mark.parametrize("mode", ["forward", "inverse", "yhat"])
def test_ntt_cluster_form_unaligned_input(dev, mode):
    """K4 on planes one word off a 16-byte boundary (the inverse's runs
    are 16-byte loads: the wrapper copies them)."""
    degree = 1 << 16
    moduli = tuple(port.generate_primes(30, 3, degree))
    x = _planes(11, moduli, degree, (2,), dev)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    flat[1:] = x.reshape(-1)
    _ntt_vs_twin(dev, flat[1:].view(x.shape), moduli, degree, mode)


def _keyswitch_vs_twin(dev, degree, digit_size, count, with_d, batch):
    """K2 on one block per plane against its twin: one launch, no cluster,
    uint32-equal outputs."""
    base, ext = _chain(count, min(digit_size, count), degree)
    digits = -(-count // digit_size)
    y = _planes(1, base, degree, (batch,), dev)
    d = _planes(2, base, degree, (batch,), dev) if with_d else None
    ka = _planes(3, ext, degree, (digits,), dev)
    kb = _planes(4, ext, degree, (digits,), dev)
    got, counts = _counted(keyswitch_gpu.gadget_accumulate, lambda: keyswitch_gpu.gadget_accumulate(
        y, ka, kb, base_moduli=base, ext_moduli=ext, degree=degree,
        digit_size=digit_size, d_ntt=d))
    assert counts == (1, 0)
    want = keyswitch_gpu.gadget_accumulate_twin(
        y, ka, kb, base, ext, degree, digit_size, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# 2^9: the keyswitch_kernel template's uint32 one-block form; 2^10 .. 2^15:
# keyswitch_kernel_reg (2 register passes at 2^10, 3 above); (ds, count)
# covers a short last digit group and D = 1 (ds >= L: no base channel has a
# non-own digit)
@pytest.mark.parametrize("degree", [1 << 9, 1 << 10, 1 << 12, 1 << 13, 1 << 14, 1 << 15])
@pytest.mark.parametrize("digit_size,count", [(1, 2), (2, 3), (3, 4), (4, 8), (8, 4)])
@pytest.mark.parametrize("with_d", [True, False])
def test_keyswitch_kernel_matches_twin(dev, degree, digit_size, count, with_d):
    _keyswitch_vs_twin(dev, degree, digit_size, count, with_d, 2)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("with_d", [True, False])
def test_keyswitch_kernel_batches(dev, batch, with_d):
    """A batch of one and an odd batch (the grid's special-first order)."""
    _keyswitch_vs_twin(dev, 1 << 14, 4, 8, with_d, batch)


@pytest.mark.parametrize("with_d", [True, False])
def test_keyswitch_kernel_main_path_shape(dev, with_d):
    """The small multiply's key switch: 8 x 31-bit, ds 4, N = 2^14, B 32."""
    _keyswitch_vs_twin(dev, 1 << 14, 4, 8, with_d, 32)


def _keyswitch_2_16_vs_twin(dev, digit_size, batch, with_d):
    """K2 at N = 2^16 (keyswitch_kernel_cluster, a cluster of 16 blocks
    per plane) against its twin on the big path's 4 x 30-bit base: one
    cluster launch, uint32-equal outputs."""
    degree = 1 << 16
    base, ext = _chain(4, digit_size, degree, 30)
    digits = -(-len(base) // digit_size)
    y = _planes(1, base, degree, (batch,), dev)
    d = _planes(2, base, degree, (batch,), dev) if with_d else None
    ka = _planes(3, ext, degree, (digits,), dev)
    kb = _planes(4, ext, degree, (digits,), dev)
    got, counts = _counted(keyswitch_gpu.gadget_accumulate, lambda: keyswitch_gpu.gadget_accumulate(
        y, ka, kb, base_moduli=base, ext_moduli=ext, degree=degree,
        digit_size=digit_size, d_ntt=d))
    assert counts == (1, 1)
    want = keyswitch_gpu.gadget_accumulate_twin(y, ka, kb, base, ext, degree,
                                                digit_size, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("with_d", [True, False])
def test_keyswitch_kernel_2_16_matches_twin(dev, with_d):
    """The big path's chain (4 x 30-bit, ds 2: D = 2, E = 6), batch 2."""
    _keyswitch_2_16_vs_twin(dev, 2, 2, with_d)


# ds 1: D = 4 digits (a special plane runs 4 cluster NTTs in a row); ds 4:
# D = 1 (with d the base planes run no NTT and touch no peer); batch 1
@pytest.mark.parametrize("digit_size,batch", [(1, 2), (4, 2), (2, 1)])
@pytest.mark.parametrize("with_d", [True, False])
def test_keyswitch_cluster_form_digits(dev, digit_size, batch, with_d):
    _keyswitch_2_16_vs_twin(dev, digit_size, batch, with_d)


def _moddown_vs_twin(dev, degree, count, digit_size, with_t, batch, keyswitch=False,
                     offset=0, bits=31):
    """K3 / K3' (K8 / K8' above 32-bit primes) against its twin: one
    launch, on a cluster at uint32 N = 2^16 and uint64 2^13 .. 2^16
    (``_on_cluster``) and none below, word-equal outputs. The multiply's
    shapes keep all but the last base prime and drop it with the
    specials; a key switch's (``keyswitch``) keeps the base and drops the
    specials. ks (and t) are channel slices of larger stacks; ``offset``
    words shift ks off its 16-byte alignment."""
    wide = bits > 32
    dtype = torch.int64 if wide else torch.int32
    fn = moddown_gpu.mod_down_combine_wide if wide else moddown_gpu.mod_down_combine
    base, ext = _chain(count, digit_size, degree, bits)
    L = len(base)
    child, dropped = (base, ext[L:]) if keyswitch else (base[:-1], ext[L - 1:])
    Lc = len(child)
    t_scale = 123456789 if with_t else 0
    yhat = _planes(5, dropped, degree, (batch,), dev, dtype)
    ks_full = _planes(6, ext, degree, (batch,), dev, dtype)
    if offset:
        flat = torch.empty(ks_full.numel() + offset, dtype=ks_full.dtype, device=dev)
        flat[offset:] = ks_full.reshape(-1)
        ks_full = flat[offset:].view(ks_full.shape)
    ks = ks_full[..., :Lc, :]
    t = _planes(7, base, degree, (batch,), dev, dtype)[..., :Lc, :] if with_t else None
    kw = dict(child_moduli=child, dropped_moduli=dropped, degree=degree,
              t_scale=t_scale)
    got, counts = _counted(fn, lambda: fn(yhat, ks, t, **kw))
    assert counts == (1, _on_cluster(degree, wide))
    want = moddown_gpu.mod_down_combine_twin(yhat, ks, t, child, dropped,
                                             degree, t_scale)
    assert torch.equal(got, want)


# 2^10 .. 2^15: moddown_kernel_reg (2 register passes at 2^10, 3 above);
# 2^16: moddown_kernel_cluster, register passes on a cluster of 16 blocks
@pytest.mark.parametrize("degree", [1 << k for k in range(10, 17)])
@pytest.mark.parametrize("with_t", [True, False])
def test_moddown_kernel_matches_twin(dev, with_t, degree):
    """K3 / K3' (4 kept, 3 dropped, B 3)."""
    _moddown_vs_twin(dev, degree, 5, 2, with_t, 3)


@pytest.mark.parametrize("batch", [1, 3, 32])
@pytest.mark.parametrize("keyswitch", [False, True])
def test_moddown_kernel_main_path_shape(dev, batch, keyswitch):
    """The small path's mod-downs at N = 2^14, 8 x 31-bit, ds 4: K3 with t
    (7 kept, 5 dropped) and K3' (8 kept, the 4 specials dropped)."""
    _moddown_vs_twin(dev, 1 << 14, 8, 4, not keyswitch, batch, keyswitch)


@pytest.mark.parametrize("with_t", [True, False])
def test_moddown_kernel_unaligned_input(dev, with_t):
    """ks read in place one word off a 16-byte boundary."""
    _moddown_vs_twin(dev, 1 << 12, 5, 2, with_t, 2, offset=1)


@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("keyswitch", [False, True])
def test_moddown_cluster_form_main_path_shape(dev, batch, keyswitch):
    """K3's cluster register-pass form at the big path's chain (4 primes,
    ds 2): K3 with t (3 kept, 3 dropped) and K3' (4 kept, the 2 specials
    dropped), ks and t channel slices of larger stacks."""
    _moddown_vs_twin(dev, 1 << 16, 4, 2, not keyswitch, batch, keyswitch)


@pytest.mark.parametrize("with_t", [True, False])
def test_moddown_cluster_form_unaligned_input(dev, with_t):
    """K3 at N = 2^16 with ks read in place one word off a 16-byte
    boundary."""
    _moddown_vs_twin(dev, 1 << 16, 4, 2, with_t, 2, offset=1)


# K9: N = 2^10 (R = 8, padded to the mma depth 32), 2^12, the small path's
# 2^14 and 2^15 (R = 256, 136 KiB of shared memory)
MXU_DEGREES = [1 << 10, 1 << 12, 1 << 14, 1 << 15]


@pytest.mark.parametrize("degree", MXU_DEGREES)
@pytest.mark.parametrize("mode", ["forward", "inverse", "fold"])
def test_mxu_kernel_matches_twin_and_k1(dev, degree, mode):
    """K9 against its twin and against K1 on the same planes (the folded
    inverse against K1 with ``inv_ntt_fold``'s final constants)."""
    moduli, _ = _chain(3, 1, degree)
    x = _planes(degree + 5, moduli, degree, (3,), dev)
    inverse = mode != "forward"
    post = tuple((q - 1) // 3 for q in moduli) if mode == "fold" else None
    got, counts = _counted(ntt_mxu_gpu.ntt_mxu_planes, lambda: ntt_mxu_gpu.ntt_mxu_planes(
        x, moduli, degree, inverse, post))
    assert counts == (1, 0)
    assert torch.equal(got, ntt_mxu.ntt_mxu(x, moduli, degree, inverse, post))
    final = None if post is None else small_fast._fold_consts(moduli, degree, post)
    assert torch.equal(got, ntt_gpu.ntt_planes(x, moduli, degree, inverse, final))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("degree", [1 << 13, 1 << 15])
def test_mxu_kernel_reads_channel_slices(dev, inverse, degree):
    """K9 on a channel slice of a larger stack (item stride 5 N) and on
    items an odd number of words apart (item stride 3 N + 1), both
    kernels (R = 64: the channel-run kernel; R = 256: one block a plane)."""
    moduli, _ = _chain(5, 1, degree)
    x = _planes(11, moduli, degree, (2,), dev)[..., 2:, :]
    got = ntt_mxu_gpu.ntt_mxu_planes(x, moduli[2:], degree, inverse)
    assert torch.equal(got, ntt_gpu.ntt_planes(x, moduli[2:], degree, inverse))
    flat = torch.zeros(3 * (3 * degree + 1), dtype=torch.int32, device=dev)
    odd = flat.as_strided((3, 3, degree), (3 * degree + 1, degree, 1))
    odd.copy_(_planes(12, moduli[2:], degree, (3,), dev))
    got = ntt_mxu_gpu.ntt_mxu_planes(odd, moduli[2:], degree, inverse)
    assert torch.equal(got, ntt_gpu.ntt_planes(odd.contiguous(), moduli[2:], degree, inverse))


# K9 at chip_smoke.py's MXU_SHAPES (items, channels, N): the small path's
# batch 32 and 1 (R = 128), R = 256 and R = 8; the kernel each runs (the
# channel-run kernel up to R = 128, planes a block to fill 132 SMs, and
# its blocks)
MXU_SHAPES = [((32, 8, 1 << 14), (1, 2, 128)), ((1, 8, 1 << 14), (1, 1, 8)),
              ((2, 2, 1 << 15), (0, 1, 4)), ((4, 3, 1 << 10), (1, 1, 12))]


@pytest.mark.parametrize("shape,form", MXU_SHAPES)
@pytest.mark.parametrize("mode", ["forward", "inverse", "fold"])
def test_mxu_kernel_at_path_shapes(dev, shape, form, mode):
    """K9 at each MXU_SHAPES shape and mode against its twin and K1 (the
    fold against ``inv_ntt_fold``'s constants), one launch, and the kernel
    it picks (``mxu_form``, on an H100's 132 SMs)."""
    B, L, degree = shape
    moduli = tuple(port.generate_primes(31, L, degree))
    x = _planes(B + L, moduli, degree, (B,), dev)
    inverse = mode != "forward"
    post = small_fast._dec_inv_ints(moduli, 4) if mode == "fold" else None
    got, counts = _counted(ntt_mxu_gpu.ntt_mxu_planes, lambda: ntt_mxu_gpu.ntt_mxu_planes(
        x, moduli, degree, inverse, post))
    assert counts == (1, 0)
    assert torch.equal(got, ntt_mxu.ntt_mxu(x, moduli, degree, inverse, post))
    final = None if post is None else small_fast._fold_consts(moduli, degree, post)
    assert torch.equal(got, ntt_gpu.ntt_planes(x, moduli, degree, inverse, final))
    info = ntt_mxu_gpu.mxu_form(B, L, degree, inverse)
    assert info["run_kernel"] == form[0] and info["threads_per_block"] == 512
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert (info["planes_a_block"], info["blocks"]) == form[1:]


# wide chains: 61-bit at 2^13 (the wide main path), 62-bit with 63-bit
# specials at 2^14 (the 128 KiB uint64 plane), 40-bit at 2^10, and 61-bit
# at 2^15 / 2^16 (K5', K6 and K8 on clusters of 16 blocks of register
# passes)
WIDE = [(61, 1 << 13), (62, 1 << 14), (40, 1 << 10), (61, 1 << 15), (61, 1 << 16)]


@pytest.mark.parametrize("bits,degree", WIDE)
@pytest.mark.parametrize("inverse", [False, True])
def test_wide_ntt_kernel_matches_twin(dev, bits, degree, inverse):
    _, moduli = _chain(2, 1, degree, bits)  # a base prime and a special
    x = _planes(degree + bits, moduli, degree, (2,), dev, torch.int64)
    final = tuple((q - 1) // 3 for q in moduli) if inverse else None
    got, counts = _counted(ntt_gpu.ntt_planes_wide, lambda: ntt_gpu.ntt_planes_wide(
        x, moduli, degree, inverse, final))
    assert counts == (1, _on_cluster(degree, True))
    assert torch.equal(got, ntt_gpu.ntt_twin(x, moduli, degree, inverse, final))


@pytest.mark.parametrize("bits,degree", WIDE)
@pytest.mark.parametrize("digit_size,count", [(1, 3), (2, 3)])
def test_wide_keyswitch_kernel_matches_twin(dev, bits, degree, digit_size, count):
    base, ext = _chain(count, digit_size, degree, bits)
    digits = -(-count // digit_size)
    y = _planes(1, base, degree, (2,), dev, torch.int64)
    d = _planes(2, base, degree, (2,), dev, torch.int64)
    ka = _planes(3, ext, degree, (digits,), dev, torch.int64)
    kb = _planes(4, ext, degree, (digits,), dev, torch.int64)
    got = keyswitch_gpu.gadget_accumulate_wide(
        y, ka, kb, base_moduli=base, ext_moduli=ext, degree=degree,
        digit_size=digit_size, d_ntt=d,
    )
    want = keyswitch_gpu.gadget_accumulate_twin(
        y, ka, kb, base, ext, degree, digit_size, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _wide_ntt_vs_twin(dev, x, moduli, degree, mode):
    """K5 / K5' / K7 at N = 2^13 .. 2^16 (ntt_kernel_cluster64, the cluster
    plan on uint64 words) against its twin: one launch, on a cluster,
    uint64-equal outputs; ``mode`` as in ``_ntt_vs_twin`` (yhat: ``moduli``
    dropped from a chain of 2 more)."""
    inverse = mode != "forward"
    final = None
    if mode == "fold":
        final = moddown_gpu._fold_consts_wide(moduli, degree,
                                              tuple((q - 1) // 3 for q in moduli))
    elif mode == "yhat":
        kept = tuple(port.generate_primes(59, 2, degree))
        final = moddown_gpu._down_consts_wide(kept, moduli, degree)[6]
    got, counts = _counted(ntt_gpu.ntt_planes_wide, lambda: ntt_gpu.ntt_planes_wide(
        x, moduli, degree, inverse, final))
    assert counts == (1, 1)
    assert torch.equal(got, ntt_gpu.ntt_twin(x, moduli, degree, inverse, final))


# N = 2^13 (the wide path), 2^14 (wide-62b), 2^15 (the big-wide path) and
# 2^16: batches of 1, 3 and 4 items of 1 to 4 channels, 61-bit primes
@pytest.mark.parametrize("degree", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
@pytest.mark.parametrize("batch,channels", [(1, 1), (3, 3), (4, 4), (1, 4), (4, 2)])
@pytest.mark.parametrize("mode", ["forward", "inverse", "fold", "yhat"])
def test_wide_ntt_cluster_form_matches_twin(dev, degree, batch, channels, mode):
    """K5 / K5' / K7's cluster register-pass form on uint64 words in each
    mode."""
    moduli = tuple(port.generate_primes(61, channels, degree))
    x = _planes(batch * 10 + channels, moduli, degree, (batch,), dev, torch.int64)
    _wide_ntt_vs_twin(dev, x, moduli, degree, mode)


@pytest.mark.parametrize("degree", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
@pytest.mark.parametrize("mode", ["forward", "inverse", "yhat"])
def test_wide_ntt_cluster_form_unaligned_input(dev, degree, mode):
    """K5 / K5' / K7 on planes one word off a 16-byte boundary (the
    inverse's runs are 16-byte loads: the wrapper copies them)."""
    moduli = tuple(port.generate_primes(61, 3, degree))
    x = _planes(12, moduli, degree, (2,), dev, torch.int64)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    flat[1:] = x.reshape(-1)
    _wide_ntt_vs_twin(dev, flat[1:].view(x.shape), moduli, degree, mode)


@pytest.mark.parametrize("degree", [1 << 13, 1 << 14])
@pytest.mark.parametrize("mode", ["inverse", "fold", "yhat"])
def test_wide_ntt_cluster_form_odd_item_stride(dev, degree, mode):
    """K7 at 2^13 / 2^14 on items one word apart beyond their planes (an
    odd item stride: every other item off a 16-byte boundary; the wrapper
    copies them)."""
    moduli = tuple(port.generate_primes(61, 3, degree))
    x = _planes(13, moduli, degree, (3,), dev, torch.int64)
    stride = x[0].numel() + 1
    flat = torch.empty(3 * stride, dtype=x.dtype, device=dev)
    odd = flat.as_strided(x.shape, (stride, degree, 1))
    odd.copy_(x)
    assert odd.stride(0) % 2 == 1
    _wide_ntt_vs_twin(dev, odd, moduli, degree, mode)


# (path, items, prime bits, base primes): the wide path's (8, 4 x 61-bit,
# 2^13) and wide-62b's (2, 3 x 62-bit, 2^14), ds 1
WIDE_PATHS = [("wide", 1 << 13, 8, 61, 4), ("wide-62b", 1 << 14, 2, 62, 3)]


@pytest.mark.parametrize("path,degree,batch,bits,count", WIDE_PATHS)
@pytest.mark.parametrize("mode", ["forward", "fold", "yhat"])
def test_wide_ntt_cluster_form_path_shapes(dev, path, degree, batch, bits, count, mode):
    """K5 / K7 at the wide paths' shapes: the forward and the
    decomposition fold on the base, the yhat emission on the last base
    prime and the special (the multiply's dropped moduli)."""
    base, ext = _chain(count, 1, degree, bits)
    moduli = ext[count - 1:] if mode == "yhat" else base
    final = None
    if mode == "fold":
        final = moddown_gpu._fold_consts_wide(moduli, degree,
                                              tuple((q - 1) // 3 for q in moduli))
    elif mode == "yhat":
        final = moddown_gpu._down_consts_wide(base[:-1], moduli, degree)[6]
    x = _planes(degree + bits, moduli, degree, (batch,), dev, torch.int64)
    got, counts = _counted(ntt_gpu.ntt_planes_wide, lambda: ntt_gpu.ntt_planes_wide(
        x, moduli, degree, mode != "forward", final))
    assert counts == (1, 1)
    assert torch.equal(got, ntt_gpu.ntt_twin(x, moduli, degree, mode != "forward", final))


@pytest.mark.parametrize("path,degree,batch,bits,count", WIDE_PATHS)
@pytest.mark.parametrize("keyswitch", [False, True])
def test_wide_moddown_cluster_form_path_shapes(dev, path, degree, batch, bits, count,
                                               keyswitch):
    """K8 (the multiply's: all but the last base prime kept, it and the
    special dropped, with t) and K8' (a key switch's: the base kept, the
    special dropped) at the wide paths' shapes."""
    _moddown_vs_twin(dev, degree, count, 1, not keyswitch, batch, keyswitch, bits=bits)


def _header_constant(name: str) -> int:
    """An int constant of ``csrc/ntt_cluster.cuh`` (the forms as built)."""
    text = (Path(ntt_gpu.__file__).parent.parent / "csrc" / "ntt_cluster.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_plane_blocks_report_the_forms(dev):
    """``ntt_gpu.launch_blocks`` (``ckks_plane_blocks``) reports the form
    each entry launches: the uint64 templates at 2^12 (one block), the
    uint64 clusters of each form's C at 2^13 and 2^14 whatever P says and
    of 16 at 2^15 / 2^16, the uint32 register-pass blocks below 2^16 and
    clusters of 16 there, and 0 where an entry refuses the arguments."""
    names = {ntt_gpu.FORWARD: "Ntt", ntt_gpu.INVERSE: "Ntt",
             ntt_gpu.KEY_SWITCH: "", ntt_gpu.MOD_DOWN: "Ntt"}
    for form, name in names.items():
        assert ntt_gpu.launch_blocks(form, True, 12, 1) == 1
        assert ntt_gpu.launch_blocks(form, True, 12, 2) == 0
        for log_n in (13, 14):
            want = 1 << _header_constant(f"kWide{name}LogCluster{log_n}")
            assert ntt_gpu.launch_blocks(form, True, log_n, 1) == want
            assert ntt_gpu.launch_blocks(form, True, log_n, 2) == want
        for log_n in (15, 16):
            want = 1 << _header_constant(f"kWideLogCluster{log_n}")
            assert ntt_gpu.launch_blocks(form, True, log_n, 1 << (log_n - 14)) == want
        assert ntt_gpu.launch_blocks(form, False, 14, 1) == 1
        assert ntt_gpu.launch_blocks(form, False, 16, 2) == 16
        assert ntt_gpu.launch_blocks(form, False, 15, 2) == 0


# (digit_size, base primes): D = 3 (a special plane runs 3 cluster NTTs in
# a row), D = 2 with a short last digit group, D = 1 (with d the base
# planes run no NTT and touch no peer)
@pytest.mark.parametrize("degree", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
@pytest.mark.parametrize("digit_size,count", [(1, 3), (2, 3), (2, 2)])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("with_d", [True, False])
def test_wide_keyswitch_cluster_form_digits(dev, degree, digit_size, count, batch, with_d):
    """K6 at N = 2^13 .. 2^16 (keyswitch_kernel_cluster64: WidePlan's C
    blocks at 2^13 and 2^14, where one block holds the plane, 16 above)
    against its twin: one cluster launch, uint64-equal outputs."""
    base, ext = _chain(count, digit_size, degree, 61)
    digits = -(-count // digit_size)
    y = _planes(1, base, degree, (batch,), dev, torch.int64)
    d = _planes(2, base, degree, (batch,), dev, torch.int64) if with_d else None
    ka = _planes(3, ext, degree, (digits,), dev, torch.int64)
    kb = _planes(4, ext, degree, (digits,), dev, torch.int64)
    got, counts = _counted(keyswitch_gpu.gadget_accumulate_wide,
                           lambda: keyswitch_gpu.gadget_accumulate_wide(
                               y, ka, kb, base_moduli=base, ext_moduli=ext, degree=degree,
                               digit_size=digit_size, d_ntt=d))
    assert counts == (1, 1)
    want = keyswitch_gpu.gadget_accumulate_twin(y, ka, kb, base, ext, degree,
                                                digit_size, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# N = 2^13, 2^14, 2^15 (the big-wide path) and 2^16 at the big-wide chain
# (3 x 61-bit, ds 1): K8 keeps 2 base primes and drops the last with the
# special, K8' keeps the base and drops the special
@pytest.mark.parametrize("degree", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("keyswitch", [False, True])
def test_wide_moddown_cluster_form_matches_twin(dev, degree, batch, keyswitch):
    """K8 (with t) / K8' (without) on the uint64 cluster plan
    (moddown_kernel_cluster64), ks and t channel slices of larger stacks."""
    _moddown_vs_twin(dev, degree, 3, 1, not keyswitch, batch, keyswitch, bits=61)


@pytest.mark.parametrize("degree", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
@pytest.mark.parametrize("with_t", [True, False])
def test_wide_moddown_cluster_form_unaligned_input(dev, degree, with_t):
    """K8 / K8' with ks read in place one word off a 16-byte boundary."""
    _moddown_vs_twin(dev, degree, 3, 1, with_t, 2, offset=1, bits=61)


@pytest.mark.parametrize("bits,degree", WIDE)
def test_wide_moddown_kernel_matches_twin(dev, bits, degree):
    base, ext = _chain(3, 1, degree, bits)
    child, dropped = base[:2], ext[2:]
    t_scale = ext[-1]
    yhat = _planes(5, dropped, degree, (2,), dev, torch.int64)
    ks = _planes(6, ext, degree, (2,), dev, torch.int64)[..., :2, :]
    t = _planes(7, base, degree, (2,), dev, torch.int64)[..., :2, :]
    kw = dict(child_moduli=child, dropped_moduli=dropped, degree=degree,
              t_scale=t_scale)
    got = moddown_gpu.mod_down_combine_wide(yhat, ks, t, **kw)
    want = moddown_gpu.mod_down_combine_twin(yhat, ks, t, child, dropped,
                                             degree, t_scale)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits,degree,count,digit_size", [
    (31, 1 << 14, 8, 4), (31, 1 << 12, 3, 2), (61, 1 << 13, 4, 1), (62, 1 << 14, 3, 1),
])
def test_moddown_no_t_kernel_matches_twin(dev, bits, degree, count, digit_size):
    """K3' / K8' at key-switch shapes (the whole base kept, the specials
    dropped, ks a channel slice of a QP stack), and their own counter."""
    base, ext = _chain(count, digit_size, degree, bits)
    specials = ext[count:]
    dtype = torch.int32 if bits < 32 else torch.int64
    fn = moddown_gpu.mod_down_combine if bits < 32 else moddown_gpu.mod_down_combine_wide
    yhat = _planes(5, specials, degree, (2,), dev, dtype)
    ks = _planes(6, ext, degree, (2,), dev, dtype)[..., :count, :]
    kw = dict(child_moduli=base, dropped_moduli=specials, degree=degree)
    before = fn.launches_no_t
    got = fn(yhat, ks, None, **kw)
    assert fn.launches_no_t == before + 1
    want = moddown_gpu.mod_down_combine_twin(yhat, ks, None, base, specials,
                                             degree, 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits,degree,count,digit_size", [
    (31, 1 << 12, 4, 2), (61, 1 << 10, 3, 1),
])
def test_rotation_gpu_matches_cpu(dev, bits, degree, count, digit_size):
    """Same seeds on both devices: a batched rotation and a
    rotate_sum_hoisted are bit-identical, and the card ran the key
    switch's kernels, the t-less mod-down included."""
    from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_rotate

    wide = bits > 31
    md = moddown_gpu.mod_down_combine_wide if wide else moddown_gpu.mod_down_combine
    ks = keyswitch_gpu.gadget_accumulate_wide if wide else keyswitch_gpu.gadget_accumulate
    values = np.random.default_rng(4).uniform(-1, 1, size=(2, degree // 2))
    outs = {}
    for device in (torch.device("cpu"), dev):
        before = (md.launches_no_t, ks.launches)
        ctx = port.CkksContext.build(port.generate_primes(bits, count, degree),
                                     degree, device)
        eng = port.CkksEngine(ctx, port.CkksParams(3.2, degree // 2, 30))
        rng = make_rng(42)
        sk = eng.generate_secret_key(rng)
        pk = eng.generate_public_key(sk, rng)
        keys = [eng.generate_gadget_rotation_key(sk, k, rng, digit_size=digit_size)
                for k in (1, 2, -3)]
        enc = port.CkksEncoder(degree, 30)
        cts = [eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng)
               for v in values]
        o0, o1 = batched_rotate((torch.stack([c.c0.data for c in cts]),
                                 torch.stack([c.c1.data for c in cts])), keys[0], ctx)
        summed = port.CkksEngine.rotate_sum_hoisted(cts[0], keys)
        outs[device.type] = [x.cpu() for x in (o0, o1, summed.c0.data, summed.c1.data)]
        launched = (md.launches_no_t - before[0], ks.launches - before[1])
        assert all(n > 0 for n in launched) == (device.type == "cuda")
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(a, b)


def test_wide_slice_gpu_matches_cpu(dev):
    """The wide slice (61-bit, ds 1) on both devices: keys and the fused
    product are bit-identical, and the GPU run went through K5/K7, K6, K8."""
    degree, count = 1 << 10, 3
    values = np.random.default_rng(9).uniform(-1, 1, size=(2, 2, degree // 2))
    counters = (ntt_gpu.ntt_planes_wide, keyswitch_gpu.gadget_accumulate_wide,
                moddown_gpu.mod_down_combine_wide)
    outs = {}
    for device in (torch.device("cpu"), dev):
        before = [f.launches for f in counters]
        ctx = port.CkksContext.build(port.generate_primes(61, count, degree),
                                     degree, device)
        eng = port.CkksEngine(ctx, port.CkksParams(3.2, degree // 2, 61))
        rng = make_rng(42)
        sk = eng.generate_secret_key(rng)
        pk = eng.generate_public_key(sk, rng)
        rlk = eng.generate_gadget_relin_key(sk, rng)
        enc = port.CkksEncoder(degree, 61)
        cts = [[eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng)
                for v in side] for side in values]
        stack = lambda side, part: torch.stack([getattr(c, part).data for c in cts[side]])
        o0, o1 = batched_mul_relin_rescale(
            (stack(0, "c0"), stack(0, "c1")), (stack(1, "c0"), stack(1, "c1")),
            rlk, ctx, ctx.drop_last(1))
        outs[device.type] = (rlk.b.cpu(), o0.cpu(), o1.cpu())
        launched = [f.launches - b for f, b in zip(counters, before)]
        assert all(n > 0 for n in launched) == (device.type == "cuda")
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert a.dtype == torch.int64 and torch.equal(a, b)


def test_slice_gpu_matches_cpu(dev):
    """Same seeds on both devices: keys, ciphertexts and the fused product
    are bit-identical, and the GPU run went through all three kernels."""
    degree, count, ds = 1 << 12, 4, 2
    values = np.random.default_rng(9).uniform(-1, 1, size=(2, 2, degree // 2))
    outs = {}
    for device in (torch.device("cpu"), dev):
        counts = [f.launches for f in (ntt_gpu.ntt_planes,
                                       keyswitch_gpu.gadget_accumulate,
                                       moddown_gpu.mod_down_combine)]
        ctx = port.CkksContext.build(port.generate_primes(31, count, degree),
                                     degree, device)
        eng = port.CkksEngine(ctx, port.CkksParams(3.2, degree // 2, 30))
        rng = make_rng(42)
        sk = eng.generate_secret_key(rng)
        pk = eng.generate_public_key(sk, rng)
        rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=ds)
        enc = port.CkksEncoder(degree, 30)
        cts = [[eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng)
                for v in side] for side in values]
        stack = lambda side, part: torch.stack([getattr(c, part).data for c in cts[side]])
        o0, o1 = batched_mul_relin_rescale(
            (stack(0, "c0"), stack(0, "c1")), (stack(1, "c0"), stack(1, "c1")),
            rlk, ctx, ctx.drop_last(1))
        outs[device.type] = (rlk.b.cpu(), o0.cpu(), o1.cpu())
        launched = [f.launches - c for f, c in zip(
            (ntt_gpu.ntt_planes, keyswitch_gpu.gadget_accumulate,
             moddown_gpu.mod_down_combine), counts)]
        assert all(n > 0 for n in launched) == (device.type == "cuda")
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(a, b)


def test_mxu_slice_gpu_matches_cpu(dev, monkeypatch):
    """Under CKKS_NTT_MXU=1 the fused multiply and a hoisted rotation sum
    on the GPU equal the CPU's words, and the GPU run launched K9."""
    monkeypatch.setenv("CKKS_NTT_MXU", "1")
    degree, count, ds = 1 << 12, 4, 2
    values = np.random.default_rng(9).uniform(-1, 1, size=(2, 2, degree // 2))
    outs = {}
    for device in (torch.device("cpu"), dev):
        before = ntt_mxu_gpu.ntt_mxu_planes.launches
        ctx = port.CkksContext.build(port.generate_primes(31, count, degree),
                                     degree, device)
        eng = port.CkksEngine(ctx, port.CkksParams(3.2, degree // 2, 30))
        rng = make_rng(42)
        sk = eng.generate_secret_key(rng)
        pk = eng.generate_public_key(sk, rng)
        rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=ds)
        rotks = [eng.generate_gadget_rotation_key(sk, k, rng, digit_size=ds)
                 for k in (1, 2)]
        enc = port.CkksEncoder(degree, 30)
        cts = [[eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng)
                for v in side] for side in values]
        stack = lambda side, part: torch.stack([getattr(c, part).data for c in cts[side]])
        o0, o1 = batched_mul_relin_rescale(
            (stack(0, "c0"), stack(0, "c1")), (stack(1, "c0"), stack(1, "c1")),
            rlk, ctx, ctx.drop_last(1))
        summed = port.CkksEngine.rotate_sum_hoisted(cts[0][0], rotks)
        outs[device.type] = (o0.cpu(), o1.cpu(), summed.c0.data.cpu(),
                             summed.c1.data.cpu())
        launched = ntt_mxu_gpu.ntt_mxu_planes.launches - before
        assert (launched > 0) == (device.type == "cuda")
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(a, b)


# ── K10 / K11: the coefficient-sharded NTT ───────────────────────────────

# (degree, shards, wide) whose slabs fit one block (<= 128 KiB)
COEFF = [(n, shards, wide) for n in (1 << 10, 1 << 14, 1 << 16)
         for shards in (1, 2, 4, 8) for wide in (False, True)
         if ((8 if wide else 4) * n) // shards <= ntt_gpu.SLICE_BYTES]


def _coeff_chain(degree, wide):
    bits = 61 if wide else 31
    dtype = torch.int64 if wide else torch.int32
    return tuple(port.generate_primes(bits, 3, degree)), dtype


@pytest.mark.parametrize("degree,shards,wide", COEFF)
@pytest.mark.parametrize("inverse", [False, True])
def test_coeff_kernels_match_twins_and_whole_plane(dev, degree, shards, wide,
                                                   inverse):
    """K11 per cross stage and K10 each against its twin on the same CUDA
    slabs, K11's one-launch form against the per-stage kernels; the
    sharded NTT word-equal to K1 / K4 / K5 / K5' on the whole plane, with
    one K10 launch and, for P >= 2, one K11 launch of the one-launch form
    (none of the per-stage form), K10's on a cluster where ``slab_form``
    picks one (K11 never)."""
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
    from toy_heaan_ckks_tpu_torch.parallel.coeff_ntt import coeff_ntt
    from toy_heaan_ckks_tpu_torch.parallel.mesh import (
        make_coeff_mesh, shard_planes, unshard_planes,
    )

    moduli, dtype = _coeff_chain(degree, wide)
    x = _planes(degree + shards, moduli, degree, (2,), dev, dtype)
    mesh = make_coeff_mesh(shards, dev)
    slabs = shard_planes(x, mesh)
    cross = shards.bit_length() - 1
    final = tuple(pow(degree, -1, q) for q in moduli) if inverse else None
    stages = range(cross - 1, -1, -1) if inverse else range(cross)
    s = slabs
    if inverse:
        s = cg.coeff_tail(s, moduli, degree, True, final if cross == 0 else None)
        twin = cg.coeff_tail_twin(slabs, moduli, degree, True,
                                  final if cross == 0 else None)
        assert all(torch.equal(a, b) for a, b in zip(s, twin))
    one_launch = cg.coeff_cross_stages(s, moduli, degree, inverse, final) if cross else s
    for st in stages:
        fin = final if inverse and st == 0 else None
        nxt = cg.coeff_cross(s, moduli, degree, st, inverse, fin)
        twin = cg.coeff_cross_twin(s, moduli, degree, st, inverse, fin)
        assert all(torch.equal(a, b) for a, b in zip(nxt, twin))
        s = nxt
    assert all(torch.equal(a, b) for a, b in zip(one_launch, s))
    if not inverse:
        tail = cg.coeff_tail(s, moduli, degree, False)
        twin = cg.coeff_tail_twin(s, moduli, degree, False)
        assert all(torch.equal(a, b) for a, b in zip(tail, twin))
        s = tail
    counters = (cg.coeff_tail, cg.coeff_cross, cg.coeff_cross_stages)
    before = [(f.launches, f.launches_cluster) for f in counters]
    out = coeff_ntt(slabs, moduli, degree, inverse)
    after = [(f.launches, f.launches_cluster) for f in counters]
    log_s = (degree // shards).bit_length() - 1
    cluster = cg.slab_form(wide, log_s, 2 * len(moduli) * shards) == "cluster"
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)] == [
        (1, int(cluster)), (0, 0), (int(cross > 0), 0)]
    whole = (ntt_gpu.ntt_planes_wide if wide else ntt_gpu.ntt_planes)(
        x, moduli, degree, inverse)
    assert torch.equal(unshard_planes(out), whole)
    assert torch.equal(unshard_planes(s), whole)


@pytest.mark.parametrize("shards", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("inverse,final", [(False, False), (True, True), (True, False),
                                           (False, True)])
def test_coeff_cross_stages_match_per_stage(dev, shards, wide, inverse, final):
    """K11's one-launch form (P <= 16: one launch, no per-stage launch) at
    N = 2^14 against the per-stage kernels run stage by stage and against
    their composed twins, with and without the final factor; at P = 32 the
    entry runs the per-stage form, one launch a stage."""
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
    from toy_heaan_ckks_tpu_torch.parallel.mesh import make_coeff_mesh, shard_planes

    degree = 1 << 14
    moduli, dtype = _coeff_chain(degree, wide)
    x = _planes(shards + 3 * inverse, moduli, degree, (2,), dev, dtype)
    slabs = shard_planes(x, make_coeff_mesh(shards, dev))
    fin = tuple(pow(degree, -1, q) for q in moduli) if final else None
    cross = shards.bit_length() - 1
    stages = list(range(cross - 1, -1, -1) if inverse else range(cross))
    staged, twin = slabs, slabs
    for st in stages:
        f = fin if st == stages[-1] else None
        staged = cg.coeff_cross(staged, moduli, degree, st, inverse, f)
        twin = cg.coeff_cross_twin(twin, moduli, degree, st, inverse, f)
    before = cg.coeff_cross.launches, cg.coeff_cross_stages.launches
    got = cg.coeff_cross_stages(slabs, moduli, degree, inverse, fin)
    fused = shards <= cg.STAGES_MAX_SHARDS
    assert (cg.coeff_cross.launches - before[0],
            cg.coeff_cross_stages.launches - before[1]) == ((0, 1) if fused else (cross, 0))
    for g, a, b in zip(got, staged, twin):
        assert torch.equal(g, a) and torch.equal(g, b)


# every register form of K10 that csrc/coeff_ntt.cuh builds: (wide, log2
# S, form), one block (uint32 slabs of 2^10 .. 2^15, uint64 of 2^10 ..
# 2^12) or the slab's cluster (2^12 words and up)
TAIL_FORMS = [(wide, log_s, form) for wide in (False, True)
              for log_s in range(10, 15 if wide else 16)
              for form in ("block", "cluster")
              if (form == "block" and log_s <= (12 if wide else 15))
              or (form == "cluster" and log_s >= 12)]


@pytest.mark.parametrize("wide,log_s,form", TAIL_FORMS)
def test_coeff_tail_every_form_matches_twin(dev, monkeypatch, wide, log_s, form):
    """Each built form of K10 (``slab_form`` patched to pick it) on the
    slabs of P = 2 (N = 2S) and of P = 4, forward and inverse with the
    final factor, word-equal to its twin, and the inverse on a slab one
    word off a 16-byte boundary (the wrapper copies it for the 16-byte
    runs)."""
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
    from toy_heaan_ckks_tpu_torch.parallel.mesh import make_coeff_mesh, shard_planes

    monkeypatch.setattr(cg, "slab_form", lambda w, s, slabs: form)
    for shards in (2, 4):
        degree = shards << log_s
        if degree > 1 << 16:
            continue
        moduli, dtype = _coeff_chain(degree, wide)
        x = _planes(log_s + shards, moduli, degree, (2,), dev, dtype)
        slabs = shard_planes(x, make_coeff_mesh(shards, dev))
        fin = tuple(pow(degree, -1, q) for q in moduli)
        for inverse, final in ((False, None), (True, fin), (False, fin)):
            got, counts = _counted(cg.coeff_tail, lambda: cg.coeff_tail(
                slabs, moduli, degree, inverse, final))
            assert counts == (1, int(form == "cluster"))
            want = cg.coeff_tail_twin(slabs, moduli, degree, inverse, final)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        off = []
        for t in slabs:
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            flat[1:] = t.reshape(-1)
            off.append(flat[1:].view(t.shape))
        got = cg.coeff_tail(tuple(off), moduli, degree, True, fin)
        want = cg.coeff_tail_twin(slabs, moduli, degree, True, fin)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("wide,log_s,form", [(True, 13, "block"), (False, 11, "cluster"),
                                             (False, 9, "cluster")])
def test_coeff_tail_unbuilt_form_raises(dev, monkeypatch, wide, log_s, form):
    """A form that csrc/coeff_ntt.cuh does not build (one block for a
    uint64 slab of 2^13, a cluster for a slab below 2^12) raises and
    launches nothing: no form gives way to another."""
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
    from toy_heaan_ckks_tpu_torch.parallel.mesh import make_coeff_mesh, shard_planes

    monkeypatch.setattr(cg, "slab_form", lambda w, s, slabs: form)
    degree = 2 << log_s
    moduli, dtype = _coeff_chain(degree, wide)
    x = _planes(log_s, moduli, degree, (2,), dev, dtype)
    slabs = shard_planes(x, make_coeff_mesh(2, dev))
    before = cg.coeff_tail.launches, cg.coeff_tail.launches_cluster
    with pytest.raises(RuntimeError):
        cg.coeff_tail(slabs, moduli, degree, False)
    assert (cg.coeff_tail.launches, cg.coeff_tail.launches_cluster) == before


@pytest.mark.parametrize("degree,shards,wide", [(1 << 16, 1, False),
                                                (1 << 15, 1, True)])
def test_coeff_tail_refuses_a_slab_above_one_block(dev, degree, shards, wide):
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
    from toy_heaan_ckks_tpu_torch.parallel.mesh import make_coeff_mesh, shard_planes

    moduli, dtype = _coeff_chain(degree, wide)
    x = _planes(1, moduli, degree, (1,), dev, dtype)
    with pytest.raises(ValueError, match="exceeds"):
        cg.coeff_tail(shard_planes(x, make_coeff_mesh(shards, dev)), moduli,
                      degree, False)


@pytest.mark.parametrize("bits,count,digit_size", [(31, 4, 2), (61, 3, 1)])
def test_coeff_composites_match_unsharded_on_card(dev, bits, count, digit_size):
    """At N = 1024 on 8 shards of the card: the coefficient-sharded multiply
    and rotation equal the unsharded composites on the card word for word,
    and ran K10 and K11 (one launch of the one-launch form a transform)."""
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
    from toy_heaan_ckks_tpu_torch.parallel.coeff_composite import (
        build_mul_relin_rescale_coeff, build_rotate_coeff,
    )
    from toy_heaan_ckks_tpu_torch.parallel.mesh import (
        make_coeff_mesh, shard_planes, unshard_planes,
    )
    from toy_heaan_ckks_tpu_torch.parallel.sharded import (
        _mul_relin_rescale_arrays, _rotate_arrays,
    )

    degree = 1 << 10
    ctx = port.CkksContext.build(port.generate_primes(bits, count, degree), degree, dev)
    eng = port.CkksEngine(ctx, port.CkksParams(3.2, degree // 2, 30))
    rng = make_rng(42)
    sk = eng.generate_secret_key(rng)
    rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=digit_size)
    rotk = eng.generate_gadget_rotation_key(sk, 1, rng, digit_size=digit_size)
    args = [_planes(20 + i, ctx.moduli, degree, (2,), dev, rlk.a.dtype) for i in range(4)]
    mesh = make_coeff_mesh(8, dev)
    sh = lambda t: shard_planes(t, mesh)
    before = cg.coeff_tail.launches, cg.coeff_cross.launches, cg.coeff_cross_stages.launches
    got = build_mul_relin_rescale_coeff(mesh, ctx, rlk.ext_ctx, digit_size)(
        *map(sh, args), sh(rlk.a), sh(rlk.b))
    want = _mul_relin_rescale_arrays(*args, rlk.a, rlk.b, ctx, rlk.ext_ctx,
                                     ctx.drop_last(1), digit_size=digit_size)
    perm = ctx.automorphism_table_ntt(pow(5, 1, 2 * degree))
    rot = build_rotate_coeff(mesh, ctx, rotk.ext_ctx, perm, digit_size)(
        sh(args[0]), sh(args[1]), sh(rotk.a), sh(rotk.b))
    rot_want = _rotate_arrays(args[0], args[1], rotk.a, rotk.b, perm, ctx,
                              rotk.ext_ctx, digit_size)
    for g, w in zip(got + rot, want + rot_want):
        assert torch.equal(unshard_planes(g), w)
    assert cg.coeff_tail.launches - before[0] == 12
    assert cg.coeff_cross.launches - before[1] == 0
    assert cg.coeff_cross_stages.launches - before[2] == 12


def _cards(count: int):
    if torch.cuda.device_count() < count:
        pytest.skip(f"needs {count} CUDA devices")
    return [torch.device("cuda", i) for i in range(count)]


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("wide", [False, True])
def test_coeff_ntt_across_cards(dev, shards, wide):
    """Shards on four cards (two per card at P = 8): K11 keeps its
    per-stage form and reads partner slabs through peer pointers, one
    launch per card and stage (none of the one-launch form), and the
    words equal K1 / K5 on the whole plane on one card."""
    from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu as cg
    from toy_heaan_ckks_tpu_torch.parallel.coeff_ntt import coeff_ntt
    from toy_heaan_ckks_tpu_torch.parallel.mesh import (
        make_coeff_mesh, shard_planes, unshard_planes,
    )

    cards = _cards(4)
    degree = 1 << 14
    moduli, dtype = _coeff_chain(degree, wide)
    x = _planes(shards, moduli, degree, (2,), dev, dtype)
    mesh = make_coeff_mesh(shards, [cards[p * 4 // shards] for p in range(shards)])
    slabs = shard_planes(x, mesh)
    whole = ntt_gpu.ntt_planes_wide if wide else ntt_gpu.ntt_planes
    for inverse in (False, True):
        before = (cg.coeff_tail.launches, cg.coeff_cross.launches,
                  cg.coeff_cross_stages.launches)
        out = coeff_ntt(slabs, moduli, degree, inverse)
        assert [t.device for t in out] == list(mesh.devices)
        assert (cg.coeff_tail.launches - before[0], cg.coeff_cross.launches - before[1],
                cg.coeff_cross_stages.launches - before[2]) == (
            4, 4 * (shards.bit_length() - 1), 0)
        assert torch.equal(unshard_planes(out).to(dev), whole(x, moduli, degree, inverse))


@pytest.mark.parametrize("bits,count,digit_size", [(31, 4, 2), (61, 3, 1)])
def test_coeff_composites_across_cards(dev, bits, count, digit_size):
    """The sharded multiply and rotation with one shard on each of four
    cards equal the unsharded composites on one card."""
    from toy_heaan_ckks_tpu_torch.parallel.coeff_composite import (
        build_mul_relin_rescale_coeff, build_rotate_coeff,
    )
    from toy_heaan_ckks_tpu_torch.parallel.mesh import (
        make_coeff_mesh, shard_planes, unshard_planes,
    )
    from toy_heaan_ckks_tpu_torch.parallel.sharded import (
        _mul_relin_rescale_arrays, _rotate_arrays,
    )

    cards = _cards(4)
    degree = 1 << 10
    ctx = port.CkksContext.build(port.generate_primes(bits, count, degree), degree, dev)
    eng = port.CkksEngine(ctx, port.CkksParams(3.2, degree // 2, 30))
    rng = make_rng(42)
    sk = eng.generate_secret_key(rng)
    rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=digit_size)
    rotk = eng.generate_gadget_rotation_key(sk, 1, rng, digit_size=digit_size)
    args = [_planes(30 + i, ctx.moduli, degree, (2,), dev, rlk.a.dtype) for i in range(4)]
    mesh = make_coeff_mesh(4, cards)
    sh = lambda t: shard_planes(t, mesh)
    got = build_mul_relin_rescale_coeff(mesh, ctx, rlk.ext_ctx, digit_size)(
        *map(sh, args), sh(rlk.a), sh(rlk.b))
    want = _mul_relin_rescale_arrays(*args, rlk.a, rlk.b, ctx, rlk.ext_ctx,
                                     ctx.drop_last(1), digit_size=digit_size)
    perm = ctx.automorphism_table_ntt(pow(5, 1, 2 * degree))
    rot = build_rotate_coeff(mesh, ctx, rotk.ext_ctx, perm, digit_size)(
        sh(args[0]), sh(args[1]), sh(rotk.a), sh(rotk.b))
    rot_want = _rotate_arrays(args[0], args[1], rotk.a, rotk.b, perm, ctx,
                              rotk.ext_ctx, digit_size)
    for g, w in zip(got + rot, want + rot_want):
        assert [t.device for t in g] == cards
        assert torch.equal(unshard_planes(g).to(dev), w)


# ── the batch x channel mesh ─────────────────────────────────────────────

# (prime bits, count, digit_size, the rotation mesh's points and batch axis):
# the rotation's key_spec splits D digits over its channel axis
MESH_CHAINS = [(31, 4, 2, 8, 4), (61, 3, 1, 3, 1)]


def _mesh_case(dev, bits, count, digit_size, degree=1 << 12):
    ctx = port.CkksContext.build(port.generate_primes(bits, count, degree), degree, dev)
    eng = port.CkksEngine(ctx, port.CkksParams(3.2, degree // 2, 30))
    rng = make_rng(42)
    sk = eng.generate_secret_key(rng)
    rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=digit_size)
    rotk = eng.generate_gadget_rotation_key(sk, 1, rng, digit_size=digit_size)
    args = [_planes(40 + i, ctx.moduli, degree, (4,), dev, rlk.a.dtype) for i in range(4)]
    return ctx, rlk, rotk, args


def _mesh_calls(ctx, rlk, rotk, args, mul_devices, rot_devices, rot_batch):
    """The sharded multiply on make_ckks_mesh(len(mul_devices), batch=2)
    and the rotation by 1 on make_ckks_mesh(len(rot_devices), rot_batch),
    each output unsharded."""
    from toy_heaan_ckks_tpu_torch.parallel import mesh as pm
    from toy_heaan_ckks_tpu_torch.parallel.sharded import (
        build_mul_relin_rescale, build_rotate,
    )

    L, n = ctx.num_channels, ctx.degree
    m = pm.make_ckks_mesh(len(mul_devices), batch=2, devices=mul_devices)
    data_s, key_s = pm.ct_spec_for(m, L), pm.key_spec_for(m, rlk.a.shape[0])
    mul = build_mul_relin_rescale(m, ctx, rlk.ext_ctx, rlk.digit_size)(
        *(pm.shard(a, data_s) for a in args), pm.shard(rlk.a, key_s),
        pm.shard(rlk.b, key_s))
    r = pm.make_ckks_mesh(len(rot_devices), batch=rot_batch, devices=rot_devices)
    perm = ctx.automorphism_table_ntt(pow(5, 1, 2 * n))
    rot = build_rotate(r, ctx, rotk.ext_ctx, perm, rotk.digit_size)(
        pm.shard(args[0], pm.ct_spec(r)), pm.shard(args[1], pm.ct_spec(r)),
        pm.shard(rotk.a, pm.key_spec(r)), pm.shard(rotk.b, pm.key_spec(r)))
    return [pm.unshard(t) for t in mul + rot], perm


@pytest.mark.parametrize("bits,count,digit_size,rot_points,rot_batch", MESH_CHAINS)
def test_mesh_composites_match_cpu_twin(dev, bits, count, digit_size, rot_points,
                                        rot_batch):
    """At N = 2^12, every grid point on the card: the sharded multiply
    (make_ckks_mesh(8, batch=2)) and rotation by 1 equal the unsharded
    composites run as the twins on the CPU word for word, and K2 / K6
    launched on each point's digit range."""
    from toy_heaan_ckks_tpu_torch.parallel.sharded import (
        _mul_relin_rescale_arrays, _rotate_arrays,
    )

    ctx, rlk, rotk, args = _mesh_case(dev, bits, count, digit_size)
    switch = (keyswitch_gpu.gadget_accumulate if ctx.chain.small
              else keyswitch_gpu.gadget_accumulate_wide)
    switch.digit_ranges.clear()
    got, perm = _mesh_calls(ctx, rlk, rotk, args, [dev] * 8, [dev] * rot_points,
                            rot_batch)
    D = rlk.a.shape[0]
    assert sorted(set(switch.digit_ranges)) == [(t, t + 1) for t in range(D)]
    cpu = torch.device("cpu")
    cctx = port.CkksContext.build(ctx.moduli, ctx.degree, cpu)
    ext = port.CkksContext.build(rlk.ext_ctx.moduli, ctx.degree, cpu)
    rext = port.CkksContext.build(rotk.ext_ctx.moduli, ctx.degree, cpu)
    a = [t.cpu() for t in args]
    want = list(_mul_relin_rescale_arrays(*a, rlk.a.cpu(), rlk.b.cpu(), cctx, ext,
                                          cctx.drop_last(1), digit_size))
    want += _rotate_arrays(a[0], a[1], rotk.a.cpu(), rotk.b.cpu(), perm.cpu(), cctx,
                           rext, digit_size)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("bits,count,digit_size,rot_points,rot_batch", MESH_CHAINS)
def test_mesh_across_cards(dev, bits, count, digit_size, rot_points, rot_batch):
    """The same calls with the grid points dealt over every card (two or
    more): the collectives copy blocks card to card, and the words equal
    the mesh on one card."""
    k = torch.cuda.device_count()
    if k < 2:
        pytest.skip("needs 2 CUDA devices")
    cards = _cards(k)
    ctx, rlk, rotk, args = _mesh_case(dev, bits, count, digit_size)
    spread, _ = _mesh_calls(ctx, rlk, rotk, args, [cards[p % k] for p in range(8)],
                            [cards[p % k] for p in range(rot_points)], rot_batch)
    one, _ = _mesh_calls(ctx, rlk, rotk, args, [dev] * 8, [dev] * rot_points, rot_batch)
    for g, w in zip(spread, one):
        assert torch.equal(g.to(dev), w)


# ── the bootstrap path (models/bootstrap.py) ─────────────────────────────


def _boot_setup(device, degree, count=28, hw=8, digit_size=4):
    """The small-prime bootstrap recipe (28 x 31-bit, ds 4, h 8) of
    chip_smoke.py phase 3f at ``degree``, drawn from make_rng(33)."""
    from toy_heaan_ckks_tpu_torch.models import BootstrapKeys

    full = port.CkksContext.build(port.generate_primes(31, count, degree), degree, device)
    ctx1 = full.slice_channels(0, 1)
    params = port.CkksParams(3.2, hw, 31)
    rng = make_rng(33)
    sk = port.CkksEngine(full, params).generate_secret_key(rng)
    eng1 = port.CkksEngine(ctx1, params)
    pk1 = eng1.generate_public_key(sk.reduce_to(ctx1), rng)
    ladder = port.KeyLadder(full, sk, 3.2, rng, lazy=True, digit_size=digit_size)
    bkeys = BootstrapKeys(ladder, params, rng, digit_size=digit_size)
    enc = port.CkksEncoder(degree, 31)
    m = np.random.default_rng(9).uniform(-0.02, 0.02, degree // 2)
    ct1 = eng1.encrypt(enc.encode(m, ctx1), pk1, ctx1.total_bits(), rng)
    return full, params, sk, bkeys, enc, m, ct1


def test_bootstrap_refresh_matches_cpu(dev):
    """The whole refresh at N = 2^10 (r 7, deg 8, dft_levels 3, arcsine):
    c0 / c1 on the card equal the CPU path's from the same seeds, K1, K2
    and K3 launched (none on a cluster), and the decode near the message."""
    from toy_heaan_ckks_tpu_torch.models import bootstrap

    kw = dict(r=7, deg=8, dft_levels=3, arcsine=True)
    outs = []
    for device in (dev, torch.device("cpu")):
        full, params, sk, bkeys, enc, m, ct1 = _boot_setup(device, 1 << 10)
        fns = (ntt_gpu.ntt_planes, keyswitch_gpu.gadget_accumulate,
               moddown_gpu.mod_down_combine)
        before = [(f.launches, f.launches_cluster) for f in fns]
        outs.append(bootstrap(ct1, full, bkeys, params, enc, **kw))
        counts = [(f.launches - a, f.launches_cluster - c) for f, (a, c) in zip(fns, before)]
        if device == dev:
            assert all(n > 0 and c == 0 for n, c in counts), counts
            got = enc.decode(port.CkksEngine.decrypt(outs[0], sk.reduce_to(outs[0].ctx)))
            assert np.max(np.abs(got - m)) < 2e-3
    gpu, cpu = outs
    assert (gpu.level, gpu.logp, gpu.true_scale) == (cpu.level, cpu.logp, cpu.true_scale)
    assert torch.equal(gpu.c0.data.cpu(), cpu.c0.data)
    assert torch.equal(gpu.c1.data.cpu(), cpu.c1.data)


@pytest.mark.parametrize("degree", [1 << 10, 1 << 16])
@pytest.mark.parametrize("lift", ["fast", "general"])
def test_raise_modulus_on_card(dev, degree, lift):
    """raise_modulus on the card (the device lift, or the host big-int one
    for 29-bit targets) equals the CPU's words."""
    from toy_heaan_ckks_tpu_torch.models import raise_modulus

    primes = port.generate_primes(31, 6, degree)
    if lift == "general":
        primes = primes[:1] + port.generate_primes(29, 4, degree)
    outs = []
    for device in (dev, torch.device("cpu")):
        full = port.CkksContext.build(primes, degree, device)
        ctx1 = full.slice_channels(0, 1)
        params = port.CkksParams(3.2, 8, 30)
        rng = make_rng(3)
        sk = port.CkksEngine(full, params).generate_secret_key(rng)
        eng1 = port.CkksEngine(ctx1, params)
        pk1 = eng1.generate_public_key(sk.reduce_to(ctx1), rng)
        enc = port.CkksEncoder(degree, 30)
        ct1 = eng1.encrypt(enc.encode(np.linspace(-0.9, 0.9, degree // 2), ctx1), pk1,
                           ctx1.total_bits(), rng)
        outs.append(raise_modulus(ct1, full))
    assert outs[0].c0.data.is_cuda
    for part in ("c0", "c1"):
        assert torch.equal(getattr(outs[0], part).data.cpu(), getattr(outs[1], part).data)


def test_hoisted_sum_chunks_on_card(dev, monkeypatch):
    """The double-hoisted weighted sum in chunks of keys (engine
    HOIST_SUM_WORDS) gives the words of one pass on the card."""
    from toy_heaan_ckks_tpu_torch import engine
    from toy_heaan_ckks_tpu_torch.models.bootstrap import _grouped_dft_diagonals

    degree = 1 << 10
    full, params, sk, bkeys, enc, m, ct1 = _boot_setup(dev, degree, count=6)
    pk = port.CkksEngine(full, params).generate_public_key(sk, make_rng(5))
    ct = port.CkksEngine(full, params).encrypt(enc.encode(m, full), pk, full.total_bits(),
                                                make_rng(6))
    diag_map = _grouped_dft_diagonals(degree, 3)[0][1]
    offs = sorted(r for r in diag_map if r)
    keys = [bkeys.rot_key(ct.level, r) for r in offs]
    pts = bkeys.encoded_diags(diag_map, offs, keys[0].ext_ctx, enc)
    whole = port.CkksEngine.rotate_weighted_sum_hoisted(ct, keys, pts)
    monkeypatch.setattr(engine, "HOIST_SUM_WORDS", keys[0].a.numel() * 4)
    chunked = port.CkksEngine.rotate_weighted_sum_hoisted(ct, keys, pts)
    assert len(offs) > 4
    assert torch.equal(whole.c0.data, chunked.c0.data)
    assert torch.equal(whole.c1.data, chunked.c1.data)


# ── the last models (models/compare.py, models/linalg.py) ────────────────


def _cmp_setup(device, degree, depth):
    """examples/encrypted_compare.py's recipe at ``degree`` on the NTT primes
    of 2^16 (``build_modulus_chain(2^16, 30, depth)``: q0 of 40 bits, a wide
    chain), drawn from make_rng(42) and np.random.default_rng(7)."""
    plan = port.build_modulus_chain(1 << 16, 30, depth)
    ctx = port.CkksContext.build(list(plan.moduli), degree, device)
    params = port.CkksParams(3.2, degree // 2, 30)
    eng = port.CkksEngine(ctx, params)
    enc = port.CkksEncoder(degree, 30)
    rng = make_rng(42)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    ladder = port.KeyLadder(ctx, sk, 3.2, rng, lazy=True)
    vals = np.random.default_rng(7)
    lo = vals.uniform(0.0, 0.35, degree // 2)
    hi = lo + vals.uniform(0.25, 0.6, degree // 2)
    cts = [eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng) for v in (hi, lo)]
    return ladder, params, cts, sk, enc


def test_compare_matches_cpu(dev):
    """compare at N = 2^10 (one f_1 step on a 9-prime chain): c0 / c1 on the
    card equal the CPU path's, K5/K7, K6 and K8 launched, none on a cluster;
    the decode near the host composition (f_1(a - b) + 1) / 2."""
    from toy_heaan_ckks_tpu_torch.models import compare as cmp_fn
    from toy_heaan_ckks_tpu_torch.models.compare import _compose_sign

    outs = []
    fns = (ntt_gpu.ntt_planes_wide, keyswitch_gpu.gadget_accumulate_wide,
           moddown_gpu.mod_down_combine_wide)
    for device in (dev, torch.device("cpu")):
        ladder, params, cts, sk, enc = _cmp_setup(device, 1 << 10, 8)
        before = [(f.launches, f.launches_cluster) for f in fns]
        outs.append(cmp_fn(ladder, params, *cts, g_iters=0, f_iters=1, n=1))
        counts = [(f.launches - a, f.launches_cluster - c) for f, (a, c) in zip(fns, before)]
        if device == dev:
            assert all(n > 0 and c == 0 for n, c in counts), counts
            got = enc.decode(port.CkksEngine.decrypt(outs[0], sk.reduce_to(outs[0].ctx)))
    gpu, cpu = outs
    assert (gpu.level, gpu.logp, gpu.true_scale) == (cpu.level, cpu.logp, cpu.true_scale)
    assert torch.equal(gpu.c0.data.cpu(), cpu.c0.data)
    assert torch.equal(gpu.c1.data.cpu(), cpu.c1.data)
    vals = np.random.default_rng(7)
    lo = vals.uniform(0.0, 0.35, 512)
    hi = lo + vals.uniform(0.25, 0.6, 512)
    # the CPU path's words decode within 1.8e-4 of the host composition
    assert np.max(np.abs(got - (_compose_sign(hi - lo, 0, 1, 1) + 1) / 2)) < 1e-3


def test_encrypted_matmul_matches_cpu(dev):
    """encrypted_matmul at d = 16 (N = 2^9, 5 x 30-bit): c0 / c1 on the card
    equal the CPU path's, K1, K2 and K3 launched, none on a cluster; the
    decode near A @ B."""
    from toy_heaan_ckks_tpu_torch.models.linalg import MatvecKeys, encrypted_matmul

    d, n = 16, 512
    outs = []
    fns = (ntt_gpu.ntt_planes, keyswitch_gpu.gadget_accumulate, moddown_gpu.mod_down_combine)
    for device in (dev, torch.device("cpu")):
        ctx = port.CkksContext.build(port.generate_primes(30, 5, n), n, device)
        params = port.CkksParams(3.2, n // 2, 30)
        eng = port.CkksEngine(ctx, params)
        enc = port.CkksEncoder(n, 30)
        rng = make_rng(42)
        sk = eng.generate_secret_key(rng)
        pk = eng.generate_public_key(sk, rng)
        keys = MatvecKeys(port.KeyLadder(ctx, sk, 3.2, rng, lazy=True), params, rng)
        vals = np.random.default_rng(7)
        a = vals.uniform(-1, 1, (d, d)) / np.sqrt(d)
        b = vals.uniform(-1, 1, (d, d)) / np.sqrt(d)
        ca, cb = (eng.encrypt(enc.encode(m.reshape(-1), ctx), pk, ctx.total_bits(), rng)
                  for m in (a, b))
        before = [(f.launches, f.launches_cluster) for f in fns]
        outs.append(encrypted_matmul(ca, cb, keys, enc))
        counts = [(f.launches - x, f.launches_cluster - c) for f, (x, c) in zip(fns, before)]
        if device == dev:
            assert all(k > 0 and c == 0 for k, c in counts), counts
            got = enc.decode(port.CkksEngine.decrypt(outs[0], sk.reduce_to(outs[0].ctx)))
            assert np.max(np.abs(got[: d * d].reshape(d, d) - a @ b)) < 1e-3
    gpu, cpu = outs
    assert (gpu.level, gpu.logp, gpu.true_scale) == (cpu.level, cpu.logp, cpu.true_scale)
    assert torch.equal(gpu.c0.data.cpu(), cpu.c0.data)
    assert torch.equal(gpu.c1.data.cpu(), cpu.c1.data)
