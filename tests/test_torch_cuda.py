"""PyTorch port on the card: each CUDA kernel against its torch twin, and
the slice on the GPU against the slice on the CPU (uint32 equality on
small chains, uint64 equality on wide ones).

Marked ``cuda``; every test skips where no CUDA device is present. The
file imports neither jax nor the reference, so it also runs where only
torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch.keys import default_special_primes
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu, moddown_gpu, ntt_gpu
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


@pytest.mark.parametrize("degree", [1 << 10, 1 << 12, 1 << 15])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_matches_twin(dev, degree, inverse):
    moduli, _ = _chain(3, 1, degree)
    x = _planes(degree, moduli, degree, (3,), dev)
    final = tuple(range(5, 8)) if inverse else None
    got = ntt_gpu.ntt_planes(x, moduli, degree, inverse, final)
    assert torch.equal(got, ntt_gpu.ntt_twin(x, moduli, degree, inverse, final))


@pytest.mark.parametrize("digit_size,count", [(1, 2), (2, 3), (3, 4), (4, 8), (8, 4)])
@pytest.mark.parametrize("with_d", [True, False])
def test_keyswitch_kernel_matches_twin(dev, digit_size, count, with_d):
    degree = 1 << 12
    base, ext = _chain(count, min(digit_size, count), degree)
    digits = -(-count // digit_size)
    y = _planes(1, base, degree, (2,), dev)
    d = _planes(2, base, degree, (2,), dev) if with_d else None
    ka = _planes(3, ext, degree, (digits,), dev)
    kb = _planes(4, ext, degree, (digits,), dev)
    got = keyswitch_gpu.gadget_accumulate(
        y, ka, kb, base_moduli=base, ext_moduli=ext, degree=degree,
        digit_size=digit_size, d_ntt=d,
    )
    want = keyswitch_gpu.gadget_accumulate_twin(
        y, ka, kb, base, ext, degree, digit_size, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("with_t", [True, False])
def test_moddown_kernel_matches_twin(dev, with_t):
    degree = 1 << 12
    base, ext = _chain(5, 2, degree)
    child, dropped = base[:4], ext[4:]
    t_scale = 123456789 if with_t else 0
    yhat = _planes(5, dropped, degree, (3,), dev)
    ks = _planes(6, ext, degree, (3,), dev)[..., :4, :]
    t = _planes(7, base, degree, (3,), dev)[..., :4, :] if with_t else None
    kw = dict(child_moduli=child, dropped_moduli=dropped, degree=degree,
              t_scale=t_scale)
    got = moddown_gpu.mod_down_combine(yhat, ks, t, **kw)
    want = moddown_gpu.mod_down_combine_twin(yhat, ks, t, child, dropped,
                                             degree, t_scale)
    assert torch.equal(got, want)


# wide chains: 61-bit at 2^13 (the wide main path), 62-bit with 63-bit
# specials at 2^14 (the 128 KiB uint64 plane), 40-bit at 2^10
WIDE = [(61, 1 << 13), (62, 1 << 14), (40, 1 << 10)]


@pytest.mark.parametrize("bits,degree", WIDE)
@pytest.mark.parametrize("inverse", [False, True])
def test_wide_ntt_kernel_matches_twin(dev, bits, degree, inverse):
    _, moduli = _chain(2, 1, degree, bits)  # a base prime and a special
    x = _planes(degree + bits, moduli, degree, (2,), dev, torch.int64)
    final = tuple((q - 1) // 3 for q in moduli) if inverse else None
    got = ntt_gpu.ntt_planes_wide(x, moduli, degree, inverse, final)
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
