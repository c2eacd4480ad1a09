"""PyTorch port, the whole slice: keygen -> encrypt -> fused multiply with
relinearization and rescale -> decrypt, held to the JAX reference.

Both packages run from the same numpy seeds at N = 1024, L = 4 31-bit
primes, digit_size 2, batch 2. Keys, ciphertexts and the fused outputs
must be bit-identical (uint32 equality) to the reference's
``CkksEngine.mul_rescale`` / ``_mul_relin_rescale_arrays`` on the CPU
(its generic jnp path, which tests/test_fused_mult.py pins bit-exact with
the Pallas path); decoded slots must meet the reference tests' 1e-4 bound.
The reference objects are built once per module.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu.parallel.sharded import (
    _mul_relin_rescale_arrays as ref_mul_arrays,
)

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch.errors import ChannelCountMismatch
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu, moddown_gpu, ntt_gpu
from toy_heaan_ckks_tpu_torch.parallel.sharded import (
    _mul_relin_rescale_arrays, batched_mul_relin_rescale,
)

DEGREE = 1024
COUNT = 4
DIGIT_SIZE = 2
BATCH = 2
SCALE_BITS = 30
ATOL = 1e-4  # the reference tests' bound (tests/test_fused_mult.py)


def _run(pkg, values):
    """Keys and BATCH ciphertext pairs from seed 42, through ``pkg``."""
    kw = {"device": "cpu"} if pkg is port else {}
    ctx = pkg.CkksContext.build(pkg.generate_primes(31, COUNT, DEGREE), DEGREE, **kw)
    eng = pkg.CkksEngine(ctx, pkg.CkksParams(3.2, DEGREE // 2, SCALE_BITS))
    rng = make_rng(42)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=DIGIT_SIZE)
    enc = pkg.CkksEncoder(DEGREE, SCALE_BITS)
    cts = [[eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng)
            for v in side] for side in values]
    return dict(ctx=ctx, eng=eng, sk=sk, pk=pk, rlk=rlk, enc=enc, cts=cts)


@pytest.fixture(scope="module")
def both():
    vr = np.random.default_rng(3)
    values = vr.uniform(-1, 1, size=(2, BATCH, DEGREE // 2))
    r, p = _run(ref, values), _run(port, values)
    # the fused composite, batched, through both packages
    stack_r = lambda side, part: jnp.stack(
        [getattr(c, part).data for c in r["cts"][side]])
    stack_p = lambda side, part: torch.stack(
        [getattr(c, part).data for c in p["cts"][side]])
    r["out"] = ref_mul_arrays(
        stack_r(0, "c0"), stack_r(0, "c1"), stack_r(1, "c0"), stack_r(1, "c1"),
        r["rlk"].a, r["rlk"].b, r["ctx"], r["rlk"].ext_ctx,
        r["ctx"].drop_last(1), digit_size=DIGIT_SIZE,
    )
    p["out"] = batched_mul_relin_rescale(
        (stack_p(0, "c0"), stack_p(0, "c1")), (stack_p(1, "c0"), stack_p(1, "c1")),
        p["rlk"], p["ctx"], p["ctx"].drop_last(1),
    )
    r["single"] = ref.CkksEngine.mul_rescale(r["cts"][0][0], r["cts"][1][0], r["rlk"])
    p["single"] = port.CkksEngine.mul_rescale(p["cts"][0][0], p["cts"][1][0], p["rlk"])
    return dict(ref=r, port=p, values=values)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(
        convert.to_reference(got), np.asarray(want, dtype=np.uint32))


def test_contexts_and_specials_match(both):
    r, p = both["ref"], both["port"]
    assert p["ctx"].moduli == r["ctx"].moduli
    assert p["rlk"].ext_ctx.moduli == r["rlk"].ext_ctx.moduli
    assert p["rlk"].special == r["rlk"].special


def test_secret_key_bit_identical(both):
    r, p = both["ref"], both["port"]
    _eq(p["sk"].poly.data, r["sk"].poly.data)
    np.testing.assert_array_equal(p["sk"].coeffs, r["sk"].coeffs)


def test_public_key_bit_identical(both):
    r, p = both["ref"], both["port"]
    _eq(p["pk"].a.data, r["pk"].a.data)
    _eq(p["pk"].b.data, r["pk"].b.data)


def test_relin_key_bit_identical(both):
    r, p = both["ref"], both["port"]
    assert p["rlk"].a_seed == r["rlk"].a_seed
    assert p["rlk"].digit_size == r["rlk"].digit_size
    _eq(p["rlk"].a, r["rlk"].a)
    _eq(p["rlk"].b, r["rlk"].b)


@pytest.mark.parametrize("side", [0, 1])
def test_ciphertexts_bit_identical(both, side):
    for pc, rc in zip(both["port"]["cts"][side], both["ref"]["cts"][side]):
        _eq(pc.c0.data, rc.c0.data)
        _eq(pc.c1.data, rc.c1.data)
        assert (pc.logp, pc.logq, pc.scale) == (rc.logp, rc.logq, rc.scale)


@pytest.mark.parametrize("part", [0, 1])
def test_fused_batch_bit_identical(both, part):
    got, want = both["port"]["out"][part], both["ref"]["out"][part]
    assert got.shape == (BATCH, COUNT - 1, DEGREE)
    _eq(got, want)


def test_engine_mul_rescale_bit_identical(both):
    got, want = both["port"]["single"], both["ref"]["single"]
    _eq(got.c0.data, want.c0.data)
    _eq(got.c1.data, want.c1.data)
    assert (got.logp, got.logq, got.level) == (want.logp, want.logq, want.level)
    assert got.scale == want.scale
    assert torch.equal(got.c0.data, both["port"]["out"][0][0])


@pytest.mark.parametrize("item", range(BATCH))
def test_decode_within_bound(both, item):
    p, r, values = both["port"], both["ref"], both["values"]
    child = p["ctx"].drop_last(1)
    single = p["single"]
    ct = port.Ciphertext(
        c0=port.Poly(p["out"][0][item], child, True),
        c1=port.Poly(p["out"][1][item], child, True),
        logp=single.logp, logq=single.logq, scale=single.scale,
    )
    got = p["enc"].decode(p["eng"].decrypt(ct, p["sk"].reduce_to(child)))
    want = values[0, item] * values[1, item]
    np.testing.assert_allclose(got, want, atol=ATOL)
    if item == 0:
        ref_dec = r["enc"].decode(
            r["eng"].decrypt(r["single"], r["sk"].reduce_to(r["single"].ctx)))
        np.testing.assert_allclose(got, ref_dec[: DEGREE // 2], atol=1e-9)


def test_convert_round_trip(both):
    """Reference state carried into the port gives the same product, and
    the port's state carried back equals the reference's arrays."""
    r, p = both["ref"], both["port"]
    rlk = convert.relin_key_from_reference(
        np.asarray(r["rlk"].a), np.asarray(r["rlk"].b), r["ctx"].moduli,
        r["rlk"].ext_ctx.moduli, r["rlk"].digit_size, DEGREE, "cpu",
        a_seed=r["rlk"].a_seed,
    )
    ctx = rlk.ctx
    ca, cb = (convert.ciphertext_from_reference(
        np.asarray(c.c0.data), np.asarray(c.c1.data), ctx, c.logp, c.logq,
        c.scale) for c in (r["cts"][0][0], r["cts"][1][0]))
    sk = convert.secret_key_from_reference(
        np.asarray(r["sk"].poly.data), r["sk"].coeffs, ctx)
    out = port.CkksEngine.mul_rescale(ca, cb, rlk)
    _eq(out.c0.data, r["single"].c0.data)
    for got, want in zip(convert.ciphertext_to_reference(out),
                         (r["single"].c0.data, r["single"].c1.data)):
        np.testing.assert_array_equal(got, np.asarray(want))
    for got, want in zip(convert.gadget_key_to_reference(p["rlk"]),
                         (r["rlk"].a, r["rlk"].b)):
        np.testing.assert_array_equal(got, np.asarray(want))
    pk = convert.public_key_from_reference(
        np.asarray(r["pk"].a.data), np.asarray(r["pk"].b.data), ctx)
    assert torch.equal(pk.b.data, p["pk"].b.data)
    assert torch.equal(sk.poly.data, p["sk"].poly.data)


def test_cpu_slice_launches_no_kernel(both):
    p = both["port"]
    counters = (ntt_gpu.ntt_planes, keyswitch_gpu.gadget_accumulate,
                moddown_gpu.mod_down_combine)
    before = [f.launches for f in counters]
    port.CkksEngine.mul_rescale(p["cts"][0][1], p["cts"][1][1], p["rlk"])
    assert [f.launches for f in counters] == before


def test_key_digit_mismatch_raises(both):
    p = both["port"]
    ct = p["cts"][0][0]
    with pytest.raises(ChannelCountMismatch):
        _mul_relin_rescale_arrays(
            ct.c0.data, ct.c1.data, ct.c0.data, ct.c1.data, p["rlk"].a,
            p["rlk"].b, p["ctx"], p["rlk"].ext_ctx, p["ctx"].drop_last(1),
            digit_size=1,
        )
