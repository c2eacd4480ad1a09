"""PyTorch port, the large rings, held to the JAX reference on the CPU.

- uint32 NTT at N = 2^16 on 2 x 30-bit (below 2^30: the reference's lazy
  butterflies) and 2 x 31-bit chains, forward and inverse, word-equal to
  the reference's staged NTT (``ops/poly.to_ntt`` / ``to_coeff`` on the
  CPU), on unbatched (L, N) planes: the shape of the slice's own NTTs, so
  the reference compiles them once.
- ``ntt_gpu.plane_split``: the kernels' one size limit and the blocks per
  plane.
- the slice at N = 2^16, 2 x 30-bit primes, digit_size 2, batch 1, from
  one numpy seed: sk, pk, the relin and rotation keys, ``mul_rescale``
  and one ``rotate_ciphertext``, bit-equal to the reference's, and a
  2^16 relin key carried across by ``convert``. The reference's key
  switch runs unjitted around the jitted pieces its multiply compiled (the
  same integer ops, one XLA compile fewer).

The rest of the large rings' CPU checks live beside the kernels they
check, each an XLA compile of ~5-10 s on one core, so the files spread
over the suite's workers: the factored K4 at N = 4096
(tests/test_torch_kernels.py), the factored K5' at N = 2048 and the
staged wide NTT at N = 2^15 (tests/test_torch_wide.py), the refusal of
N = 2^17 (tests/test_torch_host.py, tests/test_torch_wide.py). The port
runs its CPU twins; the card holds its kernels to those twins
(tests/test_torch_cuda.py, chip_smoke.py). No wide composite runs here:
its logic does not depend on N (tests/test_torch_wide.py holds it at
N = 256), and its CPU twins are bit-serial.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu import engine as ref_engine
from toy_heaan_ckks_tpu.ops import poly as ref_pops

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
from toy_heaan_ckks_tpu_torch.ops import ntt_gpu

BIG = 1 << 16
SLICE = dict(bits=30, count=2, digit_size=2, scale_bits=30)


def _planes(seed, moduli, degree, dtype):
    """(L, N) residues, each channel below its modulus."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, size=degree, dtype=np.int64) for q in moduli])).to(dtype)


def _eq(got: torch.Tensor, want) -> None:
    """Word equality of port planes with the reference's limb layout."""
    np.testing.assert_array_equal(convert.to_reference(got),
                                  np.asarray(want, dtype=np.uint32))


def _run(pkg):
    """Keys, two ciphertexts, ``mul_rescale`` and ``rotate_ciphertext`` by
    1 at N = 2^16 from seed 42, through ``pkg``."""
    kw = {"device": "cpu"} if pkg is port else {}
    ctx = pkg.CkksContext.build(
        pkg.generate_primes(SLICE["bits"], SLICE["count"], BIG), BIG, **kw)
    eng = pkg.CkksEngine(ctx, pkg.CkksParams(3.2, BIG // 2, SLICE["scale_bits"]))
    rng = make_rng(42)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=SLICE["digit_size"])
    rotk = eng.generate_gadget_rotation_key(sk, 1, rng,
                                            digit_size=SLICE["digit_size"])
    enc = pkg.CkksEncoder(BIG, SLICE["scale_bits"])
    values = np.random.default_rng(3).uniform(-1, 1, size=(2, BIG // 2))
    ca, cb = (eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng)
              for v in values)
    out = dict(ctx=ctx, sk=sk, pk=pk, rlk=rlk, rotk=rotk, cts=(ca, cb))
    out["mul"] = pkg.CkksEngine.mul_rescale(ca, cb, rlk)
    with pytest.MonkeyPatch.context() as mp:
        if pkg is ref:
            mp.setattr(ref_engine, "_gadget_key_switch",
                       ref_engine._gadget_key_switch.__wrapped__)
        out["rot"] = pkg.CkksEngine.rotate_ciphertext(ca, rotk)
    return out


@pytest.fixture(scope="module")
def both():
    return dict(ref=_run(ref), port=_run(port))


# ── the NTT entry points ─────────────────────────────────────────────────


@pytest.mark.parametrize("bits", [30, 31])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_2_16_matches_staged_reference(bits, inverse):
    moduli = tuple(ref.generate_primes(bits, 2, BIG))
    x = _planes(bits, moduli, BIG, torch.int32)
    rctx = ref.CkksContext.build(moduli, BIG)
    fn = ref_pops.to_coeff if inverse else ref_pops.to_ntt
    _eq(ntt_gpu.ntt_planes(x, moduli, BIG, inverse),
        fn(jnp.asarray(convert.to_reference(x)), rctx))


@pytest.mark.parametrize("wide", [False, True])
def test_plane_split(wide):
    """One block per plane up to 128 KiB, then a cluster of 2 or 4; the
    same limit, 2^16, for both words and every kernel."""
    splits = [ntt_gpu.plane_split(1 << k, wide) for k in (2, 14, 15, 16)]
    assert splits == ([(2, 1), (14, 1), (15, 2), (16, 4)] if wide
                      else [(2, 1), (14, 1), (15, 1), (16, 2)])
    for degree in (1 << 17, 3 << 10, 2):
        with pytest.raises(ValueError):
            ntt_gpu.plane_split(degree, wide)


# ── the slice at N = 2^16 ────────────────────────────────────────────────


def test_contexts_match(both):
    r, p = both["ref"], both["port"]
    assert p["ctx"].moduli == r["ctx"].moduli
    assert p["rlk"].ext_ctx.moduli == r["rlk"].ext_ctx.moduli


def test_keys_bit_identical(both):
    r, p = both["ref"], both["port"]
    _eq(p["sk"].poly.data, r["sk"].poly.data)
    _eq(p["pk"].a.data, r["pk"].a.data)
    _eq(p["pk"].b.data, r["pk"].b.data)


@pytest.mark.parametrize("key", ["rlk", "rotk"])
def test_gadget_keys_bit_identical(both, key):
    r, p = both["ref"][key], both["port"][key]
    assert p.digit_size == r.digit_size
    _eq(p.a, r.a)
    _eq(p.b, r.b)


def test_ciphertexts_bit_identical(both):
    for pc, rc in zip(both["port"]["cts"], both["ref"]["cts"]):
        _eq(pc.c0.data, rc.c0.data)
        _eq(pc.c1.data, rc.c1.data)


@pytest.mark.parametrize("op", ["mul", "rot"])
def test_op_bit_identical(both, op):
    got, want = both["port"][op], both["ref"][op]
    _eq(got.c0.data, want.c0.data)
    _eq(got.c1.data, want.c1.data)
    assert (got.logp, got.logq, got.scale) == (want.logp, want.logq, want.scale)


def test_convert_carries_a_2_16_key(both):
    """A reference relin key at N = 2^16 carried into the port equals the
    port's own, and back."""
    r, p = both["ref"]["rlk"], both["port"]["rlk"]
    rlk = convert.relin_key_from_reference(
        np.asarray(r.a), np.asarray(r.b), r.ctx.moduli, r.ext_ctx.moduli,
        r.digit_size, BIG, "cpu", a_seed=r.a_seed)
    assert torch.equal(rlk.a, p.a) and torch.equal(rlk.b, p.b)
    for got, want in zip(convert.gadget_key_to_reference(rlk), (r.a, r.b)):
        np.testing.assert_array_equal(got, np.asarray(want))
