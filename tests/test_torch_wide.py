"""PyTorch port, wide chains (2^31 <= q < 2^63, int64 planes, R = 2^64).

Held to the JAX reference on the CPU with uint64 equality of residues:
the overflow-free int64 primitives against Python ints (q up to just below
2^63); the conversion to and from the reference's (..., L, 2, N) limbs;
the K5/K7 twin against the staged jnp NTT on a chain with a 63-bit prime
and, on a 60-bit prime, at N = 2^15 (K5' on the card); each wide Pallas
kernel (interpret mode, N = 256, 3 x 61-bit, B = 2; the factored K5' at
N = 2048) against the twin that replaces it; and the slice — same-seed keys,
ciphertexts and the fused multiply — against the reference's generic
``_mul_relin_rescale_arrays`` at N = 256 on a 3 x 61-bit chain (ds 1) and
a 3 x 40-bit chain (ds 2, short last digit group), with the decoded
product within the reference's own 1e-6 bound on the 40-bit chain. The
reference objects are built once per chain (module-scoped fixture).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu.keys import default_special_primes as ref_specials
from toy_heaan_ckks_tpu.ops import keyswitch_pallas_wide as ref_kw
from toy_heaan_ckks_tpu.ops.modular import ModulusChain as RefChain
from toy_heaan_ckks_tpu.ops import poly as ref_pops
from toy_heaan_ckks_tpu.ops.ntt_pallas_wide import _ntt_factored_wide, ntt_pallas_wide
from toy_heaan_ckks_tpu.parallel.sharded import (
    _mul_relin_rescale_arrays as ref_mul_arrays,
)

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch.keys import default_special_primes
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu, moddown_gpu, ntt_gpu
from toy_heaan_ckks_tpu_torch.ops import modular as mm
from toy_heaan_ckks_tpu_torch.ops.small_fast import _dec_inv_ints
from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_mul_relin_rescale

DEGREE = 256
BATCH = 2


def _planes(seed, moduli, lead=(BATCH,), degree=DEGREE):
    """int64 (..., L, N) residues, each channel below its modulus."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, size=lead + (degree,), dtype=np.int64) for q in moduli],
        axis=-2,
    ))


def _j(t: torch.Tensor):
    """Port int64 planes -> the reference's uint32 limb pairs."""
    return jnp.asarray(convert.to_reference(t))


def _eq(got: torch.Tensor, want) -> None:
    """uint64 equality of port planes with reference limb pairs."""
    assert got.dtype == torch.int64
    want = np.asarray(want, dtype=np.uint32)
    words = want[..., 0, :].astype(np.uint64) | (
        want[..., 1, :].astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), words)


def _wide_chain(bits=61, count=3, degree=DEGREE, digit_size=1):
    base = tuple(ref.generate_primes(bits, count, degree))
    ctx = port.CkksContext.build(base, degree, device="cpu")
    return base, base + default_special_primes(ctx, digit_size)


# ── overflow-free int64 primitives against Python ints ──────────────────


@pytest.mark.parametrize("q", [
    (1 << 63) - 25,  # the largest prime below 2^63
    (1 << 62) - 57,
    (1 << 61) - 1,
    (1 << 31) - 1,
])
@pytest.mark.parametrize("op", ["add_mod", "sub_mod", "neg_mod", "mul_mod", "mont_mul"])
def test_wide_primitives_match_python_ints(q, op):
    rng = np.random.default_rng(q % 1000)
    edge = [0, 1, q - 1, q - 2, q // 2]
    a = edge + edge + [int(v) for v in rng.integers(0, q, 40, dtype=np.int64)]
    b = edge + edge[::-1] + [int(v) for v in rng.integers(0, q, 40, dtype=np.int64)]
    ta, tb = torch.tensor(a), torch.tensor(b)
    qc = torch.tensor([q])
    rinv = pow(1 << 64, -1, q)
    got = {
        "add_mod": lambda: mm.add_mod(ta, tb, qc),
        "sub_mod": lambda: mm.sub_mod(ta, tb, qc),
        "neg_mod": lambda: mm.neg_mod(ta, qc),
        "mul_mod": lambda: mm.mul_mod(ta, tb, qc),
        "mont_mul": lambda: mm.mont_mul(ta, tb, qc, torch.tensor([rinv])),
    }[op]()
    want = {
        "add_mod": lambda: [(x + y) % q for x, y in zip(a, b)],
        "sub_mod": lambda: [(x - y) % q for x, y in zip(a, b)],
        "neg_mod": lambda: [-x % q for x in a],
        "mul_mod": lambda: [x * y % q for x, y in zip(a, b)],
        "mont_mul": lambda: [x * y * rinv % q for x, y in zip(a, b)],
    }[op]()
    assert got.dtype == torch.int64 and got.tolist() == want


def test_wide_mul_mod_takes_any_residue_as_first_operand():
    """A residue of a larger prime times a constant mod a smaller one (the
    kernels' Harvey multiply of y_k by c[k, j])."""
    q = (1 << 61) - 1
    a = [(1 << 63) - 26, q, q + 1, 12345]
    got = mm.mul_mod(torch.tensor(a), torch.tensor([q - 3]), torch.tensor([q]))
    assert got.tolist() == [x * (q - 3) % q for x in a]


def test_chain_radix_follows_width():
    small = mm.ModulusChain.build(ref.generate_primes(31, 2, 64), "cpu")
    wide = mm.ModulusChain.build(ref.generate_primes(40, 2, 64), "cpu")
    assert (small.small, small.radix_bits, small.dtype) == (True, 32, torch.int32)
    assert (wide.small, wide.radix_bits, wide.dtype) == (False, 64, torch.int64)
    rchain = RefChain.build(wide.moduli)  # (L, 2, 1) limb pairs
    _eq(wide.qinv[:, None], np.asarray(rchain.qinv))
    _eq(wide.rmod, np.asarray(rchain.rmod))


# ── convert: reference limb pairs <-> int64 planes ───────────────────────


def test_convert_round_trip_wide():
    moduli = ((1 << 63) - 25, (1 << 40) - 87)
    t = _planes(5, moduli, (2,), 16)
    arr = convert.to_reference(t)
    assert arr.dtype == np.uint32 and arr.shape == (2, 2, 2, 16)
    back = convert.from_reference(arr, "cpu", wide=True)
    assert back.dtype == torch.int64 and torch.equal(back, t)
    bad = arr.copy()
    bad[0, 0, 1, 0] = 1 << 31  # a residue >= 2^63
    with pytest.raises(ValueError):
        convert.from_reference(bad, "cpu", wide=True)
    with pytest.raises(ValueError):
        convert.from_reference(arr, "cpu")  # non-zero hi limbs on a small chain


# ── host constants of the wide kernels ───────────────────────────────────


def test_wide_special_primes_match_reference():
    """A 62-bit chain gets 63-bit specials, as in the reference."""
    base = tuple(ref.generate_primes(62, 3, 1024))
    ctx = port.CkksContext.build(base, 1024, device="cpu")
    got = default_special_primes(ctx, 2)
    assert got == ref_specials(ref.CkksContext.build(base, 1024), 2)
    assert [p.bit_length() for p in got] == [63, 63]


@pytest.mark.parametrize("bits,count,ds", [(61, 4, 1), (40, 3, 2), (62, 3, 1)])
def test_switch_and_down_consts_match_reference(bits, count, ds):
    base, ext = _wide_chain(bits, count, 1024, ds)
    c, cs, q, qinv, got_ds = keyswitch_gpu._switch_consts_wide(base, ext, ds)
    want = ref_kw._switch_consts_wide(base, ext, ds)
    join = lambda lo, hi: lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(c, join(want[0], want[1]))
    np.testing.assert_array_equal(cs, join(want[2], want[3]))
    np.testing.assert_array_equal(q, join(want[4][:, 0], want[4][:, 1]))
    np.testing.assert_array_equal(qinv, join(want[5][:, 0], want[5][:, 1]))
    assert got_ds == want[6]

    L = len(base)
    child, dropped = base[: L - 1], ext[L - 1 :]
    p_specials = int(np.prod([int(p) for p in ext[L:]], dtype=object))
    got = moddown_gpu._down_consts_wide(child, dropped, 1024, p_specials)
    want = ref_kw._down_consts_wide(child, dropped, 1024, p_specials)
    np.testing.assert_array_equal(got[0], join(want[0], want[1]))
    np.testing.assert_array_equal(got[1], join(want[2], want[3]))
    for g, w in zip(got[2:6], want[4:8]):
        np.testing.assert_array_equal(g, join(w[:, 0], w[:, 1]))
    assert got[6] == tuple(int(v) for v in join(want[8][:, 0], want[8][:, 1]))

    post = _dec_inv_ints(base, ds)
    fin, _ = ref_kw._fold_consts_wide(base, 1024, post)
    assert moddown_gpu._fold_consts_wide(base, 1024, post) == tuple(
        int(v) for v in join(fin[:, 0], fin[:, 1]))


# ── K5/K7 twin against the staged jnp NTT, 63-bit prime included ─────────


@pytest.mark.parametrize("inverse", [False, True])
def test_k5_twin_matches_staged_reference_63bit(inverse):
    base, ext = _wide_chain(62, 2, DEGREE, 2)
    assert max(ext).bit_length() == 63
    x = _planes(7, ext)
    rctx = ref.CkksContext.build(ext, DEGREE)
    fn = ref_pops.to_coeff if inverse else ref_pops.to_ntt  # staged jnp on CPU
    _eq(ntt_gpu.ntt_planes_wide(x, ext, DEGREE, inverse), fn(_j(x), rctx))


def test_wide_ntt_above_2_14_not_ported():
    """N > 2^14 on a wide chain (K5': a plane over a cluster of blocks on
    the card) is ported: at N = 2^15 the forward NTT is word-equal to the
    staged jnp NTT and the inverse returns the input; N = 2^17 is refused
    on every device."""
    degree = 1 << 15
    moduli = (1152921504606584833,)  # 60-bit, NTT-friendly at 2^15
    x = _planes(15, moduli, lead=(), degree=degree)
    fwd = ntt_gpu.ntt_planes_wide(x, moduli, degree, False)
    _eq(fwd, ref_pops.to_ntt(_j(x), ref.CkksContext.build(moduli, degree)))
    assert torch.equal(ntt_gpu.ntt_planes_wide(fwd, moduli, degree, True), x)
    for device in ("cpu", "meta"):
        too_big = torch.zeros((1, 1 << 17), dtype=torch.int64, device=device)
        with pytest.raises(ValueError, match=r"2\^16"):
            ntt_gpu.ntt_planes_wide(too_big, moduli, 1 << 17, False)


# ── each wide Pallas kernel (interpret mode) against its twin ────────────


@pytest.fixture(scope="module")
def k_chain():
    return _wide_chain(61, 3, DEGREE, 1)


def test_k5f_twin_matches_pallas_factored_wide():
    """K5' (``_ntt_factored_wide``, row x lane twiddles; the TPU runs it at
    N >= 2^15) in interpret mode at N = 2048, forward; the twin's inverse
    returns the input."""
    degree = 2048
    moduli = tuple(ref.generate_primes(61, 2, degree))
    x = _planes(11, moduli, lead=(), degree=degree)
    fwd = ntt_gpu.ntt_planes_wide(x, moduli, degree, False)
    _eq(fwd, _ntt_factored_wide(_j(x), moduli, degree, False, interpret=True))
    assert torch.equal(ntt_gpu.ntt_planes_wide(fwd, moduli, degree, True), x)


def test_k5_twin_matches_pallas_ntt_wide(k_chain):
    base, _ = k_chain
    x = _planes(1, base)
    want = ntt_pallas_wide(_j(x), base, DEGREE, inverse=False, interpret=True)
    _eq(ntt_gpu.ntt_planes_wide(x, base, DEGREE, False), want)


def test_k7_twin_matches_pallas_inv_ntt_fold_wide(k_chain):
    base, _ = k_chain
    post = _dec_inv_ints(base, 1)
    x = _planes(2, base)
    want = ref_kw.inv_ntt_fold_wide(_j(x), base, DEGREE, post, interpret=True)
    _eq(moddown_gpu.inv_ntt_fold_wide(x, base, DEGREE, post), want)


def test_k7_twin_matches_pallas_inv_ntt_to_yhat_wide(k_chain):
    base, ext = k_chain
    dropped, child = ext[2:], base[:2]
    x = _planes(3, dropped)
    want = ref_kw.inv_ntt_to_yhat_wide(_j(x), dropped, child, DEGREE, interpret=True)
    _eq(moddown_gpu.inv_ntt_to_yhat_wide(x, dropped, child, DEGREE), want)


def test_k6_twin_matches_pallas_gadget_accumulate_wide(k_chain):
    base, ext = k_chain
    y, d = _planes(10, base), _planes(11, base)
    key_a, key_b = _planes(12, ext, (3,)), _planes(13, ext, (3,))
    kw = dict(base_moduli=base, ext_moduli=ext, degree=DEGREE, digit_size=1)
    want0, want1 = ref_kw.gadget_accumulate_pallas_wide(
        _j(y), _j(key_a), _j(key_b), interpret=True, d_ntt=_j(d), **kw)
    got0, got1 = keyswitch_gpu.gadget_accumulate_wide(y, key_a, key_b, d_ntt=d, **kw)
    _eq(got0, want0)
    _eq(got1, want1)


def test_k8_twin_matches_pallas_mod_down_combine_wide(k_chain):
    """The fused relin+rescale form: t scaled by the special product, ks
    and t read as channel slices of larger stacks."""
    base, ext = k_chain
    L = len(base)
    child, dropped = base[: L - 1], ext[L - 1 :]
    p_specials = int(np.prod([int(p) for p in ext[L:]], dtype=object))
    yhat = _planes(20, dropped)
    ks_full, t_full = _planes(21, ext), _planes(22, base)
    ks, t = ks_full[..., : L - 1, :], t_full[..., : L - 1, :]
    kw = dict(child_moduli=child, dropped_moduli=dropped, degree=DEGREE,
              t_scale=p_specials)
    want = ref_kw.mod_down_combine_pallas_wide(
        _j(yhat), _j(ks.contiguous()), _j(t.contiguous()), interpret=True, **kw)
    _eq(moddown_gpu.mod_down_combine_wide(yhat, ks, t, **kw), want)


def test_wide_entries_refuse_small_planes(k_chain):
    base, _ = k_chain
    with pytest.raises(TypeError):
        ntt_gpu.ntt_planes_wide(_planes(1, base).int(), base, DEGREE, False)
    with pytest.raises(TypeError):
        ntt_gpu.ntt_planes(_planes(1, base), base, DEGREE, False)


# ── the slice: keys, ciphertexts and the fused multiply ──────────────────

CHAINS = {"61x3-ds1": (61, 3, 1), "40x3-ds2": (40, 3, 2)}


def _run(pkg, bits, count, ds, values):
    kw = {"device": "cpu"} if pkg is port else {}
    ctx = pkg.CkksContext.build(pkg.generate_primes(bits, count, DEGREE), DEGREE, **kw)
    eng = pkg.CkksEngine(ctx, pkg.CkksParams(3.2, DEGREE // 2, bits))
    rng = make_rng(42)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=ds)
    enc = pkg.CkksEncoder(DEGREE, bits)
    cts = [[eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng)
            for v in side] for side in values]
    return dict(ctx=ctx, eng=eng, sk=sk, pk=pk, rlk=rlk, enc=enc, cts=cts)


@pytest.fixture(scope="module", params=list(CHAINS))
def both(request):
    bits, count, ds = CHAINS[request.param]
    values = np.random.default_rng(3).uniform(-1, 1, size=(2, BATCH, DEGREE // 2))
    r, p = _run(ref, bits, count, ds, values), _run(port, bits, count, ds, values)
    stack_r = lambda side, part: jnp.stack(
        [getattr(c, part).data for c in r["cts"][side]])
    stack_p = lambda side, part: torch.stack(
        [getattr(c, part).data for c in p["cts"][side]])
    r["out"] = ref_mul_arrays(  # the generic jnp composite on the CPU
        stack_r(0, "c0"), stack_r(0, "c1"), stack_r(1, "c0"), stack_r(1, "c1"),
        r["rlk"].a, r["rlk"].b, r["ctx"], r["rlk"].ext_ctx,
        r["ctx"].drop_last(1), digit_size=ds,
    )
    p["out"] = batched_mul_relin_rescale(
        (stack_p(0, "c0"), stack_p(0, "c1")), (stack_p(1, "c0"), stack_p(1, "c1")),
        p["rlk"], p["ctx"], p["ctx"].drop_last(1),
    )
    p["single"] = port.CkksEngine.mul_rescale(p["cts"][0][0], p["cts"][1][0], p["rlk"])
    return dict(ref=r, port=p, values=values, bits=bits)


def test_wide_keys_bit_identical(both):
    r, p = both["ref"], both["port"]
    assert not p["ctx"].chain.small and p["sk"].poly.data.dtype == torch.int64
    assert p["rlk"].ext_ctx.moduli == r["rlk"].ext_ctx.moduli
    assert p["rlk"].special == r["rlk"].special
    _eq(p["sk"].poly.data, r["sk"].poly.data)
    _eq(p["pk"].a.data, r["pk"].a.data)
    _eq(p["pk"].b.data, r["pk"].b.data)
    assert p["rlk"].a_seed == r["rlk"].a_seed
    _eq(p["rlk"].a, r["rlk"].a)
    _eq(p["rlk"].b, r["rlk"].b)


def test_wide_ciphertexts_bit_identical(both):
    for side in range(2):
        for pc, rc in zip(both["port"]["cts"][side], both["ref"]["cts"][side]):
            _eq(pc.c0.data, rc.c0.data)
            _eq(pc.c1.data, rc.c1.data)
            assert (pc.logp, pc.logq, pc.scale) == (rc.logp, rc.logq, rc.scale)


@pytest.mark.parametrize("part", [0, 1])
def test_wide_fused_batch_bit_identical(both, part):
    got, want = both["port"]["out"][part], both["ref"]["out"][part]
    assert got.shape == (BATCH, 2, DEGREE)
    _eq(got, want)
    single = both["port"]["single"]
    assert torch.equal((single.c0, single.c1)[part].data, got[0])


def test_wide_decode_within_reference_bound(both):
    """The reference's own bound for one multiply on a 40-bit chain
    (tests/test_wide_fast.py): 1e-6; the 61-bit chain meets it too."""
    p, values = both["port"], both["values"]
    child = p["ctx"].drop_last(1)
    single = p["single"]
    for item in range(BATCH):
        ct = port.Ciphertext(
            c0=port.Poly(p["out"][0][item], child, True),
            c1=port.Poly(p["out"][1][item], child, True),
            logp=single.logp, logq=single.logq, scale=single.scale,
        )
        got = p["enc"].decode(p["eng"].decrypt(ct, p["sk"].reduce_to(child)))
        assert np.max(np.abs(got - values[0, item] * values[1, item])) < 1e-6


def test_wide_convert_round_trip_of_state(both):
    """Reference keys and ciphertexts carried into the port give the port's
    product; the port's state carried back equals the reference's."""
    r, p = both["ref"], both["port"]
    rlk = convert.relin_key_from_reference(
        np.asarray(r["rlk"].a), np.asarray(r["rlk"].b), r["ctx"].moduli,
        r["rlk"].ext_ctx.moduli, r["rlk"].digit_size, DEGREE, "cpu",
        a_seed=r["rlk"].a_seed,
    )
    ca, cb = (convert.ciphertext_from_reference(
        np.asarray(c.c0.data), np.asarray(c.c1.data), rlk.ctx, c.logp, c.logq,
        c.scale) for c in (r["cts"][0][0], r["cts"][1][0]))
    out = port.CkksEngine.mul_rescale(ca, cb, rlk)
    assert torch.equal(out.c0.data, p["single"].c0.data)
    assert torch.equal(out.c1.data, p["single"].c1.data)
    for got, want in zip(convert.gadget_key_to_reference(p["rlk"]),
                         (r["rlk"].a, r["rlk"].b)):
        np.testing.assert_array_equal(got, np.asarray(want))
    sk = convert.secret_key_from_reference(
        np.asarray(r["sk"].poly.data), r["sk"].coeffs, rlk.ctx)
    assert torch.equal(sk.poly.data, p["sk"].poly.data)


def test_wide_cpu_slice_launches_no_kernel(both):
    p = both["port"]
    counters = (ntt_gpu.ntt_planes_wide, keyswitch_gpu.gadget_accumulate_wide,
                moddown_gpu.mod_down_combine_wide)
    before = [f.launches for f in counters]
    port.CkksEngine.mul_rescale(p["cts"][0][1], p["cts"][1][1], p["rlk"])
    assert [f.launches for f in counters] == before
