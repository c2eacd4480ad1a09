"""PyTorch port, the host and API surface, held to the JAX reference.

Word for word (the port's residues through ``convert.to_reference``, with
level, logp, logq and exact scale), from the same numpy seeds: the legacy
single-pair keys and multiply (``tests/test_engine.py``'s legacy tests),
``CkksEngineBuilder``, ``Ciphertext.mod_switch``, ``encode_sparse``, the
``Poly`` helpers and the coefficient-domain ``rescale``, the staged
division by P (``engine._mod_down_ntt``, also against the fused route),
and the five N = 1024 integration scenarios of ``tests/test_engine.py``
(one chain and one key set per package and scenario setup, module
fixtures). Exactly: ``math/primes`` (``tests/test_golden.py``'s
``get_first_prime_up(30, 1024) = 1_073_750_017``) and the native runtime
(the port's build against the reference's, and against the pure-Python
fallback). Last, every public name of each reference module the port
mirrors has its counterpart, outside a stated exclusion list.
"""

import importlib
import inspect
import os
import random
import shutil

import numpy as np
import pytest
import torch

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu import engine as ref_engine
from toy_heaan_ckks_tpu import native as ref_native
from toy_heaan_ckks_tpu.keys import default_special_primes as ref_specials
from toy_heaan_ckks_tpu.math import crt as ref_crt
from toy_heaan_ckks_tpu.math import primes as ref_primes
from toy_heaan_ckks_tpu.math.sampling import make_rng as ref_make_rng
from toy_heaan_ckks_tpu.ops import poly as ref_poly

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch import engine as port_engine
from toy_heaan_ckks_tpu_torch import native
from toy_heaan_ckks_tpu_torch.math import crt
from toy_heaan_ckks_tpu_torch.math import primes
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
from toy_heaan_ckks_tpu_torch.ops import poly as port_poly

CPU = torch.device("cpu")


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(convert.to_reference(got), np.asarray(want))


def _same_ct(got, want) -> None:
    assert got.level == want.level
    assert (got.logp, got.logq) == (want.logp, want.logq)
    assert got.true_scale == want.true_scale
    assert got.c0.ntt_domain == want.c0.ntt_domain
    _same(got.c0.data, want.c0.data)
    _same(got.c1.data, want.c1.data)


def _engines(degree, bits, count, hw, scale_bits):
    """The same engine in both packages (the port's on the CPU)."""
    moduli = ref.generate_primes(bits, count, degree)
    return (ref.CkksEngine(ref.CkksContext.build(moduli, degree),
                           ref.CkksParams(3.2, hw, scale_bits)),
            port.CkksEngine(port.CkksContext.build(moduli, degree, CPU),
                            port.CkksParams(3.2, hw, scale_bits)))


def _keys(engines, seed):
    out = []
    for eng, rng_fn in zip(engines, (ref_make_rng, make_rng)):
        rng = rng_fn(seed)
        sk = eng.generate_secret_key(rng)
        out.append((rng, sk, eng.generate_public_key(sk, rng)))
    return out


def _encrypt(eng, keys, values, scale_bits, ctx=None):
    rng, _, pk = keys
    ctx = ctx or eng.context
    enc = type_encoder(eng)(ctx.degree, scale_bits)
    return eng.encrypt(enc.encode(values, ctx), pk, ctx.total_bits(), rng)


def type_encoder(eng):
    return ref.CkksEncoder if isinstance(eng, ref.CkksEngine) else port.CkksEncoder


def _decode(ct, sk, scale_bits, slots):
    pkg = ref if isinstance(ct, ref.Ciphertext) else port
    pt = pkg.CkksEngine.decrypt(ct, sk.reduce_to(ct.ctx))
    return pkg.CkksEncoder(ct.ctx.degree, scale_bits).decode(pt)[:slots]


# ── the legacy path (tests/test_engine.py:121, :311) and the builder ────


def test_legacy_mul_ciphertexts_api():
    engines = _engines(16, 31, 4, 8, 30)
    outs = []
    for eng, (rng, sk, pk) in zip(engines, _keys(engines, 11)):
        rlk = eng.generate_relinearization_key(sk, rng)
        a = _encrypt(eng, (rng, sk, pk), np.array([0.5, -0.25]), 30)
        b = _encrypt(eng, (rng, sk, pk), np.array([0.25, 0.5]), 30)
        outs.append((rlk, a, b, type(eng).mul_ciphertexts(a, b, rlk)))
    (rlk, a, _, got), (rrlk, _, _, want) = outs[1], outs[0]
    _same(rlk.a.data, rrlk.a.data)
    _same(rlk.b.data, rrlk.b.data)
    _same_ct(got, want)
    assert got.logp == 60 and got.logq == a.logq and got.level == 4


def test_legacy_mul_exact_relinearization_identity():
    """c0' + c1' s == (c0 + c1 s)(d0 + d1 s) + d2 (b + a s - s^2), residue
    for residue, and the words equal to the reference's."""
    engines = _engines(64, 30, 4, 32, 30)
    outs = []
    for eng, (rng, sk, pk) in zip(engines, _keys(engines, 77)):
        rk = eng.generate_relinearization_key(sk, rng)
        ct1 = _encrypt(eng, (rng, sk, pk), np.linspace(0.1, 0.9, 32), 30)
        ct2 = _encrypt(eng, (rng, sk, pk), np.linspace(-0.5, 0.5, 32), 30)
        outs.append((sk, rk, ct1, ct2, type(eng).mul_ciphertexts(ct1, ct2, rk)))
    _same_ct(outs[1][4], outs[0][4])
    sk, rk, ct1, ct2, out = outs[1]
    s = sk.poly
    dec = lambda ct: ct.c0.to_ntt_domain() + ct.c1.to_ntt_domain() * s
    d2 = ct1.c1.to_ntt_domain() * ct2.c1.to_ntt_domain()
    rhs = dec(ct1) * dec(ct2) + d2 * (rk.b + rk.a * s - s * s)
    assert torch.equal(dec(out).data, rhs.data)


def test_legacy_key_relations():
    """b + a s - s^2 and b + a s - s(X^{5^k}) are small (tests/test_keys.py),
    and the keys' words equal the reference's."""
    engines = _engines(16, 31, 3, 8, 30)
    got = []
    for eng, (rng, sk, _) in zip(engines, _keys(engines, 3)):
        got.append((sk, eng.generate_relinearization_key(sk, rng),
                    eng.generate_rotation_key(sk, 1, rng),
                    eng.generate_rotation_key(sk, -2, rng)))
    for p, r in zip(got[1][1:], got[0][1:]):
        _same(p.a.data, r.a.data)
        _same(p.b.data, r.b.data)
    sk, rlk, rot1, rot2 = got[1]
    s = sk.poly
    for key, target in ((rlk, s * s), (rot1, s.rotate_slots(1)), (rot2, s.rotate_slots(-2))):
        resid = (key.b + key.a * s - target).to_coeffs()
        assert max(abs(int(x)) for x in resid) < np.sqrt(3.2) * 10
    assert (rot1.rotation, rot2.rotation) == (1, -2)


def test_engine_builder():
    rb = ref.CkksEngine.builder().error_variance(2.5).scale_bits(40)
    pb = port.CkksEngine.builder().error_variance(2.5).scale_bits(40)
    assert isinstance(pb, port.CkksEngineBuilder)
    moduli = ref.generate_primes(41, 3, 32)
    reng, peng = rb.build_rns(32, moduli), pb.build_rns(32, moduli, device="cpu")
    assert peng.params == port.CkksParams(2.5, 16, 40)
    assert (peng.params.error_variance, peng.params.hamming_weight,
            peng.params.scale_bits) == (reng.params.error_variance,
                                        reng.params.hamming_weight, reng.params.scale_bits)
    assert peng.context.moduli == reng.context.moduli
    assert peng.context.device == CPU
    hw = port.CkksEngineBuilder().hamming_weight(4).build_rns(32, moduli, "cpu")
    assert hw.params == port.CkksParams(3.2, 4, 30)


# ── mod_switch, encode_sparse, Poly helpers ──────────────────────────────


def test_mod_switch():
    engines = _engines(32, 31, 4, 8, 30)
    outs = []
    for eng, keys in zip(engines, _keys(engines, 5)):
        ct = _encrypt(eng, keys, np.linspace(-0.5, 0.5, 16), 30)
        outs.append((ct.mod_switch(1), ct.mod_switch(3), keys[1]))
    for got, want in zip(outs[1][:2], outs[0][:2]):
        _same_ct(got, want)
    sw, sk = outs[1][1], outs[1][2]
    assert sw.level == 1 and sw.logp == 30
    np.testing.assert_allclose(_decode(sw, sk, 30, 16), np.linspace(-0.5, 0.5, 16),
                               atol=1e-6)
    for levels in (0, 4):
        with pytest.raises(ValueError):
            outs[1][0].mod_switch(levels)


@pytest.mark.parametrize("slots", [1, 4, 16])
def test_encode_sparse(slots):
    degree = 64
    moduli = ref.generate_primes(31, 3, degree)
    rctx = ref.CkksContext.build(moduli, degree)
    pctx = port.CkksContext.build(moduli, degree, CPU)
    z = np.random.default_rng(slots).uniform(-1, 1, slots) + 0.5j
    want = ref.CkksEncoder(degree, 40).encode_sparse(z, rctx)
    penc = port.CkksEncoder(degree, 40)
    got = penc.encode_sparse(z, pctx)
    assert (got.slots, got.scale_bits) == (want.slots, want.scale_bits)
    _same(got.poly.data, want.poly.data)
    coeffs = got.poly.to_coeffs()
    gap = degree // (2 * slots)
    assert all(int(c) == 0 for i, c in enumerate(coeffs) if i % gap)
    np.testing.assert_allclose(penc.decode_complex(got), z, atol=1e-9)
    with pytest.raises(ValueError):
        penc.encode_sparse(np.zeros(3), pctx)
    with pytest.raises(ValueError):
        penc.encode_sparse(np.zeros(64), pctx)


@pytest.mark.parametrize("bits", [31, 61])
def test_poly_helpers(bits):
    """zero, from_residues_u64, residues, the coefficient-domain rescale and
    Poly.rescale (equal to rescale_ntt taken back), and the functional
    kernels, against the reference."""
    degree = 32
    moduli = ref.generate_primes(bits, 3, degree)
    rctx = ref.CkksContext.build(moduli, degree)
    pctx = port.CkksContext.build(moduli, degree, CPU)
    rs = np.random.default_rng(bits)
    res = np.stack([rs.integers(0, q, degree, dtype=np.uint64) for q in moduli])
    res2 = np.stack([rs.integers(0, q, degree, dtype=np.uint64) for q in moduli])
    pp, rp = port.Poly.from_residues_u64(res, pctx), ref.Poly.from_residues_u64(res, rctx)
    pq, rq = port.Poly.from_residues_u64(res2, pctx), ref.Poly.from_residues_u64(res2, rctx)
    _same(pp.data, rp.data)
    _same(port.Poly.from_residues(res, pctx).data, rp.data)
    assert [[int(x) for x in row] for row in pp.residues()] == \
        [[int(x) for x in row] for row in rp.residues()]
    assert not pp.ntt_domain
    zero = port.Poly.zero(pctx, ntt_domain=True)
    assert zero.ntt_domain and zero.data.dtype == pctx.chain.dtype
    _same(zero.data, ref.Poly.zero(rctx).data)
    pn, rn = pp.to_ntt_domain(), rp.to_ntt_domain()
    for got, want in ((pp.rescale(), rp.rescale()), (pn * pq.to_ntt_domain(),
                                                      rn * rq.to_ntt_domain()),
                      (pp + pq, rp + rq), (pp - pq, rp - rq), (-pp, -rp)):
        assert (got.ntt_domain, got.ctx.moduli) == (want.ntt_domain, want.ctx.moduli)
        _same(got.data, want.data)
    _same(port_poly.rescale(pp.data, pctx), np.asarray(ref_poly.rescale(rp.data, rctx)))
    assert torch.equal(pp.rescale().to_ntt_domain().data,
                       pp.to_ntt_domain().rescale_ntt().data)
    _same(port_poly.mod_drop_last(pp.data, 2), np.asarray(rp.data)[:1])
    with pytest.raises(ValueError):
        port_poly.rescale(pp.data[:1], pctx.slice_channels(0, 1))


# ── the staged division by P ─────────────────────────────────────────────


@pytest.mark.parametrize("bits,count,specials", [(31, 4, 1), (30, 5, 2), (61, 3, 1)])
def test_mod_down_ntt(bits, count, specials):
    """``_mod_down_ntt`` word-equal to the reference's on random NTT-domain
    planes over QP (a batch of two), and to the fused route
    (``_mod_down_dispatch``: the K3' / K8' twin)."""
    degree = 64
    moduli = tuple(ref.generate_primes(bits, count, degree))
    ctx = port.CkksContext.build(moduli, degree, CPU)
    ext_moduli = moduli + ref_specials(ref.CkksContext.build(moduli, degree), specials)
    ext_ctx = port.CkksContext.build(ext_moduli, degree, CPU)
    rs = np.random.default_rng(count)
    res = np.stack([np.stack([rs.integers(0, q, degree, dtype=np.uint64) for q in ext_moduli])
                    for _ in range(2)])
    x = convert.from_reference(
        np.stack([res & 0xFFFFFFFF, res >> 32], axis=-2).astype(np.uint32), CPU,
        wide=not ext_ctx.chain.small)
    got = port_engine._mod_down_ntt(x, ctx, ext_ctx)
    plan = ref_engine._switch_plan(moduli, ext_moduli, 1)
    want = ref_engine._mod_down_ntt(convert.to_reference(x), ref.CkksContext.build(moduli, degree),
                                    ref.CkksContext.build(ext_moduli, degree), plan)
    _same(got, want)
    assert torch.equal(got, port_engine._mod_down_dispatch(x, ctx, ext_ctx))


# ── the five N = 1024 integration scenarios (tests/test_engine.py:183-259) ─


def _setup(bits, count, seed):
    engines = _engines(1024, bits, count, 512, bits)
    out = []
    for eng, (rng, sk, pk) in zip(engines, _keys(engines, seed)):
        out.append(dict(eng=eng, rng=rng, sk=sk, pk=pk, bits=bits,
                        rlk=eng.generate_gadget_relin_key(sk, rng)))
    return out


@pytest.fixture(scope="module")
def large_setup():
    return _setup(62, 2, 1)  # tests/test_engine.py large_setup


@pytest.fixture(scope="module")
def chain_setup():
    return _setup(40, 3, 2)  # tests/test_engine.py chain_setup


def _enc(side, values, eng=None, pk=None, logq=None):
    eng = eng or side["eng"]
    enc = type_encoder(eng)(1024, side["bits"])
    return eng.encrypt(enc.encode(values, eng.context), pk or side["pk"],
                       logq or eng.context.total_bits(), side["rng"])


def _mul_rescale(side, a, b, rlk=None):
    e = type(side["eng"])
    return e.rescale_ciphertext(e.mul_ciphertexts_gadget(a, b, rlk or side["rlk"]))


def _lower(side, ct_ab):
    """tests/test_engine.py's per-level engine, public and relin keys."""
    eng = type(side["eng"])(ct_ab.ctx, side["eng"].params)
    sk = side["sk"].reduce_to(ct_ab.ctx)
    return eng, eng.generate_public_key(sk, side["rng"])


def _single(side):
    a = np.array([0.5, -0.25, 0.75, -0.125, 0.9, -0.6, 0.3, -0.8])
    b = np.array([0.4, 0.8, -0.2, 0.6, -0.5, 0.35, -0.7, 0.15])
    return _mul_rescale(side, _enc(side, a), _enc(side, b)), a * b, 1e-8


def _chained(side):
    a = np.array([0.9, 0.5, 0.8, 0.3, 0.7, 0.4, 0.6, 0.2])
    b = np.array([0.8, 0.6, 0.4, 0.9, 0.5, 0.7, 0.3, 0.85])
    c = np.array([0.7, 0.9, 0.3, 0.5, 0.6, 0.8, 0.4, 0.1])
    ct_ab = _mul_rescale(side, _enc(side, a), _enc(side, b))
    eng2, pk2 = _lower(side, ct_ab)
    rlk2 = eng2.generate_gadget_relin_key(side["sk"].reduce_to(ct_ab.ctx), side["rng"])
    ct_c = _enc(side, c, eng2, pk2, ct_ab.logq)
    return _mul_rescale(side, ct_ab, ct_c, rlk2), a * b * c, 1e-4


def _add_mul(side):
    a = np.array([0.3, -0.4, 0.6, -0.2, 0.8, -0.1, 0.5, -0.7])
    b = np.array([-0.1, 0.5, -0.3, 0.7, -0.4, 0.6, -0.2, 0.4])
    c = np.array([0.9, 0.7, 0.5, 0.3, 0.8, 0.6, 0.4, 0.2])
    cts = [_enc(side, v) for v in (a, b, c)]
    s = type(side["eng"]).add_ciphertexts(cts[0], cts[1])
    return _mul_rescale(side, s, cts[2]), (a + b) * c, 1e-8


def _mul_add(side):
    a = np.array([0.6, -0.3, 0.8, -0.5, 0.4, -0.7, 0.2, -0.9])
    b = np.array([0.5, 0.7, 0.3, 0.9, 0.6, 0.4, 0.8, 0.1])
    c = np.array([0.1, -0.2, 0.4, -0.3, 0.7, -0.5, 0.3, -0.6])
    ct_ab = _mul_rescale(side, _enc(side, a), _enc(side, b))
    eng2, pk2 = _lower(side, ct_ab)
    ct_c = _enc(side, c, eng2, pk2, ct_ab.logq)
    return type(side["eng"]).add_ciphertexts(ct_ab, ct_c), a * b + c, 1e-4


def _full_slots(side):
    vals = ref_make_rng(99)
    a, b = vals.uniform(-0.9, 0.9, 512), vals.uniform(-0.9, 0.9, 512)
    return _mul_rescale(side, _enc(side, a), _enc(side, b)), a * b, 1e-6


SCENARIOS = {"single_multiplication_large_primes": ("large", _single),
             "two_chained_multiplications": ("chain", _chained),
             "add_then_multiply": ("large", _add_mul),
             "multiply_then_add": ("chain", _mul_add),
             "full_slots_single_multiplication": ("large", _full_slots)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_integration_scenario(name, request):
    which, fn = SCENARIOS[name]
    sides = request.getfixturevalue(f"{which}_setup")
    (want, _, _), (got, expected, bound) = fn(sides[0]), fn(sides[1])
    _same_ct(got, want)
    dec = _decode(got, sides[1]["sk"], sides[1]["bits"], len(expected))
    assert np.max(np.abs(dec - expected)) < bound


# ── math/primes and the native runtime ───────────────────────────────────


def test_primes_golden_and_parity():
    assert port.get_first_prime_up(30, 1024) == 1_073_750_017
    for logq, n in ((30, 1024), (40, 8192), (61, 64), (20, 16)):
        assert primes.get_first_prime_up(logq, n) == ref_primes.get_first_prime_up(logq, n)
    for bound, n in ((1 << 31, 1024), (1 << 40, 8192), (100_000, 16), (3, 4)):
        assert primes.get_first_prime_down(bound, n) == ref_primes.get_first_prime_down(bound, n)
    assert all(primes.is_prime(n) == primes.is_prime_reference(n)
               == ref_primes.is_prime_reference(n) for n in range(2000))
    for composite in (3215031751, 3825123056546413051, 561):
        assert not port.is_prime(composite)
    assert port.is_ntt_friendly_prime(1_073_750_017, 1024)
    assert not port.is_ntt_friendly_prime(1_073_750_017 + 2048 * 3, 1024)
    assert primes.mod_inverse(3, 7) == ref_primes.mod_inverse(3, 7) == 5
    for bad in (lambda: primes.get_first_prime_up(64, 16),
                lambda: primes.get_first_prime_up(30, 0),
                lambda: primes.is_ntt_friendly_prime(7, 0),
                lambda: primes.is_prime(-1)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError):
        primes.mod_inverse(2, 4)


def test_primes_fallback_matches(monkeypatch):
    """The pure-Python bodies give what the native runtime gives."""
    fast = [primes.get_first_prime_up(30, 1024), primes.get_first_prime_down(1 << 40, 8192),
            primes.generate_primes(31, 3, 1024), [primes.is_prime(n) for n in range(500)]]
    monkeypatch.setattr(primes, "_native", lambda: None)
    slow = [primes.get_first_prime_up(30, 1024), primes.get_first_prime_down(1 << 40, 8192),
            primes.generate_primes(31, 3, 1024), [primes.is_prime(n) for n in range(500)]]
    assert fast == slow


def test_native_build_and_parity():
    """The port's own build (into its ``build/`` directory) against the
    reference's on the same inputs."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: both packages run their pure-Python paths")
    assert native.available() and ref_native.available()
    assert native.library_path().parent.name == "build"
    assert native.library_path().parent.parent.name == "toy_heaan_ckks_tpu_torch"
    rnd = random.Random(7)
    for _ in range(300):
        n = rnd.randrange(0, 1 << 63)
        assert native.is_prime_u64(n) == ref_native.is_prime_u64(n)
    for start, two_n in ((2049, 2048), ((1 << 40) + 1, 16384)):
        assert native.first_prime_up(start, two_n) == ref_native.first_prime_up(start, two_n)
        assert native.first_prime_down(start, two_n) == ref_native.first_prime_down(start, two_n)
    rs = np.random.default_rng(5)
    moduli = ref.generate_primes(61, 7, 8192)  # Q ~ 2^427
    coeffs = rs.integers(-(2**62), 2**62, 256, dtype=np.int64)
    np.testing.assert_array_equal(native.reduce_coeffs(coeffs, moduli),
                                  ref_native.reduce_coeffs(coeffs, moduli))
    res = np.stack([rs.integers(0, m, 256, dtype=np.uint64) for m in moduli])
    got = native.crt_reconstruct_centered(res, moduli)
    assert [int(x) for x in got] == [int(x) for x in
                                     ref_native.crt_reconstruct_centered(res, moduli)]
    np.testing.assert_array_equal(native.crt_to_double(res, moduli, 2.0**50),
                                  ref_native.crt_to_double(res, moduli, 2.0**50))


def test_crt_fallback_matches(monkeypatch):
    """``math/crt.py`` through the native runtime and through its
    pure-Python body: the same ints, and the reference's."""
    rs = np.random.default_rng(3)
    moduli = ref.generate_primes(31, 5, 64)
    res = np.stack([rs.integers(0, m, 64, dtype=np.uint64) for m in moduli])
    coeffs = np.array([-5, 0, 7, -(1 << 40)] * 16, dtype=np.int64)
    big = np.array([5, -7, 10**30, -(10**30)] * 16, dtype=object)
    runs = []
    for use_native in (True, False):
        if not use_native:
            monkeypatch.setattr(crt, "_native", lambda: None)
        runs.append(([int(v) for v in crt.reconstruct_centered(res, moduli)],
                     crt.to_residues(coeffs, moduli).astype(np.int64),
                     crt.to_residues(big, moduli)))
    assert runs[0][0] == runs[1][0] == [int(v) for v in ref_crt.reconstruct_centered(res, moduli)]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    np.testing.assert_array_equal(runs[0][1], ref_crt.to_residues(coeffs, moduli).astype(np.int64))
    assert (runs[0][2] == runs[1][2]).all()
    assert (runs[0][2] == ref_crt.to_residues(big, moduli)).all()


# ── every public name of the reference has its counterpart ───────────────

# Modules the port does not mirror by path, with where their work went.
MODULE_EXCLUSIONS = {
    # the Pallas kernels: CUDA kernels under csrc/ with wrappers of their own
    "toy_heaan_ckks_tpu.ops.ntt_pallas": "ops/ntt_gpu.py (K1, K4)",
    "toy_heaan_ckks_tpu.ops.ntt_pallas_wide": "ops/ntt_gpu.py (K5, K5')",
    "toy_heaan_ckks_tpu.ops.keyswitch_pallas": "ops/keyswitch_gpu.py (K2)",
    "toy_heaan_ckks_tpu.ops.keyswitch_pallas_wide": "ops/keyswitch_gpu.py, ntt_gpu.py, "
                                                    "moddown_gpu.py (K6, K7, K8)",
    "toy_heaan_ckks_tpu.ops.moddown_pallas": "ops/moddown_gpu.py (K3, K3')",
    # ROADMAP "Do not port": 16-bit half-word multiplies
    "toy_heaan_ckks_tpu.ops.u64": None,
    # ROADMAP queue 1 item 5, the next slice
    "toy_heaan_ckks_tpu.utils.batching": None,
    "toy_heaan_ckks_tpu.utils.noise": None,
    "toy_heaan_ckks_tpu.utils.profiling": None,
    "toy_heaan_ckks_tpu.utils.serialization": None,
}
# Names of mirrored modules, with the reason they have no counterpart.
NAME_EXCLUSIONS = {
    "toy_heaan_ckks_tpu": {"serialization": "queue 1 item 5"},
    # the reference's uint32 limb-pair storage; the port keeps one word a
    # residue and converts at the boundary (convert.py)
    "toy_heaan_ckks_tpu.ops.modular": dict.fromkeys(
        ("R", "add_mod_pair", "sub_mod_pair", "neg_mod_pair", "mont_mul_pair",
         "pack_residues", "unpack_residues", "reduce_u64"), "limb pairs"),
    # ROADMAP "Do not port": the zero hi-limb planes of small chains
    "toy_heaan_ckks_tpu.ops.small_fast": dict.fromkeys(("add_lo", "sub_lo", "mont_mul_lo"),
                                                       "lo planes"),
    # the Pallas wrappers of K9, K6 and K8: ntt_mxu_gpu.ntt_mxu_planes,
    # keyswitch_gpu.gadget_accumulate_wide, moddown_gpu.mod_down_combine_wide
    "toy_heaan_ckks_tpu.ops.ntt_mxu": {"ntt_mxu_pallas": "K9"},
    "toy_heaan_ckks_tpu.ops.wide_fast": {"gadget_accumulate_pallas_wide": "K6",
                                         "mod_down_combine_pallas_wide": "K8"},
}


def _public_names(mod) -> set:
    """``__all__`` where a module has one, and every public function, class
    and constant it defines (imports from elsewhere left out)."""
    names = set(getattr(mod, "__all__", ()))
    for name, value in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        defined = getattr(value, "__module__", mod.__name__)
        if (inspect.isfunction(value) or inspect.isclass(value)) and defined != mod.__name__:
            continue
        names.add(name)
    return names


def _reference_modules() -> list:
    root = os.path.dirname(ref.__file__)
    out = []
    for base, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(base, f), root)[:-3]
                parts = ["toy_heaan_ckks_tpu"] + [p for p in rel.split(os.sep)
                                                  if p != "__init__"]
                out.append(".".join(parts))
    return sorted(out)


def test_public_name_parity():
    """Every module of the JAX package has its port, and every public name
    of a mirrored module is there too, outside the stated exclusions."""
    missing = {}
    for name in _reference_modules():
        mirror = name.replace("toy_heaan_ckks_tpu", "toy_heaan_ckks_tpu_torch", 1)
        if name in MODULE_EXCLUSIONS:
            where = MODULE_EXCLUSIONS[name]
            if where is not None:
                assert os.path.exists(os.path.join(os.path.dirname(port.__file__),
                                                   where.split(" ")[0].rstrip(",")))
            continue
        port_mod = importlib.import_module(mirror)
        lacks = _public_names(importlib.import_module(name)) - set(dir(port_mod)) \
            - set(NAME_EXCLUSIONS.get(name, ()))
        if lacks:
            missing[name] = sorted(lacks)
    assert not missing, missing
    assert port.__version__ == ref.__version__
