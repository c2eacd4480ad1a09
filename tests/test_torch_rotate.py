"""PyTorch port, rotations and hybrid key switching, held to the JAX reference.

Both packages run from the same numpy seeds on two chains: small
(N = 1024, 4 x 31-bit, digit_size 2) and wide (N = 256, 3 x 61-bit,
digit_size 1). Asserted with uint32 / uint64 equality of residues: the
automorphism tables; the rotation keys (offsets 1 and -1) and the
conjugation key; the outputs of every engine op of the slice against the
reference's generic jnp path on the CPU (the oracle: its lo-plane hoisted
branches run only on a TPU); the t-less mod-down twins (K3', K8') and the
key-switch composites against the Pallas kernels in interpret mode; the
reference's staged ``mod_down_lo`` against the port's K3' mod-down; and a
rotation key carried over through ``convert``. Decoded slots must meet the
reference tests' bounds (tests/test_hoisted.py: 1e-4 per rotation, 1e-3
for sums; 1e-6 on the wide chain). Hoisted outputs are compared with the
reference's hoisted outputs, never with per-rotation ones: the two are
decode-equal, not residue-equal.

The reference objects are built once per chain (module-scoped fixture),
and each of its jitted cores costs an XLA compile (~10 s small, ~25 s
wide on one core), so the reference computes every op on the small chain
and, on the wide chain, the ops whose port code differs by chain width:
the per-rotation key switch (rotate, conjugate, multiply, square), the
weighted hoisted sum (decomposition, key products, K8' mod-down, rescale)
and the plaintext ops. Its multiply and square cores run unjitted around
its jitted key switch, which the rotations have compiled: the same
integer ops, two compiles fewer.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu import engine as ref_engine
from toy_heaan_ckks_tpu.engine import _switch_plan as ref_switch_plan
from toy_heaan_ckks_tpu.ops import small_fast as ref_sf
from toy_heaan_ckks_tpu.ops import wide_fast as ref_wf
from toy_heaan_ckks_tpu.ops.keyswitch_pallas_wide import mod_down_combine_pallas_wide
from toy_heaan_ckks_tpu.ops.moddown_pallas import mod_down_combine_pallas

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch.engine import _mod_down_dispatch, _switch_plan
from toy_heaan_ckks_tpu_torch.keys import default_special_primes
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu, moddown_gpu, ntt_gpu
from toy_heaan_ckks_tpu_torch.ops import small_fast as sf
from toy_heaan_ckks_tpu_torch.ops import wide_fast as wf
from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_rotate

# name: (N, prime bits, count, digit_size, scale bits)
CHAINS = {"small": (1024, 31, 4, 2, 30), "wide": (256, 61, 3, 1, 61)}
ROTATIONS = (1, -1)  # per-rotation offsets (keys bit-checked)
HOISTED = (-1, 3)  # the hoisted calls' offsets
OPS = ("rot1", "rot-1", "conj", "hoisted", "sum", "wsum", "mul", "square",
       "mul_plain", "mul_plain_scalar", "add_plain", "add", "sub", "neg")
# the ops the reference computes per chain (module docstring)
REF_OPS = {"small": OPS,
           "wide": tuple(op for op in OPS if op not in ("hoisted", "sum"))}


def _run(pkg, chain, ops=OPS):
    """Keys, two ciphertexts and the slice's ``ops`` through ``pkg``."""
    n, bits, count, ds, scale_bits = CHAINS[chain]
    kw = {"device": "cpu"} if pkg is port else {}
    ctx = pkg.CkksContext.build(pkg.generate_primes(bits, count, n), n, **kw)
    eng = pkg.CkksEngine(ctx, pkg.CkksParams(3.2, n // 2, scale_bits))
    rng = make_rng(42)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=ds)
    rotks = {k: eng.generate_gadget_rotation_key(sk, k, rng, digit_size=ds)
             for k in sorted(set(ROTATIONS + HOISTED))}
    cjk = eng.generate_conjugation_key(sk, rng, digit_size=ds)
    enc = pkg.CkksEncoder(n, scale_bits)
    vals = np.random.default_rng(3).uniform(-1, 1, size=(2 + len(HOISTED), n // 2))
    va, vb, diags = vals[0], vals[1], vals[2:] / 2
    ca, cb = (eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng)
              for v in (va, vb))
    E = pkg.CkksEngine
    keys = [rotks[k] for k in HOISTED]
    pts = [enc.encode(d, keys[0].ext_ctx) for d in diags]
    pb = enc.encode(vb, ctx)
    thunks = {
        "rot1": lambda: E.rotate_ciphertext(ca, rotks[1]),
        "rot-1": lambda: E.rotate_ciphertext(ca, rotks[-1]),
        "conj": lambda: E.conjugate_ciphertext(ca, cjk),
        "hoisted": lambda: E.rotate_hoisted(ca, keys),
        "sum": lambda: E.rotate_sum_hoisted(ca, keys),
        "wsum": lambda: E.rescale_ciphertext(
            E.rotate_weighted_sum_hoisted(ca, keys, pts)),
        "mul": lambda: E.mul_ciphertexts_gadget(ca, cb, rlk),
        "square": lambda: E.square_ciphertext(ca, rlk),
        "mul_plain": lambda: E.mul_plain(ca, pb),
        "mul_plain_scalar": lambda: eng.mul_plain_scalar(ca, 0.75),
        "add_plain": lambda: E.add_plain(ca, pb),
        "add": lambda: E.add_ciphertexts(ca, cb),
        "sub": lambda: E.sub_ciphertexts(ca, cb),
        "neg": lambda: E.neg_ciphertext(ca),
    }
    with pytest.MonkeyPatch.context() as mp:
        if pkg is ref:
            for core in ("_mul_gadget_core", "_square_gadget_core"):
                mp.setattr(ref_engine, core, getattr(ref_engine, core).__wrapped__)
        out = {op: thunks[op]() for op in ops}
    return dict(ctx=ctx, eng=eng, sk=sk, rlk=rlk, rotks=rotks, cjk=cjk,
                enc=enc, cts=(ca, cb), va=va, diags=diags, out=out)


@functools.lru_cache(maxsize=None)
def _both(chain):
    return dict(ref=_run(ref, chain, REF_OPS[chain]), port=_run(port, chain),
                chain=chain)


@pytest.fixture(scope="module", params=list(CHAINS))
def both(request):
    return _both(request.param)


def _eq(got: torch.Tensor, want) -> None:
    """uint32 / uint64 equality of port planes with reference limb pairs."""
    np.testing.assert_array_equal(
        convert.to_reference(got), np.asarray(want, dtype=np.uint32))


def _pairs(out):
    return out if isinstance(out, list) else [out]


# ── context: automorphism tables ─────────────────────────────────────────


@pytest.mark.parametrize("chain", list(CHAINS))
@pytest.mark.parametrize("which", ["5", "5^3", "5^-1", "5^-7", "2N-1"])
def test_automorphism_tables_match_reference(chain, which):
    n, bits, count, _, _ = CHAINS[chain]
    moduli = ref.generate_primes(bits, count, n)
    ctx = port.CkksContext.build(moduli, n, device="cpu")
    rctx = ref.CkksContext.build(moduli, n)
    half, two_n = n // 2, 2 * n
    e = {"5": 5, "5^3": pow(5, 3, two_n), "5^-1": pow(5, -1 % half, two_n),
         "5^-7": pow(5, -7 % half, two_n), "2N-1": two_n - 1}[which]
    src, neg = ctx.automorphism_table(e)
    rsrc, rneg = rctx.automorphism_table(e)
    np.testing.assert_array_equal(src.numpy(), np.asarray(rsrc))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(rneg))
    np.testing.assert_array_equal(ctx.automorphism_table_ntt(e).numpy(),
                                  np.asarray(rctx.automorphism_table_ntt(e)))
    assert src.device == ctx.device and src.dtype == torch.int64


def test_automorphism_even_exponent_raises():
    ctx = port.CkksContext.build(ref.generate_primes(31, 1, 64), 64, device="cpu")
    with pytest.raises(ValueError):
        ctx.automorphism_table_ntt(4)


def test_coefficient_automorphism_matches_ntt_permutation():
    """X -> X^e on coefficients (gather + negate) commutes with the NTT's
    slot permutation (port-internal)."""
    n = 256
    ctx = port.CkksContext.build(ref.generate_primes(31, 2, n), n, device="cpu")
    p = port.Poly.sample_uniform(ctx, make_rng(5))
    for e in (5, pow(5, 7, 2 * n), 2 * n - 1):
        via_coeff = p.automorphism(e).to_ntt_domain().data
        via_ntt = p.to_ntt_domain().automorphism(e).data
        assert torch.equal(via_coeff, via_ntt)


# ── keys ─────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("offset", ROTATIONS)
def test_rotation_key_bit_identical(both, offset):
    got, want = both["port"]["rotks"][offset], both["ref"]["rotks"][offset]
    assert (got.rotation, got.special, got.digit_size, got.a_seed) == (
        want.rotation, want.special, want.digit_size, want.a_seed)
    assert got.ext_ctx.moduli == want.ext_ctx.moduli
    _eq(got.a, want.a)
    _eq(got.b, want.b)


def test_conjugation_key_bit_identical(both):
    got, want = both["port"]["cjk"], both["ref"]["cjk"]
    assert (got.special, got.a_seed) == (want.special, want.a_seed)
    _eq(got.a, want.a)
    _eq(got.b, want.b)


def test_keys_take_explicit_specials(both):
    """``specials=`` builds the same key as the default special primes;
    ``special=`` builds a key over that one prime."""
    p = both["port"]
    rk = p["rotks"][1]
    again = port.RnsGadgetRotationKey.generate(
        p["sk"], 1, float(np.sqrt(3.2)), p["ctx"], make_rng(7),
        specials=rk.ext_ctx.moduli[p["ctx"].num_channels:],
        digit_size=rk.digit_size,
    )
    default = port.RnsGadgetRotationKey.generate(
        p["sk"], 1, float(np.sqrt(3.2)), p["ctx"], make_rng(7),
        digit_size=rk.digit_size,
    )
    assert torch.equal(again.b, default.b)
    one = rk.ext_ctx.moduli[-1]
    single = port.RnsGadgetConjugationKey.generate(
        p["sk"], float(np.sqrt(3.2)), p["ctx"], make_rng(7), special=one)
    assert single.ext_ctx.moduli == p["ctx"].moduli + (one,)
    assert single.special == one


# ── every op of the slice against the reference ──────────────────────────


@pytest.mark.parametrize("chain, op", [(c, op) for c in CHAINS for op in REF_OPS[c]])
def test_op_bit_identical(chain, op):
    both = _both(chain)
    got, want = _pairs(both["port"]["out"][op]), _pairs(both["ref"]["out"][op])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.ctx.moduli == w.ctx.moduli
        _eq(g.c0.data, w.c0.data)
        _eq(g.c1.data, w.c1.data)
        assert (g.logp, g.logq, g.scale) == (w.logp, w.logq, w.scale)


@pytest.mark.parametrize("op", ["rot1", "rot-1", "conj", "hoisted", "sum", "wsum"])
def test_decode_within_reference_bounds(both, op):
    p = both["port"]
    va, E = p["va"], port.CkksEngine
    rolled = {"rot1": [np.roll(va, -1)], "rot-1": [np.roll(va, 1)], "conj": [va],
              "hoisted": [np.roll(va, -k) for k in HOISTED],
              "sum": [sum(np.roll(va, -k) for k in HOISTED)],
              "wsum": [sum(d * np.roll(va, -k) for d, k in zip(p["diags"], HOISTED))]}
    bound = 1e-6 if both["chain"] == "wide" else (
        1e-3 if op in ("sum", "wsum") else 1e-4)
    for ct, want in zip(_pairs(p["out"][op]), rolled[op]):
        got = p["enc"].decode(E.decrypt(ct, p["sk"].reduce_to(ct.ctx)))
        assert np.max(np.abs(got - want)) < bound


def test_batched_rotate_matches_rotate_ciphertext(both):
    p = both["port"]
    ca, cb = p["cts"]
    rotk = p["rotks"][1]
    c0 = torch.stack([ca.c0.data, cb.c0.data])
    c1 = torch.stack([ca.c1.data, cb.c1.data])
    o0, o1 = batched_rotate((c0, c1), rotk, p["ctx"])
    for i, ct in enumerate((ca, cb)):
        single = port.CkksEngine.rotate_ciphertext(ct, rotk)
        assert torch.equal(o0[i], single.c0.data)
        assert torch.equal(o1[i], single.c1.data)
    _eq(o0[0], both["ref"]["out"]["rot1"].c0.data)


def test_cpu_path_launches_no_kernel(both):
    p = both["port"]
    counters = (ntt_gpu.ntt_planes, ntt_gpu.ntt_planes_wide,
                keyswitch_gpu.gadget_accumulate, keyswitch_gpu.gadget_accumulate_wide,
                moddown_gpu.mod_down_combine, moddown_gpu.mod_down_combine_wide)
    read = lambda: [(f.launches, getattr(f, "launches_no_t", 0)) for f in counters]
    before = read()
    ct = p["cts"][1]
    port.CkksEngine.rotate_ciphertext(ct, p["rotks"][1])
    port.CkksEngine.rotate_sum_hoisted(ct, [p["rotks"][k] for k in HOISTED])
    assert read() == before


def test_rotation_key_convert_round_trip(both):
    """A reference rotation key carried into the port rotates as the port's
    own key; the port's rotation and conjugation keys carried back equal
    the reference's arrays."""
    r, p = both["ref"], both["port"]
    rk = r["rotks"][-1]
    key = convert.rotation_key_from_reference(
        np.asarray(rk.a), np.asarray(rk.b), rk.rotation, r["ctx"].moduli,
        rk.ext_ctx.moduli, rk.digit_size, p["ctx"].degree, "cpu",
        a_seed=rk.a_seed,
    )
    got = port.CkksEngine.rotate_ciphertext(p["cts"][0], key)
    want = p["out"]["rot-1"]
    assert torch.equal(got.c0.data, want.c0.data)
    assert torch.equal(got.c1.data, want.c1.data)
    cj = r["cjk"]
    cjk = convert.conjugation_key_from_reference(
        np.asarray(cj.a), np.asarray(cj.b), r["ctx"].moduli, cj.ext_ctx.moduli,
        cj.digit_size, p["ctx"].degree, "cpu", a_seed=cj.a_seed,
    )
    assert torch.equal(cjk.b, p["cjk"].b)
    for key, rkey in ((p["rotks"][-1], rk), (p["cjk"], cj)):
        for g, w in zip(convert.gadget_key_to_reference(key), (rkey.a, rkey.b)):
            np.testing.assert_array_equal(g, np.asarray(w))


# ── the kernels of the slice (twins) against the Pallas kernels ──────────


def _j(t: torch.Tensor, wide: bool):
    """Port planes -> the reference's layout: uint32 lo planes on a small
    chain (the fused kernels' input), limb pairs on a wide one."""
    if wide:
        return jnp.asarray(convert.to_reference(t))
    return jnp.asarray(t.numpy().view(np.uint32))


def _planes(seed, moduli, lead, n, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, size=lead + (n,), dtype=np.int64) for q in moduli],
        axis=-2,
    )).to(dtype)


@pytest.mark.parametrize("chain", list(CHAINS))
def test_mod_down_no_t_twin_matches_pallas(chain):
    """K3' / K8' at key-switch shapes: the child is the whole base, the
    dropped moduli the specials; ks a channel slice of a QP stack."""
    n, bits, count, ds, _ = CHAINS[chain]
    wide = chain == "wide"
    base = tuple(ref.generate_primes(bits, count, n))
    ctx = port.CkksContext.build(base, n, device="cpu")
    specials = default_special_primes(ctx, ds)
    dtype = torch.int64 if wide else torch.int32
    yhat = _planes(1, specials, (2,), n, dtype)
    ks = _planes(2, base + specials, (2,), n, dtype)[..., :count, :]
    kw = dict(child_moduli=base, dropped_moduli=specials, degree=n)
    if wide:
        want = mod_down_combine_pallas_wide(
            _j(yhat, True), _j(ks.contiguous(), True), None, interpret=True, **kw)
        got = moddown_gpu.mod_down_combine_wide(yhat, ks, None, **kw)
    else:
        want = mod_down_combine_pallas(
            _j(yhat, False), _j(ks.contiguous(), False), None, interpret=True, **kw)
        got = moddown_gpu.mod_down_combine(yhat, ks, None, **kw)
        want = np.stack([np.asarray(want), np.zeros_like(want)], axis=-2)
    _eq(got, want)


def test_key_switch_matches_reference_interpret(both):
    """``key_switch_lo`` / ``key_switch_wide`` against the reference's
    composites with its Pallas kernels in interpret mode, on a rotated c1."""
    r, p = both["ref"], both["port"]
    wide = both["chain"] == "wide"
    rk, rrk = p["rotks"][1], r["rotks"][1]
    d = p["cts"][0].c1.rotate_slots(1).data[None]
    ctx, rctx = p["ctx"], r["ctx"]
    plan = _switch_plan(ctx.moduli, rk.ext_ctx.moduli, rk.digit_size)
    rplan = ref_switch_plan(rctx.moduli, rrk.ext_ctx.moduli, rrk.digit_size)
    if wide:
        got = wf.key_switch_wide(d, rk.a, rk.b, ctx, rk.ext_ctx, plan)
        want = ref_wf.key_switch_wide(_j(d, True), rrk.a, rrk.b, rctx,
                                      rrk.ext_ctx, rplan, interpret=True)
    else:
        got = sf.key_switch_lo(d, rk.a, rk.b, ctx, rk.ext_ctx, plan)
        want = ref_sf.key_switch_lo(_j(d, False), rrk.a, rrk.b, rctx,
                                    rrk.ext_ctx, rplan, interpret=True)
        want = [np.stack([np.asarray(w), np.zeros_like(w)], axis=-2) for w in want]
    for g, w in zip(got, want):
        _eq(g, w)


def test_mod_down_lo_equals_k3_no_t_twin():
    """The reference's staged ``mod_down_lo`` (K1 + elementwise glue, its
    small hoisted path, in interpret mode) and the port's hoisted mod-down
    (``engine._mod_down_dispatch``: K1 yhat -> K3' no-t) give the same
    words."""
    n, bits, count, ds, _ = CHAINS["small"]
    base = tuple(ref.generate_primes(bits, count, n))
    ctx = port.CkksContext.build(base, n, device="cpu")
    ext_ctx = port.CkksContext.build(base + default_special_primes(ctx, ds), n,
                                     device="cpu")
    rctx = ref.CkksContext.build(base, n)
    rext = ref.CkksContext.build(ext_ctx.moduli, n)
    x = _planes(3, ext_ctx.moduli, (1,), n, torch.int32)
    want = ref_sf.mod_down_lo(_j(x, False), rctx, rext,
                              ref_switch_plan(base, rext.moduli, ds), interpret=True)
    _eq(_mod_down_dispatch(x, ctx, ext_ctx),
        np.stack([np.asarray(want), np.zeros_like(want)], axis=-2))


def test_sum_is_weighted_sum_with_unit_weights(both):
    """The port's one hoisted-sum body: unit weights (the constant 1, whose
    NTT-domain Montgomery form multiplies by 1) give ``rotate_sum_hoisted``
    word for word, on both chains."""
    p = both["port"]
    keys = [p["rotks"][k] for k in HOISTED]
    ext = keys[0].ext_ctx
    one = np.zeros(ext.degree, dtype=object)
    one[0] = 1
    unit = port.Plaintext(poly=port.Poly.from_coeffs(one, ext), scale_bits=0,
                          slots=ext.degree // 2)
    got = port.CkksEngine.rotate_weighted_sum_hoisted(p["cts"][0], keys,
                                                      [unit] * len(keys))
    want = p["out"]["sum"]
    assert torch.equal(got.c0.data, want.c0.data)
    assert torch.equal(got.c1.data, want.c1.data)
