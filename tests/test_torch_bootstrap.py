"""PyTorch port, the bootstrap path and the models it needs, held to the JAX
reference.

Both packages run from the same numpy seeds and their outputs are compared
word for word (the port's residues through ``convert.to_reference``, with
the level, logp, logq and exact scale): the numpy parts of
``models/bootstrap.py`` and ``models/funceval.py`` (DFT diagonals and their
factorization, Chebyshev fits, the arcsine constant) and ``special_dft`` /
``special_idft`` / ``build_modulus_chain`` exactly; ``encode_complex`` at
several levels; ``raise_modulus`` on both lifts and its two errors; the
stages of a refresh (``eval_chebyshev``, ``eval_chebyshev_ps``, the dense,
BSGS and factored CoeffToSlot / SlotToCoeff, ``eval_mod`` linear, PS and
arcsine) and one whole ``bootstrap`` (DEGREE 32, ds 4, dft_levels 2,
arcsine); every function of ``models/algorithms.py`` on
``tests/test_rotation_algorithms.py``'s setups; ``models/funceval.py``'s
evaluators on the bootstrap chain, and the ``_combine`` scale heal on
``tests/test_funceval.py``'s chain.

The reference's jitted code compiles per level shape and runs slowly on
the CPU, so the bootstrap stages share one chain (N = 32, 14 x 31-bit,
ds 4, hw 2) and one ladder and ``BootstrapKeys`` per package from one
seed (module fixtures): each test calls the same key-drawing ops in both
packages in the same order, so their generators stay in step whatever
order the tests run in. The stages use the shortest settings that reach
each branch (r 1, deg 3 or 4), and the evaluators start at the level of
the refresh's EvalMod, whose shapes the reference has compiled by then.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu.encoding import embedding as ref_embedding
from toy_heaan_ckks_tpu.errors import CkksError as RefCkksError
from toy_heaan_ckks_tpu.math.sampling import make_rng as ref_make_rng
from toy_heaan_ckks_tpu.models import algorithms as ref_alg
from toy_heaan_ckks_tpu.models import funceval as ref_fe
from toy_heaan_ckks_tpu.utils import params as ref_params

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch import engine as port_engine
from toy_heaan_ckks_tpu_torch.encoding import embedding as port_embedding
from toy_heaan_ckks_tpu_torch.errors import CkksError
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
from toy_heaan_ckks_tpu_torch.models import algorithms as port_alg
from toy_heaan_ckks_tpu_torch.models import funceval as port_fe
from toy_heaan_ckks_tpu_torch.utils import params as port_params

# the models packages export a function named ``bootstrap``, which hides
# the submodule attribute
ref_bt = importlib.import_module("toy_heaan_ckks_tpu.models.bootstrap")
port_bt = importlib.import_module("toy_heaan_ckks_tpu_torch.models.bootstrap")

CPU = torch.device("cpu")


def _same_ct(got, want) -> None:
    """Port and reference ciphertexts: same level, bookkeeping and words."""
    assert got.level == want.level
    assert (got.logp, got.logq) == (want.logp, want.logq)
    assert got.true_scale == want.true_scale
    assert got.c0.ntt_domain == want.c0.ntt_domain
    for g, w in ((got.c0, want.c0), (got.c1, want.c1)):
        np.testing.assert_array_equal(convert.to_reference(g.data),
                                      np.asarray(w.data))


def _same_pt(got, want) -> None:
    assert (got.scale_bits, got.slots) == (want.scale_bits, want.slots)
    assert got.true_scale == want.true_scale
    assert got.poly.ntt_domain == want.poly.ntt_domain
    np.testing.assert_array_equal(convert.to_reference(got.poly.data),
                                  np.asarray(want.poly.data))


# ── numpy parts: exact equality ──────────────────────────────────────────


@pytest.mark.parametrize("m,levels", [(4, 1), (4, 2), (9, 3), (15, 3), (7, 7)])
def test_split_stages(m, levels):
    assert port_bt._split_stages(m, levels) == ref_bt._split_stages(m, levels)


def test_split_stages_rejects():
    for levels in (0, 5):
        with pytest.raises(CkksError):
            port_bt._split_stages(4, levels)
        with pytest.raises(RefCkksError):
            ref_bt._split_stages(4, levels)


@pytest.mark.parametrize("degree", [16, 32, 64])
def test_cts_diagonals(degree):
    for got, want in zip(port_bt._cts_diagonals(degree),
                         ref_bt._cts_diagonals(degree)):
        np.testing.assert_array_equal(got, want)


def _same_diag_map(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for r in want:
        np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("degree,i", [(32, 0), (32, 3), (64, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_stage_diagonals(degree, i, inverse):
    _same_diag_map(port_bt._stage_diagonals(degree, i, inverse),
                   ref_bt._stage_diagonals(degree, i, inverse))


def test_compose_diagonals():
    a = port_bt._stage_diagonals(64, 1, False)
    b = port_bt._stage_diagonals(64, 2, True)
    _same_diag_map(port_bt._compose_diagonals(a, b, 32),
                   ref_bt._compose_diagonals(a, b, 32))


@pytest.mark.parametrize("degree,levels", [(32, 1), (32, 2), (64, 3), (1024, 3)])
def test_grouped_dft_diagonals(degree, levels):
    got = port_bt._grouped_dft_diagonals(degree, levels)
    want = ref_bt._grouped_dft_diagonals(degree, levels)
    for g_groups, w_groups in zip(got, want):
        assert len(g_groups) == len(w_groups) == levels
        for g, w in zip(g_groups, w_groups):
            _same_diag_map(g, w)


@pytest.mark.parametrize("premul", [1.0, 0.37 + 0j, 2.5 - 1j])
def test_stc_groups_premul(premul):
    got = port_bt._stc_groups_premul(32, 2, premul)
    want = ref_bt._stc_groups_premul(32, 2, premul)
    for g, w in zip(got, want):
        _same_diag_map(g, w)


def test_auto_giant():
    for n2 in (8, 16, 32, 512, 1 << 15):
        for giant in ("auto", None, 4):
            assert port_bt._auto_giant(n2, giant) == ref_bt._auto_giant(n2, giant)


def test_fits_and_constants():
    for a, deg in ((0.34, 8), (1.2, 3), (2.0, 6)):
        np.testing.assert_array_equal(port_bt._exp_cheb_coeffs(a, deg),
                                      ref_bt._exp_cheb_coeffs(a, deg))
    for rho in (0.99, 1.0, 32.0):
        assert port_bt._arcsine_c(rho) == ref_bt._arcsine_c(rho)
    for f, a, b, deg in ((np.exp, -1.0, 1.0, 15), (np.sin, 0.2, 2.0, 7)):
        np.testing.assert_array_equal(port_fe.chebyshev_fit(f, a, b, deg),
                                      ref_fe.chebyshev_fit(f, a, b, deg))
    assert port_alg.sqrt_poly_coeffs() == ref_alg.sqrt_poly_coeffs()
    assert port_alg.sqrt_poly_coeffs(4, 0.1, 1.0) == ref_alg.sqrt_poly_coeffs(4, 0.1, 1.0)


@pytest.mark.parametrize("degree", [16, 64])
def test_special_dft_idft(degree):
    rng = np.random.default_rng(degree)
    z = rng.normal(size=degree) + 1j * rng.normal(size=degree)
    np.testing.assert_array_equal(port_embedding.special_idft(z, degree),
                                  ref_embedding.special_idft(z, degree))
    np.testing.assert_array_equal(port_embedding.special_dft(z, degree),
                                  ref_embedding.special_dft(z, degree))
    # the oracle agrees with the fast path
    slots = port_embedding.build_conjugate_slots(z[: degree // 2], degree)
    np.testing.assert_allclose(port_embedding.special_idft(slots, degree),
                               port_embedding.embed_encode(slots, degree), atol=1e-12)


@pytest.mark.parametrize("args", [(1024, 30, 12, 40, False), (64, 31, 20, None, False),
                                  (1 << 16, 31, 27, 31, False), (4096, 30, 2, 40, True)])
def test_build_modulus_chain(args):
    got = port_params.build_modulus_chain(*args)
    want = ref_params.build_modulus_chain(*args)
    assert got.moduli == want.moduli
    assert (got.scale_bits, got.total_bits, got.depth) == (
        want.scale_bits, want.total_bits, want.depth)
    assert port_params.MAX_LOGQP_128 == ref_params.MAX_LOGQP_128


def test_build_modulus_chain_security_cap():
    for mod in (port_params, ref_params):
        with pytest.raises(ValueError):
            mod.build_modulus_chain(1024, 30, 3, enforce_security=True)


# ── encode_complex ───────────────────────────────────────────────────────


@pytest.mark.parametrize("degree", [32, 64])
def test_encode_complex(degree):
    primes = ref.generate_primes(31, 4, degree)
    rng = np.random.default_rng(3)
    z = rng.uniform(-1, 1, degree // 2) + 1j * rng.uniform(-1, 1, degree // 2)
    for scale_bits in (31, 50):
        renc, penc = ref.CkksEncoder(degree, scale_bits), port.CkksEncoder(degree, scale_bits)
        for count in (1, 3, 4):
            rctx = ref.CkksContext.build(primes[:count], degree)
            pctx = port.CkksContext.build(primes[:count], degree, CPU)
            got = penc.encode_complex(z[: degree // 4 * (count % 2 + 1)], pctx)
            want = renc.encode_complex(z[: degree // 4 * (count % 2 + 1)], rctx)
            _same_pt(got, want)
            if count * 31 > scale_bits + 32:  # room for the scaled values
                np.testing.assert_allclose(penc.decode_complex(got)[: got.slots],
                                           z[: got.slots], atol=1e-6)


# ── raise_modulus ────────────────────────────────────────────────────────


def _level1(pkg, rng_fn, full_primes, degree, hw, device):
    kw = {} if device is None else {"device": device}
    full = pkg.CkksContext.build(full_primes, degree, **kw)
    ctx1 = full.slice_channels(0, 1)
    params = pkg.CkksParams(3.2, hw, 30)
    rng = rng_fn(3)
    sk = pkg.CkksEngine(full, params).generate_secret_key(rng)
    eng1 = pkg.CkksEngine(ctx1, params)
    sk1 = sk.reduce_to(ctx1)
    pk1 = eng1.generate_public_key(sk1, rng)
    enc = pkg.CkksEncoder(degree, 30)
    a = np.linspace(-0.9, 0.9, degree // 2)
    ct1 = eng1.encrypt(enc.encode(a, ctx1), pk1, ctx1.total_bits(), rng)
    return full, sk, sk1, ct1


@pytest.mark.parametrize("lift", ["fast", "general"])
def test_raise_modulus(lift):
    """Both lifts word-equal to the reference's (``fast``: every target
    prime above q0/2, the device path; ``general``: 29-bit target primes,
    the host big-int path), and the raised ciphertext decrypts to the
    level-1 message plus q0 * I with |I| bounded (tests/test_bootstrap.py)."""
    degree, hw = 64, 8
    primes = ref.generate_primes(31, 6, degree)
    if lift == "general":
        primes = primes[:1] + ref.generate_primes(29, 4, degree)
    rfull, _, _, rct1 = _level1(ref, ref_make_rng, primes, degree, hw, None)
    full, sk, sk1, ct1 = _level1(port, make_rng, primes, degree, hw, CPU)
    q0 = primes[0]
    fast = all(2 * q > q0 for q in primes)
    assert fast == (lift == "fast")
    _same_ct(ct1, rct1)
    raised = port_bt.raise_modulus(ct1, full)
    _same_ct(raised, ref_bt.raise_modulus(rct1, rfull))
    assert raised.logq == full.total_bits()
    m1 = port.CkksEngine.decrypt(ct1, sk1).poly.to_coeffs()
    mr = port.CkksEngine.decrypt(raised, sk).poly.to_coeffs()
    assert all(int(d) == 0 for d in (mr - m1) % q0)
    assert max(abs(int(v)) for v in (mr - m1) // q0) <= (hw + 3) // 2 + 1


def test_raise_modulus_errors():
    degree = 64
    primes = ref.generate_primes(31, 4, degree)
    full, _, _, ct1 = _level1(port, make_rng, primes, degree, 8, CPU)
    # not at level 1 (tests/test_bootstrap.py:64)
    raised = port_bt.raise_modulus(ct1, full)
    with pytest.raises(CkksError, match="level 1"):
        port_bt.raise_modulus(raised, full)
    # ring degree mismatch
    other = port.CkksContext.build(ref.generate_primes(31, 4, 2 * degree), 2 * degree, CPU)
    with pytest.raises(CkksError, match="ring degree"):
        port_bt.raise_modulus(ct1, other)


# ── the refresh's stages on one shared ladder ────────────────────────────

BOOT_DEGREE, BOOT_COUNT, BOOT_HW, BOOT_DS = 32, 14, 2, 4
BOOT_EVAL_LEVEL = BOOT_COUNT - 2  # after the factored CoeffToSlot's 2 levels


def _boot_side(pkg, rng_fn, device):
    """One package's side of the bootstrap setup: the reference test's
    ``test_bootstrap_factored_dft_ds4_arcsine`` order of draws on a
    14-prime chain."""
    kw = {} if device is None else {"device": device}
    deg, scale = BOOT_DEGREE, 31
    full = pkg.CkksContext.build(pkg.generate_primes(scale, BOOT_COUNT, deg), deg, **kw)
    ctx1 = full.slice_channels(0, 1)
    params = pkg.CkksParams(3.2, BOOT_HW, scale)
    rng = rng_fn(33)
    eng_full = pkg.CkksEngine(full, params)
    sk = eng_full.generate_secret_key(rng)
    eng1 = pkg.CkksEngine(ctx1, params)
    pk1 = eng1.generate_public_key(sk.reduce_to(ctx1), rng)
    pk = eng_full.generate_public_key(sk, rng)
    ladder = pkg.KeyLadder(full, sk, 3.2, rng, lazy=True, digit_size=BOOT_DS)
    bt = ref_bt if pkg is ref else port_bt
    bkeys = bt.BootstrapKeys(ladder, params, rng, digit_size=BOOT_DS)
    enc = pkg.CkksEncoder(deg, scale)
    vals = np.random.default_rng(9)
    small = vals.uniform(-0.02, 0.02, deg // 2)
    z = vals.uniform(-0.5, 0.5, deg // 2) + 1j * vals.uniform(-0.5, 0.5, deg // 2)
    x = np.linspace(-0.95, 0.95, deg // 2)
    return dict(
        full=full, params=params, eng=eng_full, sk=sk, pk=pk, ladder=ladder,
        bkeys=bkeys, enc=enc, small=small, z=z, x=x, bt=bt,
        ct1=eng1.encrypt(enc.encode(small, ctx1), pk1, ctx1.total_bits(), rng),
        ct_z=eng_full.encrypt(enc.encode_complex(z, full), pk, full.total_bits(), rng),
        ct_x=eng_full.encrypt(enc.encode(x, full), pk, full.total_bits(), rng),
    )


@pytest.fixture(scope="module")
def boot():
    return _boot_side(ref, ref_make_rng, None), _boot_side(port, make_rng, CPU)


def _decode(side, ct):
    sk = side["sk"].reduce_to(ct.ctx)
    return side["enc"].decode_complex(type(side["eng"]).decrypt(ct, sk))


def test_boot_setup_matches(boot):
    r, p = boot
    for name in ("ct1", "ct_z", "ct_x"):
        _same_ct(p[name], r[name])


# the stages ``bootstrap`` calls through its module's globals, recorded by
# the ``refresh`` fixture
STAGES = ("raise_modulus", "coeff_to_slot", "eval_chebyshev", "eval_mod",
          "slot_to_coeff")


def _traced_refresh(side):
    """One whole refresh (ds 4, dft_levels 2, arcsine, the shortest EvalMod:
    r 1, deg 3) with each stage's outputs recorded in call order."""
    bt, trace = side["bt"], {name: [] for name in STAGES}

    def spy(name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            trace[name].append(out)
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for name in STAGES:
            mp.setattr(bt, name, spy(name, getattr(bt, name)))
        out = bt.bootstrap(side["ct1"], side["full"], side["bkeys"], side["params"],
                           side["enc"], r=1, deg=3, dft_levels=2, arcsine=True)
    return out, trace


@pytest.fixture(scope="module")
def refresh(boot):
    return [_traced_refresh(side) for side in boot]


@pytest.mark.parametrize("stage", STAGES)
def test_refresh_stages(refresh, stage):
    """Each stage of the refresh (the factored CoeffToSlot and SlotToCoeff,
    the linear Chebyshev evaluation and EvalMod with the arcsine
    correction, on both packed halves) word-equal to the reference's."""
    (_, want), (_, got) = refresh
    assert len(got[stage]) == len(want[stage]) == (2 if stage in ("eval_chebyshev",
                                                                  "eval_mod") else 1)
    for g, w in zip(got[stage], want[stage]):
        _same_ct(g, w)


def test_bootstrap_matches_reference(boot, refresh):
    """The refreshed ciphertext: level count - (deg + r + 2 + 2 * dft_levels
    + 2), words equal to the reference's, every matvec level's rotation
    keys evicted."""
    (want, _), (got, _) = refresh
    _same_ct(got, want)
    assert got.level == BOOT_COUNT - (3 + 1 + 2 + 2 * 2 + 2)
    assert np.all(np.isfinite(_decode(boot[1], got)))
    for side in boot:
        assert not side["bkeys"]._rot


def _at_eval_level(side, ct):
    """``ct`` dropped to the level where the refresh's EvalMod starts
    (BOOT_EVAL_LEVEL), so the reference's jitted ops reuse the shapes the
    ``refresh`` fixture compiled."""
    eng = type(side["eng"])(side["ladder"].at_level(ct.level).ctx, side["params"])
    return (ref_alg if side["bt"] is ref_bt else port_alg).align_level(
        eng, ct, BOOT_EVAL_LEVEL)


def test_eval_chebyshev_ps(boot):
    coeffs = [0.2, 0.4, -0.3, 0.1, 0.05]
    outs = [fe.eval_chebyshev_ps(side["ladder"], side["params"],
                                 _at_eval_level(side, side["ct_x"]), coeffs)
            for fe, side in zip((ref_fe, port_fe), boot)]
    _same_ct(outs[1], outs[0])
    got = _decode(boot[1], outs[1])[: BOOT_DEGREE // 2].real
    np.testing.assert_allclose(got, np.polynomial.chebyshev.chebval(boot[1]["x"], coeffs),
                               atol=2e-3)


@pytest.mark.parametrize("giant", [None, 8])
def test_cts_stc_dense_bsgs(boot, giant):
    """CoeffToSlot then SlotToCoeff by the dense hoisted matvec (giant None)
    and by baby-step/giant-step (giant 8): each output word-equal, the pair
    the identity on the slots (tests/test_bootstrap.py's bound)."""
    outs = []
    for side in boot:
        t = side["bt"].coeff_to_slot(side["ct_z"], side["bkeys"], side["enc"], giant=giant)
        back = side["bt"].slot_to_coeff(t, side["bkeys"], side["enc"], giant=giant)
        outs.append((t, back))
    for got, want in zip(outs[1], outs[0]):
        _same_ct(got, want)
    back = outs[1][1]
    assert back.level == BOOT_COUNT - 2
    z = boot[1]["z"]
    np.testing.assert_allclose(_decode(boot[1], back)[: len(z)], z, atol=2e-4)


@pytest.mark.parametrize("method", ["linear", "ps"])
def test_eval_mod(boot, method):
    """EvalMod without the arcsine correction on a fresh ciphertext of
    small values from the refresh's EvalMod level (K 2, r 1; deg 3 linear,
    deg 4 Paterson-Stockmeyer), word-equal on both packages."""
    outs = []
    for side in boot:
        rho = side["full"].moduli[0] / side["ct_x"].true_scale
        outs.append(side["bt"].eval_mod(
            side["ladder"], side["params"], side["bkeys"],
            _at_eval_level(side, side["ct_x"]), rho, 2,
            pre=0.5 / (rho * 2), post=-1j * rho / (4.0 * np.pi), r=1,
            deg=4 if method == "ps" else 3, method=method))
    _same_ct(outs[1], outs[0])
    assert np.all(np.isfinite(_decode(boot[1], outs[1])))


def test_hoisted_sum_chunks(boot, monkeypatch):
    """The double-hoisted weighted sum in chunks of keys gives the words of
    one pass (engine.HOIST_SUM_WORDS)."""
    p = boot[1]
    ct = p["ct_z"]
    diag_map = port_bt._grouped_dft_diagonals(BOOT_DEGREE, 2)[0][1]
    offs = sorted(r for r in diag_map if r)
    rotks = [p["bkeys"].rot_key(ct.level, r) for r in offs]
    pts = p["bkeys"].encoded_diags(diag_map, offs, rotks[0].ext_ctx, p["enc"])
    whole = port.CkksEngine.rotate_weighted_sum_hoisted(ct, rotks, pts)
    monkeypatch.setattr(port_engine, "HOIST_SUM_WORDS", rotks[0].a.numel() * 2)
    chunked = port.CkksEngine.rotate_weighted_sum_hoisted(ct, rotks, pts)
    assert len(offs) > 2
    assert (chunked.level, chunked.logp, chunked.true_scale) == (
        whole.level, whole.logp, whole.true_scale)
    assert torch.equal(chunked.c0.data, whole.c0.data)
    assert torch.equal(chunked.c1.data, whole.c1.data)
    # the reference's generator draws the same keys (it stays in step)
    r = boot[0]
    for off in offs:
        r["bkeys"].rot_key(ct.level, off)


# ── models/algorithms.py on tests/test_rotation_algorithms.py's setups ──


def _alg_side(pkg, rng_fn, device, count, seed, scale_bits=30, rotations=(1, 2, 4, 8)):
    kw = {} if device is None else {"device": device}
    n = 32
    ctx = pkg.CkksContext.build(pkg.generate_primes(30, count, n), n, **kw)
    params = pkg.CkksParams(error_variance=3.2, hamming_weight=n // 2, scale_bits=scale_bits)
    eng = pkg.CkksEngine(ctx, params)
    enc = pkg.CkksEncoder(n, scale_bits)
    rng = rng_fn(seed)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    ladder = pkg.KeyLadder(ctx, sk, 3.2, rng, rotations=rotations)
    return dict(ctx=ctx, params=params, eng=eng, enc=enc, rng=rng, sk=sk, pk=pk,
                ladder=ladder, alg=ref_alg if pkg is ref else port_alg)


@pytest.fixture(scope="module")
def alg_deep():
    # tests/test_rotation_algorithms.py deep_setup: 7 x 30-bit at N = 32
    return _alg_side(ref, ref_make_rng, None, 7, 7), _alg_side(port, make_rng, CPU, 7, 7)


def _encrypt(side, values):
    return side["eng"].encrypt(side["enc"].encode(values, side["ctx"]), side["pk"],
                               side["ctx"].total_bits(), side["rng"])


def test_algorithms_slot_sums(alg_deep):
    """sum_slots (rotation tree), sum_slots_hoisted, align_level and
    normalize_scale word-equal to the reference's."""
    values = np.linspace(0.1, 0.9, 16)
    outs = []
    for side in alg_deep:
        a = side["alg"]
        ct = _encrypt(side, values)
        keys = [side["eng"].generate_gadget_rotation_key(side["sk"], r, side["rng"])
                for r in range(1, 4)]
        tree = a.sum_slots(ct, side["ladder"], 16)
        hoisted = a.sum_slots_hoisted(ct, keys)  # the sum of slots 0..3
        aligned = a.align_level(side["eng"], ct, 4)
        normed = a.normalize_scale(side["eng"], ct, ct.true_scale * 1.002)
        outs.append((ct, tree, hoisted, aligned, normed))
    for got, want in zip(outs[1], outs[0]):
        _same_ct(got, want)
    p = alg_deep[1]
    for out, want in zip(outs[1][1:3], (values.sum(), values[:4].sum())):
        dec = p["enc"].decode(p["eng"].decrypt(out, p["sk"]))[0]
        assert abs(dec - want) < 1e-3
    assert outs[1][3].level == 4


def test_algorithms_add_const_and_horner(alg_deep):
    x = np.array([0.1, 0.4, 0.7, 0.95])
    coeffs = [0.3, -0.5, 0.25, 0.125]
    outs = []
    for side in alg_deep:
        a = side["alg"]
        ct = _encrypt(side, x)
        plus = a._add_const(side["eng"], ct, 0.25 - 0.5j)
        horner = a.eval_poly_horner(side["ladder"], side["params"], ct, coeffs)
        outs.append((ct, plus, horner))
    for got, want in zip(outs[1], outs[0]):
        _same_ct(got, want)
    p, horner = alg_deep[1], outs[1][2]
    dec = p["enc"].decode(p["eng"].decrypt(horner, p["sk"].reduce_to(horner.ctx)))[:4]
    assert np.max(np.abs(dec - np.polyval(coeffs[::-1], x))) < 1e-3


def test_encrypted_std_dev(alg_deep):
    t = np.arange(16)
    readings = np.clip(0.5 + 0.3 * np.sin(t / 3.0) + 0.05 * np.cos(t * 1.7), 0.0, 1.0)
    outs = [side["alg"].encrypted_std_dev(side["ladder"], side["params"],
                                          _encrypt(side, readings), 16)
            for side in alg_deep]
    _same_ct(outs[1], outs[0])
    p = alg_deep[1]
    dec = p["enc"].decode(p["eng"].decrypt(outs[1], p["sk"].reduce_to(outs[1].ctx)))[:16]
    assert np.max(np.abs(dec - np.std(readings))) < 0.03


# ── models/funceval.py on tests/test_funceval.py's chain ─────────────────


def _fe_side(pkg, rng_fn, device, levels, seed=7):
    kw = {} if device is None else {"device": device}
    degree = 64
    full = pkg.CkksContext.build(pkg.generate_primes(30, levels, degree), degree, **kw)
    params = pkg.CkksParams(3.2, 8, 30)
    eng = pkg.CkksEngine(full, params)
    rng = rng_fn(seed)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    ladder = pkg.KeyLadder(full, sk, 3.2, rng, lazy=True)
    enc = pkg.CkksEncoder(degree, 30)
    return dict(ctx=full, params=params, eng=eng, rng=rng, sk=sk, pk=pk,
                ladder=ladder, enc=enc, fe=ref_fe if pkg is ref else port_fe,
                alg=ref_alg if pkg is ref else port_alg)


@pytest.fixture(scope="module")
def fe_chain():
    return _fe_side(ref, ref_make_rng, None, 7), _fe_side(port, make_rng, CPU, 7)


# name: (the function, its interval, the fit's degree, the inputs)
FUNCS = {
    "sigmoid": (lambda x: 1.0 / (1.0 + np.exp(-x)), (-8.0, 8.0), 5, np.linspace(-6, 6, 16)),
    "exp": (np.exp, (-1.0, 1.0), 5, np.linspace(-0.9, 0.9, 16)),
    "inverse": (lambda x: 1.0 / x, (0.2, 2.0), 5, np.linspace(0.3, 1.9, 16)),
    "function_linear": (np.cos, (-1.0, 1.0), 4, np.linspace(-0.9, 0.9, 16)),
}


@pytest.mark.parametrize("fn", list(FUNCS))
def test_funceval(boot, fn):
    """eval_sigmoid, eval_exp, eval_inverse (Paterson-Stockmeyer) and
    eval_function with the linear recurrence, on the bootstrap chain from
    the level where the refresh's EvalMod starts, word-equal to the
    reference's; the decode near the plain Chebyshev interpolant."""
    f, (a, b), degree, x = FUNCS[fn]
    outs = []
    for side in boot:
        fe, rng_fn = (ref_fe, ref_make_rng) if side["bt"] is ref_bt else (port_fe, make_rng)
        ct = side["eng"].encrypt(side["enc"].encode(x, side["full"]), side["pk"],
                                 side["full"].total_bits(), rng_fn(11))
        args = (side["ladder"], side["params"], _at_eval_level(side, ct))
        if fn == "function_linear":
            outs.append(fe.eval_function(*args, f, (a, b), degree=degree, method="linear"))
        else:
            outs.append(getattr(fe, f"eval_{fn}")(*args, interval=(a, b), degree=degree))
    _same_ct(outs[1], outs[0])
    u = (2 * x - a - b) / (b - a)
    want = np.polynomial.chebyshev.chebval(u, port_fe.chebyshev_fit(f, a, b, degree))
    got = _decode(boot[1], outs[1])[: len(x)].real
    assert np.max(np.abs(got - want)) < 2e-3


def test_eval_inverse_rejects_zero(fe_chain):
    p = fe_chain[1]
    with pytest.raises(ValueError):
        port_fe.eval_inverse(p["ladder"], p["params"], None, interval=(-1.0, 1.0))


def test_combine_heal(fe_chain):
    """tests/test_funceval.py's _combine case on both packages: above the
    1% tolerance one level is spent and the words agree; below it nothing
    is spent."""
    outs = []
    for side in fe_chain:
        ct = _encrypt(side, np.linspace(-0.5, 0.5, 32))

        def engine_at(level, side=side):
            return type(side["eng"])(side["ladder"].at_level(level).ctx, side["params"])

        healed = side["fe"]._combine(
            engine_at, ct, dataclasses.replace(ct, scale=ct.true_scale * 1.015))
        kept = side["fe"]._combine(
            engine_at, ct, dataclasses.replace(ct, scale=ct.true_scale * 1.005), sub=True)
        outs.append((ct, healed, kept))
    for got, want in zip(outs[1], outs[0]):
        _same_ct(got, want)
    ct, healed, kept = outs[1]
    assert healed.level == ct.level - 1 and kept.level == ct.level
