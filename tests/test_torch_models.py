"""PyTorch port, ``models/compare.py`` and ``models/linalg.py``, held to the
JAX reference.

Both packages run from the same numpy seeds and their outputs are compared
word for word (the port's residues through ``convert.to_reference``, with
the level, logp, logq and exact scale); the host numpy parts (the sign
polynomial families, ``plan_sign_iterations``, the diagonal maps) exactly.

Setups are ``tests/test_compare.py``'s (DEGREE 64, 30-bit primes, hw 8,
seed 23) and ``tests/test_linalg.py``'s (DEGREE 64 matvec, 31-bit, seed 29;
DEGREE 128 matmul, d = 8, seed 37), one chain and one lazy ladder per
package and setup (module fixtures): each test calls the same key-drawing
ops in both packages in the same order, so their generators stay in step
whatever order the tests run in. The reference's compare circuit is slow
on the CPU (a degree-7 Paterson-Stockmeyer step spans ~4 levels), so each
comparison runs at the shortest setting that reaches its branches: one
f_1 step (degree 3), and one case with a g_3 step then an f_1 step for
both branches and the order of composition. Each decode is held to the host composition of the
same polynomials.
"""

import importlib

import numpy as np
import pytest
import torch

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu.errors import CkksError as RefCkksError
from toy_heaan_ckks_tpu.math.sampling import make_rng as ref_make_rng

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch.errors import CkksError
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng

ref_cmp = importlib.import_module("toy_heaan_ckks_tpu.models.compare")
port_cmp = importlib.import_module("toy_heaan_ckks_tpu_torch.models.compare")
ref_la = importlib.import_module("toy_heaan_ckks_tpu.models.linalg")
port_la = importlib.import_module("toy_heaan_ckks_tpu_torch.models.linalg")

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


def _side(pkg, rng_fn, degree, bits, count, hw, seed, matvec_keys=False):
    kw = {} if pkg is ref else {"device": CPU}
    full = pkg.CkksContext.build(pkg.generate_primes(bits, count, degree), degree, **kw)
    params = pkg.CkksParams(3.2, hw, bits)
    eng = pkg.CkksEngine(full, params)
    rng = rng_fn(seed)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    ladder = pkg.KeyLadder(full, sk, 3.2, rng, lazy=True)
    la = ref_la if pkg is ref else port_la
    side = dict(full=full, params=params, eng=eng, rng=rng, sk=sk, pk=pk, ladder=ladder,
                enc=pkg.CkksEncoder(degree, bits), cmp=ref_cmp if pkg is ref else port_cmp,
                la=la)
    if matvec_keys:
        side["keys"] = la.MatvecKeys(ladder, params, rng)
    return side


def _pair(*args, **kw):
    return _side(ref, ref_make_rng, *args, **kw), _side(port, make_rng, *args, **kw)


def _encrypt(side, values, complex_=False):
    encode = side["enc"].encode_complex if complex_ else side["enc"].encode
    return side["eng"].encrypt(encode(values, side["full"]), side["pk"],
                               side["full"].total_bits(), side["rng"])


def _decode(side, ct, complex_=False):
    pt = type(side["eng"]).decrypt(ct, side["sk"].reduce_to(ct.ctx))
    return (side["enc"].decode_complex if complex_ else side["enc"].decode)(pt)


# ── host numpy: exact equality ───────────────────────────────────────────


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_sign_f_coeffs(n):
    np.testing.assert_array_equal(port_cmp.sign_f_coeffs(n), ref_cmp.sign_f_coeffs(n))


def test_sign_g3_and_rejects():
    np.testing.assert_array_equal(port_cmp.SIGN_G3, ref_cmp.SIGN_G3)
    with pytest.raises(ValueError):
        port_cmp.sign_f_coeffs(0)
    with pytest.raises(ValueError):
        port_cmp.plan_sign_iterations(1e-9, 1e-12)
    with pytest.raises(ValueError):
        port_cmp.plan_sign_iterations(0.0, 1e-3)


@pytest.mark.parametrize("delta,eps,n", [(0.05, 1e-3, 3), (0.25, 1e-2, 3), (0.1, 1e-4, 2),
                                         (0.5, 1e-2, 1)])
def test_plan_sign_iterations(delta, eps, n):
    got = port_cmp.plan_sign_iterations(delta, eps, n)
    assert got == ref_cmp.plan_sign_iterations(delta, eps, n)
    xs = np.linspace(-1, 1, 101)
    np.testing.assert_array_equal(port_cmp._compose_sign(xs, *got, n),
                                  ref_cmp._compose_sign(xs, *got, n))


def _same_diag_map(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for r in want:
        np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("d", [2, 4, 8, 16])
def test_diagonal_maps(d):
    for name in ("_sigma_diagonals", "_tau_diagonals", "_transpose_diagonals"):
        _same_diag_map(getattr(port_la, name)(d), getattr(ref_la, name)(d))


def test_matrix_diagonals():
    m = np.random.default_rng(2).uniform(-1, 1, (8, 8))
    for got, want in zip(port_la.matrix_diagonals(m), ref_la.matrix_diagonals(m)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        port_la.matrix_diagonals(np.zeros((2, 3)))
    for n2 in (32, 2, 8):
        with pytest.raises(CkksError):
            port_la._square_dim(n2)
        with pytest.raises(RefCkksError):
            ref_la._square_dim(n2)
    assert port_la._square_dim(64) == ref_la._square_dim(64) == 8


# ── compare: tests/test_compare.py's chain, one ladder per package ──────

CMP_DEGREE, CMP_COUNT = 64, 16


@pytest.fixture(scope="module")
def cmp_chain():
    # tests/test_compare.py _setup(16): 30-bit primes, hw 8, seed 23
    return _pair(CMP_DEGREE, 30, CMP_COUNT, 8, 23)


def _signed(n):
    return np.concatenate([np.linspace(0.2, 1.0, n // 2), -np.linspace(0.2, 1.0, n // 2)])


def _operands(n):
    rs = np.random.default_rng(5)
    lo = rs.uniform(0.0, 0.35, n)
    hi = lo + rs.uniform(0.25, 0.6, n)
    swap = rs.uniform(size=n) < 0.5
    return np.where(swap, lo, hi), np.where(swap, hi, lo)


# (g_iters, f_iters, n): one f_1 step, and a g_3 step then an f_1 step (both
# branches, in the order of composition)
SIGN_KW = {"f1": dict(g_iters=0, f_iters=1, n=1), "g+f1": dict(g_iters=1, f_iters=1, n=1)}


@pytest.mark.parametrize("kind", list(SIGN_KW))
def test_eval_sign(cmp_chain, kind):
    kw = SIGN_KW[kind]
    x = _signed(CMP_DEGREE // 2)
    outs = []
    for side in cmp_chain:
        ct = _encrypt(side, x)
        outs.append(side["cmp"].eval_sign(side["ladder"], side["params"], ct, **kw))
    _same_ct(outs[1], outs[0])
    want = port_cmp._compose_sign(x, kw["g_iters"], kw["f_iters"], kw.get("n", 3))
    got = _decode(cmp_chain[1], outs[1])[: len(x)]
    assert np.max(np.abs(got - want)) < 1e-3


def test_eval_sign_rejects(cmp_chain):
    p = cmp_chain[1]
    with pytest.raises(ValueError):
        port_cmp.eval_sign(p["ladder"], p["params"], None, g_iters=0, f_iters=0)


# name: (the function's inputs, the host value of the composition f_1)
def _f1(x):
    return port_cmp._compose_sign(x, 0, 1, 1)


CMP_CASES = {
    "eval_abs": lambda a, b: a * _f1(a),
    "compare": lambda a, b: (_f1(a - b) + 1) / 2,
    "eval_max": lambda a, b: (a + b) / 2 + (a - b) / 2 * _f1(a - b),
    "eval_min": lambda a, b: (a + b) / 2 - (a - b) / 2 * _f1(a - b),
    "eval_relu": lambda a, b: (a + a * _f1(a)) / 2,
}


@pytest.mark.parametrize("fn", list(CMP_CASES))
def test_compare_ops(cmp_chain, fn):
    """abs / compare / max / min / relu on one f_1 step: word-equal to the
    reference's, the decode near the host composition."""
    n = CMP_DEGREE // 2
    unary = fn in ("eval_abs", "eval_relu")
    a, b = (_signed(n), None) if unary else _operands(n)
    outs = []
    for side in cmp_chain:
        cts = [_encrypt(side, a)] + ([] if unary else [_encrypt(side, b)])
        outs.append(getattr(side["cmp"], fn)(side["ladder"], side["params"], *cts,
                                             **SIGN_KW["f1"]))
    _same_ct(outs[1], outs[0])
    got = _decode(cmp_chain[1], outs[1])[:n]
    assert np.max(np.abs(got - CMP_CASES[fn](a, b))) < 1e-3


def test_mul_cts_aligns(cmp_chain):
    """``_mul_cts`` of operands at different levels: the higher one aligned
    down, then the fused multiply with that level's relin key."""
    x = np.linspace(-0.9, 0.9, CMP_DEGREE // 2)
    outs = []
    for side in cmp_chain:
        ct = _encrypt(side, x)
        low = side["eng"].rescale_ciphertext(side["eng"].mul_plain_scalar(ct, 0.5))
        outs.append(side["cmp"]._mul_cts(side["ladder"], side["params"], ct, low))
    _same_ct(outs[1], outs[0])
    assert outs[1].level == CMP_COUNT - 2
    got = _decode(cmp_chain[1], outs[1])[: len(x)]
    assert np.max(np.abs(got - 0.5 * x * x)) < 1e-4


# ── linalg: tests/test_linalg.py's setups ────────────────────────────────

MV_DEGREE, MM_DEGREE, MM_D = 64, 128, 8


@pytest.fixture(scope="module")
def mv_chain():
    # tests/test_linalg.py test_encrypted_matvec_matches_plain: 3 x 31-bit, hw 4
    return _pair(MV_DEGREE, 31, 3, 4, 29, matvec_keys=True)


@pytest.fixture(scope="module")
def mm_chain():
    # tests/test_linalg.py _matmul_setup(5): N = 128, 5 x 30-bit, hw 8
    return _pair(MM_DEGREE, 30, 5, 8, 37, matvec_keys=True)


@pytest.mark.parametrize("giant", [None, 8, "auto"])
def test_encrypted_matvec(mv_chain, giant):
    n2 = MV_DEGREE // 2
    rs = np.random.default_rng(4)
    m = rs.uniform(-0.2, 0.2, (n2, n2)) + 1j * rs.uniform(-0.2, 0.2, (n2, n2))
    v = rs.uniform(-0.5, 0.5, n2) + 1j * rs.uniform(-0.5, 0.5, n2)
    outs = []
    for side in mv_chain:
        ct = _encrypt(side, v, complex_=True)
        outs.append(side["la"].encrypted_matvec(ct, m, side["keys"], side["enc"],
                                                giant=giant))
    _same_ct(outs[1], outs[0])
    assert outs[1].level == 2
    got = _decode(mv_chain[1], outs[1], complex_=True)[:n2]
    np.testing.assert_allclose(got, m @ v, atol=3e-4)


def test_matvec_and_matmul_reject(mv_chain):
    """A matrix of the wrong shape (ValueError) and a matmul on N/2 = 32
    slots, not a square (CkksError), in both packages."""
    for side, err in zip(mv_chain, (RefCkksError, CkksError)):
        ct = _encrypt(side, np.zeros(MV_DEGREE // 2))
        with pytest.raises(ValueError):
            side["la"].encrypted_matvec(ct, np.zeros((4, 4)), side["keys"], side["enc"])
        with pytest.raises(err, match="d\\^2 = N/2"):
            side["la"].encrypted_matmul(ct, ct, side["keys"], side["enc"])


def _matrices():
    rs = np.random.default_rng(11)
    a = rs.uniform(-1, 1, (MM_D, MM_D)) / np.sqrt(MM_D)
    return a, rs.uniform(-1, 1, (MM_D, MM_D)) / np.sqrt(MM_D)


def test_encrypted_matmul(mm_chain):
    """JKLS d = 8 at N = 128, both operands encrypted: word-equal to the
    reference's, three levels, the decode near A @ B."""
    a, b = _matrices()
    outs = []
    for side in mm_chain:
        ca, cb = _encrypt(side, a.reshape(-1)), _encrypt(side, b.reshape(-1))
        outs.append(side["la"].encrypted_matmul(ca, cb, side["keys"], side["enc"]))
    _same_ct(outs[1], outs[0])
    assert outs[1].level == 5 - 3
    got = _decode(mm_chain[1], outs[1])[: MM_D * MM_D].reshape(MM_D, MM_D)
    np.testing.assert_allclose(got, a @ b, atol=2e-3)


def test_encrypted_transpose(mm_chain):
    a = np.random.default_rng(13).uniform(-1, 1, (MM_D, MM_D))
    outs = []
    for side in mm_chain:
        outs.append(side["la"].encrypted_transpose(_encrypt(side, a.reshape(-1)),
                                                   side["keys"], side["enc"]))
    _same_ct(outs[1], outs[0])
    assert outs[1].level == 5 - 1
    got = _decode(mm_chain[1], outs[1])[: MM_D * MM_D].reshape(MM_D, MM_D)
    np.testing.assert_allclose(got, a.T, atol=3e-4)


def test_encrypted_matmul_rejects(mm_chain):
    """Operands at different levels or with different scales raise the
    reference's errors with its messages."""
    for side, err in zip(mm_chain, (RefCkksError, CkksError)):
        eng, la = side["eng"], side["la"]
        ct = _encrypt(side, np.zeros(MM_D * MM_D))
        low = eng.rescale_ciphertext(eng.mul_plain_scalar(ct, 1.0))
        with pytest.raises(err, match="same level"):
            la.encrypted_matmul(ct, low, side["keys"], side["enc"])
        scaled = type(ct)(c0=ct.c0, c1=ct.c1, logp=ct.logp, logq=ct.logq,
                          scale=ct.true_scale * 1.5)
        with pytest.raises(err, match="scales differ"):
            la.encrypted_matmul(ct, scaled, side["keys"], side["enc"])
