"""PyTorch port, host layer: primes, sampling, CRT, modular constants, the
plain torch NTT, encoder and conversion, held to the JAX reference.

Residues are compared by uint32 equality (the port's int32 planes carry
the reference's lo-limb bits); decoded slots by the reference tests'
1e-4 bound.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu.math import crt as ref_crt
from toy_heaan_ckks_tpu.math import primes as ref_primes
from toy_heaan_ckks_tpu.math import sampling as ref_sampling
from toy_heaan_ckks_tpu.ops import modular as ref_mm
from toy_heaan_ckks_tpu.ops import ntt as ref_ntt
from toy_heaan_ckks_tpu.ops import poly as ref_pops
from toy_heaan_ckks_tpu.ops.ntt_pallas import _planes_cached

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch.math import crt, primes, sampling
from toy_heaan_ckks_tpu_torch.ops import modular as mm
from toy_heaan_ckks_tpu_torch.ops import ntt, ntt_gpu

REPO = pathlib.Path(__file__).resolve().parent.parent


def _lo(arr) -> np.ndarray:
    """Reference (..., L, 2, N) uint32 -> lo limbs (hi limbs must be 0)."""
    arr = np.asarray(arr)
    assert not arr[..., 1, :].any()
    return arr[..., 0, :]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _rand_residues(seed, moduli, degree, lead=()):
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.integers(0, q, size=lead + (degree,), dtype=np.int64) for q in moduli],
        axis=-2,
    )


# ── primes, sampling, CRT ────────────────────────────────────────────────


@pytest.mark.parametrize("bits,count,degree", [
    (31, 8, 1 << 14), (31, 4, 1024), (30, 5, 1024), (28, 3, 64), (20, 2, 16),
])
def test_generate_primes_match(bits, count, degree):
    assert primes.generate_primes(bits, count, degree) == \
        ref_primes.generate_primes(bits, count, degree)


@pytest.mark.parametrize("q,order", [
    (2147473409, 2048), (2147352577, 1 << 15), (1073479681, 128), (97, 16),
])
def test_primitive_root_matches(q, order):
    assert primes.find_primitive_root(q, order) == \
        ref_primes.find_primitive_root(q, order)


@pytest.mark.parametrize("n", [0, 1, 2, 97, 561, 2147473409, (1 << 61) - 1,
                               3215031751, 4294967297])
def test_is_prime_matches(n):
    assert primes.is_prime(n) == ref_primes.is_prime(n)


def test_samplers_draw_the_same_stream():
    a, b = sampling.make_rng(5), ref_sampling.make_rng(5)
    np.testing.assert_array_equal(
        sampling.uniform_coefficients(64, 2147473409, a),
        ref_sampling.uniform_coefficients(64, 2147473409, b))
    np.testing.assert_array_equal(
        sampling.gaussian_coefficients(64, 3.2, a),
        ref_sampling.gaussian_coefficients(64, 3.2, b))
    np.testing.assert_array_equal(
        sampling.ternary_coefficients(64, 32, a),
        ref_sampling.ternary_coefficients(64, 32, b))


def test_crt_reconstruct_matches():
    moduli = ref_primes.generate_primes(31, 5, 64)
    res = _rand_residues(3, moduli, 64)
    got = crt.reconstruct_centered(res, moduli)
    want = ref_crt.reconstruct_centered(res.astype(np.uint64), moduli)
    assert [int(v) for v in got] == [int(v) for v in want]
    coeffs = np.array([-5, 0, 7, -(1 << 40)] * 16, dtype=np.int64)
    np.testing.assert_array_equal(
        crt.to_residues(coeffs, moduli).astype(np.int64),
        ref_crt.to_residues(coeffs, moduli).astype(np.int64))


# ── modular constants and arithmetic ─────────────────────────────────────


def test_chain_constants_match():
    moduli = tuple(ref_primes.generate_primes(31, 4, 1024))
    chain = mm.ModulusChain.build(moduli, "cpu")
    rchain = ref_mm.ModulusChain.build(moduli)
    np.testing.assert_array_equal(_u32(chain.qinv), np.asarray(rchain.qinv)[:, 0, 0])
    np.testing.assert_array_equal(chain.rmod[:, 0].numpy(), np.asarray(rchain.rmod)[:, 0, 0])
    assert chain.total_bits() == rchain.total_bits()


def test_wide_chain_not_ported():
    """Wide chains are ported to N = 2^16 (above 2^14 the kernels spread a
    plane over a thread-block cluster): at N = 2^15 the NTT of X is
    word-equal to the reference's evaluation points psi^{E_k} (tree order,
    ``ops/ntt.tree_leaf_exponents``) and its inverse returns X; N = 2^17
    is refused on every device."""
    n = 1 << 15
    q = ref_primes.generate_primes(61, 1, n)[0]
    x = torch.zeros((1, n), dtype=torch.int64)
    x[0, 1] = 1
    got = ntt_gpu.ntt_planes_wide(x, (q,), n, False)
    psi = ref_primes.find_primitive_root(q, 2 * n)
    assert got[0].tolist() == [pow(psi, e, q) for e in ref_ntt.tree_leaf_exponents(n)]
    assert torch.equal(ntt_gpu.ntt_planes_wide(got, (q,), n, True), x)
    for device in ("cpu", "meta"):
        too_big = torch.zeros((1, 1 << 17), dtype=torch.int64, device=device)
        with pytest.raises(ValueError, match=r"2\^16"):
            ntt_gpu.ntt_planes_wide(too_big, (q,), 1 << 17, False)


def test_context_defaults_to_cuda(monkeypatch):
    """No device given: the current CUDA device, never a quiet CPU."""
    from toy_heaan_ckks_tpu_torch.context import canonical_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert canonical_device(None) == torch.device("cuda", 0)
    assert canonical_device("cuda") == torch.device("cuda", 0)
    assert canonical_device("cpu") == torch.device("cpu")


def test_context_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.CkksContext.build(ref_primes.generate_primes(31, 2, 64), 64)


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod", "neg_mod"])
def test_elementwise_ops_match(op):
    moduli = tuple(ref_primes.generate_primes(31, 3, 64))
    ctx = port.CkksContext.build(moduli, 64, device="cpu")
    rctx = ref.CkksContext.build(moduli, 64)
    a = _rand_residues(1, moduli, 64)
    b = _rand_residues(2, moduli, 64)
    ta, tb = torch.from_numpy(a).int(), torch.from_numpy(b).int()
    ra, rb = convert.to_reference(ta), convert.to_reference(tb)
    q = ctx.chain.q
    got = {
        "mont_mul": lambda: mm.mont_mul(ta, tb, q, ctx.chain.rinv),
        "add_mod": lambda: mm.add_mod(ta, tb, q),
        "sub_mod": lambda: mm.sub_mod(ta, tb, q),
        "neg_mod": lambda: mm.neg_mod(ta, q),
    }[op]()
    want = {
        "mont_mul": lambda: ref_mm.mont_mul(ra, rb, rctx.chain),
        "add_mod": lambda: ref_mm.add_mod(ra, rb, rctx.chain),
        "sub_mod": lambda: ref_mm.sub_mod(ra, rb, rctx.chain),
        "neg_mod": lambda: ref_mm.neg_mod(ra, rctx.chain),
    }[op]()
    np.testing.assert_array_equal(_u32(got), _lo(want))


# ── the plain torch NTT (K1's twin) against the staged jnp oracle ────────


@pytest.mark.parametrize("degree", [16, 64, 256, 1024])
def test_tree_exponents_match(degree):
    assert ntt.tree_exponent_stages(degree) == ref_ntt.tree_exponent_stages(degree)
    assert ntt.tree_leaf_exponents(degree) == ref_ntt.tree_leaf_exponents(degree)


def test_compact_twiddles_match_expanded_planes():
    """Entry 2^s + g of the compact table is the reference's expanded
    stage-s plane at every position of group g."""
    degree = 1024
    moduli = tuple(ref_primes.generate_primes(31, 2, degree))
    fwd, inv = ntt.compact_twiddles(moduli, degree)
    fwd_w, _, inv_w, _, _, _, _ = _planes_cached(moduli, degree)
    for s in range(degree.bit_length() - 1):
        idx = (1 << s) + np.arange(degree) // (degree >> s)
        np.testing.assert_array_equal(fwd[:, idx], fwd_w[:, s])
        np.testing.assert_array_equal(inv[:, idx], inv_w[:, s])


@pytest.mark.parametrize("degree,count", [(16, 2), (64, 3), (256, 2), (1024, 3)])
@pytest.mark.parametrize("inverse", [False, True])
def test_torch_ntt_matches_staged_reference(degree, count, inverse):
    moduli = tuple(ref_primes.generate_primes(31, count, degree))
    x = torch.from_numpy(_rand_residues(degree, moduli, degree, (2,))).int()
    tabs = ntt.NttTables.build(moduli, degree, torch.device("cpu"))
    rctx = ref.CkksContext.build(moduli, degree)
    fn = ref_pops.to_coeff if inverse else ref_pops.to_ntt  # staged jnp on CPU
    want = fn(convert.to_reference(x), rctx)
    got = ntt.inverse_ntt(x, tabs) if inverse else ntt.forward_ntt(x, tabs)
    np.testing.assert_array_equal(_u32(got), _lo(want))


# ── context, poly, encoder ───────────────────────────────────────────────


def test_context_cached_per_device_and_levels():
    moduli = ref_primes.generate_primes(31, 3, 64)
    ctx = port.CkksContext.build(moduli, 64, device="cpu")
    assert port.CkksContext.build(tuple(moduli), 64, "cpu") is ctx
    child = ctx.drop_last(1)
    assert child.moduli == tuple(moduli[:2]) and child.device == ctx.device
    assert ctx.slice_channels(2, 3).moduli == (moduli[2],)
    assert ctx.total_bits() == ref.CkksContext.build(moduli, 64).total_bits()


@pytest.mark.parametrize("degree", [64, 1024])
def test_encode_residues_match(degree):
    moduli = ref_primes.generate_primes(31, 3, degree)
    ctx = port.CkksContext.build(moduli, degree, device="cpu")
    rctx = ref.CkksContext.build(moduli, degree)
    vals = np.linspace(-0.9, 0.9, degree // 2)
    pt = port.CkksEncoder(degree, 30).encode(vals, ctx)
    rpt = ref.CkksEncoder(degree, 30).encode(vals, rctx)
    np.testing.assert_array_equal(_u32(pt.poly.data), _lo(rpt.poly.data))
    np.testing.assert_allclose(
        port.CkksEncoder(degree, 30).decode(pt), vals, atol=1e-4)


@pytest.mark.parametrize("sampler", ["uniform", "gaussian", "tribits"])
def test_poly_samplers_match(sampler):
    degree = 64
    moduli = ref_primes.generate_primes(31, 3, degree)
    ctx = port.CkksContext.build(moduli, degree, device="cpu")
    rctx = ref.CkksContext.build(moduli, degree)
    a, b = sampling.make_rng(9), ref_sampling.make_rng(9)
    got, want = {
        "uniform": lambda: (port.Poly.sample_uniform(ctx, a),
                            ref.Poly.sample_uniform(rctx, b)),
        "gaussian": lambda: (port.Poly.sample_gaussian(ctx, 3.2, a),
                             ref.Poly.sample_gaussian(rctx, 3.2, b)),
        "tribits": lambda: (port.Poly.sample_tribits(ctx, 32, a),
                            ref.Poly.sample_tribits(rctx, 32, b)),
    }[sampler]()
    np.testing.assert_array_equal(_u32(got.data), _lo(want.data))
    np.testing.assert_array_equal(
        _u32(got.to_ntt_domain().data), _lo(want.to_ntt_domain().data))


def test_convert_round_trip_and_checks():
    arr = np.zeros((2, 3, 2, 8), np.uint32)
    arr[..., 0, :] = np.arange(48, dtype=np.uint32).reshape(2, 3, 8) * 12345
    t = convert.from_reference(arr, "cpu")
    assert t.dtype == torch.int32 and t.shape == (2, 3, 8)
    np.testing.assert_array_equal(convert.to_reference(t), arr)
    bad = arr.copy()
    bad[0, 0, 1, 0] = 1
    with pytest.raises(ValueError):
        convert.from_reference(bad, "cpu")


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax nor the reference
    package (AST scan: an environment may pre-import jax, so sys.modules
    cannot tell)."""
    files = sorted((REPO / "toy_heaan_ckks_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    banned = ("jax", "jaxlib", "toy_heaan_ckks_tpu")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path}: imports {name}"
