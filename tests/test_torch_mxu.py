"""PyTorch port, K9 (the matrix-product NTT) and the CKKS_NTT_MXU=1 path,
held to the JAX reference with uint32 equality.

- ``ntt_mxu.mxu_tables`` against the reference's ``_mxu_tables`` (limbs,
  twist, Shoup companions, fold constants, q, -q^{-1});
- the twin ``ntt_mxu.ntt_mxu`` against ``ntt_mxu_pallas(interpret=True)``
  at N = 1024 (the reference's jnp ``ntt_mxu`` costs ~17 s per case on
  one core, its Pallas kernel in interpret mode ~4 s) and against the
  port's staged NTT at every R = N / 128 in [8, 256];
- ``supported_mxu`` against the reference's;
- under ``CKKS_NTT_MXU=1``: ``small_fast``'s ``inv_ntt_fold``, ``ntt_lo``,
  ``rescale_ntt_lo`` and ``mod_down_lo`` against the reference's under
  the same variable (interpret mode), and the multiply, a rotation and a
  hoisted rotation sum through the port's entry points against the
  reference's words, with a spy on ``ntt_mxu_planes`` showing the route.

N = 1024, 4 x 31-bit primes, digit_size 2 (2 specials), seeds as in
tests/test_torch_slice.py; the reference objects are built once per module.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu.engine import _switch_plan as ref_switch_plan
from toy_heaan_ckks_tpu.ops import ntt_mxu as ref_mxu
from toy_heaan_ckks_tpu.ops import small_fast as ref_sf
from toy_heaan_ckks_tpu.parallel.sharded import (
    _mul_relin_rescale_arrays as ref_mul_arrays,
)

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch.keys import dec_inv_ints, default_special_primes
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
from toy_heaan_ckks_tpu_torch.ops import ntt_gpu, ntt_mxu, ntt_mxu_gpu
from toy_heaan_ckks_tpu_torch.ops import small_fast as sf
from toy_heaan_ckks_tpu_torch.parallel.sharded import batched_mul_relin_rescale

DEGREE = 1024
COUNT = 4
DIGIT_SIZE = 2
SCALE_BITS = 30
BATCH = 2


def _planes(seed, moduli, degree, lead=(BATCH,)):
    """int32 planes (lead..., L, N) of uniform residues from a numpy seed."""
    rng = np.random.default_rng(seed)
    arr = np.stack([rng.integers(0, q, size=lead + (degree,), dtype=np.int64)
                    for q in moduli], axis=-2)
    return torch.from_numpy(arr).to(torch.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(_u32(got), np.asarray(want, dtype=np.uint32))


def _eq_ref(got: torch.Tensor, want) -> None:
    """Port planes against the reference's (..., L, 2, N) limb pairs."""
    np.testing.assert_array_equal(convert.to_reference(got),
                                  np.asarray(want, dtype=np.uint32))


def _post(moduli):
    return tuple((q - 1) // 3 for q in moduli)


# ── tables, twin, envelope ───────────────────────────────────────────────


@pytest.mark.parametrize("degree", [1024, 4096])
@pytest.mark.parametrize("inverse,with_post", [(False, False), (True, False),
                                               (True, True)])
def test_tables_match_reference(degree, inverse, with_post):
    moduli = tuple(ref.generate_primes(31, 3, degree))
    post = _post(moduli) if with_post else None
    tabs = ntt_mxu.mxu_tables(moduli, degree, inverse, post, torch.device("cpu"))
    w1, w2, t, t_sh, rs, q, qinv = ref_mxu._mxu_tables(moduli, degree, inverse, post)
    r, c = ntt_mxu.layout(degree)
    assert (r, c) == ref_mxu._layout(degree) and tabs.rows == r
    for got, want in ((tabs.w_first, w1), (tabs.w_second, w2)):
        want = np.asarray(want, dtype=np.float32).astype(np.uint8)  # (4, L, K, K)
        k = want.shape[-1]
        np.testing.assert_array_equal(got[:, :, :k, :k].permute(1, 0, 2, 3).numpy(), want)
        # the row contraction's zero padding up to the mma depth
        assert got.shape[-1] == max(k, ntt_mxu.MIN_K)
        assert not got[:, :, k:, :].any() and not got[:, :, :, k:].any()
    _eq(tabs.t.reshape(len(moduli), r, c), t)
    _eq(tabs.t_shoup.reshape(len(moduli), r, c), t_sh)
    _eq(tabs.rs, rs)
    _eq(tabs.q, np.asarray(q)[:, 0, 0])
    _eq(tabs.qinv, np.asarray(qinv)[:, 0, 0])


@pytest.fixture(scope="module")
def chain():
    """The module's chain: base moduli and the extended basis (2 specials)."""
    moduli = tuple(ref.generate_primes(31, COUNT, DEGREE))
    ctx = port.CkksContext.build(moduli, DEGREE, device="cpu")
    return moduli, moduli + default_special_primes(ctx, DIGIT_SIZE)


@pytest.mark.parametrize("mode", ["forward", "inverse", "fold"])
def test_twin_matches_pallas_interpret(chain, mode):
    """3 x 31-bit at N = 1024 (the first three primes of the chain: the
    reference's compiled calls are reused by ``rescale_ntt_lo`` below)."""
    moduli = chain[0][:3]
    x = _planes(5, moduli, DEGREE)
    inverse = mode != "forward"
    post = _post(moduli) if mode == "fold" else None
    want = ref_mxu.ntt_mxu_pallas(jnp.asarray(_u32(x)), moduli, DEGREE, inverse,
                                  post=post, interpret=True)
    got = ntt_mxu.ntt_mxu(x, moduli, DEGREE, inverse, post)
    _eq(got, want)
    assert torch.equal(ntt_mxu_gpu.ntt_mxu_planes(x, moduli, DEGREE, inverse, post), got)


@pytest.mark.parametrize("log_n", range(10, 16))
@pytest.mark.parametrize("mode", ["forward", "inverse", "fold"])
def test_twin_matches_staged_ntt(log_n, mode):
    """R = 8 .. 256 (N = 2^10 .. 2^15), 2 channels: the twin equals the
    port's staged NTT (the fold against ``inv_ntt_fold``'s constants)."""
    degree = 1 << log_n
    moduli = tuple(ref.generate_primes(31, 2, degree))
    x = _planes(log_n, moduli, degree)
    inverse = mode != "forward"
    post = _post(moduli) if mode == "fold" else None
    final = None if post is None else sf._fold_consts(moduli, degree, post)
    assert torch.equal(ntt_mxu.ntt_mxu(x, moduli, degree, inverse, post),
                       ntt_gpu.ntt_twin(x, moduli, degree, inverse, final))


@pytest.mark.parametrize("log_n", range(9, 17))
@pytest.mark.parametrize("bits", [31, 61])
def test_supported_mxu_matches_reference(log_n, bits):
    degree = 1 << log_n
    moduli = tuple(ref.generate_primes(bits, 2, degree))
    ok = ntt_mxu.supported_mxu(degree, moduli)
    assert ok == ref_mxu.supported_mxu(degree, moduli)
    assert ok == (bits == 31 and 10 <= log_n <= 15)
    if not ok:
        x = torch.zeros((1, 2, degree), dtype=torch.int32)
        with pytest.raises(ValueError):
            ntt_mxu_gpu.ntt_mxu_planes(x, moduli, degree, False)


def test_post_needs_inverse(chain):
    x = _planes(1, chain[0], DEGREE)
    with pytest.raises(ValueError):
        ntt_mxu_gpu.ntt_mxu_planes(x, chain[0], DEGREE, False, _post(chain[0]))


# ── small_fast entry points under CKKS_NTT_MXU=1 ─────────────────────────


@pytest.fixture
def mxu_env(monkeypatch):
    """CKKS_NTT_MXU=1 and a spy counting ``small_fast``'s K9 calls."""
    monkeypatch.setenv("CKKS_NTT_MXU", "1")
    calls = []
    real = sf.ntt_mxu_planes

    def spy(*args, **kw):
        calls.append(args[3])  # inverse
        return real(*args, **kw)

    monkeypatch.setattr(sf, "ntt_mxu_planes", spy)
    return calls


def _contexts(moduli, ext):
    return (port.CkksContext.build(moduli, DEGREE, device="cpu"),
            port.CkksContext.build(ext, DEGREE, device="cpu"),
            ref.CkksContext.build(moduli, DEGREE), ref.CkksContext.build(ext, DEGREE))


ENTRY_POINTS = ("inv_ntt_fold", "ntt_lo_forward", "ntt_lo_inverse",
                "rescale_ntt_lo", "mod_down_lo")
# K9 calls per entry point (True: inverse)
K9_CALLS = {"inv_ntt_fold": [True], "ntt_lo_forward": [False],
            "ntt_lo_inverse": [True], "rescale_ntt_lo": [True, False],
            "mod_down_lo": [True, False]}


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_small_fast_entry_points_match_reference(chain, mxu_env, entry):
    moduli, ext = chain
    ctx, ext_ctx, rctx, rext = _contexts(moduli, ext)
    x = _planes(7, moduli, DEGREE)
    rx = jnp.asarray(_u32(x))
    if entry == "inv_ntt_fold":
        post = dec_inv_ints(moduli, DIGIT_SIZE)
        got = sf.inv_ntt_fold(x, moduli, DEGREE, post)
        want = ref_sf.inv_ntt_fold(rx, moduli, DEGREE, post, interpret=True)
    elif entry.startswith("ntt_lo"):
        inverse = entry.endswith("inverse")
        got = sf.ntt_lo(x, moduli, DEGREE, inverse)
        want = ref_sf.ntt_lo(rx, moduli, DEGREE, inverse, interpret=True)
    elif entry == "rescale_ntt_lo":
        got = sf.rescale_ntt_lo(x, ctx)
        want = ref_sf.rescale_ntt_lo(rx, rctx, interpret=True)
    else:
        xe = _planes(8, ext, DEGREE)
        got = sf.mod_down_lo(xe, ctx, ext_ctx)
        plan = ref_switch_plan(rctx.moduli, rext.moduli, DIGIT_SIZE)
        want = ref_sf.mod_down_lo(jnp.asarray(_u32(xe)), rctx, rext, plan,
                                  interpret=True)
    _eq(got, want)
    assert mxu_env == K9_CALLS[entry]


def test_entry_points_without_env_run_k1(chain, monkeypatch):
    """Unset, the same entry points take K1's route (no K9 call) and give
    the same words."""
    moduli, ext = chain
    ctx, ext_ctx, _, _ = _contexts(moduli, ext)
    x, xe = _planes(7, moduli, DEGREE), _planes(8, ext, DEGREE)
    monkeypatch.delenv("CKKS_NTT_MXU", raising=False)

    def run():
        return (sf.ntt_lo(x, moduli, DEGREE, False), sf.rescale_ntt_lo(x, ctx),
                sf.mod_down_lo(xe, ctx, ext_ctx))

    base = run()
    monkeypatch.setattr(sf, "ntt_mxu_planes", None)  # any K9 call would fail
    assert all(torch.equal(a, b) for a, b in zip(base, run()))
    monkeypatch.undo()
    monkeypatch.setenv("CKKS_NTT_MXU", "1")
    assert all(torch.equal(a, b) for a, b in zip(base, run()))


# ── the slice under CKKS_NTT_MXU=1 ───────────────────────────────────────


def _keys_and_cts(pkg, values):
    """Keys from seed 42 (relin and rotation keys 1, -1, 3, digit_size 2)
    and 2 x BATCH ciphertexts, through ``pkg``."""
    kw = {"device": "cpu"} if pkg is port else {}
    ctx = pkg.CkksContext.build(pkg.generate_primes(31, COUNT, DEGREE), DEGREE, **kw)
    eng = pkg.CkksEngine(ctx, pkg.CkksParams(3.2, DEGREE // 2, SCALE_BITS))
    rng = make_rng(42)
    sk = eng.generate_secret_key(rng)
    pk = eng.generate_public_key(sk, rng)
    rlk = eng.generate_gadget_relin_key(sk, rng, digit_size=DIGIT_SIZE)
    rotks = {k: eng.generate_gadget_rotation_key(sk, k, rng, digit_size=DIGIT_SIZE)
             for k in (1, -1, 3)}
    enc = pkg.CkksEncoder(DEGREE, SCALE_BITS)
    cts = [[eng.encrypt(enc.encode(v, ctx), pk, ctx.total_bits(), rng)
            for v in side] for side in values]
    return dict(ctx=ctx, rlk=rlk, rotks=rotks, cts=cts)


OPS = ("batched_mul", "mul_rescale", "rotate", "rotate_sum_hoisted")


def _ops(pkg, s):
    E = pkg.CkksEngine
    ctx, rlk, rotks, cts = s["ctx"], s["rlk"], s["rotks"], s["cts"]
    ca, cb = cts[0][0], cts[1][0]
    if pkg is port:
        stack = lambda side, part: torch.stack([getattr(c, part).data for c in cts[side]])
        batched = lambda: batched_mul_relin_rescale(
            (stack(0, "c0"), stack(0, "c1")), (stack(1, "c0"), stack(1, "c1")),
            rlk, ctx, ctx.drop_last(1))
    else:
        stack = lambda side, part: jnp.stack([getattr(c, part).data for c in cts[side]])
        batched = lambda: ref_mul_arrays(
            stack(0, "c0"), stack(0, "c1"), stack(1, "c0"), stack(1, "c1"),
            rlk.a, rlk.b, ctx, rlk.ext_ctx, ctx.drop_last(1), digit_size=DIGIT_SIZE)
    pair = lambda ct: (ct.c0.data, ct.c1.data)
    thunks = {
        "batched_mul": batched,
        "rotate": lambda: pair(E.rotate_ciphertext(ca, rotks[1])),
        "rotate_sum_hoisted": lambda: pair(E.rotate_sum_hoisted(ca, [rotks[-1], rotks[3]])),
    }
    if pkg is port:
        thunks["mul_rescale"] = lambda: pair(E.mul_rescale(ca, cb, rlk))
    return thunks


@pytest.fixture(scope="module")
def slice_outputs():
    """The reference's outputs (its generic path) and the port's under
    CKKS_NTT_MXU=1, with the K9 calls of each port op."""
    values = np.random.default_rng(3).uniform(-1, 1, size=(2, BATCH, DEGREE // 2))
    r = _keys_and_cts(ref, values)
    want = {op: fn() for op, fn in _ops(ref, r).items()}
    # the reference's single multiply is its batched composite's item 0
    want["mul_rescale"] = tuple(o[0] for o in want["batched_mul"])
    p = _keys_and_cts(port, values)
    got, k9 = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CKKS_NTT_MXU", "1")
        real = sf.ntt_mxu_planes
        for op, fn in _ops(port, p).items():
            calls = []
            mp.setattr(sf, "ntt_mxu_planes",
                       lambda *a, **kw: calls.append(a[3]) or real(*a, **kw))
            got[op], k9[op] = fn(), calls
    return dict(got=got, want=want, k9=k9)


@pytest.mark.parametrize("op", OPS)
def test_slice_under_mxu_matches_reference(slice_outputs, op):
    got, want = slice_outputs["got"][op], slice_outputs["want"][op]
    for g, w in zip(got, want):
        _eq_ref(g, w)
    # the multiply's and the rotation's decomposition fold (inverse); the
    # hoisted sum's two mod-downs each a fold and a forward transform
    expected = {"batched_mul": [True], "mul_rescale": [True], "rotate": [True],
                "rotate_sum_hoisted": [True, False, True, False]}[op]
    assert slice_outputs["k9"][op] == expected
