"""PyTorch port, the coefficient-sharded NTT and composites, held to the JAX
reference on the 8-virtual-device CPU mesh of ``tests/conftest.py``.

The same numpy-seeded residues go through the reference's
``parallel/coeff_ntt.py`` / ``coeff_composite.py`` builders (or its
unsharded oracles) and through the port's (``parallel/mesh.py``,
``coeff_ntt.py``, ``coeff_composite.py``) on a CPU coefficient mesh, where
K10 and K11 run as their twins (``ops/coeff_ntt_gpu.py``). Every output
must be word-equal (uint32 limbs, the hi limbs zero on small chains):

- the sharded NTT at P = 8 under each of the reference's switches
  (``use_pallas=False``; ``use_pallas=True`` with K10 in interpret mode;
  ``remote_dma=True`` with K11 in interpret mode), at P in {2, 4} on
  ``jax.devices()[:P]``, and at P = 1 against the port's ``ntt_planes``;
  K10's twin against the reference's tail kernel in interpret mode;
- the wide sharded NTT (3 x 61-bit) against ``build_coeff_sharded_ntt_wide``;
- the multiply at ds 1 against the reference's sharded builder with K11 in
  interpret mode, at ds 2 and wide against ``_mul_relin_rescale_arrays``;
  the rotations (small, wide) against ``CkksEngine.rotate_ciphertext``;
  each composite also against the port's unsharded path.

Keys come from the reference's keygen and are carried over with
``convert.py`` and ``shard_planes``. Each reference output is computed once
per module.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu.math.sampling import make_rng as ref_make_rng
from toy_heaan_ckks_tpu.ops.ntt_pallas import _planes_cached
from toy_heaan_ckks_tpu.ops.poly import Poly as RefPoly
from toy_heaan_ckks_tpu.parallel.coeff_composite import (
    build_mul_relin_rescale_coeff as ref_build_mul,
)
from toy_heaan_ckks_tpu.parallel.coeff_ntt import (
    _local_tail_pallas,
    build_coeff_sharded_ntt as ref_build_ntt,
    build_coeff_sharded_ntt_wide as ref_build_ntt_wide,
)
from toy_heaan_ckks_tpu.parallel.sharded import (
    _mul_relin_rescale_arrays as ref_mul_arrays,
)

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch.ops import coeff_ntt_gpu, ntt_gpu
from toy_heaan_ckks_tpu_torch.parallel.coeff_composite import (
    build_mul_relin_rescale_coeff, build_rotate_coeff,
)
from toy_heaan_ckks_tpu_torch.parallel.coeff_ntt import (
    build_coeff_sharded_ntt, build_coeff_sharded_ntt_wide, coeff_ntt,
)
from toy_heaan_ckks_tpu_torch.parallel.mesh import (
    CoeffMesh, make_coeff_mesh, shard_planes, unshard_planes,
)
from toy_heaan_ckks_tpu_torch.parallel.sharded import (
    _mul_relin_rescale_arrays, _rotate_arrays,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

CPU = torch.device("cpu")
BATCH = 2


def _limbs(seed: int, moduli, degree: int, lead: tuple) -> np.ndarray:
    """Uniform residues as the reference's uint32 (..., L, 2, N) limbs."""
    rng = np.random.default_rng(seed)
    words = np.stack([rng.integers(0, q, size=lead + (degree,), dtype=np.uint64)
                      for q in moduli], axis=-2)
    lo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (words >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=-2)


def _ref_mesh(shards: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:shards]), axis_names=("coeff",))


def _ref_shard(x, mesh: Mesh):
    """The reference's coefficient layout: the last axis on ``coeff``."""
    spec = P(*([None] * (np.ndim(x) - 1)), "coeff")
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _eq(got: torch.Tensor, want) -> None:
    """Port words (int32 / int64) against reference limbs (..., L, 2, N)."""
    np.testing.assert_array_equal(convert.to_reference(got),
                                  np.asarray(want, dtype=np.uint32))


# ── the sharded NTT ──────────────────────────────────────────────────────

# (degree, prime count, shards, reference mode); mode "jnp": ppermute cross
# stages and jnp local stages; "tail": K10 in interpret mode; "dma": K11 in
# interpret mode
NTT_CASES = (
    [(n, c, 8, mode) for n, c in ((1024, 3), (2048, 2))
     for mode in ("jnp", "tail", "dma")]
    + [(1024, 3, shards, "jnp") for shards in (2, 4)]
)
MODE_KW = {"jnp": dict(use_pallas=False),
           "tail": dict(use_pallas=True, interpret=True),
           "dma": dict(use_pallas=False, remote_dma=True, interpret=True)}


def _ntt_input(degree: int, count: int, bits: int = 30):
    moduli = tuple(ref.generate_primes(bits, count, degree))
    return moduli, _limbs(degree + count, moduli, degree, (BATCH,))


@pytest.fixture(scope="module")
def ref_ntt():
    """Reference outputs of each NTT case, computed once (lazily)."""
    cache = {}

    def get(degree, count, shards, mode, inverse):
        key = (degree, count, shards, mode, inverse)
        if key not in cache:
            moduli, x = _ntt_input(degree, count)
            mesh = _ref_mesh(shards)
            fn = ref_build_ntt(mesh, moduli, degree, inverse=inverse,
                               **MODE_KW[mode])
            cache[key] = np.asarray(fn(_ref_shard(x[..., 0, :], mesh)))
        return cache[key]

    return get


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("degree,count,shards,mode", NTT_CASES)
def test_sharded_ntt_matches_reference(ref_ntt, degree, count, shards, mode,
                                       inverse):
    moduli, x = _ntt_input(degree, count)
    mesh = make_coeff_mesh(shards, "cpu")
    slabs = shard_planes(convert.from_reference(x, CPU), mesh)
    out = build_coeff_sharded_ntt(mesh, moduli, degree, inverse)(slabs)
    assert len(out) == shards and all(t.shape == (BATCH, count, degree // shards)
                                      for t in out)
    want = ref_ntt(degree, count, shards, mode, inverse)
    np.testing.assert_array_equal(unshard_planes(out).numpy().view(np.uint32), want)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_one_shard_is_the_unsharded_ntt(wide, inverse):
    """P = 1: no cross stage, K10 alone is the whole NTT (== K1 / K5)."""
    degree = 512
    moduli, x = _ntt_input(degree, 3, 61 if wide else 30)
    planes = convert.from_reference(x, CPU, wide=wide)
    mesh = make_coeff_mesh(1, "cpu")
    build = build_coeff_sharded_ntt_wide if wide else build_coeff_sharded_ntt
    (got,) = build(mesh, moduli, degree, inverse)(shard_planes(planes, mesh))
    unsharded = ntt_gpu.ntt_planes_wide if wide else ntt_gpu.ntt_planes
    assert torch.equal(got, unsharded(planes, moduli, degree, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_tail_twin_matches_reference_kernel(inverse):
    """K10's twin on slab 5 of 8 against the reference's ``_tail_kernel``
    in interpret mode on the same slab and its twiddle slices."""
    degree, count, shards, p = 1024, 2, 8, 5
    moduli, x = _ntt_input(degree, count)
    s, cross, log_n = degree // shards, 3, 10
    fwd_w, fwd_wp, inv_w, inv_wp, q_col, _, _ = _planes_cached(moduli, degree)
    w, wp = (inv_w, inv_wp) if inverse else (fwd_w, fwd_wp)
    cut = slice(p * s, (p + 1) * s)
    want = np.asarray(_local_tail_pallas(
        jnp.asarray(x[..., 0, cut]), jnp.asarray(w[:, cross:, cut]),
        jnp.asarray(wp[:, cross:, cut]), jnp.asarray(q_col), n=degree,
        s0=cross, s_count=log_n, inverse=inverse, interpret=True))
    slabs = shard_planes(convert.from_reference(x, CPU), make_coeff_mesh(shards, "cpu"))
    got = coeff_ntt_gpu.coeff_tail(slabs, moduli, degree, inverse)[p]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_wide_sharded_ntt_matches_reference(inverse):
    degree, shards = 512, 8
    moduli, x = _ntt_input(degree, 3, 61)
    fn = ref_build_ntt_wide(_ref_mesh(shards), moduli, degree, inverse=inverse)
    want = np.asarray(fn(_ref_shard(x, _ref_mesh(shards))))
    mesh = make_coeff_mesh(shards, "cpu")
    slabs = shard_planes(convert.from_reference(x, CPU, wide=True), mesh)
    out = build_coeff_sharded_ntt_wide(mesh, moduli, degree, inverse)(slabs)
    _eq(unshard_planes(out), want)


# ── composites ───────────────────────────────────────────────────────────

# name: (degree, bits, prime count, digit_size, batch)
COMPOSITES = {
    "mul-ds1": (1024, 30, 3, 1, 1),
    "mul-ds2": (1024, 30, 4, 2, BATCH),
    "mul-wide": (512, 61, 3, 1, BATCH),
    "rot": (1024, 30, 3, 1, 1),
    "rot-wide": (512, 61, 3, 1, 1),
}


@functools.lru_cache(maxsize=None)
def _secret(degree: int, bits: int, count: int):
    """The reference's context, engine, secret key and key stream (seed
    17), one per chain: a multiply and a rotation case share them."""
    ctx = ref.CkksContext.build(ref.generate_primes(bits, count, degree), degree)
    eng = ref.CkksEngine(ctx, ref.CkksParams(3.2, degree // 2, bits))
    rng = ref_make_rng(17)
    return ctx, eng, eng.generate_secret_key(rng), rng


def _composite(name: str) -> dict:
    """Reference keys and outputs of one composite, the inputs, and the
    port's keys carried over with ``convert.py``."""
    degree, bits, count, ds, batch = COMPOSITES[name]
    ctx, eng, sk, rng = _secret(degree, bits, count)
    rotate = name.startswith("rot")
    key = (eng.generate_gadget_rotation_key(sk, 1, rng, digit_size=ds) if rotate
           else eng.generate_gadget_relin_key(sk, rng, digit_size=ds))
    args = [_limbs(100 + i, ctx.moduli, degree, (batch,))
            for i in range(2 if rotate else 4)]
    a, b = np.asarray(key.a), np.asarray(key.b)
    if rotate:
        ct = ref.Ciphertext(c0=RefPoly(jnp.asarray(args[0][0]), ctx, True),
                            c1=RefPoly(jnp.asarray(args[1][0]), ctx, True),
                            logp=bits, logq=ctx.total_bits())
        out = ref.CkksEngine.rotate_ciphertext(ct, key)
        want = [np.asarray(out.c0.data)[None], np.asarray(out.c1.data)[None]]
        port_key = convert.rotation_key_from_reference(
            a, b, 1, ctx.moduli, key.ext_ctx.moduli, ds, degree, CPU)
    elif name == "mul-ds1":
        mesh = _ref_mesh(8)
        fn = ref_build_mul(mesh, ctx, key.ext_ctx, digit_size=ds,
                           remote_dma=True, interpret=True)
        want = [np.stack([np.asarray(w), np.zeros_like(w)], axis=-2) for w in
                fn(*[_ref_shard(x[..., 0, :], mesh) for x in args],
                   _ref_shard(a[..., 0, :], mesh), _ref_shard(b[..., 0, :], mesh))]
        port_key = convert.relin_key_from_reference(
            a, b, ctx.moduli, key.ext_ctx.moduli, ds, degree, CPU)
    else:
        want = [np.asarray(w) for w in ref_mul_arrays(
            *[jnp.asarray(x) for x in args], key.a, key.b, ctx, key.ext_ctx,
            ctx.drop_last(1), digit_size=ds)]
        port_key = convert.relin_key_from_reference(
            a, b, ctx.moduli, key.ext_ctx.moduli, ds, degree, CPU)
    return dict(args=args, key=port_key, want=want, ref_key=(a, b))


@pytest.fixture(scope="module")
def composites():
    cache = {}

    def get(name):
        if name not in cache:
            case = _composite(name)
            case["got"], case["unsharded"] = _port_composite(name, case)
            cache[name] = case
        return cache[name]

    return get


def _port_composite(name: str, case: dict, shards: int = 8):
    """The port's sharded composite and its unsharded path on the case."""
    wide = COMPOSITES[name][1] > 31
    key = case["key"]
    ctx, ext_ctx = key.ctx, key.ext_ctx
    planes = [convert.from_reference(x, CPU, wide=wide) for x in case["args"]]
    mesh = make_coeff_mesh(shards, "cpu")
    sh = lambda t: shard_planes(t, mesh)
    if name.startswith("rot"):
        perm = ctx.automorphism_table_ntt(pow(5, 1, 2 * ctx.degree))
        fn = build_rotate_coeff(mesh, ctx, ext_ctx, perm, key.digit_size)
        got = fn(*map(sh, planes), sh(key.a), sh(key.b))
        unsharded = _rotate_arrays(*planes, key.a, key.b, perm, ctx, ext_ctx,
                                   key.digit_size)
    else:
        fn = build_mul_relin_rescale_coeff(mesh, ctx, ext_ctx, key.digit_size)
        got = fn(*map(sh, planes), sh(key.a), sh(key.b))
        unsharded = _mul_relin_rescale_arrays(
            *planes, key.a, key.b, ctx, ext_ctx, ctx.drop_last(1),
            digit_size=key.digit_size)
    return [unshard_planes(g) for g in got], unsharded


@pytest.mark.parametrize("name", list(COMPOSITES))
def test_composite_matches_reference(composites, name):
    case = composites(name)
    for g, w in zip(case["got"], case["want"]):
        _eq(g, w)


@pytest.mark.parametrize("name", list(COMPOSITES))
def test_composite_matches_unsharded_port(composites, name):
    case = composites(name)
    for g, w in zip(case["got"], case["unsharded"]):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_multiply_at_every_shard_count(composites, shards):
    got, unsharded = _port_composite("mul-ds2", composites("mul-ds2"), shards)
    for g, w in zip(got, unsharded):
        assert torch.equal(g, w)


def test_keys_carried_over_and_sharded(composites):
    """convert.py then shard_planes: slab p of the port's key is the
    reference's key words [p*S, (p+1)*S), and unsharding gives it back."""
    case = composites("mul-ds2")
    mesh = make_coeff_mesh(8, "cpu")
    a, _ = case["ref_key"]
    slabs = shard_planes(case["key"].a, mesh)
    s = a.shape[-1] // 8
    for p, t in enumerate(slabs):
        assert t.is_contiguous() and t.shape == a.shape[:-2] + (s,)
        _eq(t, a[..., p * s : (p + 1) * s])
    assert torch.equal(unshard_planes(slabs), case["key"].a)


# ── mesh and wrapper contracts ───────────────────────────────────────────


def test_make_coeff_mesh_needs_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_coeff_mesh(4)


def test_make_coeff_mesh_checks_its_shards():
    mesh = make_coeff_mesh(4, "cpu")
    assert mesh == CoeffMesh((CPU,) * 4) and mesh.shards == 4
    assert make_coeff_mesh(2, ["cpu", "cpu"]).devices == (CPU, CPU)
    with pytest.raises(ValueError, match="power-of-two"):
        make_coeff_mesh(3, "cpu")
    with pytest.raises(ValueError, match="devices for"):
        make_coeff_mesh(4, ["cpu", "cpu"])
    x = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="slabs on a mesh"):
        mesh.check(shard_planes(x, make_coeff_mesh(2, "cpu")))
    with pytest.raises(ValueError, match="does not split"):
        shard_planes(torch.zeros((2, 6), dtype=torch.int32), mesh)


def test_wrappers_check_their_slabs():
    moduli, x = _ntt_input(64, 2)
    slabs = shard_planes(convert.from_reference(x, CPU), make_coeff_mesh(4, "cpu"))
    with pytest.raises(TypeError):
        coeff_ntt_gpu.coeff_tail(tuple(t.float() for t in slabs), moduli, 64, False)
    with pytest.raises(ValueError, match="contiguous"):
        coeff_ntt_gpu.coeff_tail(tuple(t.transpose(0, 1) for t in slabs),
                                 moduli, 64, False)
    with pytest.raises(ValueError, match="slab shape"):
        coeff_ntt_gpu.coeff_tail(slabs, moduli[:1], 64, False)
    with pytest.raises(ValueError, match="differ"):
        coeff_ntt_gpu.coeff_tail(slabs[:3] + (slabs[3][:1],), moduli, 64, False)
    with pytest.raises(ValueError, match="powers of two"):
        coeff_ntt_gpu.coeff_tail(slabs[:3], moduli, 64, False)
    with pytest.raises(ValueError, match="cross stage"):
        coeff_ntt_gpu.coeff_cross(slabs, moduli, 64, 2, False)
    with pytest.raises(ValueError, match="q < 2"):
        coeff_ntt_gpu.coeff_tail(slabs, (moduli[0], (1 << 61) - 1), 64, False)
    with pytest.raises(TypeError):
        build_coeff_sharded_ntt_wide(make_coeff_mesh(4, "cpu"), moduli, 64,
                                     False)(slabs)


def test_cpu_slabs_launch_no_kernel():
    moduli, x = _ntt_input(256, 2)
    slabs = shard_planes(convert.from_reference(x, CPU), make_coeff_mesh(4, "cpu"))
    before = (coeff_ntt_gpu.coeff_tail.launches, coeff_ntt_gpu.coeff_cross.launches)
    back = coeff_ntt(coeff_ntt(slabs, moduli, 256, False), moduli, 256, True)
    assert all(torch.equal(g, w) for g, w in zip(back, slabs))
    assert (coeff_ntt_gpu.coeff_tail.launches,
            coeff_ntt_gpu.coeff_cross.launches) == before
