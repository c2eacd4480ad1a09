"""PyTorch port, the batch x channel mesh and the KeyLadder, held to the JAX
reference on the 8-virtual-device CPU mesh of ``tests/conftest.py``.

The same numpy-seeded ciphertexts and keys (the reference's keygen, carried
over with ``convert.py``) go through the reference's sharded builders
(``parallel/sharded.py`` ``build_mul_relin_rescale``, ``build_rotate``, the
multihost ``jit``) and through the port's (``parallel/mesh.py``,
``collectives.py``, ``sharded.py``) on a mesh whose grid points are all the
CPU, where K1 / K2 / K3 run as their twins. Every output must be
word-equal to the reference's sharded output and to the port's unsharded
call, laid out as the reference's ``out_shardings`` (its spec without the
limb axis). Sizes and seeds are those of ``tests/test_sharding.py`` and
``tests/test_sharding_edge.py`` (N = 64), the wide case those of
``tests/test_torch_wide.py`` (N = 256, 3 x 61-bit). Each reference setup and
output is computed once per module. The KeyLadder tests are
``tests/test_keys.py``'s at its size (N = 16, 3 x 31-bit, seed 55).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import toy_heaan_ckks_tpu as ref
from toy_heaan_ckks_tpu.keys import KeyLadder as RefKeyLadder
from toy_heaan_ckks_tpu.math.sampling import make_rng as ref_make_rng
from toy_heaan_ckks_tpu.ops.poly import Poly as RefPoly
from toy_heaan_ckks_tpu.parallel import mesh as ref_mesh
from toy_heaan_ckks_tpu.parallel import sharded as ref_sharded

import toy_heaan_ckks_tpu_torch as port
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch.math.sampling import make_rng
from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu, moddown_gpu, small_fast
from toy_heaan_ckks_tpu_torch.ops import modular as mm
from toy_heaan_ckks_tpu_torch.parallel import mesh
from toy_heaan_ckks_tpu_torch.parallel.sharded import (
    _mul_relin_rescale_arrays, _rotate_arrays, build_mul_relin_rescale,
    build_rotate,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

CPU = torch.device("cpu")
CPU8 = ("cpu",) * 8


def _axes(named_sharding, ndim: int = 4) -> tuple:
    """A reference spec of an ``ndim``-axis (..., 2, N) array without its
    limb axis."""
    spec = tuple(named_sharding.spec)
    spec += (None,) * (ndim - len(spec))
    return tuple(tuple(a) if isinstance(a, list) else a
                 for a in spec[:-2] + spec[-1:])


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(convert.to_reference(got),
                                  np.asarray(want, dtype=np.uint32))


@functools.lru_cache(maxsize=None)
def _setup(L: int, digit_size: int, batch: int, seed: int, bits: int = 30,
           degree: int = 64, rotation: bool = False):
    """The reference tests' setup (seed 123: ``test_sharding.py``, 321:
    ``test_sharding_edge.py``), with the port's copies on the CPU."""
    primes = ref.generate_primes(bits, L, degree)
    rctx = ref.CkksContext.build(primes, degree)
    eng = ref.CkksEngine(rctx, ref.CkksParams(3.2, degree // 2, 30))
    rng = ref_make_rng(seed)
    sk = eng.generate_secret_key(rng)
    key = (eng.generate_gadget_rotation_key(sk, 1, rng) if rotation else
           eng.generate_gadget_relin_key(sk, rng, digit_size=digit_size))

    def rand_batch(s):
        r = ref_make_rng(s)
        return jnp.stack([RefPoly.sample_uniform(rctx, r).to_ntt_domain().data
                          for _ in range(batch)])

    planes = tuple(rand_batch(s) for s in (1, 2, 3, 4))
    wide = bits > 31
    ctx = port.CkksContext.build(primes, degree, CPU)
    fields = (np.asarray(key.a), np.asarray(key.b))
    args = (tuple(primes), key.ext_ctx.moduli, key.digit_size, degree, CPU)
    pkey = (convert.rotation_key_from_reference(*fields, key.rotation, *args)
            if rotation else convert.relin_key_from_reference(*fields, *args))
    pplanes = tuple(convert.from_reference(np.asarray(p), CPU, wide) for p in planes)
    return rctx, key, planes, ctx, pkey, pplanes


# ── meshes and specs ─────────────────────────────────────────────────────


def test_mesh_shapes():
    m = mesh.make_ckks_mesh(8, batch=2, devices=CPU8)
    assert m.devices.shape == (2, 4) == ref_mesh.make_ckks_mesh(8, batch=2).devices.shape
    assert m.shape == {"batch": 2, "channel": 4}
    assert mesh.make_ckks_mesh(8, batch=1, devices=CPU8).devices.shape == (1, 8)
    assert mesh.make_ckks_mesh(8, batch=4, devices="cpu").points == (CPU,) * 8
    with pytest.raises(ValueError):
        mesh.make_ckks_mesh(8, batch=3, devices=CPU8)
    with pytest.raises(ValueError):
        ref_mesh.make_ckks_mesh(8, batch=3)


def test_multihost_mesh_shapes():
    m = mesh.make_multihost_mesh(hosts=2, chips_per_host=4, batch_per_host=1,
                                 devices=CPU8)
    rm = ref_mesh.make_multihost_mesh(hosts=2, chips_per_host=4, batch_per_host=1)
    assert m.devices.shape == rm.devices.shape == (2, 1, 4)
    assert m.axis_names == tuple(rm.axis_names)
    for kw in (dict(hosts=3, chips_per_host=4), dict(hosts=2, chips_per_host=4,
                                                     batch_per_host=3)):
        with pytest.raises(ValueError):
            mesh.make_multihost_mesh(devices=CPU8, **kw)
        with pytest.raises(ValueError):
            ref_mesh.make_multihost_mesh(**kw)
    # without a process group the port drives one host
    assert mesh.make_multihost_mesh(devices=CPU8).shape == {
        "host": 1, "batch": 1, "channel": 8}


def test_mesh_device_rules(monkeypatch):
    with pytest.raises(ValueError, match="one kind"):
        mesh.make_ckks_mesh(2, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="need 8 devices"):
        mesh.make_ckks_mesh(8, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_ckks_mesh(8, batch=2)


@pytest.mark.parametrize("batch_axis", [1, 2, 4])
@pytest.mark.parametrize("count", [3, 4, 5, 6, 8])
def test_specs_match_the_reference(batch_axis, count):
    m = mesh.make_ckks_mesh(8, batch=batch_axis, devices=CPU8)
    rm = ref_mesh.make_ckks_mesh(8, batch=batch_axis)
    for port_fn, ref_fn in ((mesh.ct_spec_for, ref_mesh.ct_spec_for),
                            (mesh.key_spec_for, ref_mesh.key_spec_for)):
        assert port_fn(m, count).axes == _axes(ref_fn(rm, count))
    assert mesh.ct_spec(m).axes == _axes(ref_mesh.ct_spec(rm))
    assert mesh.key_spec(m).axes == _axes(ref_mesh.key_spec(rm))
    assert mesh.ct_spec(m, batched=False).axes == _axes(ref_mesh.ct_spec(rm, False), 3)
    assert mesh.replicated(m).axes == (None,) * 3
    assert mesh.ct_spec_for(m, count) == mesh.ct_spec_for(m, count)
    mh = mesh.make_multihost_mesh(2, 4, devices=CPU8)
    rmh = ref_mesh.make_multihost_mesh(2, 4)
    assert mesh.ct_spec_mh(mh).axes == _axes(ref_mesh.ct_spec_mh(rmh))
    assert mesh.key_spec_mh(mh).axes == _axes(ref_mesh.key_spec_mh(rmh))


def test_shard_round_trip_and_divisibility():
    m = mesh.make_ckks_mesh(8, batch=2, devices=CPU8)
    x = torch.arange(4 * 8 * 16, dtype=torch.int32).reshape(4, 8, 16)
    for spec in (mesh.ct_spec(m), mesh.ct_spec_for(m, 7), mesh.replicated(m)):
        s = mesh.shard(x, spec)
        assert len(s.blocks) == 8 and torch.equal(mesh.unshard(s), x)
    s = mesh.shard(x, mesh.ct_spec(m))
    assert s.blocks[5].shape == (2, 2, 16)  # point (1, 1): items 2..3, channels 2..3
    assert torch.equal(s.blocks[5], x[2:4, 2:4])
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard(x[:, :7], mesh.ct_spec(m))
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard(x[:3], mesh.ct_spec(m))


# ── the sharded multiply ─────────────────────────────────────────────────

# (L, digit_size, batch axis, seed): test_sharding.py's case, then the five
# awkward ratios of test_sharding_edge.py
MUL_CASES = [(4, 1, 2, 123), (4, 2, 2, 321), (4, 4, 2, 321), (5, 1, 2, 321),
             (3, 2, 2, 321), (6, 4, 1, 321)]


@functools.lru_cache(maxsize=None)
def _ref_mul(L, digit_size, batch_axis, seed, bits=30, degree=64):
    """The reference's sharded multiply on its 8-device mesh."""
    rctx, rlk, planes, *_ = _setup(L, digit_size, 2, seed, bits, degree)
    rm = ref_mesh.make_ckks_mesh(8, batch=batch_axis)
    fn = ref_sharded.build_mul_relin_rescale(rm, rctx, rlk.ext_ctx,
                                             digit_size=rlk.digit_size)
    put = lambda x: jax.device_put(x, ref_mesh.ct_spec_for(rm, L))
    kput = lambda x: jax.device_put(x, ref_mesh.key_spec_for(rm, rlk.a.shape[0]))
    out0, out1 = fn(*map(put, planes), kput(rlk.a), kput(rlk.b))
    return np.asarray(out0), np.asarray(out1), _axes(out0.sharding)


def _port_mul(L, digit_size, batch_axis, seed, bits=30, degree=64):
    *_, ctx, rlk, planes = _setup(L, digit_size, 2, seed, bits, degree)
    m = mesh.make_ckks_mesh(8, batch=batch_axis, devices=CPU8)
    fn = build_mul_relin_rescale(m, ctx, rlk.ext_ctx, rlk.digit_size)
    put = lambda x: mesh.shard(x, mesh.ct_spec_for(m, L))
    kput = lambda x: mesh.shard(x, mesh.key_spec_for(m, rlk.a.shape[0]))
    outs = fn(*map(put, planes), kput(rlk.a), kput(rlk.b))
    return m, ctx, rlk, planes, outs


@pytest.mark.parametrize("L,digit_size,batch_axis,seed", MUL_CASES)
def test_sharded_mul_matches_reference(L, digit_size, batch_axis, seed):
    m, ctx, rlk, planes, outs = _port_mul(L, digit_size, batch_axis, seed)
    want0, want1, ref_axes = _ref_mul(L, digit_size, batch_axis, seed)
    spec = mesh.ct_spec_for(m, L - 1)
    assert all(o.spec == spec for o in outs) and spec.axes == ref_axes
    unsharded = _mul_relin_rescale_arrays(*planes, rlk.a, rlk.b, ctx, rlk.ext_ctx,
                                          ctx.drop_last(1), rlk.digit_size)
    for got, want, single in zip(outs, (want0, want1), unsharded):
        whole = mesh.unshard(got)
        _eq(whole, want)
        assert torch.equal(whole, single)


def test_sharded_mul_wide_matches_reference():
    """3 x 61-bit primes, ds 1, on make_ckks_mesh(8, batch=2): the three
    channels dealt over the 4-wide axis, the key replicated. The reference
    side is its unsharded composite, run eagerly: XLA takes ~590 s on the
    CPU to compile its sharded wide program, and GSPMD runs the same
    integer program, so the words are the same (``test_sharding.py``'s
    gate); the output spec is ``ct_spec_for``'s, as on the small cases."""
    case = (3, 1, 2, 321, 61, 256)
    m, ctx, rlk, planes, outs = _port_mul(*case)
    assert planes[0].dtype == torch.int64
    rctx, rrlk, rplanes, *_ = _setup(*case[:4], *case[4:])
    want = ref_sharded._mul_relin_rescale_arrays(
        *rplanes, rrlk.a, rrlk.b, rctx, rrlk.ext_ctx, rctx.drop_last(1), digit_size=1)
    rm = ref_mesh.make_ckks_mesh(8, batch=2)
    assert outs[0].spec == mesh.ct_spec_for(m, 2)
    assert outs[0].spec.axes == _axes(ref_mesh.ct_spec_for(rm, 2))
    unsharded = _mul_relin_rescale_arrays(*planes, rlk.a, rlk.b, ctx, rlk.ext_ctx,
                                          ctx.drop_last(1), rlk.digit_size)
    for got, w, single in zip(outs, want, unsharded):
        _eq(mesh.unshard(got), w)
        assert torch.equal(mesh.unshard(got), single)


def test_sharded_mul_multihost_matches_reference():
    """(host, batch, channel) = (2, 1, 4) with ct_spec_mh / key_spec_mh,
    a batch of 4 (test_sharding_edge.py's multihost case)."""
    rctx, rlk, planes, ctx, prlk, pplanes = _setup(4, 1, 4, 321)
    rm = ref_mesh.make_multihost_mesh(hosts=2, chips_per_host=4, batch_per_host=1)
    data_s, key_s = ref_mesh.ct_spec_mh(rm), ref_mesh.key_spec_mh(rm)
    fn = jax.jit(functools.partial(
        ref_sharded._mul_relin_rescale_arrays, ctx=rctx, ext_ctx=rlk.ext_ctx,
        child_ctx=rctx.drop_last(1), digit_size=1),
        in_shardings=(data_s,) * 4 + (key_s, key_s))
    want = fn(*(jax.device_put(p, data_s) for p in planes),
              jax.device_put(rlk.a, key_s), jax.device_put(rlk.b, key_s))

    m = mesh.make_multihost_mesh(hosts=2, chips_per_host=4, batch_per_host=1,
                                 devices=CPU8)
    pfn = build_mul_relin_rescale(m, ctx, prlk.ext_ctx, prlk.digit_size)
    outs = pfn(*(mesh.shard(p, mesh.ct_spec_mh(m)) for p in pplanes),
               mesh.shard(prlk.a, mesh.key_spec_mh(m)),
               mesh.shard(prlk.b, mesh.key_spec_mh(m)))
    assert outs[0].spec.axes == (("host", "batch"), None, None)
    for got, w in zip(outs, want):
        _eq(mesh.unshard(got), w)


def test_sharded_mul_splits_the_work(monkeypatch):
    """Each point's kernels see its own channels and digits: on the 4-wide
    channel axis at L = 8, ds 2 (D = 4, keys digit-sharded), no fold, key
    switch or mod-down call receives the whole tensor, and the digit
    ranges dealt cover the digits once per batch point."""
    L, B = 8, 4
    primes = port.generate_primes(30, L, 64)
    ctx = port.CkksContext.build(primes, 64, CPU)
    eng = port.CkksEngine(ctx, port.CkksParams(3.2, 32, 30))
    rng = make_rng(9)
    rlk = eng.generate_gadget_relin_key(eng.generate_secret_key(rng), rng, digit_size=2)
    gen = np.random.default_rng(3)
    planes = [torch.from_numpy(np.stack([gen.integers(0, q, (B, 64)) for q in primes],
                                        axis=-2)).int() for _ in range(4)]
    want = _mul_relin_rescale_arrays(*planes, rlk.a, rlk.b, ctx, rlk.ext_ctx,
                                     ctx.drop_last(1), rlk.digit_size)
    calls = {"fold": [], "accumulate": [], "yhat": [], "mod_down": []}

    def spy(name, fn, record):
        @functools.wraps(fn)  # the wrapper's counters stay readable
        def wrapped(*args, **kw):
            calls[name].append(record(*args, **kw))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(small_fast, "inv_ntt_fold", spy(
        "fold", small_fast.inv_ntt_fold, lambda x, *a, **k: x.shape[-2]))
    monkeypatch.setattr(keyswitch_gpu, "gadget_accumulate", spy(
        "accumulate", keyswitch_gpu.gadget_accumulate,
        lambda y, ka, kb, **k: (k["digits"], ka.shape[0], k["d_ntt"] is not None)))
    monkeypatch.setattr(moddown_gpu, "inv_ntt_to_yhat", spy(
        "yhat", moddown_gpu.inv_ntt_to_yhat, lambda x, *a, **k: x.shape[-2]))
    monkeypatch.setattr(moddown_gpu, "mod_down_combine", spy(
        "mod_down", moddown_gpu.mod_down_combine,
        lambda yhat, ks, t, **k: (ks.shape[-2], len(k["child_moduli"]))))

    m = mesh.make_ckks_mesh(8, batch=2, devices=CPU8)
    fn = build_mul_relin_rescale(m, ctx, rlk.ext_ctx, rlk.digit_size)
    outs = fn(*(mesh.shard(p, mesh.ct_spec_for(m, L)) for p in planes),
              mesh.shard(rlk.a, mesh.key_spec_for(m, 4)),
              mesh.shard(rlk.b, mesh.key_spec_for(m, 4)))
    for got, w in zip(outs, want):
        assert torch.equal(mesh.unshard(got), w)
    # the decomposition fold: each of the 8 points on its 2 channels
    assert calls["fold"] == [2] * 8
    # K2: each point one digit of its own, the skip-own input on digit 0
    assert sorted(calls["accumulate"]) == sorted(
        [((t, t + 1), 1, t == 0) for t in range(4)] * 2)
    # K3: each point's kept channels (2, 2, 2, 1), ks0 and ks1, never all 7
    assert sorted(calls["mod_down"]) == sorted([(2, 2)] * 12 + [(1, 1)] * 4)
    assert calls["yhat"] == [3] * 16  # q_last and the two specials


# ── the sharded rotation ─────────────────────────────────────────────────


def test_sharded_rotate_matches_reference():
    rctx, rotk, planes, ctx, prot, pplanes = _setup(4, 1, 2, 123, rotation=True)
    n = rctx.degree
    perm_ref = rctx.automorphism_table_ntt(pow(5, rotk.rotation % (n // 2), 2 * n))
    rm = ref_mesh.make_ckks_mesh(8, batch=2)
    fn = ref_sharded.build_rotate(rm, rctx, rotk.ext_ctx, perm_ref)
    put = lambda x: jax.device_put(x, ref_mesh.ct_spec(rm))
    kput = lambda x: jax.device_put(x, ref_mesh.key_spec(rm))
    want = fn(put(planes[0]), put(planes[1]), kput(rotk.a), kput(rotk.b))

    perm = ctx.automorphism_table_ntt(pow(5, prot.rotation % (n // 2), 2 * n))
    m = mesh.make_ckks_mesh(8, batch=2, devices=CPU8)
    pfn = build_rotate(m, ctx, prot.ext_ctx, perm, prot.digit_size)
    put = lambda x: mesh.shard(x, mesh.ct_spec(m))
    kput = lambda x: mesh.shard(x, mesh.key_spec(m))
    outs = pfn(put(pplanes[0]), put(pplanes[1]), kput(prot.a), kput(prot.b))
    single = _rotate_arrays(pplanes[0], pplanes[1], prot.a, prot.b, perm, ctx,
                            prot.ext_ctx, prot.digit_size)
    for got, w, s in zip(outs, want, single):
        assert got.spec == mesh.ct_spec(m) and _axes(w.sharding) == got.spec.axes
        _eq(mesh.unshard(got), w)
        assert torch.equal(mesh.unshard(got), s)


def test_sharded_rotate_needs_split_digits():
    """key_spec cannot split D = 2 digits over a 4-wide channel axis: the
    port raises ValueError where the reference's device_put fails, and the
    builder refuses a key laid out otherwise."""
    *_, rlk, pplanes = _setup(4, 2, 2, 321)
    m = mesh.make_ckks_mesh(8, batch=2, devices=CPU8)
    with pytest.raises(ValueError):
        mesh.shard(rlk.a, mesh.key_spec(m))
    ctx = port.CkksContext.build(rlk.ctx.moduli, 64, CPU)
    fn = build_rotate(m, ctx, rlk.ext_ctx, ctx.automorphism_table_ntt(5), 2)
    rep = mesh.key_spec_for(m, 2)
    with pytest.raises(ValueError, match="key_spec"):
        fn(*(mesh.shard(p, mesh.ct_spec(m)) for p in pplanes[:2]),
           mesh.shard(rlk.a, rep), mesh.shard(rlk.b, rep))


# ── KeyLadder ────────────────────────────────────────────────────────────


@functools.lru_cache(maxsize=None)
def _ladder_setup():
    primes = ref.generate_primes(31, 3, 16)
    rctx = ref.CkksContext.build(primes, 16)
    reng = ref.CkksEngine(rctx, ref.CkksParams(3.2, 8, 30))
    ctx = port.CkksContext.build(primes, 16, CPU)
    eng = port.CkksEngine(ctx, port.CkksParams(3.2, 8, 30))
    return rctx, reng, ctx, eng


def _ladder_words(keys, to_words) -> list:
    out = [to_words(keys.sk.poly.data), to_words(keys.pk.a.data),
           to_words(keys.pk.b.data), to_words(keys.rlk.a), to_words(keys.rlk.b)]
    for r in sorted(keys.rot):
        out += [to_words(keys.rot[r].a), to_words(keys.rot[r].b)]
    return out


def test_key_ladder_lazy_and_memory():
    """Lazy ladder generates a level only on first access and reports the
    bytes it holds (``tests/test_keys.py``'s test on the port)."""
    _, _, ctx, eng = _ladder_setup()
    rng = make_rng(55)
    sk = eng.generate_secret_key(rng)
    ladder = port.KeyLadder(ctx, sk, 3.2, rng, rotations=(1,), lazy=True)
    assert ladder.levels == {}
    assert ladder.memory_bytes() == 0
    top = ctx.num_channels
    keys = ladder.at_level(top)
    assert keys.ctx.num_channels == top
    assert set(ladder.levels) == {top}
    m1 = ladder.memory_bytes()
    # sk, pk a / b: 3 planes of (L, N); relin and rotation keys: 4 stacks
    # of (D, E, N) = (3, 4, 16); int32 words
    assert m1 == 4 * (3 * top * 16 + 4 * 3 * 4 * 16)
    ladder.at_level(top - 1)
    assert ladder.memory_bytes() > m1
    assert ladder.for_ctx(ctx.drop_last(1)) is ladder.levels[top - 1]
    with pytest.raises(KeyError):
        ladder.at_level(top + 1)


@pytest.mark.parametrize("lazy", [False, True])
def test_key_ladder_matches_reference(lazy):
    """From one seed, every level's sk / pk / relin / rotation keys equal
    the reference ladder's word for word (lazy: the levels visited in the
    same order on both)."""
    rctx, reng, ctx, eng = _ladder_setup()
    rrng, rng = ref_make_rng(55), make_rng(55)
    rladder = RefKeyLadder(rctx, reng.generate_secret_key(rrng), 3.2, rrng,
                           rotations=(1, 2), lazy=lazy)
    ladder = port.KeyLadder(ctx, eng.generate_secret_key(rng), 3.2, rng,
                            rotations=(1, 2), lazy=lazy)
    order = (2, 3, 1) if lazy else (3, 2, 1)
    for lvl in order:
        got = _ladder_words(ladder.at_level(lvl), convert.to_reference)
        want = _ladder_words(rladder.at_level(lvl), np.asarray)
        assert len(got) == len(want) == 9
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert set(ladder.levels) == set(rladder.levels) == {1, 2, 3}


def test_digit_range_contract():
    """K2's twin on digit ranges: the ranges' partial accumulators sum to the
    whole, the skip-own input only with a range from digit 0, a range
    outside the digits refused."""
    *_, ctx, rlk, planes = _setup(4, 1, 2, 123)
    L = ctx.num_channels
    y = small_fast.inv_ntt_fold(planes[0], ctx.moduli, 64,
                                small_fast._dec_inv_ints(ctx.moduli, 1))
    kw = dict(base_moduli=ctx.moduli, ext_moduli=rlk.ext_ctx.moduli, degree=64,
              digit_size=1)
    whole = keyswitch_gpu.gadget_accumulate(y, rlk.a, rlk.b, d_ntt=planes[0], **kw)
    parts = [keyswitch_gpu.gadget_accumulate(y, rlk.a[t0:t1], rlk.b[t0:t1],
                                             digits=(t0, t1), **kw)
             for t0, t1 in ((0, 1), (1, 3), (3, 4))]
    own = keyswitch_gpu.gadget_accumulate(y, rlk.a[:2], rlk.b[:2], digits=(0, 2),
                                          d_ntt=planes[0][:, :2], **kw)
    assert torch.equal(own[0], keyswitch_gpu.gadget_accumulate(
        y, rlk.a[:2], rlk.b[:2], digits=(0, 2), **kw)[0])
    q = rlk.ext_ctx.chain.q
    for i in range(2):
        acc = parts[0][i]
        for p in parts[1:]:
            acc = mm.add_mod(acc, p[i], q)
        assert torch.equal(acc, whole[i])
    with pytest.raises(ValueError, match="digit 0"):
        keyswitch_gpu.gadget_accumulate(y, rlk.a[1:2], rlk.b[1:2], digits=(1, 2),
                                        d_ntt=planes[0][:, :2], **kw)
    with pytest.raises(ValueError, match="outside"):
        keyswitch_gpu.gadget_accumulate(y, rlk.a, rlk.b, digits=(0, L + 1), **kw)
