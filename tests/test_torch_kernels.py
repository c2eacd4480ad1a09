"""PyTorch port, kernel twins: K1/K4 (NTT), K2 (key switch), K3 (mod-down).

Each kernel's plain torch twin — what a CPU tensor runs — is held to the
Pallas kernel it replaces, run as the reference tests run it on the CPU
(interpret mode), at N = 1024 (K4, the factored NTT: N = 4096) on the
same numpy-seeded inputs, with uint32 equality. The host constant tables are held to the reference's. The CUDA
kernels themselves are compared with these twins on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from toy_heaan_ckks_tpu.math.primes import generate_primes
from toy_heaan_ckks_tpu.ops import keyswitch_pallas as ref_ks
from toy_heaan_ckks_tpu.ops import moddown_pallas as ref_md
from toy_heaan_ckks_tpu.ops import small_fast as ref_sf
from toy_heaan_ckks_tpu.ops import ntt_pallas as ref_npal
from toy_heaan_ckks_tpu.ops.ntt_pallas import ntt_pallas

from toy_heaan_ckks_tpu_torch import CkksContext
from toy_heaan_ckks_tpu_torch import convert
from toy_heaan_ckks_tpu_torch.keys import default_special_primes, sp_inv_ints
from toy_heaan_ckks_tpu_torch.ops import keyswitch_gpu, moddown_gpu, ntt_gpu
from toy_heaan_ckks_tpu_torch.ops import small_fast as sf

DEGREE = 1024
BATCH = 2


def _planes(seed, moduli, lead=(BATCH,)):
    """int32 (..., L, N) residues, each channel below its modulus."""
    rng = np.random.default_rng(seed)
    arr = np.stack(
        [rng.integers(0, q, size=lead + (DEGREE,), dtype=np.int64) for q in moduli],
        axis=-2,
    )
    return torch.from_numpy(arr.astype(np.int32))


def _j(t: torch.Tensor):
    """Port int32 planes -> the reference's uint32 lo planes."""
    return jnp.asarray(t.numpy().view(np.uint32))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def _chain(count: int, digit_size: int):
    base = tuple(generate_primes(31, count, DEGREE))
    ctx = CkksContext.build(base, DEGREE, device="cpu")
    return base, base + default_special_primes(ctx, digit_size)


# ── K1: ntt_pallas._ntt_kernel ───────────────────────────────────────────


@pytest.mark.parametrize("inverse", [False, True])
def test_k1_twin_matches_pallas_ntt(inverse):
    moduli, _ = _chain(3, 1)
    x = _planes(1, moduli)
    want = ntt_pallas(convert.to_reference(x), moduli, DEGREE, inverse,
                      interpret=True)[..., 0, :]
    _eq(ntt_gpu.ntt_planes(x, moduli, DEGREE, inverse), want)


@pytest.mark.parametrize("bits", [30, 31])
def test_k4_twin_matches_pallas_factored_ntt(bits):
    """K4 (``_ntt_factored_call``, row x lane twiddles, lazy below 2^30;
    the TPU runs it at N = 2^16) in interpret mode at N = 4096, forward;
    the twin's inverse returns the input."""
    degree = 4096
    moduli = tuple(generate_primes(bits, 2, degree))
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(np.stack([rng.integers(0, q, size=degree, dtype=np.int64)
                                   for q in moduli]).astype(np.int32))
    frw, frwp, flw, flwp, _, _, _, _, q, ninv, ninvp = (
        ref_npal._planes_factored_cached(moduli, degree))
    want = ref_npal._ntt_factored_call(
        _j(x), frw, frwp, flw, flwp, q, ninv, ninvp, degree=degree,
        inverse=False, interpret=True, lazy=ref_npal.lazy_ok(moduli))
    fwd = ntt_gpu.ntt_planes(x, moduli, degree, False)
    _eq(fwd, want)
    assert torch.equal(ntt_gpu.ntt_planes(fwd, moduli, degree, True), x)


def test_k1_twin_matches_pallas_inv_ntt_fold():
    moduli, _ = _chain(4, 2)
    post = tuple((q - 1) // 3 for q in moduli)
    x = _planes(2, moduli)
    want = ref_sf.inv_ntt_fold(_j(x), moduli, DEGREE, post, interpret=True)
    _eq(sf.inv_ntt_fold(x, moduli, DEGREE, post), want)


def test_k1_twin_matches_pallas_inv_ntt_to_yhat():
    base, ext = _chain(4, 2)
    dropped, child = ext[3:], base[:3]
    x = _planes(3, dropped)
    want = ref_md.inv_ntt_to_yhat(_j(x), dropped, child, DEGREE, interpret=True)
    _eq(moddown_gpu.inv_ntt_to_yhat(x, dropped, child, DEGREE), want)


@pytest.mark.parametrize("count", [1, 4, 7])
def test_fold_consts_match(count):
    moduli, _ = _chain(count, 1)
    post = tuple(range(3, 3 + count))
    w, _ = ref_sf._fold_consts(moduli, DEGREE, post)
    assert sf._fold_consts(moduli, DEGREE, post) == tuple(int(v) for v in w[:, 0])


# ── K2: keyswitch_pallas._ks_kernel / _ks_kernel_base ────────────────────


@pytest.mark.parametrize("digit_size,count", [(1, 2), (2, 3), (3, 4)])
def test_k2_twin_matches_pallas(digit_size, count):
    """ds 2 over 3 primes and ds 3 over 4 primes have a short last group."""
    base, ext = _chain(count, digit_size)
    digits = -(-count // digit_size)
    y, d = _planes(10, base), _planes(11, base)
    key_a, key_b = _planes(12, ext, (digits,)), _planes(13, ext, (digits,))
    kw = dict(base_moduli=base, ext_moduli=ext, degree=DEGREE,
              digit_size=digit_size)
    want0, want1 = ref_ks.gadget_accumulate_pallas(
        _j(y), jnp.asarray(convert.to_reference(key_a)),
        jnp.asarray(convert.to_reference(key_b)),
        interpret=True, stack_limbs=False, d_ntt=_j(d), **kw,
    )
    got0, got1 = keyswitch_gpu.gadget_accumulate(y, key_a, key_b, d_ntt=d, **kw)
    _eq(got0, want0)
    _eq(got1, want1)


@pytest.mark.parametrize("digit_size,count", [(1, 2), (2, 3), (3, 4), (4, 8), (8, 4)])
def test_switch_consts_match(digit_size, count):
    base, ext = _chain(count, min(digit_size, count))
    got = keyswitch_gpu._switch_consts(base, ext, digit_size)
    want = ref_ks._switch_consts(base, ext, digit_size)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], want[2][:, 0])
    np.testing.assert_array_equal(got[3], want[3][:, 0])
    assert got[4] == want[4]


def test_k2_rejects_mismatched_key():
    base, ext = _chain(4, 2)
    key = _planes(0, ext, (3,))
    with pytest.raises(ValueError):
        keyswitch_gpu.gadget_accumulate(
            _planes(1, base), key, key, base_moduli=base, ext_moduli=ext,
            degree=DEGREE, digit_size=2,
        )


# ── K3: moddown_pallas._md_kernel_t ──────────────────────────────────────


def test_k3_twin_matches_pallas():
    """The fused relin+rescale form: t scaled by the special product, ks
    and t read as channel slices of larger stacks."""
    base, ext = _chain(4, 2)
    L = len(base)
    child, dropped = base[: L - 1], ext[L - 1 :]
    p_specials = int(np.prod([int(p) for p in ext[L:]], dtype=object))
    yhat = _planes(20, dropped)
    ks_full, t_full = _planes(21, ext), _planes(22, base)
    ks, t = ks_full[..., : L - 1, :], t_full[..., : L - 1, :]
    want = ref_md.mod_down_combine_pallas(
        _j(yhat), _j(ks.contiguous()), _j(t.contiguous()),
        child_moduli=child, dropped_moduli=dropped, degree=DEGREE,
        interpret=True, t_scale=p_specials,
    )
    got = moddown_gpu.mod_down_combine(
        yhat, ks, t, child_moduli=child, dropped_moduli=dropped,
        degree=DEGREE, t_scale=p_specials,
    )
    _eq(got, want)


@pytest.mark.parametrize("t_scale", [0, 12345, (1 << 61) + 7])
def test_down_consts_match(t_scale):
    base, ext = _chain(5, 2)
    child, dropped = base[:4], ext[4:]
    got = moddown_gpu._down_consts(child, dropped, DEGREE, t_scale)
    want = ref_md._down_consts(child, dropped, DEGREE, t_scale)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[2:6], want[2:6]):
        np.testing.assert_array_equal(g, w[:, 0])
    assert got[6] == tuple(int(v) for v in want[6][:, 0])


def test_sp_inv_ints_match_reference():
    from toy_heaan_ckks_tpu.keys import sp_inv_ints as ref_sp_inv_ints

    _, ext = _chain(4, 3)
    assert sp_inv_ints(ext[4:]) == ref_sp_inv_ints(ext[4:])


# ── dispatch: CPU -> twin, never a launch; other devices -> raise ────────


def test_cpu_tensors_never_launch():
    base, ext = _chain(2, 1)
    before = (ntt_gpu.ntt_planes.launches,
              keyswitch_gpu.gadget_accumulate.launches,
              moddown_gpu.mod_down_combine.launches)
    x = _planes(30, base)
    ntt_gpu.ntt_planes(x, base, DEGREE, False)
    keyswitch_gpu.gadget_accumulate(
        x, _planes(31, ext, (2,)), _planes(32, ext, (2,)), base_moduli=base,
        ext_moduli=ext, degree=DEGREE, digit_size=1, d_ntt=x,
    )
    moddown_gpu.mod_down_combine(
        _planes(33, ext[1:]), x[..., :1, :], None, child_moduli=base[:1],
        dropped_moduli=ext[1:], degree=DEGREE,
    )
    assert (ntt_gpu.ntt_planes.launches,
            keyswitch_gpu.gadget_accumulate.launches,
            moddown_gpu.mod_down_combine.launches) == before


@pytest.mark.parametrize("kernel", ["ntt", "keyswitch", "moddown"])
def test_non_cpu_non_cuda_tensor_raises(kernel):
    """A tensor that is not on the CPU never reaches a twin."""
    base, ext = _chain(2, 1)
    x = torch.empty((1, 2, DEGREE), dtype=torch.int32, device="meta")
    key = torch.empty((2, 3, DEGREE), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected CUDA"):
        if kernel == "ntt":
            ntt_gpu.ntt_planes(x, base, DEGREE, True)
        elif kernel == "keyswitch":
            keyswitch_gpu.gadget_accumulate(
                x, key, key, base_moduli=base, ext_moduli=ext, degree=DEGREE,
                digit_size=1,
            )
        else:
            moddown_gpu.mod_down_combine(
                torch.empty((1, 2, DEGREE), dtype=torch.int32, device="meta"),
                x[..., :1, :], None, child_moduli=base[:1],
                dropped_moduli=ext[1:], degree=DEGREE,
            )


def test_dropped_specials_fold_matches_sp_inv():
    """inv_ntt_to_yhat over the specials alone equals mont_mul(iNTT, sp_inv)
    — the identity the mod-down relies on (port-internal, twins only)."""
    base, ext = _chain(3, 2)
    specials = ext[3:]
    x = _planes(40, specials)
    tables_q = torch.tensor(specials, dtype=torch.int64)[:, None]
    rinv = torch.tensor([pow(1 << 32, -1, p) for p in specials])[:, None]
    plain = ntt_gpu.ntt_planes(x, specials, DEGREE, True)
    sp = torch.tensor(sp_inv_ints(specials), dtype=torch.int32)[:, None]
    from toy_heaan_ckks_tpu_torch.ops.modular import mont_mul

    want = mont_mul(plain, sp, tables_q, rinv)
    got = moddown_gpu.inv_ntt_to_yhat(x, specials, base, DEGREE)
    assert torch.equal(got, want)
