"""Batched homomorphic step functions, unsharded and on the batch x channel mesh.

Counterpart of ``toy_heaan_ckks_tpu/parallel/sharded.py``:
``_mul_relin_rescale_arrays``, ``batched_mul_relin_rescale``, the body of
``build_rotate`` (``_rotate_arrays``, with ``batched_rotate`` as its
batched entry point), and the sharded builders ``build_mul_relin_rescale``
and ``build_rotate`` on a ``parallel/mesh.py`` mesh. The batch is a leading
axis that flows through every kernel.

The sharded builders split the work as the reference's GSPMD program
does: each (batch, channel) point runs the kernels on its own items and
its own channels, and the three collectives of ``parallel/collectives.py``
move only what the algebra needs. Per call, on each point: the tensor
product and the decomposition fold (K1 / K7, ``dec_inv`` folded, its
constants sliced from the whole chain's) on the point's channels; the
all-gather of the folded y along ``channel``; the gadget accumulation
(K2 / K6) of the point's digits alone (the wrappers' ``digits`` range),
digit-sharded keys where D splits over the axis, else the replicated
key's digits dealt over it; the sum of the partial (B, E, N)
accumulators mod q along ``channel``; then, for the multiply, the
broadcast of q_last's tensor terms from the point that holds it, the
yhat inverse (K1 / K7) of the dropped channels and the fused mod-down
(K3 / K8) of the point's kept channels, gathered along ``channel`` where
the output spec replicates them; for the rotation the specials' yhat and
the t-less mod-down (K3' / K8') of the point's channels. A channel axis
that the spec replicates is still split in the work: its channels are
dealt over the axis (the kept ones evenly, q_last to the last point).
The words equal the unsharded composite's.
"""

from __future__ import annotations

import math

import torch

from ..context import CkksContext
from ..ops import modular as mm
from . import collectives
from .mesh import Mesh, ShardSpec, Sharded, ct_spec, key_spec


def _mul_relin_rescale_arrays(c0a, c1a, c0b, c1b, key_a, key_b,
                              ctx: CkksContext, ext_ctx: CkksContext,
                              child_ctx: CkksContext, digit_size: int = 1):
    """One fused (batched) multiply + relinearize + rescale on raw planes.

    Input: (B, L, N) NTT-domain Montgomery residues; keys (D, E, N); all
    of the extended chain's dtype. Output: (B, L-1, N) over ``child_ctx``.
    The relinearization mod-down and the ciphertext rescale are one
    division by P * q_last. The chain's width picks the composite: small
    (every prime < 2^31, int32, R = 2^32) -> ``small_fast``, wide (int64,
    R = 2^64) -> ``wide_fast``.
    """
    from ..engine import _check_key_compat, _switch_plan
    from ..ops import small_fast as sf
    from ..ops import wide_fast as wf

    _check_key_compat(ctx, key_a, digit_size)
    if child_ctx.moduli != ctx.moduli[:-1]:
        raise ValueError("child_ctx must be ctx without its last prime")
    plan = _switch_plan(ctx.moduli, ext_ctx.moduli, digit_size)
    fused = (sf.mul_relin_rescale_lo if ext_ctx.chain.small
             else wf.mul_relin_rescale_wide)
    return fused(c0a, c1a, c0b, c1b, key_a, key_b, ctx, ext_ctx, plan)


def batched_mul_relin_rescale(ct_batch_a, ct_batch_b, rlk, ctx, child_ctx):
    """Unsharded batched step: ``ct_batch_*`` = (c0 stack, c1 stack)."""
    return _mul_relin_rescale_arrays(
        *ct_batch_a, *ct_batch_b, rlk.a, rlk.b, ctx, rlk.ext_ctx, child_ctx,
        digit_size=rlk.digit_size,
    )


def _rotate_arrays(c0, c1, key_a, key_b, perm, ctx: CkksContext,
                   ext_ctx: CkksContext, digit_size: int = 1):
    """One (batched) rotation on raw planes: the NTT-domain automorphism as a
    slot gather (``perm`` = ``ctx.automorphism_table_ntt(5^k mod 2N)``),
    the gadget key switch of the gathered c1, and c0' = sigma(c0) + ks0.
    Planes (B, L, N); keys (D, E, N). Returns (c0', c1'), (B, L, N)."""
    from ..engine import _gadget_key_switch
    from ..ops import modular as mm

    c0_rot = c0.index_select(-1, perm)
    c1_rot = c1.index_select(-1, perm)
    ks0, ks1 = _gadget_key_switch(c1_rot, key_a, key_b, ctx, ext_ctx, digit_size)
    return mm.add_mod(c0_rot, ks0, ctx.chain.q), ks1


def batched_rotate(ct_batch, rotk, ctx: CkksContext):
    """Unsharded batched rotation by ``rotk.rotation``: ``ct_batch`` =
    (c0 stack, c1 stack) of NTT-domain planes (B, L, N)."""
    half, two_n = ctx.degree // 2, 2 * ctx.degree
    perm = ctx.automorphism_table_ntt(pow(5, rotk.rotation % half, two_n))
    return _rotate_arrays(*ct_batch, rotk.a, rotk.b, perm, ctx, rotk.ext_ctx,
                          digit_size=rotk.digit_size)


# ── the batch x channel mesh ─────────────────────────────────────────────


def _kernels(small: bool) -> tuple:
    """The chain's kernel wrappers (fold, accumulate, to_yhat, mod_down),
    looked up at each call."""
    from ..ops import keyswitch_gpu as ksg
    from ..ops import moddown_gpu as mdg
    from ..ops import small_fast as sf

    if small:
        return (sf.inv_ntt_fold, ksg.gadget_accumulate, mdg.inv_ntt_to_yhat,
                mdg.mod_down_combine)
    return (mdg.inv_ntt_fold_wide, ksg.gadget_accumulate_wide,
            mdg.inv_ntt_to_yhat_wide, mdg.mod_down_combine_wide)


def _deal(count: int, parts: int) -> list:
    """``count`` items in ``parts`` contiguous ranges, the first
    ``count % parts`` one longer."""
    size, extra = divmod(count, parts)
    out, lo = [], 0
    for c in range(parts):
        out.append(range(lo, lo + size + (c < extra)))
        lo = out[-1].stop
    return out


def _owned(num: int, parts: int, split: bool, rescale: bool) -> list:
    """The channels each point along ``channel`` works on: its block where
    the spec splits the channels, else a deal (for a rescale the kept
    channels evenly and q_last to the last point)."""
    if split:
        return [range(c * num // parts, (c + 1) * num // parts) for c in range(parts)]
    if not rescale:
        return _deal(num, parts)
    own = _deal(num - 1, parts)
    own[-1] = range(own[-1].start, num)
    return own


def _plane_spec(values, mesh: Mesh, channels: int) -> ShardSpec:
    """The one spec of ``values``: (batch axes, ``channel`` or None, None)
    on ``mesh``, the batch never on ``channel``, ``channels`` channels."""
    spec = values[0].spec
    for v in values:
        if not isinstance(v, Sharded) or v.spec != spec:
            raise ValueError("the planes must be sharded values of one spec")
        if len(v.shape) != 3 or v.shape[1] != channels or v.shape != values[0].shape:
            raise ValueError(f"planes (B, {channels}, N) expected, got {v.shape}")
    if spec.mesh != mesh:
        raise ValueError("the planes lie on another mesh")
    if "channel" in spec.names(0) or spec.axes[1] not in ("channel", None) \
            or spec.axes[2] is not None:
        raise ValueError(f"unsupported plane layout {spec.axes}")
    return spec


def _key_split(key_a, key_b, mesh: Mesh) -> bool:
    """Whether the keys' digits split over ``channel`` (else replicated)."""
    spec = key_a.spec
    if key_b.spec != spec or spec.mesh != mesh or key_a.shape != key_b.shape:
        raise ValueError("the keys must be sharded values of one spec and shape")
    if spec.axes not in (("channel", None, None), (None, None, None)):
        raise ValueError(f"unsupported key layout {spec.axes}")
    return spec.axes[0] == "channel"


def _chain(ctx: CkksContext, dev):
    return CkksContext.build(ctx.moduli, ctx.degree, dev).chain


def _empty(like: torch.Tensor, channels: int = 0) -> torch.Tensor:
    return like.new_empty(like.shape[:-2] + (channels, like.shape[-1]))


def _key_switch_sums(mesh: Mesh, y, d, key_a, key_b, key_split: bool,
                     digits: list, ctx: CkksContext, ext_ctx: CkksContext,
                     digit_size: int, accumulate) -> tuple:
    """All-gather the folded y along ``channel``, accumulate each point's
    digits (``digits`` per channel index; ``d[p]``: the skip-own planes
    of the channels [0, k1) where the point holds them, else None), and
    sum the partial accumulators mod q along ``channel``: (ks0, ks1), one
    (B, E, N) per point."""
    y_all = collectives.all_gather(mesh, y)
    part0, part1 = [None] * mesh.size, [None] * mesh.size
    for p in range(mesh.size):
        dr = digits[mesh.coords(p)["channel"]]
        if not dr:
            continue
        ka, kb = key_a.blocks[p], key_b.blocks[p]
        if not key_split:
            ka, kb = ka[dr.start : dr.stop], kb[dr.start : dr.stop]
        part0[p], part1[p] = accumulate(
            y_all[p], ka, kb, base_moduli=ctx.moduli, ext_moduli=ext_ctx.moduli,
            degree=ctx.degree, digit_size=digit_size, d_ntt=d[p],
            digits=(dr.start, dr.stop))
    q = ext_ctx.chain.q
    return (collectives.sum_mod(mesh, part0, q),
            collectives.sum_mod(mesh, part1, q))


def _skip_own(t2, own: range, digits: range, num: int, digit_size: int):
    """t2's planes of the channels [0, k1) of a digit range from digit 0,
    where the point's own channels hold them; else None."""
    from ..ops.keyswitch_gpu import digit_channels

    if not digits or digits.start:
        return None
    k1 = digit_channels(num, digit_size, (digits.start, digits.stop))[1]
    return t2[..., :k1, :] if own.start == 0 and own.stop >= k1 else None


def build_mul_relin_rescale(mesh: Mesh, ctx: CkksContext, ext_ctx: CkksContext,
                            digit_size: int = 1):
    """Sharded batched multiply + relin + rescale on ``mesh``. Returns
    fn(c0a, c1a, c0b, c1b, key_a, key_b) -> (c0, c1): sharded planes
    (B, L, N) laid out as ``ct_spec_for(mesh, L)`` (or ``ct_spec_mh`` on a
    multihost mesh: the batch on any axes but ``channel``, the channels on
    ``channel`` or replicated) and keys (D, E, N) as
    ``key_spec_for(mesh, D)``; the outputs (B, L-1, N) keep the planes'
    batch layout, their channels on ``channel`` where L - 1 splits over it
    (``ct_spec_for(mesh, L - 1)``), else replicated. ``digit_size`` must
    be the key's stored decomposition width."""
    from ..engine import _check_key_compat, _combined_down_consts, _switch_plan
    from ..ops.small_fast import _dec_inv_ints

    L, n = ctx.num_channels, ctx.degree
    if L < 2:
        raise ValueError("a rescale needs two channels or more")
    nc = mesh.shape["channel"]
    plan = _switch_plan(ctx.moduli, ext_ctx.moduli, digit_size)
    ds, D = plan.digit_size, plan.num_digits
    dec_inv = _dec_inv_ints(tuple(ctx.moduli), ds)
    p_last = _combined_down_consts(ctx.moduli, ext_ctx.moduli)[L - 1]
    p_specials = math.prod(ext_ctx.moduli[L:])
    dropped = ext_ctx.moduli[L - 1 :]  # (q_last, specials...)
    out_split = (L - 1) % nc == 0

    def fn(c0a, c1a, c0b, c1b, key_a, key_b):
        planes = (c0a, c1a, c0b, c1b)
        spec = _plane_spec(planes, mesh, L)
        key_split = _key_split(key_a, key_b, mesh)
        _check_key_compat(ctx, key_a, digit_size)
        fold, accumulate, to_yhat, mod_down = _kernels(ext_ctx.chain.small)
        split = spec.axes[1] == "channel"
        own = _owned(L, nc, split, rescale=True)
        digits = _owned(D, nc, key_split, rescale=False)
        coord = [mesh.coords(p)["channel"] for p in range(mesh.size)]

        # the tensor product and the decomposition fold, channel-local
        t, y, d = [], [], []
        for p, dev in enumerate(mesh.points):
            r = own[coord[p]]
            sl = slice(0, None) if split else slice(r.start, r.stop)
            a0, a1, b0, b1 = (v.blocks[p][:, sl] for v in planes)
            chain = _chain(ctx, dev)
            q, rinv = chain.q[r.start : r.stop], chain.rinv[r.start : r.stop]
            t2 = mm.mont_mul(a1, b1, q, rinv)
            t.append((mm.mont_mul(a0, b0, q, rinv),
                      mm.add_mod(mm.mont_mul(a0, b1, q, rinv),
                                 mm.mont_mul(a1, b0, q, rinv), q)))
            y.append(fold(t2, ctx.moduli[r.start : r.stop], n,
                          dec_inv[r.start : r.stop]) if r else _empty(t2))
            d.append(_skip_own(t2, r, digits[coord[p]], L, ds))
        ks0, ks1 = _key_switch_sums(mesh, y, d, key_a, key_b, key_split, digits,
                                    ctx, ext_ctx, ds, accumulate)
        # q_last's tensor terms, from the last point along the axis
        lasts = [collectives.broadcast(mesh, [tp[i][:, -1:] for tp in t], nc - 1)
                 for i in range(2)]

        outs = ([], [])
        for p, dev in enumerate(mesh.points):
            r = own[coord[p]]
            kept = range(r.start, min(r.stop, L - 1))
            if not kept:
                for i in range(2):
                    outs[i].append(_empty(t[p][i]))
                continue
            chain = _chain(ctx, dev)
            q_last, rinv_last = chain.q[L - 1 :], chain.rinv[L - 1 :]
            p_col = torch.tensor([[p_last]], dtype=torch.int64, device=dev)
            child = ctx.moduli[kept.start : kept.stop]
            for i, ks in enumerate((ks0[p], ks1[p])):
                t_last_p = mm.mont_mul(lasts[i][p], p_col, q_last, rinv_last)
                x_drop = torch.cat([mm.add_mod(t_last_p, ks[:, L - 1 : L], q_last),
                                    ks[:, L:]], dim=-2)
                yhat = to_yhat(x_drop, dropped, child, n)
                outs[i].append(mod_down(
                    yhat, ks[:, kept.start : kept.stop], t[p][i][:, : len(kept)],
                    child_moduli=child, dropped_moduli=dropped, degree=n,
                    t_scale=p_specials))
        out_spec = ShardSpec(mesh, (spec.axes[0], "channel" if out_split else None,
                                    None))
        shape = (c0a.shape[0], L - 1, n)
        if not out_split:
            outs = tuple(collectives.all_gather(mesh, o) for o in outs)
        return tuple(Sharded(out_spec, shape, tuple(o)) for o in outs)

    return fn


def build_rotate(mesh: Mesh, ctx: CkksContext, ext_ctx: CkksContext, perm,
                 digit_size: int = 1):
    """Sharded batched rotation (the NTT-domain automorphism as a slot
    gather by ``perm`` = ``ctx.automorphism_table_ntt(5^k mod 2N)``, then
    the gadget key switch) on ``mesh``. Returns fn(c0, c1, key_a, key_b)
    -> (c0', c1'): planes laid out as ``ct_spec(mesh)`` in and out, keys
    as ``key_spec(mesh)`` (``shard`` raises ``ValueError`` where the
    channel axis does not divide L or D)."""
    from ..engine import _check_key_compat, _switch_plan
    from ..ops.small_fast import _dec_inv_ints

    L, n = ctx.num_channels, ctx.degree
    nc = mesh.shape["channel"]
    data_s, key_s = ct_spec(mesh), key_spec(mesh)
    plan = _switch_plan(ctx.moduli, ext_ctx.moduli, digit_size)
    ds = plan.digit_size
    dec_inv = _dec_inv_ints(tuple(ctx.moduli), ds)
    specials = ext_ctx.moduli[L:]

    def fn(c0, c1, key_a, key_b):
        if c0.spec != data_s or c1.spec != data_s or c0.shape != c1.shape:
            raise ValueError("build_rotate: planes laid out as ct_spec(mesh) expected")
        if key_a.spec != key_s or key_b.spec != key_s:
            raise ValueError("build_rotate: keys laid out as key_spec(mesh) expected")
        _check_key_compat(ctx, key_a, digit_size)
        fold, accumulate, to_yhat, mod_down = _kernels(ext_ctx.chain.small)
        own = _owned(L, nc, True, rescale=False)
        digits = _owned(plan.num_digits, nc, True, rescale=False)
        coord = [mesh.coords(p)["channel"] for p in range(mesh.size)]

        rot, y, d = [], [], []
        for p, dev in enumerate(mesh.points):
            r = own[coord[p]]
            pd = perm.to(dev)
            c0r, c1r = (v.blocks[p].index_select(-1, pd) for v in (c0, c1))
            rot.append(c0r)
            y.append(fold(c1r, ctx.moduli[r.start : r.stop], n,
                          dec_inv[r.start : r.stop]))
            d.append(_skip_own(c1r, r, digits[coord[p]], L, ds))
        ks0, ks1 = _key_switch_sums(mesh, y, d, key_a, key_b, True, digits,
                                    ctx, ext_ctx, ds, accumulate)

        outs = ([], [])
        for p, dev in enumerate(mesh.points):
            r = own[coord[p]]
            child = ctx.moduli[r.start : r.stop]
            for i, ks in enumerate((ks0[p], ks1[p])):
                yhat = to_yhat(ks[:, L:], specials, child, n)
                outs[i].append(mod_down(yhat, ks[:, r.start : r.stop], None,
                                        child_moduli=child, dropped_moduli=specials,
                                        degree=n))
            q = _chain(ctx, dev).q[r.start : r.stop]
            outs[0][-1] = mm.add_mod(rot[p], outs[0][-1], q)
        return tuple(Sharded(data_s, tuple(c0.shape), tuple(o)) for o in outs)

    return fn
