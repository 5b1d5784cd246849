"""Sequence-parallel fused sparse attention (sharded sparse-flash).

Combines the distribution layer with the fused attention kernel: the score
topology is row(=query)-partitioned over a mesh axis (``RowPartition``),
each device runs the sparse-flash kernel over its own query band's occupied
key blocks (per-shard block metadata travels as stacked device-varying
data), and K/V are replicated. Communication: the forward is
communication-free; in the backward only dk/dv — partial sums over the
globally-shared key axis — pay one ``psum`` over the interconnect.

This is the BASELINE north-star sequence scaling: each shard holds only
its query rows' CSR slice and touches only the K/V columns its nonzeros
reference, with scores never materialised in HBM on any device.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops._common import device_arrays as _device_arrays
from ..ops.pallas import flash_sparse as fs
from ..topology import SparseTopology
from .partition import RowPartition

__all__ = ["ShardedFlashSpec", "flash_attention_sharded",
           "flash_attention_kv_sharded"]


class ShardedFlashSpec:
    """Static bundle: row partition + per-shard flash metadata, stacked."""

    def __init__(self, part: RowPartition, *,
                 bm: int = 128, bk: int = 128,
                 mesh: Optional[Mesh] = None, axis: str = "sp"):
        # Every replica shares the (single) shard topology, so the kernels
        # run with heads=R (metadata batch 0 shared by all replicas). GQA
        # head grouping is a CALL-time property (``group=`` on
        # flash_attention_sharded), like pallas/decode_attention.
        self.part = part
        self.mesh, self.axis = mesh, axis
        views = [s.block(bm, bk) for s in part.shards]
        self.views = views
        v0 = views[0]
        self.mb, self.kb = v0.mb, v0.kb
        self.bm, self.bk = bm, bk
        self.m_pad_loc, self.n_pad = v0.m_pad, v0.n_pad

        fmetas = [fs.build_flash_bwd_meta([v]) for v in views]
        # ONE stacking implementation (shared with the overlap split's
        # interior/halo metadata — a padding-convention change must not
        # be able to diverge between the base spec and the split)
        st = _stack_fmetas(fmetas, self.mb, self.kb)
        self.max_bpr, self.max_bpc = st["max_bpr"], st["max_bpc"]
        self.block_cols = st["block_cols"]
        self.mask_slot = st["mask_slot"]
        self.is_partial_ = st["is_partial"]
        self.nblocks = st["nblocks"]
        self.t_src_i = st["t_src_i"]
        self.t_mask_slot = st["t_mask_slot"]
        self.t_is_partial = st["t_is_partial"]
        self.t_nblocks = st["t_nblocks"]
        self.pmask = st["pmask"]

    def halo_extents(self, n_loc: int):
        """(lo, hi): max KEY rows any device's topology shard reaches
        below/above its own ``n_loc``-row K/V band — the ragged K/V
        exchange size for ``flash_attention_kv_sharded``. Same derivation
        as ``ShardedPanelSpec.halo_extents`` (touched column blocks from
        the stacked metadata), uniform over devices for static shapes."""
        cache = getattr(self, "_halo_extents", None)
        if cache is None:
            cache = {}
            self._halo_extents = cache
        if n_loc in cache:
            return cache[n_loc]
        lo = hi = 0
        ndev = self.part.ndev
        for d in range(ndev):
            cols = self.block_cols[d].reshape(self.mb, self.max_bpr)
            nblk = self.nblocks[d]
            touched = [int(cols[i, s]) for i in range(self.mb)
                       for s in range(int(nblk[i]))]
            if not touched:
                continue
            first = min(touched) * self.bk
            last = (max(touched) + 1) * self.bk
            lo = max(lo, d * n_loc - first)
            hi = max(hi, last - (d + 1) * n_loc)
        cache[n_loc] = (max(lo, 0), max(hi, 0))
        return cache[n_loc]

    def halo_plan(self, n_loc: int):
        """(lo, hi) when the ragged exchange wins, else None (full-span
        topology -> dense all_gather fallback)."""
        lo, hi = self.halo_extents(n_loc)
        if lo + hi >= (self.part.ndev - 1) * n_loc:
            return None
        return lo, hi

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def _smap(spec, fn, in_specs, out_specs):
    # On a multi-axis mesh, stay MANUAL only over the spec's own axis:
    # the other axes (dp across hosts, tp) remain under GSPMD control, so
    # an outer jit can shard the replica/batch dims over them — the
    # hierarchical host-tier composition (see __graft_entry__'s 2x4
    # dryrun and comm_model's DCN tier).
    kw = {}
    if spec.mesh is not None and len(spec.mesh.axis_names) > 1:
        kw["axis_names"] = frozenset({spec.axis})
    return jax.shard_map(fn, mesh=spec.mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False, **kw)


def _meta_args(spec):
    return tuple(jnp.asarray(x) for x in (
        spec.block_cols, spec.nblocks, spec.mask_slot, spec.is_partial_,
        spec.pmask))


def _t_meta_args(spec):
    return tuple(jnp.asarray(x) for x in (
        spec.t_src_i, spec.t_nblocks, spec.t_mask_slot, spec.t_is_partial,
        spec.pmask))


def _fwd_sharded(spec, q_sh, k, v, group):
    """q_sh [ndev, R, m_pad_loc, hd_pad] (pre-scaled+padded);
    k, v [R // group, n_pad, hd_pad] replicated. Returns (out, m, l)
    sharded."""
    R = q_sh.shape[1]
    x = spec.axis

    def local(cols, nblk, slot, part, pmask, q, kk, vv):
        out, m, l = fs.flash_sparse_attention_fwd(
            cols[0][None], nblk[0][None], slot[0][None], part[0][None],
            pmask[0][None], q[0], kk, vv,
            R=R, heads=R, mb=spec.mb, max_bpr=spec.max_bpr,
            bm=spec.bm, bk=spec.bk, group=group)
        return out[None], m[None], l[None]

    fn = _smap(
        spec, local,
        in_specs=(P(x), P(x), P(x), P(x), P(x),
                  P(x), P(None, None, None), P(None, None, None)),
        out_specs=(P(x), P(x), P(x)),
    )
    return fn(*_meta_args(spec), q_sh, k, v)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5))
def _flash_sh(spec, q_sh, k, v, scale, group):
    out, _, _ = _fwd_sharded(spec, *_prep(spec, q_sh, k, v, scale), group)
    return out  # _prep already applied the scale


def _prep(spec, q_sh, k, v, scale):
    hd = q_sh.shape[-1]
    hd_pad = hd
    ndev, R = q_sh.shape[0], q_sh.shape[1]
    R_kv = k.shape[0]
    q_p = jnp.zeros((ndev, R, spec.m_pad_loc, hd_pad), q_sh.dtype)
    q_p = q_p.at[:, :, : q_sh.shape[2], :hd].set(q_sh * scale)
    k_p = jnp.zeros((R_kv, spec.n_pad, hd_pad), k.dtype)
    k_p = k_p.at[:, : k.shape[1], :hd].set(k)
    v_p = jnp.zeros((R_kv, spec.n_pad, hd_pad), v.dtype)
    v_p = v_p.at[:, : v.shape[1], :hd].set(v)
    return q_p, k_p, v_p


def _flash_sh_fwd(spec, q_sh, k, v, scale, group):
    q_p, k_p, v_p = _prep(spec, q_sh, k, v, scale)
    out, m, l = _fwd_sharded(spec, q_p, k_p, v_p, group)
    # residuals hold ONLY the padded copies + the unpadded shapes —
    # saving q_sh/k/v too doubled activation memory (k/v replicated on
    # every device) when the backward needs just their extents
    shapes = (q_sh.shape, k.shape, v.shape)
    return out, (shapes, q_p, k_p, v_p, out, m, l)


def _flash_sh_bwd(spec, scale, group, res, g):
    (q_shape, k_shape, v_shape), q_p, k_p, v_p, out, m_st, l_st = res
    ndev, R = q_p.shape[0], q_p.shape[1]
    hd = q_shape[-1]
    x = spec.axis

    g_p = g  # cotangent of the (padded) kernel output; zeros in padding

    stats = jnp.concatenate(
        [m_st[:, :, :, :1], l_st[:, :, :, :1],
         jnp.zeros(m_st.shape[:3] + (126,), jnp.float32)], axis=3)
    d_rows = jnp.sum(g_p * out, axis=-1)           # [ndev, R, m_pad_loc]
    dcoef = jnp.broadcast_to(
        d_rows[..., None], d_rows.shape + (128,))

    def local_dq(cols, nblk, slot, part, pmask, q, kk, vv, gg, st, dc):
        dq = fs.flash_sparse_bwd_dq(
            cols[0][None], nblk[0][None], slot[0][None], part[0][None],
            pmask[0][None], q[0], kk, vv, gg[0], st[0], dc[0],
            R=R, heads=R, mb=spec.mb, max_bpr=spec.max_bpr,
            bm=spec.bm, bk=spec.bk, group=group)
        return dq[None]

    dq_p = _smap(
        spec, local_dq,
        in_specs=(P(x), P(x), P(x), P(x), P(x), P(x),
                  P(None, None, None), P(None, None, None),
                  P(x), P(x), P(x)),
        out_specs=P(x),
    )(*_meta_args(spec), q_p, k_p, v_p, g_p, stats, dcoef)

    def local_dkv(ti, tn, tsl, tpt, pmask, q, kk, vv, gg, st, dc):
        dk, dv = fs.flash_sparse_bwd_dkv(
            ti[0][None], tn[0][None], tsl[0][None], tpt[0][None],
            pmask[0][None], q[0], kk, vv, gg[0], st[0], dc[0],
            R=R, heads=R, kb=spec.kb, max_bpc=spec.max_bpc,
            bm=spec.bm, bk=spec.bk, group=group)
        if group > 1:
            # per-query-replica partials -> shared KV replica grads,
            # summed LOCALLY before the psum (the payload shrinks by
            # the group factor too)
            dk = dk.reshape(R // group, group, *dk.shape[1:]).sum(axis=1)
            dv = dv.reshape(R // group, group, *dv.shape[1:]).sum(axis=1)
        # after the psum every device holds the identical full dk/dv —
        # return them replicated instead of stacking ndev copies and
        # slicing [0] outside
        dk = jax.lax.psum(dk, spec.axis)
        dv = jax.lax.psum(dv, spec.axis)
        return dk, dv

    dk_p, dv_p = _smap(
        spec, local_dkv,
        in_specs=(P(x), P(x), P(x), P(x), P(x), P(x),
                  P(None, None, None), P(None, None, None),
                  P(x), P(x), P(x)),
        out_specs=(P(None, None, None), P(None, None, None)),
    )(*_t_meta_args(spec), q_p, k_p, v_p, g_p, stats, dcoef)

    dq = (dq_p[:, :, : q_shape[2], :hd] * scale).astype(q_p.dtype)
    dk = dk_p[:, : k_shape[1], :hd].astype(k_p.dtype)
    dv = dv_p[:, : v_shape[1], :hd].astype(v_p.dtype)
    return dq, dk, dv


_flash_sh.defvjp(_flash_sh_fwd, _flash_sh_bwd)


def flash_attention_sharded(spec: ShardedFlashSpec, q_sh, k, v,
                            scale=None, group: int = 1):
    """Sequence-parallel fused sparse attention.

    ``q_sh [ndev, R, s_loc, hd]`` query-sharded over the mesh axis (rows in
    partition order — apply ``spec.part.perm`` if balanced); ``k, v
    [R // group, s, hd]`` replicated. Returns query-sharded
    ``[ndev, R, s_loc, hd]`` (trimmed to ``s_loc`` rows).

    ``group`` (GQA): each run of ``group`` consecutive query replicas
    reads one shared KV replica (``r // group``, the ``b*heads + h`` fold
    order — same convention as ``pallas/decode_attention``). Replicated
    K/V memory, kernel KV streams, and the dk/dv psum payload all shrink
    by ``group`` vs expanding K/V to full heads — exactly where sequence
    parallelism runs longest.
    """
    R = q_sh.shape[1]
    if group < 1 or R % group:
        raise ValueError(f"group {group} must divide replicas {R}")
    if k.shape[0] != R // group or v.shape[0] != R // group:
        raise ValueError(
            f"k/v replicas {k.shape[0]}/{v.shape[0]} != R // group "
            f"{R // group}")
    if scale is None:
        scale = 1.0 / np.sqrt(q_sh.shape[-1])
    out = _flash_sh(spec, q_sh, k, v, float(scale), int(group))
    return out[:, :, : q_sh.shape[2], : q_sh.shape[-1]]


# ---------------------------------------------------------------------------
# K/V-SHARDED sequence parallelism: halo exchange instead of replication.
#
# The replicated-K/V path above pays a full [R_kv, n_pad, hd] psum for
# dk/dv — quantified in benchmarks/scaling.py as THE structural scaling
# cost of sp attention. For banded/windowed topologies (the long-context
# design target) each query shard only reads a bounded band of keys, so
# K/V can stay key-sharded and only the halo rows move (sliced ppermute
# shifts, same machinery as sharded_ops._halo_assemble). The backward
# needs NO psum at all: dk/dv partials live in the globally-indexed local
# buffer and the halo assembly's own VJP (reverse ppermutes, identical
# volume) routes overlapping halo contributions back to their owners.
# Comm per step: 2 x (lo + hi) x hd rows each way vs the psum's
# 2 x n_pad x hd x (ndev-1)/ndev — constant in sequence length.
# ---------------------------------------------------------------------------


def _assemble_kv(spec, x_sh, n_loc, plan, *, include_own=True):
    """Differentiable halo assembly: x_sh [ndev, R_kv, n_loc, hd_pad]
    key-sharded -> globally-indexed [ndev, R_kv, n_pad, hd_pad].

    ``include_own=True``: each device's own band is written too (the
    monolithic path's full buffer; ``plan=None`` falls back to
    all_gather for full-span topologies). ``include_own=False``: ONLY
    the received halo rows are written (the overlap split's buffer —
    the interior kernel reads the local shard directly, so every write
    here is a ppermute landing and the transfers have no kernel
    dependency). One body so the send-slice / wraparound-to-scratch
    arithmetic cannot diverge between the two paths. (sharded_ops has
    the 2-D dense-operand twin — rank differences keep them separate.)"""
    x = spec.axis
    ndev = spec.part.ndev

    if plan is None:
        if not include_own:
            raise ValueError("halo-only assembly needs a ragged plan")

        def local_g(xl):
            full = jax.lax.all_gather(xl[0], x, axis=1, tiled=True)
            R_kv, n_full, hd_pad = full.shape
            buf = jnp.zeros((R_kv, spec.n_pad, hd_pad), full.dtype)
            return buf.at[:, :min(n_full, spec.n_pad)].set(
                full[:, : spec.n_pad])[None]

        return _smap(spec, local_g, in_specs=P(x), out_specs=P(x))(x_sh)

    lo, hi = plan
    steps_lo, steps_hi = -(-lo // n_loc), -(-hi // n_loc)

    def local(xl):
        x_loc = xl[0]                        # [R_kv, n_loc, hd_pad]
        R_kv, _, hd_pad = x_loc.shape
        me = jax.lax.axis_index(x)
        z = jnp.int32(0)
        # + n_loc scratch rows absorb wrapped edge-device writes (their
        # metadata never reads them; see sharded_ops._halo_assemble)
        buf = jnp.zeros((R_kv, spec.n_pad + n_loc, hd_pad), x_loc.dtype)
        if include_own:
            buf = jax.lax.dynamic_update_slice(buf, x_loc,
                                               (z, me * n_loc, z))
        scratch = spec.n_pad
        for k in range(1, steps_lo + 1):
            take = min(n_loc, lo - (k - 1) * n_loc)
            send = x_loc[:, n_loc - take:, :]
            recv = jax.lax.ppermute(
                send, x, [(j, (j + k) % ndev) for j in range(ndev)])
            start = (me - k) * n_loc + (n_loc - take)
            start = jnp.where(me >= k, start, scratch)
            buf = jax.lax.dynamic_update_slice(buf, recv, (z, start, z))
        for k in range(1, steps_hi + 1):
            take = min(n_loc, hi - (k - 1) * n_loc)
            send = x_loc[:, :take, :]
            recv = jax.lax.ppermute(
                send, x, [(j, (j - k) % ndev) for j in range(ndev)])
            start = (me + k) * n_loc
            start = jnp.where(me + k < ndev, start, scratch)
            buf = jax.lax.dynamic_update_slice(buf, recv, (z, start, z))
        return buf[:, : spec.n_pad][None]

    return _smap(spec, local, in_specs=P(x), out_specs=P(x))(x_sh)


def _fwd_sharded_kv(spec, q_p, kbuf, vbuf, group):
    R = q_p.shape[1]
    x = spec.axis

    def local(cols, nblk, slot, part, pmask, q, kk, vv):
        out, m, l = fs.flash_sparse_attention_fwd(
            cols[0][None], nblk[0][None], slot[0][None], part[0][None],
            pmask[0][None], q[0], kk[0], vv[0],
            R=R, heads=R, mb=spec.mb, max_bpr=spec.max_bpr,
            bm=spec.bm, bk=spec.bk, group=group)
        return out[None], m[None], l[None]

    fn = _smap(
        spec, local,
        in_specs=(P(x), P(x), P(x), P(x), P(x), P(x), P(x), P(x)),
        out_specs=(P(x), P(x), P(x)),
    )
    return fn(*_meta_args(spec), q_p, kbuf, vbuf)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5))
def _flash_sh_kv(spec, q_p, kbuf, vbuf, scale, group):
    out, _, _ = _fwd_sharded_kv(spec, q_p, kbuf, vbuf, group)
    return out


def _flash_sh_kv_fwd(spec, q_p, kbuf, vbuf, scale, group):
    out, m, l = _fwd_sharded_kv(spec, q_p, kbuf, vbuf, group)
    return out, (q_p, kbuf, vbuf, out, m, l)


def _flash_sh_kv_bwd(spec, scale, group, res, g):
    q_p, kbuf, vbuf, out, m_st, l_st = res
    R = q_p.shape[1]
    x = spec.axis

    stats = jnp.concatenate(
        [m_st[:, :, :, :1], l_st[:, :, :, :1],
         jnp.zeros(m_st.shape[:3] + (126,), jnp.float32)], axis=3)
    d_rows = jnp.sum(g * out, axis=-1)
    dcoef = jnp.broadcast_to(d_rows[..., None], d_rows.shape + (128,))

    sh = (P(x),) * 5

    def local_dq(cols, nblk, slot, part, pmask, q, kk, vv, gg, st, dc):
        dq = fs.flash_sparse_bwd_dq(
            cols[0][None], nblk[0][None], slot[0][None], part[0][None],
            pmask[0][None], q[0], kk[0], vv[0], gg[0], st[0], dc[0],
            R=R, heads=R, mb=spec.mb, max_bpr=spec.max_bpr,
            bm=spec.bm, bk=spec.bk, group=group)
        return dq[None]

    dq_p = _smap(
        spec, local_dq,
        in_specs=sh + (P(x), P(x), P(x), P(x), P(x), P(x)),
        out_specs=P(x),
    )(*_meta_args(spec), q_p, kbuf, vbuf, g, stats, dcoef)

    def local_dkv(ti, tn, tsl, tpt, pmask, q, kk, vv, gg, st, dc):
        dk, dv = fs.flash_sparse_bwd_dkv(
            ti[0][None], tn[0][None], tsl[0][None], tpt[0][None],
            pmask[0][None], q[0], kk[0], vv[0], gg[0], st[0], dc[0],
            R=R, heads=R, kb=spec.kb, max_bpc=spec.max_bpc,
            bm=spec.bm, bk=spec.bk, group=group)
        if group > 1:
            dk = dk.reshape(R // group, group, *dk.shape[1:]).sum(axis=1)
            dv = dv.reshape(R // group, group, *dv.shape[1:]).sum(axis=1)
        # NO psum: partials stay in this device's globally-indexed buffer
        # coords; the halo assembly's VJP (outside this custom_vjp) sums
        # overlapping halo contributions via reverse ppermutes.
        return dk[None], dv[None]

    dk_b, dv_b = _smap(
        spec, local_dkv,
        in_specs=sh + (P(x), P(x), P(x), P(x), P(x), P(x)),
        out_specs=(P(x), P(x)),
    )(*_t_meta_args(spec), q_p, kbuf, vbuf, g, stats, dcoef)

    # dq is w.r.t. q_p, which the PUBLIC fn already pre-scaled — the
    # outer scale chain rule happens outside this custom_vjp (unlike
    # _flash_sh, whose _prep scales INSIDE the vjp boundary)
    return dq_p.astype(q_p.dtype), dk_b.astype(kbuf.dtype), \
        dv_b.astype(vbuf.dtype)


_flash_sh_kv.defvjp(_flash_sh_kv_fwd, _flash_sh_kv_bwd)


def flash_attention_kv_sharded(spec: ShardedFlashSpec, q_sh, k_sh, v_sh,
                               scale=None, group: int = 1,
                               overlap: bool = True):
    """Sequence-parallel fused sparse attention with K/V SHARDED over the
    same axis as the queries — the zero-psum variant.

    ``q_sh [ndev, R, s_loc_q, hd]`` query-sharded (partition row order);
    ``k_sh, v_sh [ndev, R_kv, s_loc_k, hd]`` KEY-sharded in natural order
    (device d owns key rows ``[d * n_loc, d * n_loc + s_loc_k)``), with
    ``R_kv = R // group`` (GQA). Each device fetches only the halo key
    rows its topology shard touches (``spec.halo_extents``); full-span
    topologies fall back to all_gather. The backward is psum-free: dk/dv
    flow back through the halo assembly's VJP. Returns query-sharded
    ``[ndev, R, s_loc_q, hd]``.

    Use this for banded/windowed long-context topologies with
    ``RowPartition(balance=False)`` (contiguous query bands — a balanced
    permutation scatters rows and forces the all_gather fallback).

    ``overlap`` (default on, engaged when the halo plan is ragged and the
    band is whole blocks): split each shard's topology into interior
    blocks (computed from the LOCAL K/V, no comm) and halo blocks (a
    second small kernel pass over only the exchanged rows), merged by the
    online-softmax rule — the halo ppermutes and the interior kernel have
    no serializing dependency, so the transfer streams while the kernel
    works (see the module-level OVERLAP section)."""
    ndev, R = q_sh.shape[0], q_sh.shape[1]
    R_kv = k_sh.shape[1]
    if group < 1 or R % group:
        raise ValueError(f"group {group} must divide replicas {R}")
    if R_kv != R // group or v_sh.shape[1] != R_kv:
        raise ValueError(
            f"k/v replicas {R_kv}/{v_sh.shape[1]} != R // group "
            f"{R // group}")
    if k_sh.shape[0] != ndev or v_sh.shape[0] != ndev:
        raise ValueError("k/v must carry the ndev axis (key-sharded)")
    if spec.n_pad % ndev:
        raise ValueError(
            f"key padding n_pad={spec.n_pad} must divide over ndev="
            f"{ndev} for key sharding (pad s or change bk)")
    n_loc = spec.n_pad // ndev
    if k_sh.shape[2] > n_loc:
        raise ValueError(f"per-device key rows {k_sh.shape[2]} > {n_loc}")
    hd = q_sh.shape[-1]
    hd_pad = hd
    # Python float (weak type): a np.float64 scalar would promote the
    # f32 q under x64 and warn/copy on the padded .set
    scale = float(scale) if scale is not None else float(hd) ** -0.5

    kp = jnp.zeros((ndev, R_kv, n_loc, hd_pad), k_sh.dtype)
    kp = kp.at[:, :, : k_sh.shape[2], :hd].set(k_sh)
    vp = jnp.zeros((ndev, R_kv, n_loc, hd_pad), v_sh.dtype)
    vp = vp.at[:, :, : v_sh.shape[2], :hd].set(v_sh)
    plan = spec.halo_plan(n_loc)

    q_p = jnp.zeros((ndev, R, spec.m_pad_loc, hd_pad), q_sh.dtype)
    q_p = q_p.at[:, :, : q_sh.shape[2], :hd].set(q_sh * scale)

    if overlap and plan is not None and n_loc % spec.bk == 0:
        kbuf = _assemble_halo(spec, kp, n_loc, plan)
        vbuf = _assemble_halo(spec, vp, n_loc, plan)
        out = _flash_kv_ov(spec, n_loc, q_p, kp, kbuf, vp, vbuf,
                           int(group))
        return out[:, :, : q_sh.shape[2], :hd]

    kbuf = _assemble_kv(spec, kp, n_loc, plan)
    vbuf = _assemble_kv(spec, vp, n_loc, plan)
    out = _flash_sh_kv(spec, q_p, kbuf, vbuf, float(scale), int(group))
    return out[:, :, : q_sh.shape[2], :hd]


# ---------------------------------------------------------------------------
# Comm/compute-OVERLAPPED K/V-sharded attention.
#
# The path above assembles the halo'd K/V buffer FULLY before the kernel
# runs — the halo ppermutes sit on the critical path. This variant splits
# each device's topology shard into
#
#   * INTERIOR blocks: key columns inside the device's own n_loc-row K/V
#     band — computable from the LOCAL K/V shard with no communication;
#   * HALO blocks: key columns in other devices' bands — they need the
#     halo rows, which travel via the same sliced ppermute shifts.
#
# The halo ppermutes are issued first and depend only on the K/V shards;
# the interior flash kernel depends only on the local shard — the compiled
# program has NO serializing dependency between the collective and the
# interior kernel (tests/test_overlap.py asserts this on the jaxpr), so
# XLA's async collectives can stream the halo while the kernel works. A
# second, small kernel pass over only the halo blocks consumes the
# arrived rows, and the two partial softmaxes merge by the online rule
# (same math as ring_flash's cross-band merge). The backward splits the
# same way: dq is the sum of the two passes; interior dk/dv land directly
# on the local shard, halo dk/dv ride the reverse ppermutes (the
# assembly's VJP) — the interior dkv kernel is independent of those
# reverse transfers, so the backward overlaps too.
# ---------------------------------------------------------------------------


def _filter_columns(topo: SparseTopology, lo: int, hi: int, *,
                    inside: bool) -> SparseTopology:
    """Host CSR column filter. ``inside=True``: keep cols in ``[lo, hi)``
    REBASED to ``[0, hi - lo)``; ``inside=False``: keep the complement in
    global coordinates."""
    ro, ci = topo.row_offsets, topo.column_indices
    offs = np.zeros(topo.m + 1, np.int32)
    cols = []
    for r in range(topo.m):
        cc = ci[ro[r]: ro[r + 1]]
        keep = (cc >= lo) & (cc < hi)
        cc = (cc[keep] - lo) if inside else cc[~keep]
        cols.append(cc)
        offs[r + 1] = offs[r] + len(cc)
    cat = (np.concatenate(cols).astype(np.int32) if offs[-1]
           else np.zeros(0, np.int32))
    return SparseTopology(topo.m, (hi - lo) if inside else topo.n,
                          offs, cat)


def _stack_fmetas(fmetas, mb, kb):
    """Stack per-device ``build_flash_bwd_meta`` dicts uniformly (the
    ShardedFlashSpec padding conventions, factored for the overlap
    split's second and third metadata sets)."""
    ndev = len(fmetas)
    max_bpr = max(max(m["max_bpr"] for m in fmetas), 1)
    max_bpc = max(max(m["max_bpc"] for m in fmetas), 1)

    def stack2(key, rows, maxlen, repeat):
        outs = []
        for m in fmetas:
            a = m[key][0]
            len_d = a.shape[0] // rows
            pad = np.zeros((rows, maxlen), a.dtype)
            pad[:, :len_d] = a.reshape(rows, len_d)
            if repeat and 0 < len_d < maxlen:
                pad[:, len_d:] = pad[:, len_d - 1: len_d]
            outs.append(pad.reshape(-1))
        return np.stack(outs)

    npart = max(max(m["pmask"].shape[1] for m in fmetas), 1)
    v0 = fmetas[0]
    bm, bk = v0["bm"], v0["bk"]
    pmask = np.zeros((ndev, npart, bm, bk), np.float32)
    for d, m in enumerate(fmetas):
        pmask[d, : m["pmask"].shape[1]] = m["pmask"][0]
    return dict(
        block_cols=stack2("block_cols", mb, max_bpr, True),
        mask_slot=stack2("mask_slot", mb, max_bpr, True),
        is_partial=stack2("is_partial", mb, max_bpr, False),
        nblocks=np.stack([m["nblocks"][0] for m in fmetas]),
        t_src_i=stack2("t_src_i", kb, max_bpc, True),
        t_mask_slot=stack2("t_mask_slot", kb, max_bpc, True),
        t_is_partial=stack2("t_is_partial", kb, max_bpc, False),
        t_nblocks=np.stack([m["t_nblocks"][0] for m in fmetas]),
        pmask=pmask, max_bpr=int(max_bpr), max_bpc=int(max_bpc))


def _overlap_meta(spec: ShardedFlashSpec, n_loc: int):
    """Interior/halo split metadata, built once per spec (host) and
    cached. Interior block columns are REBASED to the local band (the
    kernel reads the un-assembled K/V shard directly); halo columns stay
    global (the kernel reads the halo-assembled buffer)."""
    cache = getattr(spec, "_ov_meta", None)
    if cache is not None:
        if cache["n_loc"] != n_loc:
            # kv-sharding fixes n_loc = n_pad // ndev; a different value
            # means a caller bug, not a cache-key miss
            raise ValueError(
                f"overlap metadata built for n_loc={cache['n_loc']}, "
                f"got {n_loc}")
        return cache
    ndev = spec.part.ndev
    fmet_i, fmet_h = [], []
    for d in range(ndev):
        shard = spec.part.shards[d]
        lo, hi = d * n_loc, (d + 1) * n_loc
        t_i = _filter_columns(shard, lo, hi, inside=True)
        t_h = _filter_columns(shard, lo, hi, inside=False)
        fmet_i.append(fs.build_flash_bwd_meta(
            [t_i.block(spec.bm, spec.bk)]))
        fmet_h.append(fs.build_flash_bwd_meta(
            [t_h.block(spec.bm, spec.bk)]))
    kb_i = n_loc // spec.bk
    meta = {
        "i": _stack_fmetas(fmet_i, spec.mb, kb_i),
        "h": _stack_fmetas(fmet_h, spec.mb, spec.kb),
        "kb_i": kb_i,
        "n_loc": n_loc,
    }
    spec._ov_meta = meta
    return meta


_OV_KEYS = ("block_cols", "nblocks", "mask_slot", "is_partial",
            "t_src_i", "t_nblocks", "t_mask_slot", "t_is_partial", "pmask")


def _ov_dev_meta(spec, n_loc):
    meta = _overlap_meta(spec, n_loc)
    return _device_arrays(
        spec, "_ov_meta_dev",
        lambda: {f"{p}_{k}": meta[p][k]
                 for p in ("i", "h") for k in _OV_KEYS})


def _assemble_halo(spec, x_sh, n_loc, plan):
    """Halo-ONLY assembly (the overlap split): see ``_assemble_kv``."""
    return _assemble_kv(spec, x_sh, n_loc, plan, include_own=False)


def _ov_merge(out_i, m_i, l_i, out_h, m_h, l_h):
    """Online-softmax merge of two partial flash results (each already
    normalised by its own denominator). Same invariant as ring_flash's
    cross-band merge: rescale factors carry the l's explicitly."""
    m_i, l_i = m_i[..., :1], l_i[..., :1]
    m_h, l_h = m_h[..., :1], l_h[..., :1]
    M = jnp.maximum(m_i, m_h)
    wi = jnp.exp(m_i - M) * l_i
    wh = jnp.exp(m_h - M) * l_h
    L = wi + wh
    out = (out_i * wi + out_h * wh) / jnp.maximum(L, 1e-30)
    return out, M, L


def _ov_fwd(spec, n_loc, group, q_p, k_loc, kbuf, v_loc, vbuf):
    R = q_p.shape[1]
    x = spec.axis
    meta = _ov_dev_meta(spec, n_loc)
    st = _overlap_meta(spec, n_loc)
    keys = list(meta.keys())
    vals = [meta[k] for k in keys]

    def local(*args):
        md = dict(zip(keys, args[: len(keys)]))
        q, kl, kb_, vl, vb = args[len(keys):]
        q0 = q[0]
        out_i, m_i, l_i = fs.flash_sparse_attention_fwd(
            md["i_block_cols"][0][None], md["i_nblocks"][0][None],
            md["i_mask_slot"][0][None], md["i_is_partial"][0][None],
            md["i_pmask"][0][None], q0, kl[0], vl[0],
            R=R, heads=R, mb=spec.mb, max_bpr=st["i"]["max_bpr"],
            bm=spec.bm, bk=spec.bk, group=group)
        out_h, m_h, l_h = fs.flash_sparse_attention_fwd(
            md["h_block_cols"][0][None], md["h_nblocks"][0][None],
            md["h_mask_slot"][0][None], md["h_is_partial"][0][None],
            md["h_pmask"][0][None], q0, kb_[0], vb[0],
            R=R, heads=R, mb=spec.mb, max_bpr=st["h"]["max_bpr"],
            bm=spec.bm, bk=spec.bk, group=group)
        out, M, L = _ov_merge(out_i, m_i, l_i, out_h, m_h, l_h)
        return out[None], M[None], L[None]

    fn = _smap(spec, local,
               in_specs=tuple(P(x) for _ in keys) + (P(x),) * 5,
               out_specs=(P(x), P(x), P(x)))
    return fn(*vals, q_p, k_loc, kbuf, v_loc, vbuf)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 7))
def _flash_kv_ov(spec, n_loc, q_p, k_loc, kbuf, v_loc, vbuf, group):
    out, _, _ = _ov_fwd(spec, n_loc, group, q_p, k_loc, kbuf, v_loc, vbuf)
    return out


def _flash_kv_ov_fwd(spec, n_loc, q_p, k_loc, kbuf, v_loc, vbuf, group):
    out, M, L = _ov_fwd(spec, n_loc, group, q_p, k_loc, kbuf, v_loc, vbuf)
    return out, (q_p, k_loc, kbuf, v_loc, vbuf, out, M, L)


def _flash_kv_ov_bwd(spec, n_loc, group, res, g):
    q_p, k_loc, kbuf, v_loc, vbuf, out, M, L = res
    R = q_p.shape[1]
    x = spec.axis
    meta = _ov_dev_meta(spec, n_loc)
    st = _overlap_meta(spec, n_loc)
    keys = list(meta.keys())
    vals = [meta[k] for k in keys]

    stats = jnp.concatenate(
        [M, L, jnp.zeros(M.shape[:3] + (126,), jnp.float32)], axis=3)
    d_rows = jnp.sum(g * out, axis=-1)
    dcoef = jnp.broadcast_to(d_rows[..., None], d_rows.shape + (128,))

    def local(*args):
        md = dict(zip(keys, args[: len(keys)]))
        q, kl, kb_, vl, vb, gg, stt, dc = args[len(keys):]
        q0, g0, st0, dc0 = q[0], gg[0], stt[0], dc[0]
        dq = fs.flash_sparse_bwd_dq(
            md["i_block_cols"][0][None], md["i_nblocks"][0][None],
            md["i_mask_slot"][0][None], md["i_is_partial"][0][None],
            md["i_pmask"][0][None], q0, kl[0], vl[0], g0, st0, dc0,
            R=R, heads=R, mb=spec.mb, max_bpr=st["i"]["max_bpr"],
            bm=spec.bm, bk=spec.bk, group=group)
        dq = dq + fs.flash_sparse_bwd_dq(
            md["h_block_cols"][0][None], md["h_nblocks"][0][None],
            md["h_mask_slot"][0][None], md["h_is_partial"][0][None],
            md["h_pmask"][0][None], q0, kb_[0], vb[0], g0, st0, dc0,
            R=R, heads=R, mb=spec.mb, max_bpr=st["h"]["max_bpr"],
            bm=spec.bm, bk=spec.bk, group=group)
        dk_l, dv_l = fs.flash_sparse_bwd_dkv(
            md["i_t_src_i"][0][None], md["i_t_nblocks"][0][None],
            md["i_t_mask_slot"][0][None],
            md["i_t_is_partial"][0][None],
            md["i_pmask"][0][None], q0, kl[0], vl[0], g0, st0, dc0,
            R=R, heads=R, kb=st["kb_i"], max_bpc=st["i"]["max_bpc"],
            bm=spec.bm, bk=spec.bk, group=group)
        dk_b, dv_b = fs.flash_sparse_bwd_dkv(
            md["h_t_src_i"][0][None], md["h_t_nblocks"][0][None],
            md["h_t_mask_slot"][0][None],
            md["h_t_is_partial"][0][None],
            md["h_pmask"][0][None], q0, kb_[0], vb[0], g0, st0, dc0,
            R=R, heads=R, kb=spec.kb, max_bpc=st["h"]["max_bpc"],
            bm=spec.bm, bk=spec.bk, group=group)
        if group > 1:
            gsum = lambda a: a.reshape(                     # noqa: E731
                R // group, group, *a.shape[1:]).sum(axis=1)
            dk_l, dv_l = gsum(dk_l), gsum(dv_l)
            dk_b, dv_b = gsum(dk_b), gsum(dv_b)
        return dq[None], dk_l[None], dk_b[None], dv_l[None], dv_b[None]

    sh = tuple(P(x) for _ in keys)
    dq, dk_l, dk_b, dv_l, dv_b = _smap(
        spec, local,
        in_specs=sh + (P(x),) * 8,
        out_specs=(P(x),) * 5,
    )(*vals, q_p, k_loc, kbuf, v_loc, vbuf, g, stats, dcoef)
    # cotangents w.r.t. (q_p pre-scaled, local K/V shards, halo buffers);
    # the halo buffers' cotangents route home through _assemble_halo's
    # VJP outside this custom_vjp (reverse ppermutes, same volume)
    return (dq.astype(q_p.dtype), dk_l.astype(k_loc.dtype),
            dk_b.astype(kbuf.dtype), dv_l.astype(v_loc.dtype),
            dv_b.astype(vbuf.dtype))


_flash_kv_ov.defvjp(_flash_kv_ov_fwd, _flash_kv_ov_bwd)
