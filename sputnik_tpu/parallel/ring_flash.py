"""Ring sparse flash attention: full-causal sequence parallelism.

``flash_attention_kv_sharded`` (halo exchange) covers banded/windowed
topologies; FULL-CAUSAL masks span every earlier key block, so its halo
degenerates to an all_gather that materialises the whole K/V on every
device. This module closes that case with the ring schedule (the
sparse-flash generalisation of Ring Attention): K/V stay key-sharded, and
on step ``t`` device ``d`` holds key band ``(d - t) mod ndev``, runs the
fused sparse-flash kernel over ONLY that band's occupied blocks of its
query shard's topology, folds the partial result into a running online
softmax (cross-band log-sum-exp merge), and rotates the band one hop.
Peak K/V memory per device is one band (+ the in-flight copy), not the
whole sequence; comm is the same total volume as the all_gather but
pipelined with compute and never materialised.

The backward is the standard two-pass ring: the forward's FINAL softmax
stats (running max / denominator per query row) are saved, then a second
ring pass recomputes each band's probabilities from those stats, runs the
existing sparse-flash backward kernels (dq accumulates locally; dk/dv
accumulate into buffers that ROTATE WITH their band, arriving home after
a full cycle) — no psum anywhere.

Sparsity: the per-(shard, band) block metadata is built once on the host
by column-slicing each query shard's CSR to the band (rebased block
columns), so strictly-empty pairs (future bands under causality) cost one
kernel pass whose programs all exit at once.
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

__all__ = ["RingFlashSpec", "ring_flash_attention"]

_NEG_LARGE = -1e30


def _slice_columns(topo: SparseTopology, windows) -> SparseTopology:
    """Host CSR column slice to one or more [lo, hi) windows, rebased and
    CONCATENATED in window order (window w's keys land at local columns
    ``sum(len of earlier windows) + (c - lo_w)``). One window = a
    contiguous band; two = a zigzag chunk pair."""
    if not windows:
        raise ValueError("_slice_columns needs at least one [lo, hi) "
                         "window (nbands >= 1 everywhere in the ring)")
    ro, ci = topo.row_offsets, topo.column_indices
    offs = np.zeros(topo.m + 1, np.int32)
    cols = []
    bases = np.cumsum([0] + [hi - lo for lo, hi in windows])
    for r in range(topo.m):
        cc = ci[ro[r]: ro[r + 1]]
        parts = [cc[(cc >= lo) & (cc < hi)] - lo + bases[w]
                 for w, (lo, hi) in enumerate(windows)]
        cc = np.concatenate(parts)
        cols.append(cc)
        offs[r + 1] = offs[r] + len(cc)
    cat = (np.concatenate(cols).astype(np.int32) if offs[-1]
           else np.zeros(0, np.int32))
    return SparseTopology(topo.m, int(bases[-1]), offs, cat)


class RingFlashSpec:
    """Static bundle: row partition + per-(shard, band) flash metadata.

    Stacked host arrays are ``[ndev, nbands, ...]`` — sharded over the
    mesh axis on dim 0, indexed by the (device-dependent) band id inside
    the scan. Requires the key padding to split evenly into bands
    (``n_pad % (ndev * bk) == 0``) and a natural-order partition
    (``RowPartition(balance=False)`` — a balanced permutation scatters
    query rows and destroys the band structure causality relies on).
    """

    def __init__(self, part: RowPartition, *, bm: int = 128,
                 bk: int = 128, mesh: Optional[Mesh] = None,
                 axis: str = "sp"):
        if not (np.array_equal(part.perm, np.arange(len(part.perm)))
                or getattr(part, "zigzag", False)):
            # a serpentine-balanced permutation scatters query rows
            # across shards; the band metadata would silently compute
            # the WRONG attention (confirmed: max err ~2 vs the dense
            # oracle). The two supported layouts are natural-order and
            # zigzag (whose q/out boundary runs through shard_queries /
            # unshard_output below).
            raise ValueError(
                "ring attention requires a natural-order partition "
                "(RowPartition(..., balance=False)) or the zigzag "
                "load-balanced one (RowPartition(..., zigzag=True) + "
                "spec.shard_queries/unshard_output)")
        self.part = part
        self.mesh, self.axis = mesh, axis
        self.bm, self.bk = bm, bk
        ndev = part.ndev
        v0 = part.shards[0].block(bm, bk)
        self.mb, self.m_pad_loc = v0.mb, v0.m_pad
        self.n_pad = v0.n_pad
        if self.n_pad % (ndev * bk):
            raise ValueError(
                f"key padding n_pad={self.n_pad} must divide into "
                f"{ndev} bands of whole {bk}-blocks")
        self.n_loc = self.n_pad // ndev
        self.kb_loc = self.n_loc // bk

        # zigzag partitions zigzag the KEY shards too: band j = key
        # chunks j and (2*ndev-1-j) of 2*ndev contiguous chunks. This is
        # what actually balances the LOCKSTEP schedule — with contiguous
        # bands, band 0 is full work for almost every device and the
        # per-step max stays one full band (eff ~0.56 measured on the
        # block counts); with chunk-pair bands every (device, band) cell
        # is exactly 2 half-chunk interactions (+diagonal halves), so the
        # per-step max equals the mean.
        self.kv_zigzag = bool(getattr(part, "zigzag", False))
        if self.kv_zigzag:
            if self.n_loc % (2 * bk):
                raise ValueError(
                    f"zigzag ring needs key half-chunks of whole "
                    f"{bk}-blocks: n_pad={self.n_pad} over {ndev} "
                    f"devices gives band {self.n_loc}, not divisible "
                    f"by 2*bk={2 * bk}")
            half_k = self.n_loc // 2

            def windows(b):
                c2 = 2 * ndev - 1 - b
                return [(b * half_k, (b + 1) * half_k),
                        (c2 * half_k, (c2 + 1) * half_k)]
        else:
            def windows(b):
                return [(b * self.n_loc, (b + 1) * self.n_loc)]

        metas = []
        for d in range(ndev):
            shard = part.shards[d]
            for b in range(ndev):
                sliced = _slice_columns(shard, windows(b))
                view = sliced.block(bm, bk)
                metas.append(fs.build_flash_bwd_meta([view]))

        self.max_bpr = max(max(m["max_bpr"] for m in metas), 1)
        self.max_bpc = max(max(m["max_bpc"] for m in metas), 1)
        npart = max(max(m["pmask"].shape[1] for m in metas), 1)

        def stack(key, rows, maxlen):
            out = np.zeros((ndev * ndev, rows * maxlen), np.int32)
            for i, m in enumerate(metas):
                a = m[key][0]
                len_d = a.shape[0] // rows
                pad = np.zeros((rows, maxlen), np.int32)
                pad[:, :len_d] = a.reshape(rows, len_d)
                if 0 < len_d < maxlen and key in ("block_cols", "t_src_i",
                                                  "mask_slot",
                                                  "t_mask_slot"):
                    pad[:, len_d:] = pad[:, len_d - 1: len_d]
                out[i] = pad.reshape(-1)
            return out.reshape(ndev, ndev, rows * maxlen)

        self.block_cols = stack("block_cols", self.mb, self.max_bpr)
        self.mask_slot = stack("mask_slot", self.mb, self.max_bpr)
        self.is_partial_ = stack("is_partial", self.mb, self.max_bpr)
        self.nblocks = np.stack(
            [m["nblocks"][0] for m in metas]).reshape(ndev, ndev, self.mb)
        self.t_src_i = stack("t_src_i", self.kb_loc, self.max_bpc)
        self.t_mask_slot = stack("t_mask_slot", self.kb_loc, self.max_bpc)
        self.t_is_partial = stack("t_is_partial", self.kb_loc,
                                  self.max_bpc)
        self.t_nblocks = np.stack(
            [m["t_nblocks"][0] for m in metas]).reshape(ndev, ndev,
                                                        self.kb_loc)
        self.pmask = np.zeros((ndev, ndev, npart, bm, bk), np.float32)
        for i, m in enumerate(metas):
            d, b = divmod(i, ndev)
            self.pmask[d, b, : m["pmask"].shape[1]] = m["pmask"][0]

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    # -- boundary sharding helpers ----------------------------------------

    def _zig_shard(self, x, n_total, zig):
        """``x [R, s, hd]`` -> ``[ndev, R, n_total//ndev, hd]``; zigzag =
        two contiguous chunks per device (chunk ``d`` + mirror
        ``2*ndev-1-d``) — reshapes and one axis reverse, never an
        element gather on the value layout."""
        ndev = self.part.ndev
        R, s, hd = x.shape
        xp = jnp.zeros((R, n_total, hd), x.dtype).at[:, :s].set(x)
        if zig:
            half = n_total // (2 * ndev)
            xc = xp.reshape(R, 2 * ndev, half, hd)
            top = xc[:, :ndev]                     # chunk d
            bot = xc[:, ndev:][:, ::-1]            # chunk 2*ndev-1-d
            xs = jnp.concatenate([top, bot], axis=2)
        else:
            xs = xp.reshape(R, ndev, n_total // ndev, hd)
        return xs.transpose(1, 0, 2, 3)

    def _zig_unshard(self, x_sh, s, zig):
        ndev = self.part.ndev
        _, R, n_loc, hd = x_sh.shape
        o = x_sh.transpose(1, 0, 2, 3)             # [R, ndev, n_loc, hd]
        if zig:
            half = n_loc // 2
            top = o[:, :, :half]                   # chunks 0..ndev-1
            bot = o[:, :, half:][:, ::-1]          # chunks ndev..2ndev-1
            o = jnp.concatenate([top, bot], axis=1)
            o = o.reshape(R, 2 * ndev * half, hd)
        else:
            o = o.reshape(R, ndev * n_loc, hd)
        return o[:, :s]

    def shard_queries(self, q):
        """``q [R, s, hd]`` (natural row order) -> the partition's
        query-sharded layout ``[ndev, R, m_loc, hd]``."""
        return self._zig_shard(q, self.part.m_loc * self.part.ndev,
                               getattr(self.part, "zigzag", False))

    def shard_keys(self, k):
        """``k [R_kv, s, hd]`` -> key-sharded ``[ndev, R_kv, n_loc,
        hd]``: contiguous bands for natural partitions, chunk-pair bands
        for zigzag ones (the load-balanced schedule). Pads the sequence
        to ``n_pad`` globally first (the short-shard misalignment guard
        below)."""
        return self._zig_shard(k, self.n_pad, self.kv_zigzag)

    def unshard_output(self, out_sh, s: Optional[int] = None):
        """Inverse of ``shard_queries``: ``[ndev, R, m_loc, hd]`` ->
        ``[R, s, hd]`` in natural row order (slice-shaped, no gather)."""
        return self._zig_unshard(
            out_sh, s if s is not None else self.part.topo.m,
            getattr(self.part, "zigzag", False))

    def unshard_kv(self, kv_sh, s: Optional[int] = None):
        """Inverse of ``shard_keys`` (use on dk/dv too — gradients come
        back in the same key-sharded layout)."""
        return self._zig_unshard(
            kv_sh, s if s is not None else self.part.topo.n,
            self.kv_zigzag)

    def ring_compute_balance(self) -> dict:
        """Compute-side ring efficiency from the ACTUAL per-(shard, band)
        block counts the kernels will run: the scan is lockstep (ppermute
        barrier per step), so step ``t`` costs the max over devices of
        band ``(d - t) % ndev``'s blocks, and
        ``efficiency = total / (ndev * wall)``. Contiguous causal
        partitions sit at ~0.5 (early devices idle while the last does a
        full band every step); zigzag rebalances to ~1."""
        ndev = self.part.ndev
        work = self.nblocks.sum(axis=2)            # [ndev, nbands]
        wall = 0
        for t in range(ndev):
            wall += max(work[d, (d - t) % ndev] for d in range(ndev))
        total = int(work.sum())
        return {
            "total_blocks": total,
            "wall_blocks": int(wall),
            "per_device_blocks": work.sum(axis=1).tolist(),
            "efficiency": total / max(ndev * wall, 1),
        }


def _meta(spec):
    return _device_arrays(
        spec, "_ring_meta_dev",
        lambda: {k: getattr(spec, k) for k in (
            "block_cols", "nblocks", "mask_slot", "is_partial_",
            "t_src_i", "t_nblocks", "t_mask_slot", "t_is_partial",
            "pmask")})


def _band_take(meta, band):
    """Select one band's metadata (local arrays are [1, nbands, ...])."""
    return {k: jax.lax.dynamic_index_in_dim(v[0], band, axis=0,
                                            keepdims=True)
            for k, v in meta.items()}


def _ring_fwd_local(spec, group, meta_loc, q, k0, v0):
    """Inside shard_map: q [1, R, m_pad_loc, hd_pad] (pre-scaled),
    k0/v0 [1, R_kv, n_loc, hd_pad] (own band). Returns (out, M, L)
    local plus nothing rotated (bands return home).

    Each ring step runs the flash forward over the current band
    (``flash_sparse_ring_band_fwd``) and folds it into the carried
    unnormalised accumulator + packed stats by the online-softmax merge."""
    x = spec.axis
    ndev = spec.part.ndev
    d = jax.lax.axis_index(x)
    q0 = q[0]
    R = q0.shape[0]
    hd_pad = q0.shape[-1]
    fwd = [(j, (j + 1) % ndev) for j in range(ndev)]

    def step(carry, t):
        k_cur, v_cur, acc, st = carry
        band = jax.lax.rem(d - t + ndev, ndev)
        # Issue band t+1's rotation BEFORE the kernel consumes band t:
        # the ppermutes read only the carry (never the kernel output), so
        # the compiled program has no serializing dependency between the
        # collective and the flash kernel — XLA's async collectives can
        # put the transfer in flight while the kernel works
        # (tests/test_overlap.py asserts the dataflow independence).
        k_nxt = jax.lax.ppermute(k_cur, x, fwd)
        v_nxt = jax.lax.ppermute(v_cur, x, fwd)
        acc, st = fs.flash_sparse_ring_band_fwd(
            band[None].astype(jnp.int32),
            meta_loc["block_cols"][0], meta_loc["nblocks"][0],
            meta_loc["mask_slot"][0], meta_loc["is_partial_"][0],
            meta_loc["pmask"][0],
            q0, k_cur, v_cur, acc, st,
            R=R, mb=spec.mb, max_bpr=spec.max_bpr,
            bm=spec.bm, bk=spec.bk, group=group)
        return (k_nxt, v_nxt, acc, st), None

    st0 = jnp.zeros((R, spec.m_pad_loc, 128), jnp.float32)
    st0 = st0.at[:, :, 0].set(_NEG_LARGE)
    init = (k0[0], v0[0],
            jnp.zeros((R, spec.m_pad_loc, hd_pad), jnp.float32),
            st0)
    (k_end, v_end, acc, st), _ = jax.lax.scan(
        step, init, jnp.arange(ndev))
    M = st[:, :, :1]
    L = st[:, :, 1:2]
    out = acc / jnp.maximum(L, 1e-30)
    return out[None], M[None], L[None]


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


def _fwd(spec, group, q_p, k_p, v_p):
    x = spec.axis
    meta_keys = list(_meta(spec).keys())
    meta_vals = [
        _meta(spec)[k] for k in meta_keys]

    def local(*args):
        meta_loc = dict(zip(meta_keys, args[: len(meta_keys)]))
        q, kk, vv = args[len(meta_keys):]
        return _ring_fwd_local(spec, group, meta_loc, q, kk, vv)

    fn = _smap(spec, local,
               in_specs=tuple(P(x) for _ in meta_keys) + (P(x), P(x), P(x)),
               out_specs=(P(x), P(x), P(x)))
    return fn(*meta_vals, q_p, k_p, v_p)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 4))
def _ring(spec, q_p, k_p, v_p, group):
    out, _, _ = _fwd(spec, group, q_p, k_p, v_p)
    return out


def _ring_f(spec, q_p, k_p, v_p, group):
    out, M, L = _fwd(spec, group, q_p, k_p, v_p)
    return out, (q_p, k_p, v_p, out, M, L)


def _ring_b(spec, group, res, g):
    q_p, k_p, v_p, out, M, L = res
    x = spec.axis
    ndev = spec.part.ndev
    R = q_p.shape[1]
    hd_pad = q_p.shape[-1]

    # stats layout the kernels expect: lane 0 = max, lane 1 = denom
    stats = jnp.concatenate(
        [M, L, jnp.zeros(M.shape[:3] + (126,), jnp.float32)], axis=3)
    d_rows = jnp.sum(g * out, axis=-1)
    dcoef = jnp.broadcast_to(d_rows[..., None], d_rows.shape + (128,))

    meta_keys = list(_meta(spec).keys())
    meta_vals = [_meta(spec)[k] for k in meta_keys]

    def local(*args):
        meta_loc = dict(zip(meta_keys, args[: len(meta_keys)]))
        q, kk, vv, gg, st, dc = args[len(meta_keys):]
        d = jax.lax.axis_index(x)
        q0, g0, st0, dc0 = q[0], gg[0], st[0], dc[0]
        fwd_perm = [(j, (j + 1) % ndev) for j in range(ndev)]

        def step(carry, t):
            k_cur, v_cur, dk_cur, dv_cur, dq_acc = carry
            band = jax.lax.rem(d - t + ndev, ndev)
            # K/V rotation depends only on the carry — in flight while
            # the backward kernels run. The dk/dv rotation below cannot
            # be hoisted: this band's gradient contribution must board
            # before the accumulator leaves (see comm_model overlap
            # factors: ring bwd is half-overlappable).
            k_nxt = jax.lax.ppermute(k_cur, x, fwd_perm)
            v_nxt = jax.lax.ppermute(v_cur, x, fwd_perm)
            mt = _band_take(meta_loc, band)
            dq_t = fs.flash_sparse_bwd_dq(
                mt["block_cols"], mt["nblocks"], mt["mask_slot"],
                mt["is_partial_"], mt["pmask"],
                q0, k_cur, v_cur, g0, st0, dc0,
                R=R, heads=R, mb=spec.mb, max_bpr=spec.max_bpr,
                bm=spec.bm, bk=spec.bk, group=group)
            dk_t, dv_t = fs.flash_sparse_bwd_dkv(
                mt["t_src_i"], mt["t_nblocks"], mt["t_mask_slot"],
                mt["t_is_partial"], mt["pmask"],
                q0, k_cur, v_cur, g0, st0, dc0,
                R=R, heads=R, kb=spec.kb_loc, max_bpc=spec.max_bpc,
                bm=spec.bm, bk=spec.bk, group=group)
            dk_t = dk_t.reshape(R // group, group,
                                *dk_t.shape[1:]).sum(axis=1)
            dv_t = dv_t.reshape(R // group, group,
                                *dv_t.shape[1:]).sum(axis=1)
            dk_cur = dk_cur + dk_t
            dv_cur = dv_cur + dv_t
            dq_acc = dq_acc + dq_t
            # rotate the accumulated gradient with its band — after the
            # full cycle each band's dk/dv is home
            dk_nxt = jax.lax.ppermute(dk_cur, x, fwd_perm)
            dv_nxt = jax.lax.ppermute(dv_cur, x, fwd_perm)
            return (k_nxt, v_nxt, dk_nxt, dv_nxt, dq_acc), None

        R_kv = kk.shape[1]
        init = (kk[0], vv[0],
                jnp.zeros((R_kv, spec.n_loc, hd_pad), jnp.float32),
                jnp.zeros((R_kv, spec.n_loc, hd_pad), jnp.float32),
                jnp.zeros((R, spec.m_pad_loc, hd_pad), jnp.float32))
        (k_end, v_end, dk, dv, dq), _ = jax.lax.scan(
            step, init, jnp.arange(ndev))
        return dq[None], dk[None], dv[None]

    sh = tuple(P(x) for _ in meta_keys)
    dq, dk, dv = _smap(
        spec, local,
        in_specs=sh + (P(x), P(x), P(x), P(x), P(x), P(x)),
        out_specs=(P(x), P(x), P(x)),
    )(*meta_vals, q_p, k_p, v_p, g, stats, dcoef)
    # dq is w.r.t. the PRE-SCALED q_p (the public fn scales outside)
    return dq.astype(q_p.dtype), dk.astype(k_p.dtype), dv.astype(v_p.dtype)


_ring.defvjp(_ring_f, _ring_b)


def ring_flash_attention(spec: RingFlashSpec, q_sh, k_sh, v_sh,
                         scale=None, group: int = 1):
    """Ring sparse flash attention over the spec's mesh axis.

    ``q_sh [ndev, R, s_loc_q, hd]`` query-sharded (natural order);
    ``k_sh, v_sh [ndev, R_kv, s_loc_k, hd]`` key-sharded, with ``R_kv =
    R // group`` (GQA). Peak per-device K/V is ONE band; no psum in
    either direction. Returns query-sharded ``[ndev, R, s_loc_q, hd]``.
    Use for full-causal (or otherwise full-span) topologies; banded
    masks are cheaper through ``flash_attention_kv_sharded``."""
    ndev, R = q_sh.shape[0], q_sh.shape[1]
    if ndev != spec.part.ndev:
        raise ValueError(f"q ndev {ndev} != partition {spec.part.ndev}")
    if group < 1 or R % group:
        raise ValueError(f"group {group} must divide replicas {R}")
    R_kv = k_sh.shape[1]
    if R_kv != R // group or v_sh.shape[1] != R_kv:
        raise ValueError(
            f"k/v replicas {R_kv}/{v_sh.shape[1]} != R // group "
            f"{R // group}")
    if k_sh.shape[2] != spec.n_loc or v_sh.shape[2] != spec.n_loc:
        # the band metadata addresses global key row 128*b + c at buffer
        # row c, so each shard must carry EXACTLY its n_loc-row band —
        # a short shard (s not a multiple of ndev*bk) silently misaligns
        # every band (confirmed: 0.18 max err at s=1000). Pad the keys
        # GLOBALLY to n_pad first, then shard.
        raise ValueError(
            f"per-device key rows {k_sh.shape[2]} != band {spec.n_loc}; "
            "pad the sequence to n_pad globally, then shard")
    hd = q_sh.shape[-1]
    hd_pad = hd
    scale = float(scale) if scale is not None else float(hd) ** -0.5

    q_p = jnp.zeros((ndev, R, spec.m_pad_loc, hd_pad), q_sh.dtype)
    q_p = q_p.at[:, :, : q_sh.shape[2], :hd].set(q_sh * scale)
    k_p = jnp.zeros((ndev, R_kv, spec.n_loc, hd_pad), k_sh.dtype)
    k_p = k_p.at[:, :, : k_sh.shape[2], :hd].set(k_sh)
    v_p = jnp.zeros((ndev, R_kv, spec.n_loc, hd_pad), v_sh.dtype)
    v_p = v_p.at[:, :, : v_sh.shape[2], :hd].set(v_sh)

    out = _ring(spec, q_p, k_p, v_p, int(group))
    return out[:, :, : q_sh.shape[2], :hd]
