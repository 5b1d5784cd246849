"""Sharded COMPRESSED (true-BSR) sparse ops: the memory-tight distributed
layout.

``ShardedPanelSpec`` (sharded_ops.py) stores each device's panel in the
block-ELL layout — every row-block padded to the *global* max blocks per
row-block, so a skewed topology (one dense row among sparse ones) inflates
every device's values to ``mb * max_bpr`` tiles. This module shards the
COMPRESSED layout instead (``blocking.CompressedView``: blocks stored
back-to-back behind per-row-block offsets): each device's panel is
``[G + 1, bm, bk]`` where ``G`` is the max *total* blocks on any device —
memory tracks the actual nonzero tiles, not the worst row.

Same closed, differentiable algebra as the ELL sharded ops (spmm /
spmm_t / sddmm / softmax and the attention chain); all per-device
metadata (offsets, block columns, block->row map, transpose lists) is
stacked device-varying data read by the compressed block ops. Softmax is
a segment reduction over the ragged block->row-block map, computed with
jnp segment ops (communication-free; rows never leave their device).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops._common import round_up as _round_up
from ..ops._common import tile_n as _tile_n
from ..ops.pallas import bsr_compressed as _c
from ..ops.panel_api import _view as _panel_view
from ..ops.panel_api import values_to_panel_np
from .partition import RowPartition

__all__ = [
    "ShardedCompressedSpec",
    "sharded_spmm_c",
    "sharded_spmm_t_c",
    "sharded_sddmm_c",
    "sharded_softmax_c",
    "sparse_attention_sharded_c",
]

_NEG_LARGE = -1e30


def _device_meta(spec):
    """The spec's block metadata as cached DEVICE arrays
    (``_common.device_arrays``): under a surrounding ``jit`` the arrays
    enter as hoisted runtime buffers, not HLO literals. The ``mask``
    alone is values-sized (``[ndev, G+1, bm, bk]`` f32); baked into the
    program as constants it would slow every compile."""
    from ..ops._common import device_arrays

    return device_arrays(
        spec, "_device_meta_cache",
        lambda: {k: getattr(spec, k)
                 for k in ("block_offsets", "block_cols", "block_rows",
                           "mask", "t_gblk", "t_rows", "t_nblocks")})


class ShardedCompressedSpec:
    """Static bundle: partition + compressed block metadata stacked over
    devices (common ``G = max total blocks per device``)."""

    def __init__(self, part: RowPartition, *, bm: int = 128, bk: int = 128,
                 mesh: Optional[Mesh] = None, axis: str = "x"):
        self.part = part
        self.bm, self.bk = bm, bk
        self.mesh, self.axis = mesh, axis
        views = [_panel_view(s, bm, bk, compressed=True)
                 for s in part.shards]
        self.views = views
        v0 = views[0]
        self.mb, self.kb = v0.mb, v0.kb
        self.m_pad_loc, self.n_pad = v0.m_pad, v0.n_pad
        G = max(v.num_blocks for v in views)
        self.num_blocks = G
        self.max_bpr = max(v.max_bpr for v in views)

        ndev = part.ndev
        offs = np.zeros((ndev, self.mb + 1), np.int32)
        cols = np.zeros((ndev, G + 1), np.int32)
        rows = np.zeros((ndev, G + 1), np.int32)
        mask = np.zeros((ndev, G + 1, bm, bk), np.float32)
        for d, v in enumerate(views):
            offs[d] = v.block_offsets
            nb = v.num_blocks
            cols[d, : nb + 1] = v.block_cols
            rows[d, : nb + 1] = v.block_rows
            # pad slots repeat the last id
            cols[d, nb + 1:] = v.block_cols[nb]
            rows[d, nb + 1:] = v.block_rows[nb]
            mask[d, : nb] = v.mask[: nb]
        self.block_offsets, self.block_cols = offs, cols
        self.block_rows, self.mask = rows, mask

        # transposed metadata: per-device dump ids remapped to the common G
        metas = [v.transpose_meta() for v in views]
        self.max_bpc = max(ts.shape[1] for _, ts in metas)
        tg = np.zeros((ndev, self.kb * self.max_bpc), np.int32)
        tr = np.zeros((ndev, self.kb * self.max_bpc), np.int32)
        tn = np.zeros((ndev, self.kb), np.int32)
        for d, (tnb, tsrc) in enumerate(metas):
            pad = np.zeros((self.kb, self.max_bpc, 2), np.int32)
            pad[:, :, 0] = self.num_blocks
            pad[:, : tsrc.shape[1]] = tsrc
            pad[:, :, 0][pad[:, :, 0] == views[d].num_blocks] = G
            for j in range(self.kb):
                nb = int(tnb[j])
                if 0 < nb < self.max_bpc:
                    pad[j, nb:] = pad[j, nb - 1]
            tg[d] = pad[:, :, 0].reshape(-1)
            tr[d] = pad[:, :, 1].reshape(-1)
            tn[d] = tnb
        self.t_gblk, self.t_rows, self.t_nblocks = tg, tr, tn

    @property
    def panel_shape(self):
        """Per-device compressed panel shape (without the ndev axis)."""
        return (self.num_blocks + 1, self.bm, self.bk)

    def stack_values(self, values) -> np.ndarray:
        """Global CSR values -> stacked compressed panels
        ``[ndev, G + 1, bm, bk]`` (host-side, boundary only)."""
        part, topo = self.part, self.part.topo
        ro = topo.row_offsets
        out = np.zeros((part.ndev,) + self.panel_shape, np.float32)
        for d, shard in enumerate(part.shards):
            rws = part.perm[d * part.m_loc: (d + 1) * part.m_loc]
            vals = np.concatenate(
                [np.asarray(values)[ro[r]: ro[r + 1]]
                 for r in rws if r < topo.m]
                or [np.zeros(0, np.float32)])
            v = np.zeros(shard.nnz_pad, np.float32)
            v[: len(vals)] = vals
            p = values_to_panel_np(shard, v, self.bm, self.bk,
                                   compressed=True)
            out[d, : p.shape[0]] = p
        return out

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


# ---------------------------------------------------------------------------
# Local (per-shard) impls; leading dim 1 inside shard_map.
# ---------------------------------------------------------------------------


def _local_spmm_c(spec, offs, cols, panel, dense, q_pad):
    return _c.bsr_spmm_panel_c(
        offs[0], cols[0], panel[0], dense,
        jnp.zeros((spec.m_pad_loc, 1), jnp.float32),
        mb=spec.mb, max_bpr=spec.max_bpr, num_blocks=spec.num_blocks,
        bm=spec.bm, bk=spec.bk, bn=_tile_n(q_pad),
    )[None]


def _local_spmm_t_c(spec, tg, tr, tn, panel, g):
    out = _c.bsr_spmm_t_panel_c(
        tg[0], tr[0], tn[0], panel[0], g[0],
        kb=spec.kb, max_bpc=spec.max_bpc, num_blocks=spec.num_blocks,
        bm=spec.bm, bk=spec.bk,
    )
    return jax.lax.psum(out, spec.axis)[None]


def _local_sddmm_c(spec, offs, cols, mask, lhs, rhs, d_pad):
    # slots in (num_blocks_d, G) lie past this device's offsets: the op
    # leaves them zero
    return _c.bsr_sddmm_panel_c(
        offs[0], cols[0], lhs[0], rhs, mask[0],
        mb=spec.mb, max_bpr=spec.max_bpr, num_blocks=spec.num_blocks,
        bm=spec.bm, bk=spec.bk,
    )[None]


def _seg_softmax(mask, rows, p, mb, bm):
    """Masked row softmax over the ragged block->row-block map (jnp
    segment ops; communication-free)."""
    v = jnp.where(mask != 0, p, _NEG_LARGE)
    bmax = jnp.max(v, axis=2)                                   # [G+1, bm]
    row_max = jax.ops.segment_max(bmax, rows, num_segments=mb)  # [mb, bm]
    row_max = jnp.maximum(row_max, _NEG_LARGE)
    e = jnp.where(mask != 0, jnp.exp(v - row_max[rows][:, :, None]), 0.0)
    bsum = jnp.sum(e, axis=2)
    denom = jax.ops.segment_sum(bsum, rows, num_segments=mb)
    denom = jnp.maximum(denom[rows][:, :, None], jnp.finfo(p.dtype).tiny)
    return e / denom


def _pad2(x, nrows, ncols):
    out = jnp.zeros((nrows, ncols), x.dtype)
    return out.at[: x.shape[0], : x.shape[1]].set(x)


def _pad3(spec, x):
    d_pad = _round_up(max(x.shape[-1], 1), 128)
    out = jnp.zeros((x.shape[0], spec.m_pad_loc, d_pad), x.dtype)
    return out.at[:, : x.shape[1], : x.shape[2]].set(x)


def _smap(spec, fn, in_specs, out_specs):
    return jax.shard_map(
        fn, mesh=spec.mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )


# ---------------------------------------------------------------------------
# custom_vjp sharded ops (global views: [ndev, ...] stacked operands).
# ---------------------------------------------------------------------------


def _raw_spmm_c(spec, panels, dense):
    q = dense.shape[-1]
    q_pad = _round_up(max(q, 1), 128)
    dense_p = _pad2(dense, spec.n_pad, q_pad)
    meta = _device_meta(spec)
    offs, cols = meta["block_offsets"], meta["block_cols"]
    x = spec.axis
    fn = _smap(
        spec,
        lambda o, c, p, dn: _local_spmm_c(spec, o, c, p, dn, q_pad),
        in_specs=(P(x), P(x), P(x), P(None, None)),
        out_specs=P(x),
    )
    return fn(offs, cols, panels, dense_p)


def _raw_spmm_t_c(spec, panels, g_sh):
    q = g_sh.shape[-1]
    g_sh = _pad3(spec, g_sh)
    meta = _device_meta(spec)
    tg, tr, tn = meta["t_gblk"], meta["t_rows"], meta["t_nblocks"]
    x = spec.axis
    fn = _smap(
        spec,
        lambda a, b, c, p, g: _local_spmm_t_c(spec, a, b, c, p, g),
        in_specs=(P(x), P(x), P(x), P(x), P(x)),
        out_specs=P(x),
    )
    out = fn(tg, tr, tn, panels, g_sh)
    return out[0][:, :q]


def _raw_sddmm_c(spec, lhs_sh, rhs):
    d = rhs.shape[-1]
    d_pad = _round_up(max(d, 1), 128)
    rhs_p = _pad2(rhs, spec.n_pad, d_pad)
    lhs_sh = _pad3(spec, lhs_sh)
    meta = _device_meta(spec)
    offs, cols, mask = (meta["block_offsets"], meta["block_cols"],
                        meta["mask"])
    x = spec.axis
    fn = _smap(
        spec,
        lambda o, c, mk, l, r: _local_sddmm_c(spec, o, c, mk, l, r, d_pad),
        in_specs=(P(x), P(x), P(x), P(x), P(None, None)),
        out_specs=P(x),
    )
    return fn(offs, cols, mask, lhs_sh, rhs_p)


def _raw_softmax_c(spec, panels):
    meta = _device_meta(spec)
    mask, rows = meta["mask"], meta["block_rows"]
    x = spec.axis

    def local(mk, rw, p):
        return _seg_softmax(mk[0], rw[0], p[0], spec.mb, spec.bm)[None]

    fn = _smap(spec, local, in_specs=(P(x), P(x), P(x)), out_specs=P(x))
    return fn(mask, rows, panels)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sharded_spmm_c(spec, panels, dense):
    """``A_compressed @ dense`` row-sharded: panels ``[ndev, G+1, bm, bk]``
    x dense ``[n, q]`` -> ``[ndev, m_pad_loc, q_pad]``."""
    return _raw_spmm_c(spec, panels, dense)


def _spmm_c_fwd(spec, panels, dense):
    return _raw_spmm_c(spec, panels, dense), (panels, dense)


def _spmm_c_bwd(spec, res, g):
    panels, dense = res
    d_panels = _raw_sddmm_c(spec, g, dense)
    d_dense = _raw_spmm_t_c(spec, panels, g)
    return d_panels, d_dense[: dense.shape[0], : dense.shape[1]]


sharded_spmm_c.defvjp(_spmm_c_fwd, _spmm_c_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sharded_spmm_t_c(spec, panels, g_sh):
    """``A^T @ G`` with row-sharded ``G``; replicated ``[n, q]`` psum."""
    return _raw_spmm_t_c(spec, panels, g_sh)


def _spmm_t_c_fwd(spec, panels, g_sh):
    return _raw_spmm_t_c(spec, panels, g_sh), (panels, g_sh)


def _spmm_t_c_bwd(spec, res, ct):
    panels, g_sh = res
    d_panels = _raw_sddmm_c(spec, g_sh, ct)
    d_g = _raw_spmm_c(spec, panels, ct)
    return d_panels, d_g[:, : g_sh.shape[1], : g_sh.shape[-1]]


sharded_spmm_t_c.defvjp(_spmm_t_c_fwd, _spmm_t_c_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sharded_sddmm_c(spec, lhs_sh, rhs):
    """Sampled ``L @ R^T`` into sharded compressed panels."""
    return _raw_sddmm_c(spec, lhs_sh, rhs)


def _sddmm_c_fwd(spec, lhs_sh, rhs):
    return _raw_sddmm_c(spec, lhs_sh, rhs), (lhs_sh, rhs)


def _sddmm_c_bwd(spec, res, g_panels):
    lhs_sh, rhs = res
    d_lhs = _raw_spmm_c(spec, g_panels, rhs)
    d_rhs = _raw_spmm_t_c(spec, g_panels, lhs_sh)
    return (d_lhs[:, : lhs_sh.shape[1], : lhs_sh.shape[-1]],
            d_rhs[: rhs.shape[0], : rhs.shape[1]])


sharded_sddmm_c.defvjp(_sddmm_c_fwd, _sddmm_c_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sharded_softmax_c(spec, panels):
    """Ragged row softmax over sharded compressed panels."""
    return _raw_softmax_c(spec, panels)


def _sm_c_fwd(spec, panels):
    p = _raw_softmax_c(spec, panels)
    return p, p


def _sm_c_bwd(spec, p, g):
    meta = _device_meta(spec)
    rows, mask = meta["block_rows"], meta["mask"]
    x = spec.axis

    def local(rw, mk, pp, gg):
        # mask-select (not multiply): pad-slot cotangents are undefined
        pg = jnp.where(mk[0] != 0, pp[0] * gg[0], 0.0)
        rs = jax.ops.segment_sum(jnp.sum(pg, axis=2), rw[0],
                                 num_segments=spec.mb)
        out = pp[0] * (gg[0] - rs[rw[0]][:, :, None])
        return jnp.where(mk[0] != 0, out, 0.0)[None]

    fn = _smap(spec, local, in_specs=(P(x), P(x), P(x), P(x)),
               out_specs=P(x))
    return (fn(rows, mask, p, g),)


sharded_softmax_c.defvjp(_sm_c_fwd, _sm_c_bwd)


def sparse_attention_sharded_c(spec, q, k, v, *,
                               scale: Optional[float] = None):
    """Sequence-sharded sparse attention on the COMPRESSED layout:
    SDDMM -> ragged softmax -> SpMM, query rows partitioned over the mesh
    axis. Same semantics as ``sparse_attention_sharded`` with the
    memory-tight per-device panels."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    q_pad = _pad3(spec, q)
    scores = sharded_sddmm_c(spec, q_pad, k)
    w = sharded_softmax_c(spec, scores * scale)
    ctx = sharded_spmm_c(spec, w, v)
    return ctx[:, : q.shape[1], :d]
