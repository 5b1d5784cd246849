"""Sharded sparse ops: shard_map over a mesh axis, row-partitioned operand.

Sharding layout (the BASELINE north-star design, SURVEY.md §5):

  * sparse operand: row-partitioned — device ``d`` owns ``RowPartition``
    shard ``d`` (its panel values + block metadata, all device-varying
    *data* the kernels read per program);
  * dense RHS / LHS activations: replicated (column-sharding composes on
    top via the outer ``jit`` sharding of the dense operand);
  * collectives: ``spmm`` and row-wise ``softmax``/``sddmm`` are
    communication-free (outputs stay row-sharded); only the transposed
    product (``A^T @ G`` — the dense gradient) ends in a ``psum`` over the interconnect.

Everything is differentiable: each op is a ``jax.custom_vjp`` whose
backward composes the same sharded kernels (same algebra as
``ops/panel_api.py``), so a whole training step stays inside one
``shard_map``-friendly ``jit``.

On the CPU the same code paths run the kernels' plain versions — the unit
suite exercises the full sharded algebra on an 8-device CPU mesh.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops._common import device_arrays as _device_arrays
from ..ops._common import round_up as _round_up
from ..ops._common import tile_n as _tile_n
from ..ops.pallas import bsr_sddmm as _sddmm_mod
from ..ops.pallas import bsr_spmm as _spmm_mod
from ..ops.pallas import bsr_spmm_t as _spmm_t_mod
from .partition import RowPartition

__all__ = [
    "ShardedPanelSpec",
    "sharded_spmm",
    "sharded_spmm_halo",
    "sharded_spmm_t",
    "sharded_sddmm",
    "sharded_softmax",
    "sparse_attention_sharded",
]

_NEG_LARGE = -1e30


class ShardedPanelSpec:
    """Static bundle: partition + block tiles + stacked kernel metadata.

    All stacked arrays are host numpy; they enter the computation as
    device-varying data sharded over the mesh axis.
    """

    def __init__(self, part: RowPartition, *, bm: int = 128, bk: int = 128,
                 mesh: Optional[Mesh] = None, axis: str = "x"):
        self.part = part
        self.bm, self.bk = bm, bk
        self.mesh, self.axis = mesh, axis
        # one implementation of the stacked-metadata convention
        # (repeat-padded slots stay inside the walked row):
        # blocking.stack_block_meta over the per-shard views
        from ..blocking import stack_block_meta

        views = [s.block(bm, bk) for s in part.shards]
        meta = stack_block_meta(views)
        self.views = views
        self.block_cols = meta["block_cols"]     # [ndev, mb*max_bpr]
        self.nblocks = meta["nblocks"]           # [ndev, mb]
        self.max_bpr = meta["max_bpr"]
        self.mask = meta["mask"]                 # [ndev, mb, max_bpr, bm, bk]
        self.t_src_i = meta["t_src_i"]
        self.t_src_s = meta["t_src_s"]
        self.t_nblocks = meta["t_nblocks"]
        self.max_bpc = meta["max_bpc"]
        v0 = views[0]
        self.mb, self.kb = v0.mb, v0.kb
        self.m_pad_loc, self.n_pad = v0.m_pad, v0.n_pad

    @property
    def panel_shape(self):
        """Per-device panel shape (without the ndev axis)."""
        return (self.mb, self.max_bpr, self.bm, self.bk)

    def stack_values(self, values) -> np.ndarray:
        """Global CSR values -> stacked panels [ndev, *panel_shape]."""
        return self.part.stacked_panel(values, self.bm, self.bk,
                                       self.max_bpr)

    def halo_extents(self, n_loc: int) -> tuple:
        """(lo, hi): max rows any device's CSR slice reaches BELOW/ABOVE its
        own ``n_loc``-row dense shard — the ragged-exchange size.

        Derived from the per-device touched column blocks: device ``d``
        owning dense rows ``[d*n_loc, (d+1)*n_loc)`` must fetch
        ``[min_col_block*bk, (max_col_block+1)*bk)``; the halo is the
        overhang, maximised over devices (uniform so shapes stay static).
        """
        cache = getattr(self, "_halo_extents", None)
        if cache is None:
            cache = {}
            self._halo_extents = cache
        if n_loc in cache:
            return cache[n_loc]
        lo = hi = 0
        for d in range(self.part.ndev):
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

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


# ---------------------------------------------------------------------------
# Local (per-shard) impls. Operands carry a leading ndev axis that shard_map
# maps over; inside the local function the leading dim is 1.
# ---------------------------------------------------------------------------


def _spec_meta(spec):
    """The spec's stacked block metadata as cached DEVICE arrays
    (``_common.device_arrays``: hoisted jit buffers, not HLO literals —
    the element-mask panels alone are values-sized)."""
    return _device_arrays(
        spec, "_device_meta",
        lambda: {k: getattr(spec, k)
                 for k in ("block_cols", "nblocks", "mask",
                           "t_src_i", "t_src_s", "t_nblocks")})


def _local_spmm(spec, cols, nblk, panel, dense, q_pad):
    return _spmm_mod.bsr_spmm_panel(
        cols[0], nblk[0], panel[0], dense,
        jnp.zeros((spec.m_pad_loc, 1), jnp.float32),
        mb=spec.mb, max_bpr=spec.max_bpr, kb=spec.kb,
        bm=spec.bm, bk=spec.bk, bn=_tile_n(q_pad),
    )[None]


def _local_spmm_t(spec, ti, ts, tn, panel, g):
    out = _spmm_t_mod.bsr_spmm_t_panel(
        ti[0], ts[0], tn[0], panel[0], g[0],
        kb=spec.kb, max_bpc=spec.max_bpc, mb=spec.mb,
        bm=spec.bm, bk=spec.bk,
    )
    return jax.lax.psum(out, spec.axis)[None]


def _local_sddmm(spec, cols, nblk, mask, lhs, rhs, d_pad):
    return _sddmm_mod.bsr_sddmm_panel(
        cols[0], nblk[0], lhs[0], rhs, mask[0],
        mb=spec.mb, max_bpr=spec.max_bpr,
        bm=spec.bm, bk=spec.bk, bd=min(d_pad, 128),
    )[None]


def _pad2(x, rows, cols_):
    out = jnp.zeros((rows, cols_), x.dtype)
    return out.at[: x.shape[0], : x.shape[1]].set(x)


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


# ---------------------------------------------------------------------------
# custom_vjp sharded ops (global views: [ndev, ...] stacked operands).
# ---------------------------------------------------------------------------


def _raw_spmm(spec, panels, dense):
    """panels [ndev, mb, max_bpr, bm, bk] x dense [n, q] ->
    [ndev, m_pad_loc, q_pad] (rows sharded, permuted order)."""
    q = dense.shape[-1]
    q_pad = _round_up(max(q, 1), 128)
    dense_p = _pad2(dense, spec.n_pad, q_pad)
    cols = _spec_meta(spec)["block_cols"]
    nblk = _spec_meta(spec)["nblocks"]
    x = spec.axis
    fn = _smap(
        spec,
        lambda c, nb, p, dn: _local_spmm(spec, c, nb, p, dn, q_pad),
        in_specs=(P(x), P(x), P(x), P(None, None)),
        out_specs=P(x),
    )
    return fn(cols, nblk, panels, dense_p)


def _raw_spmm_t(spec, panels, g_sh):
    """A^T @ G with G row-sharded [ndev, m_loc, q]; returns the replicated
    [n_pad, q] sum (psum over the mesh axis). ``g_sh`` is padded here to
    (m_pad_loc, multiple-of-128)."""
    q = g_sh.shape[-1]
    g_sh = _pad3(spec, g_sh)
    ti = _spec_meta(spec)["t_src_i"]
    ts = _spec_meta(spec)["t_src_s"]
    tn = _spec_meta(spec)["t_nblocks"]
    x = spec.axis
    fn = _smap(
        spec,
        lambda a, b, c, p, g: _local_spmm_t(spec, a, b, c, p, g),
        in_specs=(P(x), P(x), P(x), P(x), P(x)),
        out_specs=P(x),
    )
    out = fn(ti, ts, tn, panels, g_sh)  # [ndev, n_pad, q_pad] (all equal)
    return out[0][:, :q]


def _raw_sddmm(spec, lhs_sh, rhs):
    """lhs row-sharded [ndev, m_pad_loc, d_pad] x rhs [n, d] ->
    sharded panels [ndev, mb, max_bpr, bm, bk]."""
    d = rhs.shape[-1]
    d_pad = _round_up(max(d, 1), 128)
    rhs_p = _pad2(rhs, spec.n_pad, d_pad)
    lhs_sh = _pad3(spec, lhs_sh)
    cols = _spec_meta(spec)["block_cols"]
    nblk = _spec_meta(spec)["nblocks"]
    mask = _spec_meta(spec)["mask"]
    x = spec.axis
    fn = _smap(
        spec,
        lambda c, nb, mk, l, r: _local_sddmm(spec, c, nb, mk, l, r, d_pad),
        in_specs=(P(x), P(x), P(x), P(x), P(None, None)),
        out_specs=P(x),
    )
    return fn(cols, nblk, mask, lhs_sh, rhs_p)


def _raw_softmax(spec, panels):
    """Row softmax on sharded panels (communication-free)."""
    mask = _spec_meta(spec)["mask"]
    x = spec.axis

    def local(mk, p):
        v = jnp.where(mk != 0, p, _NEG_LARGE)
        row_max = jnp.maximum(jnp.max(v, axis=(2, 4), keepdims=True),
                              _NEG_LARGE)
        e = jnp.where(mk != 0, jnp.exp(v - row_max), 0.0)
        denom = jnp.sum(e, axis=(2, 4), keepdims=True)
        return e / jnp.maximum(denom, jnp.finfo(p.dtype).tiny)

    fn = _smap(spec, local, in_specs=(P(x), P(x)), out_specs=P(x))
    return fn(mask, panels)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sharded_spmm(spec, panels, dense):
    return _raw_spmm(spec, panels, dense)


def _sh_spmm_fwd(spec, panels, dense):
    return _raw_spmm(spec, panels, dense), (panels, dense)


def _sh_spmm_bwd(spec, res, g):
    panels, dense = res
    d_panels = _raw_sddmm(spec, g, dense)
    d_dense = _raw_spmm_t(spec, panels, g)
    d_dense = d_dense[: dense.shape[0], : dense.shape[1]]
    return d_panels, d_dense


sharded_spmm.defvjp(_sh_spmm_fwd, _sh_spmm_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sharded_spmm_t(spec, panels, g_sh):
    return _raw_spmm_t(spec, panels, g_sh)


def _sh_spmm_t_fwd(spec, panels, g_sh):
    return _raw_spmm_t(spec, panels, g_sh), (panels, g_sh)


def _sh_spmm_t_bwd(spec, res, ct):
    panels, g_sh = res
    d_panels = _raw_sddmm(spec, g_sh, ct)
    d_g = _raw_spmm(spec, panels, ct)
    return d_panels, d_g[:, : g_sh.shape[1], : g_sh.shape[-1]]


sharded_spmm_t.defvjp(_sh_spmm_t_fwd, _sh_spmm_t_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sharded_sddmm(spec, lhs_sh, rhs):
    return _raw_sddmm(spec, lhs_sh, rhs)


def _sh_sddmm_fwd(spec, lhs_sh, rhs):
    return _raw_sddmm(spec, lhs_sh, rhs), (lhs_sh, rhs)


def _sh_sddmm_bwd(spec, res, g_panels):
    lhs_sh, rhs = res
    d_lhs = _raw_spmm(spec, g_panels, rhs)[:, :, : lhs_sh.shape[-1]]
    d_rhs = _raw_spmm_t(spec, g_panels, lhs_sh)
    return d_lhs[:, : lhs_sh.shape[1]], d_rhs[: rhs.shape[0], : rhs.shape[1]]


sharded_sddmm.defvjp(_sh_sddmm_fwd, _sh_sddmm_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sharded_softmax(spec, panels):
    return _raw_softmax(spec, panels)


def _sh_sm_fwd(spec, panels):
    p = _raw_softmax(spec, panels)
    return p, p


def _sh_sm_bwd(spec, p, g):
    x = spec.axis

    def local(pp, gg):
        pg = pp * gg
        rs = jnp.sum(pg, axis=(2, 4), keepdims=True)
        return pp * (gg - rs)

    fn = _smap(spec, local, in_specs=(P(x), P(x)), out_specs=P(x))
    return (fn(p, g),)


sharded_softmax.defvjp(_sh_sm_fwd, _sh_sm_bwd)


def sparse_attention_sharded(spec, q, k, v, *, scale: Optional[float] = None):
    """Sequence-sharded sparse attention: SDDMM -> softmax -> SpMM with the
    score topology row-partitioned over the mesh axis.

    ``q [ndev, s_loc, d]`` row(=query)-sharded; ``k, v [s, d]`` replicated
    (the sparse generalisation of all-gather attention: every device keeps
    only its query band's CSR slice and reads the K/V columns its nonzeros
    touch). Output is query-sharded ``[ndev, s_loc, d]``.
    """
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    q_pad = _pad3(spec, q)
    scores = sharded_sddmm(spec, q_pad, k)
    w = sharded_softmax(spec, scores * scale)
    ctx = sharded_spmm(spec, w, v)
    return ctx[:, : q.shape[1], :d]


def _pad3(spec, x):
    """Pad row-sharded [ndev, s_loc, d] to [ndev, m_pad_loc, d_pad]."""
    d_pad = _round_up(max(x.shape[-1], 1), 128)
    out = jnp.zeros((x.shape[0], spec.m_pad_loc, d_pad), x.dtype)
    return out.at[:, : x.shape[1], : x.shape[2]].set(x)


# ---------------------------------------------------------------------------
# Column-sharded-RHS variant: halo exchange of dense rows.
# ---------------------------------------------------------------------------


def _halo_steps(lo: int, hi: int, n_loc: int):
    return -(-lo // n_loc), -(-hi // n_loc)


def _halo_assemble(spec, d_loc, n_loc, q_pad, lo, hi, *,
                   include_own=True):
    """Inside ``shard_map``: build the globally-indexed ``[n_pad + n_loc,
    q_pad]`` dense buffer holding this device's own shard (unless
    ``include_own=False`` — the overlap split's halo-only buffer: the
    interior pass reads the local shard directly, so every write here is
    a ppermute landing with no kernel dependency) plus only the
    ``lo``/``hi`` halo rows, received via *sliced* ``ppermute`` shifts —
    comm volume is exactly ``lo + hi`` rows per device instead of the
    ``(ndev-1) * n_loc`` of a dense all_gather. The trailing ``n_loc``
    scratch rows absorb wrapped edge-device writes (their metadata never
    reads them). Built from differentiable ops only, so the backward pass
    is ``jax.vjp`` of this function (reverse ppermutes, same volume).
    One body for both variants so the send-slice / wraparound arithmetic
    cannot diverge (flash_sharded._assemble_kv is the 3-D K/V twin)."""
    x = spec.axis
    ndev = spec.part.ndev
    me = jax.lax.axis_index(x)
    buf = jnp.zeros((spec.n_pad + n_loc, q_pad), d_loc.dtype)
    if include_own:
        buf = jax.lax.dynamic_update_slice(buf, d_loc,
                                           (me * n_loc, jnp.int32(0)))
    steps_lo, steps_hi = _halo_steps(lo, hi, n_loc)
    scratch = spec.n_pad
    for k in range(1, steps_lo + 1):
        take = min(n_loc, lo - (k - 1) * n_loc)
        send = d_loc[n_loc - take:, :]               # my bottom rows
        recv = jax.lax.ppermute(
            send, x, [(j, (j + k) % ndev) for j in range(ndev)])
        start = (me - k) * n_loc + (n_loc - take)
        start = jnp.where(me >= k, start, scratch)   # wrap -> scratch tail
        buf = jax.lax.dynamic_update_slice(buf, recv,
                                           (start, jnp.int32(0)))
    for k in range(1, steps_hi + 1):
        take = min(n_loc, hi - (k - 1) * n_loc)
        send = d_loc[:take, :]                       # my top rows
        recv = jax.lax.ppermute(
            send, x, [(j, (j - k) % ndev) for j in range(ndev)])
        start = (me + k) * n_loc
        start = jnp.where(me + k < ndev, start, scratch)
        buf = jax.lax.dynamic_update_slice(buf, recv,
                                           (start, jnp.int32(0)))
    return buf


def _local_spmm_t_nopsum(spec, ti, ts, tn, panel, g):
    """Per-device partial ``A_d^T @ G_d`` WITHOUT the psum (the ragged halo
    backward reduces it over the halo paths instead)."""
    return _spmm_t_mod.bsr_spmm_t_panel(
        ti[0], ts[0], tn[0], panel[0], g[0],
        kb=spec.kb, max_bpc=spec.max_bpc, mb=spec.mb,
        bm=spec.bm, bk=spec.bk,
    )


def _halo_plan(spec, n_loc):
    """(lo, hi) if the ragged exchange pays off, else None (dense
    all_gather). Ragged wins when the halo is smaller than gathering
    everyone else's shard."""
    lo, hi = spec.halo_extents(n_loc)
    if lo + hi >= (spec.part.ndev - 1) * n_loc:
        return None
    return lo, hi


def _halo_assemble_only(spec, d_loc, n_loc, q_pad, lo, hi):
    """Halo-ONLY assembly (the overlap split): see ``_halo_assemble``."""
    return _halo_assemble(spec, d_loc, n_loc, q_pad, lo, hi,
                          include_own=False)


def _ov_split_meta(spec, n_loc):
    """Interior/halo split of the stacked SpMM walk (host, cached per
    ``n_loc``). Interior block columns are REBASED to the local dense
    shard; halo columns stay global. ``slot_sel`` carries each sub-walk
    entry's canonical panel slot so values never move."""
    cache = getattr(spec, "_ov_spmm_np", None)
    if cache is None:
        cache = {}
        spec._ov_spmm_np = cache
    if n_loc in cache:
        return cache[n_loc]
    ndev = spec.part.ndev
    lob = n_loc // spec.bk
    rows_i, rows_h = [], []
    for d in range(ndev):
        cols = spec.block_cols[d].reshape(spec.mb, spec.max_bpr)
        nblk = spec.nblocks[d]
        per_i, per_h = [], []
        for i in range(spec.mb):
            ci, ch = [], []
            for s in range(int(nblk[i])):
                c = int(cols[i, s])
                if d * lob <= c < (d + 1) * lob:
                    ci.append((c - d * lob, s))
                else:
                    ch.append((c, s))
            per_i.append(ci)
            per_h.append(ch)
        rows_i.append(per_i)
        rows_h.append(per_h)

    def stack(rows):
        maxb = max(max((len(r) for r in per), default=0)
                   for per in rows)
        maxb = max(maxb, 1)
        cols = np.zeros((ndev, spec.mb, maxb), np.int32)
        sel = np.zeros((ndev, spec.mb, maxb), np.int32)
        nbl = np.zeros((ndev, spec.mb), np.int32)
        for d, per in enumerate(rows):
            for i, r in enumerate(per):
                nbl[d, i] = len(r)
                for s, (c, sl) in enumerate(r):
                    cols[d, i, s] = c
                    sel[d, i, s] = sl
                if 0 < len(r) < maxb:      # repeat-pad the last valid slot
                    cols[d, i, len(r):] = cols[d, i, len(r) - 1]
                    sel[d, i, len(r):] = sel[d, i, len(r) - 1]
        return {"cols": cols.reshape(ndev, -1),
                "sel": sel.reshape(ndev, -1), "nblk": nbl,
                "maxb": int(maxb)}

    out = {"i": stack(rows_i), "h": stack(rows_h)}
    cache[n_loc] = out
    return out


def _ov_spmm_dev_meta(spec, n_loc):
    meta = _ov_split_meta(spec, n_loc)
    return _device_arrays(
        spec, f"_ov_spmm_dev_{n_loc}",
        lambda: {f"{p}_{k}": meta[p][k] for p in ("i", "h")
                 for k in ("cols", "sel", "nblk")})


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sharded_spmm_halo(spec, panels, dense_sh):
    """Row-partitioned sparse x ROW-SHARDED dense RHS.

    ``dense_sh [ndev, n_loc, q]`` holds each device's band of the dense
    operand's rows (the BASELINE north-star layout: dense RHS sharded, not
    replicated). Each device fetches only the dense rows its CSR slice's
    column blocks touch: the per-device halo extents are precomputed from
    the block metadata (``ShardedPanelSpec.halo_extents``) and exchanged
    with sliced ``ppermute`` shifts (``_halo_assemble``) — comm volume
    ``lo + hi`` rows per device. Topologies whose halo would span the whole
    operand fall back to the dense ``all_gather``. Output is row-sharded
    ``[ndev, m_pad_loc, q_pad]``; the backward runs the same halo paths in
    reverse (vjp of the assembly) plus a psum-free local ``A^T G``.
    """
    return _raw_spmm_halo(spec, panels, dense_sh)


def _raw_spmm_halo(spec, panels, dense_sh):
    n_loc, q = dense_sh.shape[1], dense_sh.shape[-1]
    q_pad = _round_up(max(q, 1), 128)
    cols = _spec_meta(spec)["block_cols"]
    nblk = _spec_meta(spec)["nblocks"]
    x = spec.axis
    plan = _halo_plan(spec, n_loc)

    if plan is not None and n_loc % spec.bk == 0:
        # comm/compute-overlap split: the halo ppermutes feed ONLY the
        # halo pass; the interior pass reads the local shard — no
        # serializing dependency between the transfer and the interior
        # kernel work (tests/test_overlap.py asserts this on the jaxpr).
        meta = _ov_spmm_dev_meta(spec, n_loc)
        st = _ov_split_meta(spec, n_loc)

        def local_ov(ci, si, ni, ch, sh_, nh, p, d_loc):
            d2 = d_loc[0]
            if q_pad != q:
                d2 = jnp.concatenate(
                    [d2, jnp.zeros((n_loc, q_pad - q), d2.dtype)],
                    axis=-1)
            buf = _halo_assemble_only(spec, d2, n_loc, q_pad, *plan)
            out_i = _spmm_mod.bsr_spmm_panel_sel(
                ci[0], ni[0], si[0], p[0], d2,
                mb=spec.mb, max_bpr=st["i"]["maxb"],
                bm=spec.bm, bk=spec.bk, bn=_tile_n(q_pad))
            out_h = _spmm_mod.bsr_spmm_panel_sel(
                ch[0], nh[0], sh_[0], p[0], buf[: spec.n_pad],
                mb=spec.mb, max_bpr=st["h"]["maxb"],
                bm=spec.bm, bk=spec.bk, bn=_tile_n(q_pad))
            return (out_i + out_h)[None]

        fn = _smap(
            spec, local_ov,
            in_specs=(P(x),) * 8,
            out_specs=P(x),
        )
        return fn(meta["i_cols"], meta["i_sel"], meta["i_nblk"],
                  meta["h_cols"], meta["h_sel"], meta["h_nblk"],
                  panels, dense_sh)

    def local(c, nb, p, d_loc):
        d2 = d_loc[0]
        if q_pad != q:
            d2 = jnp.concatenate(
                [d2, jnp.zeros((n_loc, q_pad - q), d2.dtype)], axis=-1)
        if plan is None:
            d_full = jax.lax.all_gather(d2, x, tiled=True)   # [n, q_pad]
            ext = jnp.zeros((spec.n_pad, q_pad), d2.dtype)
            ext = jax.lax.dynamic_update_slice(ext, d_full, (0, 0))
        else:
            ext = _halo_assemble(spec, d2, n_loc, q_pad, *plan)[: spec.n_pad]
        return _local_spmm(spec, c, nb, p, ext, q_pad)

    fn = _smap(
        spec, local,
        in_specs=(P(x), P(x), P(x), P(x)),
        out_specs=P(x),
    )
    return fn(cols, nblk, panels, dense_sh)


def _sh_spmm_halo_fwd(spec, panels, dense_sh):
    return _raw_spmm_halo(spec, panels, dense_sh), (panels, dense_sh)


def _sh_spmm_halo_bwd(spec, res, g):
    panels, dense_sh = res
    ndev, n_loc, q = dense_sh.shape
    q_pad = g.shape[-1]
    plan = _halo_plan(spec, n_loc)
    if plan is None:
        # dense path: sddmm against the re-gathered rows; A^T g re-sharded
        d_full = jnp.reshape(dense_sh, (ndev * n_loc, q))
        d_panels = _raw_sddmm(spec, g, d_full)
        d_dense_full = _raw_spmm_t(spec, panels, g)[: ndev * n_loc, :q]
        return d_panels, jnp.reshape(d_dense_full, (ndev, n_loc, q))

    cols = _spec_meta(spec)["block_cols"]
    nblk = _spec_meta(spec)["nblocks"]
    mask = _spec_meta(spec)["mask"]
    ti = _spec_meta(spec)["t_src_i"]
    ts = _spec_meta(spec)["t_src_s"]
    tn = _spec_meta(spec)["t_nblocks"]
    x = spec.axis

    def local_bwd(c, nb, mk, a, b, t, p, d_loc, g_loc):
        d2 = d_loc[0]
        if q_pad != q:
            d2 = jnp.concatenate(
                [d2, jnp.zeros((n_loc, q_pad - q), d2.dtype)], axis=-1)
        ext, vjp_fn = jax.vjp(
            lambda dl: _halo_assemble(spec, dl, n_loc, q_pad, *plan), d2)
        d_panel = _sddmm_mod.bsr_sddmm_panel(
            c[0], nb[0], g_loc[0], ext[: spec.n_pad], mk[0],
            mb=spec.mb, max_bpr=spec.max_bpr,
            bm=spec.bm, bk=spec.bk, bd=min(q_pad, 128),
        )
        d_full = _local_spmm_t_nopsum(spec, a, b, t, p, g_loc)
        d_ext = jnp.zeros_like(ext)
        d_ext = jax.lax.dynamic_update_slice(d_ext, d_full, (0, 0))
        (d_d2,) = vjp_fn(d_ext)
        return d_panel[None], d_d2[None, :, :q]

    fn = _smap(
        spec, local_bwd,
        in_specs=(P(x),) * 9,
        out_specs=(P(x), P(x)),
    )
    d_panels, d_dense = fn(cols, nblk, mask, ti, ts, tn, panels, dense_sh, g)
    return d_panels, d_dense


sharded_spmm_halo.defvjp(_sh_spmm_halo_fwd, _sh_spmm_halo_bwd)
