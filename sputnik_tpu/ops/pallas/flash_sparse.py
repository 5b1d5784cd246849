"""Block-sparse flash attention ("sparse flash"): forward and backward.

The reference computes attention as three kernel dispatches with the score
matrix materialised in CSR form between them (SDDMM -> SparseSoftmax ->
SpMM, ``modules/sparse_attention.py:65-94``). The score traffic is the
whole cost of that chain, so these Pallas-Triton kernels fuse it in
FlashAttention-2 form:

  * forward — one program per ``(replica, query block)`` walks only the
    occupied key blocks of the mask topology (``block_cols``), computes
    each score tile, applies a numerically-stable online softmax (running
    max / denominator in registers) and accumulates the context; scores
    never reach device memory;
  * backward — two kernels recompute score tiles from the saved row stats:
    dq walks each query block's key blocks (the forward's walk), dk/dv
    walk each key block's query blocks through the transposed metadata
    (``build_flash_bwd_meta``) — the same no-value-movement trick as
    ``bsr_spmm_t``.

Masking is block-classified: fully-dense blocks (the vast majority for
causal / local-window topologies) need no element mask; *partial* blocks
read a tile of the compacted, deduplicated mask array ``pmask``.

Batched like ``batched_panel``: replica ``r`` reads its mask's metadata at
``r // heads`` and (GQA) its K/V replica at ``r // group``.

Row statistics travel as a stats array whose lane 0 is the running max and
lane 1 the denominator (``[R, M, 2]``; callers may pass wider arrays with
the same two leading lanes). Where the kernels do not serve
(``_common.route``), each entry runs its plain block-gather version.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .._common import route as _route

__all__ = ["flash_sparse_attention_fwd", "flash_sparse_bwd_dq",
           "flash_sparse_bwd_dkv", "flash_sparse_ring_band_fwd",
           "build_flash_meta", "build_flash_bwd_meta"]

_NEG_LARGE = -1e30


def build_flash_meta(views):
    """Per-mask metadata for the fused kernel from stacked BlockViews.

    Returns dict of stacked arrays (B leading dim):
      block_cols   i32[B, mb*max_bpr]   (padding repeats last valid)
      nblocks      i32[B, mb]
      mask_slot    i32[B, mb*max_bpr]   slot into the compacted mask panel;
                                        full blocks repeat the previous slot
      is_partial   i32[B, mb*max_bpr]
      pmask        f32[B, n_partial_max, bm, bk] compacted partial masks
    """
    B = len(views)
    v0 = views[0]
    mb, bm, bk = v0.mb, v0.bm, v0.bk
    max_bpr = max(v.max_bpr for v in views)

    cols = np.zeros((B, mb * max_bpr), np.int32)
    nblk = np.zeros((B, mb), np.int32)
    slot = np.zeros((B, mb * max_bpr), np.int32)
    part = np.zeros((B, mb * max_bpr), np.int32)
    pmasks = []
    n_partial_max = 1
    for b, v in enumerate(views):
        c = np.zeros((mb, max_bpr), np.int32)
        c[:, : v.max_bpr] = v.block_cols
        sl = np.zeros((mb, max_bpr), np.int32)
        pt = np.zeros((mb, max_bpr), np.int32)
        pm = []
        seen: dict = {}   # tile bytes -> compacted slot: banded/causal
        # topologies repeat the same few partial patterns down the
        # diagonal — without dedup a banded s=32k mask stores hundreds
        # of identical tiles (268 MB of pmask; ~2 unique tiles after dedup)
        cur = 0
        for i in range(mb):
            nb = int(v.nblocks[i])
            if 0 < nb < max_bpr:
                c[i, nb:] = c[i, nb - 1]
            for s in range(max_bpr):
                if s < nb:
                    tile = v.mask[i, s]
                    if not tile.all():
                        key = tile.tobytes()
                        hit = seen.get(key)
                        if hit is None:
                            pm.append(tile.astype(np.float32))
                            hit = seen[key] = len(pm) - 1
                        cur = hit
                        sl[i, s] = cur
                        pt[i, s] = 1
                    else:
                        sl[i, s] = cur  # repeat previous slot: DMA elided
                else:
                    sl[i, s] = cur
        if not pm:
            pm = [np.ones((bm, bk), np.float32)]
        pmasks.append(np.stack(pm))
        n_partial_max = max(n_partial_max, len(pm))
        cols[b] = c.reshape(-1)
        nblk[b] = v.nblocks
        slot[b] = sl.reshape(-1)
        part[b] = pt.reshape(-1)

    pmask = np.zeros((B, n_partial_max, bm, bk), np.float32)
    for b, pm in enumerate(pmasks):
        pmask[b, : pm.shape[0]] = pm
    return dict(block_cols=cols, nblocks=nblk, mask_slot=slot,
                is_partial=part, pmask=pmask, max_bpr=int(max_bpr),
                mb=mb, bm=bm, bk=bk)


def build_flash_bwd_meta(views):
    """Transposed metadata + per-(col-block, slot) mask slots for dk/dv."""
    B = len(views)
    v0 = views[0]
    kb, bm, bk = v0.kb, v0.bm, v0.bk
    metas = [v.transpose_meta() for v in views]
    max_bpc = max(ts.shape[1] for _, ts in metas)
    ti = np.zeros((B, kb * max_bpc), np.int32)
    tn = np.zeros((B, kb), np.int32)
    tslot = np.zeros((B, kb * max_bpc), np.int32)   # mask slot of src block
    tpart = np.zeros((B, kb * max_bpc), np.int32)
    fmeta = build_flash_meta(views)
    mb = v0.mb
    max_bpr = fmeta["max_bpr"]
    for b, (tnb, tsrc) in enumerate(metas):
        pad = np.zeros((kb, max_bpc, 2), np.int32)
        pad[:, : tsrc.shape[1]] = tsrc
        for j in range(kb):
            nb = int(tnb[j])
            if 0 < nb < max_bpc:
                pad[j, nb:] = pad[j, nb - 1]
        ti[b] = pad[:, :, 0].reshape(-1)
        tn[b] = tnb
        sl = fmeta["mask_slot"][b].reshape(mb, max_bpr)
        pt = fmeta["is_partial"][b].reshape(mb, max_bpr)
        for j in range(kb):
            for u in range(max_bpc):
                i_src, s_src = pad[j, u]
                tslot[b, j * max_bpc + u] = sl[i_src, s_src]
                tpart[b, j * max_bpc + u] = (
                    pt[i_src, s_src] if u < max(int(tnb[j]), 1) else 0)
    return dict(t_src_i=ti, t_nblocks=tn, t_mask_slot=tslot,
                t_is_partial=tpart, max_bpc=int(max_bpc),
                **{k: fmeta[k] for k in
                   ("block_cols", "nblocks", "mask_slot", "is_partial",
                    "pmask", "max_bpr", "mb", "bm", "bk")})


# ---------------------------------------------------------------------------
# Shared helpers.
# ---------------------------------------------------------------------------


def _pow2(x: int, lo: int = 16) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def _pad_hd(x, hd_p):
    hd = x.shape[-1]
    if hd == hd_p:
        return x
    return jnp.pad(x, ((0, 0), (0, 0), (0, hd_p - hd)))


def _stats(m, l):
    """Pack row max / denominator into the ``[R, M, 2]`` stats layout."""
    return jnp.stack([m, l], axis=-1)


def _call(kernel, grid, out_shape, operands, *, hd_p, mode, name):
    # one pipeline stage: the loop body's K/V (and Q/dO) tiles already
    # fill most of a block's shared memory, and deeper pipelining measured
    # slower on the backward (PERF.md)
    return pl.pallas_call(
        kernel,
        grid=grid,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=4 if hd_p <= 64 else 8, num_stages=1),
        interpret=mode == "interpret",
        name=name,
    )(*operands)


def _scores(q, k_ref, rk, c, bk, part, pm_ref, b, slot):
    """Masked score tile ``q @ k_block^T`` for key block ``c``."""
    k = k_ref[rk, pl.ds(c * bk, bk), :]
    sc = pl.dot(q, k, trans_b=True)
    pm = pm_ref[b, slot, :, :]
    return jnp.where((part == 1) & (pm == 0), _NEG_LARGE, sc), k


# ---------------------------------------------------------------------------
# Pallas-Triton kernels.
# ---------------------------------------------------------------------------


def _fwd_kernel(cols_ref, nblk_ref, slot_ref, part_ref, pm_ref, q_ref,
                k_ref, v_ref, o_ref, m_ref, l_ref, *, heads, group, max_bpr,
                bm, bk, hd_p):
    r, i = pl.program_id(0), pl.program_id(1)
    b, rk = jax.lax.div(r, jnp.int32(heads)), jax.lax.div(r, jnp.int32(group))
    rows = pl.ds(i * bm, bm)
    q = q_ref[r, rows, :]

    def body(s, carry):
        acc, m_i, l_i = carry
        idx = i * max_bpr + s
        c = cols_ref[b, idx]
        sc, _ = _scores(q, k_ref, rk, c, bk, part_ref[b, idx], pm_ref, b,
                        slot_ref[b, idx])
        m_new = jnp.maximum(m_i, jnp.max(sc, axis=1))
        p = jnp.exp(sc - m_new[:, None])
        p = jnp.where(sc <= _NEG_LARGE / 2, 0.0, p)
        corr = jnp.exp(m_i - m_new)
        v = v_ref[rk, pl.ds(c * bk, bk), :]
        acc = acc * corr[:, None] + pl.dot(p.astype(v.dtype), v)
        return acc, m_new, l_i * corr + jnp.sum(p, axis=1)

    acc, m_i, l_i = jax.lax.fori_loop(
        0, nblk_ref[b, i], body,
        (jnp.zeros((bm, hd_p), jnp.float32),
         jnp.full((bm,), _NEG_LARGE, jnp.float32),
         jnp.zeros((bm,), jnp.float32)))
    o_ref[r, rows, :] = acc / jnp.maximum(l_i, 1e-30)[:, None]
    m_ref[r, rows] = m_i
    l_ref[r, rows] = l_i


def _row_stats(m_ref, l_ref, d_ref, r, rows):
    return (m_ref[r, rows], jnp.maximum(l_ref[r, rows], 1e-30),
            d_ref[r, rows])


def _probs(sc, m, l):
    p = jnp.exp(sc - m[:, None]) / l[:, None]
    return jnp.where(sc <= _NEG_LARGE / 2, 0.0, p)


def _dq_kernel(cols_ref, nblk_ref, slot_ref, part_ref, pm_ref, q_ref,
               k_ref, v_ref, g_ref, m_ref, l_ref, d_ref, dq_ref, *, heads,
               group, max_bpr, bm, bk, hd_p):
    r, i = pl.program_id(0), pl.program_id(1)
    b, rk = jax.lax.div(r, jnp.int32(heads)), jax.lax.div(r, jnp.int32(group))
    rows = pl.ds(i * bm, bm)
    q, g = q_ref[r, rows, :], g_ref[r, rows, :]
    m, l, dd = _row_stats(m_ref, l_ref, d_ref, r, rows)

    def body(s, acc):
        idx = i * max_bpr + s
        c = cols_ref[b, idx]
        sc, k = _scores(q, k_ref, rk, c, bk, part_ref[b, idx], pm_ref, b,
                        slot_ref[b, idx])
        p = _probs(sc, m, l)
        v = v_ref[rk, pl.ds(c * bk, bk), :]
        ds = p * (pl.dot(g, v, trans_b=True) - dd[:, None])
        return acc + pl.dot(ds.astype(k.dtype), k)

    dq_ref[r, rows, :] = jax.lax.fori_loop(
        0, nblk_ref[b, i], body, jnp.zeros((bm, hd_p), jnp.float32))


def _dkv_kernel(ti_ref, tn_ref, slot_ref, part_ref, pm_ref, q_ref, k_ref,
                v_ref, g_ref, m_ref, l_ref, d_ref, dk_ref, dv_ref, *, heads,
                group, max_bpc, bm, bk, hd_p):
    r, j = pl.program_id(0), pl.program_id(1)
    b, rk = jax.lax.div(r, jnp.int32(heads)), jax.lax.div(r, jnp.int32(group))
    cols = pl.ds(j * bk, bk)
    k, v = k_ref[rk, cols, :], v_ref[rk, cols, :]

    def body(u, carry):
        dk, dv = carry
        idx = j * max_bpc + u
        i = ti_ref[b, idx]
        rows = pl.ds(i * bm, bm)
        q, g = q_ref[r, rows, :], g_ref[r, rows, :]
        m, l, dd = _row_stats(m_ref, l_ref, d_ref, r, rows)
        sc = pl.dot(q, k, trans_b=True)
        pm = pm_ref[b, slot_ref[b, idx], :, :]
        sc = jnp.where((part_ref[b, idx] == 1) & (pm == 0), _NEG_LARGE, sc)
        p = _probs(sc, m, l)
        dv = dv + pl.dot(p.astype(g.dtype), g, trans_a=True)
        ds = p * (pl.dot(g, v, trans_b=True) - dd[:, None])
        dk = dk + pl.dot(ds.astype(q.dtype), q, trans_a=True)
        return dk, dv

    zero = jnp.zeros((bk, hd_p), jnp.float32)
    dk, dv = jax.lax.fori_loop(0, tn_ref[b, j], body, (zero, zero))
    dk_ref[r, cols, :] = dk
    dv_ref[r, cols, :] = dv


# ---------------------------------------------------------------------------
# Plain block-gather versions (what XLA runs where the kernels do not).
# ---------------------------------------------------------------------------


def _live(nblk, slot, part, pmask, mb, S):
    """Element liveness of every walked block: ``[B, mb, bm, S, bk]``."""
    B = nblk.shape[0]
    slot, part = slot.reshape(B, mb, S), part.reshape(B, mb, S)
    pm = jax.vmap(lambda p, s: p[s])(pmask, slot)       # [B, mb, S, bm, bk]
    live = ((jnp.arange(S)[None, None, :] < nblk[:, :, None])[..., None,
                                                             None]
            & ((part == 0)[..., None, None] | (pm != 0)))
    return jnp.transpose(live, (0, 1, 3, 2, 4))


def _gather_kv(x, blocks, B, Hk, bk):
    """``x [R_kv, N, hd]`` -> the blocks ``blocks [B, ...]`` names:
    ``[B, Hk, *blocks.shape[1:], bk, hd]``."""
    hd = x.shape[-1]
    xb = x.reshape(B, Hk, -1, bk, hd)
    return jax.vmap(lambda a, c: a[:, c])(xb, blocks)


def _fwd_plain(cols, nblk, slot, part, pmask, q, k, v, *, heads, group):
    B = cols.shape[0]
    R, M, hd = q.shape
    bm, bk = pmask.shape[-2:]
    mb = M // bm
    S = cols.shape[1] // mb
    G, Hk = group, heads // group
    live = _live(nblk, slot, part, pmask, mb, S)[:, None, None]
    c = cols.reshape(B, mb, S)
    kg = _gather_kv(k, c, B, Hk, bk)                    # [B,Hk,mb,S,bk,hd]
    vg = _gather_kv(v, c, B, Hk, bk)
    qb = q.reshape(B, Hk, G, mb, bm, hd)
    sc = jnp.einsum("bhgiad,bhiskd->bhgiask", qb, kg,
                    preferred_element_type=jnp.float32)
    sc = jnp.where(live, sc, _NEG_LARGE)
    m = jnp.maximum(jnp.max(sc, axis=(-2, -1)), _NEG_LARGE)
    e = jnp.where(live, jnp.exp(sc - m[..., None, None]), 0.0)
    l = jnp.sum(e, axis=(-2, -1))
    out = jnp.einsum("bhgiask,bhiskd->bhgiad", e.astype(v.dtype), vg,
                     preferred_element_type=jnp.float32)
    out = out / jnp.maximum(l, 1e-30)[..., None]
    return (out.reshape(R, M, hd), m.reshape(R, M), l.reshape(R, M))


def _dq_plain(cols, nblk, slot, part, pmask, q, k, v, g, m, l, dd, *,
              heads, group):
    B = cols.shape[0]
    R, M, hd = q.shape
    bm, bk = pmask.shape[-2:]
    mb = M // bm
    S = cols.shape[1] // mb
    G, Hk = group, heads // group
    live = _live(nblk, slot, part, pmask, mb, S)[:, None, None]
    c = cols.reshape(B, mb, S)
    kg = _gather_kv(k, c, B, Hk, bk)
    vg = _gather_kv(v, c, B, Hk, bk)

    def rows(x):
        return x.reshape(B, Hk, G, mb, bm, -1)

    qb, gb = rows(q), rows(g)
    mr, lr, dr = (rows(x[..., None]) for x in (m, l, dd))
    sc = jnp.einsum("bhgiad,bhiskd->bhgiask", qb, kg,
                    preferred_element_type=jnp.float32)
    p = jnp.where(live, jnp.exp(sc - mr[..., None]) /
                  jnp.maximum(lr, 1e-30)[..., None], 0.0)
    dp = jnp.einsum("bhgiad,bhiskd->bhgiask", gb, vg,
                    preferred_element_type=jnp.float32)
    ds = p * (dp - dr[..., None])
    dq = jnp.einsum("bhgiask,bhiskd->bhgiad", ds.astype(k.dtype), kg,
                    preferred_element_type=jnp.float32)
    return dq.reshape(R, M, hd)


def _dkv_plain(ti, tn, slot, part, pmask, q, k, v, g, m, l, dd, *, heads,
               group):
    B = ti.shape[0]
    R, M, hd = q.shape
    bm, bk = pmask.shape[-2:]
    mb = M // bm
    kb = tn.shape[1]
    U = ti.shape[1] // kb
    G, Hk = group, heads // group
    live = _live(tn, slot, part, pmask, kb, U)          # [B, kb, bm, U, bk]
    live = jnp.transpose(live, (0, 1, 3, 2, 4))[:, None, None]
    t = ti.reshape(B, kb, U)

    def qrows(x):                                       # -> [B,Hk,G,kb,U,bm,*]
        xb = x.reshape(B, Hk, G, mb, bm, -1)
        return jax.vmap(lambda a, c: a[:, :, c])(xb, t)

    qg, gg = qrows(q), qrows(g)
    mr, lr, dr = (qrows(x[..., None])[..., 0] for x in (m, l, dd))
    kb_ = k.reshape(B, Hk, kb, bk, hd)
    vb_ = v.reshape(B, Hk, kb, bk, hd)
    sc = jnp.einsum("bhgjuad,bhjkd->bhgjuak", qg, kb_,
                    preferred_element_type=jnp.float32)
    p = jnp.where(live, jnp.exp(sc - mr[..., None]) /
                  jnp.maximum(lr, 1e-30)[..., None], 0.0)
    dv = jnp.einsum("bhgjuak,bhgjuad->bhgjkd", p.astype(g.dtype), gg,
                    preferred_element_type=jnp.float32)
    dp = jnp.einsum("bhgjuad,bhjkd->bhgjuak", gg, vb_,
                    preferred_element_type=jnp.float32)
    ds = p * (dp - dr[..., None])
    dk = jnp.einsum("bhgjuak,bhgjuad->bhgjkd", ds.astype(q.dtype), qg,
                    preferred_element_type=jnp.float32)
    return dk.reshape(R, kb * bk, hd), dv.reshape(R, kb * bk, hd)


# ---------------------------------------------------------------------------
# Entries (metadata contract unchanged; the route picks the body).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("heads", "group", "mode"))
def _fwd_triton(cols, nblk, slot, part, pmask, q, k, v, *, heads, group,
                mode):
    R, M, hd = q.shape
    bm, bk = pmask.shape[-2:]
    mb = M // bm
    hd_p = _pow2(hd)
    kernel = functools.partial(_fwd_kernel, heads=heads, group=group,
                               max_bpr=cols.shape[1] // mb, bm=bm, bk=bk,
                               hd_p=hd_p)
    out, m, l = _call(
        kernel, (R, mb),
        [jax.ShapeDtypeStruct((R, M, hd_p), jnp.float32),
         jax.ShapeDtypeStruct((R, M), jnp.float32),
         jax.ShapeDtypeStruct((R, M), jnp.float32)],
        (cols, nblk, slot, part, pmask, _pad_hd(q, hd_p), _pad_hd(k, hd_p),
         _pad_hd(v, hd_p)), hd_p=hd_p, mode=mode, name="flash_sparse_fwd")
    return out[..., :hd], m, l


def flash_sparse_attention_fwd(block_cols, nblocks, mask_slot, is_partial,
                               pmask, q, k, v, *, R: int, heads: int,
                               mb: int, max_bpr: int, bm: int, bk: int,
                               group: int = 1, packed_stats: bool = False):
    """Forward over ``q [R, mb*bm, hd]`` (pre-scaled by 1/sqrt(hd)) and
    ``k, v [R // group, kb*bk, hd]``: returns ``(out, stats [R, mb*bm, 2])``
    with ``packed_stats``, else ``(out, row_max [R, mb*bm, 1],
    row_denom [R, mb*bm, 1])``."""
    del R, mb, max_bpr, bm, bk
    mode = _route()
    if mode == "plain":
        out, m, l = _fwd_plain(block_cols, nblocks, mask_slot, is_partial,
                               pmask, q, k, v, heads=heads, group=group)
    else:
        out, m, l = _fwd_triton(block_cols, nblocks, mask_slot, is_partial,
                                pmask, q, k, v, heads=heads, group=group,
                                mode=mode)
    if packed_stats:
        return out, _stats(m, l)
    return out, m[..., None], l[..., None]


@functools.partial(jax.jit, static_argnames=("heads", "group", "mode"))
def _dq_triton(cols, nblk, slot, part, pmask, q, k, v, g, m, l, dd, *,
               heads, group, mode):
    R, M, hd = q.shape
    bm, bk = pmask.shape[-2:]
    mb = M // bm
    hd_p = _pow2(hd)
    kernel = functools.partial(_dq_kernel, heads=heads, group=group,
                               max_bpr=cols.shape[1] // mb, bm=bm, bk=bk,
                               hd_p=hd_p)
    dq = _call(kernel, (R, mb),
               jax.ShapeDtypeStruct((R, M, hd_p), jnp.float32),
               (cols, nblk, slot, part, pmask) + tuple(
                   _pad_hd(x, hd_p) for x in (q, k, v, g)) + (m, l, dd),
               hd_p=hd_p, mode=mode, name="flash_sparse_dq")
    return dq[..., :hd]


def flash_sparse_bwd_dq(block_cols, nblocks, mask_slot, is_partial, pmask,
                        q, k, v, g, stats, dcoef, *, R: int, heads: int,
                        mb: int, max_bpr: int, bm: int, bk: int,
                        group: int = 1):
    """dq (w.r.t. the PRE-SCALED q): ``f32[R, mb*bm, hd]``. ``stats``:
    lane 0 = row max, lane 1 = denominator; ``dcoef``: lane 0 = ``D =
    rowsum(g * out)``."""
    del R, mb, max_bpr, bm, bk
    args = (block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v, g,
            stats[..., 0], stats[..., 1], dcoef[..., 0])
    mode = _route()
    if mode == "plain":
        return _dq_plain(*args, heads=heads, group=group)
    return _dq_triton(*args, heads=heads, group=group, mode=mode)


@functools.partial(jax.jit, static_argnames=("heads", "group", "kb",
                                             "mode"))
def _dkv_triton(ti, tn, slot, part, pmask, q, k, v, g, m, l, dd, *, heads,
                group, kb, mode):
    R, M, hd = q.shape
    bm, bk = pmask.shape[-2:]
    hd_p = _pow2(hd)
    kernel = functools.partial(_dkv_kernel, heads=heads, group=group,
                               max_bpc=ti.shape[1] // kb, bm=bm, bk=bk,
                               hd_p=hd_p)
    shape = jax.ShapeDtypeStruct((R, kb * bk, hd_p), jnp.float32)
    dk, dv = _call(kernel, (R, kb), [shape, shape],
                   (ti, tn, slot, part, pmask) + tuple(
                       _pad_hd(x, hd_p) for x in (q, k, v, g)) + (m, l, dd),
                   hd_p=hd_p, mode=mode, name="flash_sparse_dkv")
    return dk[..., :hd], dv[..., :hd]


def flash_sparse_bwd_dkv(t_src_i, t_nblocks, t_mask_slot, t_is_partial,
                         pmask, q, k, v, g, stats, dcoef, *, R: int,
                         heads: int, kb: int, max_bpc: int, bm: int, bk: int,
                         group: int = 1):
    """(dk, dv): each ``f32[R, kb*bk, hd]`` — PER QUERY REPLICA even under
    GQA (k/v enter as ``[R // group, ...]``); the caller sums each group
    of ``group`` partials into its shared KV replica's gradient (summing
    across programs in-kernel would need atomics)."""
    del R, max_bpc, bm, bk
    args = (t_src_i, t_nblocks, t_mask_slot, t_is_partial, pmask, q, k, v,
            g, stats[..., 0], stats[..., 1], dcoef[..., 0])
    mode = _route()
    if mode == "plain":
        return _dkv_plain(*args, heads=heads, group=group)
    return _dkv_triton(*args, heads=heads, group=group, kb=kb, mode=mode)


def flash_sparse_ring_band_fwd(band, block_cols, nblocks, mask_slot,
                               is_partial, pmask, q, k, v, acc_in, st_in, *,
                               R: int, mb: int, max_bpr: int, bm: int,
                               bk: int, group: int = 1):
    """One ring step: attend ``q [R, mb*bm, hd]`` to the current key band
    ``k, v [R // group, n_loc, hd]`` with band ``band[0]``'s metadata (the
    ``[nbands, ...]`` stacks; every replica shares the band) and merge the
    result into the carried UNNORMALISED accumulator ``acc_in [R, mb*bm,
    hd]`` and stats ``st_in`` (lane 0 = running max, lane 1 = denominator;
    seed with zeros and a ``-1e30`` max). Finish with ``out = acc /
    max(st[..., 1:2], eps)`` after the last band."""
    def take(x):
        return jax.lax.dynamic_index_in_dim(x, band[0], axis=0,
                                            keepdims=True)

    out, m, l = flash_sparse_attention_fwd(
        take(block_cols), take(nblocks), take(mask_slot), take(is_partial),
        take(pmask), q, k, v, R=R, heads=R, mb=mb, max_bpr=max_bpr, bm=bm,
        bk=bk, group=group)
    m_in, l_in = st_in[..., :1], st_in[..., 1:2]
    m_new = jnp.maximum(m_in, m)
    a_in, a = jnp.exp(m_in - m_new), jnp.exp(m - m_new) * l
    acc = acc_in * a_in + out * a
    l_new = l_in * a_in + a
    st = jnp.concatenate([m_new, l_new, st_in[..., 2:]], axis=-1)
    return acc, st
