"""Compressed (true-BSR) block ops: offset-indexed block storage.

Same compute as ``bsr_spmm`` / ``bsr_spmm_t`` / ``bsr_sddmm`` but the
values are the ``CompressedView`` layout ``[num_blocks + 1, bm, bk]``
addressed through per-row-block offsets — no ELL padding, so topologies
with skewed per-row block counts (e.g. one dense row among sparse ones, a
common shape in graph workloads) don't inflate memory to ``mb * max_bpr``
tiles.

Plain ``jax.numpy`` throughout: each block's dense rows are gathered once
and contracted in one einsum, and the ragged per-row-block sums are
``segment_sum`` over the block -> row-block map (derived from the
offsets). Blocks at or past ``block_offsets[-1]`` (the dump block, and on a
sharded device the slots beyond its own block count) contribute nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .._common import acc_dtype

__all__ = ["bsr_spmm_panel_c", "bsr_spmm_t_panel_c", "bsr_sddmm_panel_c",
           "c_softmax"]

_NEG_LARGE = -1e30


def _rows_live(block_offsets, n_slots, mb):
    """Row block of every stored block, and whether it is a real block."""
    g = jnp.arange(n_slots)
    rows = jnp.searchsorted(block_offsets, g, side="right") - 1
    return jnp.clip(rows, 0, mb - 1), g < block_offsets[-1]


def bsr_spmm_panel_c(block_offsets, block_cols, values, dense, bias=None, *,
                     mb: int, max_bpr: int, num_blocks: int, bm: int,
                     bk: int, bn: int = 128, epilogue: str = "none"):
    """``f32[mb * bm, n_pad]`` from ``values [num_blocks + 1, bm, bk]``,
    ``dense [kb * bk, n_pad]`` and (with an epilogue) ``bias f32[mb*bm,
    1]``."""
    del max_bpr, num_blocks, bn
    n = dense.shape[-1]
    rows, live = _rows_live(block_offsets, values.shape[0], mb)
    g = dense.reshape(-1, bk, n)[block_cols]                 # [G+1, bk, n]
    contrib = jnp.einsum("gak,gkn->gan",
                         jnp.where(live[:, None, None], values, 0), g,
                         preferred_element_type=acc_dtype(values, g))
    out = jax.ops.segment_sum(contrib, rows, num_segments=mb)
    out = out.reshape(mb * bm, n)
    if epilogue != "none":
        out = out + bias.reshape(-1, 1)
        if epilogue == "bias_relu":
            out = jnp.maximum(out, 0.0)
    return out


def bsr_spmm_t_panel_c(t_gblk, t_rows, t_nblocks, values, g, *, kb: int,
                       max_bpc: int, num_blocks: int, bm: int, bk: int):
    """``A^T @ G``: ``[kb * bk, q]`` from the transposed block lists
    (global block id and source row block per column-block slot)."""
    del num_blocks
    q = g.shape[-1]
    gb, tr = t_gblk.reshape(kb, max_bpc), t_rows.reshape(kb, max_bpc)
    live = jnp.arange(max_bpc)[None, :] < t_nblocks[:, None]
    a = jnp.where(live[:, :, None, None], values[gb], 0)    # [kb, U, bm, bk]
    gg = g.reshape(-1, bm, q)[tr]                            # [kb, U, bm, q]
    out = jnp.einsum("juak,juaq->jkq", a, gg,
                     preferred_element_type=acc_dtype(a, gg))
    return out.reshape(kb * bk, q)


def bsr_sddmm_panel_c(block_offsets, block_cols, lhs, rhs, mask, *,
                      mb: int, max_bpr: int, num_blocks: int, bm: int,
                      bk: int, bd: int = 0):
    """Sampled ``lhs @ rhs^T`` into the COMPRESSED panel ``f32[num_blocks
    + 1, bm, bk]`` (zero outside real blocks and their element masks)."""
    del max_bpr, num_blocks, bd
    d = lhs.shape[-1]
    rows, live = _rows_live(block_offsets, mask.shape[0], mb)
    ll = lhs.reshape(mb, bm, d)[rows]                        # [G+1, bm, d]
    rr = rhs.reshape(-1, bk, d)[block_cols]                  # [G+1, bk, d]
    out = jnp.einsum("gad,gkd->gak", ll, rr,
                     preferred_element_type=acc_dtype(ll, rr))
    return jnp.where(live[:, None, None] & (mask != 0), out, 0.0)


def c_softmax(block_offsets, values, mask, *, mb: int):
    """Masked row softmax over the ragged block -> row-block map."""
    rows, live = _rows_live(block_offsets, values.shape[0], mb)
    keep = live[:, None, None] & (mask != 0)
    v = jnp.where(keep, values, _NEG_LARGE)
    row_max = jax.ops.segment_max(jnp.max(v, axis=2), rows, num_segments=mb)
    row_max = jnp.maximum(row_max, _NEG_LARGE)                # [mb, bm]
    e = jnp.where(keep, jnp.exp(v - row_max[rows][:, :, None]), 0.0)
    denom = jax.ops.segment_sum(jnp.sum(e, axis=2), rows, num_segments=mb)
    denom = jnp.maximum(denom[rows][:, :, None],
                        jnp.finfo(values.dtype).tiny)
    return e / denom
