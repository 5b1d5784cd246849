"""Transposed block-CSR SpMM: ``A^T @ G`` straight off the *original* panel.

The reference pays a cuSPARSE CSR->CSC conversion every backward pass
(``src/transpose_cuda.cu:90-99``). Here the transposed topology is only
*block metadata* (``BlockView.transpose_meta``): for each block column
``j``, the list of ``(row_block, slot)`` panel blocks sitting in that
column. The op gathers those blocks and the matching rows of ``G`` and
contracts them in one einsum that transposes each tile inside the
contraction — no value permutation. XLA compiles it on every platform: a
Pallas-Triton kernel walking the same lists was not faster on an H100
(``PERF.md``, bring-up).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .._common import acc_dtype

__all__ = ["bsr_spmm_t_batched", "bsr_spmm_t_panel"]


def _spmm_t_plain(ti, ts, tn, panels, g, *, heads, kb):
    R, mb, _, bm, bk = panels.shape
    B = ti.shape[0]
    max_bpc = ti.shape[1] // kb
    q = g.shape[-1]

    def one(ti, ts, tn, p, g):      # p [h, mb, S, bm, bk], g [h, mb*bm, q]
        ti, ts = ti.reshape(kb, max_bpc), ts.reshape(kb, max_bpc)
        live = jnp.arange(max_bpc)[None, :] < tn[:, None]
        a = jnp.where(live[None, :, :, None, None], p[:, ti, ts], 0)
        gg = g.reshape(heads, mb, bm, q)[:, ti]     # [h, kb, U, bm, q]
        return jnp.einsum("hjuak,hjuaq->hjkq", a, gg,
                          preferred_element_type=acc_dtype(a, gg))

    out = jax.vmap(one)(ti, ts, tn,
                        panels.reshape((B, heads) + panels.shape[1:]),
                        g.reshape(B, heads, -1, q))
    return out.reshape(R, kb * bk, q)


def bsr_spmm_t_batched(t_src_i, t_src_s, t_nblocks, panels, g, *,
                       heads: int = 1, kb: int):
    """Batched ``A_r^T @ G_r``: ``t_src_i/t_src_s i32[B, kb * max_bpc]``,
    ``t_nblocks i32[B, kb]``, ``panels [R, mb, max_bpr, bm, bk]``, ``g
    [R, mb * bm, q]`` -> ``[R, kb * bk, q]``."""
    return _spmm_t_plain(t_src_i, t_src_s, t_nblocks, panels, g,
                         heads=heads, kb=kb)


def bsr_spmm_t_panel(t_src_i, t_src_s, t_nblocks, values_panel, g, *,
                     kb: int, max_bpc: int, mb: int, bm: int, bk: int):
    """Returns ``A^T @ G``: ``f32[kb * bk, q_pad]`` for one panel
    ``[mb, max_bpr, bm, bk]`` and ``g [mb * bm, q_pad]``."""
    del max_bpc, mb, bm, bk
    return bsr_spmm_t_batched(
        t_src_i[None], t_src_s[None], t_nblocks[None], values_panel[None],
        g[None], kb=kb)[0]
