"""Block-CSR SDDMM (the GPU answer to ``sputnik::CudaSddmm``,
``src/sddmm_cuda.cu:46``).

Computes ``(lhs @ rhs^T)`` sampled at the topology's nonzeros (``rhs`` is
stored row-major ``[n, d]`` and transposed inside the contraction, as in
the reference, ``tests/test_sddmm.py:9``). Output is the block panel
``[R, mb, max_bpr, bm, bk]``: one Pallas-Triton program per ``(replica,
row block, slot)`` computes its occupied tile as ``lhs_tile[i] @
rhs_tile[block_cols[i, s]]^T`` over an in-program loop on the contraction
dimension, masked by the tile's element mask. Padded slots store zeros.
The plain version gathers the rhs blocks and contracts in one einsum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .._common import round_up as _round_up
from .._common import acc_dtype
from .._common import route as _route
from .bsr_spmm import chunk as _chunk

__all__ = ["bsr_sddmm_batched", "bsr_sddmm_panel", "bsr_sddmm"]


def _kernel(cols_ref, nblk_ref, m_ref, l_ref, r_ref, o_ref, *, heads,
            max_bpr, bm, bk, bd, nd):
    r, i, s = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    b = jax.lax.div(r, jnp.int32(heads))
    c = cols_ref[b, i * max_bpr + s]

    def body(t, acc):
        a = l_ref[r, pl.ds(i * bm, bm), pl.ds(t * bd, bd)]        # [bm, bd]
        x = r_ref[r, pl.ds(c * bk, bk), pl.ds(t * bd, bd)]        # [bk, bd]
        return acc + pl.dot(a, x, trans_b=True)

    # nd contraction chunks on an occupied slot, none on a padded one
    trips = jnp.minimum(jnp.maximum(nblk_ref[b, i] - s, 0), 1) * nd
    acc = jax.lax.fori_loop(0, trips, body, jnp.zeros((bm, bk), jnp.float32))
    o_ref[r, i, s, :, :] = acc * m_ref[b, i, s, :, :]


@functools.partial(jax.jit, static_argnames=("heads", "interpret"))
def _sddmm_triton(cols, nblk, mask, lhs, rhs, *, heads, interpret):
    B, mb, max_bpr, bm, bk = mask.shape
    R, _, d_pad = lhs.shape
    bd = _chunk(d_pad)
    kernel = functools.partial(_kernel, heads=heads, max_bpr=max_bpr, bm=bm,
                               bk=bk, bd=bd, nd=d_pad // bd)
    return pl.pallas_call(
        kernel,
        grid=(R, mb, max_bpr),
        out_shape=jax.ShapeDtypeStruct((R, mb, max_bpr, bm, bk),
                                       jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="bsr_sddmm",
    )(cols, nblk, mask, lhs, rhs)


def _sddmm_plain(cols, nblk, mask, lhs, rhs, *, heads):
    B, mb, max_bpr, bm, bk = mask.shape
    R, _, d = lhs.shape
    kb = rhs.shape[1] // bk

    def one(c, nb, m, lh, rh):      # lh [h, mb*bm, d], rh [h, kb*bk, d]
        c = c.reshape(mb, max_bpr)
        live = jnp.arange(max_bpr)[None, :] < nb[:, None]
        m = jnp.where(live[:, :, None, None], m, 0)
        rr = rh.reshape(heads, kb, bk, d)[:, c]     # [h, mb, S, bk, d]
        ll = lh.reshape(heads, mb, bm, d)
        return jnp.einsum("hiad,hiskd->hisak", ll, rr,
                          preferred_element_type=acc_dtype(ll, rr)) * m

    out = jax.vmap(one)(cols, nblk, mask, lhs.reshape(B, heads, -1, d),
                        rhs.reshape(B, heads, -1, d))
    return out.reshape(R, mb, max_bpr, bm, bk)


def bsr_sddmm_batched(block_cols, nblocks, mask, lhs, rhs, *,
                      heads: int = 1):
    """Batched sampled product: ``block_cols i32[B, mb * max_bpr]``,
    ``nblocks i32[B, mb]``, ``mask f32[B, mb, max_bpr, bm, bk]``, ``lhs
    [R, mb * bm, d_pad]``, ``rhs [R, kb * bk, d_pad]`` -> panels
    ``f32[R, mb, max_bpr, bm, bk]``."""
    mode = _route()
    if mode == "plain":
        return _sddmm_plain(block_cols, nblocks, mask, lhs, rhs,
                            heads=heads)
    return _sddmm_triton(block_cols, nblocks, mask, lhs, rhs, heads=heads,
                         interpret=mode == "interpret")


def bsr_sddmm_panel(block_cols, nblocks, lhs, rhs, mask, *, mb: int,
                    max_bpr: int, bm: int, bk: int, bd: int = 0):
    """Returns the sampled-product panel ``f32[mb, max_bpr, bm, bk]`` for
    ``lhs [mb * bm, d_pad]``, ``rhs [kb * bk, d_pad]`` and ``mask
    f32[mb, max_bpr, bm, bk]``."""
    del mb, max_bpr, bm, bk, bd
    return bsr_sddmm_batched(block_cols[None], nblocks[None], mask[None],
                             lhs[None], rhs[None])[0]


def bsr_sddmm(topo, lhs, rhs, *, bm: int = 128, bk: int = 128,
              bd: int = 16):
    """``lhs[m, d] x rhs[n, d] -> values[nnz_pad]`` sampled at the
    topology (``d`` zero-padded to a multiple of ``bd``)."""
    bv = topo.block(bm, bk)
    d = lhs.shape[-1]
    d_pad = _round_up(max(d, 1), bd)
    lhs_pad = jnp.zeros((bv.m_pad, d_pad), lhs.dtype)
    lhs_pad = lhs_pad.at[: lhs.shape[0], :d].set(lhs)
    rhs_pad = jnp.zeros((bv.n_pad, d_pad), rhs.dtype)
    rhs_pad = rhs_pad.at[: rhs.shape[0], :d].set(rhs)
    panel = bsr_sddmm_panel(
        jnp.asarray(bv.block_cols.reshape(-1)), jnp.asarray(bv.nblocks),
        lhs_pad, rhs_pad, jnp.asarray(bv.mask, jnp.float32),
        mb=bv.mb, max_bpr=bv.max_bpr, bm=bm, bk=bk)
    flat = jnp.concatenate([panel.reshape(-1), jnp.zeros((1,), panel.dtype)])
    return jnp.take(flat, jnp.asarray(bv.gather_idx))
