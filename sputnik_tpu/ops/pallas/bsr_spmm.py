"""Block-CSR SpMM: one Pallas-Triton kernel family for every panel SpMM
(the GPU answer to ``sputnik::CudaSpmm``, ``src/spmm_cuda.cu:49``).

The sparse operand is held as block panels
``panels[R, mb, max_bpr, bm, bk]`` (see ``blocking.BlockView``) with block
metadata shared by runs of ``heads`` consecutive replicas (``r // heads``
picks the topology). One program computes one ``(replica, row block,
output tile)``: it loads its own ``block_cols`` / ``nblocks`` entries and
walks the row's occupied blocks in an in-program loop, slicing the dense
tile of each block column straight from device memory and accumulating
``A_block @ B_tile`` in float32 registers. The bias(+ReLU) epilogue is
fused (the reference's phantom ``spmm_bias`` op, Sputnik's
``CudaSpmmBiasRelu``). A single matrix is ``R = 1``.

The plain version (a block-gather einsum over the panel) is what XLA runs
where the kernel does not serve (``_common.route``).
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

__all__ = ["bsr_spmm_batched", "bsr_spmm_panel", "bsr_spmm_panel_sel",
           "bsr_spmm", "chunk"]


def chunk(b: int, cap: int = 32) -> int:
    """Inner contraction chunk: the largest power of two <= ``cap``
    dividing ``b`` (keeps each pipelined shared-memory stage small)."""
    c = cap
    while c > 1 and b % c:
        c //= 2
    return c


def _kernel(*refs, heads, max_bpr, bm, bk, bn, bkc, epilogue, with_sel):
    refs = list(refs)
    cols_ref, nblk_ref = refs.pop(0), refs.pop(0)
    sel_ref = refs.pop(0) if with_sel else None
    p_ref, d_ref = refs.pop(0), refs.pop(0)
    bias_ref = refs.pop(0) if epilogue != "none" else None
    (o_ref,) = refs
    r, i, j = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    b = jax.lax.div(r, jnp.int32(heads))
    nk = bk // bkc

    def body(t, acc):
        s = jax.lax.div(t, jnp.int32(nk))
        kk = jax.lax.rem(t, jnp.int32(nk))
        idx = i * max_bpr + s
        c = cols_ref[b, idx]
        slot = sel_ref[b, idx] if with_sel else s
        a = p_ref[r, i, slot, :, pl.ds(kk * bkc, bkc)]            # [bm, bkc]
        x = d_ref[r, pl.ds(c * bk + kk * bkc, bkc), pl.ds(j * bn, bn)]
        return acc + pl.dot(a, x)

    acc = jax.lax.fori_loop(0, nblk_ref[b, i] * nk, body,
                            jnp.zeros((bm, bn), jnp.float32))
    if bias_ref is not None:
        acc = acc + bias_ref[pl.ds(i * bm, bm)][:, None]
        if epilogue == "bias_relu":
            acc = jnp.maximum(acc, 0.0)
    o_ref[r, pl.ds(i * bm, bm), pl.ds(j * bn, bn)] = acc


@functools.partial(jax.jit, static_argnames=("heads", "bn", "epilogue",
                                             "interpret"))
def _spmm_triton(cols, nblk, sel, panels, dense, bias, *, heads, bn,
                 epilogue, interpret):
    R, mb, max_bpr_p, bm, bk = panels.shape
    max_bpr = cols.shape[1] // mb
    n_pad = dense.shape[-1]
    operands = [cols, nblk] + ([sel] if sel is not None else []) + [
        panels, dense] + ([bias] if epilogue != "none" else [])
    kernel = functools.partial(
        _kernel, heads=heads, max_bpr=max_bpr, bm=bm, bk=bk, bn=bn,
        bkc=chunk(bk), epilogue=epilogue, with_sel=sel is not None)
    return pl.pallas_call(
        kernel,
        grid=(R, mb, n_pad // bn),
        out_shape=jax.ShapeDtypeStruct((R, mb * bm, n_pad), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="bsr_spmm",
    )(*operands)


def _spmm_plain(cols, nblk, sel, panels, dense, bias, mask, *, heads,
                epilogue):
    """Block-gather einsum: gather each occupied block's dense rows, then
    one batched contraction over (slot, block column)."""
    R, mb, _, bm, bk = panels.shape
    B = cols.shape[0]
    max_bpr = cols.shape[1] // mb
    n = dense.shape[-1]
    kb = dense.shape[1] // bk
    if sel is None:
        sel = jnp.broadcast_to(jnp.arange(max_bpr, dtype=jnp.int32),
                               (B, mb, max_bpr)).reshape(B, -1)
    if mask is None:
        mask = jnp.ones((B, 1, 1, 1, 1), bool)

    def one(c, nb, sl, mk, p, d):   # p [heads, mb, *, bm, bk]
        c, sl = c.reshape(mb, max_bpr), sl.reshape(mb, max_bpr)
        rows = jnp.arange(mb)[:, None]
        p = p[:, rows, sl]                          # [h, mb, S, bm, bk]
        if mk.shape[1] > 1:
            mk = mk[rows, sl]
        live = (jnp.arange(max_bpr)[None, :] < nb[:, None])[..., None, None]
        p = jnp.where(live & (mk != 0), p, 0)
        g = d.reshape(heads, kb, bk, n)[:, c]       # [h, mb, S, bk, n]
        return jnp.einsum("hisak,hiskn->hian", p, g,
                          preferred_element_type=acc_dtype(p, g))

    out = jax.vmap(one)(cols, nblk, sel, mask,
                        panels.reshape((B, heads) + panels.shape[1:]),
                        dense.reshape(B, heads, -1, n))
    out = out.reshape(R, mb * bm, n)
    if epilogue != "none":
        out = out + bias[None, :, None]
        if epilogue == "bias_relu":
            out = jnp.maximum(out, 0.0)
    return out


def bsr_spmm_batched(block_cols, nblocks, panels, dense, bias=None, *,
                     heads: int = 1, bn: int = 128, epilogue: str = "none",
                     slot_sel=None, mask=None):
    """Batched panel SpMM: ``f32[R, mb * bm, n_pad]``.

    ``block_cols``/``slot_sel`` ``i32[B, mb * max_bpr]``, ``nblocks
    i32[B, mb]``, ``panels [R, mb, max_bpr_full, bm, bk]`` with ``R = B *
    heads``, ``dense [R, kb * bk, n_pad]`` (``n_pad`` a multiple of
    ``bn``), ``bias f32[mb * bm]`` (read only with an epilogue).
    ``slot_sel`` picks the panel slot visited at each walk step (default:
    the step itself) — a sub-walk over a subset of each row's blocks.
    ``mask [B, mb, max_bpr_full, bm, bk]`` (optional): the element
    pattern. Panel entries outside it are structurally zero; the plain
    version enforces that, the kernel reads tiles as stored (every
    producer — init, SDDMM, the gradients — keeps them zero)."""
    if epilogue != "none" and bias is None:
        raise ValueError(f"epilogue {epilogue!r} needs a bias")
    mode = _route()
    if mode == "plain":
        return _spmm_plain(block_cols, nblocks, slot_sel, panels, dense,
                           bias, mask, heads=heads, epilogue=epilogue)
    bias = None if bias is None else bias.astype(jnp.float32)
    return _spmm_triton(block_cols, nblocks, slot_sel, panels, dense, bias,
                        heads=heads, bn=bn, epilogue=epilogue,
                        interpret=mode == "interpret")


def bsr_spmm_panel(block_cols, nblocks, values_panel, dense, bias, *,
                   mb: int, max_bpr: int, kb: int, bm: int, bk: int,
                   bn: int, epilogue: str = "none"):
    """Core panel SpMM: ``block_cols i32[mb * max_bpr]``, ``nblocks
    i32[mb]``, ``values_panel [mb, max_bpr, bm, bk]``, ``dense [kb * bk,
    n_pad]``, ``bias f32[mb * bm, 1]`` -> ``f32[mb * bm, n_pad]``."""
    del mb, max_bpr, kb, bm, bk     # carried by the operand shapes
    return bsr_spmm_batched(
        block_cols[None], nblocks[None], values_panel[None], dense[None],
        None if bias is None else bias.reshape(-1),
        bn=bn, epilogue=epilogue)[0]


def bsr_spmm_panel_sel(block_cols, nblocks, slot_sel, values_panel, dense,
                       *, mb: int, max_bpr: int, bm: int, bk: int, bn: int):
    """Panel SpMM over a SUBSET of each row's blocks, selected by slot.

    The panel slot visited at walk step ``s`` is ``slot_sel[i * max_bpr +
    s]`` — the values panel keeps its canonical layout while the walk is
    reordered/filtered. This lets the halo-overlap split
    (``parallel/sharded_ops.sharded_spmm_halo``) run the interior blocks
    against the LOCAL dense shard while the halo rows are still in
    flight. Returns ``f32[mb*bm, n_pad]`` holding ONLY the selected
    blocks' contributions (SpMM is linear in the block set)."""
    del mb, max_bpr, bm, bk
    return bsr_spmm_batched(
        block_cols[None], nblocks[None], values_panel[None], dense[None],
        bn=bn, slot_sel=slot_sel[None])[0]


def bsr_spmm(topo, values, dense, bias=None, *, bm: int = 128,
             bk: int = 128, bn: int = 128, epilogue: str = "none"):
    """CSR SpMM via the block panel: ``values[nnz_pad] x dense[n, n_out]
    -> [m, n_out]`` (optionally fused ``+ bias`` / ``relu``)."""
    bv = topo.block(bm, bk)
    m, n_out = topo.m, dense.shape[-1]
    n_pad = _round_up(max(n_out, 1), bn)
    flat = jnp.zeros((bv.dump + 1,), values.dtype)
    flat = flat.at[jnp.asarray(bv.scatter_idx)].set(values)
    panel = flat[: bv.dump].reshape(bv.values_shape)
    dense_pad = jnp.zeros((bv.n_pad, n_pad), dense.dtype)
    dense_pad = dense_pad.at[: dense.shape[0], :n_out].set(dense)
    bias_pad = None
    if bias is not None:
        bias_pad = jnp.zeros((bv.m_pad,), jnp.float32).at[:m].set(bias)
    out = bsr_spmm_batched(
        jnp.asarray(bv.block_cols.reshape(1, -1)),
        jnp.asarray(bv.nblocks[None]), panel[None],
        dense_pad.astype(panel.dtype)[None], bias_pad, bn=bn,
        epilogue=epilogue)[0]
    return out[:m, :n_out]
