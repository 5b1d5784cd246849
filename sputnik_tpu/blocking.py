"""Derived kernel-friendly views of a CSR topology.

Two static reformulations are precomputed on the host (numpy) and cached on
the topology; both are pure index bookkeeping — values flow through them with
single gathers/scatters that XLA fuses into the surrounding computation.

ELL view
    Rows padded to a common (lane-aligned) length ``Lpad``; values live in a
    dense ``[m, Lpad]`` panel. This is the layout of the Pallas sparse-softmax
    kernel (row-wise reduction with no gather at all) and of row-ragged VPU
    ops in general.

Block-CSR view (ELL at matrix-tile granularity)
    The matrix is cut into ``bm x bk`` tiles; tiles containing at least one
    nonzero are densified and listed per row-block, padded to the max
    blocks-per-row-block (``max_bpr``). This is the layout of the Pallas
    SpMM/SDDMM kernels: the "gather" of dense rows happens at *tile*
    granularity (each program reads its block columns and slices whole
    dense tiles), the block-level answer to Sputnik's per-row vector
    gathers (``third_party/sputnik`` CSR kernels — see SURVEY.md §7 "Hard
    parts" #1).

Padding conventions (shared with ``topology.py``): padded element slots point
at a dump slot one past the end of the flattened panel, padded block slots
point at column-block 0 and carry all-zero values, so every consumer drops
padding structurally.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["EllView", "BlockView", "CompressedView", "build_ell",
           "build_blocks", "build_compressed", "stack_block_meta"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class EllView:
    """Row-padded (ELLPACK) view of a CSR topology."""

    m: int
    l_pad: int                 # padded row length (multiple of `lane`)
    scatter_idx: np.ndarray    # i32[nnz_pad] -> flat index into m*l_pad (+1 dump)
    gather_idx: np.ndarray     # i32[nnz_pad] <- flat index to read back
    cols: np.ndarray           # i32[m, l_pad], padding -> 0
    mask: np.ndarray           # bool[m, l_pad]

    @property
    def values_shape(self) -> Tuple[int, int]:
        return (self.m, self.l_pad)

    @property
    def dump(self) -> int:
        return self.m * self.l_pad


def build_ell(topo, *, lane: int = 128) -> EllView:
    nnz, nnz_pad, m = topo.nnz, topo.nnz_pad, topo.m
    rows = topo.row_ids[:nnz].astype(np.int64)
    lengths = topo.row_lengths.astype(np.int64)
    l_pad = _round_up(max(int(lengths.max(initial=0)), 1), lane)

    # Position of each element within its row.
    pos_in_row = np.arange(nnz, dtype=np.int64) - topo.row_offsets[rows]
    flat = rows * l_pad + pos_in_row
    dump = m * l_pad

    scatter_idx = np.full(nnz_pad, dump, dtype=np.int32)
    scatter_idx[:nnz] = flat
    gather_idx = scatter_idx  # identical map, used in both directions

    cols = np.zeros((m, l_pad), dtype=np.int32)
    mask = np.zeros((m, l_pad), dtype=bool)
    cols.reshape(-1)[flat] = topo.column_indices[:nnz]
    mask.reshape(-1)[flat] = True

    return EllView(m=m, l_pad=int(l_pad), scatter_idx=scatter_idx,
                   gather_idx=gather_idx, cols=cols, mask=mask)


@dataclasses.dataclass(frozen=True)
class BlockView:
    """Block-CSR (tile-level ELL) view of a CSR topology."""

    bm: int
    bk: int
    mb: int                    # number of row-blocks   (m_pad / bm)
    kb: int                    # number of col-blocks   (n_pad / bk)
    max_bpr: int               # padded blocks per row-block
    num_blocks: int            # real (non-padding) nonzero tiles
    block_cols: np.ndarray     # i32[mb, max_bpr]; padding -> 0
    block_valid: np.ndarray    # bool[mb, max_bpr]
    nblocks: np.ndarray        # i32[mb] real blocks per row-block
    scatter_idx: np.ndarray    # i32[nnz_pad] -> flat into mb*max_bpr*bm*bk (+1)
    gather_idx: np.ndarray     # i32[nnz_pad] <- same flat indexing
    mask: np.ndarray           # bool[mb, max_bpr, bm, bk] real-element mask

    @property
    def m_pad(self) -> int:
        return self.mb * self.bm

    @property
    def n_pad(self) -> int:
        return self.kb * self.bk

    @property
    def values_shape(self) -> Tuple[int, int, int, int]:
        return (self.mb, self.max_bpr, self.bm, self.bk)

    @property
    def dump(self) -> int:
        return self.mb * self.max_bpr * self.bm * self.bk

    @property
    def block_density(self) -> float:
        """Fraction of tiles that must be touched (compute/traffic ratio
        vs. a dense matmul) — the roofline input for the Pallas kernels."""
        return self.num_blocks / max(self.mb * self.kb, 1)

    def transpose_meta(self):
        """Transposed block list: for each *column*-block ``j`` of A, the
        ``(row_block, slot)`` pairs holding a block in column ``j``.

        Returns ``(t_nblocks i32[kb], t_src i32[kb, max_bpc, 2])`` where
        ``t_src[j, u] = (i, s)`` means panel block ``(i, s)`` sits at block
        column ``j``; padded slots repeat the last valid pair (or (0, 0)) so
        a Pallas index_map revisits the previous block and skips the DMA.
        This is what lets ``A^T @ G`` run straight off the *original* panel —
        no value permutation, unlike the reference's cuSPARSE CSR->CSC
        conversion per backward (``src/transpose_cuda.cu:90-99``).
        """
        cached = getattr(self, "_transpose_meta_cache", None)
        if cached is not None:
            return cached
        kb, mb, max_bpr = self.kb, self.mb, self.max_bpr
        pairs = [[] for _ in range(kb)]
        for i in range(mb):
            for s in range(int(self.nblocks[i])):
                pairs[int(self.block_cols[i, s])].append((i, s))
        max_bpc = max((len(p) for p in pairs), default=1)
        max_bpc = max(max_bpc, 1)
        t_nblocks = np.array([len(p) for p in pairs], dtype=np.int32)
        t_src = np.zeros((kb, max_bpc, 2), dtype=np.int32)
        for j, p in enumerate(pairs):
            for u, (i, s) in enumerate(p):
                t_src[j, u] = (i, s)
            if 0 < len(p) < max_bpc:
                t_src[j, len(p):] = t_src[j, len(p) - 1]
        object.__setattr__(self, "_transpose_meta_cache",
                           (t_nblocks, t_src))
        return t_nblocks, t_src


def build_blocks(topo, *, bm: int, bk: int) -> BlockView:
    nnz, nnz_pad = topo.nnz, topo.nnz_pad
    mb = max(-(-topo.m // bm), 1)
    kb = max(-(-topo.n // bk), 1)

    from . import _native

    got = _native.block_build(
        topo.row_ids[:nnz], topo.column_indices[:nnz], bm, bk, mb, kb
    )
    if got is not None:
        nblocks, block_cols, flat32, max_bpr = got
        flat = flat32.astype(np.int64)
        block_valid = np.zeros((mb, max_bpr), dtype=bool)
        for i in range(mb):
            block_valid[i, : nblocks[i]] = True
        dump = mb * max_bpr * bm * bk
        scatter_idx = np.full(nnz_pad, dump, dtype=np.int32)
        scatter_idx[:nnz] = flat32
        gather_idx = scatter_idx  # identical map, used in both directions
        mask = np.zeros((mb, max_bpr, bm, bk), dtype=bool)
        mask.reshape(-1)[flat] = True
        return BlockView(
            bm=bm, bk=bk, mb=int(mb), kb=int(kb), max_bpr=int(max_bpr),
            num_blocks=int(nblocks.sum()), block_cols=block_cols,
            block_valid=block_valid, nblocks=nblocks,
            scatter_idx=scatter_idx, gather_idx=gather_idx, mask=mask,
        )

    rows = topo.row_ids[:nnz].astype(np.int64)
    cols = topo.column_indices[:nnz].astype(np.int64)
    rb, cb = rows // bm, cols // bk

    key = rb * kb + cb
    uniq, inv = np.unique(key, return_inverse=True)  # sorted by (rb, cb)
    urb = uniq // kb
    counts = np.bincount(urb, minlength=mb).astype(np.int64)
    starts = np.zeros(mb + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot_of_uniq = np.arange(len(uniq), dtype=np.int64) - starts[urb]
    max_bpr = max(int(counts.max(initial=0)), 1)

    block_cols = np.zeros((mb, max_bpr), dtype=np.int32)
    block_valid = np.zeros((mb, max_bpr), dtype=bool)
    block_cols[urb, slot_of_uniq] = (uniq % kb).astype(np.int32)
    block_valid[urb, slot_of_uniq] = True
    # Padded slots repeat the row-block's last valid column (0 if the row
    # block is empty): a Pallas index_map that lands on the same block as the
    # previous grid step skips the DMA entirely, so padding costs no traffic.
    for i in range(mb):
        c = int(counts[i])
        if 0 < c < max_bpr:
            block_cols[i, c:] = block_cols[i, c - 1]

    slot_e = slot_of_uniq[inv]
    r_in, c_in = rows % bm, cols % bk
    flat = ((rb * max_bpr + slot_e) * bm + r_in) * bk + c_in
    dump = mb * max_bpr * bm * bk

    scatter_idx = np.full(nnz_pad, dump, dtype=np.int32)
    scatter_idx[:nnz] = flat
    gather_idx = scatter_idx  # identical map, used in both directions

    mask = np.zeros((mb, max_bpr, bm, bk), dtype=bool)
    mask.reshape(-1)[flat] = True

    return BlockView(
        bm=bm, bk=bk, mb=int(mb), kb=int(kb), max_bpr=int(max_bpr),
        num_blocks=int(len(uniq)), block_cols=block_cols,
        block_valid=block_valid, nblocks=counts.astype(np.int32),
        scatter_idx=scatter_idx, gather_idx=gather_idx, mask=mask,
    )


def stack_block_meta(views):
    """Stack per-topology BlockViews (equal ``m``/``n``/tiles) to common
    ``max_bpr``/``max_bpc`` batch metadata for the batched/sharded kernels.

    Returns a dict with: ``block_cols [B, mb*max_bpr]``, ``nblocks [B, mb]``,
    ``mask [B, mb, max_bpr, bm, bk]`` (f32), ``t_src_i/t_src_s
    [B, kb*max_bpc]``, ``t_nblocks [B, kb]``, ``max_bpr``, ``max_bpc``.
    Padded block slots repeat the last valid entry so Pallas index maps
    revisit the previous block and skip the DMA.
    """
    B = len(views)
    v0 = views[0]
    mb, kb, bm, bk = v0.mb, v0.kb, v0.bm, v0.bk
    max_bpr = max(v.max_bpr for v in views)
    cols = np.zeros((B, mb * max_bpr), np.int32)
    nblk = np.zeros((B, mb), np.int32)
    mask = np.zeros((B, mb, max_bpr, bm, bk), np.float32)
    for b, v in enumerate(views):
        c = np.zeros((mb, max_bpr), np.int32)
        c[:, : v.max_bpr] = v.block_cols
        for i in range(mb):
            nb = int(v.nblocks[i])
            if 0 < nb < max_bpr:
                c[i, nb:] = c[i, nb - 1]
        cols[b] = c.reshape(-1)
        nblk[b] = v.nblocks
        mask[b, :, : v.max_bpr] = v.mask

    metas = [v.transpose_meta() for v in views]
    max_bpc = max(ts.shape[1] for _, ts in metas)
    ti = np.zeros((B, kb * max_bpc), np.int32)
    ts_ = np.zeros((B, kb * max_bpc), np.int32)
    tn = np.zeros((B, kb), np.int32)
    for b, (tnb, tsrc) in enumerate(metas):
        pad = np.zeros((kb, max_bpc, 2), np.int32)
        pad[:, : tsrc.shape[1]] = tsrc
        for j in range(kb):
            nb = int(tnb[j])
            if 0 < nb < max_bpc:
                pad[j, nb:] = pad[j, nb - 1]
        ti[b] = pad[:, :, 0].reshape(-1)
        ts_[b] = pad[:, :, 1].reshape(-1)
        tn[b] = tnb
    return dict(block_cols=cols, nblocks=nblk, mask=mask, t_src_i=ti,
                t_src_s=ts_, t_nblocks=tn, max_bpr=int(max_bpr),
                max_bpc=int(max_bpc), mb=mb, kb=kb, bm=bm, bk=bk)


@dataclasses.dataclass(frozen=True)
class CompressedView:
    """True-BSR (offset-indexed) view: blocks stored back-to-back.

    Unlike ``BlockView`` (ELL at block level: every row-block padded to
    ``max_bpr`` slots), blocks here are concatenated and addressed through
    ``block_offsets`` — a topology with one dense row among sparse ones
    stores only its real blocks instead of inflating every row-block to
    the global maximum. Values live as ``[num_blocks + 1, bm, bk]`` (last
    block is an always-zero dump used by padded grid steps).
    """

    bm: int
    bk: int
    mb: int
    kb: int
    num_blocks: int
    max_bpr: int               # max real blocks in any row-block (grid bound)
    block_offsets: np.ndarray  # i32[mb + 1]
    block_cols: np.ndarray     # i32[num_blocks + 1] (dump repeats last)
    block_rows: np.ndarray     # i32[num_blocks + 1] row-block of each block
    scatter_idx: np.ndarray    # i32[nnz_pad] -> flat into (num_blocks+1)*bm*bk
    gather_idx: np.ndarray     # i32[nnz_pad] <- same
    mask: np.ndarray           # bool[num_blocks + 1, bm, bk]

    @property
    def m_pad(self) -> int:
        return self.mb * self.bm

    @property
    def n_pad(self) -> int:
        return self.kb * self.bk

    @property
    def values_shape(self):
        return (self.num_blocks + 1, self.bm, self.bk)

    @property
    def dump(self) -> int:
        return (self.num_blocks + 1) * self.bm * self.bk

    def transpose_meta(self):
        """(t_nblocks i32[kb], t_src i32[kb, max_bpc, 2]) where
        ``t_src[j, u] = (global_block_id, row_block)``; padding repeats the
        last valid pair (dump block for empty columns)."""
        cached = getattr(self, "_transpose_meta_cache", None)
        if cached is not None:
            return cached
        pairs = [[] for _ in range(self.kb)]
        for g in range(self.num_blocks):
            pairs[int(self.block_cols[g])].append(
                (g, int(self.block_rows[g])))
        max_bpc = max(max((len(p) for p in pairs), default=1), 1)
        t_nblocks = np.array([len(p) for p in pairs], dtype=np.int32)
        t_src = np.full((self.kb, max_bpc, 2), self.num_blocks, np.int32)
        t_src[:, :, 1] = 0
        for j, p in enumerate(pairs):
            for u, (g, rb) in enumerate(p):
                t_src[j, u] = (g, rb)
            if 0 < len(p) < max_bpc:
                t_src[j, len(p):] = t_src[j, len(p) - 1]
        object.__setattr__(self, "_transpose_meta_cache", (t_nblocks, t_src))
        return t_nblocks, t_src


def build_compressed(topo, *, bm: int, bk: int) -> CompressedView:
    """Derive the compressed view from the (cached) BlockView — pure index
    remapping, no extra passes over the elements."""
    bv = topo.block(bm, bk)
    mb, kb, max_bpr = bv.mb, bv.kb, bv.max_bpr
    starts = np.zeros(mb + 1, np.int64)
    np.cumsum(bv.nblocks, out=starts[1:])
    num_blocks = int(starts[-1])

    block_cols = np.zeros(num_blocks + 1, np.int32)
    block_rows = np.zeros(num_blocks + 1, np.int32)
    for i in range(mb):
        nb = int(bv.nblocks[i])
        block_cols[starts[i]: starts[i] + nb] = bv.block_cols[i, :nb]
        block_rows[starts[i]: starts[i] + nb] = i
    if num_blocks:
        block_cols[num_blocks] = block_cols[num_blocks - 1]
        block_rows[num_blocks] = block_rows[num_blocks - 1]

    # remap element scatter indices: ELL slot -> compressed slot
    tile = bm * bk
    old = bv.scatter_idx.astype(np.int64)
    blk = old // tile
    within = old % tile
    rb = blk // max_bpr
    s = blk % max_bpr
    is_pad = old >= bv.dump
    gblk = np.where(is_pad, num_blocks, starts[np.minimum(rb, mb - 1)] + s)
    flat = (gblk * tile + np.where(is_pad, 0, within)).astype(np.int32)

    mask = np.zeros((num_blocks + 1, bm, bk), bool)
    mask.reshape(-1)[flat[~is_pad]] = True

    return CompressedView(
        bm=bm, bk=bk, mb=mb, kb=kb, num_blocks=num_blocks,
        max_bpr=int(bv.nblocks.max(initial=1)),
        block_offsets=starts.astype(np.int32),
        block_cols=block_cols, block_rows=block_rows,
        scatter_idx=flat, gather_idx=flat, mask=mask,
    )
