"""Row partitioner: split one sparse topology across N devices.

Each device owns an equal-row-count shard of the matrix; because SPMD traces
one program for every device, per-shard topology metadata is *stacked data*
(``[ndev, ...]`` arrays sharded over the mesh axis and read by the
kernels), not per-device Python constants — the SPMD replacement for the
per-GPU topologies a CUDA framework would hold.

Load balance: nnz skew across equal row chunks is flattened by an optional
row *permutation* built from the row swizzle (longest-first round-robin over
devices — the distributed generalisation of Sputnik's ``diffsort``
scheduling, reference ``modules/spmm.py:4-6``). Outputs come back in
permuted order and are unpermuted once at the boundary.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..topology import SparseTopology, _round_up

__all__ = ["RowPartition"]


class RowPartition:
    """Static row partition of a topology over ``ndev`` devices.

    Attributes:
      ndev: number of shards.
      m_loc: rows per shard (``m`` padded up to a multiple of ``ndev * bm``).
      perm / inv_perm: global row permutation applied before sharding
        (``None`` -> identity). ``row_of_shard[d, i] = perm[d * m_loc + i]``.
      shards: per-device ``SparseTopology`` (equal ``m_loc``, shared
        ``nnz_pad`` bucket = max over shards).
    """

    def __init__(self, topo: SparseTopology, ndev: int, *,
                 balance: bool = True, bm: int = 128,
                 zigzag: bool = False):
        self.topo = topo
        self.ndev = ndev
        self.zigzag = bool(zigzag)
        if zigzag:
            balance = False  # zigzag IS the (ring-safe) balancing scheme
            m_pad = _round_up(topo.m, 2 * ndev * bm)
        else:
            m_pad = _round_up(topo.m, ndev * bm)
        self.m_loc = m_pad // ndev

        lengths = np.zeros(m_pad, np.int64)
        lengths[: topo.m] = topo.row_lengths
        if zigzag:
            # device d owns row chunks d and (2*ndev-1-d) of 2*ndev equal
            # contiguous chunks — the causal-attention load balancer for
            # the ring schedule: per-device work is uniform AND stays
            # slice-shaped (two contiguous runs, no element gathers at
            # the boundary; see RingFlashSpec.shard_queries).
            half = self.m_loc // 2
            perm = np.empty(m_pad, np.int64)
            for d in range(ndev):
                lo = d * self.m_loc
                perm[lo: lo + half] = np.arange(d * half, (d + 1) * half)
                c2 = 2 * ndev - 1 - d
                perm[lo + half: lo + self.m_loc] = np.arange(
                    c2 * half, (c2 + 1) * half)
            self.perm = perm
        elif balance:
            # longest-first serpentine round-robin over devices: device d,
            # pass p gets the (p*ndev + d)-th longest row on even passes and
            # the reversed pick on odd passes, evening out totals.
            order = np.argsort(-lengths, kind="stable")
            perm = np.empty(m_pad, np.int64)
            for p in range(self.m_loc):
                seg = order[p * ndev: (p + 1) * ndev]
                if p % 2:
                    seg = seg[::-1]
                for d in range(len(seg)):
                    perm[d * self.m_loc + p] = seg[d]
            self.perm = perm
        else:
            self.perm = np.arange(m_pad, dtype=np.int64)
        self.inv_perm = np.empty(m_pad, np.int64)
        self.inv_perm[self.perm] = np.arange(m_pad)

        # Build per-shard CSR from the permuted row view.
        ro, ci = topo.row_offsets, topo.column_indices
        shard_nnz = []
        shard_arrays = []
        for d in range(ndev):
            rows = self.perm[d * self.m_loc: (d + 1) * self.m_loc]
            lens = lengths[rows]
            offs = np.zeros(self.m_loc + 1, np.int32)
            np.cumsum(lens, out=offs[1:])
            cols = np.concatenate(
                [ci[ro[r]: ro[r + 1]] for r in rows if r < topo.m]
                or [np.zeros(0, np.int32)]
            ).astype(np.int32)
            shard_nnz.append(int(offs[-1]))
            shard_arrays.append((offs, cols))
        nnz_pad = _round_up(max(max(shard_nnz), 1), 4)
        self.shards: List[SparseTopology] = [
            SparseTopology(self.m_loc, topo.n, offs, cols, nnz_pad=nnz_pad)
            for offs, cols in shard_arrays
        ]
        self.nnz_pad = nnz_pad

    # -- stacked kernel metadata (device-varying data for shard_map) -------

    def stacked_block_meta(self, bm: int, bk: int):
        """``(block_cols [ndev, mb*max_bpr], nblocks [ndev, mb])`` with a
        common ``max_bpr`` across shards, plus the per-shard BlockViews
        (``blocking.stack_block_meta`` over the shards — one
        implementation of the repeat-pad/DMA-skip convention)."""
        from ..blocking import stack_block_meta

        key = (bm, bk)
        cached = getattr(self, "_stacked_meta_cache", None)
        if cached is None:
            cached = {}
            self._stacked_meta_cache = cached
        if key not in cached:
            views = [s.block(bm, bk) for s in self.shards]
            meta = stack_block_meta(views)
            cached[key] = (meta["block_cols"], meta["nblocks"],
                           meta["max_bpr"], views)
        return cached[key]

    def stacked_panel(self, values: np.ndarray, bm: int, bk: int,
                      max_bpr: Optional[int] = None) -> np.ndarray:
        """Global CSR values -> stacked per-shard panels
        ``[ndev, mb, max_bpr, bm, bk]`` (host-side, boundary only)."""
        from ..ops.panel_api import values_to_panel_np

        topo, ro = self.topo, self.topo.row_offsets
        values = np.asarray(values)  # dtype-preserving (bf16 streams)
        if max_bpr is None:
            _, _, max_bpr, _ = self.stacked_block_meta(bm, bk)
        panels = []
        for d, shard in enumerate(self.shards):
            rows = self.perm[d * self.m_loc: (d + 1) * self.m_loc]
            vals = np.concatenate(
                [values[ro[r]: ro[r + 1]] for r in rows if r < topo.m]
                or [np.zeros(0, values.dtype)]
            )
            v = np.zeros(shard.nnz_pad, values.dtype)
            v[: len(vals)] = vals
            p = values_to_panel_np(shard, v, bm, bk)
            mb, bpr = p.shape[0], p.shape[1]
            if bpr < max_bpr:
                p = np.concatenate(
                    [p, np.zeros((mb, max_bpr - bpr, bm, bk), p.dtype)],
                    axis=1,
                )
            panels.append(p)
        return np.stack(panels)

    def unpermute_rows(self, out):
        """Undo the balancing permutation on a row-major output
        ``[m_pad, ...] -> [m, ...]`` (host or device array)."""
        import jax.numpy as jnp

        return jnp.take(out, jnp.asarray(self.inv_perm[: self.topo.m]),
                        axis=0)
