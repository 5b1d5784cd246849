"""Sparse topology: the framework's core data type.

A ``SparseTopology`` describes *where* the nonzeros of an ``m x n`` sparse
matrix live; a ``SparseMatrix`` pairs a topology with a value vector. The
representation is CSR with a row-processing order ("row swizzle"), mirroring
the reference framework's four-array convention (Torch-Sputnik,
``tests/sparse_matrix.py:9-41``):

  - ``values        : f32[nnz]``   nonzero values (held *outside* the topology)
  - ``row_offsets   : i32[m+1]``   cumulative row lengths
  - ``column_indices: i32[nnz]``   column of each nonzero
  - ``row_swizzle   : i32[m]``     row *processing order*, longest rows first
                                   (the reference calls this ``row_indices`` /
                                   ``diffsort``, ``modules/spmm.py:4-6``)

Design decisions (vs. the reference's CUDA layout):

  * **Static shapes.** XLA compiles fixed shapes, so ``nnz`` is padded up to a
    static ``nnz_pad`` (a multiple of ``pad_to``; the reference rounds nnz to
    multiples of 4 for CUDA vector loads, ``tests/connectors.py:49-52``, and
    so do we by default). Padding slots carry
    ``column == 0`` and an out-of-range expanded row id (``row == m``) so
    every op drops them structurally — no runtime masks on the hot path.
  * **Expanded row ids.** ``row_ids: i32[nnz_pad]`` (the COO row of each
    nonzero) are precomputed so SpMM/SDDMM lower to gathers + segment
    reductions — the idiomatic XLA formulation.
  * **Topology is static.** Topologies are built on the host with numpy and
    are hashable by identity, so ops can take them via
    ``jax.custom_vjp(..., nondiff_argnums=(0,))`` and jitted functions can
    close over them. Values are the only traced/trainable part.
  * **Transpose is a permutation.** CSR -> CSC only permutes *values* once the
    topology is fixed, so the transpose permutation is precomputed at build
    time and the hot-path transpose is a single gather (the reference pays a
    cuSPARSE ``Csr2cscEx2`` call per backward, ``src/transpose_cuda.cu:90-99``).
  * **Block-CSR view.** ``topology.block(bm, bk)`` derives a tile-level
    block-sparse view (see ``blocking.py``) consumed by the Pallas kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "SparseTopology",
    "SparseMatrix",
    "diffsort",
    "dense_to_csr_arrays",
    "DEFAULT_PAD_TO",
]

# The reference pads nnz to multiples of 4 (CUDA float4 loads); tiny test
# matrices are common, so keep the reference-compatible default and let
# callers opt into wider padding.
DEFAULT_PAD_TO = 4


def diffsort(row_offsets: np.ndarray) -> np.ndarray:
    """Row processing order: longest rows first (stable).

    This is Sputnik's load-balancing row swizzle. NOTE: the reference's
    ``diffsort`` (``modules/spmm.py:4-6``) computes ``argsort(-lengths,
    descending=True)`` which actually yields *shortest*-first; since the order
    only affects scheduling, not semantics, we implement the documented
    intent ("needed for load balance", longest first). No kernel consumes
    this order (each block-row is its own program) — the load balancing
    that matters lives in the distributed partitioner
    (``parallel/partition.py``: nnz-balanced serpentine assignment of
    row-blocks to devices). This function is kept as the reference-parity
    single-chip definition.
    """
    row_offsets = np.asarray(row_offsets)
    lengths = row_offsets[1:] - row_offsets[:-1]
    return np.argsort(-lengths, kind="stable").astype(np.int32)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dense_to_csr_arrays(matrix: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Dense numpy matrix -> (values, row_offsets, column_indices).

    Equivalent of the reference's ``_dense_to_sparse``
    (``tests/sparse_matrix.py:9-41``) without the torch round trip. Uses the
    native C builder (``_native/topology.c``) when available.
    """
    matrix = np.asarray(matrix)
    assert matrix.ndim == 2, f"expected 2-D matrix, got {matrix.shape}"
    if matrix.dtype == np.float32 or matrix.dtype == np.float64:
        from . import _native

        got = _native.csr_from_dense(matrix.astype(np.float32, copy=False))
        if got is not None:
            return got
    mask = matrix != 0
    values = matrix[mask].astype(np.float32)
    lengths = mask.sum(axis=1).astype(np.int64)
    row_offsets = np.zeros(matrix.shape[0] + 1, dtype=np.int32)
    np.cumsum(lengths, out=row_offsets[1:])
    column_indices = np.nonzero(mask)[1].astype(np.int32)
    return values, row_offsets, column_indices


class SparseTopology:
    """Static sparsity pattern of an ``m x n`` matrix (host-side numpy).

    Hashable by identity so it can be a ``nondiff_argnums`` argument of
    ``jax.custom_vjp`` ops and a static field of flax modules. All derived
    structure (expanded row ids, transpose permutation, ELL / block views)
    is cached on the instance.
    """

    __slots__ = (
        "m",
        "n",
        "nnz",
        "nnz_pad",
        "row_offsets",
        "column_indices",
        "row_ids",
        "row_swizzle",
        "valid",
        "_transpose_cache",
        "_ell_cache",
        "_block_cache",
    )

    def __init__(
        self,
        m: int,
        n: int,
        row_offsets: np.ndarray,
        column_indices: np.ndarray,
        *,
        pad_to: int = DEFAULT_PAD_TO,
        nnz_pad: Optional[int] = None,
    ):
        row_offsets = np.ascontiguousarray(row_offsets, dtype=np.int32)
        column_indices = np.ascontiguousarray(column_indices, dtype=np.int32)
        assert row_offsets.shape == (m + 1,), (row_offsets.shape, m)
        nnz = int(row_offsets[-1])
        assert column_indices.shape[0] >= nnz
        column_indices = column_indices[:nnz]
        if nnz_pad is None:
            nnz_pad = _round_up(max(nnz, 1), pad_to)
        assert nnz_pad >= nnz

        self.m = int(m)
        self.n = int(n)
        self.nnz = nnz
        self.nnz_pad = int(nnz_pad)
        self.row_offsets = row_offsets

        # Pad column indices with 0 (any in-range column works: padded slots
        # are dropped via the out-of-range expanded row id below).
        ci = np.zeros(self.nnz_pad, dtype=np.int32)
        ci[:nnz] = column_indices
        self.column_indices = ci

        # Expanded COO row ids; padding slots get row == m so that
        # segment-reductions with num_segments == m + 1 park them in a dump
        # row that is sliced away.
        row_ids = np.full(self.nnz_pad, self.m, dtype=np.int32)
        row_ids[:nnz] = np.repeat(
            np.arange(self.m, dtype=np.int32),
            (row_offsets[1:] - row_offsets[:-1]).astype(np.int64),
        )
        self.row_ids = row_ids

        self.row_swizzle = diffsort(row_offsets)
        # bool[nnz_pad]; True for real (non-padding) slots.
        self.valid = np.arange(self.nnz_pad) < nnz

        self._transpose_cache = None
        self._ell_cache = None
        self._block_cache = {}

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_dense_mask(
        cls, mask: np.ndarray, *, pad_to: int = DEFAULT_PAD_TO
    ) -> "SparseTopology":
        mask = np.asarray(mask)
        _, row_offsets, column_indices = dense_to_csr_arrays(
            (mask != 0).astype(np.float32)
        )
        return cls(mask.shape[0], mask.shape[1], row_offsets, column_indices,
                   pad_to=pad_to)

    # -- identity hashing (topology is static structure) --------------------

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        density = self.nnz / max(self.m * self.n, 1)
        return (
            f"SparseTopology(m={self.m}, n={self.n}, nnz={self.nnz}, "
            f"nnz_pad={self.nnz_pad}, density={density:.4f})"
        )

    # -- derived structure --------------------------------------------------

    @property
    def row_lengths(self) -> np.ndarray:
        return (self.row_offsets[1:] - self.row_offsets[:-1]).astype(np.int32)

    def to_dense_mask(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), dtype=np.float32)
        rows = self.row_ids[: self.nnz]
        cols = self.column_indices[: self.nnz]
        out[rows, cols] = 1.0
        return out

    def transpose(self) -> Tuple["SparseTopology", np.ndarray]:
        """Transposed topology + value permutation.

        Returns ``(topo_t, perm)`` where ``perm: i32[topo_t.nnz_pad]`` maps a
        slot of the transposed value vector to its source slot, i.e.
        ``values_t = values[perm]``. Replaces the reference's per-backward
        cuSPARSE CSR->CSC conversion (``src/transpose_cuda.cu:90-99``) with a
        one-time precompute.
        """
        if self._transpose_cache is not None:
            return self._transpose_cache

        from . import _native

        got = _native.transpose_perm(
            self.row_ids[: self.nnz], self.column_indices[: self.nnz], self.n
        )
        if got is not None:
            row_offsets_t, column_indices_t, order = got
        else:
            rows = self.row_ids[: self.nnz].astype(np.int64)
            cols = self.column_indices[: self.nnz].astype(np.int64)
            # CSC order: sort by (col, row); stable lexsort keys reversed.
            order = np.lexsort((rows, cols)).astype(np.int32)
            counts = np.bincount(cols, minlength=self.n)
            row_offsets_t = np.zeros(self.n + 1, dtype=np.int32)
            np.cumsum(counts, out=row_offsets_t[1:])
            column_indices_t = rows[order].astype(np.int32)

        topo_t = SparseTopology(
            self.n,
            self.m,
            row_offsets_t,
            column_indices_t,
            nnz_pad=self.nnz_pad,
        )
        perm = np.full(topo_t.nnz_pad, min(self.nnz, self.nnz_pad - 1),
                       dtype=np.int32)
        # Padding slots point at a padding slot of the source when one
        # exists (source padding values are structurally ignored anyway).
        perm[: self.nnz] = order
        if self.nnz < self.nnz_pad:
            perm[self.nnz:] = self.nnz  # a guaranteed-padding source slot

        # Cache the reverse direction too: transposing twice must yield the
        # original topology object (so double-backward reuses compiled
        # code). Padding slots (if any) point at a guaranteed-padding slot
        # of the transposed vector; valid slots are the inverse permutation.
        fill = self.nnz if self.nnz < self.nnz_pad else 0
        inv = np.full(self.nnz_pad, fill, dtype=np.int32)
        inv[order] = np.arange(self.nnz, dtype=np.int32)
        topo_t._transpose_cache = (self, inv)

        self._transpose_cache = (topo_t, perm)
        return self._transpose_cache

    def ell(self, *, lane: int = 128):
        from .blocking import build_ell  # local import to avoid cycle

        # keyed by lane, like block()'s (bm, bk) cache — a divisibility
        # check would hand a 512-lane view to a 128-lane consumer (4x
        # wider panel) and thrash on alternating lane sizes
        if self._ell_cache is None:
            self._ell_cache = {}
        if lane not in self._ell_cache:
            self._ell_cache[lane] = build_ell(self, lane=lane)
        return self._ell_cache[lane]

    def block(self, bm: int = 128, bk: int = 128):
        key = (bm, bk)
        if key not in self._block_cache:
            from .blocking import build_blocks  # local import to avoid cycle

            self._block_cache[key] = build_blocks(self, bm=bm, bk=bk)
        return self._block_cache[key]


class SparseMatrix:
    """values + topology. Mirrors the reference's ``SparseMatrix`` fixture
    (``tests/sparse_matrix.py:96-179``) but as a host-side builder: the value
    vector it produces is a plain array, ready to become a trainable param.
    """

    def __init__(self, matrix: np.ndarray, *, pad_to: int = DEFAULT_PAD_TO):
        matrix = np.asarray(matrix, dtype=np.float32)
        values, row_offsets, column_indices = dense_to_csr_arrays(matrix)
        self.topology = SparseTopology(
            matrix.shape[0], matrix.shape[1], row_offsets, column_indices,
            pad_to=pad_to,
        )
        v = np.zeros(self.topology.nnz_pad, dtype=np.float32)
        v[: self.topology.nnz] = values
        self.values = v
        self.shape = matrix.shape

    @property
    def dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float32)
        t = self.topology
        out[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = (
            self.values[: t.nnz]
        )
        return out
