"""Many-mask (ragged batched) topology and ops.

The reference's transformer demo calls a phantom ``*_many_mask`` binding
family (never implemented in its C++ layer — ``src/sputnik.cpp:36-42`` binds
none of them): per-batch-element masks with *different nnz per mask*, stacked
``row_offsets [b, m+1]`` / concatenated ``column_indices``, an ``nnzs [b]``
vector, and ``b*h`` operand replicas where the ``h`` heads of a batch element
share its mask (``tests/transformer/utils.py:17-38``,
``tests/test_attention_many_masks.py:90-155``). This module implements the
family for real, as first-class differentiable ops.

Static-shape raggedness: XLA needs static shapes, so instead of the reference's
flat concatenation each mask's CSR is padded to the *shared* max ``nnz_pad``
(SURVEY.md §7 "Hard parts" #2 — pad-to-bucket). Values are ``[R, nnz_pad]``
with ``R = b*h``; padding slots are dropped structurally exactly as in the
single-mask case. The per-mask arrays are stacked host constants and the ops
are double ``vmap``s (heads x masks) over the single-mask XLA cores, with the
same backward algebra as ``ops/api.py``.
"""

from __future__ import annotations

import functools
from typing import List, Tuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ops import xla_ops
from .topology import DEFAULT_PAD_TO, SparseTopology, _round_up

__all__ = [
    "ManyMaskTopology",
    "spmm_many_mask",
    "sddmm_many_mask",
    "sparse_softmax_many_mask",
    "csr_transpose_many_mask",
]


class ManyMaskTopology:
    """A batch of ``b`` sparsity patterns over a shared ``m x n`` shape.

    Static and hashable by identity, like ``SparseTopology``. Arrays are
    stacked with a shared ``nnz_pad`` bucket.
    """

    def __init__(self, topologies: List[SparseTopology],
                 pad_to: Optional[int] = None):
        assert topologies, "need at least one mask"
        m, n = topologies[0].m, topologies[0].n
        for t in topologies:
            assert (t.m, t.n) == (m, n), "masks must share [m, n]"
        self.b = len(topologies)
        self.m, self.n = m, n
        self.nnzs = np.array([t.nnz for t in topologies], dtype=np.int32)
        # shared bucket multiple; pass pad_to=128 to keep the wider
        # alignment a member was built with (the default mirrors the
        # reference's round-to-4, topology.DEFAULT_PAD_TO)
        self.nnz_pad = _round_up(int(self.nnzs.max(initial=1)),
                                 pad_to or DEFAULT_PAD_TO)

        def pad_slot(t, arr, fill):
            out = np.full(self.nnz_pad, fill, dtype=arr.dtype)
            out[: min(t.nnz, self.nnz_pad)] = arr[: t.nnz]
            return out

        self.column_indices = np.stack(
            [pad_slot(t, t.column_indices, 0) for t in topologies]
        )
        self.row_ids = np.stack([pad_slot(t, t.row_ids, m) for t in topologies])
        self.valid = np.stack(
            [np.arange(self.nnz_pad) < t.nnz for t in topologies]
        )
        self.row_offsets = np.stack([t.row_offsets for t in topologies])
        self.row_swizzle = np.stack([t.row_swizzle for t in topologies])
        self.topologies = list(topologies)
        self._transpose_cache = None

    @classmethod
    def from_dense_masks(cls, masks: np.ndarray,
                         pad_to: Optional[int] = None) -> "ManyMaskTopology":
        """masks: [b, m, n] (e.g. the per-step attention mask tensor the
        reference converts on every forward, ``tests/transformer/modules.py:29``
        — here you build once and cache)."""
        masks = np.asarray(masks)
        assert masks.ndim == 3, masks.shape
        return cls([SparseTopology.from_dense_mask(mk) for mk in masks],
                   pad_to=pad_to)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return (
            f"ManyMaskTopology(b={self.b}, m={self.m}, n={self.n}, "
            f"nnzs={self.nnzs.tolist()}, nnz_pad={self.nnz_pad})"
        )

    def transpose(self) -> Tuple["ManyMaskTopology", np.ndarray]:
        """Transposed batch topology + stacked value permutation [b, nnz_pad]."""
        if self._transpose_cache is not None:
            return self._transpose_cache
        topo_ts, perms = [], []
        for t in self.topologies:
            tt, perm = t.transpose()
            topo_ts.append(tt)
            perms.append(perm)
        mt_t = ManyMaskTopology(topo_ts)

        def rebucket(perms_list, src_pad, dst_pad):
            # A perm entry is a *source slot* in the per-mask bucket; valid
            # targets always index valid sources (< nnz), and padding targets
            # only ever index padding, whose value is ignored structurally —
            # so clipping into the batch bucket is safe.
            out = np.zeros((self.b, dst_pad), dtype=np.int32)
            for i, (t, perm) in enumerate(zip(self.topologies, perms_list)):
                p = np.minimum(perm, src_pad - 1)
                take = min(len(p), dst_pad)
                out[i] = min(t.nnz, src_pad - 1)
                out[i, :take] = p[:take]
            return out

        perm_stack = rebucket(perms, self.nnz_pad, mt_t.nnz_pad)
        # Cache the reverse direction so transpose(transpose(mt)) is `mt`
        # itself (keeps double-backward on one compiled topology).
        inv_list = [tt.transpose()[1] for tt in topo_ts]
        inv_stack = rebucket(inv_list, mt_t.nnz_pad, self.nnz_pad)
        mt_t._transpose_cache = (self, inv_stack)
        self._transpose_cache = (mt_t, perm_stack)
        return self._transpose_cache


# ---------------------------------------------------------------------------
# Impl cores: double vmap (masks b, heads h) over the single-mask XLA ops.
# Operands are [b, h, ...]; topology constants are stacked [b, ...] numpy.
# ---------------------------------------------------------------------------


def _split_bh(mt, x):
    r = x.shape[0]
    if r % mt.b:
        raise ValueError(f"replica dim {r} not a multiple of b={mt.b}")
    return x.reshape(mt.b, r // mt.b, *x.shape[1:])


def _merge_bh(x):
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _mm_spmm_impl(mt, values_bh, dense_bh):
    per_mask = jax.vmap(
        lambda ci, ri, v, d: xla_ops.spmm(v, ci, ri, mt.m, d),
        in_axes=(None, None, 0, 0),
    )
    return jax.vmap(per_mask, in_axes=(0, 0, 0, 0))(
        jnp.asarray(mt.column_indices), jnp.asarray(mt.row_ids),
        values_bh, dense_bh,
    )


def _mm_sddmm_impl(mt, lhs_bh, rhs_bh):
    per_mask = jax.vmap(
        lambda ci, ri, va, l, r: xla_ops.sddmm(l, r, ri, ci, va),
        in_axes=(None, None, None, 0, 0),
    )
    return jax.vmap(per_mask, in_axes=(0, 0, 0, 0, 0))(
        jnp.asarray(mt.column_indices), jnp.asarray(mt.row_ids),
        jnp.asarray(mt.valid), lhs_bh, rhs_bh,
    )


def _mm_softmax_impl(mt, values_bh):
    per_mask = jax.vmap(
        lambda ri, va, v: xla_ops.sparse_softmax(v, ri, va, mt.m),
        in_axes=(None, None, 0),
    )
    return jax.vmap(per_mask, in_axes=(0, 0, 0))(
        jnp.asarray(mt.row_ids), jnp.asarray(mt.valid), values_bh
    )


def _mm_transpose_values(mt, values_bh):
    _, perm = mt.transpose()
    take = jax.vmap(
        lambda p, v: jnp.take(v, p), in_axes=(None, 0)
    )
    return jax.vmap(take, in_axes=(0, 0))(jnp.asarray(perm), values_bh)


# ---------------------------------------------------------------------------
# custom_vjp cores on [b, h, ...] operands.
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _mm_spmm(mt, values, dense):
    return _mm_spmm_impl(mt, values, dense)


def _mm_spmm_fwd(mt, values, dense):
    return _mm_spmm_impl(mt, values, dense), (values, dense)


def _mm_spmm_bwd(mt, res, g):
    values, dense = res
    d_values = _mm_sddmm_impl(mt, g, dense)
    mt_t, _ = mt.transpose()
    d_dense = _mm_spmm_impl(mt_t, _mm_transpose_values(mt, values), g)
    return d_values, d_dense


_mm_spmm.defvjp(_mm_spmm_fwd, _mm_spmm_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _mm_sddmm(mt, lhs, rhs):
    return _mm_sddmm_impl(mt, lhs, rhs)


def _mm_sddmm_fwd(mt, lhs, rhs):
    return _mm_sddmm_impl(mt, lhs, rhs), (lhs, rhs)


def _mm_sddmm_bwd(mt, res, g):
    lhs, rhs = res
    d_lhs = _mm_spmm_impl(mt, g, rhs)
    mt_t, _ = mt.transpose()
    d_rhs = _mm_spmm_impl(mt_t, _mm_transpose_values(mt, g), lhs)
    return d_lhs, d_rhs


_mm_sddmm.defvjp(_mm_sddmm_fwd, _mm_sddmm_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _mm_softmax(mt, values):
    return _mm_softmax_impl(mt, values)


def _mm_softmax_fwd(mt, values):
    p = _mm_softmax_impl(mt, values)
    return p, p


def _mm_softmax_bwd(mt, p, g):
    per_mask = jax.vmap(
        lambda ri, pp, gg: xla_ops.softmax_vjp(pp, gg, ri, mt.m),
        in_axes=(None, 0, 0),
    )
    gx = jax.vmap(per_mask, in_axes=(0, 0, 0))(
        jnp.asarray(mt.row_ids), p, g
    )
    return (gx,)


_mm_softmax.defvjp(_mm_softmax_fwd, _mm_softmax_bwd)


# ---------------------------------------------------------------------------
# Public API: [R = b*h, ...] replica layout, reference-style.
# ---------------------------------------------------------------------------


def spmm_many_mask(mt, values, dense):
    """``values [R, nnz_pad] x dense [R, k, n] -> [R, m, n]`` where replica
    ``r`` uses mask ``r // (R/b)`` (heads share their batch's mask)."""
    out = _mm_spmm(mt, _split_bh(mt, values), _split_bh(mt, dense))
    return _merge_bh(out)


def sddmm_many_mask(mt, lhs, rhs):
    """``lhs [R, m, d] x rhs [R, n, d] -> values [R, nnz_pad]``."""
    out = _mm_sddmm(mt, _split_bh(mt, lhs), _split_bh(mt, rhs))
    return _merge_bh(out)


def sparse_softmax_many_mask(mt, values):
    """Ragged row softmax per mask: ``[R, nnz_pad] -> [R, nnz_pad]``."""
    return _merge_bh(_mm_softmax(mt, _split_bh(mt, values)))


def csr_transpose_many_mask(mt, values):
    """Per-mask CSR transpose of replicated values -> ``(mt_t, values_t)``."""
    mt_t, _ = mt.transpose()
    return mt_t, _merge_bh(_mm_transpose_values(mt, _split_bh(mt, values)))
