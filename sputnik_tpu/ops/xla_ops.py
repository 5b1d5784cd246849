"""XLA (pure ``jnp``) implementations of the core sparse ops.

These are the framework's *oracle* kernels: gather + segment-reduction
formulations that compile on every backend and serve as the independent
correctness reference for the block ops and their kernels, mirroring how
the reference validates its CUDA kernels against dense torch (SURVEY.md
§4). The many-mask ``csr`` layout runs on them too.

All functions operate on raw arrays using the padding conventions of
``topology.py``:
  * ``row_ids``  i32[nnz_pad], padding slots == m (parked in a dump segment)
  * ``col_ids``  i32[nnz_pad], padding slots == 0
  * ``valid``    bool[nnz_pad]

Semantics parity (vs. Torch-Sputnik bindings):
  * ``spmm``   : A_sp[m,k] @ B[k,n]                (``src/spmm_cuda.cu:9-60``)
  * ``sddmm``  : (L[m,d] @ R[n,d]^T) sampled       (``src/sddmm_cuda.cu:7-57``;
                 note R is stored row-major [n,d] — the transpose is fused,
                 confirmed by the dense oracle at ``tests/test_sddmm.py:9``)
  * ``softmax``: row-wise over CSR nonzeros        (``src/softmax_cuda.cu:7-46``)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["spmm", "sddmm", "sparse_softmax", "softmax_vjp"]

_NEG_LARGE = -1e30


def spmm(values, col_ids, row_ids, m: int, dense):
    """CSR sparse [m, k] times dense [k, n] -> dense [m, n]."""
    gathered = jnp.take(dense, col_ids, axis=0)          # [nnz_pad, n]
    contrib = gathered * values[:, None]
    out = jax.ops.segment_sum(contrib, row_ids, num_segments=m + 1)
    return out[:m]


def sddmm(lhs, rhs, row_ids, col_ids, valid):
    """Sampled dense-dense: out[e] = <lhs[row[e]], rhs[col[e]]>."""
    li = jnp.take(lhs, row_ids, axis=0, mode="clip")     # [nnz_pad, d]
    ri = jnp.take(rhs, col_ids, axis=0)                  # [nnz_pad, d]
    vals = jnp.sum(li * ri, axis=-1)
    return jnp.where(valid, vals, 0.0)


def sparse_softmax(values, row_ids, valid, m: int):
    """Row-wise softmax over the nonzeros of each CSR row.

    Padding contributes nothing; fully-masked (empty) rows simply have no
    output slots — the degenerate case the reference deliberately exercises
    (``tests/transformer/driver.py:11-14``).
    """
    vm = jnp.where(valid, values, _NEG_LARGE)
    row_max = jax.ops.segment_max(vm, row_ids, num_segments=m + 1)
    row_max = jnp.maximum(row_max, _NEG_LARGE)           # empty rows -> finite
    e = jnp.exp(vm - jnp.take(row_max, row_ids))
    e = jnp.where(valid, e, 0.0)
    denom = jax.ops.segment_sum(e, row_ids, num_segments=m + 1)
    denom = jnp.maximum(denom, jnp.finfo(values.dtype).tiny)
    return e / jnp.take(denom, row_ids)


def softmax_vjp(p, g, row_ids, m: int):
    """Correct CSR-softmax VJP: ``gx = p * (g - rowsum(p * g))``.

    The reference's transformer demo gets this wrong (it softmaxes the
    cotangent, ``tests/transformer/functions.py:105-115``); this is the real
    Jacobian-vector product, applied row-wise over the sparse slots. ``p``
    is zero at padding slots, so padding cotangents vanish structurally.
    """
    pg = p * g
    rs = jax.ops.segment_sum(pg, row_ids, num_segments=m + 1)
    return p * (g - jnp.take(rs, row_ids))
