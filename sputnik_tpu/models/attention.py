"""SparseAttention: multi-head attention with a sparse score matrix.

Capability parity with the reference's ``SparseAttention``
(``modules/sparse_attention.py:38-128``): Q/K/V/output projections are
``SparseLinear`` layers, the attention score matrix is *never materialised
densely* — SDDMM produces only the ``[b*heads, nnz]`` sampled scores, a CSR
softmax normalises them, and SpMM applies them to V. Heads fold into the
replication dimension (``four_d_to_three_d``, ``:100-103``).

Fixes over the reference:
  * the softmax is the differentiable ``sparse_softmax`` op — the reference
    calls the raw binding, silently breaking gradient flow (``:76-81``);
  * the mask topology is built once and cached as static structure.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import panel_api as P
from ..topology import SparseTopology
from .linear import SparseLinear
from .module import Module

__all__ = ["SparseAttention"]


@dataclasses.dataclass(frozen=True)
class SparseAttention(Module):
    """Multi-head attention over a shared sparse score topology.

    Attributes:
      num_heads: number of attention heads.
      embed_dim: model width (divisible by ``num_heads``).
      score_topology: ``SparseTopology`` of the ``[seq, seq]`` score mask,
        shared by all heads and batch elements (the reference's single
        random 90%-sparse mask, ``modules/sparse_attention.py:50-52``).
      weight_topologies: optional 4-tuple of weight topologies for the
        q/k/v/out projections; dense-equivalent full topologies by default.
    """

    num_heads: int
    embed_dim: int
    score_topology: SparseTopology
    weight_topologies: Optional[tuple] = None

    def _projections(self):
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by "
                f"num_heads {self.num_heads}"
            )
        wts = self.weight_topologies
        if wts is None:
            full = SparseTopology.from_dense_mask(
                np.ones((self.embed_dim, self.embed_dim), np.float32)
            )
            wts = (full, full, full, full)
        return [SparseLinear(topology=t) for t in wts]

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def attention(self, q3d, k3d, v3d):
        """SDDMM -> sparse softmax -> SpMM on ``[b*heads, s, head_dim]``.

        Runs entirely in the panel layout: the sampled scores never leave
        the block panel between the three ops (the reference's chain
        round-trips flat CSR values through three kernels,
        ``modules/sparse_attention.py:65-94``)."""
        spec = P.PanelSpec(self.score_topology)
        scale = 1.0 / jnp.sqrt(float(self.head_dim))

        def one(q, k, v):
            scores = P.sddmm(spec, q, k) * scale
            weights = P.sparse_softmax(spec, scores)
            return P.spmm(spec, weights, v)

        return jax.vmap(one)(q3d, k3d, v3d)

    def forward(self, scope, x):
        """x: ``[batch, seq, embed]`` -> ``[batch, seq, embed]``."""
        b, s, _ = x.shape
        t = self.score_topology
        if s != t.m or s != t.n:
            # a non-square score topology would silently attend over
            # zero-padded K/V rows
            raise ValueError(
                f"seq {s} != score topology [{t.m}, {t.n}]")

        def split_heads(y):  # [b, s, e] -> [b*h, s, hd]
            y = y.reshape(b, s, self.num_heads, self.head_dim)
            y = jnp.transpose(y, (0, 2, 1, 3))
            return y.reshape(b * self.num_heads, s, self.head_dim)

        q_proj, k_proj, v_proj, out_proj = self._projections()
        q = split_heads(q_proj(scope.child("q_proj"), x))
        k = split_heads(k_proj(scope.child("k_proj"), x))
        v = split_heads(v_proj(scope.child("v_proj"), x))

        ctx = self.attention(q, k, v)  # [b*h, s, hd]
        ctx = ctx.reshape(b, self.num_heads, s, self.head_dim)
        ctx = jnp.transpose(ctx, (0, 2, 1, 3)).reshape(b, s, self.embed_dim)
        return out_proj(scope.child("out_proj"), ctx)
