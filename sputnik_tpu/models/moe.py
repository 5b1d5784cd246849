"""Sparse Mixture-of-Experts: per-expert CSR-sparse FFNs + expert parallelism.

New capability beyond the reference (which has no conditional compute):
a top-1-routed MoE layer whose expert FFN weights are CSR-sparse with a
SHARED topology and per-expert values — exactly the replicated-values
semantics of the reference's batched SpMM (``src/spmm_cuda.cu:29-30``:
``values [r, nnz] x dense [r, k, n]``), so the whole expert bank computes
as ONE batched sparse op per projection.

Design choices:
  * dense one-hot dispatch/combine (einsum onto a ``[tokens, E, capacity]``
    tensor) — matmul-shaped, static shapes, no gathers — the
    Mesh-TensorFlow/GShard MoE formulation;
  * expert parallelism via ``shard_map`` over an ``ep`` mesh axis: each
    device holds ``E/ndev`` experts' values and computes their batched
    sparse FFN locally; the only collective is one ``psum`` of the
    combined ``[tokens, hidden]`` output;
  * the router's load-balance auxiliary loss is sown under
    ``intermediates/aux_loss`` (GShard aux: ``E * sum(f_e * p_e)``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import batched_panel as bp
from ..ops import panel_api as PA
from ..topology import SparseTopology
from .module import Dense, Module

__all__ = ["SparseMoE"]


def _bank_tiles(topo: SparseTopology):
    """Expert-bank block tiles: the panel default (``default_block``)."""
    return PA.default_block(topo)


def _bank_spec(topo: SparseTopology, n_rep: int, bm: int = 0,
               bk: int = 0) -> "bp.BatchedPanelSpec":
    """``(n_rep, bm, bk)``-keyed expert-bank spec, cached on the
    topology's block view (the topology itself is __slots__-only): ONE
    shared-topology metadata set, ``n_rep`` value replicas — experts are
    exactly the batched-panel replica axis."""
    if not bm or not bk:
        bm, bk = _bank_tiles(topo)
    bv = topo.block(bm, bk)
    cached = getattr(bv, "_moe_specs", None)
    if cached is None:
        cached = {}
        object.__setattr__(bv, "_moe_specs", cached)
    key = (n_rep, bm, bk)
    if key not in cached:
        cached[key] = bp.BatchedPanelSpec([topo], heads=n_rep,
                                          bm=bm, bk=bk)
    return cached[key]


@dataclasses.dataclass(frozen=True)
class SparseMoE(Module):
    """Top-1 / top-2 MoE with CSR-sparse expert FFNs.

    Attributes:
      topo_in: ``SparseTopology [ffn, hidden]`` of every expert's first
        projection (shared pattern; per-expert values).
      topo_out: ``SparseTopology [hidden, ffn]`` of the second projection.
      num_experts: expert count ``E`` (divisible by the ``ep`` axis size
        when expert-parallel).
      top_k: experts per token — 1 (Switch-style) or 2 (the GShard/Mixtral
        standard). With ``top_k=2`` the two gates are renormalised to sum
        to 1 and second choices queue BEHIND every first choice in the
        capacity buffer (GShard's location offset), so congestion sheds
        second opinions before first ones.
      capacity_factor: per-expert token capacity multiplier
        (``C = ceil(tokens / E * top_k * capacity_factor)``; overflow
        tokens pass through with that expert contribution zeroed, the
        standard behaviour).
      activation: nonlinearity between the projections.
      mesh / axis: optional expert-parallel mesh axis; values are sharded
        ``P('ep')`` and the expert compute runs under ``shard_map``.
    """

    topo_in: SparseTopology
    topo_out: SparseTopology
    num_experts: int
    top_k: int = 1
    capacity_factor: float = 1.25
    activation: Optional[str] = "gelu"
    mesh: Optional[Mesh] = None
    axis: str = "ep"
    # (bm, bk) kernel tiles for the expert bank; None -> _bank_tiles.
    # Set it to the block granularity of a
    # block-structured expert topology so empty tiles are SKIPPED (the
    # whole point of block sparsity: time scales with occupancy).
    bank_tiles: Optional[tuple] = None

    def _act(self, y):
        if self.activation == "gelu":
            return jax.nn.gelu(y)
        if self.activation == "relu":
            return jax.nn.relu(y)
        if self.activation is None:
            return y
        raise ValueError(f"unknown activation {self.activation}")

    def forward(self, scope, x):
        """``x [..., hidden] -> [..., hidden]``."""
        h = self.topo_in.n
        f = self.topo_in.m
        if self.topo_out.m != h or self.topo_out.n != f:
            raise ValueError(
                f"topo_out must be [{h}, {f}], got "
                f"[{self.topo_out.m}, {self.topo_out.n}]")
        if x.shape[-1] != h:
            raise ValueError(f"input features {x.shape[-1]} != {h}")
        E = self.num_experts
        if self.top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {self.top_k}")
        lead = x.shape[:-1]
        xf = x.reshape(-1, h)
        T = xf.shape[0]
        C = max(int(np.ceil(T / E * self.top_k * self.capacity_factor)), 1)

        # --- router (dense; tiny) ---------------------------------------
        logits = Dense(E, use_bias=False)(scope.child("router"), xf)
        probs = jax.nn.softmax(logits, axis=-1)
        # routing math stays int32/f32: a bf16 cumsum is only exact to
        # 256, so with capacity > 256 two tokens would silently share a
        # capacity slot (their inputs SUM in the dispatch einsum)
        expert1 = jnp.argmax(probs, axis=-1)                       # [T]
        gate1 = jnp.max(probs, axis=-1)                            # [T]
        oh1 = jax.nn.one_hot(expert1, E, dtype=jnp.int32)          # [T, E]

        # GShard load-balance aux loss (first-choice assignment fractions):
        # E * sum_e(frac_tokens * mean_prob)
        frac = jnp.mean(oh1.astype(probs.dtype), axis=0)
        mean_p = jnp.mean(probs, axis=0)
        scope.sow("aux_loss", E * jnp.sum(frac * mean_p))

        # position of each token within its expert; one_hot itself zeroes
        # unrouted (-1) and over-capacity (>= C) slots
        pos1 = jnp.cumsum(oh1, axis=0) * oh1 - 1                   # [T, E]
        if self.top_k == 1:
            dispatch = jax.nn.one_hot(pos1, C, dtype=xf.dtype)     # [T, E, C]
            combine = dispatch * gate1[:, None, None]
        else:
            # second choice: mask the winner, renormalise the two gates
            probs2 = probs * (1 - oh1.astype(probs.dtype))
            expert2 = jnp.argmax(probs2, axis=-1)
            gate2 = jnp.max(probs2, axis=-1)
            oh2 = jax.nn.one_hot(expert2, E, dtype=jnp.int32)
            denom = jnp.maximum(gate1 + gate2, 1e-9)
            g1n, g2n = gate1 / denom, gate2 / denom
            # GShard location offset: second choices queue behind ALL of
            # an expert's first choices, so overflow sheds them first
            cnt1 = jnp.sum(oh1, axis=0)                            # [E]
            pos2 = (jnp.cumsum(oh2, axis=0) + cnt1[None, :]) * oh2 - 1
            disp1 = jax.nn.one_hot(pos1, C, dtype=xf.dtype)
            disp2 = jax.nn.one_hot(pos2, C, dtype=xf.dtype)
            dispatch = disp1 + disp2                               # [T, E, C]
            combine = (disp1 * g1n[:, None, None]
                       + disp2 * g2n[:, None, None])

        # --- per-expert sparse values (shared topology, PANEL layout) ----
        # Values live in the block panel, the canonical device layout (no
        # per-forward values->panel scatter). The expert bank is one
        # batched-panel op per projection: experts = the replica axis of
        # ``ops/batched_panel`` sharing one topology's metadata. The tiles
        # are resolved ONCE, with the param-owning expert count E, so the
        # ep-local path reuses the tiles the params were created with.
        def _tiles(topo):
            return self.bank_tiles or _bank_tiles(topo)

        bt_in, bt_out = _tiles(self.topo_in), _tiles(self.topo_out)
        spec_in = _bank_spec(self.topo_in, E, *bt_in)
        spec_out = _bank_spec(self.topo_out, E, *bt_out)
        init_in = PA.panel_kaiming_values(self.topo_in, spec_in.bm,
                                          spec_in.bk)
        init_out = PA.panel_kaiming_values(self.topo_out, spec_out.bm,
                                           spec_out.bk)
        v_in = scope.param("w_in_values",
                          lambda k, s, d=jnp.float32: jax.vmap(
                              lambda kk: init_in(kk, s[1:], d))(
                                  jax.random.split(k, E)),
                          (E,) + spec_in.panel_shape)
        v_out = scope.param("w_out_values",
                           lambda k, s, d=jnp.float32: jax.vmap(
                               lambda kk: init_out(kk, s[1:], d))(
                                   jax.random.split(k, E)),
                           (E,) + spec_out.panel_shape)

        def expert_bank(disp, comb, p1, p2, xflat, n_exp):
            """[T,E',C] dispatch over E' (possibly local) experts —
            the tiles stay the E-resolved ones above."""
            s1 = _bank_spec(self.topo_in, n_exp, *bt_in)
            s2 = _bank_spec(self.topo_out, n_exp, *bt_out)
            xin = jnp.einsum("tec,th->ehc", disp, xflat)
            y1 = bp.spmm_bh(s1, p1, xin)                   # [E', f, C]
            y2 = bp.spmm_bh(s2, p2, self._act(y1))         # [E', h, C]
            return jnp.einsum("tec,ehc->th", comb,
                              y2.astype(xflat.dtype))      # [T, h]

        if self.mesh is None:
            out = expert_bank(dispatch, combine, v_in, v_out, xf, E)
        else:
            ax = self.axis
            n_loc = E // self.mesh.shape[ax]

            def local(disp, comb, v1, v2, xflat):
                part = expert_bank(disp, comb, v1, v2, xflat, n_loc)
                return jax.lax.psum(part, ax)

            out = jax.shard_map(
                local, mesh=self.mesh,
                in_specs=(P(None, ax, None), P(None, ax, None),
                          P(ax), P(ax), P()),
                out_specs=P(),
                check_vma=False,
            )(dispatch, combine, v_in, v_out, xf)

        return out.reshape(*lead, h)

    # -- value-layout boundary helpers -------------------------------------

    def flat_values(self, panels, which: str = "in") -> np.ndarray:
        """Panel-layout expert values ``[E, *panel]`` -> flat CSR
        ``[E, nnz_pad]`` (host boundary; dtype-preserving)."""
        topo = self.topo_in if which == "in" else self.topo_out
        spec = _bank_spec(topo, self.num_experts,
                          *(self.bank_tiles or (0, 0)))
        return np.stack([
            PA.panel_to_values_np(topo, np.asarray(p), spec.bm, spec.bk)
            for p in np.asarray(panels)])

    def panel_values(self, flat, which: str = "in") -> np.ndarray:
        """Inverse of :meth:`flat_values`."""
        topo = self.topo_in if which == "in" else self.topo_out
        spec = _bank_spec(topo, self.num_experts,
                          *(self.bank_tiles or (0, 0)))
        return np.stack([
            PA.values_to_panel_np(topo, np.asarray(v), spec.bm, spec.bk)
            for v in np.asarray(flat)])
