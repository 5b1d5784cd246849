"""Dynamic sparse training: magnitude pruning + RigL-style regrowth.

The reference framework (and the Sputnik kernel library it binds) exists
to serve sparse *training* research, but ships no tooling for evolving
the sparsity pattern itself — users hand-roll prune/regrow loops around
the kernels. This module supplies that loop's primitives:

  * Topology updates are HOST steps between jitted segments (exactly the
    paged-KV scheduler's philosophy, ``ops/paged.py``: allocation and
    structure changes are control flow; device code sees static shapes).
  * ``nnz`` is held CONSTANT across a ``rigl_update`` (drop k, grow k),
    and the new :class:`~sputnik_tpu.topology.SparseTopology` is built
    with the old ``nnz_pad`` — every value-shaped buffer (parameters,
    Adam moments) keeps its shape, so optimizer state survives a pattern
    update without re-initialisation. A topology swap does force a jit
    retrace (the metadata is static structure), which is why updates are
    periodic (every few hundred steps, per the RigL recipe), not
    per-step.
  * Panel-layout parameters round-trip through the dtype-preserving host
    converters (``ops/panel_api.values_to_panel_np``): the uncompressed
    panel shape depends only on ``(m, n, bm, bk)``, so panel params and
    moments also keep their shapes across updates.

References (recipes, public):
  * RigL: "Rigging the Lottery: Making All Tickets Winners"
    (Evci et al., 2020) — drop smallest-|w|, grow largest-|dense grad|.
  * Cubic schedule: "To prune, or not to prune" (Zhu & Gupta, 2017).

No counterpart exists in the reference (SURVEY.md §2 lists none);
this is a framework addition in the reference's own problem domain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..topology import SparseTopology

__all__ = [
    "topology_from_dense",
    "magnitude_prune",
    "rigl_update",
    "remap_values",
    "cubic_sparsity_schedule",
    "rigl_update_linear",
    "rigl_update_moe",
    "dense_linear_grad",
    "block_occupancy",
    "block_rigl_update",
]


def _keys(topo: SparseTopology) -> np.ndarray:
    """Flat ``row * n + col`` ids of the real slots, ascending (CSR is
    row-major with sorted columns, so this is already sorted)."""
    nnz = topo.nnz
    return (topo.row_ids[:nnz].astype(np.int64) * topo.n
            + topo.column_indices[:nnz].astype(np.int64))


def _topo_from_coo(m: int, n: int, rows: np.ndarray, cols: np.ndarray,
                   *, nnz_pad: Optional[int] = None) -> SparseTopology:
    """Canonical CSR topology from unordered COO coordinates."""
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    row_offsets = np.zeros(m + 1, dtype=np.int64)
    np.add.at(row_offsets, rows + 1, 1)
    row_offsets = np.cumsum(row_offsets)
    if row_offsets[-1] >= 2**31:
        raise ValueError(f"nnz {row_offsets[-1]} overflows int32 offsets")
    return SparseTopology(m, n, row_offsets.astype(np.int32),
                          cols.astype(np.int32), nnz_pad=nnz_pad)


def topology_from_dense(w: np.ndarray, *, density: Optional[float] = None,
                        nnz: Optional[int] = None,
                        nnz_pad: Optional[int] = None,
                        ) -> Tuple[SparseTopology, np.ndarray]:
    """Top-|w| magnitude sparsification of a dense ``[m, n]`` weight.

    Returns ``(topology, values[nnz_pad])`` — the one-shot prune that
    seeds a dynamic-sparse run from a dense init (or a dense
    checkpoint). Exactly one of ``density`` / ``nnz`` selects the budget.
    """
    w = np.asarray(w)
    m, n = w.shape
    if (density is None) == (nnz is None):
        raise ValueError("pass exactly one of density / nnz")
    keep = int(nnz) if nnz is not None else int(round(density * m * n))
    keep = max(1, min(keep, m * n))
    flat = np.abs(w).ravel()
    kept = np.argpartition(flat, m * n - keep)[m * n - keep:]
    topo = _topo_from_coo(m, n, (kept // n).astype(np.int64),
                          (kept % n).astype(np.int64), nnz_pad=nnz_pad)
    vals = np.zeros(topo.nnz_pad, dtype=w.dtype)
    nz = topo.nnz
    vals[:nz] = w[topo.row_ids[:nz], topo.column_indices[:nz]]
    return topo, vals


def remap_values(old: SparseTopology, new: SparseTopology, arr,
                 *, fill: float = 0.0) -> np.ndarray:
    """Re-key a value-shaped buffer (params, Adam ``mu``/``nu``) from one
    topology to another: positions present in both carry their entry
    over; positions new to ``new`` get ``fill`` (0 = the RigL grown-at-
    zero init and the correct fresh-moment state). Dtype-preserving."""
    if (old.m, old.n) != (new.m, new.n):
        raise ValueError(f"shape mismatch {(old.m, old.n)} vs "
                         f"{(new.m, new.n)}")
    arr = np.asarray(arr)
    ok, nk = _keys(old), _keys(new)
    if len(ok) > 1 and not np.all(np.diff(ok) > 0):
        # searchsorted needs ascending keys; CSR with per-row sorted
        # columns guarantees it, but SparseTopology never validates
        # column order — a user-built topology with unsorted columns
        # would silently mismap params/moments instead of erroring.
        raise ValueError("old topology has unsorted or duplicate columns "
                         "within a row; sort columns per row first")
    if len(nk) > 1 and not np.all(np.diff(nk) > 0):
        raise ValueError("new topology has unsorted or duplicate columns "
                         "within a row; sort columns per row first")
    out = np.full(new.nnz_pad, fill, dtype=arr.dtype)
    pos = np.searchsorted(ok, nk)
    pos_c = np.minimum(pos, max(len(ok) - 1, 0))
    hit = (len(ok) > 0) & (ok[pos_c] == nk)
    out[: new.nnz][hit] = arr[: old.nnz][pos_c[hit]]
    return out


def magnitude_prune(topo: SparseTopology, values, *,
                    density: Optional[float] = None,
                    n_drop: Optional[int] = None,
                    keep_nnz_pad: bool = False,
                    ) -> Tuple[SparseTopology, np.ndarray]:
    """Drop the smallest-|value| active connections.

    ``density`` is relative to the FULL ``m * n`` matrix (matching
    ``topology_from_dense``); ``n_drop`` is an absolute count. With
    ``keep_nnz_pad`` the pruned topology keeps the old ``nnz_pad`` so
    value-shaped buffers keep their shape (gradual-pruning loops that
    shrink ``nnz`` over a schedule want this).
    """
    if (density is None) == (n_drop is None):
        raise ValueError("pass exactly one of density / n_drop")
    values = np.asarray(values)
    nnz = topo.nnz
    if density is not None:
        target = int(round(density * topo.m * topo.n))
        drop = nnz - target
        if drop < 0:
            # growth is rigl_update's job. A mask-derived topology's
            # actual density sits a few connections off the nominal
            # schedule value (binomial nnz, round_to alignment) — that
            # boundary case warns and no-ops; a REAL overshoot (a
            # mis-ordered cubic schedule) still fails loudly.
            import warnings

            # ~one row's worth of CONNECTIONS (mean nnz per row), not the
            # row count — for tall sparse matrices m itself can exceed
            # many rows of connections and silently no-op a real
            # schedule overshoot
            margin = max(topo.nnz // max(topo.m, 1), 16)
            if -drop <= margin:
                warnings.warn(
                    f"magnitude_prune target density {density} is "
                    f"marginally above current "
                    f"{nnz / (topo.m * topo.n):.4f}; no-op",
                    stacklevel=2)
                return topo, remap_values(topo, topo, values)
            raise ValueError(
                f"requested density {density} exceeds current "
                f"{nnz / (topo.m * topo.n):.4f}; magnitude_prune only "
                "drops connections (use rigl_update to grow)")
    else:
        drop = int(n_drop)
    drop = max(0, min(drop, nnz - 1))
    order = np.argsort(np.abs(values[:nnz]), kind="stable")
    kept = order[drop:]
    new = _topo_from_coo(
        topo.m, topo.n, topo.row_ids[kept].astype(np.int64),
        topo.column_indices[kept].astype(np.int64),
        nnz_pad=topo.nnz_pad if keep_nnz_pad else None)
    return new, remap_values(topo, new, values)


def rigl_update(topo: SparseTopology, values, dense_grad, *,
                fraction: float = 0.1,
                ) -> Tuple[SparseTopology, np.ndarray]:
    """One RigL connectivity update at constant ``nnz``.

    Drops the ``k = round(fraction * nnz)`` smallest-|value| active
    connections and grows the ``k`` inactive positions with the largest
    |dense_grad| (grown values start at 0, per the recipe; re-growing a
    just-dropped position is allowed only through its gradient — active
    positions are excluded from growth *before* the drop, so a pattern
    cannot oscillate within one update). The result keeps ``nnz`` AND
    ``nnz_pad``, so every value-shaped buffer keeps its shape; carry
    optimizer moments across with :func:`remap_values` (fill=0).

    ``dense_grad``: the FULL ``[m, n]`` loss gradient of the weight
    (:func:`dense_linear_grad` computes it for a linear layer from one
    batch — RigL evaluates it only at update steps, so the dense outer
    product is paid once per update, not per step).
    """
    values = np.asarray(values)
    g = np.abs(np.asarray(dense_grad, np.float32))
    if g.shape != (topo.m, topo.n):
        raise ValueError(f"dense_grad shape {g.shape} != "
                         f"{(topo.m, topo.n)}")
    nnz = topo.nnz
    k = int(round(fraction * nnz))
    k = max(0, min(k, nnz - 1, topo.m * topo.n - nnz))
    if k == 0:
        return topo, remap_values(topo, topo, values)

    order = np.argsort(np.abs(values[:nnz]), kind="stable")
    kept = order[k:]

    g.ravel()[_keys(topo)] = -1.0           # never grow an active slot
    flat = g.ravel()
    grow = np.argpartition(flat, flat.size - k)[flat.size - k:]

    rows = np.concatenate([topo.row_ids[kept].astype(np.int64),
                           grow // topo.n])
    cols = np.concatenate([topo.column_indices[kept].astype(np.int64),
                           grow % topo.n])
    new = _topo_from_coo(topo.m, topo.n, rows, cols, nnz_pad=topo.nnz_pad)
    return new, remap_values(topo, new, values)


def block_occupancy(topo: SparseTopology, bm: int, bk: int) -> np.ndarray:
    """Per-``(bm, bk)``-tile nonzero counts, ``int64 [ceil(m/bm),
    ceil(n/bk)]`` — the quantity the block-CSR kernels' runtime actually
    scales with (``benchmarks/structured.py``)."""
    mb = -(-topo.m // bm)
    kb = -(-topo.n // bk)
    nnz = topo.nnz
    bi = topo.row_ids[:nnz].astype(np.int64) // bm
    bj = topo.column_indices[:nnz].astype(np.int64) // bk
    occ = np.zeros((mb, kb), np.int64)
    np.add.at(occ, (bi, bj), 1)
    return occ


def block_rigl_update(topo: SparseTopology, values, dense_grad, *,
                      bm: int, bk: int, fraction: float = 0.1,
                      ) -> Tuple[SparseTopology, np.ndarray]:
    """One RigL connectivity update at WHOLE-TILE granularity.

    Element-granular RigL converges to element-random patterns whose
    block occupancy is ~1.0 at kernel tile sizes — the kernels then do dense
    FLOPs through sparse bookkeeping (the r4 MoE-bank floor). This
    variant drops the ``k = round(fraction * nblocks)`` occupied
    ``(bm, bk)`` tiles with the smallest summed ``|value|`` and grows the
    ``k`` empty tiles with the largest summed ``|dense_grad|`` (grown
    tiles enter FULLY dense at value 0), so the trained pattern stays in
    the regime where sparsity buys wall-clock time.

    Requires a block-dense topology (every tile fully occupied or empty
    — e.g. seeded from ``patterns.block_random_topology``) and tile-
    aligned dims, so ``nnz`` and ``nnz_pad`` are exactly preserved and
    every value-shaped buffer (params, Adam moments via
    :func:`remap_values`) keeps its shape. Use the same ``(bm, bk)`` as
    the kernels' panel tiles so the drop/grow unit is the unit of
    compute.
    """
    if topo.m % bm or topo.n % bk:
        raise ValueError(
            f"dims ({topo.m}, {topo.n}) must be multiples of the tile "
            f"({bm}, {bk})")
    values = np.asarray(values)
    g = np.asarray(dense_grad, np.float32)
    if g.shape != (topo.m, topo.n):
        raise ValueError(f"dense_grad shape {g.shape} != "
                         f"{(topo.m, topo.n)}")
    mb, kb = topo.m // bm, topo.n // bk
    occ = block_occupancy(topo, bm, bk)
    full = bm * bk
    if not np.all((occ == 0) | (occ == full)):
        raise ValueError(
            "block_rigl_update needs a block-dense topology (every tile "
            "full or empty); seed from patterns.block_random_topology or "
            "use element-granular rigl_update")
    occupied = occ == full
    nblocks = int(occupied.sum())
    k = int(round(fraction * nblocks))
    k = max(0, min(k, nblocks - 1, mb * kb - nblocks))
    if k == 0:
        return topo, remap_values(topo, topo, values)

    nnz = topo.nnz
    bi = topo.row_ids[:nnz].astype(np.int64) // bm
    bj = topo.column_indices[:nnz].astype(np.int64) // bk
    score = np.zeros((mb, kb), np.float64)
    np.add.at(score, (bi, bj), np.abs(values[:nnz].astype(np.float64)))

    occ_flat = occupied.ravel()
    sc_flat = np.where(occ_flat, score.ravel(), np.inf)
    drop = np.argpartition(sc_flat, k - 1)[:k]

    gscore = np.abs(g).reshape(mb, bm, kb, bk).sum(axis=(1, 3)).ravel()
    gscore[occ_flat] = -1.0                  # never grow an active tile
    grow = np.argpartition(gscore, gscore.size - k)[gscore.size - k:]

    keep_flat = occ_flat.copy()
    keep_flat[drop] = False
    keep_flat[grow] = True
    bids = np.flatnonzero(keep_flat)
    # expand final tiles to element COO
    ii = (bids // kb)[:, None] * bm + np.arange(bm)[None, :]   # [B, bm]
    jj = (bids % kb)[:, None] * bk + np.arange(bk)[None, :]    # [B, bk]
    rows = np.repeat(ii[:, :, None], bk, axis=2).ravel()
    cols = np.repeat(jj[:, None, :], bm, axis=1).ravel()
    new = _topo_from_coo(topo.m, topo.n, rows, cols, nnz_pad=topo.nnz_pad)
    return new, remap_values(topo, new, values)


def cubic_sparsity_schedule(step: int, *, s_init: float, s_final: float,
                            t_start: int, t_end: int) -> float:
    """Zhu & Gupta gradual-pruning schedule: sparsity ramps from
    ``s_init`` to ``s_final`` over ``[t_start, t_end]`` along
    ``s_final + (s_init - s_final) * (1 - t)^3``."""
    if t_end <= t_start:
        raise ValueError("t_end must exceed t_start")
    t = np.clip((step - t_start) / (t_end - t_start), 0.0, 1.0)
    return float(s_final + (s_init - s_final) * (1.0 - t) ** 3)


def dense_linear_grad(x, gy) -> np.ndarray:
    """Dense ``dL/dW [out, in]`` of ``y = x @ W^T`` from one batch:
    ``gy^T @ x`` with all leading dims folded (host numpy — this runs
    once per RigL update, off the jitted step)."""
    x = np.asarray(x, np.float32)
    gy = np.asarray(gy, np.float32)
    return gy.reshape(-1, gy.shape[-1]).T @ x.reshape(-1, x.shape[-1])


def rigl_update_linear(layer, variables, dense_grad, *,
                       fraction: float = 0.1, opt_values=None):
    """RigL update of a :class:`~sputnik_tpu.models.linear.SparseLinear`.

    Handles both value layouts: panel params round-trip through the
    dtype-preserving host converters (uncompressed panel shape depends
    only on ``(m, n, bm, bk)``, so shapes are stable). Returns
    ``(new_layer, new_variables, new_opt_values)`` where ``new_layer``
    is ``layer.clone(topology=...)`` (re-jit against it) and
    ``opt_values`` is an optional list of value-shaped optimizer leaves
    (e.g. Adam ``mu``/``nu`` for the values param) remapped with grown
    slots zeroed.
    """
    from ..ops import panel_api as P

    topo = layer.topology
    p = variables["params"]
    vp = np.asarray(p["values"])

    def to_csr(a, t, spec):
        if layer.layout == "panel":
            return P.panel_to_values_np(t, a, spec.bm, spec.bk)
        return a

    def from_csr(a, t, spec):
        if layer.layout == "panel":
            return P.values_to_panel_np(t, a, spec.bm, spec.bk)
        return a

    spec = layer.spec()
    vals = to_csr(vp, topo, spec)
    new_topo, new_vals = rigl_update(topo, vals, dense_grad,
                                     fraction=fraction)
    new_layer = layer.clone(topology=new_topo)
    new_spec = new_layer.spec()
    if (new_spec.bm, new_spec.bk) != (spec.bm, spec.bk):  # same (m, n)
        raise AssertionError("panel tiles changed across update")
    new_p = dict(p, values=from_csr(new_vals, new_topo, new_spec))
    new_vars = dict(variables, params=new_p)

    new_opt = None
    if opt_values is not None:
        new_opt = [
            from_csr(
                remap_values(topo, new_topo, to_csr(np.asarray(m_), topo,
                                                    spec)),
                new_topo, new_spec)
            for m_ in opt_values
        ]
    return new_layer, new_vars, new_opt


def rigl_update_moe(moe, variables, dense_grads_in, dense_grads_out, *,
                    fraction: float = 0.1, opt_values=None, block=None):
    """One RigL connectivity update of a ``SparseMoE``'s SHARED expert
    topologies at constant ``nnz``.

    The expert bank shares ONE topology per projection with per-expert
    values (the reference's replicated-values semantics), so the
    drop/grow criteria AGGREGATE over experts: drop the connections with
    the smallest mean |value| across experts, grow the inactive
    positions with the largest mean |dense grad| (``dense_grads_*``:
    per-expert stacks ``[E, m, n]`` or pre-aggregated ``[m, n]``).

    Values are panel-layout (``models/moe.py``); they round-trip through
    the dtype-preserving host converters per expert, and — as with
    :func:`rigl_update_linear` — ``nnz`` and ``nnz_pad`` are held
    constant so every value-shaped buffer (params, Adam moments via
    ``opt_values``) keeps its shape. Returns ``(new_moe, new_variables,
    new_opt_values)``; re-jit against ``new_moe`` (a topology swap is a
    retrace, so update periodically, not per step).
    """
    import dataclasses as _dc

    import jax

    from ..models.moe import SparseMoE, _bank_spec  # noqa: F401

    def agg(g, topo):
        g = np.asarray(g, np.float32)
        if g.ndim == 3:
            g = np.abs(g).mean(axis=0)
        if g.shape != (topo.m, topo.n):
            raise ValueError(f"dense grad shape {g.shape} != "
                             f"{(topo.m, topo.n)}")
        return g

    p = variables["params"]
    E = moe.num_experts
    out_params = dict(p)
    new_topos = {}
    new_opt = list(opt_values) if opt_values is not None else None

    for which, gd in (("in", dense_grads_in), ("out", dense_grads_out)):
        topo = moe.topo_in if which == "in" else moe.topo_out
        spec = _bank_spec(topo, E, *(getattr(moe, "bank_tiles", None)
                                     or (0, 0)))
        name = f"w_{which}_values"
        flat = moe.flat_values(p[name], which)          # [E, nnz_pad]
        mean_mag = np.abs(flat[:, : topo.nnz]).mean(axis=0)
        # drop smallest mean |value|; grow largest aggregated |grad|
        pseudo_vals = np.zeros(topo.nnz_pad, np.float32)
        pseudo_vals[: topo.nnz] = mean_mag
        if block is not None:
            # whole-tile drop/grow — keeps the bank in the block-dense
            # regime where the kernels' time scales with density
            new_topo, _ = block_rigl_update(
                topo, pseudo_vals, agg(gd, topo), bm=block[0],
                bk=block[1], fraction=fraction)
        else:
            new_topo, _ = rigl_update(topo, pseudo_vals, agg(gd, topo),
                                      fraction=fraction)
        new_topos[which] = new_topo
        new_spec_bm, new_spec_bk = spec.bm, spec.bk
        remapped = np.stack([
            remap_values(topo, new_topo, flat[e]) for e in range(E)])
        from ..ops import panel_api as PA

        out_params[name] = np.stack([
            PA.values_to_panel_np(new_topo, v, new_spec_bm, new_spec_bk)
            for v in remapped])
        if new_opt is not None:
            for j, m_ in enumerate(new_opt):
                leaf = m_.get(name) if isinstance(m_, dict) else None
                if leaf is None:
                    continue
                flat_m = moe.flat_values(leaf, which)
                rm = np.stack([
                    remap_values(topo, new_topo, flat_m[e])
                    for e in range(E)])
                m2 = dict(m_)
                m2[name] = np.stack([
                    PA.values_to_panel_np(new_topo, v, new_spec_bm,
                                          new_spec_bk) for v in rm])
                new_opt[j] = m2

    new_moe = _dc.replace(moe, topo_in=new_topos["in"],
                          topo_out=new_topos["out"])
    new_vars = dict(variables, params=out_params)
    return new_moe, new_vars, new_opt
