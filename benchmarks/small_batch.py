"""Small-matrix regime (r4 verdict weak #6): 64^3-class problems run at
~0.13 SoL individually — latency floor + tile padding dominate a single
tiny op. The answer is BATCHING: B independent small topologies are
exactly the batched-panel replica axis (per-replica metadata, one kernel
launch), amortising the fixed cost over the whole family.

Rows (on a GPU; fails without one):
  * one 64^3 spmm through the flat api (the r4 floor, for reference)
  * B=64 DISTINCT 64^3 topologies as ONE batched-panel call
  * the same B=64 family as 64 sequential flat calls inside one jit
  * dense f32 anchor at the batched shape (SoL denominator)

Run:  python benchmarks/small_batch.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    import sputnik_tpu as st
    from sputnik_tpu.ops import batched_panel as bp
    from sputnik_tpu.ops import panel_api as PA
    from sputnik_tpu.utils import enable_compile_cache
    from sputnik_tpu.utils.device import require_gpu
    from sputnik_tpu.utils.profiling import measure

    require_gpu()
    enable_compile_cache()
    out = {}
    rng = np.random.RandomState(0)
    n, d, B = 64, 0.1, 64

    topos = [st.SparseTopology.from_dense_mask(
        (rng.rand(n, n) < d).astype(np.float32)) for _ in range(B)]
    denses = jnp.asarray(rng.randn(B, n, n).astype(np.float32))

    # single 64^3 through the flat api (the r4 per-op floor)
    mat = st.SparseMatrix((rng.rand(n, n) < d).astype(np.float32)
                          * rng.randn(n, n).astype(np.float32))
    f1 = jax.jit(lambda v, dd: st.spmm(mat.topology, v, dd))
    out["single_flat_ms"] = measure(f1, jnp.asarray(mat.values), denses[0])

    # B distinct topologies = the batched-panel replica axis, ONE launch
    bm, bk = 64, 128                       # n=64 pads into one 128 tile
    spec = bp.BatchedPanelSpec(topos, heads=1, bm=bm, bk=bk)
    panels = jnp.asarray(np.stack([
        PA.values_to_panel_np(
            t, rng.randn(t.nnz_pad).astype(np.float32), bm, bk)
        for t in topos]))
    dense_p = jnp.zeros((B, spec.n_pad, 128), jnp.float32)
    dense_p = dense_p.at[:, :n, :n].set(denses)
    fb = jax.jit(lambda p, dd: bp.spmm_bh(spec, p, dd))
    out["batched_64x_ms"] = measure(fb, panels, dense_p)
    out["batched_per_matrix_ms"] = round(out["batched_64x_ms"] / B, 6)

    # the same family as B sequential flat calls inside one jit
    vals = [jnp.asarray(rng.randn(t.nnz_pad).astype(np.float32))
            for t in topos]

    @jax.jit
    def loop(vs, dd):
        return [st.spmm(t, v, dd[i])
                for i, (t, v) in enumerate(zip(topos, vs))]

    out["loop_64x_ms"] = measure(loop, vals, denses)

    # pack the batch into ONE block-diagonal topology at the panel's
    # default tile: a 128 x 128 tile covers 2 of the 64^3 matrices
    from sputnik_tpu.ops import panel_api as PAN

    Abd = np.zeros((B * n, B * n), np.float32)
    vcat = []
    for i, t in enumerate(topos):
        blk = np.zeros((n, n), np.float32)
        blk[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = \
            np.asarray(rng.randn(t.nnz)).astype(np.float32)
        Abd[i * n: (i + 1) * n, i * n: (i + 1) * n] = blk
    mat_bd = st.SparseMatrix(Abd)
    spec_bd = PAN.PanelSpec(mat_bd.topology)
    panel_bd = jnp.asarray(PAN.values_to_panel_np(
        mat_bd.topology, mat_bd.values, spec_bd.bm, spec_bd.bk))
    dense_bd = jnp.asarray(np.asarray(denses).reshape(B * n, n))
    fbd = jax.jit(lambda p, dd: PAN.spmm(spec_bd, p, dd))
    out["blockdiag_ms"] = measure(fbd, panel_bd, dense_bd)
    out["blockdiag_per_matrix_ms"] = round(
        out["blockdiag_ms"] / B, 6)

    # dense f32 anchor at the batched shape (SoL denominator)
    a = jnp.asarray(rng.randn(B, n, n).astype(np.float32))
    fd = jax.jit(lambda a, b: jnp.einsum("bij,bjk->bik", a, b))
    out["dense_batch_ms"] = measure(fd, a, denses)
    out["batched_vs_loop"] = round(
        out["loop_64x_ms"] / max(out["batched_64x_ms"], 1e-9), 2)
    out["batched_vs_dense"] = round(
        out["dense_batch_ms"] / max(out["batched_64x_ms"], 1e-9), 3)

    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
