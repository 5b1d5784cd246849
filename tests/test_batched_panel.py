"""Batched panel (many-mask kernel) ops vs the flat many-mask oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import sputnik_tpu as st
from sputnik_tpu import many_mask as mm
from sputnik_tpu.ops import batched_panel as bp

from _routes import route


@pytest.fixture
def problem():
    rng = np.random.RandomState(0)
    b, h, s, hd = 3, 2, 48, 32
    masks = np.stack(
        [np.tril(np.ones((s, s), np.float32), k=-i) for i in range(b)])
    masks[0, 7, :] = 0.0  # fully-masked row
    mt = mm.ManyMaskTopology.from_dense_masks(masks)
    spec = bp.BatchedPanelSpec.from_many_mask(mt, heads=h, bm=16, bk=16)
    mk = lambda seed: jnp.asarray(  # noqa: E731
        np.random.RandomState(seed).randn(b * h, s, hd).astype(np.float32))
    return dict(mt=mt, spec=spec, q=mk(1), k=mk(2), v=mk(3), hd=hd)


def _chain_bp(spec, hd, q, k, v):
    sc = bp.sddmm_bh(spec, q, k) / np.sqrt(hd)
    w = bp.sparse_softmax_bh(spec, sc)
    return bp.spmm_bh(spec, w, v)


def _chain_mm(mt, hd, q, k, v):
    sc = mm.sddmm_many_mask(mt, q, k) / np.sqrt(hd)
    w = mm.sparse_softmax_many_mask(mt, sc)
    return mm.spmm_many_mask(mt, w, v)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_chain_and_grads_match_many_mask(problem, backend):
    mt, spec = problem["mt"], problem["spec"]
    q, k, v, hd = problem["q"], problem["k"], problem["v"], problem["hd"]
    with route(backend):
        out = _chain_bp(spec, hd, q, k, v)
        g = jax.grad(
            lambda qq: jnp.sum(_chain_bp(spec, hd, qq, k, v) ** 2))(q)
    ref = _chain_mm(mt, hd, q, k, v)
    g_ref = jax.grad(
        lambda qq: jnp.sum(_chain_mm(mt, hd, qq, k, v) ** 2))(q)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), atol=1e-2)


def test_values_roundtrip(problem):
    mt, spec = problem["mt"], problem["spec"]
    rng = np.random.RandomState(4)
    vals = rng.randn(spec.R, mt.nnz_pad).astype(np.float32)
    for r in range(spec.R):
        vals[r, mt.topologies[r // spec.heads].nnz:] = 0.0
    panels = spec.stack_values(vals)
    back = np.asarray(spec.unstack_values(jnp.asarray(panels), mt.nnz_pad))
    np.testing.assert_allclose(back, vals)


def test_transformer_panel_layout_matches_csr_layout():
    from sputnik_tpu.models import SparseTransformer
    from sputnik_tpu.models.transformer import SparseCoreAttention

    rng = np.random.RandomState(5)
    b, s, h, heads = 2, 32, 32, 4
    mask = np.tril(np.ones((s, s), np.float32))
    masks = np.broadcast_to(mask, (b, s, s)).copy()
    mt = mm.ManyMaskTopology.from_dense_masks(masks)
    q = jnp.asarray(rng.randn(b, s, heads, h // heads).astype(np.float32))
    k = jnp.asarray(rng.randn(b, s, heads, h // heads).astype(np.float32))
    v = jnp.asarray(rng.randn(b, s, heads, h // heads).astype(np.float32))
    out_p = SparseCoreAttention(mask_topology=mt, num_heads=heads,
                                layout="panel").apply({}, q, k, v)
    out_c = SparseCoreAttention(mask_topology=mt, num_heads=heads,
                                layout="csr").apply({}, q, k, v)
    np.testing.assert_allclose(np.asarray(out_p), np.asarray(out_c),
                               atol=1e-4)


def test_wide_output_tile_divisor_parity():
    """Output-tile padding must stay exact for awkward widths
    (non-power-of-two, prime*128)."""
    rng = np.random.RandomState(0)
    m = n = 256
    topo = st.SparseTopology.from_dense_mask(
        (rng.rand(m, n) < 0.3).astype(np.float32))
    spec = bp.BatchedPanelSpec([topo], heads=2, bm=128, bk=128)
    vals = [rng.randn(topo.nnz_pad).astype(np.float32) for _ in range(2)]
    panels = jnp.asarray(spec.stack_values(np.stack(vals)))
    A = np.zeros((m, n), np.float32)
    A[topo.row_ids[:topo.nnz], topo.column_indices[:topo.nnz]] = \
        vals[0][:topo.nnz]
    B = np.zeros((m, n), np.float32)
    B[topo.row_ids[:topo.nnz], topo.column_indices[:topo.nnz]] = \
        vals[1][:topo.nnz]

    with route("pallas"):
        for q in (512, 640, 896, 1280, 1664):   # 5x128, 7x128, 13x128...
            dense = jnp.asarray(
                rng.randn(2, n, q).astype(np.float32))
            out = bp.spmm_bh(spec, panels, dense)
            np.testing.assert_allclose(
                np.asarray(out)[0], A @ np.asarray(dense)[0], atol=1e-3,
                err_msg=f"q={q}")
            np.testing.assert_allclose(
                np.asarray(out)[1], B @ np.asarray(dense)[1], atol=1e-3,
                err_msg=f"q={q}")
            # transposed walk at the same widths
            g = jnp.asarray(rng.randn(2, m, q).astype(np.float32))
            gt = jax.grad(lambda d: jnp.sum(
                bp.spmm_bh(spec, panels, d) * g))(dense)
            ref0 = A.T @ np.asarray(g)[0]
            np.testing.assert_allclose(np.asarray(gt)[0], ref0,
                                       atol=1e-3, err_msg=f"gT q={q}")

