"""Pallas-Triton kernel parity vs the XLA oracle (interpret mode on CPU).

Mirrors the reference's dense-oracle validation style (SURVEY.md §4) one
level down: the oracle is ``ops/xla_ops`` (independent element-level
gathers), so any kernel bug shows as a kernel/oracle split. Every kernel
runs through the Pallas interpreter (``interpret_kernels``) AND through
its plain block-gather twin, at small shapes with empty rows, partial
blocks, padding, GQA and f32/bf16 operands. Gradients are covered through
the public custom_vjp ops, which route the *backward* compositions
through the kernels too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import sputnik_tpu as st
from sputnik_tpu.ops import xla_ops
from sputnik_tpu.ops.pallas.bsr_sddmm import bsr_sddmm
from sputnik_tpu.ops.pallas.bsr_spmm import bsr_spmm

from _routes import route


def _random_topo(rng, m, k, density, empty_row=True):
    mask = (rng.rand(m, k) < density).astype(np.float32)
    if empty_row:
        mask[min(3, m - 1), :] = 0.0
    A = mask * rng.randn(m, k)
    mat = st.SparseMatrix(A.astype(np.float32))
    return mat.topology, jnp.asarray(mat.values)


ROUTES = ["xla", "pallas"]


@pytest.mark.parametrize("backend", ROUTES)
@pytest.mark.parametrize(
    "m,k,n,density",
    [(72, 64, 72, 0.5), (200, 130, 50, 0.1), (8, 300, 17, 0.3)],
)
def test_bsr_spmm_parity(m, k, n, density, backend):
    rng = np.random.RandomState(0)
    topo, vals = _random_topo(rng, m, k, density)
    dense = jnp.asarray(rng.randn(k, n).astype(np.float32))
    ref = xla_ops.spmm(vals, topo.column_indices, topo.row_ids, topo.m, dense)
    with route(backend):
        out = bsr_spmm(topo, vals, dense, bm=16, bk=32, bn=16)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("backend", ROUTES)
@pytest.mark.parametrize("epilogue", ["bias", "bias_relu"])
def test_bsr_spmm_bias_relu(epilogue, backend):
    rng = np.random.RandomState(1)
    topo, vals = _random_topo(rng, 72, 64, 0.5)
    dense = jnp.asarray(rng.randn(64, 40).astype(np.float32))
    bias = jnp.asarray(rng.randn(72).astype(np.float32))
    ref = xla_ops.spmm(vals, topo.column_indices, topo.row_ids, topo.m, dense)
    ref = ref + bias[:, None]
    if epilogue == "bias_relu":
        ref = jnp.maximum(ref, 0.0)
    with route(backend):
        out = bsr_spmm(topo, vals, dense, bias, bm=16, bk=16, bn=16,
                       epilogue=epilogue)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("backend", ROUTES)
@pytest.mark.parametrize("m,n,d,sp", [(72, 72, 64, 0.5), (130, 50, 96, 0.2)])
def test_bsr_sddmm_parity(m, n, d, sp, backend):
    rng = np.random.RandomState(2)
    topo, _ = _random_topo(rng, m, n, sp)
    lhs = jnp.asarray(rng.randn(m, d).astype(np.float32))
    rhs = jnp.asarray(rng.randn(n, d).astype(np.float32))
    ref = xla_ops.sddmm(lhs, rhs, topo.row_ids, topo.column_indices,
                        topo.valid)
    with route(backend):
        out = bsr_sddmm(topo, lhs, rhs, bm=16, bk=16)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("backend", ROUTES)
def test_flat_softmax_parity_incl_empty_row(backend):
    rng = np.random.RandomState(3)
    topo, _ = _random_topo(rng, 72, 72, 0.5, empty_row=True)
    vals = jnp.asarray(rng.randn(topo.nnz_pad).astype(np.float32))
    ref = xla_ops.sparse_softmax(vals, topo.row_ids, topo.valid, topo.m)
    with route(backend):
        out = st.sparse_softmax(topo, vals)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert np.all(np.isfinite(np.asarray(out)))


def _dense_of(topo, vals):
    A = np.zeros((topo.m, topo.n), np.float32)
    A[topo.row_ids[: topo.nnz], topo.column_indices[: topo.nnz]] = \
        np.asarray(vals)[: topo.nnz]
    return A


def test_forced_pallas_backend_end_to_end_grads():
    """Public API through the interpreted kernels: fwd + grads match the
    plain route."""
    rng = np.random.RandomState(4)
    m, k, n = 40, 36, 28
    topo, vals = _random_topo(rng, m, k, 0.4)
    dense = jnp.asarray(rng.randn(k, n).astype(np.float32))
    lhs = jnp.asarray(rng.randn(m, 16).astype(np.float32))
    rhs = jnp.asarray(rng.randn(k, 16).astype(np.float32))

    def run():
        out = {}
        out["spmm"] = st.spmm(topo, vals, dense)
        out["sddmm"] = st.sddmm(topo, lhs, rhs)
        out["softmax"] = st.sparse_softmax(topo, vals)
        out["g_spmm"] = jax.grad(
            lambda v: jnp.sum(st.spmm(topo, v, dense) ** 2))(vals)
        out["g_sddmm"] = jax.grad(
            lambda l: jnp.sum(st.sddmm(topo, l, rhs) ** 2))(lhs)
        out["g_softmax"] = jax.grad(
            lambda v: jnp.sum(st.sparse_softmax(topo, v) ** 2))(vals)
        return out

    with route("xla"):
        ref = run()
    with route("pallas"):
        got = run()
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=1e-3,
                                   err_msg=name)


def test_forced_pallas_replicated_left_spmm():
    rng = np.random.RandomState(5)
    topo, vals = _random_topo(rng, 24, 20, 0.5)
    dense3 = jnp.asarray(rng.randn(3, 20, 12).astype(np.float32))
    ref = np.einsum("mk,rkn->rmn", np.asarray(_dense_of(topo, vals)),
                    np.asarray(dense3))
    with route("pallas"):
        got = st.left_spmm(topo, vals, dense3)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_flat_dispatch_panel_cache():
    """Eager flat calls reuse the values->panel conversion per values
    buffer; a DIFFERENT values array must not hit the stale entry, and a
    jitted call (traced values) must bypass the cache entirely."""
    from sputnik_tpu.ops import xla_ops
    from sputnik_tpu.ops.pallas import dispatch

    rng = np.random.RandomState(7)
    topo, vals = _random_topo(rng, 72, 64, 0.5)
    dense = jnp.asarray(rng.randn(64, 40).astype(np.float32))
    ref = xla_ops.spmm(vals, topo.column_indices, topo.row_ids,
                       topo.m, dense)

    with route("pallas"):
        dispatch._panel_cache.clear()
        out1 = st.spmm(topo, vals, dense)
        assert len(dispatch._panel_cache) == 1
        out2 = st.spmm(topo, vals, dense)          # cache hit
        assert len(dispatch._panel_cache) == 1
        vals2 = vals * 2.0
        out3 = st.spmm(topo, vals2, dense)         # distinct buffer: miss
        assert len(dispatch._panel_cache) == 2
        outj = jax.jit(lambda v, d: st.spmm(topo, v, d))(vals, dense)
    dispatch._panel_cache.clear()

    np.testing.assert_allclose(out1, ref, atol=1e-4)
    np.testing.assert_allclose(out2, ref, atol=1e-4)
    np.testing.assert_allclose(out3, 2.0 * np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(outj, ref, atol=1e-4)
