"""Op parity vs. dense oracles + gradient checks.

Reproduces the reference's test matrix (SURVEY.md §4) as proper pytest
parity tests: SpMM vs ``matmul`` (test_spmm.py), replicated 3-D SpMM
(test_spmm_3d.py), left_spmm (test_left_spmm.py), SDDMM vs masked matmul
(test_sddmm.py / _3d), sparse softmax vs dense softmax with -1e9 masking
(test_softmax.py), CSR transpose incl. empty rows (test_transpose.py), the
fused bias+ReLU epilogue (test_spmm_bias_relu.py), plus the gradcheck the
reference aspired to but never ran (test_spmm_grad.py imports gradcheck and
doesn't call it) — done here with ``jax.test_util.check_grads``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

import sputnik_tpu as st
from sputnik_tpu.patterns import init_uniform, sparsify_uniform

from _routes import route

# Reference tolerances: 1e-2 element threshold for matmul-class ops
# (tests/test_spmm.py:37), 1e-4 for SDDMM (tests/test_sddmm.py:34). We use
# rtol-style allclose at comparable strictness.
MM_TOL = dict(rtol=1e-4, atol=1e-4)


def make_sparse(m, k, sparsity, seed=0, round_to=4):
    dense = sparsify_uniform(
        init_uniform((m, k), seed=seed), sparsity, round_to=round_to, seed=seed + 1
    ).astype(np.float32)
    sm = st.SparseMatrix(dense)
    return dense, sm


class TestSpmm:
    @pytest.mark.parametrize(
        "m,k,n,sparsity",
        [(72, 64, 72, 0.9), (72, 64, 72, 0.0), (64, 64, 64, 0.5), (33, 47, 29, 0.8)],
    )
    def test_2d_parity(self, m, k, n, sparsity):
        dense_a, sm = make_sparse(m, k, sparsity)
        b = init_uniform((k, n), seed=7)
        out = st.spmm(sm.topology, jnp.asarray(sm.values), jnp.asarray(b))
        np.testing.assert_allclose(out, dense_a @ b, **MM_TOL)

    def test_3d_replicated(self):
        # reference test_spmm_3d: shared mask, per-replica values
        r, m, k, n = 8, 72, 64, 72
        dense_a, sm = make_sparse(m, k, 0.9)
        t = sm.topology
        vals = init_uniform((r, t.nnz_pad), seed=3) * (np.arange(t.nnz_pad) < t.nnz)
        b = init_uniform((r, k, n), seed=4)
        out = st.spmm(t, jnp.asarray(vals), jnp.asarray(b))
        assert out.shape == (r, m, n)
        for i in range(r):
            ai = np.zeros((m, k), np.float32)
            ai[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = vals[i, : t.nnz]
            np.testing.assert_allclose(out[i], ai @ b[i], **MM_TOL)

    def test_left_spmm(self):
        # one shared sparse matrix x batched dense
        r, m, k, n = 4, 48, 32, 24
        dense_a, sm = make_sparse(m, k, 0.7)
        b = init_uniform((r, k, n), seed=5)
        out = st.left_spmm(sm.topology, jnp.asarray(sm.values), jnp.asarray(b))
        assert out.shape == (r, m, n)
        for i in range(r):
            np.testing.assert_allclose(out[i], dense_a @ b[i], **MM_TOL)

    def test_empty_row_gives_zeros(self):
        dense = init_uniform((8, 8), seed=1)
        dense[3, :] = 0
        sm = st.SparseMatrix(dense)
        b = init_uniform((8, 4), seed=2)
        out = st.spmm(sm.topology, jnp.asarray(sm.values), jnp.asarray(b))
        np.testing.assert_allclose(out[3], np.zeros(4), atol=0)

    def test_jit(self):
        dense_a, sm = make_sparse(32, 32, 0.5)
        b = init_uniform((32, 16), seed=9)
        f = jax.jit(lambda v, d: st.spmm(sm.topology, v, d))
        np.testing.assert_allclose(f(sm.values, b), dense_a @ b, **MM_TOL)


class TestSddmm:
    @pytest.mark.parametrize("m,n,d,sparsity", [(72, 72, 64, 0.9), (72, 72, 64, 0.0)])
    def test_2d_parity(self, m, n, d, sparsity):
        mask, sm = make_sparse(m, n, sparsity, seed=10)
        lhs = init_uniform((m, d), seed=11)
        rhs = init_uniform((n, d), seed=12)  # stored [n, d]; op does rhs^T
        t = sm.topology
        vals = st.sddmm(t, jnp.asarray(lhs), jnp.asarray(rhs))
        ref = (lhs @ rhs.T) * (mask != 0)
        got = np.zeros((m, n), np.float32)
        got[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = np.asarray(vals)[: t.nnz]
        np.testing.assert_allclose(got, ref, **MM_TOL)
        # padding slots must be exactly zero
        np.testing.assert_array_equal(np.asarray(vals)[t.nnz:], 0.0)

    def test_3d_parity(self):
        r, m, n, d = 6, 48, 48, 32
        mask, sm = make_sparse(m, n, 0.8, seed=13)
        lhs = init_uniform((r, m, d), seed=14)
        rhs = init_uniform((r, n, d), seed=15)
        t = sm.topology
        vals = st.sddmm(t, jnp.asarray(lhs), jnp.asarray(rhs))
        assert vals.shape == (r, t.nnz_pad)
        for i in range(r):
            ref = (lhs[i] @ rhs[i].T) * (mask != 0)
            got = np.zeros((m, n), np.float32)
            got[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = np.asarray(vals)[i, : t.nnz]
            np.testing.assert_allclose(got, ref, **MM_TOL)


class TestSoftmax:
    def _dense_ref(self, mask, scores_dense):
        # reference oracle: zeros pre-set to -1e9 then dense softmax
        logits = np.where(mask != 0, scores_dense, -1e9)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True) * (mask != 0)

    def test_parity(self):
        m, n = 72, 72
        mask, sm = make_sparse(m, n, 0.9, seed=20)
        t = sm.topology
        scores = init_uniform((m, n), seed=21) * (mask != 0)
        vals = np.zeros(t.nnz_pad, np.float32)
        vals[: t.nnz] = scores[t.row_ids[: t.nnz], t.column_indices[: t.nnz]]
        out = st.sparse_softmax(t, jnp.asarray(vals))
        got = np.zeros((m, n), np.float32)
        got[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = np.asarray(out)[: t.nnz]
        np.testing.assert_allclose(got, self._dense_ref(mask, scores), rtol=1e-5, atol=1e-6)

    def test_rows_sum_to_one(self):
        mask, sm = make_sparse(64, 64, 0.85, seed=22)
        t = sm.topology
        vals = init_uniform((t.nnz_pad,), seed=23) * t.valid
        out = np.asarray(st.sparse_softmax(t, jnp.asarray(vals)))
        sums = np.zeros(t.m + 1)
        np.add.at(sums, t.row_ids, out)
        nonempty = t.row_lengths > 0
        np.testing.assert_allclose(sums[: t.m][nonempty], 1.0, rtol=1e-5)

    def test_empty_row_no_nan(self):
        dense = init_uniform((8, 8), seed=1)
        dense[2, :] = 0  # fully-masked row (driver.py:11-14 case)
        sm = st.SparseMatrix(dense)
        out = st.sparse_softmax(sm.topology, jnp.asarray(sm.values))
        assert not np.any(np.isnan(np.asarray(out)))

    def test_replicated(self):
        r = 5
        mask, sm = make_sparse(32, 32, 0.8, seed=25)
        t = sm.topology
        vals = init_uniform((r, t.nnz_pad), seed=26) * t.valid
        out = st.sparse_softmax(t, jnp.asarray(vals))
        assert out.shape == (r, t.nnz_pad)
        for i in range(r):
            scores = np.zeros((32, 32), np.float32)
            scores[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = vals[i, : t.nnz]
            got = np.zeros((32, 32), np.float32)
            got[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = np.asarray(out)[i, : t.nnz]
            np.testing.assert_allclose(got, self._dense_ref(mask, scores), rtol=1e-5, atol=1e-6)


class TestTransposeOp:
    def test_transpose_then_spmm_is_atb(self):
        m, k, n = 48, 40, 24
        dense_a, sm = make_sparse(m, k, 0.8, seed=30)
        b = init_uniform((m, n), seed=31)
        topo_t, values_t = st.csr_transpose(sm.topology, jnp.asarray(sm.values))
        out = st.spmm(topo_t, values_t, jnp.asarray(b))
        np.testing.assert_allclose(out, dense_a.T @ b, **MM_TOL)

    def test_batched_values(self):
        r, m, k = 3, 16, 24
        dense_a, sm = make_sparse(m, k, 0.7, seed=32)
        t = sm.topology
        vals = init_uniform((r, t.nnz_pad), seed=33) * t.valid
        topo_t, values_t = st.csr_transpose(t, jnp.asarray(vals))
        assert values_t.shape == (r, topo_t.nnz_pad)


class TestSpmmBiasRelu:
    def test_parity(self):
        # reference test_spmm_bias_relu.py: ones bias, compare vs dense + 1
        m, k, n = 72, 64, 72
        dense_a, sm = make_sparse(m, k, 0.0)
        b = init_uniform((k, n), seed=40)
        bias = np.ones(m, np.float32)
        out = st.spmm_bias_relu(
            sm.topology, jnp.asarray(sm.values), jnp.asarray(b), jnp.asarray(bias)
        )
        ref = np.maximum(dense_a @ b + 1.0, 0.0)
        np.testing.assert_allclose(out, ref, **MM_TOL)

    def test_relu_clamps(self):
        m, k, n = 16, 16, 8
        dense_a, sm = make_sparse(m, k, 0.5, seed=41)
        b = init_uniform((k, n), low=-1.0, high=1.0, seed=42)
        bias = init_uniform((m,), low=-2.0, high=0.0, seed=43)
        out = st.spmm_bias_relu(
            sm.topology, jnp.asarray(sm.values), jnp.asarray(b), jnp.asarray(bias)
        )
        ref = np.maximum(dense_a @ b + bias[:, None], 0.0)
        np.testing.assert_allclose(out, ref, **MM_TOL)
        assert (np.asarray(out) >= 0).all()


class TestGrads:
    """The gradcheck the reference never ran (SURVEY §4, BASELINE config 2)."""

    @pytest.mark.parametrize("sparsity", [0.25, 0.1])
    def test_spmm_grads(self, sparsity):
        m = k = n = 64  # scaled-down from 512 for CI speed; densities per BASELINE
        dense_a, sm = make_sparse(m, k, 1 - sparsity, seed=50)
        b = init_uniform((k, n), seed=51)
        f = lambda v, d: st.spmm(sm.topology, v, d)
        check_grads(f, (jnp.asarray(sm.values, jnp.float64),
                        jnp.asarray(b, jnp.float64)), order=1, modes=["rev"])

    @pytest.mark.parametrize("sparsity", [0.25, 0.1])
    def test_sddmm_grads(self, sparsity):
        m = n = 64
        d = 32
        mask, sm = make_sparse(m, n, 1 - sparsity, seed=52)
        lhs = init_uniform((m, d), seed=53)
        rhs = init_uniform((n, d), seed=54)
        f = lambda l, r: st.sddmm(sm.topology, l, r)
        check_grads(f, (jnp.asarray(lhs, jnp.float64),
                        jnp.asarray(rhs, jnp.float64)), order=1, modes=["rev"])

    def test_softmax_grad(self):
        mask, sm = make_sparse(32, 32, 0.8, seed=55)
        t = sm.topology
        vals = init_uniform((t.nnz_pad,), seed=56) * t.valid
        f = lambda v: st.sparse_softmax(t, v)
        check_grads(f, (jnp.asarray(vals, jnp.float64),), order=1, modes=["rev"])

    def test_spmm_grad_matches_dense(self):
        """values-grad == dense grad sampled at the mask (exact check)."""
        m, k, n = 24, 16, 8
        dense_a, sm = make_sparse(m, k, 0.7, seed=57)
        t = sm.topology
        b = init_uniform((k, n), seed=58)

        g_vals, g_b = jax.grad(
            lambda v, d: jnp.sum(st.spmm(t, v, d) ** 2), argnums=(0, 1)
        )(jnp.asarray(sm.values), jnp.asarray(b))

        def dense_loss(a, d):
            return jnp.sum((a @ d) ** 2)

        g_a_dense, g_b_dense = jax.grad(dense_loss, argnums=(0, 1))(
            jnp.asarray(dense_a), jnp.asarray(b)
        )
        got = np.zeros((m, k), np.float32)
        got[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = np.asarray(g_vals)[: t.nnz]
        # chained-grad comparison: fp32 accumulation-order noise compounds,
        # so use the reference's 1e-2-class threshold here
        np.testing.assert_allclose(got, np.asarray(g_a_dense) * (dense_a != 0),
                                   rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(g_b, g_b_dense, rtol=1e-2, atol=1e-2)
        # padding slots get zero grad
        np.testing.assert_array_equal(np.asarray(g_vals)[t.nnz:], 0.0)

    def test_bias_relu_grads(self):
        m, k, n = 24, 16, 8
        dense_a, sm = make_sparse(m, k, 0.6, seed=59)
        b = init_uniform((k, n), low=-1.0, high=1.0, seed=60)
        bias = init_uniform((m,), low=-0.5, high=0.5, seed=61)
        f = lambda v, d, bb: st.spmm_bias_relu(sm.topology, v, d, bb)
        check_grads(f, (jnp.asarray(sm.values, jnp.float64),
                        jnp.asarray(b, jnp.float64),
                        jnp.asarray(bias, jnp.float64)),
                    order=1, modes=["rev"], rtol=2e-2, atol=2e-2)


def test_flat_api_mixed_dtype_grads():
    """bf16/f32 mixed primals through the flat-CSR custom_vjps: the
    impls promote, so the backward rules must cast cotangents back to
    the primal dtypes (custom_vjp rejects promoted grads)."""
    rng = np.random.RandomState(21)
    A = ((rng.rand(48, 40) < 0.4) * rng.randn(48, 40)).astype(np.float32)
    mat = st.SparseMatrix(A)
    t = mat.topology
    vals16 = jnp.asarray(mat.values, jnp.bfloat16)
    dense = jnp.asarray(rng.randn(40, 24).astype(np.float32))
    bias = jnp.asarray(rng.randn(48).astype(np.float32))

    gv, gd = jax.grad(lambda v, d: jnp.sum(
        st.spmm(t, v, d).astype(jnp.float32)), argnums=(0, 1))(vals16, dense)
    assert gv.dtype == jnp.bfloat16 and gd.dtype == dense.dtype

    gv, gd, gb = jax.grad(lambda v, d, b: jnp.sum(
        st.spmm_bias_relu(t, v, d, b).astype(jnp.float32)),
        argnums=(0, 1, 2))(vals16, dense, bias)
    assert gv.dtype == jnp.bfloat16 and gb.dtype == bias.dtype

    lhs16 = jnp.asarray(rng.randn(48, 24), jnp.bfloat16)
    rhs = jnp.asarray(rng.randn(40, 24).astype(np.float32))
    gl, gr = jax.grad(lambda l, r: jnp.sum(
        st.sddmm(t, l, r).astype(jnp.float32)), argnums=(0, 1))(lhs16, rhs)
    assert gl.dtype == jnp.bfloat16 and gr.dtype == rhs.dtype

    gsm = jax.grad(lambda v: jnp.sum(
        st.sparse_softmax(t, v).astype(jnp.float32)))(vals16)
    assert gsm.dtype == jnp.bfloat16


def test_flat_dispatch_caches():
    """Eager flat-path caches: prebuilt jitted closure reused per
    (spec, dtype, epilogue, route); the values->panel cache is a bounded
    FIFO (it pins device buffers)."""
    from sputnik_tpu.ops.pallas import dispatch

    topo = st.SparseTopology.from_dense_mask(
        (np.random.RandomState(0).rand(256, 256) < 0.3).astype(
            np.float32))
    spec = dispatch._flat_spec(topo)
    assert dispatch._flat_spec(topo) is spec          # spec cached

    f1 = dispatch._flat_fn(spec, jnp.float32, "none")
    f2 = dispatch._flat_fn(spec, jnp.float32, "none")
    assert f1 is f2                                   # closure cached
    f3 = dispatch._flat_fn(spec, jnp.float32, "bias")
    assert f3 is not f1                               # epilogue keyed
    with route("pallas"):
        f4 = dispatch._flat_fn(spec, jnp.float32, "none")
    assert f4 is not f1                               # route keyed

    dispatch._panel_cache.clear()
    vals = [jnp.full((topo.nnz_pad,), float(i), jnp.float32)
            for i in range(dispatch._PANEL_CACHE_SLOTS + 3)]
    for v in vals:
        dispatch._values_panel(spec, v)
    assert len(dispatch._panel_cache) == dispatch._PANEL_CACHE_SLOTS
    # identity hit returns the SAME panel buffer
    p1 = dispatch._values_panel(spec, vals[-1])
    p2 = dispatch._values_panel(spec, vals[-1])
    assert p1 is p2
    dispatch._panel_cache.clear()


def test_flat_dispatch_cache_flush_and_size_guard():
    """set_backend flushes the flat-dispatch caches (pinned device buffers
    + prebuilt closures); traced values are never cached."""
    import sputnik_tpu as st
    from sputnik_tpu.ops.pallas import dispatch

    topo = st.SparseTopology.from_dense_mask(
        (np.random.RandomState(1).rand(64, 64) < 0.3).astype(np.float32))
    spec = dispatch._flat_spec(topo)
    vals = jnp.ones((topo.nnz_pad,), jnp.float32)
    dispatch.flush_caches()
    dispatch._values_panel(spec, vals)
    dispatch._flat_fn(spec, jnp.float32, "none")
    assert len(dispatch._panel_cache) == 1 and len(dispatch._fn_cache) >= 1
    st.set_backend("auto")
    assert len(dispatch._panel_cache) == 0
    assert len(dispatch._fn_cache) == 0

    jax.jit(lambda v: dispatch._values_panel(spec, v))(vals)
    assert len(dispatch._panel_cache) == 0            # traced: not pinned
