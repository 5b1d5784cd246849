"""Card-only tests: the compiled Pallas-Triton kernels against their
plain versions at small shapes. They skip without a GPU; on the card run
``SPUTNIK_TEST_GPU=1 python -m pytest tests -m gpu``. ``chip_smoke.py``
phase A runs the same compiled-kernel comparisons at full width."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import sputnik_tpu as st
from sputnik_tpu.ops import batched_panel as bp
from sputnik_tpu.ops import panel_api as P
from sputnik_tpu.ops.fused_attention import fused_sparse_attention


def _both_routes(fn, *args):
    with jax.default_matmul_precision("highest"):
        kernel = fn(*args)
        st.set_backend("xla")
        try:
            plain = fn(*args)
        finally:
            st.set_backend("auto")
    return kernel, plain


@pytest.mark.gpu
def test_bsr_kernels_compiled(gpu):
    rng = np.random.RandomState(0)
    topo = st.SparseTopology.from_dense_mask(
        (rng.rand(512, 384) < 0.2).astype(np.float32))
    spec = P.PanelSpec(topo)
    vals = jnp.asarray(np.where(topo.valid, rng.randn(topo.nnz_pad), 0),
                       jnp.float32)
    panel = P.values_to_panel(topo, vals, spec.bm, spec.bk)
    x = jnp.asarray(rng.randn(384, 256).astype(np.float32))
    g = jnp.asarray(rng.randn(512, 256).astype(np.float32))
    for fn, args in ((lambda p, d: P.spmm(spec, p, d), (panel, x)),
                     (lambda a, b: P.sddmm(spec, a, b), (g, x))):
        kernel, plain = _both_routes(jax.jit(fn), *args)
        np.testing.assert_allclose(np.asarray(kernel), np.asarray(plain),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_flash_kernels_compiled(gpu):
    rng = np.random.RandomState(1)
    s, h, hd = 256, 2, 64
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (2, s, s)).copy()
    mt = st.ManyMaskTopology.from_dense_masks(masks)
    spec = bp.BatchedPanelSpec.from_many_mask(mt, heads=h, bm=64, bk=64)
    q = jnp.asarray(rng.randn(2 * h, s, hd).astype(np.float32))

    def fwd_bwd(a):
        out = fused_sparse_attention(spec, a, a, a)
        return out, jax.grad(lambda b: jnp.sum(
            fused_sparse_attention(spec, b, b, b) ** 2))(a)

    (ok, gk), (op, gp) = _both_routes(jax.jit(fwd_bwd), q)
    np.testing.assert_allclose(np.asarray(ok), np.asarray(op), atol=1e-4)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gp), atol=1e-3)
