"""Fused sparse attention (sparse-flash kernel) tests.

Interpret-mode parity vs the unfused batched-panel chain (itself validated
against dense attention), gradient parity, degenerate-mask safety, and the
model-layer ``layout="flash"`` wiring.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sputnik_tpu import many_mask as mm
from sputnik_tpu.ops import batched_panel as bp
from sputnik_tpu.ops._common import interpret_kernels
from sputnik_tpu.ops.fused_attention import fused_sparse_attention


@pytest.fixture
def problem():
    rng = np.random.RandomState(0)
    b, h, s, hd = 2, 2, 64, 32
    masks = np.stack([
        np.tril(np.ones((s, s), np.float32)),
        (rng.rand(s, s) < 0.35).astype(np.float32),
    ])
    masks[0, 9, :] = 0.0  # fully-masked row
    mt = mm.ManyMaskTopology.from_dense_masks(masks)
    spec = bp.BatchedPanelSpec.from_many_mask(mt, heads=h, bm=16, bk=16)
    mk = lambda seed: jnp.asarray(  # noqa: E731
        np.random.RandomState(seed).randn(b * h, s, hd).astype(np.float32))
    return dict(spec=spec, q=mk(1), k=mk(2), v=mk(3))


def _unfused(spec, q, k, v):
    """The SDDMM -> softmax -> SpMM panel chain (independent of the
    flash kernels)."""
    scores = bp.sddmm_bh(spec, q, k) / np.sqrt(q.shape[-1])
    return bp.spmm_bh(spec, bp.sparse_softmax_bh(spec, scores), v)


def test_fused_matches_unfused_and_handles_empty_row(problem):
    spec, q, k, v = (problem[x] for x in ("spec", "q", "k", "v"))
    ref = _unfused(spec, q, k, v)
    with interpret_kernels():
        out = fused_sparse_attention(spec, q, k, v)  # Triton, interpret
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)
    assert np.all(np.isfinite(np.asarray(out)))
    assert np.abs(np.asarray(out)[0, 9]).max() == 0.0  # masked row -> zeros


def test_fused_grads_match(problem):
    spec, q, k, v = (problem[x] for x in ("spec", "q", "k", "v"))

    def grads(fn):
        return jax.grad(lambda a, b_, c: jnp.sum(fn(spec, a, b_, c) ** 2),
                        argnums=(0, 1, 2))(q, k, v)

    ref = grads(_unfused)
    with interpret_kernels():
        g_kernel = grads(fused_sparse_attention)
    g_plain = grads(fused_sparse_attention)
    for got in (g_kernel, g_plain):
        for g_got, g_want in zip(got, ref):
            np.testing.assert_allclose(np.asarray(g_got),
                                       np.asarray(g_want), atol=1e-3)


def test_fused_rejects_bad_shapes(problem):
    spec, q, k, v = (problem[x] for x in ("spec", "q", "k", "v"))
    with pytest.raises(ValueError):
        fused_sparse_attention(spec, q[:1], k, v)
    with pytest.raises(ValueError):
        fused_sparse_attention(spec, q[:, :8], k, v)


def test_transformer_flash_layout_matches_panel():
    from sputnik_tpu.models.transformer import SparseCoreAttention

    rng = np.random.RandomState(5)
    b, s, h, heads = 2, 32, 32, 4
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    mt = mm.ManyMaskTopology.from_dense_masks(masks)
    q = jnp.asarray(rng.randn(b, s, heads, h // heads).astype(np.float32))
    k = jnp.asarray(rng.randn(b, s, heads, h // heads).astype(np.float32))
    v = jnp.asarray(rng.randn(b, s, heads, h // heads).astype(np.float32))
    attn_f = SparseCoreAttention(mask_topology=mt, num_heads=heads,
                                 layout="flash")
    out_f = jax.jit(lambda a, b, c: attn_f.apply({}, a, b, c))(q, k, v)
    out_p = SparseCoreAttention(mask_topology=mt, num_heads=heads,
                                layout="panel").apply({}, q, k, v)
    np.testing.assert_allclose(np.asarray(out_f), np.asarray(out_p),
                               atol=1e-4)


def test_fused_gqa_matches_expanded():
    """group=2 on grouped KV replicas == full-head attention with K/V
    repeated, kernel (interpret) AND plain route, fwd + all three grads."""
    rng = np.random.RandomState(11)
    b, h, s, hd = 2, 4, 64, 32
    group = 2
    kvh = h // group
    masks = np.stack([np.tril(np.ones((s, s), np.float32)),
                      (rng.rand(s, s) < 0.4).astype(np.float32)])
    mt = mm.ManyMaskTopology.from_dense_masks(masks)
    spec = bp.BatchedPanelSpec.from_many_mask(mt, heads=h, bm=16, bk=16)
    q = jnp.asarray(rng.randn(b * h, s, hd).astype(np.float32))
    k = jnp.asarray(rng.randn(b * kvh, s, hd).astype(np.float32))
    v = jnp.asarray(rng.randn(b * kvh, s, hd).astype(np.float32))
    k_full = jnp.repeat(k, group, axis=0)
    v_full = jnp.repeat(v, group, axis=0)

    for backend in ("plain", "interpret"):
        ctx = interpret_kernels() if backend == "interpret" else \
            contextlib.nullcontext()
        with ctx:
            out = fused_sparse_attention(spec, q, k, v, group=group)
            ref = fused_sparse_attention(spec, q, k_full, v_full)
            np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                       atol=1e-4, err_msg=backend)
            gq, gk, gv = jax.grad(
                lambda a, b_, c: jnp.sum(
                    fused_sparse_attention(spec, a, b_, c,
                                           group=group) ** 2),
                argnums=(0, 1, 2))(q, k, v)
            gq_f, gk_f, gv_f = jax.grad(
                lambda a, b_, c: jnp.sum(
                    fused_sparse_attention(spec, a, b_, c) ** 2),
                argnums=(0, 1, 2))(q, k_full, v_full)
            np.testing.assert_allclose(np.asarray(gq), np.asarray(gq_f),
                                       atol=1e-3, err_msg=backend)
            # expanded-path dk/dv fold back by group-sum
            for g_got, g_full in ((gk, gk_f), (gv, gv_f)):
                folded = np.asarray(g_full).reshape(
                    b * kvh, group, s, hd).sum(axis=1)
                np.testing.assert_allclose(np.asarray(g_got), folded,
                                           atol=1e-3, err_msg=backend)
    with pytest.raises(ValueError):
        fused_sparse_attention(spec, q, k, v, group=3)
    with pytest.raises(ValueError):
        fused_sparse_attention(spec, q, k_full, v_full, group=group)
