"""Sequence-parallel fused sparse attention on the 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

import sputnik_tpu as st
from sputnik_tpu.ops._common import interpret_kernels
from sputnik_tpu.parallel import RowPartition
from sputnik_tpu.parallel.flash_sharded import (
    ShardedFlashSpec,
    flash_attention_sharded,
)

NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < NDEV:
        pytest.skip(f"need {NDEV} devices")
    return Mesh(np.array(devs[:NDEV]), ("sp",))


def _dense_ref(mask, q, k, v):
    hd = q.shape[-1]
    sc = np.einsum("rqd,rkd->rqk", q, k) / np.sqrt(hd)
    sc = np.where(mask != 0, sc, -1e30)
    e = np.exp(sc - sc.max(-1, keepdims=True)) * (mask != 0)
    w = e / np.maximum(e.sum(-1, keepdims=True), 1e-30)
    return np.einsum("rqk,rkd->rqd", w, v)


def test_sharded_flash_fwd_bwd_vs_dense(mesh):
    rng = np.random.RandomState(0)
    s, hd, R = 320, 32, 3
    mask = np.tril(np.ones((s, s), np.float32))
    mask[5, :] = 0.0
    part = RowPartition(st.SparseTopology.from_dense_mask(mask), NDEV,
                        bm=8, balance=False)
    spec = ShardedFlashSpec(part, bm=8, bk=128, mesh=mesh, axis="sp")
    q = rng.randn(R, s, hd).astype(np.float32)
    k = rng.randn(R, s, hd).astype(np.float32)
    v = rng.randn(R, s, hd).astype(np.float32)
    q_sh = jnp.asarray(q.reshape(R, NDEV, s // NDEV, hd).transpose(1, 0, 2, 3))

    out = jax.jit(lambda a, b, c: flash_attention_sharded(spec, a, b, c))(
        q_sh, jnp.asarray(k), jnp.asarray(v))
    got = np.asarray(out).transpose(1, 0, 2, 3).reshape(R, s, hd)
    ref = _dense_ref(mask, q, k, v)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.all(got[:, 5] == 0)  # fully-masked row

    gq, gk, gv = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(flash_attention_sharded(spec, a, b, c) ** 2),
        argnums=(0, 1, 2)))(q_sh, jnp.asarray(k), jnp.asarray(v))

    def dense(qq, kk, vv):
        scd = jnp.einsum("rqd,rkd->rqk", qq, kk) / np.sqrt(hd)
        scd = jnp.where(jnp.asarray(mask) != 0, scd, -1e30)
        wd = jax.nn.softmax(scd, axis=-1) * (jnp.asarray(mask) != 0)
        return jnp.einsum("rqk,rkd->rqd", wd, vv)

    gq_d, gk_d, gv_d = jax.grad(
        lambda a, b, c: jnp.sum(dense(a, b, c) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gq_got = np.asarray(gq).transpose(1, 0, 2, 3).reshape(R, s, hd)
    np.testing.assert_allclose(gq_got, np.asarray(gq_d), atol=1e-2)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gk_d), atol=1e-2)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(gv_d), atol=1e-2)


def test_sharded_flash_gqa(mesh):
    """kv_heads < heads on the 8-device mesh (r2 verdict #5): grouped KV
    replicas reproduce the dense reference with K/V expanded to full
    heads, forward AND dk/dv (locally group-summed before the psum)."""
    rng = np.random.RandomState(3)
    s, hd, R, group = 320, 32, 4, 2
    R_kv = R // group
    mask = np.tril(np.ones((s, s), np.float32))
    part = RowPartition(st.SparseTopology.from_dense_mask(mask), NDEV,
                        bm=8, balance=False)
    spec = ShardedFlashSpec(part, bm=8, bk=128, mesh=mesh, axis="sp")
    q = rng.randn(R, s, hd).astype(np.float32)
    k = rng.randn(R_kv, s, hd).astype(np.float32)
    v = rng.randn(R_kv, s, hd).astype(np.float32)
    q_sh = jnp.asarray(
        q.reshape(R, NDEV, s // NDEV, hd).transpose(1, 0, 2, 3))

    out = jax.jit(lambda a, b, c: flash_attention_sharded(
        spec, a, b, c, group=group))(q_sh, jnp.asarray(k), jnp.asarray(v))
    got = np.asarray(out).transpose(1, 0, 2, 3).reshape(R, s, hd)
    k_full = np.repeat(k, group, axis=0)
    v_full = np.repeat(v, group, axis=0)
    mask_r = np.broadcast_to(mask, (R, s, s))
    ref = _dense_ref(mask_r, q, k_full, v_full)
    np.testing.assert_allclose(got, ref, atol=1e-4)

    gq, gk, gv = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(
            flash_attention_sharded(spec, a, b, c, group=group) ** 2),
        argnums=(0, 1, 2)))(q_sh, jnp.asarray(k), jnp.asarray(v))
    assert gk.shape == (R_kv, s, hd) and gv.shape == (R_kv, s, hd)

    def dense(qq, kk, vv):
        kf = jnp.repeat(kk, group, axis=0)
        vf = jnp.repeat(vv, group, axis=0)
        scd = jnp.einsum("rqd,rkd->rqk", qq, kf) / np.sqrt(hd)
        scd = jnp.where(jnp.asarray(mask) != 0, scd, -1e30)
        wd = jax.nn.softmax(scd, axis=-1) * (jnp.asarray(mask) != 0)
        return jnp.einsum("rqk,rkd->rqd", wd, vf)

    gq_d, gk_d, gv_d = jax.grad(
        lambda a, b, c: jnp.sum(dense(a, b, c) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gq_got = np.asarray(gq).transpose(1, 0, 2, 3).reshape(R, s, hd)
    np.testing.assert_allclose(gq_got, np.asarray(gq_d), atol=1e-2)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gk_d), atol=1e-2)
    np.testing.assert_allclose(np.asarray(gv), np.asarray(gv_d), atol=1e-2)


def test_sharded_flash_gqa_validation(mesh):
    rng = np.random.RandomState(4)
    s, hd = 320, 16
    mask = np.tril(np.ones((s, s), np.float32))
    part = RowPartition(st.SparseTopology.from_dense_mask(mask), NDEV,
                        bm=8, balance=False)
    spec = ShardedFlashSpec(part, bm=8, bk=128, mesh=mesh, axis="sp")
    q_sh = jnp.asarray(rng.randn(NDEV, 4, s // NDEV, hd).astype(np.float32))
    kv = jnp.asarray(rng.randn(4, s, hd).astype(np.float32))
    with pytest.raises(ValueError):
        flash_attention_sharded(spec, q_sh, kv, kv, group=3)  # 3 !| 4
    with pytest.raises(ValueError):
        flash_attention_sharded(spec, q_sh, kv, kv, group=2)  # kv not R/2


def _window_mask(s, w):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    return ((j <= i) & (j > i - w)).astype(np.float32)


@pytest.mark.parametrize("group", [1, 2])
def test_kv_sharded_halo_matches_dense(mesh, group):
    """K/V-sharded halo attention (zero-psum backward) == dense reference
    on a banded topology, fwd + all grads, incl. GQA grouping."""
    from sputnik_tpu.parallel.flash_sharded import (
        flash_attention_kv_sharded)

    rng = np.random.RandomState(7)
    s, hd, R = 1024, 16, 2 * group
    R_kv = R // group
    mask = _window_mask(s, 96)           # causal band
    part = RowPartition(st.SparseTopology.from_dense_mask(mask), NDEV,
                        bm=8, balance=False)
    spec = ShardedFlashSpec(part, bm=8, bk=128, mesh=mesh, axis="sp")
    assert spec.halo_plan(spec.n_pad // NDEV) is not None  # ragged path
    n_loc = s // NDEV

    q = rng.randn(R, s, hd).astype(np.float32)
    k = rng.randn(R_kv, s, hd).astype(np.float32)
    v = rng.randn(R_kv, s, hd).astype(np.float32)
    q_sh = jnp.asarray(q.reshape(R, NDEV, n_loc, hd).transpose(1, 0, 2, 3))
    k_sh = jnp.asarray(k.reshape(R_kv, NDEV, n_loc, hd).transpose(1, 0, 2, 3))
    v_sh = jnp.asarray(v.reshape(R_kv, NDEV, n_loc, hd).transpose(1, 0, 2, 3))

    out = jax.jit(lambda a, b, c: flash_attention_kv_sharded(
        spec, a, b, c, group=group))(q_sh, k_sh, v_sh)
    got = np.asarray(out).transpose(1, 0, 2, 3).reshape(R, s, hd)
    mask_r = np.broadcast_to(mask, (R, s, s))
    ref = _dense_ref(mask_r, q, np.repeat(k, group, 0),
                     np.repeat(v, group, 0))
    np.testing.assert_allclose(got, ref, atol=1e-4)

    gq, gk, gv = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(flash_attention_kv_sharded(
            spec, a, b, c, group=group) ** 2),
        argnums=(0, 1, 2)))(q_sh, k_sh, v_sh)
    assert gk.shape == k_sh.shape and gv.shape == v_sh.shape

    def dense(qq, kk, vv):
        kf = jnp.repeat(kk, group, axis=0)
        vf = jnp.repeat(vv, group, axis=0)
        scd = jnp.einsum("rqd,rkd->rqk", qq, kf) / np.sqrt(hd)
        scd = jnp.where(jnp.asarray(mask) != 0, scd, -1e30)
        wd = jax.nn.softmax(scd, axis=-1) * (jnp.asarray(mask) != 0)
        return jnp.einsum("rqk,rkd->rqd", wd, vf)

    gq_d, gk_d, gv_d = jax.grad(
        lambda a, b, c: jnp.sum(dense(a, b, c) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gq_got = np.asarray(gq).transpose(1, 0, 2, 3).reshape(R, s, hd)
    gk_got = np.asarray(gk).transpose(1, 0, 2, 3).reshape(R_kv, s, hd)
    gv_got = np.asarray(gv).transpose(1, 0, 2, 3).reshape(R_kv, s, hd)
    np.testing.assert_allclose(gq_got, np.asarray(gq_d), atol=1e-2)
    np.testing.assert_allclose(gk_got, np.asarray(gk_d), atol=1e-2)
    np.testing.assert_allclose(gv_got, np.asarray(gv_d), atol=1e-2)


def test_kv_sharded_fallback_full_span(mesh):
    """Full-causal topology: halo spans the operand -> all_gather
    fallback, results still exact."""
    from sputnik_tpu.parallel.flash_sharded import (
        flash_attention_kv_sharded)

    rng = np.random.RandomState(8)
    s, hd, R = 320, 16, 2
    mask = np.tril(np.ones((s, s), np.float32))
    part = RowPartition(st.SparseTopology.from_dense_mask(mask), NDEV,
                        bm=8, balance=False)
    spec = ShardedFlashSpec(part, bm=8, bk=128, mesh=mesh, axis="sp")
    n_loc = spec.n_pad // NDEV
    assert spec.halo_plan(n_loc) is None
    q = rng.randn(R, s, hd).astype(np.float32)
    kv = rng.randn(R, s, hd).astype(np.float32)
    # s == 320 < n_pad == 384: keys live in the first s rows globally;
    # device d owns global key rows [d * n_loc, (d+1) * n_loc)
    k_rows = np.zeros((R, NDEV * n_loc, hd), np.float32)
    k_rows[:, :s] = kv
    k_sh = jnp.asarray(
        k_rows.reshape(R, NDEV, n_loc, hd).transpose(1, 0, 2, 3))
    n_loc_q = s // NDEV
    q_sh = jnp.asarray(
        q.reshape(R, NDEV, n_loc_q, hd).transpose(1, 0, 2, 3))

    out = jax.jit(lambda a, b, c: flash_attention_kv_sharded(
        spec, a, b, c))(q_sh, k_sh, k_sh)
    got = np.asarray(out).transpose(1, 0, 2, 3).reshape(R, s, hd)
    ref = _dense_ref(np.broadcast_to(mask, (R, s, s)), q, kv, kv)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_sharded_flash_kernels_match_plain(mesh):
    """Per-shard forward + dq/dkv backward through the Triton kernels
    (interpret) give the plain route's output and grads."""

    rng = np.random.RandomState(4)
    s, hd, R = 320, 32, 2
    mask = np.tril(np.ones((s, s), np.float32))
    part = RowPartition(st.SparseTopology.from_dense_mask(mask), NDEV,
                        bm=8, balance=False)
    spec = ShardedFlashSpec(part, bm=8, bk=128, mesh=mesh, axis="sp")
    q_sh = jnp.asarray(rng.randn(NDEV, R, s // NDEV, hd).astype(
        np.float32))
    k = jnp.asarray(rng.randn(R, s, hd).astype(np.float32))
    v = jnp.asarray(rng.randn(R, s, hd).astype(np.float32))

    def run():
        f = lambda a, b, c: flash_attention_sharded(spec, a, b, c)  # noqa
        out = jax.jit(f)(q_sh, k, v)
        return (out,) + jax.jit(jax.grad(
            lambda a, b, c: jnp.sum(f(a, b, c) ** 2),
            argnums=(0, 1, 2)))(q_sh, k, v)

    plain = run()
    with interpret_kernels():
        kern = run()
    for a, b, nm in zip(kern, plain, ("out", "q", "k", "v")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-3, err_msg=nm)
