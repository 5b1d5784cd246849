"""Pallas-Triton kernels through the interpreter vs numpy references.

Every kernel of the GPU route — the block-CSR family (SpMM and SDDMM,
batched over replicas with shared per-topology metadata) and the
block-sparse flash attention (forward, dq, dk/dv) — runs here under
``interpret_kernels`` at small shapes, alongside its plain block-gather
twin, against an independent dense numpy computation. The transposed SpMM
has only the plain version, checked the same way. Cases cover empty
rows, partial blocks, row/column padding, GQA, a fully-masked attention
row, and f32/bf16 operands.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import sputnik_tpu as st
from sputnik_tpu.ops import batched_panel as bp
from sputnik_tpu.ops._common import interpret_kernels
from sputnik_tpu.ops.pallas import bsr_sddmm, bsr_spmm, bsr_spmm_t
from sputnik_tpu.ops.pallas import flash_sparse as fs

ROUTES = ["plain", "interpret"]
DTYPES = [jnp.float32, jnp.bfloat16]


def _run(route, fn, *args, **kw):
    if route == "interpret":
        with interpret_kernels():
            return fn(*args, **kw)
    return fn(*args, **kw)


def _tol(dtype):
    return 1e-4 if dtype == jnp.float32 else 3e-2


def _topos(B, m, n, seed):
    """B topologies of equal shape: random density with an empty row and
    an empty column block, so walks have padding and zero-length rows."""
    rng = np.random.RandomState(seed)
    out = []
    for b in range(B):
        mask = (rng.rand(m, n) < 0.3 + 0.2 * b).astype(np.float32)
        mask[3] = 0.0
        mask[:, 16:32] = 0.0
        out.append(st.SparseTopology.from_dense_mask(mask))
    return out


def _panels(topos, heads, bm, bk, rng, dtype):
    """Per-replica dense matrices + their stacked panels."""
    spec = bp.BatchedPanelSpec(topos, heads=heads, bm=bm, bk=bk)
    nnz_pad = max(t.nnz_pad for t in topos)
    dense, vals = [], []
    for r in range(spec.R):
        t = topos[r // heads]
        v = np.zeros(nnz_pad, np.float32)
        v[: t.nnz] = rng.randn(t.nnz)
        v = np.asarray(jnp.asarray(v, dtype).astype(jnp.float32))
        A = np.zeros((t.m, t.n), np.float32)
        A[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = v[: t.nnz]
        dense.append(A)
        vals.append(v)
    panels = jnp.asarray(spec.stack_values(np.stack(vals)), dtype)
    return spec, np.stack(dense), panels


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,heads", [(1, 1), (2, 2)])
def test_batched_spmm(B, heads, dtype, route):
    rng = np.random.RandomState(1)
    m, n, q = 40, 48, 24                      # m, n, q not tile multiples
    spec, A, panels = _panels(_topos(B, m, n, 2), heads, 16, 16, rng, dtype)
    meta = spec.meta
    x = rng.randn(spec.R, n, q).astype(np.float32)
    x = np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))
    xp = np.zeros((spec.R, spec.n_pad, 32), np.float32)
    xp[:, :n, :q] = x
    out = _run(route, bsr_spmm.bsr_spmm_batched,
               jnp.asarray(meta["block_cols"]), jnp.asarray(meta["nblocks"]),
               panels, jnp.asarray(xp, dtype), heads=heads, bn=16)
    ref = np.einsum("rmn,rnq->rmq", A, x)
    np.testing.assert_allclose(np.asarray(out)[:, :m, :q], ref,
                               atol=_tol(dtype) * 10, rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,heads", [(1, 1), (2, 2)])
def test_batched_spmm_t(B, heads, dtype):
    rng = np.random.RandomState(3)
    m, n, q = 40, 48, 20
    spec, A, panels = _panels(_topos(B, m, n, 4), heads, 16, 16, rng, dtype)
    meta = spec.meta
    g = rng.randn(spec.R, m, q).astype(np.float32)
    g = np.asarray(jnp.asarray(g, dtype).astype(jnp.float32))
    gp = np.zeros((spec.R, spec.m_pad, q), np.float32)
    gp[:, :m] = g
    out = bsr_spmm_t.bsr_spmm_t_batched(
        jnp.asarray(meta["t_src_i"]), jnp.asarray(meta["t_src_s"]),
        jnp.asarray(meta["t_nblocks"]), panels, jnp.asarray(gp, dtype),
        heads=heads, kb=spec.kb)
    ref = np.einsum("rmn,rmq->rnq", A, g)
    np.testing.assert_allclose(np.asarray(out)[:, :n, :q], ref,
                               atol=_tol(dtype) * 10, rtol=_tol(dtype))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,heads", [(1, 1), (2, 2)])
def test_batched_sddmm(B, heads, dtype, route):
    rng = np.random.RandomState(5)
    m, n, d = 40, 48, 24
    topos = _topos(B, m, n, 6)
    spec = bp.BatchedPanelSpec(topos, heads=heads, bm=16, bk=16)
    meta = spec.meta
    lhs = rng.randn(spec.R, m, d).astype(np.float32)
    rhs = rng.randn(spec.R, n, d).astype(np.float32)
    lhs, rhs = (np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))
                for x in (lhs, rhs))
    lp = np.zeros((spec.R, spec.m_pad, 32), np.float32)
    rp = np.zeros((spec.R, spec.n_pad, 32), np.float32)
    lp[:, :m, :d], rp[:, :n, :d] = lhs, rhs
    out = _run(route, bsr_sddmm.bsr_sddmm_batched,
               jnp.asarray(meta["block_cols"]), jnp.asarray(meta["nblocks"]),
               jnp.asarray(meta["mask"]), jnp.asarray(lp, dtype),
               jnp.asarray(rp, dtype), heads=heads)
    nnz_pad = max(t.nnz_pad for t in topos)
    got = np.asarray(spec.unstack_values(out, nnz_pad))
    for r in range(spec.R):
        t = topos[r // heads]
        want = np.einsum("kd,kd->k", lhs[r][t.row_ids[: t.nnz]],
                         rhs[r][t.column_indices[: t.nnz]])
        np.testing.assert_allclose(got[r, : t.nnz], want,
                                   atol=_tol(dtype) * 10, rtol=_tol(dtype))
    # padded slots and off-pattern elements stay zero
    dense_out = np.asarray(out)
    assert np.all(dense_out[jnp.asarray(meta["mask"]).repeat(
        heads, 0) == 0] == 0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("epilogue", ["bias", "bias_relu"])
def test_spmm_epilogue(epilogue, route):
    rng = np.random.RandomState(7)
    m, n, q = 40, 48, 16
    spec, A, panels = _panels(_topos(1, m, n, 8), 1, 16, 16, rng,
                              jnp.float32)
    meta = spec.meta
    x = rng.randn(1, spec.n_pad, q).astype(np.float32)
    bias = rng.randn(spec.m_pad).astype(np.float32)
    out = _run(route, bsr_spmm.bsr_spmm_batched,
               jnp.asarray(meta["block_cols"]), jnp.asarray(meta["nblocks"]),
               panels, jnp.asarray(x), jnp.asarray(bias), bn=16,
               epilogue=epilogue)
    ref = A[0] @ x[0, :n] + bias[:m, None]
    if epilogue == "bias_relu":
        ref = np.maximum(ref, 0.0)
    np.testing.assert_allclose(np.asarray(out)[0, :m], ref, atol=1e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_spmm_slot_subwalk(route):
    """``slot_sel``: a walk over a subset of each row's panel slots
    (the halo-overlap split) sums exactly those blocks."""
    rng = np.random.RandomState(9)
    m, n, q = 48, 64, 16
    (topo,) = _topos(1, m, n, 10)
    spec, A, panels = _panels([topo], 1, 16, 16, rng, jnp.float32)
    bv = topo.block(16, 16)
    # keep only the EVEN slots of every row block
    keep = [[s for s in range(int(bv.nblocks[i])) if s % 2 == 0]
            for i in range(bv.mb)]
    sub = max(max((len(k) for k in keep), default=1), 1)
    cols = np.zeros((bv.mb, sub), np.int32)
    sel = np.zeros((bv.mb, sub), np.int32)
    nblk = np.zeros(bv.mb, np.int32)
    ref = np.zeros((bv.m_pad, q), np.float32)
    x = rng.randn(bv.n_pad, q).astype(np.float32)
    P = np.asarray(panels)[0]
    for i, k in enumerate(keep):
        nblk[i] = len(k)
        for u, s_ in enumerate(k):
            c = int(bv.block_cols[i, s_])
            cols[i, u], sel[i, u] = c, s_
            ref[i * 16:(i + 1) * 16] += P[i, s_] @ x[c * 16:(c + 1) * 16]
    out = _run(route, bsr_spmm.bsr_spmm_panel_sel,
               jnp.asarray(cols.reshape(-1)), jnp.asarray(nblk),
               jnp.asarray(sel.reshape(-1)), panels[0], jnp.asarray(x),
               mb=bv.mb, max_bpr=sub, bm=16, bk=16, bn=16)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-4)


# ---------------------------------------------------------------------------
# Block-sparse flash attention.
# ---------------------------------------------------------------------------


def _attn_problem(group, dtype, seed):
    """2 masks x 4 heads at s=40 (padded to 48 by 16-tiles): a causal mask
    with a fully-masked row, and a random mask (partial blocks)."""
    rng = np.random.RandomState(seed)
    b, h, s, hd = 2, 4, 40, 16
    masks = np.stack([np.tril(np.ones((s, s), np.float32)),
                      (rng.rand(s, s) < 0.4).astype(np.float32)])
    masks[0, 7] = 0.0
    mt = st.ManyMaskTopology.from_dense_masks(masks)
    spec = bp.BatchedPanelSpec.from_many_mask(mt, heads=h, bm=16, bk=16)

    def mk(r):
        x = rng.randn(r, s, hd).astype(np.float32) * 0.5
        return jnp.asarray(x, dtype)

    return spec, masks, mk(b * h), mk(b * h // group), mk(b * h // group)


def _dense_attention(masks, q, k, v, heads, group):
    q, k, v = (np.asarray(jnp.asarray(x, jnp.float32)) for x in (q, k, v))
    k = np.repeat(k, group, axis=0)
    v = np.repeat(v, group, axis=0)
    m = np.repeat(masks, heads, axis=0) != 0
    sc = np.einsum("rqd,rkd->rqk", q, k) / np.sqrt(q.shape[-1])
    sc = np.where(m, sc, -1e30)
    w = np.exp(sc - sc.max(-1, keepdims=True)) * m
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-30)
    return np.einsum("rqk,rkd->rqd", w, v)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [1, 2])
def test_flash_forward(group, dtype, route):
    from sputnik_tpu.ops.fused_attention import fused_sparse_attention

    spec, masks, q, k, v = _attn_problem(group, dtype, 11)
    out = _run(route, fused_sparse_attention, spec, q, k, v, group=group)
    ref = _dense_attention(masks, q, k, v, spec.heads, group)
    tol = 1e-4 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, atol=tol)
    assert np.abs(np.asarray(out, np.float32)[: spec.heads, 7]).max() == 0.0


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("group", [1, 2])
def test_flash_backward(group, route):
    """dq (row walk) and dk/dv (transposed column walk) vs autodiff of the
    dense reference."""
    from sputnik_tpu.ops.fused_attention import fused_sparse_attention

    spec, masks, q, k, v = _attn_problem(group, jnp.float32, 12)
    cot = jnp.asarray(np.random.RandomState(13).randn(*q.shape),
                      jnp.float32)

    def dense(q_, k_, v_):
        k_ = jnp.repeat(k_, group, axis=0)
        v_ = jnp.repeat(v_, group, axis=0)
        m = jnp.repeat(jnp.asarray(masks), spec.heads, axis=0) != 0
        sc = jnp.einsum("rqd,rkd->rqk", q_, k_) / np.sqrt(q_.shape[-1])
        sc = jnp.where(m, sc, -1e30)
        w = jax.nn.softmax(sc, axis=-1) * m
        return jnp.einsum("rqk,rkd->rqd", w, v_)

    want = jax.grad(lambda *a: jnp.sum(dense(*a) * cot),
                    argnums=(0, 1, 2))(q, k, v)
    got = _run(route, jax.grad(
        lambda *a: jnp.sum(fused_sparse_attention(spec, *a, group=group)
                           * cot), argnums=(0, 1, 2)), q, k, v)
    for g_got, g_want, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(np.asarray(g_got), np.asarray(g_want),
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("route", ROUTES)
def test_flash_entry_stats_layout(route):
    """The forward entry's stats: lane 0 = row max, lane 1 = denominator
    of the scaled scores (what the backward entries read)."""
    spec, masks, q, k, v = _attn_problem(1, jnp.float32, 14)
    meta = fs.build_flash_meta(spec.views)
    scale = 1.0 / np.sqrt(q.shape[-1])
    qp = jnp.pad(q * scale, ((0, 0), (0, spec.m_pad - q.shape[1]), (0, 0)))
    kp = jnp.pad(k, ((0, 0), (0, spec.n_pad - k.shape[1]), (0, 0)))
    vp = jnp.pad(v, ((0, 0), (0, spec.n_pad - v.shape[1]), (0, 0)))
    out, stats = _run(
        route, fs.flash_sparse_attention_fwd,
        *(jnp.asarray(meta[x]) for x in ("block_cols", "nblocks",
                                         "mask_slot", "is_partial",
                                         "pmask")),
        qp, kp, vp, R=spec.R, heads=spec.heads, mb=spec.mb,
        max_bpr=meta["max_bpr"], bm=16, bk=16, packed_stats=True)
    sc = np.einsum("rqd,rkd->rqk", np.asarray(q) * scale, np.asarray(k))
    m = np.repeat(masks, spec.heads, axis=0) != 0
    row_max = np.where(m, sc, -np.inf).max(-1)
    live = m.any(-1)
    denom = np.where(m, np.exp(sc - np.where(live, row_max, 0)[..., None]),
                     0).sum(-1)
    st_ = np.asarray(stats)[:, : q.shape[1]]
    np.testing.assert_allclose(st_[..., 0][live], row_max[live], atol=1e-5)
    np.testing.assert_allclose(st_[..., 1][live], denom[live], rtol=1e-5)
    assert np.all(st_[..., 1][~live] == 0.0)


@pytest.mark.parametrize("route", ROUTES)
def test_ring_band_merge_equals_one_pass(route):
    """Two ring steps over two key bands, merged by the carried online
    softmax, equal one forward over the whole key range."""
    rng = np.random.RandomState(15)
    s, hd, R = 32, 16, 2
    mask = (rng.rand(s, s) < 0.5).astype(np.float32)
    mask[5] = 0.0
    topo = st.SparseTopology.from_dense_mask(mask)
    halves = [st.SparseTopology.from_dense_mask(mask[:, :16]),
              st.SparseTopology.from_dense_mask(mask[:, 16:])]
    views = [t.block(16, 16) for t in halves]
    metas = [fs.build_flash_meta([vw]) for vw in views]
    mpr = max(m_["max_bpr"] for m_ in metas)
    npart = max(m_["pmask"].shape[1] for m_ in metas)

    def stack(key):
        rows = []
        for m_ in metas:
            a = m_[key][0].reshape(views[0].mb, -1)
            pad = np.repeat(a[:, -1:], mpr - a.shape[1], axis=1)
            rows.append(np.concatenate([a, pad], axis=1).reshape(-1))
        return jnp.asarray(np.stack(rows))

    pm = np.ones((2, npart, 16, 16), np.float32)
    for i, m_ in enumerate(metas):
        pm[i, : m_["pmask"].shape[1]] = m_["pmask"][0]
    q = jnp.asarray(rng.randn(R, s, hd).astype(np.float32))
    k = jnp.asarray(rng.randn(R, s, hd).astype(np.float32))
    v = jnp.asarray(rng.randn(R, s, hd).astype(np.float32))
    acc = jnp.zeros((R, s, hd), jnp.float32)
    stt = jnp.zeros((R, s, 2), jnp.float32).at[..., 0].set(-1e30)
    for band in range(2):
        sl = slice(16 * band, 16 * band + 16)
        acc, stt = _run(
            route, fs.flash_sparse_ring_band_fwd,
            jnp.asarray([band], jnp.int32), stack("block_cols"),
            jnp.asarray(np.stack([m_["nblocks"][0] for m_ in metas])),
            stack("mask_slot"), stack("is_partial"), jnp.asarray(pm),
            q, k[:, sl], v[:, sl], acc, stt, R=R, mb=2, max_bpr=mpr,
            bm=16, bk=16)
    out = acc / jnp.maximum(stt[..., 1:2], 1e-30)
    ref = _dense_attention(mask[None], q * np.sqrt(hd), k, v, R, 1)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-4)
    del topo


# ---------------------------------------------------------------------------
# Lowering for the GPU: the Triton IR of every kernel is built on the host
# (``lowering_platforms=("cuda",)``), so shapes, dtypes and primitives the
# Triton route refuses fail here, without a card, at the real tile widths.
# ---------------------------------------------------------------------------


@pytest.fixture
def verified(monkeypatch):
    """Verify every Triton module as it is built (what the GPU compiler
    does first)."""
    from jax._src.pallas.triton import lowering as tl

    built = []
    orig = tl.lower_jaxpr_to_triton_module

    def lower_and_verify(*args, **kw):
        res = orig(*args, **kw)
        res.module.operation.verify()      # raises on an invalid module
        built.append(res)
        return res

    monkeypatch.setattr(tl, "lower_jaxpr_to_triton_module",
                        lower_and_verify)
    return built


def _lower(fn, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("epilogue", ["none", "bias_relu"])
def test_bsr_kernels_lower_for_cuda(dtype, epilogue, verified):
    R, mb, S, bm, bk, kb, n = 2, 4, 3, 128, 128, 4, 256
    cols = jnp.zeros((1, mb * S), jnp.int32)
    nblk = jnp.full((1, mb), S, jnp.int32)
    panels = jnp.zeros((R, mb, S, bm, bk), dtype)
    dense = jnp.zeros((R, kb * bk, n), dtype)
    bias = jnp.zeros((mb * bm,), jnp.float32)
    text = _lower(lambda c, nb, p, d, b_: bsr_spmm._spmm_triton(
        c, nb, None, p, d, b_, heads=R, bn=128, epilogue=epilogue,
        interpret=False), cols, nblk, panels, dense, bias).as_text()
    assert "bsr_spmm" in text
    _lower(lambda c, nb, p, d: bsr_spmm._spmm_triton(
        c, nb, c, p, d, None, heads=R, bn=128, epilogue="none",
        interpret=False), cols, nblk, panels, dense)
    mask = jnp.ones((1, mb, S, bm, bk), jnp.float32)
    lhs = jnp.zeros((R, mb * bm, 256), dtype)
    rhs = jnp.zeros((R, kb * bk, 256), dtype)
    _lower(lambda c, nb, m, l, r: bsr_sddmm._sddmm_triton(
        c, nb, m, l, r, heads=R, interpret=False),
        cols, nblk, mask, lhs, rhs)
    assert len(verified) == 3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group,hd", [(1, 128), (2, 64)])
def test_flash_kernels_lower_for_cuda(dtype, group, hd, verified):
    B, heads, mb, S, blk, npart = 1, 4, 8, 8, 64, 2
    R, M = B * heads, mb * blk
    i32 = jnp.int32
    meta = (jnp.zeros((B, mb * S), i32), jnp.full((B, mb), S, i32),
            jnp.zeros((B, mb * S), i32), jnp.zeros((B, mb * S), i32),
            jnp.ones((B, npart, blk, blk), jnp.float32))
    q = jnp.zeros((R, M, hd), dtype)
    kv = jnp.zeros((R // group, M, hd), dtype)
    vec = jnp.zeros((R, M), jnp.float32)
    text = _lower(lambda *a: fs._fwd_triton(
        *a, heads=heads, group=group, mode="kernel"),
        *meta, q, kv, kv).as_text()
    assert "flash_sparse_fwd" in text
    _lower(lambda *a: fs._dq_triton(
        *a, heads=heads, group=group, mode="kernel"),
        *meta, q, kv, kv, q, vec, vec, vec)
    _lower(lambda *a: fs._dkv_triton(
        *a, heads=heads, group=group, kb=mb, mode="kernel"),
        *meta, q, kv, kv, q, vec, vec, vec)
    assert len(verified) == 3
