"""Paged KV cache: allocator, device ops, and PagedDecoder == SparseDecoder.

The oracle for the whole feature is the CONTIGUOUS serving path: paging
changes where bytes live, never what attention computes, so a paged
decoder must reproduce the block-cache decoder's outputs exactly (same
params, same tokens). Op-level tests compare against dense numpy
references built from the pool; the allocator/eviction tests exercise the
host scheduler half.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sputnik_tpu.models.serving import SparseDecoder
from sputnik_tpu.models.serving_paged import PagedDecoder
from sputnik_tpu.models.transformer import SparseTransformer
from sputnik_tpu.ops import paged as pg

H, HEADS, LAYERS, FFN = 32, 2, 2, 48


def _model(b, s, **kw):
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    return SparseTransformer.from_masks(
        masks, num_layers=LAYERS, hidden_size=H, num_heads=HEADS,
        ffn_hidden_size=FFN, use_residual=True, use_layernorm=True,
        activation="gelu", **kw)


# -- allocator ----------------------------------------------------------------


def test_page_pool_alloc_free():
    pool = pg.PagePool(4)
    a = pool.allocate(3)
    assert len(set(a)) == 3 and pool.free_pages == 1
    with pytest.raises(RuntimeError):
        pool.allocate(2)
    pool.free(a[:2])
    assert pool.free_pages == 3
    with pytest.raises(ValueError):
        pool.free([99])


def test_ensure_pages_and_capacity():
    cache, pool = pg.init_paged_cache(2, n_pages=4, bk=128, hd=16,
                                      max_blocks=2)
    cache = pg.ensure_pages(cache, pool, 1)
    tbl = np.asarray(cache.page_table)
    assert (tbl[:, 0] >= 0).all() and (tbl[:, 1] == -1).all()
    assert pool.free_pages == 2
    # advancing past max_blocks * bk must raise at reserve time
    cache = dataclasses.replace(
        cache, kv_len=jnp.asarray([2 * 128 - 1, 0], jnp.int32))
    with pytest.raises(ValueError):
        pg.ensure_pages(cache, pool, 2)


# -- device ops ---------------------------------------------------------------


def _dense_paged_ref(q, cache, phys, logical, valid, group=1, qlen=1):
    """Numpy reference: each query replica attends to its KV replica's
    tabled logical blocks, causally up to its cache position."""
    bk = cache.bk
    k = np.asarray(cache.k, np.float32) * np.asarray(
        cache.k_scale)[..., None]
    v = np.asarray(cache.v, np.float32) * np.asarray(
        cache.v_scale)[..., None]
    q = np.asarray(q, np.float32)
    R, _, hd = q.shape
    phys, logical = np.asarray(phys), np.asarray(logical)
    valid, kv_len = np.asarray(valid), np.asarray(cache.kv_len)
    out = np.zeros((R, qlen, hd), np.float32)
    for r in range(R):
        rk = r // group
        row = rk if phys.shape[0] != R else r
        ks, vs, pos = [], [], []
        for s_i in range(phys.shape[1]):
            if not valid[row, s_i]:
                continue
            ks.append(k[phys[row, s_i], :, :hd])
            vs.append(v[phys[row, s_i], :, :hd])
            pos.append(logical[row, s_i] * bk + np.arange(bk))
        if not ks:
            continue
        ks, vs, pos = (np.concatenate(x) for x in (ks, vs, pos))
        qpos = kv_len[rk] - qlen + np.arange(qlen)
        allow = pos[None, :] <= qpos[:, None]
        sc = np.where(allow, (q[r] * hd ** -0.5) @ ks.T, -1e30)
        w = np.exp(sc - sc.max(-1, keepdims=True)) * allow
        w = w / np.maximum(w.sum(-1, keepdims=True), 1e-30)
        out[r] = w @ vs
    return out


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int8])
def test_paged_append_writes_token(dtype):
    R, bk, hd = 4, 128, 24
    cache, pool = pg.init_paged_cache(R, n_pages=8, bk=bk, hd=hd,
                                      max_blocks=2, dtype=dtype)
    rng = np.random.RandomState(0)
    # ragged lengths incl. a page boundary and a frozen slot
    cache = dataclasses.replace(
        cache, kv_len=jnp.asarray([0, 127, 128, 37], jnp.int32))
    cache = pg.ensure_pages(cache, pool, 1)
    k_new = jnp.asarray(rng.randn(R, hd).astype(np.float32))
    v_new = jnp.asarray(rng.randn(R, hd).astype(np.float32))
    active = jnp.asarray([1, 1, 1, 0], jnp.int32)

    got = pg.append_paged(cache, k_new, v_new, active=active)
    np.testing.assert_array_equal(np.asarray(got.kv_len), [1, 128, 129, 37])
    # each active replica's token lands at (its page, its offset),
    # dequantizing back to the written values
    tbl0 = np.asarray(cache.page_table)
    tol = 1e-6 if dtype == jnp.float32 else 2e-2
    for r, pos in enumerate([0, 127, 128]):
        page, off = tbl0[r, pos // bk], pos % bk
        for buf, sc, new in ((got.k, got.k_scale, k_new),
                             (got.v, got.v_scale, v_new)):
            tok = np.asarray(buf[page, off, :hd], np.float32) * float(
                sc[page, off])
            np.testing.assert_allclose(tok, np.asarray(new[r]),
                                       rtol=tol, atol=tol * 4)
    # frozen replica's page is untouched
    tbl = np.asarray(cache.page_table)
    np.testing.assert_array_equal(np.asarray(got.k[tbl[3, 0]]),
                                  np.asarray(cache.k[tbl[3, 0]]))


def test_paged_append_unallocated_guard():
    """No page for the write position -> pool bit-identical, no advance."""
    cache, pool = pg.init_paged_cache(2, n_pages=4, bk=128, hd=16,
                                      max_blocks=2)
    cache = pg.ensure_pages(cache, pool, 1)
    # replica 1 sits exactly at a page boundary with block 1 unallocated
    cache = dataclasses.replace(
        cache, kv_len=jnp.asarray([5, 128], jnp.int32))
    k_new = jnp.ones((2, 16))
    out = pg.append_paged(cache, k_new, k_new)
    np.testing.assert_array_equal(np.asarray(out.kv_len), [6, 128])
    # replica 1 wrote nothing anywhere
    tbl = np.asarray(cache.page_table)
    np.testing.assert_array_equal(np.asarray(out.k[tbl[1, 0]]),
                                  np.asarray(cache.k[tbl[1, 0]]))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.int8])
def test_paged_attention_parity(dtype):
    """Paged attention vs the dense numpy reference on ragged pooled
    sequences."""
    R_kv, bk, hd, group = 3, 128, 32, 2
    R = R_kv * group
    cache, pool = pg.init_paged_cache(R_kv, n_pages=12, bk=bk, hd=hd,
                                      max_blocks=4, dtype=dtype)
    rng = np.random.RandomState(1)
    lengths = np.array([130, 37, 512])
    cache = dataclasses.replace(
        cache, kv_len=jnp.asarray(lengths, jnp.int32))
    cache = pg.ensure_pages(cache, pool, 0)
    # fill allocated pages with data (host write through the table)
    tbl = np.asarray(cache.page_table)
    k_np = np.asarray(cache.k, np.float32).copy()
    v_np = np.asarray(cache.v, np.float32).copy()
    ks_np = np.asarray(cache.k_scale).copy()
    vs_np = np.asarray(cache.v_scale).copy()
    for r in range(R_kv):
        for b in range((lengths[r] + bk - 1) // bk):
            page = tbl[r, b]
            tokens = rng.randn(bk, hd).astype(np.float32)
            if dtype == jnp.int8:
                sc = np.maximum(np.abs(tokens).max(-1), 1e-30) / 127.0
                k_np[page, :, :hd] = np.clip(
                    np.round(tokens / sc[:, None]), -127, 127)
                v_np[page, :, :hd] = k_np[page, :, :hd][::-1]
                ks_np[page] = sc
                vs_np[page] = sc[::-1]
            else:
                k_np[page, :, :hd] = tokens
                v_np[page, :, :hd] = tokens[::-1]
    cache = dataclasses.replace(
        cache,
        k=jnp.asarray(k_np.astype(np.int8) if dtype == jnp.int8
                      else k_np, dtype),
        v=jnp.asarray(v_np.astype(np.int8) if dtype == jnp.int8
                      else v_np, dtype),
        k_scale=jnp.asarray(ks_np), v_scale=jnp.asarray(vs_np))

    phys, logical, valid = pg.paged_block_table(cache, window_blocks=4)
    q = jnp.asarray(rng.randn(R, 1, hd).astype(np.float32))

    got = pg.paged_attention(q, cache, phys, logical, valid, group=group)
    want = _dense_paged_ref(q, cache, phys, logical, valid, group=group)
    # both contract the dequantized pool in f32
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5)


# -- end-to-end ---------------------------------------------------------------


def test_paged_decoder_matches_contiguous():
    """PagedDecoder == SparseDecoder on the same params/tokens (paging
    must change storage only), through prefill + ragged decode with a
    freeze, f32 exactness."""
    b, P = 2, 128
    model = _model(b, P)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((b, P, H)))
    rng = np.random.RandomState(2)
    prompts = jnp.asarray(rng.randn(b, P, H).astype(np.float32) * 0.3)
    toks = jnp.asarray(rng.randn(3, b, 1, H).astype(np.float32) * 0.3)

    ref_dec = SparseDecoder(model, s_max=P + 128, bk=128,
                            cache_dtype=jnp.float32)
    ref_caches = ref_dec.init_caches(b)
    y_ref, ref_caches = ref_dec.prefill(params, prompts, ref_caches)

    dec = PagedDecoder(model, n_pages=3 * b * HEADS, s_max=P + 128,
                       bk=128, cache_dtype=jnp.float32)
    caches = dec.init_caches(b)
    y, caches = dec.prefill(params, prompts, caches)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-6, atol=1e-6)

    actives = [np.array([True, True]), np.array([True, False]),
               np.array([True, True])]
    for t, act in enumerate(actives):
        caches = dec.reserve(caches, 1)
        y, caches = dec.decode_step(params, toks[t], caches,
                                    active=jnp.asarray(act))
        y_ref, ref_caches = ref_dec.decode_step_ragged(
            params, toks[t], ref_caches, active=jnp.asarray(act))
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                                   rtol=1e-5, atol=1e-5, err_msg=f"t={t}")


def test_paged_eviction_reuses_pages():
    """release() returns pages; a new sequence admitted into the freed
    slot reuses them and decodes correctly."""
    b, P = 2, 128
    model = _model(b, P)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((b, P, H)))
    rng = np.random.RandomState(3)
    prompts = jnp.asarray(rng.randn(b, P, H).astype(np.float32) * 0.3)

    # pool sized so both slots BARELY fit: eviction must be what makes
    # room for the re-admission
    dec = PagedDecoder(model, n_pages=2 * b * HEADS, s_max=P + 128,
                       bk=128, cache_dtype=jnp.float32)
    caches = dec.init_caches(b)
    _, caches = dec.prefill(params, prompts, caches)
    free0 = dec.free_pages[0]
    caches = dec.reserve(caches, 1)    # decode pages for both slots
    assert dec.free_pages[0] < free0 or free0 == 0

    # finish slot 0, release, re-admit: table row blanks and pool grows
    caches = dec.release(caches, 0)
    assert dec.free_pages[0] >= b  # slot 0's pages came back (per layer)
    tbl = np.asarray(caches[0].page_table)
    assert (tbl[: HEADS] == -1).all()
    assert int(caches[0].kv_len[0]) == 0

    # fresh prompt into slot 0 via a fresh batch=1 paged prefill on the
    # SAME pools is out of scope (pools are per-decoder); instead verify
    # the freed slot can grow again through reserve + append
    caches = dec.reserve(caches, 1)
    tok = jnp.asarray(rng.randn(b, 1, H).astype(np.float32) * 0.3)
    y, caches = dec.decode_step(params, tok, caches)
    assert np.isfinite(np.asarray(y)).all()
    assert int(caches[0].kv_len[0]) == 1          # restarted from zero
    assert int(caches[0].kv_len[HEADS]) == P + 1  # slot 1 kept going


def test_prefix_sharing_refcounts_and_parity():
    """Prefix caching: slot 1 admitted with slot 0's prefix via shared
    pages. Decoding the forked slot must equal decoding a slot whose
    prefix was prefilled independently; releasing the source must NOT
    free shared pages while the fork lives."""
    b, P = 2, 256     # two 128-token pages of prefix
    model = _model(b, P)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((b, P, H)))
    rng = np.random.RandomState(4)
    prompt = rng.randn(1, P, H).astype(np.float32) * 0.3
    prompts = jnp.asarray(np.concatenate([prompt, prompt], axis=0))
    toks = jnp.asarray(rng.randn(2, b, 1, H).astype(np.float32) * 0.3)

    # reference: both slots prefilled with the same prompt independently
    ref = PagedDecoder(model, n_pages=4 * b * HEADS, s_max=P + 128,
                       bk=128, cache_dtype=jnp.float32)
    rc = ref.init_caches(b)
    _, rc = ref.prefill(params, prompts, rc)

    # fork: prefill slot 0 only (batch mask via lengths=0 on slot 1),
    # release slot 1's (zero) state, then share slot 0's prefix into it
    dec = PagedDecoder(model, n_pages=4 * b * HEADS, s_max=P + 128,
                       bk=128, cache_dtype=jnp.float32)
    caches = dec.init_caches(b)
    _, caches = dec.prefill(params, prompts, caches,
                            lengths=jnp.asarray([P, 0]))
    caches = dec.release(caches, 1)          # blank slot 1
    free_before = dec.free_pages[0]
    caches = dec.share_prefix(caches, src=0, dst=1, n_tokens=P)
    # full-page prefix: sharing allocates nothing
    assert dec.free_pages[0] == free_before
    np.testing.assert_array_equal(np.asarray(caches[0].kv_len),
                                  [P] * (b * HEADS))

    for t in range(2):
        caches = dec.reserve(caches, 1)
        rc = ref.reserve(rc, 1)
        y, caches = dec.decode_step(params, toks[t], caches)
        y_ref, rc = ref.decode_step(params, toks[t], rc)
        np.testing.assert_allclose(np.asarray(y[1]), np.asarray(y_ref[1]),
                                   rtol=1e-5, atol=1e-5, err_msg=f"t={t}")
        # the fork must also not perturb the source slot
        np.testing.assert_allclose(np.asarray(y[0]), np.asarray(y_ref[0]),
                                   rtol=1e-5, atol=1e-5)

    # release the SOURCE: shared pages survive for the fork
    free_mid = dec.free_pages[0]
    caches = dec.release(caches, 0)
    # slot 0's own post-prefix decode pages return; the P//bk shared
    # prefix pages per replica do NOT
    assert dec.free_pages[0] > free_mid
    caches = dec.reserve(caches, 1)
    y, caches = dec.decode_step(params, toks[0], caches,
                                active=jnp.asarray([False, True]))
    assert np.isfinite(np.asarray(y[1])).all()
    # release the fork too (and slot 0 again — the final reserve() grew
    # the blank slot 0 as well): now everything returns
    caches = dec.release(caches, 1)
    caches = dec.release(caches, 0)
    assert dec.free_pages[0] == dec.pools[0].n_pages


def test_share_prefix_partial_page_copies():
    """Non-page-aligned prefix: the tail page is copied, not shared —
    the fork's appends must not corrupt the source."""
    cache, pool = pg.init_paged_cache(2, n_pages=6, bk=128, hd=16,
                                      max_blocks=3)
    rng = np.random.RandomState(5)
    # slot 0 (replica 0) holds 200 tokens: 1 full page + 72 in page 2
    cache = dataclasses.replace(cache,
                                kv_len=jnp.asarray([200, 0], jnp.int32))
    cache = pg.ensure_pages(cache, pool, 0)
    free0 = pool.free_pages
    cache = pg.share_prefix(cache, pool, 0, 1, 200)
    assert pool.free_pages == free0 - 1      # one copied tail page
    tbl = np.asarray(cache.page_table)
    assert tbl[1, 0] == tbl[0, 0]            # full page shared
    assert tbl[1, 1] != tbl[0, 1] and tbl[1, 1] >= 0  # tail copied
    # fork appends at 200 -> its own page; source bytes untouched
    out = pg.append_paged(cache, jnp.ones((2, 16)), jnp.ones((2, 16)),
                          active=jnp.asarray([0, 1], jnp.int32))
    np.testing.assert_array_equal(np.asarray(out.kv_len), [200, 201])
    np.testing.assert_array_equal(np.asarray(out.k[tbl[0, 1]]),
                                  np.asarray(cache.k[tbl[0, 1]]))
    # double-free protection via refcounts
    with pytest.raises(ValueError):
        pool.free([int(tbl[0, 0])] * 3)


def test_lmserver_paged_matches_contiguous():
    """LMServer(n_pages=...) greedy-generates token-identically to the
    contiguous server (paging is storage-only), prompt -> n_new tokens,
    f32 caches."""
    from sputnik_tpu.models import LMServer, SparseLM

    b, P, V, n_new = 2, 128, 97, 6
    masks = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                            (b, P, P)).copy()
    lm = SparseLM.from_masks(
        masks, vocab_size=V, num_layers=2, hidden_size=H,
        num_heads=HEADS, ffn_hidden_size=FFN, use_residual=True,
        use_layernorm=True, activation="gelu")
    rng = np.random.RandomState(8)
    prompt = jnp.asarray(rng.randint(0, V, (b, P)))
    params = lm.init(jax.random.PRNGKey(0), prompt)

    ref = LMServer(lm, s_max=P + 128, bk=128, cache_dtype=jnp.float32)
    toks_ref, _ = ref.generate(params, prompt, n_new)

    srv = LMServer(lm, s_max=P + 128, bk=128, cache_dtype=jnp.float32,
                   n_pages=3 * b * HEADS * 2)
    toks, _ = srv.generate(params, prompt, n_new)
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(toks_ref))


def test_paged_decode_multi_matches_contiguous():
    """Speculative verification over the pool == the contiguous
    decode_multi (same params/draft, f32), plus rollback parity."""
    b, P, q = 2, 128, 4
    model = _model(b, P)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((b, P, H)))
    rng = np.random.RandomState(9)
    prompts = jnp.asarray(rng.randn(b, P, H).astype(np.float32) * 0.3)
    draft = jnp.asarray(rng.randn(b, q, H).astype(np.float32) * 0.3)

    ref = SparseDecoder(model, s_max=P + 128, bk=128,
                        cache_dtype=jnp.float32)
    rc = ref.init_caches(b)
    _, rc = ref.prefill(params, prompts, rc)
    y_ref, rc2 = ref.decode_multi(params, draft, rc)

    dec = PagedDecoder(model, n_pages=3 * b * HEADS, s_max=P + 128,
                       bk=128, cache_dtype=jnp.float32)
    caches = dec.init_caches(b)
    _, caches = dec.prefill(params, prompts, caches)
    caches = dec.reserve(caches, q)
    y, caches2 = dec.decode_multi(params, draft, caches)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(caches2[0].kv_len),
                                  [P + q] * (b * HEADS))

    # rollback 2 rejected tokens, then a uniform step must equal the
    # contiguous decoder's after the same rollback
    caches3 = dec.rollback(caches2, 2)
    rc3 = ref.rollback(rc2, 2)
    tok = jnp.asarray(rng.randn(b, 1, H).astype(np.float32) * 0.3)
    caches3 = dec.reserve(caches3, 1)
    y_p, _ = dec.decode_step(params, tok, caches3)
    y_c, _ = ref.decode_step(params, tok, rc3)
    np.testing.assert_allclose(np.asarray(y_p), np.asarray(y_c),
                               rtol=1e-5, atol=1e-5)


def test_paged_decode_multi_overflow_all_or_nothing():
    """A draft that is not fully page-backed writes nothing and kv_len
    stays (the rejection signal), per replica."""
    cache, pool = pg.init_paged_cache(2, n_pages=4, bk=128, hd=16,
                                      max_blocks=2)
    import dataclasses as dc
    cache = dc.replace(cache, kv_len=jnp.asarray([120, 10], jnp.int32))
    cache = pg.ensure_pages(cache, pool, 1)   # block 0 only for r0
    toks = jnp.ones((2, 4, 16))
    out = pg.append_paged_seq(cache, toks, toks)
    # replica 0 needs positions 120..123 -> block 0 only? 123 < 128: fits!
    np.testing.assert_array_equal(np.asarray(out.kv_len), [124, 14])
    # now replica 0 at 126 would cross into unallocated block 1
    cache2 = dc.replace(out, kv_len=jnp.asarray([126, 14], jnp.int32))
    out2 = pg.append_paged_seq(cache2, toks, toks)
    np.testing.assert_array_equal(np.asarray(out2.kv_len), [126, 18])
    tbl = np.asarray(cache2.page_table)
    np.testing.assert_array_equal(np.asarray(out2.k[tbl[0, 0]]),
                                  np.asarray(cache2.k[tbl[0, 0]]))


def test_paged_attention_qlen_parity():
    """qlen > 1 (the speculative path) vs the dense numpy reference."""
    R_kv, bk, hd, qlen = 2, 128, 32, 4
    cache, pool = pg.init_paged_cache(R_kv, n_pages=8, bk=bk, hd=hd,
                                      max_blocks=3, dtype=jnp.float32)
    rng = np.random.RandomState(10)
    lengths = np.array([200, 131])
    cache = dataclasses.replace(cache,
                                kv_len=jnp.asarray(lengths, jnp.int32))
    cache = pg.ensure_pages(cache, pool, 0)
    tbl = np.asarray(cache.page_table)
    k_np = np.asarray(cache.k).copy()
    for r in range(R_kv):
        for blk in range((lengths[r] + bk - 1) // bk):
            k_np[tbl[r, blk], :, :hd] = rng.randn(bk, hd)
    cache = dataclasses.replace(cache, k=jnp.asarray(k_np),
                                v=jnp.asarray(k_np[:, ::-1]))
    phys, logical, valid = pg.paged_block_table(cache, window_blocks=3)
    q = jnp.asarray(rng.randn(R_kv, qlen, hd).astype(np.float32))

    got = pg.paged_attention(q, cache, phys, logical, valid, qlen=qlen)
    want = _dense_paged_ref(q, cache, phys, logical, valid, qlen=qlen)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4)


def test_paged_rollback_per_replica():
    """Mixed accept/reject batches roll back PER SLOT: the rejected
    slot's kv_len (the rejection signal) must not move — a scalar n
    would silently destroy its real committed tokens."""
    b, P, q = 2, 128, 4
    model = _model(b, P)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((b, P, H)))
    rng = np.random.RandomState(11)
    prompts = jnp.asarray(rng.randn(b, P, H).astype(np.float32) * 0.3)
    draft = jnp.asarray(rng.randn(b, q, H).astype(np.float32) * 0.3)

    # pool sized so slot 1's draft pages CANNOT be reserved: reserve for
    # slot 0 only via ensure_pages(replicas=...)
    dec = PagedDecoder(model, n_pages=2 * b * HEADS + HEADS, s_max=P + 128,
                       bk=128, cache_dtype=jnp.float32)
    caches = dec.init_caches(b)
    _, caches = dec.prefill(params, prompts, caches)
    caches = tuple(pg.ensure_pages(c, pool, q, replicas=range(HEADS))
                   for c, pool in zip(caches, dec.pools))

    _, caches2 = dec.decode_multi(params, draft, caches)
    kv = np.asarray(caches2[0].kv_len)
    assert (kv[:HEADS] == P + q).all()     # slot 0 accepted
    assert (kv[HEADS:] == P).all()         # slot 1 rejected (no pages)

    # slot 0 keeps 1 of 4 draft tokens; slot 1 rolls back zero
    caches3 = dec.rollback(caches2, jnp.asarray([q - 1, 0]))
    kv3 = np.asarray(caches3[0].kv_len)
    np.testing.assert_array_equal(kv3, [P + 1] * HEADS + [P] * HEADS)


def test_layer_page_tables_identical():
    """The decode step hoists the physical table from caches[0]
    (serving_paged._paged_decode_layers): every layer's pool sees the
    same host-scheduler calls, so the tables must stay bit-identical
    through a mixed reserve/decode/release/share/re-admit workload."""
    import jax

    from sputnik_tpu.models.serving_paged import PagedDecoder
    from sputnik_tpu.models.transformer import SparseTransformer

    b, s, heads, h = 2, 128, 2, 16
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    model = SparseTransformer.from_masks(
        masks, num_layers=3, hidden_size=h, num_heads=heads,
        ffn_hidden_size=32, use_residual=True, use_layernorm=True,
        activation="gelu")
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(b, s, h).astype(np.float32) * 0.3)
    params = model.init(jax.random.PRNGKey(0), x)
    dec = PagedDecoder(model, n_pages=16, s_max=256, bk=128,
                       cache_dtype=jnp.float32)
    caches = dec.init_caches(b)

    def check(cs):
        t0 = np.asarray(cs[0].page_table)
        for c in cs[1:]:
            np.testing.assert_array_equal(np.asarray(c.page_table), t0)

    _, caches = dec.prefill(params, x, caches)
    check(caches)
    tok = jnp.asarray(rng.randn(b, 1, h).astype(np.float32) * 0.3)
    for _ in range(3):
        caches = dec.reserve(caches, 1)
        y, caches = dec.decode_step(params, tok, caches)
        check(caches)
    caches = dec.release(caches, 1)
    check(caches)
    caches = dec.share_prefix(caches, 0, 1, 128)
    check(caches)
    caches = dec.reserve(caches, 1)
    y, caches = dec.decode_step(params, tok, caches)
    check(caches)
    assert np.isfinite(np.asarray(y)).all()
