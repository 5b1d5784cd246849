"""Decode/serving path: KV cache, block tables, sparse decode attention.

The reference has no serving path (SURVEY.md §1); these tests validate the
new decode family against dense numpy references: int8 quantized caches,
GQA grouping, and speculative qlen > 1.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import sputnik_tpu as st
from sputnik_tpu.ops import decode as D


def _filled_cache(R_kv, s_max, hd, n_tok, rng, dtype=jnp.float32):
    cache = D.init_kv_cache(R_kv, s_max, hd, dtype=dtype)
    for _ in range(n_tok):
        k = rng.randn(R_kv, hd).astype(np.float32)
        v = rng.randn(R_kv, hd).astype(np.float32)
        cache = D.append_kv(cache, jnp.asarray(k), jnp.asarray(v))
    return cache


def _dense_ref(q, ks, vs, allow, scale):
    """q [qlen, hd], ks/vs [s, hd], allow [qlen, s] bool."""
    sc = (q * scale) @ ks.T
    sc = np.where(allow, sc, -1e30)
    sc -= sc.max(axis=-1, keepdims=True)
    w = np.exp(sc)
    w = np.where(allow, w, 0.0)
    denom = np.maximum(w.sum(axis=-1, keepdims=True), 1e-30)
    return (w / denom) @ vs


class TestKVCache:
    def test_append_tracks_len_and_values(self):
        rng = np.random.RandomState(0)
        cache = _filled_cache(2, 512, 64, 5, rng)
        assert cache.kv_len.tolist() == [5, 5]
        assert cache.k.shape == (2, 512, 128)  # hd padded to lane width
        assert float(jnp.abs(cache.k[:, 5:]).max()) == 0.0

    def test_scalar_pos_matches_ragged_path(self):
        """append_kv(pos=...) (the aliasable serving fast path) must write
        exactly what the per-replica vmapped path writes."""
        rng = np.random.RandomState(3)
        for dtype in (jnp.float32, jnp.int8):
            a = D.init_kv_cache(3, 128, 64, dtype=dtype)
            b = D.init_kv_cache(3, 128, 64, dtype=dtype)
            for t in range(4):
                k = jnp.asarray(rng.randn(3, 64).astype(np.float32))
                v = jnp.asarray(rng.randn(3, 64).astype(np.float32))
                a = D.append_kv(a, k, v)
                b = D.append_kv(b, k, v, pos=b.kv_len[0])
            for f in ("k", "v", "k_scale", "v_scale", "kv_len"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                    err_msg=f"{dtype} field {f}")

    def test_scalar_pos_under_jit_scan(self):
        """The fast path must work as a scan carry (the decode loop)."""
        cache = D.init_kv_cache(2, 128, 64, dtype=jnp.bfloat16)
        toks = jnp.asarray(
            np.random.RandomState(4).randn(5, 2, 64).astype(np.float32))

        @jax.jit
        def run(cache, toks):
            def body(c, t):
                return D.append_kv(c, t, t, pos=c.kv_len[0]), ()
            c, _ = jax.lax.scan(body, cache, toks)
            return c

        out = run(cache, toks)
        assert out.kv_len.tolist() == [5, 5]
        np.testing.assert_allclose(
            np.asarray(out.k[:, :5, :64], np.float32),
            np.asarray(jnp.transpose(toks, (1, 0, 2)).astype(jnp.bfloat16),
                       np.float32))

    def test_int8_roundtrip(self):
        rng = np.random.RandomState(1)
        cache = D.init_kv_cache(1, 256, 128, dtype=jnp.int8)
        k = rng.randn(1, 128).astype(np.float32)
        v = rng.randn(1, 128).astype(np.float32)
        cache = D.append_kv(cache, jnp.asarray(k), jnp.asarray(v))
        kd = np.asarray(cache.k[0, 0].astype(jnp.float32)
                        * cache.k_scale[0, 0])
        assert np.abs(kd - k[0]).max() < np.abs(k).max() / 100


class TestPrefill:
    def test_prefill_matches_appends(self):
        rng = np.random.RandomState(7)
        R, s_max, hd, T = 2, 256, 64, 10
        ks = rng.randn(R, T, hd).astype(np.float32)
        vs = rng.randn(R, T, hd).astype(np.float32)
        by_append = D.init_kv_cache(R, s_max, hd, dtype=jnp.float32)
        for t in range(T):
            by_append = D.append_kv(by_append, jnp.asarray(ks[:, t]),
                                    jnp.asarray(vs[:, t]))
        bulk = D.prefill_kv(D.init_kv_cache(R, s_max, hd, jnp.float32),
                            jnp.asarray(ks), jnp.asarray(vs))
        np.testing.assert_allclose(np.asarray(bulk.k),
                                   np.asarray(by_append.k))
        assert bulk.kv_len.tolist() == by_append.kv_len.tolist()

    def test_prefill_ragged_lengths(self):
        rng = np.random.RandomState(8)
        ks = rng.randn(2, 8, 64).astype(np.float32)
        cache = D.prefill_kv(D.init_kv_cache(2, 256, 64, jnp.float32),
                             jnp.asarray(ks), jnp.asarray(ks),
                             lengths=jnp.asarray([3, 8], jnp.int32))
        assert cache.kv_len.tolist() == [3, 8]
        assert float(jnp.abs(cache.k[0, 3:]).max()) == 0.0

    def test_prefill_int8(self):
        rng = np.random.RandomState(9)
        ks = rng.randn(1, 4, 128).astype(np.float32)
        cache = D.prefill_kv(D.init_kv_cache(1, 256, 128, jnp.int8),
                             jnp.asarray(ks), jnp.asarray(ks))
        kd = np.asarray(cache.k[0, :4].astype(jnp.float32)) * \
            np.asarray(cache.k_scale[0, :4])[:, None]
        assert np.abs(kd - ks[0]).max() < np.abs(ks).max() / 100


class TestBlockTable:
    def test_window_and_sinks(self):
        kv_len = jnp.asarray([1, 300, 1024], jnp.int32)
        tbl, valid = D.decode_block_table(
            kv_len, s_max=1024, bk=128, window_blocks=2, sink_blocks=1)
        tbl, valid = np.asarray(tbl), np.asarray(valid)
        # len=1: only block 0 (sink); window slots collapse onto it
        assert valid[0].tolist() == [1, 0, 0]
        assert tbl[0, 0] == 0
        # len=300 -> last block 2: sink 0 + window {1, 2}
        assert valid[1].tolist() == [1, 1, 1]
        assert tbl[1].tolist() == [0, 1, 2]
        # len=1024 -> last block 7: sink 0 + window {6, 7}
        assert tbl[2].tolist() == [0, 6, 7]

    def test_empty_cache_all_invalid(self):
        tbl, valid = D.decode_block_table(
            jnp.asarray([0], jnp.int32), s_max=512, bk=128,
            window_blocks=2, sink_blocks=1)
        assert int(np.asarray(valid).sum()) == 0

    def test_topology_row_table(self):
        mask = np.zeros((4, 1024), np.float32)
        mask[3, [0, 5, 300, 999]] = 1
        topo = st.SparseTopology.from_dense_mask(mask)
        blocks, valid = D.table_from_topology_row(topo, 3, 128)
        assert blocks.tolist() == [0, 2, 7]
        assert valid.tolist() == [1, 1, 1]


class TestDecodeAttention:
    def test_parity_vs_dense(self):
        rng = np.random.RandomState(2)
        R, s_max, hd, bk = 3, 1024, 64, 128
        n_tok = 700
        cache = _filled_cache(R, s_max, hd, n_tok, rng)
        q = rng.randn(R, 1, hd).astype(np.float32)
        tbl, valid = D.decode_block_table(
            cache.kv_len, s_max=s_max, bk=bk, window_blocks=3,
            sink_blocks=1)
        out = np.asarray(D.decode_attention(jnp.asarray(q), cache, tbl,
                                            valid, bk=bk))
        assert out.shape == (R, 1, hd)

        scale = hd ** -0.5
        pos = np.arange(s_max)
        for r in range(R):
            allow = np.zeros((1, s_max), bool)
            for s_i in range(tbl.shape[1]):
                if int(valid[r, s_i]):
                    allow |= (pos // bk == int(tbl[r, s_i]))[None]
            allow &= (pos <= n_tok - 1)[None]
            ref = _dense_ref(q[r], np.asarray(cache.k[r, :, :hd]),
                             np.asarray(cache.v[r, :, :hd]), allow, scale)
            np.testing.assert_allclose(out[r], ref, rtol=2e-2, atol=2e-4)

    def test_int8_cache_matches_dense(self):
        """An int8 cache attends exactly like its dequantized f32 copy."""
        rng = np.random.RandomState(3)
        R, s_max, hd, bk = 2, 512, 128, 128
        n_tok = 400
        cache = _filled_cache(R, s_max, hd, n_tok, rng, dtype=jnp.int8)
        q = rng.randn(R, 1, hd).astype(np.float32)
        tbl, valid = D.decode_block_table(
            cache.kv_len, s_max=s_max, bk=bk, window_blocks=2,
            sink_blocks=1)
        got = np.asarray(D.decode_attention(jnp.asarray(q), cache, tbl,
                                            valid, bk=bk))
        kf = np.asarray(cache.k, np.float32) * np.asarray(
            cache.k_scale)[..., None]
        vf = np.asarray(cache.v, np.float32) * np.asarray(
            cache.v_scale)[..., None]
        pos = np.arange(s_max)
        for r in range(R):
            allow = np.zeros((1, s_max), bool)
            for s_i in range(tbl.shape[1]):
                if int(valid[r, s_i]):
                    allow |= (pos // bk == int(tbl[r, s_i]))[None]
            allow &= (pos <= n_tok - 1)[None]
            ref = _dense_ref(q[r], kf[r, :, :hd], vf[r, :, :hd], allow,
                             hd ** -0.5)
            np.testing.assert_allclose(got[r], ref, rtol=1e-4, atol=1e-5)

    def test_gqa_groups(self):
        rng = np.random.RandomState(4)
        R_kv, group, s_max, hd, bk = 2, 2, 512, 64, 128
        cache = _filled_cache(R_kv, s_max, hd, 300, rng)
        R = R_kv * group
        q = jnp.asarray(rng.randn(R, 1, hd).astype(np.float32))
        tbl1, valid1 = D.decode_block_table(
            cache.kv_len, s_max=s_max, bk=bk, window_blocks=2,
            sink_blocks=1)
        tbl = jnp.repeat(tbl1, group, axis=0)
        valid = jnp.repeat(valid1, group, axis=0)
        got = D.decode_attention(q, cache, tbl, valid, bk=bk, group=group)
        # reference: every query replica gets its own copy of its KV
        # replica's cache (group=1)
        expanded = D.KVCache(
            k=jnp.repeat(cache.k, group, axis=0),
            v=jnp.repeat(cache.v, group, axis=0),
            kv_len=jnp.repeat(cache.kv_len, group),
            k_scale=jnp.repeat(cache.k_scale, group, axis=0),
            v_scale=jnp.repeat(cache.v_scale, group, axis=0))
        ref = D.decode_attention(q, expanded, tbl, valid, bk=bk)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)

    def test_gqa_accepts_per_kv_table(self):
        """Passing the [R_kv, S] table straight from decode_block_table
        (what SparseDecoder does) must equal the pre-expanded [R, S]
        form. Regression: attention indexes tables by QUERY replica, so
        an un-expanded table reads out of range for r >= R_kv."""
        rng = np.random.RandomState(6)
        R_kv, group, s_max, hd, bk = 2, 2, 512, 64, 128
        cache = _filled_cache(R_kv, s_max, hd, 300, rng)
        q = jnp.asarray(rng.randn(R_kv * group, 1, hd).astype(np.float32))
        tbl, valid = D.decode_block_table(
            cache.kv_len, s_max=s_max, bk=bk, window_blocks=2,
            sink_blocks=1)
        got = D.decode_attention(q, cache, tbl, valid, bk=bk, group=group)
        ref = D.decode_attention(
            q, cache, jnp.repeat(tbl, group, axis=0),
            jnp.repeat(valid, group, axis=0), bk=bk, group=group)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-6, atol=1e-7)

    def test_speculative_qlen_causal(self):
        """qlen=4: each query row only sees keys up to its own position."""
        rng = np.random.RandomState(5)
        R, s_max, hd, bk, qlen = 1, 512, 64, 128, 4
        n_tok = 200
        cache = _filled_cache(R, s_max, hd, n_tok, rng)
        q = rng.randn(R, qlen, hd).astype(np.float32)
        tbl, valid = D.decode_block_table(
            cache.kv_len, s_max=s_max, bk=bk, window_blocks=2,
            sink_blocks=1)
        out = np.asarray(D.decode_attention(jnp.asarray(q), cache, tbl,
                                            valid, bk=bk, qlen=qlen))

        scale = hd ** -0.5
        pos = np.arange(s_max)
        allow_blk = np.zeros((s_max,), bool)
        for s_i in range(tbl.shape[1]):
            if int(valid[0, s_i]):
                allow_blk |= pos // bk == int(tbl[0, s_i])
        qpos = n_tok - qlen + np.arange(qlen)
        allow = allow_blk[None, :] & (pos[None, :] <= qpos[:, None])
        ref = _dense_ref(q[0], np.asarray(cache.k[0, :, :hd]),
                         np.asarray(cache.v[0, :, :hd]), allow, scale)
        np.testing.assert_allclose(out[0], ref, rtol=2e-2, atol=2e-4)

    def test_empty_cache_zeros(self):
        cache = D.init_kv_cache(1, 256, 64)
        q = jnp.ones((1, 1, 64), jnp.float32)
        tbl, valid = D.decode_block_table(
            cache.kv_len, s_max=256, bk=128, window_blocks=1,
            sink_blocks=1)
        out = D.decode_attention(q, cache, tbl, valid, bk=128)
        assert np.all(np.asarray(out) == 0.0)

    def test_shape_validation(self):
        cache = D.init_kv_cache(2, 256, 64)
        tbl = jnp.zeros((2, 1), jnp.int32)
        valid = jnp.ones((2, 1), jnp.int32)
        q = jnp.zeros((2, 2, 64), jnp.float32)
        with pytest.raises(ValueError):
            D.decode_attention(q, cache, tbl, valid, bk=128, qlen=1)
        with pytest.raises(ValueError):
            D.decode_attention(q, cache, tbl, valid, bk=100, qlen=2)
        with pytest.raises(ValueError):  # R mismatch vs group
            D.decode_attention(q[:1], cache, tbl, valid, bk=128, qlen=2)

    def test_decode_loop_appends_and_attends(self):
        """Mini serving loop: prefill 64 tokens, decode 8 more one by one."""
        rng = np.random.RandomState(6)
        R, s_max, hd, bk = 2, 256, 64, 128
        cache = _filled_cache(R, s_max, hd, 64, rng)
        for step in range(8):
            k = jnp.asarray(rng.randn(R, hd).astype(np.float32))
            v = jnp.asarray(rng.randn(R, hd).astype(np.float32))
            cache = D.append_kv(cache, k, v)
            tbl, valid = D.decode_block_table(
                cache.kv_len, s_max=s_max, bk=bk, window_blocks=1,
                sink_blocks=1)
            q = jnp.asarray(rng.randn(R, 1, hd).astype(np.float32))
            out = D.decode_attention(q, cache, tbl, valid, bk=bk)
            assert np.isfinite(np.asarray(out)).all()
        assert cache.kv_len.tolist() == [72, 72]
