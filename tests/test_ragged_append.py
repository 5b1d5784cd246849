"""Ragged KV append: per-slot writes + the capacity invariant.

* the per-slot cache append (``vmap(dynamic_update_slice)`` at each
  replica's own position) writes exactly its token and nothing else;
* a slot sitting at ``kv_len == s_max`` used to get its last real token
  silently overwritten by the clamped write (documented, unenforced).
  The guard is now in the op; the tests here corrupt under the old
  behaviour and round-trip under the new one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sputnik_tpu.ops.decode import (
    KVCache, append_kv, append_kv_seq, init_kv_cache)


def _filled_cache(R, s_max, hd, dtype, rng, lengths):
    """Cache with `lengths[r]` random tokens written per replica."""
    cache = init_kv_cache(R, s_max, hd, dtype=dtype)
    hd_pad = cache.k.shape[-1]
    k = np.zeros((R, s_max, hd_pad), np.float32)
    v = np.zeros((R, s_max, hd_pad), np.float32)
    for r in range(R):
        k[r, : lengths[r], :hd] = rng.randn(lengths[r], hd)
        v[r, : lengths[r], :hd] = rng.randn(lengths[r], hd)
    if dtype == jnp.int8:
        ks = np.maximum(np.abs(k).max(-1), 1e-30) / 127.0
        vs = np.maximum(np.abs(v).max(-1), 1e-30) / 127.0
        cache = KVCache(
            k=jnp.asarray(np.clip(np.round(k / ks[..., None]), -127, 127),
                          jnp.int8),
            v=jnp.asarray(np.clip(np.round(v / vs[..., None]), -127, 127),
                          jnp.int8),
            kv_len=jnp.asarray(lengths, jnp.int32),
            k_scale=jnp.asarray(ks, jnp.float32),
            v_scale=jnp.asarray(vs, jnp.float32))
    else:
        cache = KVCache(
            k=jnp.asarray(k, dtype), v=jnp.asarray(v, dtype),
            kv_len=jnp.asarray(lengths, jnp.int32),
            k_scale=cache.k_scale, v_scale=cache.v_scale)
    return cache


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int8])
def test_ragged_append_writes_only_its_token(dtype):
    """Each active replica's token lands at its own position (and
    dequantizes back); every other cache row stays bit-identical."""
    R, s_max, hd = 5, 256, 48
    rng = np.random.RandomState(0)
    lengths = np.array([0, 31, 32, 127, 255])
    cache = _filled_cache(R, s_max, hd, dtype, rng, lengths)
    k_new = jnp.asarray(rng.randn(R, hd).astype(np.float32))
    v_new = jnp.asarray(rng.randn(R, hd).astype(np.float32))
    active = jnp.asarray([1, 1, 0, 1, 1], jnp.int32)

    got = append_kv(cache, k_new, v_new, active=active)
    tol = 1e-6 if dtype == jnp.float32 else 2e-2
    for r in (0, 1, 3, 4):
        p = int(lengths[r])
        for buf, sc, new, old in ((got.k, got.k_scale, k_new, cache.k),
                                  (got.v, got.v_scale, v_new, cache.v)):
            tok = np.asarray(buf[r, p, :hd], np.float32) * float(sc[r, p])
            np.testing.assert_allclose(tok, np.asarray(new[r]), rtol=tol,
                                       atol=tol * 4)
            rest = np.delete(np.arange(s_max), p)
            np.testing.assert_array_equal(np.asarray(buf[r])[rest],
                                          np.asarray(old[r])[rest])
    np.testing.assert_array_equal(np.asarray(got.kv_len),
                                  [1, 32, 32, 128, 256])
    # the frozen replica is bit-identical to its input
    np.testing.assert_array_equal(np.asarray(got.k[2]),
                                  np.asarray(cache.k[2]))
    assert int(got.kv_len[2]) == 32


def test_capacity_slot_untouched():
    """A replica at kv_len == s_max keeps its cache bit-identical through a
    ragged append — the round-2 clamped-write corruption, now enforced."""
    R, s_max, hd = 3, 128, 32
    rng = np.random.RandomState(1)
    lengths = np.array([s_max, 5, s_max])      # 0 and 2 are full
    cache = _filled_cache(R, s_max, hd, jnp.float32, rng, lengths)
    k_new = jnp.asarray(rng.randn(R, hd).astype(np.float32))
    v_new = jnp.asarray(rng.randn(R, hd).astype(np.float32))

    # replica 2 is ALSO frozen; replica 0 is active but full
    out = append_kv(cache, k_new, v_new,
                    active=jnp.asarray([1, 1, 0], jnp.int32))

    for r in (0, 2):
        np.testing.assert_array_equal(np.asarray(out.k[r]),
                                      np.asarray(cache.k[r]))
        np.testing.assert_array_equal(np.asarray(out.v[r]),
                                      np.asarray(cache.v[r]))
        assert int(out.kv_len[r]) == s_max     # pinned, not s_max + 1
    # the non-full replica still appended normally
    hd_pad = cache.k.shape[-1]
    np.testing.assert_allclose(np.asarray(out.k[1, 5, :hd]),
                               np.asarray(k_new[1]), rtol=1e-6)
    assert int(out.kv_len[1]) == 6


def test_uniform_path_capacity_guard():
    """decode_step's scalar-pos path: a full batch writes nothing."""
    R, s_max, hd = 2, 64, 16
    rng = np.random.RandomState(2)
    cache = _filled_cache(R, s_max, hd, jnp.float32, rng,
                          np.array([s_max, s_max]))
    out = append_kv(cache, jnp.ones((R, hd)), jnp.ones((R, hd)),
                    pos=jnp.int32(s_max))
    np.testing.assert_array_equal(np.asarray(out.k), np.asarray(cache.k))
    np.testing.assert_array_equal(np.asarray(out.v), np.asarray(cache.v))
    np.testing.assert_array_equal(np.asarray(out.kv_len), [s_max, s_max])


def test_seq_append_overflow_guard():
    """append_kv_seq: a draft that doesn't fit is all-or-nothing."""
    R, s_max, hd, q = 2, 64, 16, 4
    rng = np.random.RandomState(3)
    cache = _filled_cache(R, s_max, hd, jnp.float32, rng,
                          np.array([s_max - 2, s_max - 2]))
    toks = jnp.asarray(rng.randn(R, q, hd).astype(np.float32))
    out = append_kv_seq(cache, toks, toks, pos=jnp.int32(s_max - 2))
    np.testing.assert_array_equal(np.asarray(out.k), np.asarray(cache.k))
    np.testing.assert_array_equal(np.asarray(out.kv_len),
                                  np.asarray(cache.kv_len))
    # and one that does fit still lands
    ok = append_kv_seq(cache, toks[:, :2], toks[:, :2],
                       pos=jnp.int32(s_max - 2))
    np.testing.assert_array_equal(np.asarray(ok.kv_len), [s_max, s_max])
    np.testing.assert_allclose(np.asarray(ok.k[:, s_max - 2, :hd]),
                               np.asarray(toks[:, 0]), rtol=1e-6)


def test_int8_quantized_roundtrip():
    """int8 cache: an appended token dequantizes back."""
    R, s_max, hd = 3, 128, 32
    rng = np.random.RandomState(4)
    cache = _filled_cache(R, s_max, hd, jnp.int8, rng, np.array([3, 7, 99]))
    k_new = jnp.asarray(rng.randn(R, hd).astype(np.float32))
    v_new = jnp.asarray(rng.randn(R, hd).astype(np.float32))
    out = append_kv(cache, k_new, v_new)
    for r, ln in enumerate((3, 7, 99)):
        got_k = (np.asarray(out.k[r, ln, :hd], np.float32)
                 * float(out.k_scale[r, ln]))
        np.testing.assert_allclose(got_k, np.asarray(k_new[r]),
                                   atol=2 / 127 * np.abs(k_new[r]).max())
        assert int(out.kv_len[r]) == ln + 1


def test_ragged_step_full_slot_regression():
    """Serving-level regression: a ragged decode step with one FROZEN slot
    at capacity leaves that slot's cache exactly intact (this silently
    corrupted its last token before the guard)."""
    from sputnik_tpu.models.serving import SparseDecoder
    from sputnik_tpu.models.transformer import SparseTransformer

    H, HEADS, P = 16, 2, 8
    mask = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                           (2, P, P)).copy()
    model = SparseTransformer.from_masks(
        mask, num_layers=1, hidden_size=H, num_heads=HEADS,
        ffn_hidden_size=24, use_residual=True, use_layernorm=True,
        activation="gelu")
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, P, H)))
    dec = SparseDecoder(model, s_max=P, bk=8, cache_dtype=jnp.float32)

    rng = np.random.RandomState(5)
    prompts = jnp.asarray(rng.randn(2, P, H).astype(np.float32) * 0.3)
    caches = dec.init_caches(2)
    _, caches = dec.prefill(params, prompts, caches)   # both at kv_len == P
    before = [np.asarray(c.k).copy() for c in caches]

    # slot 0 frozen AT capacity; slot 1 "active" but also full
    x = jnp.asarray(rng.randn(2, 1, H).astype(np.float32))
    _, caches2 = dec.decode_step_ragged(
        params, x, caches, active=jnp.asarray([False, True]))
    for c2, b in zip(caches2, before):
        np.testing.assert_array_equal(np.asarray(c2.k), b)
        np.testing.assert_array_equal(np.asarray(c2.kv_len),
                                      [P] * (2 * dec.kv_heads))


def test_decode_step_at_capacity_table_clamped():
    """Uniform decode_step at kv_len == s_max must attend the SAME
    clamped window as the (already-clamped) ragged step — the unclamped
    kv_len + 1 table marked an out-of-range block valid, dropping block
    0 and double-counting the last (0.127 output error pre-fix)."""
    from sputnik_tpu.models.serving import SparseDecoder
    from sputnik_tpu.models.transformer import SparseTransformer

    H, HEADS, P = 16, 2, 8
    mask = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                           (2, P, P)).copy()
    model = SparseTransformer.from_masks(
        mask, num_layers=1, hidden_size=H, num_heads=HEADS,
        ffn_hidden_size=24, use_residual=True, use_layernorm=True,
        activation="gelu")
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, P, H)))
    rng = np.random.RandomState(6)
    prompts = jnp.asarray(rng.randn(2, P, H).astype(np.float32) * 0.3)
    x = jnp.asarray(rng.randn(2, 1, H).astype(np.float32))

    dec = SparseDecoder(model, s_max=P, bk=4, cache_dtype=jnp.float32)
    caches = dec.init_caches(2)
    _, caches = dec.prefill(params, prompts, caches)   # kv_len == s_max

    y_uni, c_uni = dec.decode_step(params, x, caches)
    y_rag, c_rag = dec.decode_step_ragged(params, x, caches)
    np.testing.assert_allclose(np.asarray(y_uni), np.asarray(y_rag),
                               rtol=1e-6, atol=1e-6)
    for cu, cr in zip(c_uni, c_rag):
        np.testing.assert_array_equal(np.asarray(cu.k), np.asarray(cr.k))
        np.testing.assert_array_equal(np.asarray(cu.kv_len),
                                      np.asarray(cr.kv_len))


def test_decode_multi_overflow_signals_via_kv_len():
    """Speculative step whose draft does not fit: kv_len is the rejection
    signal (unchanged), the cache is untouched, outputs stay finite."""
    from sputnik_tpu.models.serving import SparseDecoder
    from sputnik_tpu.models.transformer import SparseTransformer

    H, HEADS, P = 16, 2, 8
    mask = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                           (1, P, P)).copy()
    model = SparseTransformer.from_masks(
        mask, num_layers=1, hidden_size=H, num_heads=HEADS,
        ffn_hidden_size=24, use_residual=True, use_layernorm=True,
        activation="gelu")
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, P, H)))
    rng = np.random.RandomState(7)
    prompts = jnp.asarray(rng.randn(1, P, H).astype(np.float32) * 0.3)

    dec = SparseDecoder(model, s_max=P + 4, bk=4, cache_dtype=jnp.float32)
    caches = dec.init_caches(1)
    _, caches = dec.prefill(params, prompts, caches)   # kv_len == P
    draft = jnp.asarray(rng.randn(1, 6, H).astype(np.float32))  # 6 > 4 left
    before_k = np.asarray(caches[0].k).copy()
    y, caches2 = dec.decode_multi(params, draft, caches)
    assert np.isfinite(np.asarray(y)).all()
    np.testing.assert_array_equal(np.asarray(caches2[0].kv_len),
                                  np.asarray(caches[0].kv_len))
    np.testing.assert_array_equal(np.asarray(caches2[0].k), before_k)
