"""Paged serving runtime: SparseDecoder with a shared KV page pool.

``PagedDecoder`` keeps the whole SparseDecoder surface (prefill through
the fused-flash prompt pass, jit-able decode steps, GQA, sinks+window
tables, bf16/int8 KV) but stores KV in per-layer page pools
(``ops/paged.py``) instead of per-slot contiguous buffers: HBM waste for
a ragged batch drops from ``sum(s_max - len)`` tokens to under one page
per (slot, kv-head, layer), and slots admit/evict without copying cache
data — the vLLM memory model.

Scheduling contract (the standard split): ``reserve(caches, n)`` is a
HOST step that allocates pages for the next ``n`` tokens (call it between
jitted decode segments — page allocation is control flow); the decode
step itself is fully jit-able. ``release(caches, slot)`` returns a
finished sequence's pages to the pools.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import paged as pg
from ..ops.decode import decode_block_table
from .serving import SparseDecoder

__all__ = ["PagedDecoder"]


class PagedDecoder(SparseDecoder):
    """Generation runtime over a page pool.

    Args (beyond SparseDecoder's):
      n_pages: pool capacity per layer, in pages of ``bk`` tokens,
        SHARED by all ``batch * kv_heads`` replicas. Size it as
        ``ceil(expected_total_tokens / bk) + batch * kv_heads`` (one
        partially-filled page per replica).
      s_max here is the per-sequence LENGTH CAP (table width), not a
        per-slot reservation — memory scales with tokens written, not
        with the cap.
    """

    def __init__(self, model, *, n_pages: int, s_max: int, bk: int = 256,
                 window=None, sinks: int = 0, cache_dtype=jnp.bfloat16):
        super().__init__(model, s_max=s_max, bk=bk, window=window,
                         sinks=sinks, cache_dtype=cache_dtype)
        self.n_pages = n_pages
        self.pools: List[pg.PagePool] = []

    # -- cache management ---------------------------------------------------

    def init_caches(self, batch: int) -> Tuple[pg.PagedKVCache, ...]:
        """One pooled cache per layer (allocators live on the decoder)."""
        R_kv = batch * self.kv_heads
        caches, self.pools = [], []
        for _ in range(self.model.num_layers):
            c, pool = pg.init_paged_cache(
                R_kv, self.n_pages, self.bk, self.hd, self.nb,
                dtype=self.cache_dtype)
            caches.append(c)
            self.pools.append(pool)
        return tuple(caches)

    def reserve(self, caches: Sequence[pg.PagedKVCache],
                n_tokens: int = 1) -> Tuple[pg.PagedKVCache, ...]:
        """HOST scheduler step: allocate pages for the next ``n_tokens``
        appends on every layer. Call between jitted decode segments."""
        return tuple(pg.ensure_pages(c, pool, n_tokens)
                     for c, pool in zip(caches, self.pools))

    def release(self, caches: Sequence[pg.PagedKVCache],
                slot: int) -> Tuple[pg.PagedKVCache, ...]:
        """Evict a finished sequence: free its pages on every layer."""
        return tuple(pg.free_pages_of(c, pool, slot,
                                      kv_heads=self.kv_heads)
                     for c, pool in zip(caches, self.pools))

    def share_prefix(self, caches: Sequence[pg.PagedKVCache], src: int,
                     dst: int, n_tokens: int) -> Tuple[pg.PagedKVCache, ...]:
        """Prefix caching (host step): admit slot ``dst`` with slot
        ``src``'s first ``n_tokens`` (system prompt / shared context) —
        full pages are refcount-shared, only a partial tail page copies.
        ``dst`` must be released first."""
        return tuple(pg.share_prefix(c, pool, src, dst, n_tokens,
                                     kv_heads=self.kv_heads)
                     for c, pool in zip(caches, self.pools))

    @property
    def free_pages(self) -> List[int]:
        return [p.free_pages for p in self.pools]

    # -- prefill --------------------------------------------------------------
    # SparseDecoder.prefill runs the prompt pass; only the cache hooks
    # differ: reserve pool pages up front, bulk-write pool pages per layer
    # (a duplicated attention body here drifted from the base once — the
    # hook keeps the 'PagedDecoder == SparseDecoder' oracle structural).

    def _prefill_setup(self, caches, T: int):
        if T % self.bk:
            raise ValueError(f"prompt length {T} must pad to bk={self.bk}")
        if isinstance(caches[0].kv_len, jax.core.Tracer):
            # under a trace (tensor-parallel shard_map, or a jitted
            # prefill) the host scheduler can't run — the caller must
            # have reserved the prompt pages already (PagedTPDecoder
            # and a pre-reserved jit both do)
            return caches
        return self.reserve(caches, T)     # pages for the whole prompt

    def _prefill_write(self, cache, k3, v3, len_r):
        T = k3.shape[1]
        pages = cache.page_table[:, : T // self.bk]
        if not isinstance(pages, jax.core.Tracer):
            pages = np.asarray(pages)      # host path: validated scatter
        return pg.write_prompt_pages(cache, k3, v3, replica_pages=pages,
                                     lengths=len_r)

    # -- decode ----------------------------------------------------------------

    def _paged_decode_layers(self, params, x, caches, append_fn, qlen,
                             advance, reduce_fn):
        """Shared decode layer loop (one body for the uniform, ragged and
        speculative steps — the contiguous decoder's `_decode_layers`
        pattern): per layer, append via ``append_fn(cache, k3, v3) ->
        cache`` then attend through the physical page table built from
        the step-shared logical table."""
        m = self.model
        b = x.shape[0]
        scale = 1.0 / float(np.sqrt(self.hd))
        kv_len1 = jnp.minimum(caches[0].kv_len + advance,
                              self.nb * self.bk)
        logical, valid0 = decode_block_table(
            kv_len1, s_max=self.s_max, bk=self.bk,
            window_blocks=self.window_blocks,
            sink_blocks=self.sink_blocks)
        # The PHYSICAL table is also step-shared: every layer's pool sees
        # the same reserve/release/share_prefix calls in the same order
        # (this class is the only writer), so the page tables are
        # identical across layers by construction (regression-tested:
        # test_paged.test_layer_page_tables_identical). Hoisting the
        # gather + masks out of the layer loop removes 3 * num_layers
        # XLA ops per decoded token.
        c0 = caches[0]
        phys = jnp.take_along_axis(
            c0.page_table, jnp.clip(logical, 0, c0.max_blocks - 1),
            axis=1)
        valid = valid0 * (phys >= 0).astype(jnp.int32)
        phys = jnp.where(valid == 1, phys, c0.dump_page)

        new_caches = []
        for i in range(m.num_layers):
            lp = self._layer_params(params, i)
            cache = caches[i]

            def attn(q, k, v):
                nonlocal cache
                cache = append_fn(cache, self._fold(k), self._fold(v))
                ctx = pg.paged_attention(
                    self._fold(q), cache, phys, logical, valid,
                    group=self.group, qlen=qlen, scale=scale)
                ctx = ctx.reshape(b, m.num_heads, qlen, self.hd)
                return jnp.transpose(ctx, (0, 2, 1, 3)).reshape(
                    b, qlen, m.num_heads * self.hd)

            x, _ = self._block(lp, x, attn, reduce_fn=reduce_fn)
            new_caches.append(cache)
        return x, tuple(new_caches)

    def decode_step(self, params, x_tok, caches, active=None,
                    reduce_fn=None):
        """One token per sequence (jit-able; run ``reserve`` first).

        Paged appends are per-replica by construction (each replica's
        current page differs), so uniform and ragged batches share this
        one step; ``active`` freezes finished slots exactly like the
        contiguous ragged step. Returns ``(y [b, 1, h], caches)``."""
        act_r = None
        if active is not None:
            act_r = jnp.repeat(jnp.asarray(active).astype(jnp.int32),
                               self.kv_heads)

        def append(cache, k3, v3):
            return pg.append_paged(cache, k3[:, 0], v3[:, 0],
                                   active=act_r)

        return self._paged_decode_layers(
            params, x_tok, caches, append, 1,
            act_r if act_r is not None else 1, reduce_fn)

    def decode_step_ragged(self, params, x_tok, caches, active=None,
                           reduce_fn=None):
        # paged appends are per-replica by construction: uniform and
        # ragged batches share one step
        return self.decode_step(params, x_tok, caches, active=active,
                                reduce_fn=reduce_fn)

    def decode_multi(self, params, x_toks, caches, reduce_fn=None):
        """Speculative-decode verification over the pool: advance
        ``q <= 8`` draft tokens at once (``reserve(caches, q)`` first).
        Per-replica all-or-nothing like the contiguous path: a replica
        whose draft doesn't fit (pages/table) writes nothing and its
        ``kv_len`` stays — the rejection signal (compare kv_len
        before/after). See ``SparseDecoder.decode_multi`` for the window
        caveat; reject tokens with the PER-REPLICA ``rollback``."""
        qn = x_toks.shape[1]

        def append(cache, k3, v3):
            return pg.append_paged_seq(cache, k3, v3)

        return self._paged_decode_layers(params, x_toks, caches, append,
                                         qn, qn, reduce_fn)

    def rollback(self, caches, n):
        """Reject the last ``n`` speculative tokens: shrink ``kv_len``.
        Pages stay allocated (later appends overwrite in place — no data
        movement, no pool traffic).

        ``n`` may be a scalar (uniform batch) or PER-SLOT ``i32[b]`` —
        batched speculative loops accept different prefix lengths per
        sequence, and a rejected replica (kv_len unchanged) must roll
        back ZERO: a scalar ``n`` over a mixed accept/reject batch would
        silently destroy real committed tokens on the rejected slots."""
        n = jnp.asarray(n, jnp.int32)
        if n.ndim == 1:
            n = jnp.repeat(n, self.kv_heads)
        return tuple(
            dataclasses.replace(c, kv_len=jnp.maximum(c.kv_len - n, 0))
            for c in caches)
