"""Paged KV cache: a shared page pool + per-sequence page tables.

The contiguous block cache (``ops/decode.py``) reserves ``s_max`` tokens
per sequence replica; a serving pool with ragged lengths strands
``s_max - len`` tokens of device memory per slot. Paging (the vLLM idea)
stores KV in a shared pool ``[P, bk, hd_pad]``; each sequence owns
an ordered page list (``page_table``), so HBM waste is bounded by one
page per replica and admission/eviction never moves data.

Division of labour (the standard serving split):

  * DEVICE (jit-able): ``append_paged`` (one token per replica),
    ``paged_block_table`` (logical sinks+window table -> physical
    pages), ``paged_attention`` (masked attention over the tabled
    pages).
  * HOST (the scheduler, between jitted segments): ``PagePool`` free-list
    allocation, ``ensure_pages`` (grow tables before the tokens that
    need them — page allocation is control flow, not dataflow, exactly
    like vLLM's scheduler step).

Capacity is enforced like the contiguous cache (r2 verdict #4): a
replica whose next block has no page (or that is frozen) neither writes
nor advances — the pool is bit-identical through its append.

Reference framework: no serving path at all (SURVEY.md §1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ._common import round_up
from .decode import QPAD, decode_block_table, pad_quantize_tokens

__all__ = ["PagePool", "PagedKVCache", "init_paged_cache", "ensure_pages",
           "append_paged", "append_paged_seq", "paged_block_table",
           "paged_attention", "write_prompt_pages", "share_prefix",
           "free_pages_of"]


class PagePool:
    """Host-side free-list allocator over page ids ``[0, n_pages)``.

    Lives OUTSIDE the jitted dataflow (allocation is scheduling). The
    pool arrays themselves carry ``n_pages + 1 +`` padding rows: row
    ``n_pages`` is the DUMP page — skipped appends write their (masked)
    bytes there, so a skipped append never touches a live page.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._rc = np.zeros(n_pages, np.int32)   # 0 = free

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"of {self.n_pages} (evict finished sequences first)")
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._rc[i] = 1
        return ids

    def share(self, ids) -> None:
        """Bump refcounts (prefix caching: several sequences' tables point
        at the same immutable full pages)."""
        for i in ids:
            if self._rc[i] <= 0:
                raise ValueError(f"sharing unallocated page {i}")
            self._rc[i] += 1

    def free(self, ids) -> None:
        """Drop one reference per id; a page returns to the free list only
        when its last reference goes."""
        for i in ids:
            if not 0 <= i < self.n_pages:
                raise ValueError(f"freeing foreign page id {i}")
            if self._rc[i] <= 0:
                raise ValueError(f"double free of page {i}")
            self._rc[i] -= 1
            if self._rc[i] == 0:
                self._free.append(int(i))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PagedKVCache:
    """Pooled KV. ``k``/``v``: ``[P_alloc, bk, hd_pad]`` (``P_alloc`` =
    n_pages + dump + pad-to-8); scales ``[P_alloc, bk]`` f32;
    ``page_table``: ``i32[R_kv, max_blocks]`` physical page per logical
    block (-1 = unallocated); ``kv_len``: ``i32[R_kv]``."""

    k: jax.Array
    v: jax.Array
    k_scale: jax.Array
    v_scale: jax.Array
    page_table: jax.Array
    kv_len: jax.Array

    @property
    def is_int8(self) -> bool:
        return self.k.dtype == jnp.int8

    @property
    def bk(self) -> int:
        return self.k.shape[1]

    @property
    def max_blocks(self) -> int:
        return self.page_table.shape[1]

    @property
    def dump_page(self) -> int:
        """Last (padded, never-allocated) pool row — skipped appends and
        invalid table slots aim here."""
        return int(self.k.shape[0] - 1)


def init_paged_cache(R_kv: int, n_pages: int, bk: int, hd: int,
                     max_blocks: int,
                     dtype=jnp.bfloat16) -> Tuple[PagedKVCache, PagePool]:
    """Empty pooled cache + its host allocator. ``bk`` (page size in
    tokens) must be a multiple of 128; ``max_blocks`` bounds any single
    sequence at ``max_blocks * bk`` tokens."""
    if bk % 128:
        raise ValueError(f"bk {bk} must be a multiple of 128")
    hd_pad = round_up(max(hd, 1), 128)
    P_alloc = round_up(n_pages + 1, 8)      # +1 dump page, pad to 8
    cache = PagedKVCache(
        k=jnp.zeros((P_alloc, bk, hd_pad), dtype),
        v=jnp.zeros((P_alloc, bk, hd_pad), dtype),
        k_scale=jnp.ones((P_alloc, bk), jnp.float32),
        v_scale=jnp.ones((P_alloc, bk), jnp.float32),
        page_table=jnp.full((R_kv, max_blocks), -1, jnp.int32),
        kv_len=jnp.zeros((R_kv,), jnp.int32),
    )
    return cache, PagePool(n_pages)


def ensure_pages(cache: PagedKVCache, pool: PagePool,
                 n_tokens: int = 1, replicas=None) -> PagedKVCache:
    """HOST scheduler step: make sure the next ``n_tokens`` appends have
    pages. Fetches ``kv_len``/``page_table`` to host (a sync point — call
    between jitted decode segments, vLLM-style), allocates missing pages,
    returns the cache with an updated table. ``replicas``: optional
    iterable restricting which replica rows grow."""
    kv_len = np.asarray(cache.kv_len)
    table = np.asarray(cache.page_table).copy()
    bk = cache.bk
    rows = range(table.shape[0]) if replicas is None else replicas
    # two-phase: collect every hole first, allocate ONCE, then fill —
    # allocating inside the scan would leak already-popped pages into a
    # discarded local table copy if a later replica raised (pool
    # exhaustion / capacity), permanently shrinking the pool
    holes = []
    for r in rows:
        last = (int(kv_len[r]) + n_tokens - 1) // bk
        if last >= table.shape[1]:
            raise ValueError(
                f"replica {r} needs block {last} >= max_blocks "
                f"{table.shape[1]}")
        # fill from block 0: admission can set kv_len directly (prefix
        # shares, restores), so earlier blocks may still be holes
        holes.extend((r, b) for b in range(0, last + 1)
                     if table[r, b] < 0)
    if not holes:
        return cache
    pages = pool.allocate(len(holes))   # atomic: raises before popping
    for (r, b), p in zip(holes, pages):
        table[r, b] = p
    return dataclasses.replace(cache,
                               page_table=jnp.asarray(table, jnp.int32))


def free_pages_of(cache: PagedKVCache, pool: PagePool, replica: int,
                  kv_heads: int = 1) -> PagedKVCache:
    """Evict a finished sequence: return the ``kv_heads`` replica rows'
    pages to the pool and blank their table rows + lengths (host step)."""
    table = np.asarray(cache.page_table).copy()
    kv_len = np.asarray(cache.kv_len).copy()
    for r in range(replica * kv_heads, (replica + 1) * kv_heads):
        pool.free([p for p in table[r] if p >= 0])
        table[r] = -1
        kv_len[r] = 0
    return dataclasses.replace(
        cache, page_table=jnp.asarray(table, jnp.int32),
        kv_len=jnp.asarray(kv_len, jnp.int32))


def share_prefix(cache: PagedKVCache, pool: PagePool, src: int, dst: int,
                 n_tokens: int, *, kv_heads: int = 1) -> PagedKVCache:
    """Prefix caching (host step): point slot ``dst``'s tables at slot
    ``src``'s first ``n_tokens`` of KV without copying full pages.

    Full prefix pages are SHARED (refcounted — they are immutable by
    construction: appends only ever touch a sequence's own tail page). A
    partial last page (``n_tokens % bk != 0``) is copied at fork time
    into a fresh page ``dst`` owns (copy-on-write resolved eagerly —
    ``dst``'s next appends land there). ``dst``'s previous pages must
    already be released. Returns the cache with updated tables/lengths;
    the KV pool bytes move only for the partial page."""
    bk = cache.bk
    table = np.asarray(cache.page_table).copy()
    kv_len = np.asarray(cache.kv_len).copy()
    k2, v2 = cache.k, cache.v
    ks2, vs2 = cache.k_scale, cache.v_scale
    full, rem = divmod(n_tokens, bk)
    for h in range(kv_heads):
        rs = src * kv_heads + h
        rd = dst * kv_heads + h
        if int(kv_len[rs]) < n_tokens:
            raise ValueError(
                f"src replica {rs} holds {int(kv_len[rs])} < {n_tokens}")
        if (table[rd] >= 0).any() or int(kv_len[rd]) != 0:
            raise ValueError(f"dst replica {rd} not released")
        shared = [int(p) for p in table[rs, :full]]
        if any(p < 0 for p in shared):
            raise ValueError("src prefix has unallocated pages")
        pool.share(shared)
        table[rd, :full] = shared
        if rem:
            new = pool.allocate(1)[0]
            srcp = int(table[rs, full])
            k2 = k2.at[new].set(k2[srcp])
            v2 = v2.at[new].set(v2[srcp])
            ks2 = ks2.at[new].set(ks2[srcp])
            vs2 = vs2.at[new].set(vs2[srcp])
            table[rd, full] = new
        kv_len[rd] = n_tokens
    return dataclasses.replace(
        cache, k=k2, v=v2, k_scale=ks2, v_scale=vs2,
        page_table=jnp.asarray(table, jnp.int32),
        kv_len=jnp.asarray(kv_len, jnp.int32))


def _resolve_write(cache: PagedKVCache, active):
    """(page, off, ok): the physical write slot per replica, with the
    capacity/frozen guard folded in. Skipped replicas aim at the dump
    page (disjoint from every live page)."""
    R = cache.kv_len.shape[0]
    bk = cache.bk
    blk = jnp.minimum(cache.kv_len // bk, cache.max_blocks - 1)
    page = jnp.take_along_axis(cache.page_table, blk[:, None], axis=1)[:, 0]
    ok = (page >= 0) & (cache.kv_len < cache.max_blocks * bk)
    if active is not None:
        ok = ok & (jnp.asarray(active).astype(jnp.int32) == 1)
    dump = cache.k.shape[0] - 1   # last (padded) row is never allocated
    page = jnp.where(ok, page, dump)
    off = jnp.where(ok, cache.kv_len % bk, 0)
    return page, off.astype(jnp.int32), ok.astype(jnp.int32)


def append_paged(cache: PagedKVCache, k_new, v_new,
                 active=None) -> PagedKVCache:
    """Append one token per replica into its current page. ``k_new``/
    ``v_new``: ``[R_kv, hd]``. A replica with no allocated page for its
    next position (run ``ensure_pages`` first), past its table capacity,
    or with ``active == 0`` is untouched and does not advance."""
    R = cache.kv_len.shape[0]
    hd_pad = cache.k.shape[-1]
    kq, vq, ks, vs = pad_quantize_tokens(k_new, v_new, hd_pad,
                                         cache.k.dtype)

    page, off, ok = _resolve_write(cache, active)
    new_len = cache.kv_len + ok

    # per-replica guarded dynamic updates into the pool
    k2, ks2 = cache.k, cache.k_scale
    v2, vs2 = cache.v, cache.v_scale
    for i in range(R):
        old = jax.lax.dynamic_slice(k2, (page[i], off[i], jnp.int32(0)),
                                    (1, 1, hd_pad))
        tok = jnp.where(ok[i] == 1, kq[i][None, None].astype(k2.dtype), old)
        k2 = jax.lax.dynamic_update_slice(
            k2, tok, (page[i], off[i], jnp.int32(0)))
        old = jax.lax.dynamic_slice(v2, (page[i], off[i], jnp.int32(0)),
                                    (1, 1, hd_pad))
        tok = jnp.where(ok[i] == 1, vq[i][None, None].astype(v2.dtype), old)
        v2 = jax.lax.dynamic_update_slice(
            v2, tok, (page[i], off[i], jnp.int32(0)))
        olds = jax.lax.dynamic_slice(ks2, (page[i], off[i]), (1, 1))
        sv = jnp.where(ok[i] == 1, ks[i][None, None], olds)
        ks2 = jax.lax.dynamic_update_slice(ks2, sv, (page[i], off[i]))
        olds = jax.lax.dynamic_slice(vs2, (page[i], off[i]), (1, 1))
        sv = jnp.where(ok[i] == 1, vs[i][None, None], olds)
        vs2 = jax.lax.dynamic_update_slice(vs2, sv, (page[i], off[i]))
    return dataclasses.replace(cache, k=k2, v=v2, k_scale=ks2,
                               v_scale=vs2, kv_len=new_len)


def append_paged_seq(cache: PagedKVCache, k_new, v_new,
                     active=None) -> PagedKVCache:
    """Append ``q <= QPAD`` tokens per replica (speculative drafts).
    ``k_new``/``v_new``: ``[R_kv, q, hd]``.

    ALL-OR-NOTHING per replica, like ``append_kv_seq``: a replica whose
    ``q`` positions are not all page-backed (or not all below the table
    capacity) writes nothing and does not advance — a partial draft
    write would desync rollback. Tokens may span a page boundary; the
    write unrolls into ``q`` single-token paged appends (each moves
    tens of KB — the draft is 8 tokens, not a prompt)."""
    R, q, _ = k_new.shape
    if q > QPAD:
        raise ValueError(f"draft length {q} > {QPAD}")
    bk = cache.bk
    # every target position must have a page and fit the table
    pos = cache.kv_len[:, None] + jnp.arange(q)[None, :]       # [R, q]
    blk = jnp.clip(pos // bk, 0, cache.max_blocks - 1)
    pages = jnp.take_along_axis(cache.page_table, blk, axis=1)
    fits = jnp.all((pages >= 0) & (pos < cache.max_blocks * bk), axis=1)
    ok = fits.astype(jnp.int32)
    if active is not None:
        ok = ok * jnp.asarray(active).astype(jnp.int32)
    for t in range(q):
        cache = append_paged(cache, k_new[:, t], v_new[:, t], active=ok)
    return cache


def write_prompt_pages(cache: PagedKVCache, k_seq, v_seq, *,
                       replica_pages: np.ndarray,
                       lengths=None) -> PagedKVCache:
    """Bulk prefill write (host-known page ids -> static scatter).

    ``k_seq``/``v_seq``: ``[R_kv, T, hd]``; ``replica_pages``: host
    ``i32[R_kv, T // bk]`` physical page per prompt block (from
    ``ensure_pages`` + the cache's table, fetched host-side at admission
    time). ``lengths``: valid tokens per replica (pad tokens are zeroed
    and never attended thanks to ``kv_len``).

    ``replica_pages`` may also be a TRACED array (tensor-parallel
    serving runs the prefill inside ``shard_map``, where the table
    cannot be fetched to host): the write becomes a device scatter and
    unallocated (< 0) ids are redirected to the dump page instead of
    raising — the caller must have reserved the prompt's pages before
    entering the trace (``PagedTPDecoder.prefill`` does)."""
    R, T, hd = k_seq.shape
    bk = cache.bk
    if T % bk:
        raise ValueError(f"prompt length {T} must pad to page size {bk}")
    nb = T // bk
    hd_pad = cache.k.shape[-1]
    if lengths is None:
        lengths = jnp.full((R,), T, jnp.int32)
    # zero pad tokens BEFORE quantizing (their scales become the floor)
    msk = (jnp.arange(T)[None, :] < lengths[:, None])[..., None]
    k_seq = jnp.where(msk, k_seq.astype(jnp.float32), 0.0)
    v_seq = jnp.where(msk, v_seq.astype(jnp.float32), 0.0)
    kq, vq, ks, vs = pad_quantize_tokens(k_seq, v_seq, hd_pad,
                                         cache.k.dtype)

    if isinstance(replica_pages, jax.core.Tracer):
        pages = jnp.reshape(replica_pages, (-1,))          # [R * nb]
        idx = jnp.where(pages < 0, cache.k.shape[0] - 1,
                        pages).astype(jnp.int32)
    else:
        pages = np.asarray(replica_pages).reshape(-1)      # [R * nb]
        if (pages < 0).any():
            raise ValueError("unallocated page in replica_pages")
        idx = jnp.asarray(pages, jnp.int32)
    kq = kq.reshape(R * nb, bk, hd_pad)
    vq = vq.reshape(R * nb, bk, hd_pad)
    ks = ks.reshape(R * nb, bk)
    vs = vs.reshape(R * nb, bk)
    return dataclasses.replace(
        cache,
        k=cache.k.at[idx].set(kq),
        v=cache.v.at[idx].set(vq),
        k_scale=cache.k_scale.at[idx].set(ks),
        v_scale=cache.v_scale.at[idx].set(vs),
        kv_len=lengths.astype(jnp.int32),
    )


def paged_block_table(cache: PagedKVCache, *, window_blocks: int,
                      sink_blocks: int = 0, advance=None):
    """Physical sinks+window table from the cache state (device, jit-able).

    Returns ``(phys i32[R, S], logical i32[R, S], valid i32[R, S])``.
    ``advance``: optional per-replica i32 added to ``kv_len`` first (the
    decode step tables the position AFTER this step's append)."""
    kv_len = cache.kv_len + (advance if advance is not None else 0)
    bk = cache.bk
    logical, valid = decode_block_table(
        kv_len, s_max=cache.max_blocks * bk, bk=bk,
        window_blocks=window_blocks, sink_blocks=sink_blocks)
    phys = jnp.take_along_axis(
        cache.page_table, jnp.clip(logical, 0, cache.max_blocks - 1),
        axis=1)
    valid = valid * (phys >= 0).astype(jnp.int32)
    # invalid slots: aim at the dump page; decode_block_table already
    # repeats the previous valid logical id so consecutive slots mostly
    # share pages (DMA elided)
    phys = jnp.where(valid == 1, phys, cache.k.shape[0] - 1)
    return phys.astype(jnp.int32), logical.astype(jnp.int32), valid


def _oracle(q, cache: PagedKVCache, phys, logical, valid, group, scale,
            qlen):
    """Dense jnp reference: gather pages back to contiguous KV, then the
    standard masked attention (CPU path + correctness oracle)."""
    R = q.shape[0]
    bk, mb = cache.bk, cache.max_blocks
    tbl = jnp.clip(cache.page_table, 0, cache.k.shape[0] - 1)
    kf = (cache.k.astype(jnp.float32)
          * cache.k_scale[..., None])[tbl]      # [R_kv, mb, bk, hd_pad]
    vf = (cache.v.astype(jnp.float32) * cache.v_scale[..., None])[tbl]
    kf = kf.reshape(tbl.shape[0], mb * bk, -1)
    vf = vf.reshape(tbl.shape[0], mb * bk, -1)
    hd = q.shape[-1]
    s_max = mb * bk

    outs = []
    for r in range(R):
        rk = r // group
        sc = (q[r, :qlen].astype(jnp.float32) * scale) @ kf[rk, :, :hd].T
        pos = jnp.arange(s_max)
        qpos = cache.kv_len[rk] - qlen + jnp.arange(qlen)
        allow = jnp.zeros((s_max,), bool)
        for s in range(logical.shape[1]):
            in_blk = pos // bk == logical[r, s]
            allow = allow | (in_blk & (valid[r, s] == 1))
        m = allow[None, :] & (pos[None, :] <= qpos[:, None])
        sc = jnp.where(m, sc, -1e30)
        w = jax.nn.softmax(sc, axis=-1)
        w = jnp.where(m, w, 0.0)
        outs.append(w @ vf[rk, :, :hd])
    return jnp.stack(outs)


def paged_attention(q, cache: PagedKVCache, phys, logical, valid, *,
                    group: int = 1, qlen: int = 1,
                    scale: Optional[float] = None):
    """Paged decode attention: ``q [R, qlen, hd]`` against the
    tabled pool pages. Returns ``f32[R, qlen, hd]``. ``qlen > 1`` serves
    speculative verification (queries are the last ``qlen`` cache
    positions, causally masked). ``phys``/``logical``/``valid`` may be
    per KV replica (``[R_kv, S]``) — expanded per query replica here,
    like ``decode_attention``."""
    R, qn, hd = q.shape
    if qn != qlen:
        raise ValueError(f"q has qlen {qn}, expected {qlen}")
    if qlen > QPAD:
        raise ValueError(f"qlen > {QPAD} not supported (got {qlen})")
    R_kv = cache.kv_len.shape[0]
    if R != R_kv * group:
        raise ValueError(f"R {R} != R_kv {R_kv} * group {group}")
    if group > 1 and phys.shape[0] == R_kv:
        phys = jnp.repeat(phys, group, axis=0)
        logical = jnp.repeat(logical, group, axis=0)
        valid = jnp.repeat(valid, group, axis=0)
    if phys.shape[0] != R:
        raise ValueError(f"table rows {phys.shape[0]} != R {R}")
    scale = float(scale) if scale is not None else float(hd) ** -0.5

    return _oracle(q, cache, phys, logical, valid, group, scale, qlen)
