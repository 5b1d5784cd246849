"""Decode/serving path: sparse single-query attention over a block KV cache.

The reference framework stops at prefill (its attention modules run full
sequences; SURVEY.md §1 notes it has "no serving path"). This module adds
the decode family:

  * ``KVCache`` — a functional (pytree) per-replica KV cache, fp32/bf16 or
    int8 with per-token dequant scales (the persistent int8 layout flagged
    as the serving follow-up in round 1).
  * ``append_kv`` — one-token cache append (vmapped dynamic_update_slice;
    quantizes on write for int8 caches).
  * ``decode_block_table`` — on-device (jit-traceable) attention-sinks +
    local-window block table from the current ``kv_len``; and
    ``table_from_topology_row`` for arbitrary ``SparseTopology`` rows.
  * ``decode_attention`` — masked attention over the tabled blocks,
    supporting GQA groups and ``qlen > 1`` speculative verification.

Decode is memory-bandwidth-bound; its speed of light is the tabled KV
bytes / bandwidth, and the int8 cache halves those bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ._common import round_up

# most query rows one decode_attention call takes (qlen > 1 is
# speculative verification)
QPAD = 8

__all__ = [
    "KVCache", "init_kv_cache", "append_kv", "append_kv_seq",
    "prefill_kv", "insert_kv_slot", "decode_block_table",
    "table_from_topology_row", "decode_attention",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KVCache:
    """Per-replica KV cache. ``k``/``v``: ``[R_kv, s_max, hd_pad]``;
    ``kv_len``: ``i32[R_kv]`` tokens written so far; int8 caches carry
    per-token dequant scales ``[R_kv, s_max]`` (fp caches hold ones)."""

    k: jax.Array
    v: jax.Array
    kv_len: jax.Array
    k_scale: jax.Array
    v_scale: jax.Array

    @property
    def is_int8(self) -> bool:
        return self.k.dtype == jnp.int8

    @property
    def s_max(self) -> int:
        return self.k.shape[1]


def init_kv_cache(R_kv: int, s_max: int, hd: int,
                  dtype=jnp.bfloat16) -> KVCache:
    """Empty cache; ``s_max`` is rounded up to the block size at use; ``hd``
    is padded to the 128-lane minor dim."""
    hd_pad = round_up(max(hd, 1), 128)
    shape = (R_kv, s_max, hd_pad)
    return KVCache(
        k=jnp.zeros(shape, dtype),
        v=jnp.zeros(shape, dtype),
        kv_len=jnp.zeros((R_kv,), jnp.int32),
        k_scale=jnp.ones((R_kv, s_max), jnp.float32),
        v_scale=jnp.ones((R_kv, s_max), jnp.float32),
    )


def _quantize_token(x):
    """f32[hd] -> (int8[hd], scale). Symmetric per-token scale."""
    scale = jnp.maximum(jnp.max(jnp.abs(x)), 1e-30) / 127.0
    q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return q, scale


def pad_quantize_tokens(k_new, v_new, hd_pad: int, dtype):
    """``(..., hd)`` K/V tokens -> padded ``(..., hd_pad)`` in the cache
    ``dtype`` plus per-token scales ``(...,)`` (ones for fp caches).

    The SINGLE source of the cache write convention (zero-padding +
    symmetric per-token int8 quantization) shared by the contiguous and
    paged append/prefill paths — a drifted copy would make the two cache
    families silently disagree numerically."""

    def pad(x):
        out = jnp.zeros(x.shape[:-1] + (hd_pad,), jnp.float32)
        return out.at[..., : x.shape[-1]].set(x.astype(jnp.float32))

    kp, vp = pad(k_new), pad(v_new)
    if dtype == jnp.int8:
        qf = _quantize_token
        for _ in range(kp.ndim - 1):
            qf = jax.vmap(qf)
        kq, ks = qf(kp)
        vq, vs = qf(vp)
    else:
        kq, vq = kp.astype(dtype), vp.astype(dtype)
        ks = vs = jnp.ones(kp.shape[:-1], jnp.float32)
    return kq, vq, ks, vs


def append_kv(cache: KVCache, k_new, v_new, pos=None,
              active=None) -> KVCache:
    """Append one token per replica. ``k_new``/``v_new``: ``[R_kv, hd]``
    (hd <= hd_pad; padded with zeros). Functional: returns a new cache.

    ``pos``: optional scalar i32 write position shared by ALL replicas
    (the common serving case — every sequence in the batch is at the same
    length). With ``pos`` the update is ONE scalar-indexed
    ``dynamic_update_slice`` that XLA aliases in place inside a decode
    scan. Without it, each replica writes at its own ``kv_len`` through a
    guarded ``vmap(dynamic_update_slice)`` (a Hopper ragged-append kernel
    is listed in ROADMAP.md).

    ``active`` (ragged path only): optional per-replica i32/bool ``[R_kv]``
    write-enable — frozen continuous-batching slots neither write nor
    advance ``kv_len``.

    Capacity is ENFORCED on every path: a replica at ``kv_len == s_max``
    (or a shared ``pos == s_max``) keeps its cache bit-identical and its
    length pinned at ``s_max`` — a full slot's last real token can never
    be overwritten by the clamped write position.
    """
    R, s_max, hd_pad = cache.k.shape
    kq, vq, ks, vs = pad_quantize_tokens(k_new, v_new, hd_pad,
                                         cache.k.dtype)

    if pos is not None:
        if active is not None:
            raise ValueError("active mask requires the ragged path "
                             "(pos=None); a uniform batch freezes no slots")
        z = jnp.int32(0)
        p_raw = jnp.asarray(pos, jnp.int32)
        p = jnp.minimum(p_raw, s_max - 1)
        fits = p_raw < s_max

        def guard(tok, buf, width):
            # at capacity: write the existing contents back (net no-op);
            # a [R, 1, hd_pad] read is noise next to the step's traffic
            old = jax.lax.dynamic_slice(
                buf, (z, p) + (z,) * (buf.ndim - 2), (R, 1) + width)
            return jnp.where(fits, tok, old.astype(tok.dtype))

        kq_w = guard(kq[:, None], cache.k, (hd_pad,))
        vq_w = guard(vq[:, None], cache.v, (hd_pad,))
        ks_w = guard(ks[:, None], cache.k_scale, ())
        vs_w = guard(vs[:, None], cache.v_scale, ())
        return KVCache(
            k=jax.lax.dynamic_update_slice(cache.k, kq_w, (z, p, z)),
            v=jax.lax.dynamic_update_slice(cache.v, vq_w, (z, p, z)),
            kv_len=jnp.minimum(cache.kv_len + 1, s_max),
            k_scale=jax.lax.dynamic_update_slice(
                cache.k_scale, ks_w, (z, p)),
            v_scale=jax.lax.dynamic_update_slice(
                cache.v_scale, vs_w, (z, p)),
        )

    ok = (jnp.ones((R,), jnp.int32) if active is None
          else jnp.asarray(active).astype(jnp.int32))
    adv = ok * (cache.kv_len < s_max).astype(jnp.int32)
    new_len = cache.kv_len + adv

    def upd(buf, tok, ln, okr):
        p = jnp.minimum(ln, s_max - 1)
        old = jax.lax.dynamic_slice(buf, (p, jnp.int32(0)), (1, hd_pad))
        tok = jnp.where((ln < s_max) & (okr == 1), tok[None],
                        old.astype(tok.dtype))
        return jax.lax.dynamic_update_slice(buf, tok, (p, jnp.int32(0)))

    def upd_s(buf, sc, ln, okr):
        p = jnp.minimum(ln, s_max - 1)
        old = jax.lax.dynamic_slice(buf, (p,), (1,))
        sc = jnp.where((ln < s_max) & (okr == 1), sc[None], old)
        return jax.lax.dynamic_update_slice(buf, sc, (p,))

    return KVCache(
        k=jax.vmap(upd)(cache.k, kq, cache.kv_len, ok),
        v=jax.vmap(upd)(cache.v, vq, cache.kv_len, ok),
        kv_len=new_len,
        k_scale=jax.vmap(upd_s)(cache.k_scale, ks, cache.kv_len, ok),
        v_scale=jax.vmap(upd_s)(cache.v_scale, vs, cache.kv_len, ok),
    )


def append_kv_seq(cache: KVCache, k_new, v_new, pos) -> KVCache:
    """Append ``q`` tokens per replica at the shared scalar position
    ``pos`` (speculative decode: the draft's q tokens land in the cache
    in ONE aliasable ``dynamic_update_slice``). ``k_new``/``v_new``:
    ``[R_kv, q, hd]`` (hd <= hd_pad). Capacity-guarded like ``append_kv``:
    if the q tokens don't all fit below ``s_max`` the cache stays
    bit-identical and ``kv_len`` does not advance (all-or-nothing — a
    partial draft write would desync rollback)."""
    R, s_max, hd_pad = cache.k.shape
    q = k_new.shape[1]
    kq, vq, ks, vs = pad_quantize_tokens(k_new, v_new, hd_pad,
                                         cache.k.dtype)

    z = jnp.int32(0)
    p_raw = jnp.asarray(pos, jnp.int32)
    p = jnp.minimum(p_raw, s_max - q)
    fits = p_raw <= s_max - q

    def guard(tok, buf):
        old = jax.lax.dynamic_slice(
            buf, (z, p) + (z,) * (buf.ndim - 2), (R, q) + buf.shape[2:])
        return jnp.where(fits, tok, old.astype(tok.dtype))

    return KVCache(
        k=jax.lax.dynamic_update_slice(cache.k, guard(kq, cache.k),
                                       (z, p, z)),
        v=jax.lax.dynamic_update_slice(cache.v, guard(vq, cache.v),
                                       (z, p, z)),
        kv_len=jnp.where(fits, cache.kv_len + q, cache.kv_len),
        k_scale=jax.lax.dynamic_update_slice(
            cache.k_scale, guard(ks, cache.k_scale), (z, p)),
        v_scale=jax.lax.dynamic_update_slice(
            cache.v_scale, guard(vs, cache.v_scale), (z, p)),
    )


def prefill_kv(cache: KVCache, k_seq, v_seq, lengths=None) -> KVCache:
    """Bulk-write a prompt into an (empty) cache.

    ``k_seq``/``v_seq``: ``[R_kv, T, hd]``; ``lengths``: ``i32[R_kv]``
    valid tokens per replica (default: all ``T``). Writes from position 0 —
    the prefill step of a serving loop (per-token ``append_kv`` is the
    decode step)."""
    R, s_max, hd_pad = cache.k.shape
    T = k_seq.shape[1]
    if lengths is None:
        lengths = jnp.full((R,), T, jnp.int32)
    # zero pad tokens BEFORE quantizing (their scales become the floor)
    mask = (jnp.arange(T)[None, :] < lengths[:, None])[..., None]
    k_seq = jnp.where(mask, k_seq.astype(jnp.float32), 0.0)
    v_seq = jnp.where(mask, v_seq.astype(jnp.float32), 0.0)
    kq, vq, ks, vs = pad_quantize_tokens(k_seq, v_seq, hd_pad,
                                         cache.k.dtype)

    return KVCache(
        k=cache.k.at[:, :T].set(kq),
        v=cache.v.at[:, :T].set(vq),
        kv_len=lengths.astype(jnp.int32),
        k_scale=cache.k_scale.at[:, :T].set(ks),
        v_scale=cache.v_scale.at[:, :T].set(vs),
    )


def insert_kv_slot(cache: KVCache, src: KVCache, slot, *,
                   kv_heads: int) -> KVCache:
    """Admit a sequence into batch slot ``slot`` (continuous batching).

    Overwrites the ``kv_heads`` cache replicas of slot ``slot`` (rows
    ``slot*kv_heads : (slot+1)*kv_heads``) with ``src``'s — a
    single-sequence cache produced by a ``batch=1`` prefill. ``slot``
    may be a traced scalar: the copy is one ``dynamic_update_slice``
    per buffer, so admission jits into the serving loop. ``src`` may
    have a smaller ``s_max`` (its tokens land at positions
    ``[0, src.s_max)``; the slot's stale tail past that is never read
    because ``kv_len`` is overwritten too). Cache dtype and head dim
    must match."""
    if src.k.dtype != cache.k.dtype:
        raise ValueError(
            f"src cache dtype {src.k.dtype} != {cache.k.dtype}")
    if src.k.shape[-1] != cache.k.shape[-1]:
        raise ValueError(
            f"src hd_pad {src.k.shape[-1]} != {cache.k.shape[-1]}")
    if src.k.shape[0] != kv_heads:
        raise ValueError(
            f"src has {src.k.shape[0]} replicas, expected kv_heads "
            f"{kv_heads}")
    if src.s_max > cache.s_max:
        raise ValueError(
            f"src s_max {src.s_max} > cache s_max {cache.s_max}")
    n_slots = cache.k.shape[0] // kv_heads
    if isinstance(slot, (int, np.integer)) and not 0 <= slot < n_slots:
        # traced slots can't be checked here; a concrete out-of-range
        # slot would otherwise CLAMP in dynamic_update_slice and
        # silently overwrite a neighboring sequence's cache
        raise ValueError(f"slot {slot} out of range [0, {n_slots})")
    z = jnp.int32(0)
    r0 = jnp.asarray(slot, jnp.int32) * kv_heads
    return KVCache(
        k=jax.lax.dynamic_update_slice(cache.k, src.k, (r0, z, z)),
        v=jax.lax.dynamic_update_slice(cache.v, src.v, (r0, z, z)),
        kv_len=jax.lax.dynamic_update_slice(
            cache.kv_len, src.kv_len.astype(jnp.int32), (r0,)),
        k_scale=jax.lax.dynamic_update_slice(
            cache.k_scale, src.k_scale, (r0, z)),
        v_scale=jax.lax.dynamic_update_slice(
            cache.v_scale, src.v_scale, (r0, z)),
    )


def decode_block_table(kv_len, *, s_max: int, bk: int,
                       window_blocks: int, sink_blocks: int = 1):
    """Attention-sinks + local-window block table, computed on device.

    Returns ``(tbl i32[R, S], valid i32[R, S])`` with
    ``S = sink_blocks + window_blocks`` (static). Window blocks that fall
    inside the sink range (or before block 0) are invalidated and clamped
    to the previous slot's id so their DMA is elided by the pipeline.

    The window is BLOCK-granular (standard sliding-window-attention
    practice): the last ``window_blocks`` whole ``bk``-token blocks are
    attended, i.e. between ``window`` and ``window + bk - 1`` keys — NOT
    an element-exact ``j > i - window`` cut. Greedy decodes therefore
    match a banded-mask full forward block-wise, not token-exactly; an
    element-exact banded structure trains/prefills through the flash
    topologies instead.
    """
    nb = s_max // bk
    last = jnp.maximum((kv_len - 1) // bk, 0)                # [R]
    sink = jnp.arange(sink_blocks, dtype=jnp.int32)          # [Ss]
    win = jnp.arange(window_blocks, dtype=jnp.int32)
    win = last[:, None] - (window_blocks - 1) + win[None, :]  # [R, Sw]

    sink_t = jnp.broadcast_to(sink[None, :], (kv_len.shape[0], sink_blocks))
    sink_ok = (sink_t <= last[:, None]) & (kv_len[:, None] > 0)
    win_ok = (win >= sink_blocks) & (win <= last[:, None]) & (
        kv_len[:, None] > 0)

    tbl = jnp.concatenate([sink_t, jnp.clip(win, 0, nb - 1)], axis=1)
    valid = jnp.concatenate([sink_ok, win_ok], axis=1).astype(jnp.int32)
    # clamp invalid slots to the running previous valid id -> DMA elided
    def last_valid(a, b):
        return (jnp.where(b[1] == 1, b[0], a[0]),
                jnp.maximum(a[1], b[1]))

    prev = jax.lax.associative_scan(last_valid, (tbl, valid), axis=1)[0]
    return jnp.where(valid == 1, tbl, prev).astype(jnp.int32), valid


def table_from_topology_row(topo, row: int, bk: int):
    """Static block table from one row of a ``SparseTopology`` (numpy).

    The set of ``bk``-sized KV blocks touched by the row's column indices —
    the decode analogue of the prefill mask's last row."""
    lo, hi = int(topo.row_offsets[row]), int(topo.row_offsets[row + 1])
    cols = np.asarray(topo.column_indices[lo:hi])
    blocks = np.unique(cols // bk).astype(np.int32)
    if blocks.size == 0:
        blocks = np.zeros((1,), np.int32)
        return blocks, np.zeros((1,), np.int32)
    return blocks, np.ones_like(blocks)


def _oracle(q, cache, tbl, valid, bk, qlen, group, scale):
    """Dense jnp reference: each query replica attends to its tabled
    blocks of its KV replica, causally up to its cache position."""
    R = q.shape[0]
    s_max = cache.k.shape[1]
    kf = cache.k.astype(jnp.float32) * cache.k_scale[..., None]
    vf = cache.v.astype(jnp.float32) * cache.v_scale[..., None]

    hd = q.shape[-1]
    pos = jnp.arange(s_max)

    def one(r):
        rk = r // group
        sc = (q[r, :qlen].astype(jnp.float32) * scale) @ kf[
            rk, :, :hd].T                                          # [qlen,s]
        qpos = cache.kv_len[rk] - qlen + jnp.arange(qlen)
        allow = jnp.any((pos[None, :] // bk == tbl[r][:, None])
                        & (valid[r][:, None] == 1), axis=0)
        m = allow[None, :] & (pos[None, :] <= qpos[:, None])
        sc = jnp.where(m, sc, -1e30)
        w = jax.nn.softmax(sc, axis=-1)
        w = jnp.where(m, w, 0.0)
        return w @ vf[rk, :, :hd]

    return jax.vmap(one)(jnp.arange(R))


def decode_attention(q, cache: KVCache, tbl, valid, *,
                     bk: int = 256, qlen: int = 1, group: int = 1,
                     scale: Optional[float] = None):
    """Sparse decode attention: ``q [R, qlen, hd]`` against the tabled KV
    blocks. Returns ``f32[R, qlen, hd]``.

    ``tbl``/``valid``: ``i32[R, S]`` per QUERY replica, or ``[R_kv, S]``
    per KV replica (the shape ``decode_block_table`` produces from a
    grouped cache's ``kv_len``) — the latter is expanded here so each
    query group reads its shared KV replica's table. ``group``: query
    replicas per KV replica (GQA). ``qlen > 1``: speculative
    verification — queries are the last ``qlen`` cache positions,
    causally masked.
    """
    R, qn, hd = q.shape
    if qn != qlen:
        raise ValueError(f"q has qlen {qn}, expected {qlen}")
    if qlen > QPAD:
        raise ValueError(f"qlen > {QPAD} not supported (got {qlen})")
    if cache.s_max % bk:
        raise ValueError(f"s_max {cache.s_max} not a multiple of bk {bk}")
    if R != cache.k.shape[0] * group:
        raise ValueError(
            f"R {R} != R_kv {cache.k.shape[0]} * group {group}")
    if group > 1 and tbl.shape[0] == cache.k.shape[0]:
        # per-KV tables -> per-query (the attention indexes tables by
        # query replica; an un-expanded table would read out of range
        # for r >= R_kv)
        tbl = jnp.repeat(tbl, group, axis=0)
        valid = jnp.repeat(valid, group, axis=0)
    if tbl.shape[0] != R or valid.shape[0] != R:
        raise ValueError(
            f"tbl/valid rows {tbl.shape[0]}/{valid.shape[0]} != R {R} "
            f"(or R_kv {cache.k.shape[0]})")
    scale = float(scale) if scale is not None else float(hd) ** -0.5
    out = _oracle(q, cache, tbl, valid, bk, qlen, group, scale)
    return out[:, :, :hd]
