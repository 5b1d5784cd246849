"""Serving runtime for the sparse transformer: prefill + block-KV decode.

The reference framework has no serving path at all (SURVEY.md §1: "no
scheduler, no runtime, no CLI, no serving path"); its attention modules
always run full sequences. This module adds the generation loop on top
of the decode op family (``ops/decode.py``):

  * ``SparseDecoder`` — a functional runtime bound to a trained
    ``SparseTransformer``'s parameters. ``prefill`` runs the prompt
    through the model's fast fused-flash path while bulk-writing every
    layer's K/V into block caches; ``decode_step`` advances one token per
    sequence through sparse decode attention over the block cache.
  * Attention during decode follows the serving mask families: full
    causal (``window=None``) or attention-sinks + sliding window — the
    block table is computed on device from the cache lengths
    (``ops/decode.decode_block_table``), so the whole decode step jits
    into a single static-shape program.

Everything is functional: caches are pytrees threaded through jit-able
steps, so a generation loop is a ``lax.scan`` / Python loop over
``decode_step`` with no mutable state.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import batched_panel as bp
from ..ops.decode import (
    KVCache,
    QPAD,
    append_kv,
    append_kv_seq,
    decode_attention,
    decode_block_table,
    init_kv_cache,
    prefill_kv,
)
from ..ops.fused_attention import fused_sparse_attention
from .module import layernorm as _layernorm
from .transformer import SparseTransformer

__all__ = ["SparseDecoder"]


def _dense(p, x):
    """``Dense`` apply: ``x @ kernel + bias``."""
    return x @ p["kernel"] + p["bias"]


class SparseDecoder:
    """Generation runtime over a ``SparseTransformer``'s parameters.

    Args:
      model: the ``SparseTransformer`` (its mask topology drives prefill
        attention; decode attention follows ``window``/``sinks``).
      s_max: cache capacity (tokens per sequence); rounded up to ``bk``.
      bk: KV block size (decode attention works block by block; small
        models/tests can use 8+).
      window: sliding-window span in TOKENS for decode attention, or
        ``None`` for full causal coverage of the cache.
      sinks: number of attention-sink BLOCKS kept from position 0
        (only meaningful with a window).
      cache_dtype: ``jnp.bfloat16`` (default), ``jnp.float32``, or
        ``jnp.int8`` (per-token dequant scales, half the decode
        cache bytes).
    """

    def __init__(self, model: SparseTransformer, *, s_max: int,
                 bk: int = 256, window: Optional[int] = None,
                 sinks: int = 0, cache_dtype=jnp.bfloat16):
        if model.hidden_size % model.num_heads:
            raise ValueError("hidden_size must divide num_heads")
        if getattr(model, "moe_every", 0):
            raise ValueError(
                "serving decoders expect dense-MLP layers; MoE-interleaved "
                "models (moe_every > 0) are a training-side feature")
        self.model = model
        self.bk = bk
        self.s_max = ((s_max + bk - 1) // bk) * bk
        self.nb = self.s_max // bk
        if window is None:
            self.window_blocks = self.nb
            self.sink_blocks = 0
        else:
            # window rows may straddle a block boundary -> +1 block
            self.window_blocks = min(-(-window // bk) + 1, self.nb)
            self.sink_blocks = min(sinks, self.nb)
        self.cache_dtype = cache_dtype
        self.hd = model.hidden_size // model.num_heads
        # GQA: cache only the KV heads; decode attention maps each group
        # of `group` query heads onto its shared KV replica.
        self.kv_heads = model.num_kv_heads or model.num_heads
        if model.num_heads % self.kv_heads:
            raise ValueError(
                f"num_kv_heads {self.kv_heads} must divide "
                f"num_heads {model.num_heads}")
        self.group = model.num_heads // self.kv_heads
        # Build + device-place the prefill spec NOW (outside any trace):
        # warm_flash_meta is a no-op under a trace, and a first build
        # inside jax.jit(prefill) would bake the topology metadata into
        # the compile payload as HLO literals.
        self._prefill_spec(model.mask_topology.m)

    # -- params ------------------------------------------------------------

    @staticmethod
    def cast_params(params, dtype=jnp.bfloat16):
        """Cast parameters for serving (bf16 halves the per-token weight
        traffic, usually the dominant decode bytes). LayerNorm scales/
        biases stay f32 for stability; matmuls read bf16 weights and
        accumulate f32 (x f32 @ W bf16 promotes to f32)."""

        def cast(path, p):
            names = [getattr(k, "key", str(k)) for k in path]
            if any(n.startswith("ln_") for n in names):
                return p
            return p.astype(dtype) if hasattr(p, "astype") else p

        return jax.tree_util.tree_map_with_path(cast, params)

    # -- cache management --------------------------------------------------

    def init_caches(self, batch: int) -> Tuple[KVCache, ...]:
        """One empty block cache per layer; replicas = batch * KV heads
        (GQA models cache ``num_heads / num_kv_heads`` times less)."""
        R_kv = batch * self.kv_heads
        return tuple(
            init_kv_cache(R_kv, self.s_max, self.hd, dtype=self.cache_dtype)
            for _ in range(self.model.num_layers))

    # -- shared layer math (mirrors SparseTransformer.__call__) -------------

    def _qkv(self, lp, x):
        """[b, s, h] -> q [b, s, heads, hd], k/v [b, s, kv_heads, hd]
        (mirrors the model's fused QKV projection + split —
        head-interleaved for MHA, flat q|k|v blocks for GQA)."""
        b, s, _ = x.shape
        heads, kv, hd = self.model.num_heads, self.kv_heads, self.hd
        qkv = _dense(lp["self_attention"]["query_key_value"], x)
        if kv == heads:
            qkv = qkv.reshape(b, s, heads, 3 * hd)
            return jnp.split(qkv, 3, axis=-1)
        q = qkv[..., : heads * hd].reshape(b, s, heads, hd)
        k = qkv[..., heads * hd: (heads + kv) * hd].reshape(b, s, kv, hd)
        v = qkv[..., (heads + kv) * hd:].reshape(b, s, kv, hd)
        return q, k, v

    def _fold(self, x):
        b, s, h, hd = x.shape
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(b * h, s, hd)

    def _mlp(self, lp, x):
        m = self.model
        y = _dense(lp["mlp"]["to_4h"], x)
        if m.activation == "gelu":
            y = jax.nn.gelu(y)
        elif m.activation == "relu":
            y = jax.nn.relu(y)
        return _dense(lp["mlp"]["to_h"], y)

    def _block(self, lp, x, attn_fn, reduce_fn=None):
        """One transformer layer around a supplied attention body.

        ``reduce_fn`` (tensor parallelism): applied to the attention
        output projection and the MLP down projection — the two
        row-sharded matmuls whose partial sums must be ``psum``-reduced
        across the tp axis (``parallel/serving_tp.TPDecoder`` passes
        ``lax.psum``; their biases are pre-divided by tp at shard time
        so the reduction adds them back exactly once)."""
        m = self.model

        def maybe_ln(y, name):
            return _layernorm(lp[name], y) if m.use_layernorm else y

        attn_in = maybe_ln(x, "ln_attn")
        q, k, v = self._qkv(lp, attn_in)
        ctx = attn_fn(q, k, v)
        attn = _dense(lp["self_attention"]["dense"], ctx)
        if reduce_fn is not None:
            attn = reduce_fn(attn)
        x = x + attn if m.use_residual else attn
        mlp = self._mlp(lp, maybe_ln(x, "ln_mlp"))
        if reduce_fn is not None:
            mlp = reduce_fn(mlp)
        return (x + mlp if m.use_residual else mlp), (k, v)

    def _layer_params(self, params, i):
        p = params.get("params", params)
        return p[f"layer_{i}"]

    # -- prefill -------------------------------------------------------------

    def _prefill_spec(self, T: int) -> "bp.BatchedPanelSpec":
        """Batched panel spec for the prompt pass — the model's own
        ``cached_batched_spec`` cache and ``flash_tiles`` defaults (one
        source of truth with the training attention), warmed
        forward-only (prefill never differentiates). A fresh spec per
        trace would bake its numpy metadata into the jitted prefill as
        HLO literals (the compile-payload gotcha)."""
        from ..ops.fused_attention import warm_flash_meta
        from .transformer import cached_batched_spec, flash_tiles

        if self.model.attention_layout == "panel" or T < 16:
            bm = bk = 128
        else:
            bm, bk = flash_tiles(T, self.hd)
        spec = cached_batched_spec(self.model.mask_topology,
                                   self.model.num_heads, bm, bk)
        warm_flash_meta(spec, backward=False)
        return spec

    def _prefill_setup(self, caches, T: int):
        """Hook: cache-family-specific validation/allocation before the
        prompt pass (paged: page reservation)."""
        return caches

    def _prefill_write(self, cache, k3, v3, len_r):
        """Hook: bulk-write one layer's folded ``[R_kv, T, hd]`` K/V into
        its cache (paged decoders write pool pages instead)."""
        return prefill_kv(cache, k3, v3, lengths=len_r)

    def prefill(self, params, x, caches: Sequence[KVCache],
                reduce_fn=None, lengths=None):
        """Run the prompt ``x [b, T, h]`` through the model (fused-flash
        attention on the model's own mask topology) and bulk-write every
        layer's K/V into ``caches``. Returns ``(y [b, T, h], caches)``.

        ``lengths`` (i32 ``[b]``, optional): per-sequence prompt lengths
        for a VARIABLE-length batch padded to ``T`` on the right. With a
        causal mask, rows ``< lengths[s]`` never attend pad positions,
        so their activations are exact; pad rows produce garbage the
        caller ignores (read each sequence's output at
        ``lengths[s] - 1``). Cache ``kv_len`` is set per replica, so
        decoding continues through ``decode_step_ragged`` (or
        ``decode_step`` once lengths have been equalised)."""
        m = self.model
        mt = m.mask_topology
        b, T, _ = x.shape
        if T != mt.m:
            raise ValueError(f"prompt length {T} != mask rows {mt.m}")
        caches = self._prefill_setup(caches, T)
        len_r = None if lengths is None else jnp.repeat(
            jnp.asarray(lengths, jnp.int32), self.kv_heads)
        scale = 1.0 / float(np.sqrt(self.hd))
        core = self._prefill_spec(T)

        new_caches = []
        for i in range(m.num_layers):
            lp = self._layer_params(params, i)

            def attn(q, k, v):
                if self.group > 1:   # GQA: prefill attends at full heads
                    k = jnp.repeat(k, self.group, axis=2)
                    v = jnp.repeat(v, self.group, axis=2)
                q3, k3, v3 = self._fold(q), self._fold(k), self._fold(v)
                if m.attention_layout == "panel" or T < 16:
                    s_ = bp.sddmm_bh(core, q3, k3) * scale
                    w = bp.sparse_softmax_bh(core, s_)
                    ctx = bp.spmm_bh(core, w, v3)
                else:
                    ctx = fused_sparse_attention(core, q3, k3, v3,
                                                 scale=scale)
                ctx = ctx.reshape(b, m.num_heads, T, self.hd)
                return jnp.transpose(ctx, (0, 2, 1, 3)).reshape(
                    b, T, m.num_heads * self.hd)

            x, (k, v) = self._block(lp, x, attn, reduce_fn=reduce_fn)
            new_caches.append(
                self._prefill_write(caches[i], self._fold(k),
                                    self._fold(v), len_r))
        return x, tuple(new_caches)

    # -- decode --------------------------------------------------------------

    def _decode_layers(self, params, x, caches, append_fn, tbl, valid,
                       qlen, reduce_fn):
        """The shared decode layer loop: per layer, append this step's
        K/V to the layer cache (``append_fn(cache, k3, v3) -> cache``,
        where ``k3``/``v3`` are folded ``[R_kv, qlen, hd]``) and attend
        over the step-shared block table. The three public steps
        (uniform / ragged / speculative) differ only in ``append_fn``
        and ``qlen``."""
        m = self.model
        b = x.shape[0]
        scale = 1.0 / float(np.sqrt(self.hd))

        new_caches = []
        for i in range(m.num_layers):
            lp = self._layer_params(params, i)
            cache = caches[i]

            def attn(q, k, v):
                nonlocal cache
                cache = append_fn(cache, self._fold(k), self._fold(v))
                ctx = decode_attention(
                    self._fold(q), cache, tbl, valid,
                    bk=self.bk, qlen=qlen, group=self.group,
                    scale=scale)                        # [R, qlen, hd]
                ctx = ctx.reshape(b, m.num_heads, qlen, self.hd)
                return jnp.transpose(ctx, (0, 2, 1, 3)).reshape(
                    b, qlen, m.num_heads * self.hd)

            x, _ = self._block(lp, x, attn, reduce_fn=reduce_fn)
            new_caches.append(cache)
        return x, tuple(new_caches)

    def decode_step(self, params, x_tok, caches: Sequence[KVCache],
                    reduce_fn=None):
        """Advance one token: ``x_tok [b, 1, h]`` -> ``(y [b, 1, h],
        caches)``. Appends each layer's K/V, then attends over the block
        table (sinks + window, or the full causal history).

        The serving loop keeps every sequence at the same length, so the
        cache write position is ONE scalar: ``append_kv(..., pos=pos)``
        is a single aliasable ``dynamic_update_slice`` (cheaper than the
        per-slot ragged write — see ``append_kv``), and the block
        table is computed once per step, not per layer (``kv_len`` is
        identical across layers). At capacity the write is a guarded
        no-op (``kv_len`` pins at ``s_max``)."""
        # Shared across layers: scalar write position and the post-append
        # block table (every layer's cache has the same lengths). The
        # table length CLAMPS at s_max: past capacity the append is a
        # guarded no-op, and an unclamped kv_len + 1 would mark an
        # out-of-range block valid (it clamps onto the last block —
        # double-counted — while block 0 falls out of the window;
        # measured 0.127 output error at capacity).
        pos = caches[0].kv_len[0]
        tbl, valid = decode_block_table(
            jnp.minimum(caches[0].kv_len + 1, self.s_max),
            s_max=self.s_max, bk=self.bk,
            window_blocks=self.window_blocks,
            sink_blocks=self.sink_blocks)

        def append(cache, k3, v3):
            return append_kv(cache, k3[:, 0], v3[:, 0], pos=pos)

        return self._decode_layers(params, x_tok, caches, append,
                                   tbl, valid, 1, reduce_fn)

    def decode_step_ragged(self, params, x_tok, caches: Sequence[KVCache],
                           active=None, reduce_fn=None):
        """One token per sequence with PER-SEQUENCE cache lengths — the
        continuous-batching step. ``x_tok [b, 1, h]`` -> ``(y [b, 1, h],
        caches)``.

        Unlike ``decode_step`` (uniform lengths, one scalar write
        position), each slot appends at its own ``kv_len`` and attends
        its own block table, so sequences admitted at different times
        (``ops.decode.insert_kv_slot``) batch together. ``active``
        (bool ``[b]``, optional) freezes finished slots: their token is
        still computed (static shapes) but NOT written — the frozen
        slot's cache and ``kv_len`` are untouched by construction
        (``append_kv``'s write-enable mask).

        The per-slot write is a guarded ``vmap(dynamic_update_slice)``
        (``append_kv`` with per-slot positions).

        Capacity is enforced: a slot at ``kv_len == s_max`` keeps its
        cache bit-identical and its length pinned (no clamped-write
        corruption) — but it also gains no new context, so its outputs
        stop being meaningful. Evict or rotate full slots
        (``insert_kv_slot``)."""
        act_r = None
        if active is not None:
            act_r = jnp.repeat(jnp.asarray(active).astype(jnp.int32),
                               self.kv_heads)
        adv = act_r if act_r is not None else 1
        kv_len1 = jnp.minimum(caches[0].kv_len + adv, self.s_max)
        tbl, valid = decode_block_table(
            kv_len1, s_max=self.s_max, bk=self.bk,
            window_blocks=self.window_blocks,
            sink_blocks=self.sink_blocks)

        def append(cache, k3, v3):
            return append_kv(cache, k3[:, 0], v3[:, 0], active=act_r)

        return self._decode_layers(params, x_tok, caches, append,
                                   tbl, valid, 1, reduce_fn)

    def decode_multi(self, params, x_toks, caches: Sequence[KVCache],
                     reduce_fn=None):
        """Speculative-decode verification step: advance ``q <= 8`` draft
        tokens at once. ``x_toks [b, q, h]`` -> ``(y [b, q, h], caches)``.

        Teacher-forced on the draft's tokens, this equals ``q``
        sequential ``decode_step`` calls on the same inputs — but runs
        ONE attention pass per layer (decode attention's
        ``qlen > 1`` mode masks each query row causally against its own
        cache position) and ONE bulk cache write (``append_kv_seq``). A
        speculative loop scores the draft, accepts the longest matching
        prefix, and rolls ``kv_len`` back for rejected tokens (the cache
        past ``kv_len`` is never read, so rollback is just a smaller
        length — no data movement).

        With a sliding window, rows earlier than the last draft token
        may see up to ``q - 1`` extra trailing tokens of window (the
        block table is sized for the final position); sinks and
        causality are exact.

        Capacity: if the ``q`` draft tokens don't fit below ``s_max``,
        ``append_kv_seq`` writes nothing (all-or-nothing) and ``kv_len``
        does not advance — THE caller-visible rejection signal (compare
        ``caches[0].kv_len`` before/after, or size ``s_max`` for the
        worst-case draft up front). The outputs of a rejected step are
        meaningless; the block table below clamps so the attention at
        least reads in-range blocks."""
        qn = x_toks.shape[1]
        if qn > QPAD:
            raise ValueError(f"q {qn} > QPAD {QPAD}")

        pos = caches[0].kv_len[0]
        tbl, valid = decode_block_table(
            jnp.minimum(caches[0].kv_len + qn, self.s_max),
            s_max=self.s_max, bk=self.bk,
            window_blocks=self.window_blocks,
            sink_blocks=self.sink_blocks)

        def append(cache, k3, v3):
            return append_kv_seq(cache, k3, v3, pos)

        return self._decode_layers(params, x_toks, caches, append,
                                   tbl, valid, qn, reduce_fn)

    @staticmethod
    def rollback(caches: Sequence[KVCache], n: int) -> Tuple[KVCache, ...]:
        """Reject the last ``n`` speculative tokens: shrink ``kv_len``
        (positions past ``kv_len`` are never read — no data movement)."""
        return tuple(
            KVCache(k=c.k, v=c.v, kv_len=c.kv_len - n,
                    k_scale=c.k_scale, v_scale=c.v_scale)
            for c in caches)

    def decode_loop(self, params, x_tok, caches: Sequence[KVCache],
                    n_tokens: int, next_input=None, reduce_fn=None):
        """Decode ``n_tokens`` inside ONE jit via ``lax.scan`` — the
        production loop shape (no per-step Python dispatch).

        ``next_input(y) -> x`` maps a step's output activation to the next
        input (identity by default; a real deployment puts its
        logits->embedding sampling here). Returns ``(ys [n_tokens, b, 1,
        h], caches)``."""
        nxt = next_input or (lambda y: y)

        def body(carry, _):
            x, caches = carry
            y, caches = self.decode_step(params, x, caches,
                                         reduce_fn=reduce_fn)
            return (nxt(y), caches), y

        (_, caches), ys = jax.lax.scan(
            body, (x_tok, tuple(caches)), None, length=n_tokens)
        return ys, caches
