"""Tensor-parallel serving: the SparseDecoder sharded over a ``tp`` axis.

The reference has no serving path and no parallelism (SURVEY.md §1/§2);
this module composes both of this framework's additions: the block-KV
``SparseDecoder`` runtime (``models/serving.py``) partitioned
Megatron-style over a device mesh axis —

  * QKV projection column-sharded by head groups: each device projects
    and attends its own ``heads/tp`` query heads (``kv_heads/tp`` KV
    heads under GQA) against its own slice of the KV cache. Attention is
    embarrassingly parallel across heads, so the decode kernel runs
    unchanged on local replicas.
  * attention output projection and MLP down projection row-sharded;
    their partial sums are ``psum``-reduced across the axis (the two
    reduction points per layer — ``SparseDecoder._block(reduce_fn=...)``).
    Row-sharded biases are pre-divided by ``tp`` at shard time so the
    psum adds them back exactly once.
  * MLP up projection column-sharded (``ffn/tp`` per device); the
    activation is elementwise so it rides the sharded columns.
  * LayerNorm parameters are replicated (stacked per shard).

Everything runs inside ONE ``jax.shard_map`` per call, so a decode step
costs exactly 2 ``psum``s per layer over the interconnect; the KV cache
never moves.

Per-shard compute reuses ``SparseDecoder`` itself, constructed over a
"local view" of the model (``heads/tp`` heads, same full hidden size) —
the sharded runtime is the single-chip runtime plus a reduction hook.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.serving import SparseDecoder
from ..models.serving_paged import PagedDecoder
from ..models.transformer import SparseTransformer
from ..ops import paged as pg
from ..ops.decode import KVCache, init_kv_cache

__all__ = ["TPDecoder", "PagedTPDecoder"]


def _np(x):
    return np.asarray(x)


class TPDecoder:
    """Tensor/data-parallel generation runtime.

    Usage::

        mesh = Mesh(np.array(jax.devices()).reshape(tp), ("tp",))
        tpd = TPDecoder(model, mesh, s_max=..., bk=...)
        sparams = tpd.shard_params(params)   # [tp, ...]-stacked slices
        caches = tpd.init_caches(batch)
        y, caches = jax.jit(tpd.prefill)(sparams, x, caches)
        ys, caches = jax.jit(lambda p, t, c:
                             tpd.decode_loop(p, t, c, n))(sparams, tok, c)

    Requires ``num_heads``, ``num_kv_heads`` and ``ffn_hidden_size`` all
    divisible by the axis size.

    ``batch_axis``: a second mesh axis for data-parallel serving — the
    batch (and its KV caches) shards over it, params replicate, and no
    collective crosses it (throughput scales with dp devices). Requires
    every batch element to share the same mask (the shard_map body is
    one SPMD program, so per-batch-distinct topologies cannot ride a
    dp split) and the batch divisible by the axis size.
    """

    def __init__(self, model: SparseTransformer, mesh: Mesh, *,
                 axis: str = "tp", batch_axis: Optional[str] = None,
                 s_max: int, bk: int = 256,
                 window: Optional[int] = None, sinks: int = 0,
                 cache_dtype=jnp.bfloat16):
        tp = mesh.shape[axis]
        heads = model.num_heads
        kv = model.num_kv_heads or heads
        if heads % tp:
            raise ValueError(f"num_heads {heads} not divisible by tp {tp}")
        if kv % tp:
            raise ValueError(f"num_kv_heads {kv} not divisible by tp {tp}")
        if model.ffn_hidden_size % tp:
            raise ValueError(
                f"ffn_hidden_size {model.ffn_hidden_size} not divisible "
                f"by tp {tp}")
        self.mesh, self.axis, self.tp = mesh, axis, tp
        self.batch_axis = batch_axis
        self.dp = mesh.shape[batch_axis] if batch_axis else 1
        self.model = model
        self.heads, self.kv = heads, kv
        self.H_l, self.KV_l = heads // tp, kv // tp
        self.hd = model.hidden_size // heads

        mt = model.mask_topology
        if self.dp > 1:
            if mt.b % self.dp:
                raise ValueError(
                    f"mask batch {mt.b} not divisible by dp {self.dp}")
            t0 = mt.topologies[0]
            for t in mt.topologies[1:]:
                if not (np.array_equal(t.row_offsets, t0.row_offsets) and
                        np.array_equal(t.column_indices[: t.nnz],
                                       t0.column_indices[: t0.nnz])):
                    raise ValueError(
                        "data-parallel serving requires every batch "
                        "element to share the same mask")
            local_mt = type(mt)(mt.topologies[: mt.b // self.dp])
        else:
            local_mt = mt
        # per-shard runtime: the same SparseDecoder over a local view of
        # the model (local heads/batch, full hidden size for
        # residual/LN/MLP)
        local_model = model.clone(
            mask_topology=local_mt,
            hidden_size=self.H_l * self.hd,
            num_heads=self.H_l,
            num_kv_heads=None if self.KV_l == self.H_l else self.KV_l,
            ffn_hidden_size=model.ffn_hidden_size // tp,
        )
        self._ld = self._make_local_decoder(
            local_model, s_max=s_max, bk=bk, window=window, sinks=sinks,
            cache_dtype=cache_dtype)
        self.s_max, self.bk = self._ld.s_max, bk
        self.cache_dtype = cache_dtype

    def _make_local_decoder(self, local_model, **kw) -> SparseDecoder:
        """Hook: the per-shard runtime (``PagedTPDecoder`` substitutes a
        ``PagedDecoder`` — the sharded runtime stays the single-chip
        runtime plus the psum hook)."""
        return SparseDecoder(local_model, **kw)

    @property
    def n_shards(self) -> int:
        return self.dp * self.tp

    # -- parameter sharding --------------------------------------------------

    def shard_params(self, params):
        """Slice the flax parameter tree into per-shard pieces and stack
        them on a leading ``[tp]`` axis (host-side numpy; ``shard_map``
        scatters the leading axis across the mesh)."""
        tp, hd = self.tp, self.hd
        H, KV, H_l, KV_l = self.heads, self.kv, self.H_l, self.KV_l
        p = params.get("params", params)
        out = {}
        for name, lp in p.items():
            sa, mlp = lp["self_attention"], lp["mlp"]
            qk, qb = _np(sa["query_key_value"]["kernel"]), \
                _np(sa["query_key_value"]["bias"])
            if KV == H:
                # head-interleaved [h, H, 3hd]
                k3 = qk.reshape(qk.shape[0], H, 3 * hd)
                b3 = qb.reshape(H, 3 * hd)
                qkv_k = np.stack([
                    k3[:, s * H_l:(s + 1) * H_l].reshape(qk.shape[0], -1)
                    for s in range(tp)])
                qkv_b = np.stack([
                    b3[s * H_l:(s + 1) * H_l].reshape(-1)
                    for s in range(tp)])
            else:
                # flat [q | k | v] blocks
                qpart = qk[:, : H * hd]
                kpart = qk[:, H * hd: (H + KV) * hd]
                vpart = qk[:, (H + KV) * hd:]
                qpb = qb[: H * hd]
                kpb = qb[H * hd: (H + KV) * hd]
                vpb = qb[(H + KV) * hd:]

                def sl(a, n_l, s):
                    return a[..., s * n_l * hd:(s + 1) * n_l * hd]

                qkv_k = np.stack([np.concatenate(
                    [sl(qpart, H_l, s), sl(kpart, KV_l, s),
                     sl(vpart, KV_l, s)], axis=-1) for s in range(tp)])
                qkv_b = np.stack([np.concatenate(
                    [sl(qpb, H_l, s), sl(kpb, KV_l, s), sl(vpb, KV_l, s)],
                    axis=-1) for s in range(tp)])

            dk, db = _np(sa["dense"]["kernel"]), _np(sa["dense"]["bias"])
            dense_k = np.stack([
                dk[s * H_l * hd:(s + 1) * H_l * hd] for s in range(tp)])
            dense_b = np.stack([db / tp] * tp)   # psum re-adds once

            f_l = _np(mlp["to_4h"]["kernel"]).shape[1] // tp
            uk, ub = _np(mlp["to_4h"]["kernel"]), _np(mlp["to_4h"]["bias"])
            vk2, vb2 = _np(mlp["to_h"]["kernel"]), _np(mlp["to_h"]["bias"])
            up_k = np.stack([uk[:, s * f_l:(s + 1) * f_l]
                             for s in range(tp)])
            up_b = np.stack([ub[s * f_l:(s + 1) * f_l] for s in range(tp)])
            down_k = np.stack([vk2[s * f_l:(s + 1) * f_l]
                               for s in range(tp)])
            down_b = np.stack([vb2 / tp] * tp)

            new = {
                "self_attention": {
                    "query_key_value": {"kernel": qkv_k, "bias": qkv_b},
                    "dense": {"kernel": dense_k, "bias": dense_b},
                },
                "mlp": {
                    "to_4h": {"kernel": up_k, "bias": up_b},
                    "to_h": {"kernel": down_k, "bias": down_b},
                },
            }
            for ln in ("ln_attn", "ln_mlp"):
                if ln in lp:
                    new[ln] = {k2: np.stack([_np(v2)] * tp)
                               for k2, v2 in lp[ln].items()}
            out[name] = new
        return {"params": out}

    # -- caches --------------------------------------------------------------

    def init_caches(self, batch: int) -> Tuple[KVCache, ...]:
        """Global caches: ``[dp * tp * b_local * KV_l]`` replicas,
        shard-major so the mesh sharding on dim 0 gives each device its
        local ``b_local * KV_l``."""
        if batch % self.dp:
            raise ValueError(
                f"batch {batch} not divisible by dp {self.dp}")
        R = self.tp * batch * self.KV_l
        return tuple(
            init_kv_cache(R, self.s_max, self.hd, dtype=self.cache_dtype)
            for _ in range(self.model.num_layers))

    # -- sharded calls -------------------------------------------------------

    def _local_params(self, sparams):
        return jax.tree.map(lambda a: a[0], sparams)

    def _shard(self, fn, sparams, caches, n_extra_rep, y_batch_dim=0):
        """shard_map wrapper: params sharded over tp (replicated over
        dp), caches sharded over (dp, tp) on dim 0, activations sharded
        over dp (replicated over tp) in and out. ``y_batch_dim``: which
        output-activation dim carries the batch (``decode_loop`` stacks
        tokens ahead of it)."""
        cache_spec = P((self.batch_axis, self.axis)) if self.batch_axis \
            else P(self.axis)
        act_spec = P(self.batch_axis) if self.batch_axis else P()
        if self.batch_axis:
            y_spec = P(*([None] * y_batch_dim), self.batch_axis)
        else:
            y_spec = P()
        in_specs = (jax.tree.map(lambda _: P(self.axis), sparams),) + \
            tuple(act_spec for _ in range(n_extra_rep)) + \
            (jax.tree.map(lambda _: cache_spec, caches),)
        out_specs = (y_spec, jax.tree.map(lambda _: cache_spec, caches))
        # check_vma=False: the local body runs Pallas kernels on the GPU,
        # whose out_shape ShapeDtypeStructs carry no vma — the default
        # check rejects them (CPU runs take the plain path and never hit
        # it)
        return jax.shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    def _tp_call(self, method, sparams, x, caches, y_batch_dim=0,
                 **kwargs):
        """Run one local-decoder step method under the tp shard_map: the
        sharded runtime IS the single-chip runtime plus the per-layer
        psum reduce_fn (the only wrapper all four steps share).

        The jitted shard_map is memoized per (method, kwargs, cache
        structure): an eager serving loop previously re-traced AND
        re-compiled the whole sharded program on every call — the
        decode path's host overhead was the compile, not the step."""
        red = lambda t: jax.lax.psum(t, self.axis)  # noqa: E731
        ck = (getattr(method, "__func__", method), y_batch_dim,
              tuple(sorted(kwargs.items())), jax.tree.structure(caches))
        jits = getattr(self, "_tp_jits", None)
        if jits is None:
            jits = self._tp_jits = {}
        try:
            fn = jits.get(ck)
        except TypeError:          # unhashable kwarg value (jax Array…)
            ck, fn = None, None
        if fn is None:
            def f(sp, x_, cs):
                return method(self._local_params(sp), x_, cs,
                              reduce_fn=red, **kwargs)

            fn = jax.jit(self._shard(f, sparams, caches, 1,
                                     y_batch_dim=y_batch_dim))
            if ck is not None:
                jits[ck] = fn
                # per-call callables (decode_loop's next_input lambdas)
                # mint a FRESH key every call; evict those first so the
                # hot named-method programs (decode_step) never get
                # flushed out of the memo by a stream of dead entries
                if len(jits) > 32:
                    def _ephemeral(k):
                        return any(
                            callable(v) and getattr(
                                v, "__name__", "") == "<lambda>"
                            for _, v in k[2])

                    for k in list(jits):
                        if len(jits) <= 32:
                            break
                        if k != ck and _ephemeral(k):
                            jits.pop(k)
                    while len(jits) > 32:
                        jits.pop(next(iter(jits)))
        return fn(sparams, x, caches)

    def prefill(self, sparams, x, caches):
        """Prompt pass on every shard's local heads; fills local caches.
        ``x [b, T, h]`` replicated; returns ``(y [b, T, h], caches)``."""
        return self._tp_call(self._ld.prefill, sparams, x, caches)

    def decode_step(self, sparams, x_tok, caches):
        return self._tp_call(self._ld.decode_step, sparams, x_tok, caches)

    def decode_step_ragged(self, sparams, x_tok, caches, active=None):
        """Continuous-batching step, tensor-parallel. See
        ``SparseDecoder.decode_step_ragged``. ``active`` (bool ``[b]``)
        shards like an activation (over dp, replicated over tp)."""
        if active is None:
            return self._tp_call(self._ld.decode_step_ragged, sparams,
                                 x_tok, caches)
        red = lambda t: jax.lax.psum(t, self.axis)  # noqa: E731
        ck = ("ragged_active", jax.tree.structure(caches))
        jits = getattr(self, "_tp_jits", None)
        if jits is None:
            jits = self._tp_jits = {}
        fn = jits.get(ck)
        if fn is None:
            def f(sp, x_, act_, cs):
                return self._ld.decode_step_ragged(
                    self._local_params(sp), x_, cs, act_, reduce_fn=red)

            fn = jax.jit(self._shard(f, sparams, caches, 2))
            jits[ck] = fn
        return fn(sparams, x_tok, jnp.asarray(active), caches)

    def decode_multi(self, sparams, x_toks, caches):
        """Speculative verification step (q draft tokens at once),
        tensor-parallel. See ``SparseDecoder.decode_multi``."""
        return self._tp_call(self._ld.decode_multi, sparams, x_toks, caches)

    def decode_loop(self, sparams, x_tok, caches, n_tokens: int,
                    next_input=None):
        """N tokens inside one jit + one shard_map (a ``lax.scan`` whose
        body costs 2 psums/layer). ys stacks tokens on dim 0: batch
        lives on dim 1."""
        return self._tp_call(self._ld.decode_loop, sparams, x_tok, caches,
                             y_batch_dim=1, n_tokens=n_tokens,
                             next_input=next_input)


class PagedTPDecoder(TPDecoder):
    """Tensor/data-parallel serving over per-shard KV page pools — the
    composition of ``TPDecoder`` (head-sharded decode, 2 psums/layer)
    and ``PagedDecoder`` (vLLM-style pooled KV, ``ops/paged.py``).

    Layout: every ``PagedKVCache`` leaf stacks the ``dp * tp`` shards on
    dim 0 (``shard_map`` with ``P((dp, tp))`` hands each device exactly
    its local pool + tables), so INSIDE the mesh each shard runs the
    unmodified single-chip ``PagedDecoder`` over a pool of ``n_pages``
    pages holding its own ``b_local * kv_heads/tp`` replicas. Page ids
    are shard-local; the host keeps one ``PagePool`` allocator per
    (layer, shard). Host scheduler steps (``reserve``/``release``/
    ``share_prefix``) slice the stacked tables per shard, run the
    single-chip host op, and write the slices back — allocation stays
    control flow, decode stays one jit-able SPMD program.

    Contract (same as ``PagedDecoder``): call ``reserve(caches, n)``
    between jitted decode segments; ``prefill`` reserves its own prompt
    pages (a host step — do not wrap ``prefill`` itself in an outer
    ``jax.jit``; the shard_map body still compiles).

    ``n_pages`` is PER SHARD: each shard independently pools its
    ``b_local * kv_heads/tp`` replicas, so size it as
    ``ceil(expected_tokens_per_slot_sum / bk / dp) + b_local * KV_l``.
    """

    def __init__(self, model: SparseTransformer, mesh: Mesh, *,
                 n_pages: int, axis: str = "tp",
                 batch_axis: Optional[str] = None,
                 s_max: int, bk: int = 256,
                 window: Optional[int] = None, sinks: int = 0,
                 cache_dtype=jnp.bfloat16):
        self.n_pages = n_pages           # read by _make_local_decoder
        super().__init__(model, mesh, axis=axis, batch_axis=batch_axis,
                         s_max=s_max, bk=bk, window=window, sinks=sinks,
                         cache_dtype=cache_dtype)
        self.pools: List[List[pg.PagePool]] = []   # [layer][shard]
        self._b_local = None

    def _make_local_decoder(self, local_model, **kw) -> PagedDecoder:
        return PagedDecoder(local_model, n_pages=self.n_pages, **kw)

    # -- cache management (host scheduler over stacked tables) ---------------

    def init_caches(self, batch: int) -> Tuple[pg.PagedKVCache, ...]:
        if batch % self.dp:
            raise ValueError(f"batch {batch} not divisible by dp {self.dp}")
        self._b_local = batch // self.dp
        self._R_local = self._b_local * self.KV_l
        caches, self.pools = [], []
        n_sh = self.n_shards
        for _ in range(self.model.num_layers):
            local, _ = pg.init_paged_cache(
                self._R_local, self.n_pages, self.bk, self.hd,
                self._ld.nb, dtype=self.cache_dtype)
            self._P_alloc = local.k.shape[0]

            def tile0(a):
                return jnp.tile(a, (n_sh,) + (1,) * (a.ndim - 1))

            caches.append(jax.tree.map(tile0, local))
            self.pools.append([pg.PagePool(self.n_pages)
                               for _ in range(n_sh)])
        return tuple(caches)

    def _table_view(self, c: pg.PagedKVCache, s: int) -> pg.PagedKVCache:
        """Shard ``s``'s table/length rows over the GLOBAL pool arrays —
        enough for table-only host ops (``ensure_pages``/
        ``free_pages_of`` never touch pool data)."""
        R = self._R_local
        return dataclasses.replace(
            c, page_table=c.page_table[s * R:(s + 1) * R],
            kv_len=c.kv_len[s * R:(s + 1) * R])

    def _full_view(self, c: pg.PagedKVCache, s: int) -> pg.PagedKVCache:
        P, R = self._P_alloc, self._R_local
        return pg.PagedKVCache(
            k=c.k[s * P:(s + 1) * P], v=c.v[s * P:(s + 1) * P],
            k_scale=c.k_scale[s * P:(s + 1) * P],
            v_scale=c.v_scale[s * P:(s + 1) * P],
            page_table=c.page_table[s * R:(s + 1) * R],
            kv_len=c.kv_len[s * R:(s + 1) * R])

    def _set_table(self, c, s, view):
        R = self._R_local
        return dataclasses.replace(
            c,
            page_table=c.page_table.at[s * R:(s + 1) * R].set(
                view.page_table),
            kv_len=c.kv_len.at[s * R:(s + 1) * R].set(view.kv_len))

    def _set_full(self, c, s, view):
        P = self._P_alloc
        c = self._set_table(c, s, view)
        return dataclasses.replace(
            c,
            k=c.k.at[s * P:(s + 1) * P].set(view.k),
            v=c.v.at[s * P:(s + 1) * P].set(view.v),
            k_scale=c.k_scale.at[s * P:(s + 1) * P].set(view.k_scale),
            v_scale=c.v_scale.at[s * P:(s + 1) * P].set(view.v_scale))

    def _slot_shards(self, slot: int):
        """(dp-local slot, the tp shard indices holding it). Cache dim 0
        is sharded ``P((dp, tp))`` = dp-major, so dp slice ``d`` owns
        shards ``d*tp .. d*tp+tp-1`` (every tp shard carries its own KV
        heads of the same batch slots)."""
        if self._b_local is None:
            raise ValueError("init_caches first")
        if not 0 <= slot < self._b_local * self.dp:
            raise ValueError(f"slot {slot} out of range")
        d, ls = divmod(slot, self._b_local)
        return ls, [d * self.tp + t for t in range(self.tp)]

    def reserve(self, caches, n_tokens: int = 1):
        """HOST scheduler step: pages for the next ``n_tokens`` appends
        on every shard of every layer (call between jitted segments)."""
        if self._b_local is None:
            raise ValueError("init_caches first")
        out = []
        for li, c in enumerate(caches):
            for s in range(self.n_shards):
                v = pg.ensure_pages(self._table_view(c, s),
                                    self.pools[li][s], n_tokens)
                c = self._set_table(c, s, v)
            out.append(c)
        return tuple(out)

    def release(self, caches, slot: int):
        """Evict global batch slot ``slot``: free its pages on every tp
        shard of its dp slice, every layer."""
        ls, shards = self._slot_shards(slot)
        out = []
        for li, c in enumerate(caches):
            for s in shards:
                v = pg.free_pages_of(self._table_view(c, s),
                                     self.pools[li][s], ls,
                                     kv_heads=self.KV_l)
                c = self._set_table(c, s, v)
            out.append(c)
        return tuple(out)

    def share_prefix(self, caches, src: int, dst: int, n_tokens: int):
        """Prefix caching across the mesh: slots must live in the SAME dp
        slice (pages never cross pools — a cross-slice share would be a
        copy, not a share; prefill the prompt there instead)."""
        ls_src, sh_src = self._slot_shards(src)
        ls_dst, sh_dst = self._slot_shards(dst)
        if sh_src != sh_dst:
            raise ValueError(
                f"src slot {src} and dst slot {dst} live in different dp "
                "slices; prefix pages cannot be shared across pools")
        out = []
        for li, c in enumerate(caches):
            for s in sh_src:
                v = pg.share_prefix(self._full_view(c, s),
                                    self.pools[li][s], ls_src, ls_dst,
                                    n_tokens, kv_heads=self.KV_l)
                c = self._set_full(c, s, v)
            out.append(c)
        return tuple(out)

    @property
    def free_pages(self) -> List[List[int]]:
        """Free pages per layer per shard."""
        return [[p.free_pages for p in layer] for layer in self.pools]

    # -- sharded calls --------------------------------------------------------

    def prefill(self, sparams, x, caches):
        """Prompt pass: reserves the prompt's pages (HOST step), then the
        sharded prefill writes pool pages inside the mesh (the traced
        ``write_prompt_pages`` path). Eager-only at the top level, like
        ``PagedDecoder.prefill`` — the shard_map body still compiles."""
        T = x.shape[1]
        if T % self.bk:
            raise ValueError(f"prompt length {T} must pad to bk={self.bk}")
        caches = self.reserve(caches, T)
        return super().prefill(sparams, x, caches)

    def rollback(self, caches, n):
        """Reject the last ``n`` speculative tokens (scalar, or per-slot
        ``i32[batch]`` — expanded to the dp-major stacked replica rows)."""
        n = jnp.asarray(n, jnp.int32)
        if n.ndim == 1:
            nl = n.reshape(self.dp, self._b_local)
            nl = jnp.repeat(nl, self.KV_l, axis=1)        # [dp, R_local]
            n = jnp.tile(nl[:, None, :], (1, self.tp, 1)).reshape(-1)
        return tuple(
            dataclasses.replace(c, kv_len=jnp.maximum(c.kv_len - n, 0))
            for c in caches)
