"""Sparse transformer demo family (the reference's most complete "model").

Capability parity with ``tests/transformer/modules.py``: a transformer whose
attention scores are sparse under *per-batch-element masks* with differing
sparsities (the many-mask family), fused QKV projection, MLP, N stacked
layers, trainable end to end (``tests/transformer/driver.py:4-29``: 6 layers,
seq 512, hidden 512, 8 heads, causal mask with a fully-masked row).

Fixes over the reference:
  * the mask -> CSR conversion happens ONCE at construction (a cached
    ``ManyMaskTopology``), not on every forward (the reference converts per
    step at ``modules.py:29`` — flagged as the hot spot in SURVEY.md §3.4);
  * the CSR softmax backward is mathematically correct (the reference's
    ``CsrSoftmax.backward`` is wrong, ``functions.py:105-115``);
  * batch-major ``[b, s, h]`` layout throughout (idiomatic for sharding the
    batch across a device mesh) instead of ``[s, b, h]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import many_mask as mm
from ..ops import batched_panel as bp
from .module import Dense, LayerNorm, Module, remat_call

# sequence-length crossover for layout="auto": below it the dense-masked
# XLA graph is taken, above it the fused flash kernel. Measured on an H100
# (PERF.md): causal b=4 h=8 hd=128 forward + backward, dense-masked XLA is
# faster at every s in {512, 1024, 2048, 4096}; the crossover above 4096
# is not measured yet.
_XLA_FLASH_CROSSOVER = 8192

__all__ = [
    "SparseCoreAttention",
    "SparseSelfAttention",
    "MLP",
    "TransformerLayer",
    "SparseTransformer",
    "divide",
    "split_tensor_along_last_dim",
]


def divide(numerator: int, denominator: int) -> int:
    """Exact division with a clear error (the reference's Megatron-style
    helper, ``tests/transformer/utils.py:64-70``)."""
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")
    return numerator // denominator


def split_tensor_along_last_dim(tensor, num_partitions: int):
    """Split the last dimension into equal chunks
    (``tests/transformer/utils.py:72-80``)."""
    divide(tensor.shape[-1], num_partitions)
    return jnp.split(tensor, num_partitions, axis=-1)


def flash_tiles(s: int, hd: int = 128, flash_block: int = 0,
                flash_block_k: int = 0):
    """Fused-flash tile ``(bm, bk)`` for sequence length ``s`` and head
    width ``hd``.

    One Triton program owns ``bm`` query rows and walks ``bk``-wide key
    blocks. At ``hd = 128``, 64 x 64 is the largest square tile whose
    backward kernels fit a block's 227 KB of shared memory at every matmul
    precision (128 x 64 is faster at the default precision but overflows
    at ``highest``; sweep on an H100, PERF.md); wider heads halve it.
    Neither exceeds the padded sequence nor drops below 16 (the tensor
    cores' minimum). Single source of truth for training
    (``SparseCoreAttention``) and serving
    (``SparseDecoder._prefill_spec``)."""
    s_pow2 = 1 << (s - 1).bit_length()
    base = 32 if hd > 128 else 64
    bm = flash_block or base
    bk = flash_block_k or base
    return (max(16, min(bm, s_pow2)), max(16, min(bk, s_pow2)))


def dense_masks_for(mt: mm.ManyMaskTopology):
    """Dense ``[b, s, s]`` 0/1 masks for the ``xla`` layout,
    reconstructed from the topologies once and device-cached on the
    mask object (only outside a trace — a trace-created array would be
    trace-local; inside one the numpy constant is used, baking a
    per-trace HLO constant). jit-only callers should warm eagerly:
    ``SparseTransformer.from_masks`` does it for sub-crossover masks,
    the first eager ``__call__`` covers the rest."""
    np_m = getattr(mt, "_dense_masks_np", None)
    if np_m is None:
        np_m = np.stack([t.to_dense_mask() for t in mt.topologies]
                        ).astype(np.float32)
        object.__setattr__(mt, "_dense_masks_np", np_m)
    dev = getattr(mt, "_dense_masks_dev", None)
    if dev is not None:
        return dev
    from ..ops._common import trace_clean

    arr = jnp.asarray(np_m)
    if trace_clean():
        object.__setattr__(mt, "_dense_masks_dev", arr)
    return arr


def cached_batched_spec(mt: mm.ManyMaskTopology, heads: int, bm: int,
                        bk: int) -> bp.BatchedPanelSpec:
    """The ``(heads, bm, bk)``-keyed ``BatchedPanelSpec`` cache attached
    to a topology — one spec build per tiling, shared by every module
    (training attention, serving prefill) bound to the same masks."""
    cached = getattr(mt, "_batched_panel_specs", None)
    if cached is None:
        cached = {}
        object.__setattr__(mt, "_batched_panel_specs", cached)
    key = (heads, bm, bk)
    if key not in cached:
        cached[key] = bp.BatchedPanelSpec.from_many_mask(
            mt, heads=heads, bm=bm, bk=bk)
    return cached[key]


@dataclasses.dataclass(frozen=True)
class SparseCoreAttention(Module):
    """SDDMM -> ragged CSR softmax -> SpMM with per-batch masks.

    ``layout="flash"`` (default) fuses the whole chain into one kernel
    with online softmax (scores never reach device memory) and a
    two-kernel backward. ``layout="panel"`` runs the chain through the
    batched panel ops (``ops/batched_panel.py``): one launch for all
    ``b*h`` replicas, heads sharing their batch element's block metadata.
    ``layout="csr"`` keeps the flat many-mask path (reference-parity
    semantics, ``tests/transformer/functions.py``); ``layout="xla"`` is
    dense masked attention; ``layout="auto"`` picks ``xla`` below
    ``_XLA_FLASH_CROSSOVER`` and ``flash`` above."""

    mask_topology: mm.ManyMaskTopology
    num_heads: int
    layout: str = "flash"
    flash_block: int = 0        # 0 -> flash_tiles' default
    flash_block_k: int = 0      # 0 -> flash_tiles' default
    # "bf16": stream q/k/v to the flash kernel as bf16 (f32 accumulate;
    # backward COTANGENTS are then bf16 too, the standard mixed-precision
    # training trade). Opt-in; None keeps the operands' dtype.
    flash_stream: Optional[str] = None

    def _panel_spec(self, bm=128, bk=128):
        return cached_batched_spec(self.mask_topology, self.num_heads,
                                   bm, bk)

    def _dense_masks(self):
        return dense_masks_for(self.mask_topology)

    def forward(self, scope, q, k, v):
        """q: ``[b, s, heads, head_dim]``; k, v: same, or with fewer
        (grouped-query) KV heads dividing ``heads`` -> ``[b, s, h]``."""
        del scope
        mt = self.mask_topology
        b, s, h, hd = q.shape
        if b != mt.b:
            raise ValueError(f"batch {b} != mask batch {mt.b}")
        if s != mt.m:
            raise ValueError(f"seq {s} != mask rows {mt.m}")
        layout = self.layout
        if layout == "auto":
            layout = "xla" if s < _XLA_FLASH_CROSSOVER else "flash"
        if layout == "flash" and s < 16:
            # below the tensor cores' 16-row minimum tile
            layout = "panel"
        if layout == "xla":
            kv = k.shape[2]
            if kv != h:
                if kv == 0 or h % kv:
                    raise ValueError(f"kv heads {kv} must divide heads {h}")
                k = jnp.repeat(k, h // kv, axis=2)
                v = jnp.repeat(v, h // kv, axis=2)
            mask = self._dense_masks()                    # [b, s, s]
            scale = 1.0 / float(np.sqrt(hd))
            sc = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
            live = mask[:, None] != 0
            sc = jnp.where(live, sc, -1e30)
            w = jax.nn.softmax(sc, axis=-1) * live
            ctx = jnp.einsum("bhqk,bkhd->bqhd", w, v)
            return ctx.reshape(b, s, h * hd)
        group = 1
        if k.shape[2] != h:
            kv = k.shape[2]
            if kv == 0 or h % kv:
                raise ValueError(f"kv heads {kv} must divide heads {h}")
            if layout == "flash":
                # GQA native in the fused kernel: group query replicas read
                # their shared KV replica — no K/V expansion, KV streams
                # and dk/dv memory shrink by the group factor.
                group = h // kv
            else:
                # unfused panel/csr chains index K/V per query replica
                k = jnp.repeat(k, h // kv, axis=2)
                v = jnp.repeat(v, h // kv, axis=2)

        def fold(x):  # [b, s, hx, hd] -> [b*hx, s, hd]
            x = jnp.transpose(x, (0, 2, 1, 3))
            return x.reshape(b * x.shape[1], s, hd)

        q3, k3, v3 = fold(q), fold(k), fold(v)
        scale = 1.0 / float(np.sqrt(hd))
        if layout == "flash":
            from ..ops.fused_attention import (fused_sparse_attention,
                                               warm_flash_meta)

            if self.flash_stream == "bf16":
                q3 = q3.astype(jnp.bfloat16)
                k3 = k3.astype(jnp.bfloat16)
                v3 = v3.astype(jnp.bfloat16)
            blk, blk_k = flash_tiles(s, hd, self.flash_block,
                                     self.flash_block_k)
            spec = self._panel_spec(bm=blk, bk=blk_k)
            # device-place the flash metadata on the first eager call so
            # traced steps don't bake it into their compile payload
            warm_flash_meta(spec)
            ctx = fused_sparse_attention(spec, q3, k3, v3, scale=scale,
                                         group=group)
        elif layout == "panel":
            spec = self._panel_spec()
            scores = bp.sddmm_bh(spec, q3, k3) * scale
            weights = bp.sparse_softmax_bh(spec, scores)
            ctx = bp.spmm_bh(spec, weights, v3)           # [b*h, s, hd]
        else:
            scores = mm.sddmm_many_mask(mt, q3, k3) * scale
            weights = mm.sparse_softmax_many_mask(mt, scores)
            ctx = mm.spmm_many_mask(mt, weights, v3)      # [b*h, s, hd]
        ctx = ctx.reshape(b, h, s, hd).astype(q.dtype)
        return jnp.transpose(ctx, (0, 2, 1, 3)).reshape(b, s, h * hd)


@dataclasses.dataclass(frozen=True)
class SparseSelfAttention(Module):
    """Fused-QKV self-attention block (``modules.py:83-119``).

    ``num_kv_heads`` (default: ``num_heads``) enables grouped-query
    attention: K/V are projected to fewer heads, shrinking the QKV
    parameters and — the real point — the serving KV cache by
    ``num_heads / num_kv_heads`` (``models/serving.SparseDecoder`` stores
    and attends over only the KV heads)."""

    mask_topology: mm.ManyMaskTopology
    hidden_size: int
    num_heads: int
    num_kv_heads: Optional[int] = None
    attention_layout: str = "flash"
    flash_stream: Optional[str] = None   # "bf16" -> stream q/k/v

    def forward(self, scope, x):
        b, s, hsz = x.shape
        if hsz != self.hidden_size:
            raise ValueError(f"hidden {hsz} != {self.hidden_size}")
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must divide by num_heads")
        hd = self.hidden_size // self.num_heads
        kv = self.num_kv_heads or self.num_heads
        if self.num_heads % kv:
            raise ValueError(
                f"num_kv_heads {kv} must divide num_heads {self.num_heads}")

        if kv == self.num_heads:
            # head-interleaved layout, identical to the pre-GQA parameters
            qkv = Dense(3 * self.hidden_size)(
                scope.child("query_key_value"), x)
            qkv = qkv.reshape(b, s, self.num_heads, 3 * hd)
            q, k, v = jnp.split(qkv, 3, axis=-1)
        else:
            qkv = Dense((self.num_heads + 2 * kv) * hd)(
                scope.child("query_key_value"), x)
            q = qkv[..., : self.num_heads * hd]
            q = q.reshape(b, s, self.num_heads, hd)
            k = qkv[..., self.num_heads * hd: (self.num_heads + kv) * hd]
            k = k.reshape(b, s, kv, hd)
            v = qkv[..., (self.num_heads + kv) * hd:]
            v = v.reshape(b, s, kv, hd)

        ctx = SparseCoreAttention(
            mask_topology=self.mask_topology, num_heads=self.num_heads,
            layout=self.attention_layout,
            flash_stream=self.flash_stream,
        )(scope, q, k, v)
        return Dense(self.hidden_size)(scope.child("dense"), ctx)


@dataclasses.dataclass(frozen=True)
class MLP(Module):
    """Two dense projections (``modules.py:121-145``; the reference has no
    nonlinearity between them — ``activation`` opts one in)."""

    hidden_size: int
    ffn_hidden_size: int
    activation: Optional[str] = None

    def forward(self, scope, x):
        y = Dense(self.ffn_hidden_size)(scope.child("to_4h"), x)
        if self.activation == "gelu":
            y = jax.nn.gelu(y)
        elif self.activation == "relu":
            y = jax.nn.relu(y)
        elif self.activation is not None:
            raise ValueError(f"unknown activation {self.activation}")
        return Dense(self.hidden_size)(scope.child("to_h"), y)


@dataclasses.dataclass(frozen=True)
class TransformerLayer(Module):
    """Attention -> MLP. The reference stacks them bare (``modules.py:147-161``);
    ``use_residual``/``use_layernorm`` opt into the standard pre-LN block."""

    mask_topology: mm.ManyMaskTopology
    hidden_size: int
    num_heads: int
    ffn_hidden_size: int
    num_kv_heads: Optional[int] = None
    activation: Optional[str] = None
    use_residual: bool = False
    use_layernorm: bool = False
    attention_layout: str = "flash"
    flash_stream: Optional[str] = None
    # Mixture-of-Experts FFN (Switch/Mixtral-style): when ``moe`` is a
    # SparseMoE instance, it replaces the dense-in/dense-out MLP — sparse
    # expert FFNs behind a router, optionally expert-parallel over the
    # module's own mesh axis. Each layer's "mlp" scope holds its own
    # router + expert values.
    moe: Optional[Module] = None

    def forward(self, scope, x):
        def maybe_ln(y, name):
            if not self.use_layernorm:
                return y
            return LayerNorm()(scope.child(name), y)

        attn_in = maybe_ln(x, "ln_attn")
        attn = SparseSelfAttention(
            mask_topology=self.mask_topology,
            hidden_size=self.hidden_size,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            attention_layout=self.attention_layout,
            flash_stream=self.flash_stream,
        )(scope.child("self_attention"), attn_in)
        x = x + attn if self.use_residual else attn

        mlp_in = maybe_ln(x, "ln_mlp")
        mlp = self.moe if self.moe is not None else MLP(
            hidden_size=self.hidden_size,
            ffn_hidden_size=self.ffn_hidden_size,
            activation=self.activation,
        )
        y = mlp(scope.child("mlp"), mlp_in)
        return x + y if self.use_residual else y


@dataclasses.dataclass(frozen=True)
class SparseTransformer(Module):
    """N sparse-attention layers (``modules.py:163-183``).

    ``remat=True`` runs every layer under ``jax.checkpoint``: activations
    are recomputed in the backward pass instead of stored, trading ~one
    extra forward of FLOPs for O(num_layers) less device memory — the
    standard recipe for training long sequences, where memory capacity
    (not FLOPs) binds first. Parameter structure is unchanged, so
    checkpoints swap freely between the two modes."""

    mask_topology: mm.ManyMaskTopology
    num_layers: int
    hidden_size: int
    num_heads: int
    ffn_hidden_size: int
    num_kv_heads: Optional[int] = None
    activation: Optional[str] = None
    use_residual: bool = False
    use_layernorm: bool = False
    attention_layout: str = "flash"
    flash_stream: Optional[str] = None
    remat: bool = False
    # Interleaved MoE (Switch-style): every ``moe_every``-th layer's MLP
    # is replaced by ``moe`` (a SparseMoE instance — sparse expert FFNs
    # behind a top-1/top-2 router, optionally ep-sharded). 0 = no MoE;
    # 1 = every layer; 2 = layers 1, 3, 5, ... (the Switch default).
    # Training-side feature: the serving decoders expect dense-MLP
    # layer params and reject MoE models.
    moe: Optional[Module] = None
    moe_every: int = 0

    @classmethod
    def from_masks(cls, masks: np.ndarray, **kwargs) -> "SparseTransformer":
        """Build with per-batch dense 0/1 masks ``[b, s, s]`` (converted to
        CSR once, here — not per step)."""
        mt = mm.ManyMaskTopology.from_dense_masks(masks)
        if kwargs.get("attention_layout", "flash") in ("auto", "xla"):
            # device-place the dense masks EAGERLY: a jit-only caller
            # would otherwise bake a [b, s, s] constant into every
            # compiled program
            from ..ops._common import trace_clean

            if trace_clean():
                dense_masks_for(mt)
        return cls(mask_topology=mt, **kwargs)

    def forward(self, scope, x):
        if self.moe_every and self.moe is None:
            raise ValueError("moe_every set but no moe module given")
        for i in range(self.num_layers):
            is_moe = bool(self.moe_every) and (i % self.moe_every
                                               == self.moe_every - 1)
            layer = TransformerLayer(
                mask_topology=self.mask_topology,
                hidden_size=self.hidden_size,
                num_heads=self.num_heads,
                ffn_hidden_size=self.ffn_hidden_size,
                num_kv_heads=self.num_kv_heads,
                activation=self.activation,
                use_residual=self.use_residual,
                use_layernorm=self.use_layernorm,
                attention_layout=self.attention_layout,
                flash_stream=self.flash_stream,
                moe=self.moe if is_moe else None,
            )
            sub = scope.child(f"layer_{i}")
            x = remat_call(layer, sub, x) if self.remat else layer(sub, x)
        return x
