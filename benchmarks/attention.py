"""Sparse-vs-dense attention and transformer step benchmarks.

The reference's informal perf checks are sparse/dense attention time
ratios (``tests/test_attention.py:54-83``: r=256, s=72, 90% sparse) and an
untimed 6-layer transformer driver (``tests/transformer/driver.py``: b=4,
s=512, h=512, 8 heads, causal). This harness times both on a GPU (it
fails without one):

  * attention core (SDDMM -> softmax -> SpMM, batched panel kernels) vs
    dense masked softmax attention, same shapes;
  * the full SparseTransformer train step at the driver's configuration.

Usage: python benchmarks/attention.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_attention_core(name, mask, r, hd=64):
    """Sparse attention core (batched panel kernels) vs dense masked
    attention on the same mask. The reference's version of this is
    ``tests/test_attention.py:54-83`` (r=256, s=72, random 90% sparse).

    Note the regimes: with *random* masks every kernel tile stays
    occupied, so block-sparse attention cannot skip FLOPs and dense wins at
    short s (the reference skips at element granularity instead). The wins
    are
    structured masks (causal/local -> block skip) and long sequences
    (sparse scores stay O(s*w) while dense is O(s^2))."""
    import jax
    import jax.numpy as jnp

    from sputnik_tpu import many_mask as mm
    from sputnik_tpu.ops import batched_panel as bp

    from sputnik_tpu.models.transformer import flash_tiles
    from sputnik_tpu.ops.fused_attention import fused_sparse_attention
    from sputnik_tpu.utils.profiling import measure

    s = mask.shape[0]
    rng = np.random.RandomState(0)
    mt = mm.ManyMaskTopology.from_dense_masks(mask[None])
    blk, bkk = flash_tiles(s, hd)
    spec = bp.BatchedPanelSpec.from_many_mask(mt, heads=r, bm=blk, bk=bkk)
    q = jnp.asarray(rng.randn(r, s, hd).astype(np.float32))
    k = jnp.asarray(rng.randn(r, s, hd).astype(np.float32))
    v = jnp.asarray(rng.randn(r, s, hd).astype(np.float32))

    @jax.jit
    def sparse_attn(q, k, v):
        return fused_sparse_attention(spec, q, k, v)

    mask_j = jnp.asarray(mask)

    @jax.jit
    def dense_attn(q, k, v):
        sc = jnp.einsum("rqd,rkd->rqk", q, k) / np.sqrt(hd)
        sc = jnp.where(mask_j != 0, sc, -1e30)
        w = jax.nn.softmax(sc, axis=-1) * (mask_j != 0)
        return jnp.einsum("rqk,rkd->rqd", w, v)

    from sputnik_tpu.ops.fused_attention import warm_flash_meta
    warm_flash_meta(spec)
    ms_sparse = measure(sparse_attn, q, k, v)
    ms_dense = measure(dense_attn, q, k, v)
    print(json.dumps({
        "config": f"{name} r={r} s={s} hd={hd}",
        "density": round(mt.topologies[0].nnz / s ** 2, 4),
        "block_occupancy": round(spec.views[0].block_density, 4),
        "sparse_ms": ms_sparse,
        "dense_ms": ms_dense,
        "speedup_vs_dense": ms_dense / ms_sparse,
    }), flush=True)


def bench_transformer_driver():
    """the reference driver config: 6 layers, b=4, s=512, h=512, 8 heads,
    causal masks with a fully-masked row (driver.py:4-29)."""
    import jax
    import jax.numpy as jnp

    from sputnik_tpu.models import SparseTransformer
    from sputnik_tpu.utils.profiling import measure

    b, s, h, heads, layers, ffn = 4, 512, 512, 8, 6, 2048
    rng = np.random.RandomState(0)
    mask = np.tril(np.ones((s, s), np.float32))
    mask[s // 2, :] = 0.0
    masks = np.broadcast_to(mask, (b, s, s)).copy()
    model = SparseTransformer.from_masks(
        masks, num_layers=layers, hidden_size=h, num_heads=heads,
        ffn_hidden_size=ffn)
    x = jnp.asarray(rng.randn(b, s, h).astype(np.float32))
    params = model.init(jax.random.PRNGKey(0), x)

    fwd = jax.jit(lambda p: model.apply(p, x))
    step = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(model.apply(p, x) ** 2)))

    ms_fwd = measure(fwd, params)
    ms_step = measure(step, params)

    # dense-equivalent train step, SAME parameters and layer math but
    # dense masked softmax attention (the reference reports sparse/dense
    # ratios, tests/test_attention.py:55-83 — this is the ratio's
    # denominator at the driver config, measured in the same session)
    mask_j = jnp.asarray(masks)                      # [b, s, s]
    hd = h // heads

    def dense_apply(p, xx):
        # mirrors the driver model's defaults (no LN / residual /
        # activation — the reference driver's bare block), dense attention
        lp_all = p["params"]
        for i in range(layers):
            lp = lp_all[f"layer_{i}"]
            qkv = xx @ lp["self_attention"]["query_key_value"]["kernel"] \
                + lp["self_attention"]["query_key_value"]["bias"]
            qkv = qkv.reshape(b, s, heads, 3 * hd)
            q_, k_, v_ = jnp.split(qkv, 3, axis=-1)
            sc = jnp.einsum("bqhd,bkhd->bhqk", q_, k_) / np.sqrt(hd)
            sc = jnp.where(mask_j[:, None] != 0, sc, -1e30)
            w = jax.nn.softmax(sc, axis=-1) * (mask_j[:, None] != 0)
            ctx = jnp.einsum("bhqk,bkhd->bqhd", w, v_).reshape(b, s, h)
            attn = ctx @ lp["self_attention"]["dense"]["kernel"] \
                + lp["self_attention"]["dense"]["bias"]
            y = attn @ lp["mlp"]["to_4h"]["kernel"] \
                + lp["mlp"]["to_4h"]["bias"]
            xx = y @ lp["mlp"]["to_h"]["kernel"] + lp["mlp"]["to_h"]["bias"]
        return xx

    dstep = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(dense_apply(p, x) ** 2)))
    ms_dense_step = measure(dstep, params)
    print(json.dumps({
        "config": f"transformer driver b={b} s={s} h={h} x{layers}L",
        "forward_ms": ms_fwd,
        "train_step_ms": ms_step,
        "dense_train_step_ms": ms_dense_step,
        "sparse_over_dense": ms_step / ms_dense_step,
    }), flush=True)


if __name__ == "__main__":
    from sputnik_tpu.utils import enable_compile_cache
    from sputnik_tpu.utils.device import require_gpu

    require_gpu()
    enable_compile_cache()
    from sputnik_tpu.patterns import (
        causal_mask,
        local_window_mask,
        uniform_mask,
    )

    which = os.environ.get("BENCH_ATTN", "all")
    if which in ("all", "random"):
        bench_attention_core(
            "random sp=0.9", uniform_mask(512, 512, sparsity=0.9,
                                          round_to=4, seed=1), r=64)
    if which in ("all", "causal"):
        bench_attention_core("causal", causal_mask(2048), r=16)
    if which in ("all", "local"):
        bench_attention_core(
            "local w=256", local_window_mask(4096, window=256), r=8)
    if which in ("all", "driver"):
        bench_transformer_driver()
