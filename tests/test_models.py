"""Module layer: SparseLinear / SparseAttention / SparseTransformer.

Mirrors the reference's layer tests: SparseLinear vs pruned ``nn.Linear``
with copied weights incl. bias and grads (test_linear.py, test_linear_3d.py
— the latter is the reference's most complete grad test), attention-module
forward (test_attention.py), and the 6-layer transformer forward+backward
(tests/transformer/driver.py, scaled down for CI).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

import sputnik_tpu as st
from sputnik_tpu.ops._common import interpret_kernels
from sputnik_tpu.models import (
    SparseAttention,
    SparseLinear,
    SparseTransformer,
)
from sputnik_tpu.patterns import causal_mask, init_uniform, sparsify_uniform

TOL = dict(rtol=1e-4, atol=1e-4)


def pruned_weight(out_f, in_f, prune, seed=0):
    w = sparsify_uniform(
        init_uniform((out_f, in_f), low=-0.1, high=0.1, seed=seed),
        prune, round_to=4, seed=seed + 1,
    ).astype(np.float32)
    return w


def copy_params_from_dense(layer, w_dense, bias=None):
    """Pack a dense weight into the layer's value param (the reference's
    ``copy_params`` pattern, test_linear.py:87-99), layout-aware."""
    params = {"values": jnp.asarray(layer.pack_dense(w_dense))}
    if bias is not None:
        params["bias"] = jnp.asarray(bias)
    return params


class TestSparseLinear:
    def test_2d_parity(self):
        # reference test_linear.py: 256,128 pruned 0.9
        out_f, in_f, rows = 64, 48, 32
        w = pruned_weight(out_f, in_f, 0.9)
        bias = init_uniform((out_f,), seed=3)
        layer = SparseLinear.from_mask(w != 0)
        x = init_uniform((rows, in_f), seed=4)
        params = {"params": copy_params_from_dense(layer, w, bias)}
        y = layer.apply(params, jnp.asarray(x))
        np.testing.assert_allclose(y, x @ w.T + bias, **TOL)

    def test_2d_parity_csr_layout(self):
        out_f, in_f, rows = 64, 48, 32
        w = pruned_weight(out_f, in_f, 0.9)
        bias = init_uniform((out_f,), seed=3)
        layer = SparseLinear.from_mask(w != 0, layout="csr")
        x = init_uniform((rows, in_f), seed=4)
        params = {"params": copy_params_from_dense(layer, w, bias)}
        y = layer.apply(params, jnp.asarray(x))
        np.testing.assert_allclose(y, x @ w.T + bias, **TOL)

    def test_3d_parity_and_grads(self):
        # reference test_linear_3d.py: batched + bias, forward AND grads
        b, out_f, in_f, rows = 3, 40, 24, 16
        w = pruned_weight(out_f, in_f, 0.8, seed=5)
        bias = init_uniform((out_f,), seed=6)
        layer = SparseLinear.from_mask(w != 0)
        t = layer.topology
        x = init_uniform((b, rows, in_f), seed=7)
        params = {"params": copy_params_from_dense(layer, w, bias)}
        y = layer.apply(params, jnp.asarray(x))
        ref = np.einsum("brk,ok->bro", x, w) + bias
        np.testing.assert_allclose(y, ref, **TOL)

        def loss_sparse(p, x):
            return jnp.sum(layer.apply(p, x) ** 2)

        def loss_dense(wd, bd, x):
            return jnp.sum((jnp.einsum("brk,ok->bro", x, wd) + bd) ** 2)

        g = jax.grad(loss_sparse)(params, jnp.asarray(x))["params"]
        gw, gb = jax.grad(loss_dense, argnums=(0, 1))(
            jnp.asarray(w), jnp.asarray(bias), jnp.asarray(x)
        )
        got = layer.unpack_dense(g["values"])
        np.testing.assert_allclose(got, np.asarray(gw) * (w != 0), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(g["bias"], gb, rtol=1e-3, atol=1e-3)

    def test_fused_relu(self):
        out_f, in_f, rows = 32, 24, 8
        w = pruned_weight(out_f, in_f, 0.5, seed=8)
        bias = init_uniform((out_f,), low=-0.5, high=0.5, seed=9)
        layer = SparseLinear.from_mask(w != 0, fuse_relu=True)
        x = init_uniform((rows, in_f), low=-1.0, high=1.0, seed=10)
        params = {"params": copy_params_from_dense(layer, w, bias)}
        y = layer.apply(params, jnp.asarray(x))
        np.testing.assert_allclose(y, np.maximum(x @ w.T + bias, 0.0), **TOL)

    def test_init_respects_topology(self):
        layer = SparseLinear.from_mask(pruned_weight(32, 32, 0.9, seed=11) != 0)
        params = layer.init(jax.random.PRNGKey(0), jnp.zeros((4, 32)))
        vals = np.asarray(params["params"]["values"])
        mask = layer.spec().view.mask  # panel layout: zeros off-topology
        np.testing.assert_array_equal(vals[~mask], 0.0)
        assert (vals[mask] != 0).mean() > 0.99


class TestSparseAttention:
    def test_forward_matches_dense_oracle(self):
        b, heads, s, e = 2, 4, 32, 32
        mask = causal_mask(s)
        attn = SparseAttention(
            num_heads=heads, embed_dim=e,
            score_topology=st.SparseTopology.from_dense_mask(mask),
        )
        x = init_uniform((b, s, e), seed=12)
        params = attn.init(jax.random.PRNGKey(1), jnp.asarray(x))
        y = attn.apply(params, jnp.asarray(x))
        assert y.shape == (b, s, e)
        assert not np.isnan(np.asarray(y)).any()

        # oracle: dense masked attention with the same projection weights
        def project(name, xx):
            p = params["params"][name]
            lt = SparseLinear.from_mask(np.ones((e, e)))  # dense-topo layer
            wd = lt.unpack_dense(p["values"])
            return xx @ wd.T + np.asarray(p["bias"])

        q = project("q_proj", x).reshape(b, s, heads, e // heads)
        k = project("k_proj", x).reshape(b, s, heads, e // heads)
        v = project("v_proj", x).reshape(b, s, heads, e // heads)
        q, k, v = (np.transpose(z, (0, 2, 1, 3)) for z in (q, k, v))
        logits = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(e // heads)
        logits = np.where(mask != 0, logits, -1e9)
        ee = np.exp(logits - logits.max(-1, keepdims=True))
        p = ee / ee.sum(-1, keepdims=True) * (mask != 0)
        ctx = np.einsum("bhqk,bhkd->bhqd", p, v)
        ctx = np.transpose(ctx, (0, 2, 1, 3)).reshape(b, s, e)
        ref = project("out_proj", ctx)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-3, atol=1e-3)

    def test_grads_flow_through_softmax(self):
        # the reference breaks grad flow at the softmax; ours must not
        b, heads, s, e = 2, 2, 16, 16
        attn = SparseAttention(
            num_heads=heads, embed_dim=e,
            score_topology=st.SparseTopology.from_dense_mask(causal_mask(s)),
        )
        x = jnp.asarray(init_uniform((b, s, e), seed=13))
        params = attn.init(jax.random.PRNGKey(2), x)
        g = jax.grad(lambda p: jnp.sum(attn.apply(p, x) ** 2))(params)
        leaves = jax.tree.leaves(g)
        assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
        # q/k projections receive nonzero grad ONLY via attention weights
        assert float(jnp.linalg.norm(g["params"]["q_proj"]["values"])) > 0
        assert float(jnp.linalg.norm(g["params"]["k_proj"]["values"])) > 0


class TestSparseTransformer:
    def _build(self, b=2, s=32, h=32, heads=4, layers=2, ffn=64):
        # driver.py scenario scaled down: causal masks + one fully-masked row
        mask = causal_mask(s)
        mask[1, :] = 0
        masks = np.broadcast_to(mask, (b, s, s)).copy()
        model = SparseTransformer.from_masks(
            masks, num_layers=layers, hidden_size=h, num_heads=heads,
            ffn_hidden_size=ffn,
        )
        x = jnp.asarray(init_uniform((b, s, h), seed=14))
        params = model.init(jax.random.PRNGKey(3), x)
        return model, params, x

    def test_forward_backward(self):
        model, params, x = self._build()
        y = model.apply(params, x)
        assert y.shape == x.shape
        assert np.isfinite(np.asarray(y)).all()
        g = jax.grad(lambda p: jnp.sum(model.apply(p, x)))(params)
        assert all(np.isfinite(np.asarray(l)).all() for l in jax.tree.leaves(g))

    def test_train_step_reduces_loss(self):
        model, params, x = self._build(layers=1)
        y_target = jnp.asarray(init_uniform(x.shape, seed=15))
        opt = optax.adam(1e-2)
        opt_state = opt.init(params)

        @jax.jit
        def step(params, opt_state):
            loss, g = jax.value_and_grad(
                lambda p: jnp.mean((model.apply(p, x) - y_target) ** 2)
            )(params)
            updates, opt_state = opt.update(g, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        losses = []
        for _ in range(5):
            params, opt_state, loss = step(params, opt_state)
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_gqa_forward_backward(self):
        """Grouped-query attention: fewer KV heads, same output shape,
        finite grads, and the QKV projection shrinks accordingly."""
        b, s, h, heads, kv = 2, 32, 32, 4, 2
        masks = np.broadcast_to(causal_mask(s), (b, s, s)).copy()
        model = SparseTransformer.from_masks(
            masks, num_layers=1, hidden_size=h, num_heads=heads,
            num_kv_heads=kv, ffn_hidden_size=64)
        x = jnp.asarray(init_uniform((b, s, h), seed=21))
        params = model.init(jax.random.PRNGKey(7), x)
        hd = h // heads
        kern = params["params"]["layer_0"]["self_attention"][
            "query_key_value"]["kernel"]
        assert kern.shape == (h, (heads + 2 * kv) * hd)
        y = model.apply(params, x)
        assert y.shape == x.shape
        assert np.isfinite(np.asarray(y)).all()
        g = jax.grad(lambda p: jnp.sum(model.apply(p, x)))(params)
        assert all(np.isfinite(np.asarray(l)).all()
                   for l in jax.tree.leaves(g))

    def test_gqa_equals_repeated_kv_mha(self):
        """A GQA core must equal full-head attention with K/V explicitly
        repeated across each group."""
        from sputnik_tpu.models.transformer import SparseCoreAttention
        from sputnik_tpu import many_mask as mm
        b, s, heads, kv, hd = 2, 32, 4, 2, 8
        masks = np.broadcast_to(causal_mask(s), (b, s, s)).copy()
        mt = mm.ManyMaskTopology.from_dense_masks(masks)
        rng = np.random.RandomState(5)
        q = jnp.asarray(rng.randn(b, s, heads, hd).astype(np.float32))
        k = jnp.asarray(rng.randn(b, s, kv, hd).astype(np.float32))
        v = jnp.asarray(rng.randn(b, s, kv, hd).astype(np.float32))
        core = SparseCoreAttention(mask_topology=mt, num_heads=heads,
                                   layout="panel")
        y_gqa = core.apply({}, q, k, v)
        y_rep = core.apply({}, q, jnp.repeat(k, heads // kv, axis=2),
                           jnp.repeat(v, heads // kv, axis=2))
        np.testing.assert_allclose(np.asarray(y_gqa), np.asarray(y_rep),
                                   atol=1e-6)

    def test_remat_same_outputs_and_grads(self):
        """Gradient checkpointing must not change the math: identical
        forward and gradients, identical parameter structure."""
        model, params, x = self._build(layers=2)
        model_r = model.clone(remat=True)
        y = model.apply(params, x)
        y_r = model_r.apply(params, x)  # same params tree fits both
        np.testing.assert_allclose(np.asarray(y_r), np.asarray(y),
                                   atol=1e-6)
        g = jax.grad(lambda p: jnp.sum(model.apply(p, x) ** 2))(params)
        g_r = jax.grad(lambda p: jnp.sum(model_r.apply(p, x) ** 2))(params)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g_r)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       atol=1e-5, rtol=1e-5)

    def test_residual_layernorm_variant(self):
        b, s, h = 2, 16, 16
        masks = np.broadcast_to(causal_mask(s), (b, s, s)).copy()
        model = SparseTransformer.from_masks(
            masks, num_layers=2, hidden_size=h, num_heads=2,
            ffn_hidden_size=32, activation="gelu",
            use_residual=True, use_layernorm=True,
        )
        x = jnp.asarray(init_uniform((b, s, h), seed=16))
        params = model.init(jax.random.PRNGKey(4), x)
        y = model.apply(params, x)
        assert np.isfinite(np.asarray(y)).all()


def test_gqa_flash_path_native_grouping():
    """The fused flash kernel groups KV natively (no repeat): parity vs
    explicitly repeated K/V through the same kernel, forward + grads,
    Triton kernels in interpret mode."""
    from sputnik_tpu import many_mask as mm
    from sputnik_tpu.models.transformer import SparseCoreAttention

    b, s, heads, kv, hd = 2, 128, 4, 2, 16
    masks = np.broadcast_to(causal_mask(s), (b, s, s)).copy()
    mt = mm.ManyMaskTopology.from_dense_masks(masks)
    rng = np.random.RandomState(6)
    q = jnp.asarray(rng.randn(b, s, heads, hd).astype(np.float32))
    k = jnp.asarray(rng.randn(b, s, kv, hd).astype(np.float32))
    v = jnp.asarray(rng.randn(b, s, kv, hd).astype(np.float32))
    core = SparseCoreAttention(mask_topology=mt, num_heads=heads,
                               layout="flash", flash_block=128,
                               flash_block_k=128)
    with interpret_kernels():
        y_gqa = core.apply({}, q, k, v)
        y_rep = core.apply({}, q, jnp.repeat(k, heads // kv, axis=2),
                           jnp.repeat(v, heads // kv, axis=2))
        gq, gk, gv = jax.grad(
            lambda a, b_, c: jnp.sum(core.apply({}, a, b_, c) ** 2),
            argnums=(0, 1, 2))(q, k, v)
    np.testing.assert_allclose(np.asarray(y_gqa), np.asarray(y_rep),
                               atol=1e-4)
    assert gk.shape == k.shape and gv.shape == v.shape
    assert all(np.isfinite(np.asarray(g)).all() for g in (gq, gk, gv))


def test_core_attention_xla_and_auto_layouts_match_panel():
    """layout='xla' (dense-masked, fully-fusable — the sub-crossover
    dispatch target) matches the kernel layouts bit-for-semantics,
    including the fully-masked-row zero convention and GQA; 'auto'
    resolves to it below the crossover."""
    from sputnik_tpu import many_mask as mm
    from sputnik_tpu.models import transformer as T

    rng = np.random.RandomState(3)
    b, s, heads, hd = 2, 64, 4, 16
    masks = np.stack([np.tril(np.ones((s, s), np.float32)),
                      (rng.rand(s, s) < 0.4).astype(np.float32)])
    masks[0, 5, :] = 0.0
    mt = mm.ManyMaskTopology.from_dense_masks(masks)
    q = jnp.asarray(rng.randn(b, s, heads, hd).astype(np.float32))
    k = jnp.asarray(rng.randn(b, s, heads, hd).astype(np.float32))
    v = jnp.asarray(rng.randn(b, s, heads, hd).astype(np.float32))

    out_p = T.SparseCoreAttention(mask_topology=mt, num_heads=heads,
                                  layout="panel").apply({}, q, k, v)
    out_x = jax.jit(lambda a, b_, c: T.SparseCoreAttention(
        mask_topology=mt, num_heads=heads, layout="xla").apply(
            {}, a, b_, c))(q, k, v)
    np.testing.assert_allclose(np.asarray(out_x), np.asarray(out_p),
                               atol=1e-4)
    # masked row -> zeros (the kernels' convention), not NaN
    row = np.asarray(out_x).reshape(b, s, heads * hd)[0, 5]
    assert np.abs(row).max() == 0.0

    out_a = T.SparseCoreAttention(mask_topology=mt, num_heads=heads,
                                  layout="auto").apply({}, q, k, v)
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(out_x),
                               atol=1e-6)  # auto == xla below crossover

    # GQA through the xla path
    kvh = heads // 2
    k2 = jnp.asarray(rng.randn(b, s, kvh, hd).astype(np.float32))
    v2 = jnp.asarray(rng.randn(b, s, kvh, hd).astype(np.float32))
    out_gx = T.SparseCoreAttention(mask_topology=mt, num_heads=heads,
                                   layout="xla").apply({}, q, k2, v2)
    out_gp = T.SparseCoreAttention(mask_topology=mt, num_heads=heads,
                                   layout="panel").apply(
        {}, q, jnp.repeat(k2, 2, axis=2), jnp.repeat(v2, 2, axis=2))
    np.testing.assert_allclose(np.asarray(out_gx), np.asarray(out_gp),
                               atol=1e-4)

    # grads flow (dense path is plain XLA autodiff)
    g = jax.grad(lambda a: jnp.sum(T.SparseCoreAttention(
        mask_topology=mt, num_heads=heads, layout="xla").apply(
            {}, a, k, v) ** 2))(q)
    assert bool(jnp.isfinite(g).all())
