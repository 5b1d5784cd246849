"""SparseMoE: routing semantics, dense-reference parity, gradients, and
expert parallelism (shard_map over the ep axis) on the 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

import sputnik_tpu as st
from sputnik_tpu.models.moe import SparseMoE

NDEV = 8


def _topos(rng, h=32, f=48, density=0.4):
    m_in = (rng.rand(f, h) < density).astype(np.float32)
    m_out = (rng.rand(h, f) < density).astype(np.float32)
    return (st.SparseTopology.from_dense_mask(m_in),
            st.SparseTopology.from_dense_mask(m_out))


def _dense_w(topo, values):
    t = topo
    out = np.zeros((t.m, t.n), np.float32)
    vals = np.asarray(values)
    out[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = vals[: t.nnz]
    return out


def _flatten_params(moe, params):
    """Panel-layout expert values -> flat CSR for the dense refs."""
    p = dict(params)
    p["w_in_values"] = moe.flat_values(params["w_in_values"], "in")
    p["w_out_values"] = moe.flat_values(params["w_out_values"], "out")
    return p


def _ref_moe(params, topo_in, topo_out, x, E, C):
    """Dense numpy reference of the top-1 routed forward."""
    xf = np.asarray(x).reshape(-1, x.shape[-1])
    Wr = np.asarray(params["router"]["kernel"])
    logits = xf @ Wr
    ex = np.exp(logits - logits.max(-1, keepdims=True))
    probs = ex / ex.sum(-1, keepdims=True)
    expert = probs.argmax(-1)
    gate = probs.max(-1)
    out = np.zeros_like(xf)
    counts = np.zeros(E, np.int64)
    for t in range(xf.shape[0]):
        e = int(expert[t])
        if counts[e] >= C:
            continue
        counts[e] += 1
        W1 = _dense_w(topo_in, params["w_in_values"][e])
        W2 = _dense_w(topo_out, params["w_out_values"][e])
        y = W2 @ jax.nn.gelu(W1 @ xf[t])
        out[t] = gate[t] * np.asarray(y)
    return out.reshape(x.shape)


def test_moe_matches_dense_reference():
    rng = np.random.RandomState(0)
    topo_in, topo_out = _topos(rng)
    E, b, s, h = 4, 2, 8, 32
    moe = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=E,
                    capacity_factor=1.5)
    x = jnp.asarray(rng.randn(b, s, h).astype(np.float32))
    params = moe.init(jax.random.PRNGKey(0), x)
    y = moe.apply(params, x)
    C = int(np.ceil(b * s / E * 1.5))
    ref = _ref_moe(_flatten_params(moe, params["params"]),
                   topo_in, topo_out, x, E, C)
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-4, rtol=1e-4)


def test_moe_grads_and_aux_loss():
    rng = np.random.RandomState(1)
    topo_in, topo_out = _topos(rng)
    moe = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=4)
    x = jnp.asarray(rng.randn(2, 8, 32).astype(np.float32))
    params = moe.init(jax.random.PRNGKey(0), x)

    def loss(p, x):
        y, inter = moe.apply(p, x, mutable=["intermediates"])
        aux = inter["intermediates"]["aux_loss"][0]
        return jnp.mean(y ** 2) + 0.01 * aux

    l, g = jax.jit(jax.value_and_grad(loss))(params, x)
    assert np.isfinite(float(l))
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(a)).all() for a in leaves)
    # expert values that received tokens must get nonzero grads
    gv = np.asarray(g["params"]["w_in_values"])
    assert np.abs(gv).max() > 0


def test_moe_expert_parallel_parity():
    devs = jax.devices()
    if len(devs) < NDEV:
        pytest.skip(f"need {NDEV} devices")
    mesh = Mesh(np.array(devs[:NDEV]), ("ep",))
    rng = np.random.RandomState(2)
    topo_in, topo_out = _topos(rng)
    E, b, s, h = 8, 2, 16, 32
    x = jnp.asarray(rng.randn(b, s, h).astype(np.float32))

    moe1 = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=E)
    params = moe1.init(jax.random.PRNGKey(0), x)
    ref = moe1.apply(params, x)

    moe_ep = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=E,
                       mesh=mesh, axis="ep")
    got = jax.jit(lambda p, x: moe_ep.apply(p, x))(params, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)

    # gradients through the expert-parallel path
    def loss(p, x):
        return jnp.mean(moe_ep.apply(p, x) ** 2)

    g = jax.jit(jax.grad(loss))(params, x)

    def loss1(p, x):
        return jnp.mean(moe1.apply(p, x) ** 2)

    g1 = jax.grad(loss1)(params, x)
    for a, b_ in zip(jax.tree_util.tree_leaves(g),
                     jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   atol=1e-5, rtol=1e-4)


def test_moe_bf16_routing_exact_past_256():
    """bf16 inputs with capacity > 256: routing positions must stay
    exact (a bf16 cumsum rounds 257 -> 258, silently colliding capacity
    slots and summing two tokens' inputs). One expert, 600 tokens: the
    bf16 forward must match the f32 forward's routing bit-for-bit."""
    rng = np.random.RandomState(7)
    topo_in, topo_out = _topos(rng)
    E, T, h = 1, 600, 32
    moe = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=E,
                    capacity_factor=1.25)  # C = 750 > 256
    x32 = jnp.asarray(rng.randn(1, T, h).astype(np.float32))
    params = moe.init(jax.random.PRNGKey(0), x32)
    y32 = moe.apply(params, x32)
    y16 = moe.apply(params, x32.astype(jnp.bfloat16))
    # bf16 matmuls differ in rounding, but a routing collision changes
    # outputs by O(1) (two tokens share a slot; inputs sum) — a loose
    # elementwise bound separates rounding noise from mis-routing
    d = np.abs(np.asarray(y16, np.float32) - np.asarray(y32))
    scale = np.abs(np.asarray(y32)).max() + 1e-6
    assert (d / scale).max() < 0.15, (d / scale).max()


def _ref_moe_top2(params, topo_in, topo_out, x, E, C):
    """Dense numpy reference of top-2 routing: renormalised gates, second
    choices queued behind all first choices (GShard offset)."""
    xf = np.asarray(x).reshape(-1, x.shape[-1])
    Wr = np.asarray(params["router"]["kernel"])
    logits = xf @ Wr
    ex = np.exp(logits - logits.max(-1, keepdims=True))
    probs = ex / ex.sum(-1, keepdims=True)
    e1 = probs.argmax(-1)
    g1 = probs.max(-1)
    p2 = probs.copy()
    p2[np.arange(len(e1)), e1] = 0.0
    e2 = p2.argmax(-1)
    g2 = p2.max(-1)
    denom = np.maximum(g1 + g2, 1e-9)
    g1n, g2n = g1 / denom, g2 / denom
    Ws = [(_dense_w(topo_in, params["w_in_values"][e]),
           _dense_w(topo_out, params["w_out_values"][e]))
          for e in range(E)]

    def y(e, t):
        W1, W2 = Ws[e]
        return np.asarray(W2 @ jax.nn.gelu(W1 @ xf[t]))

    out = np.zeros_like(xf)
    c1 = np.zeros(E, np.int64)
    for t in range(xf.shape[0]):
        e = int(e1[t])
        if c1[e] < C:
            out[t] += g1n[t] * y(e, t)
        c1[e] += 1
    cnt1 = np.bincount(e1, minlength=E)
    c2 = np.zeros(E, np.int64)
    for t in range(xf.shape[0]):
        e = int(e2[t])
        if cnt1[e] + c2[e] < C:
            out[t] += g2n[t] * y(e, t)
        c2[e] += 1
    return out.reshape(x.shape)


def test_moe_top2_matches_dense_reference():
    rng = np.random.RandomState(3)
    topo_in, topo_out = _topos(rng)
    E, b, s, h = 4, 2, 8, 32
    moe = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=E,
                    top_k=2, capacity_factor=1.25)
    x = jnp.asarray(rng.randn(b, s, h).astype(np.float32))
    params = moe.init(jax.random.PRNGKey(0), x)
    y = moe.apply(params, x)
    C = int(np.ceil(b * s / E * 2 * 1.25))
    ref = _ref_moe_top2(_flatten_params(moe, params["params"]),
                        topo_in, topo_out, x, E, C)
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-4, rtol=1e-4)


def test_moe_top2_overflow_sheds_second_choices():
    """With capacity_factor small enough that an expert overflows, every
    shed contribution must be a SECOND choice (GShard offset): the output
    still contains each token's first-choice contribution whenever its
    first choice fit."""
    rng = np.random.RandomState(4)
    topo_in, topo_out = _topos(rng)
    E, T, h = 2, 16, 32
    x = jnp.asarray(rng.randn(1, T, h).astype(np.float32))
    # capacity C = ceil(16/2 * 2 * 0.5) = 8 < 16 first+second choices/expert
    moe = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=E,
                    top_k=2, capacity_factor=0.5)
    params = moe.init(jax.random.PRNGKey(0), x)
    y = moe.apply(params, x)
    C = int(np.ceil(T / E * 2 * 0.5))
    ref = _ref_moe_top2(_flatten_params(moe, params["params"]),
                        topo_in, topo_out, x, E, C)
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-4, rtol=1e-4)
    assert np.abs(np.asarray(y)).max() > 0


def test_moe_top2_grads_and_ep_parity():
    devs = jax.devices()
    if len(devs) < NDEV:
        pytest.skip(f"need {NDEV} devices")
    mesh = Mesh(np.array(devs[:NDEV]), ("ep",))
    rng = np.random.RandomState(5)
    topo_in, topo_out = _topos(rng)
    E, b, s, h = 8, 2, 16, 32
    x = jnp.asarray(rng.randn(b, s, h).astype(np.float32))
    moe1 = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=E,
                     top_k=2)
    params = moe1.init(jax.random.PRNGKey(0), x)
    ref = moe1.apply(params, x)
    moe_ep = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=E,
                       top_k=2, mesh=mesh, axis="ep")
    got = jax.jit(lambda p, xx: moe_ep.apply(p, xx))(params, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    g = jax.jit(jax.grad(
        lambda p, xx: jnp.mean(moe_ep.apply(p, xx) ** 2)))(params, x)
    g1 = jax.grad(
        lambda p, xx: jnp.mean(moe1.apply(p, xx) ** 2))(params, x)
    for a, b_ in zip(jax.tree_util.tree_leaves(g),
                     jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   atol=1e-5, rtol=1e-4)
    assert np.abs(np.asarray(g["params"]["w_in_values"])).max() > 0


def test_moe_transformer_interleaved():
    """Switch-style interleave: every 2nd layer's MLP is a SparseMoE with
    its OWN router + expert values; dense layers keep the plain MLP;
    gradients flow to both; serving decoders reject the model."""
    import jax
    from sputnik_tpu.models.transformer import SparseTransformer

    rng = np.random.RandomState(0)
    b, s, h, f = 2, 16, 32, 48
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    topo_in, topo_out = _topos(rng)
    moe = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=4,
                    top_k=2)
    model = SparseTransformer.from_masks(
        masks, num_layers=4, hidden_size=h, num_heads=2,
        ffn_hidden_size=f, use_residual=True, use_layernorm=True,
        activation="gelu", moe=moe, moe_every=2)
    x = jnp.asarray(rng.randn(b, s, h).astype(np.float32))
    params = model.init(jax.random.PRNGKey(0), x)

    for i in (1, 3):      # MoE layers
        lp = params["params"][f"layer_{i}"]["mlp"]
        assert "router" in lp and "w_in_values" in lp
    for i in (0, 2):      # dense layers
        assert "to_4h" in params["params"][f"layer_{i}"]["mlp"]
    # per-layer experts are INDEPENDENT parameters
    w1 = np.asarray(params["params"]["layer_1"]["mlp"]["w_in_values"])
    w3 = np.asarray(params["params"]["layer_3"]["mlp"]["w_in_values"])
    assert not np.array_equal(w1, w3)

    y = model.apply(params, x)
    assert np.isfinite(np.asarray(y)).all()
    g = jax.grad(lambda p: jnp.sum(model.apply(p, x) ** 2))(params)
    for i in (1, 3):
        gv = np.asarray(g["params"][f"layer_{i}"]["mlp"]["w_in_values"])
        assert np.isfinite(gv).all() and np.abs(gv).sum() > 0
    g0 = np.asarray(
        g["params"]["layer_0"]["mlp"]["to_4h"]["kernel"])
    assert np.abs(g0).sum() > 0

    # moe_every without a module is a clear error
    bad = SparseTransformer.from_masks(
        masks, num_layers=2, hidden_size=h, num_heads=2,
        ffn_hidden_size=f, moe_every=2)
    with pytest.raises(ValueError, match="no moe module"):
        bad.init(jax.random.PRNGKey(0), x)

    # serving decoders reject MoE models
    from sputnik_tpu.models.serving import SparseDecoder
    with pytest.raises(ValueError, match="training-side"):
        SparseDecoder(model, s_max=32, bk=8)


def test_moe_transformer_ep_sharded():
    """ep-sharded MoE inside the transformer on the 8-device mesh equals
    the unsharded model (same init seed -> same params)."""
    import jax
    from jax.sharding import Mesh
    from sputnik_tpu.models.transformer import SparseTransformer

    if len(jax.devices()) < 4:
        pytest.skip("need 4 devices")
    rng = np.random.RandomState(1)
    b, s, h, f = 2, 16, 32, 48
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    topo_in, topo_out = _topos(rng)
    x = jnp.asarray(rng.randn(b, s, h).astype(np.float32))

    def build(mesh):
        moe = SparseMoE(topo_in=topo_in, topo_out=topo_out,
                        num_experts=4, top_k=1, mesh=mesh, axis="ep")
        return SparseTransformer.from_masks(
            masks, num_layers=2, hidden_size=h, num_heads=2,
            ffn_hidden_size=f, use_residual=True, use_layernorm=True,
            activation="gelu", moe=moe, moe_every=2)

    m1 = build(None)
    p = m1.init(jax.random.PRNGKey(0), x)
    y1 = m1.apply(p, x)
    mesh = Mesh(np.array(jax.devices()[:4]), ("ep",))
    m2 = build(mesh)
    y2 = m2.apply(p, x)
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y1),
                               atol=1e-5)


def test_moe_lm_trains():
    """SparseLM with an MoE-interleaved core: token-level fwd + grad."""
    import jax
    from sputnik_tpu.models.lm import SparseLM

    rng = np.random.RandomState(2)
    b, s, h, f, V = 2, 16, 32, 48, 64
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    topo_in, topo_out = _topos(rng)
    moe = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=4,
                    top_k=2)
    lm = SparseLM.from_masks(
        masks, vocab_size=V, num_layers=2, hidden_size=h, num_heads=2,
        ffn_hidden_size=f, use_residual=True, use_layernorm=True,
        activation="gelu", moe=moe, moe_every=2)
    toks = jnp.asarray(rng.randint(0, V, (b, s)))
    params = lm.init(jax.random.PRNGKey(0), toks)
    logits = lm.apply(params, toks)
    assert logits.shape == (b, s, V)

    def loss(p):
        lg = lm.apply(p, toks)
        return -jnp.mean(jax.nn.log_softmax(lg)[..., 0])

    g = jax.grad(loss)(params)
    gv = np.asarray(
        g["params"]["core"]["layer_1"]["mlp"]["w_in_values"])
    assert np.isfinite(gv).all() and np.abs(gv).sum() > 0


def test_ep_bank_tiles_resolved_once_with_param_expert_count(monkeypatch):
    """The kernel tiles must be resolved ONCE with the param-owning
    expert count E: the ep-local compute must NOT pick different tiles
    than the params were created with (panel-shape mismatch), here under
    a non-default tile table."""
    import jax
    from jax.sharding import Mesh

    from sputnik_tpu.models import moe as moe_mod

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")

    orig = moe_mod._bank_tiles

    def tiles_by_nrep(topo, n_rep=0):
        # adversarial: local expert counts get DIFFERENT tiles
        return (16, 64) if n_rep >= 4 else (32, 128)

    monkeypatch.setattr(moe_mod, "_bank_tiles", tiles_by_nrep)

    rng = np.random.RandomState(0)
    h, f, E = 64, 128, 4
    ti = st.SparseTopology.from_dense_mask(
        (rng.rand(f, h) < 0.4).astype(np.float32))
    to = st.SparseTopology.from_dense_mask(
        (rng.rand(h, f) < 0.4).astype(np.float32))
    mesh = Mesh(np.array(jax.devices()[:2]), ("ep",))
    m = moe_mod.SparseMoE(topo_in=ti, topo_out=to, num_experts=E,
                          mesh=mesh, axis="ep")
    x = jnp.asarray(rng.randn(2, 8, h).astype(np.float32))
    params = m.init(jax.random.PRNGKey(0), x)
    y = m.apply(params, x)          # would crash on a tile mismatch
    assert np.isfinite(np.asarray(y)).all()

    # parity with the unsharded module under the SAME tile table
    m1 = moe_mod.SparseMoE(topo_in=ti, topo_out=to, num_experts=E)
    y1 = m1.apply(params, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y1), atol=1e-4)
    monkeypatch.setattr(moe_mod, "_bank_tiles", orig)
