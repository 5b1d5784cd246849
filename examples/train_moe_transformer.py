"""Train a Switch-style MoE sparse transformer end to end.

Composes the round-4 pieces: every 2nd layer's MLP is a
``SparseMoE`` (top-2 router, CSR-sparse expert FFNs running the
panel-native batched expert bank), the other layers keep the dense-in /
dense-out MLP, attention is the fused sparse-flash path. The router's
GShard aux loss is collected through flax ``intermediates`` and added to
the objective — the standard load-balance recipe.

Self-checks: loss decreases, aux loss is finite, expert values receive
gradients on every MoE layer.

Run:  python examples/train_moe_transformer.py [--small] [--steps N]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--aux-weight", type=float, default=0.01)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    import sputnik_tpu as st
    from sputnik_tpu.models.moe import SparseMoE
    from sputnik_tpu.models.transformer import SparseTransformer

    on_gpu = jax.default_backend() == "gpu"
    if args.small or not on_gpu:
        b, s, h, f, layers, heads, E = 2, 64, 32, 48, 4, 2, 4
    else:
        b, s, h, f, layers, heads, E = 4, 512, 512, 2048, 6, 8, 8

    rng = np.random.RandomState(0)
    masks = np.broadcast_to(np.tril(np.ones((s, s), np.float32)),
                            (b, s, s)).copy()
    topo_in = st.SparseTopology.from_dense_mask(
        (rng.rand(f, h) < 0.3).astype(np.float32))
    topo_out = st.SparseTopology.from_dense_mask(
        (rng.rand(h, f) < 0.3).astype(np.float32))
    moe = SparseMoE(topo_in=topo_in, topo_out=topo_out, num_experts=E,
                    top_k=2)
    model = SparseTransformer.from_masks(
        masks, num_layers=layers, hidden_size=h, num_heads=heads,
        ffn_hidden_size=f, use_residual=True, use_layernorm=True,
        activation="gelu", moe=moe, moe_every=2)

    x = jnp.asarray(rng.randn(b, s, h).astype(np.float32) * 0.5)
    y = jnp.asarray(rng.randn(b, s, h).astype(np.float32) * 0.5)
    params = model.init(jax.random.PRNGKey(0), x)
    tx = optax.adam(1e-3)
    opt = tx.init(params)

    def loss_fn(p, xx, yy):
        out, mods = model.apply(p, xx, mutable=["intermediates"])
        mse = jnp.mean((out - yy) ** 2)
        # GShard router aux loss, summed over the MoE layers
        aux = sum(jnp.sum(jnp.asarray(v)) for v in jax.tree.leaves(
            mods["intermediates"]))
        return mse + args.aux_weight * aux, (mse, aux)

    @jax.jit
    def step(p, o, xx, yy):
        (l, (mse, aux)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(p, xx, yy)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, mse, aux, g

    first = None
    for t in range(args.steps):
        params, opt, mse, aux, g = step(params, opt, x, y)
        if first is None:
            first = float(mse)
            # expert values get gradients on every MoE layer, step 1
            for i in range(1, layers, 2):
                gv = np.asarray(
                    g["params"][f"layer_{i}"]["mlp"]["w_in_values"])
                assert np.isfinite(gv).all() and np.abs(gv).sum() > 0, i
        assert np.isfinite(float(aux)), f"aux loss blew up at {t}"
    last = float(mse)
    print(f"mse {first:.4f} -> {last:.4f} over {args.steps} steps; "
          f"aux {float(aux):.4f}")
    assert last < first, "loss did not decrease"
    print("OK: MoE transformer trains (per-layer experts, aux loss wired)")


if __name__ == "__main__":
    main()
