"""Block-structured dynamic sparse training: whole-tile RigL.

Element-granular RigL converges to element-random patterns whose block
occupancy is ~1.0 at kernel tile sizes — the kernels then do dense FLOPs
through sparse bookkeeping. This loop keeps the pattern BLOCK-dense:

  * seed with ``patterns.block_random_topology`` (whole ``(bm, bk)``
    tiles on or off, tiles == the kernel tiles);
  * train a panel-layout :class:`SparseLinear` with Adam;
  * every ``--update-every`` steps run
    ``training.block_rigl_update``: drop the lowest-``sum|w|`` occupied
    tiles, grow the empty tiles with the largest ``sum|dense grad|``
    (grown tiles enter fully dense at 0) — ``nnz``/``nnz_pad`` are
    exactly preserved, so params and Adam moments keep their shapes
    (``remap_values`` carries them; only a retrace is paid).

Self-checks: the pattern stays block-dense through every update, and
the evolved pattern trains to a LOWER loss than the same run with its
initial pattern frozen. Staying block-dense is what lets the kernels skip
work: their time scales with block occupancy, not element density.

Run:  python examples/train_block_sparse.py [--small]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(evolve: bool, args, seed=0):
    import jax
    import jax.numpy as jnp
    import optax

    from sputnik_tpu.models import SparseLinear
    from sputnik_tpu.ops import panel_api as PA
    from sputnik_tpu.patterns import block_random_topology
    from sputnik_tpu.training import (block_occupancy, block_rigl_update,
                                      dense_linear_grad, remap_values)

    if args.small:
        m = n = 256
        bm, bk = 16, 128
        steps, upd = 120, 30
        batch = 64
    else:
        m = n = 1024
        bm, bk = 128, 128
        steps, upd = 400, args.update_every
        batch = 256

    rng = np.random.RandomState(seed)
    topo = block_random_topology(m, n, bm, bk, density=args.density,
                                 seed=seed)
    layer = SparseLinear(topology=topo, use_bias=True)
    # the TRUE weight is itself block-sparse on a DIFFERENT support:
    # a frozen wrong pattern cannot fit it, an evolved one can migrate
    # its tiles toward the true support through the dense gradient —
    # connectivity is what's being learned
    from sputnik_tpu.patterns import block_random_mask

    w_true = (block_random_mask(m, n, bm, bk, density=args.density,
                                seed=seed + 100)
              * rng.randn(m, n).astype(np.float32) * 0.3)
    wt = jnp.asarray(w_true)
    x0 = jnp.asarray(rng.randn(batch, n).astype(np.float32))
    variables = layer.init(jax.random.PRNGKey(seed), x0)
    tx = optax.adam(3e-2)
    opt = tx.init(variables["params"])

    def make_step(lyr):
        @jax.jit
        def step(p, o, key):
            # FRESH batch per step: with a fixed small batch any support
            # interpolates the dataset; generalisation to the input
            # distribution is what requires the right tiles
            x_ = jax.random.normal(key, (batch, n))
            y_ = x_ @ wt.T

            def loss(pp):
                return jnp.mean((lyr.apply({"params": pp}, x_) - y_) ** 2)

            l, g = jax.value_and_grad(loss)(p)
            u, o2 = tx.update(g, o, p)
            return optax.apply_updates(p, u), o2, l

        return step

    step = make_step(layer)
    params = variables["params"]
    key = jax.random.PRNGKey(seed + 1)
    x = x0
    y = x @ wt.T
    last = None
    for t in range(steps):
        key, k1 = jax.random.split(key)
        params, opt, last = step(params, opt, k1)
        if evolve and (t + 1) % upd == 0 and t + 1 < steps:
            spec = layer.spec()
            flat = PA.panel_to_values_np(
                layer.topology, np.asarray(params["values"]), spec.bm,
                spec.bk) if layer.layout == "panel" else np.asarray(
                    params["values"])
            gy = 2 * (layer.apply({"params": params}, x) - y) / y.size
            gd = dense_linear_grad(x, gy)
            new_topo, new_flat = block_rigl_update(
                layer.topology, flat, gd, bm=bm, bk=bk, fraction=0.25)
            occ = block_occupancy(new_topo, bm, bk)
            assert set(np.unique(occ)) <= {0, bm * bk}, "left block-dense!"
            # carry Adam moments onto the new pattern (grown slots 0)
            mu, nu = opt[0].mu, opt[0].nu

            def carry(leaf):
                f = PA.panel_to_values_np(
                    layer.topology, np.asarray(leaf), spec.bm, spec.bk)
                r = remap_values(layer.topology, new_topo, f)
                return jnp.asarray(PA.values_to_panel_np(
                    new_topo, r, spec.bm, spec.bk))

            mu = dict(mu, values=carry(mu["values"]))
            nu = dict(nu, values=carry(nu["values"]))
            opt = (opt[0]._replace(mu=mu, nu=nu),) + tuple(opt[1:])

            layer = layer.clone(topology=new_topo)
            params = dict(params, values=jnp.asarray(
                PA.values_to_panel_np(new_topo, new_flat, spec.bm,
                                      spec.bk)))
            step = make_step(layer)
    # held-out eval: the distributional loss, not the last minibatch
    xe = jnp.asarray(np.random.RandomState(seed + 7).randn(
        4 * batch, n).astype(np.float32))
    return float(jnp.mean((layer.apply({"params": params}, xe)
                           - xe @ wt.T) ** 2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--update-every", type=int, default=50)
    args = ap.parse_args()

    evolved = run(True, args)
    frozen = run(False, args)
    print(f"final loss  evolved={evolved:.5f}  frozen={frozen:.5f}")
    assert evolved < frozen, (
        f"block-RigL should out-train the frozen pattern "
        f"({evolved} vs {frozen})")
    print("OK: block-RigL evolved pattern out-trains the frozen one, "
          "staying block-dense throughout")


if __name__ == "__main__":
    main()
