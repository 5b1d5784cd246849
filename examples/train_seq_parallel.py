"""Sequence-parallel training: long context split across a device mesh.

A miniature training loop whose ATTENTION runs sequence-parallel — each
device owns a band of query rows and a band of K/V rows:

  * banded (local-window) topology -> `flash_attention_kv_sharded`
    (halo exchange, psum-free backward; comm constant in context length);
  * full-causal topology -> `ring_flash_attention` (K/V bands rotate,
    psum-free two-pass backward; peak per-device K/V is one band).

Both paths take one `jax.grad` through the sharded kernels and train a
toy regression; the example asserts the loss drops and that the two
attention flavours agree with their dense oracle at init.

Run:  python examples/train_seq_parallel.py [--small]
(uses up to 8 local devices; on one device the schedules degenerate
gracefully.)
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import jax

    # request 8 CPU devices BEFORE anything initializes a backend
    # (jax.default_backend() itself would initialize one and make this
    # update a silent no-op); harmless on a GPU backend.
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except Exception:
        pass  # backend already up (e.g. under pytest's conftest flags)
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import sputnik_tpu as st
    from sputnik_tpu.parallel import (
        RingFlashSpec, RowPartition, ShardedFlashSpec,
        flash_attention_kv_sharded, ring_flash_attention)
    from sputnik_tpu.patterns import causal_topology

    ndev = min(8, len(jax.devices()))
    on_gpu = jax.default_backend() == "gpu"
    if args.small or not on_gpu:
        s, hd, R, bm, bk, steps = ndev * 128, 16, 2, 8, 128, 4
    else:
        s, hd, R, bm, bk, steps = ndev * 2048, 64, 4, 64, 64, 4
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("sp",))
    n_loc = s // ndev
    rng = np.random.RandomState(0)

    def shard(a, n):
        return jnp.asarray(a.reshape(n, ndev, n_loc, hd)
                           .transpose(1, 0, 2, 3))

    # --- banded topology through the halo path ------------------------------
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    band = ((j <= i) & (j > i - max(s // 8, bk))).astype(np.float32)
    bpart = RowPartition(st.SparseTopology.from_dense_mask(band), ndev,
                         bm=bm, balance=False)
    bspec = ShardedFlashSpec(bpart, bm=bm, bk=bk, mesh=mesh, axis="sp")

    # --- full-causal topology through the ring ------------------------------
    rpart = RowPartition(causal_topology(s), ndev, bm=bm, balance=False)
    rspec = RingFlashSpec(rpart, bm=bm, bk=bk, mesh=mesh, axis="sp")

    x = rng.randn(R, s, hd).astype(np.float32) * 0.5
    target = np.roll(x, 1, axis=1)  # predict the previous position
    x_sh, t_sh = shard(x, R), shard(target, R)

    def dense_ref(mask, q, k, v):
        sc = np.einsum("rqd,rkd->rqk", q, k) / np.sqrt(hd)
        sc = np.where(mask != 0, sc, -1e30)
        e = np.exp(sc - sc.max(-1, keepdims=True)) * (mask != 0)
        w = e / np.maximum(e.sum(-1, keepdims=True), 1e-30)
        return np.einsum("rqk,rkd->rqd", w, v)

    for name, attn, mask in (
        ("halo/banded", lambda w, xx: flash_attention_kv_sharded(
            bspec, xx * w["q"], xx * w["k"], xx * w["v"]), band),
        ("ring/causal", lambda w, xx: ring_flash_attention(
            rspec, xx * w["q"], xx * w["k"], xx * w["v"]), None),
    ):
        w = {k: jnp.ones(()) for k in ("q", "k", "v")}

        # oracle check at init (unit weights)
        out = np.asarray(jax.jit(attn)(w, x_sh))
        got = out.transpose(1, 0, 2, 3).reshape(R, s, hd)
        m = mask if mask is not None else np.tril(np.ones((s, s),
                                                          np.float32))
        ref = dense_ref(np.broadcast_to(m, (R, s, s)), x, x, x)
        err = np.abs(got - ref).max()
        tol = 5e-2 if on_gpu else 1e-3
        assert err < tol, (name, err)

        @jax.jit
        def loss_fn(w, xx, tt):
            y = attn(w, xx)
            return jnp.mean((y - tt) ** 2)

        grad_fn = jax.jit(jax.value_and_grad(loss_fn))
        losses = []
        for step in range(steps):
            l, g = grad_fn(w, x_sh, t_sh)
            w = jax.tree.map(lambda p, gg: p - 0.5 * gg, w, g)
            losses.append(float(l))
        assert losses[-1] < losses[0], (name, losses)
        print(f"{name}: oracle err {err:.2e}, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps")
    print("OK")


if __name__ == "__main__":
    main()
