"""Paged serving: page-pool KV, prefix caching, eviction without copies.

A miniature multi-tenant loop over ``PagedDecoder``: several requests
share one SYSTEM PROMPT — its KV pages are prefilled once and
refcount-shared into every new slot (``share_prefix``); slots decode
raggedly, finished slots release their pages back to the pool, and the
loop reports how much pool HBM the paged layout used vs the contiguous
per-slot reservation.

The reference framework has no serving path at all; contiguous-cache
serving is ``examples/generate.py`` / ``serve_continuous.py``. This is
the memory model a production pool needs: HBM scales with tokens
actually written (plus < 1 page per replica), not with ``slots x
s_max``.

Run:  python examples/serve_paged.py [--small]
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
    import jax.numpy as jnp

    from sputnik_tpu.models.serving_paged import PagedDecoder
    from sputnik_tpu.models.transformer import SparseTransformer

    on_gpu = jax.default_backend() == "gpu"
    if args.small or not on_gpu:
        slots, P, h, heads, layers, ffn, bk = 2, 128, 64, 2, 2, 96, 128
        n_new = 4
    else:
        slots, P, h, heads, layers, ffn, bk = 4, 1024, 1024, 8, 6, 4096, 256
        n_new = 32
    s_max = P + ((n_new + bk - 1) // bk) * bk
    cache_dtype = jnp.bfloat16 if on_gpu else jnp.float32

    masks = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                            (slots, P, P)).copy()
    model = SparseTransformer.from_masks(
        masks, num_layers=layers, hidden_size=h, num_heads=heads,
        ffn_hidden_size=ffn, use_residual=True, use_layernorm=True,
        activation="gelu")
    rng = np.random.RandomState(0)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((slots, P, h)))

    # one shared system prompt for everyone
    system = rng.randn(1, P, h).astype(np.float32) * 0.3
    prompts = jnp.asarray(np.repeat(system, slots, 0))

    # pool sized for: the shared prefix (once!) + decode tails per slot
    prefix_pages = (P // bk) * slots * heads          # worst case no share
    dec = PagedDecoder(model, n_pages=prefix_pages + slots * heads * 2,
                       s_max=s_max, bk=bk, cache_dtype=cache_dtype)
    caches = dec.init_caches(slots)

    # prefill slot 0 only; every other slot shares its prefix pages
    lengths = jnp.asarray([P] + [0] * (slots - 1))
    _, caches = dec.prefill(params, prompts, caches, lengths=lengths)
    for s in range(1, slots):
        caches = dec.release(caches, s)   # drop the dummy prefill pages
        caches = dec.share_prefix(caches, src=0, dst=s, n_tokens=P)
    shared_free = dec.free_pages[0]
    print(f"prefix shared into {slots} slots; layer-0 pool: "
          f"{dec.pools[0].n_pages - shared_free} pages live "
          f"(vs {slots * (P // bk) * heads} unshared)")
    assert (dec.pools[0].n_pages - shared_free
            == (P // bk) * heads), "prefix pages must be stored once"

    # ragged decode: slot s wants n_new - s tokens
    budgets = np.array([n_new - s for s in range(slots)])
    step = jax.jit(dec.decode_step)
    tok = jnp.asarray(rng.randn(slots, 1, h).astype(np.float32) * 0.3)
    done_at = {}
    x = tok
    for t in range(int(budgets.max())):
        act = budgets > t
        caches = dec.reserve(caches, 1)
        y, caches = step(params, x, caches, active=jnp.asarray(act))
        x = y
        for s in range(slots):
            if budgets[s] == t + 1:
                done_at[s] = t + 1
    kv = np.asarray(caches[0].kv_len)
    for s in range(slots):
        assert kv[s * heads] == P + budgets[s], (s, kv[s * heads])
    assert np.isfinite(np.asarray(y)).all()

    # retire everyone; the pool must drain completely (refcounts!)
    for s in range(slots):
        caches = dec.release(caches, s)
    assert dec.free_pages[0] == dec.pools[0].n_pages, "leaked pages"
    print(f"all {slots} slots finished ({done_at}); pool fully drained")
    print("OK")


if __name__ == "__main__":
    main()
