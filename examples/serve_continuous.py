"""Continuous batching: ragged decode + slot admission.

A miniature serving loop over ``SparseDecoder.decode_step_ragged``:
requests arrive over time, each slot decodes until its own budget is
exhausted, finished slots are retired and immediately re-admitted with
the next queued request via ``decode.insert_kv_slot`` (a batch=1
prefill copied into the slot's cache rows — one ``dynamic_update_slice``
per buffer, so admission jits into the loop).

The reference framework has no serving path at all; uniform-batch
serving is ``examples/generate.py``. This example is the ragged
generalisation a multi-tenant deployment needs: sequences at different
positions batched in one step, no padding to the longest request.

Run:  python examples/serve_continuous.py [--small]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sputnik_tpu.models.serving import SparseDecoder
    from sputnik_tpu.models.transformer import SparseTransformer
    from sputnik_tpu.ops.decode import insert_kv_slot

    on_gpu = jax.default_backend() == "gpu"
    if args.small or not on_gpu:
        slots, P, h, heads, layers, ffn, bk = 2, 64, 128, 4, 2, 256, 32
    else:
        slots, P, h, heads, layers, ffn, bk = 4, 512, 1024, 8, 6, 4096, 512
    s_max = 2 * P

    def causal(b):
        return np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                               (b, P, P)).copy()

    def model(b):
        return SparseTransformer.from_masks(
            causal(b), num_layers=layers, hidden_size=h, num_heads=heads,
            ffn_hidden_size=ffn, use_residual=True, use_layernorm=True,
            activation="gelu")

    rng = np.random.RandomState(0)
    params = model(1).init(jax.random.PRNGKey(0),
                           jnp.zeros((1, P, h), jnp.float32))

    # request queue: prompts with per-request decode budgets
    n_requests = 2 * slots
    budgets = rng.randint(3, 9, n_requests)
    prompts = [jnp.asarray(rng.randn(1, P, h).astype(np.float32) * 0.3)
               for _ in range(n_requests)]

    dec = SparseDecoder(model(slots), s_max=s_max, bk=bk,
                        cache_dtype=jnp.bfloat16)
    dec1 = SparseDecoder(model(1), s_max=s_max, bk=bk,
                         cache_dtype=jnp.bfloat16)
    step = jax.jit(dec.decode_step_ragged)
    prefill1 = jax.jit(dec1.prefill)

    def admit(caches, x, slot, prompt):
        """Prefill the new request alone, copy its cache rows into the
        slot, and seed the slot's next input with the prompt's LAST
        output activation (a real LM samples a token from it and embeds
        that instead)."""
        y1, c1 = prefill1(params, prompt, dec1.init_caches(1))
        caches = tuple(insert_kv_slot(c, cc, slot, kv_heads=dec.kv_heads)
                       for c, cc in zip(caches, c1))
        return caches, x.at[slot].set(y1[0, -1:])

    # boot: admit the first `slots` requests
    caches = dec.init_caches(slots)
    slot_req = list(range(slots))
    remaining = [int(budgets[r]) for r in slot_req]
    x = jnp.zeros((slots, 1, h), jnp.float32)
    for s in range(slots):
        caches, x = admit(caches, x, s, prompts[s])
    next_req = slots
    done = 0
    t0 = time.perf_counter()
    steps = 0
    while done < n_requests:
        active = np.array([r >= 0 and remaining[s] > 0
                           for s, r in enumerate(slot_req)])
        if not active.any():
            break
        y, caches = step(params, x, caches, jnp.asarray(active))
        x = y  # feed activations back (a real LM samples + embeds here)
        steps += 1
        for s in range(slots):
            if active[s]:
                remaining[s] -= 1
                if remaining[s] == 0:
                    done += 1
                    print(f"  slot {s}: request {slot_req[s]} finished "
                          f"({int(budgets[slot_req[s]])} tokens)")
                    if next_req < n_requests:
                        caches, x = admit(caches, x, s, prompts[next_req])
                        slot_req[s] = next_req
                        remaining[s] = int(budgets[next_req])
                        next_req += 1
                    else:
                        slot_req[s] = -1
    jax.block_until_ready(x)
    dt = time.perf_counter() - t0
    print(f"served {n_requests} requests ({int(budgets.sum())} tokens) in "
          f"{steps} ragged steps, {dt:.2f}s wall")
    assert done == n_requests


if __name__ == "__main__":
    main()
