"""Serving benchmarks: decode throughput across the runtime's modes.

Times the block-KV decode loop (lax.scan over ``decode_step``) on a
6-layer model for: bf16 vs int8 KV caches, uniform vs ragged step, GQA,
and the token-level ``LMServer.generate`` (embed + head + sampling in the
loop). The reference has no serving path — the comparisons here are
between the framework's own modes, with the per-token cost in
milliseconds as the headline unit. Full size needs a GPU.

Usage: python benchmarks/serving.py [--small]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def per_token(fn, n_tokens, *args, repeats=3):
    """min wall-clock per decoded token over full jitted loops.

    ``args`` are passed through on every call — params/caches MUST be jit
    ARGUMENTS, not closure constants: a closed-over 300 MB param tree
    bakes into the HLO as literals."""
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3 / n_tokens


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sputnik_tpu.models import LMServer, SparseLM
    from sputnik_tpu.models.serving import SparseDecoder
    from sputnik_tpu.models.transformer import SparseTransformer

    on_gpu = jax.default_backend() == "gpu"
    if not args.small:
        from sputnik_tpu.utils import enable_compile_cache
        from sputnik_tpu.utils.device import require_gpu

        require_gpu()
        enable_compile_cache()
    if args.small or not on_gpu:
        b, P, h, heads, layers, ffn, bk, n_new, V = \
            2, 64, 128, 4, 2, 256, 32, 8, 997
    else:
        b, P, h, heads, layers, ffn, bk, n_new, V = \
            4, 1024, 1024, 8, 6, 4096, 1024, 64, 32000
    s_max = P + n_new
    rng = np.random.RandomState(0)

    def model(kv_heads=None):
        masks = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                                (b, P, P)).copy()
        return SparseTransformer.from_masks(
            masks, num_layers=layers, hidden_size=h, num_heads=heads,
            ffn_hidden_size=ffn, num_kv_heads=kv_heads,
            use_residual=True, use_layernorm=True, activation="gelu")

    x = jnp.asarray(rng.randn(b, P, h).astype(np.float32) * 0.3)
    tok = jnp.asarray(rng.randn(b, 1, h).astype(np.float32) * 0.3)
    rows = []

    def decode_loop_case(name, m, **dec_kw):
        params = m.init(jax.random.PRNGKey(0), x)
        dec = SparseDecoder(m, s_max=s_max, bk=bk, **dec_kw)
        caches = dec.init_caches(b)
        _, caches = jax.jit(dec.prefill)(params, x, caches)
        loop = jax.jit(lambda p, t, c: dec.decode_loop(p, t, c, n_new)[0])
        ms = per_token(loop, n_new, params, tok, caches)
        rows.append((name, ms))
        print(f"{name:>34}: {ms:.2f} ms/token", flush=True)
        return params, dec, caches

    mh = model()
    params, dec, caches = decode_loop_case("bf16 KV, uniform decode", mh,
                                           cache_dtype=jnp.bfloat16)
    decode_loop_case("int8 KV, uniform decode", mh, cache_dtype=jnp.int8)
    decode_loop_case("bf16 KV, GQA kv_heads=2",
                     model(kv_heads=min(2, heads)),
                     cache_dtype=jnp.bfloat16)

    # ragged step (same shapes, per-replica append): scan the ragged
    # step to isolate the scatter-append cost vs the uniform loop
    act = jnp.ones((b,), bool)

    def ragged_loop(p, t, caches_in):
        def body(carry, _):
            xx, cc = carry
            y, cc = dec.decode_step_ragged(p, xx, cc, act)
            return (y, cc), ()

        (y, _), _ = jax.lax.scan(body, (t, tuple(caches_in)), None,
                                 length=n_new)
        return y

    ms = per_token(jax.jit(ragged_loop), n_new, params, tok, tuple(caches))
    rows.append(("bf16 KV, RAGGED decode", ms))
    print(f"{'bf16 KV, RAGGED decode':>34}: {ms:.2f} ms/token "
          f"(per-slot writes; uniform is the fast path)",
          flush=True)

    # paged decoder (page pool + tables)
    from sputnik_tpu.models.serving_paged import PagedDecoder

    pbk = min(1024, max(128, bk))
    s_max_pg = -(-s_max // pbk) * pbk
    pdec = PagedDecoder(mh, n_pages=b * heads * (s_max_pg // pbk + 1),
                        s_max=s_max_pg, bk=pbk,
                        cache_dtype=jnp.bfloat16)
    if P % pbk == 0:
        pcaches = pdec.init_caches(b)
        _, pcaches = pdec.prefill(params, x, pcaches)
        pcaches = pdec.reserve(pcaches, n_new)

        def paged_loop(p, t, caches_in):
            def body(carry, _):
                xx, cc = carry
                y, cc = pdec.decode_step(p, xx, cc)
                return (y, cc), ()

            (y, _), _ = jax.lax.scan(body, (t, tuple(caches_in)), None,
                                     length=n_new)
            return y

        ms = per_token(jax.jit(paged_loop), n_new, params, tok,
                       tuple(pcaches))
        rows.append((f"bf16 KV, PAGED decode ({pbk}-token pages)", ms))
        print(f"{'bf16 KV, PAGED decode':>34}: {ms:.2f} ms/token "
              f"({pbk}-token pages)", flush=True)
    else:
        print(f"(paged case skipped: prompt {P} not a multiple of the "
              f"{pbk}-token page floor)", flush=True)

    # token-level generate (embed + head + top-k sampling in the loop)
    prompt = jnp.asarray(rng.randint(0, V, (b, P)))
    lm = SparseLM(core=model(), vocab_size=V)
    lp = lm.init(jax.random.PRNGKey(1), prompt)
    server = LMServer(lm, s_max=s_max, bk=bk, cache_dtype=jnp.bfloat16)
    gen = jax.jit(lambda p, pr: server.generate(
        p, pr, n_new, jax.random.PRNGKey(2), temperature=0.8, top_k=40)[0])
    ms = per_token(gen, n_new, lp, prompt)
    rows.append(("LM generate (incl. prefill+sample)", ms))
    print(f"{'LM generate (incl. prefill+sample)':>34}: {ms:.2f} ms/token",
          flush=True)

    import json
    print(json.dumps({"config": dict(b=b, P=P, h=h, heads=heads,
                                     layers=layers, bk=bk, n_new=n_new),
                      "ms_per_token": {k: round(v, 3) for k, v in rows}}))


if __name__ == "__main__":
    main()
