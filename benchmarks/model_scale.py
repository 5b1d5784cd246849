"""Production-scale transformer train steps: sparse flash vs dense.

The reference's driver config (6L, s=512) is a toy — at that scale a
monolithic dense XLA graph wins on fixed costs and `layout="auto"`
dispatches to it. This harness measures where production models live:
longer sequences and banded long-context topologies, full train steps
(fwd + bwd + SGD) on real shapes.

Rows (on a GPU; one process per run):
  * causal s=2048, 12L, h=1024  — mid-scale LM pretraining shape
  * banded w=512 s=4096, 6L    — long-context fine-tuning shape
  * banded w=256 s=8192, 4L    — the memory-bound long-context regime
    (the dense equivalent materialises s^2 scores: 256 MB/head-layer)

Run:  python benchmarks/model_scale.py [--small]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sparse_step(masks, layers, h, heads, ffn, stream=None, layout="flash"):
    import jax
    import jax.numpy as jnp
    import optax

    from sputnik_tpu.models.transformer import SparseTransformer

    model = SparseTransformer.from_masks(
        masks, num_layers=layers, hidden_size=h, num_heads=heads,
        ffn_hidden_size=ffn, use_residual=True, use_layernorm=True,
        activation="gelu", attention_layout=layout, flash_stream=stream)
    b, s = masks.shape[0], masks.shape[1]
    x = jnp.asarray(np.random.RandomState(0).randn(b, s, h).astype(
        np.float32))
    params = model.init(jax.random.PRNGKey(0), x)
    tx = optax.sgd(1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(p, o, xx):
        l, g = jax.value_and_grad(
            lambda pp: jnp.mean(model.apply(pp, xx) ** 2))(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, l

    return step, params, opt, x


def dense_step(masks, layers, h, heads, ffn):
    """The same model and step with dense masked attention (the
    ``attention_layout="xla"`` path): the dense baseline."""
    return sparse_step(masks, layers, h, heads, ffn, layout="xla")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    from sputnik_tpu.patterns import causal_mask, local_window_mask
    from sputnik_tpu.utils import enable_compile_cache
    from sputnik_tpu.utils.device import require_gpu
    from sputnik_tpu.utils.profiling import measure

    if not args.small:
        require_gpu()
    enable_compile_cache()
    out = {}

    if args.small:
        configs = [("causal_s256", np.broadcast_to(
            causal_mask(256), (2, 256, 256)).copy(), 2, 128, 4, 256,
            True)]
    else:
        configs = [
            ("causal_s2048_12L_h1024",
             np.broadcast_to(causal_mask(2048), (4, 2048, 2048)).copy(),
             12, 1024, 16, 4096, True),
            ("band512_s4096_6L_h1024",
             np.broadcast_to(local_window_mask(4096, 512),
                             (2, 4096, 4096)).copy(),
             6, 1024, 16, 4096, True),
            ("band256_s8192_4L_h1024",
             np.broadcast_to(local_window_mask(8192, 256),
                             (1, 8192, 8192)).copy(),
             4, 1024, 16, 4096, True),
        ]

    for tag, masks, layers, h, heads, ffn, run_dense in configs:
        for variant, stream in (("", None), ("_bf16", "bf16")):
            step, params, opt, x = sparse_step(masks, layers, h, heads,
                                               ffn, stream)
            out[f"{tag}_sparse{variant}_ms"] = measure(step, params, opt,
                                                       x)
        if run_dense:
            try:
                step, params, opt, x = dense_step(masks, layers, h,
                                                  heads, ffn)
                out[f"{tag}_dense_ms"] = measure(step, params, opt, x)
            except Exception as e:     # dense OOMs at long s — the point
                out[f"{tag}_dense_ms"] = f"OOM/ERR {str(e)[:60]}"
        print(json.dumps({k: v for k, v in out.items()
                          if k.startswith(tag)}), flush=True)

    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
