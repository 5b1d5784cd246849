"""Structured-sparsity benchmark: block-skip where it actually pays.

Uniform-random sparsity leaves every kernel tile occupied, so the BSR
kernel's time is density-flat. Structured patterns — local-window /
banded / block-diagonal masks, the kind sparse attention actually uses —
leave most tiles empty, and the kernel's time scales with *block occupancy*
instead. This benchmark shows SpMM time vs window size at 4096², against
the dense-matmul time for the same shapes.

Usage: python benchmarks/structured.py   (fails without a GPU)
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    import sputnik_tpu as st
    from sputnik_tpu.patterns import local_window_mask
    from sputnik_tpu.ops import panel_api as P
    from sputnik_tpu.utils import enable_compile_cache
    from sputnik_tpu.utils.device import require_gpu
    from sputnik_tpu.utils.profiling import measure

    require_gpu()
    enable_compile_cache()
    size = int(os.environ.get("BENCH_SIZE", 4096))
    rng = np.random.RandomState(0)
    dense = jnp.asarray(rng.randn(size, size).astype(np.float32))

    # dense matmul reference on the same card
    a = jnp.asarray(rng.randn(size, size).astype(np.float32))
    dense_ms = measure(jax.jit(lambda x, y: x @ y), a, dense)
    print(json.dumps({"config": "dense matmul", "ms": dense_ms}),
          flush=True)

    for window in (128, 256, 512, 1024):
        mask = local_window_mask(size, window=window)
        A = mask * rng.randn(size, size).astype(np.float32)
        mat = st.SparseMatrix(A.astype(np.float32))
        spec = P.PanelSpec(mat.topology)
        panel = jnp.asarray(
            P.values_to_panel_np(mat.topology, mat.values, spec.bm, spec.bk))
        fn = jax.jit(lambda p, d: P.spmm(spec, p, d))
        ms = measure(fn, panel, dense)
        occ = spec.view.block_density
        print(json.dumps({
            "config": f"local_window w={window}",
            "ms": ms,
            "block_occupancy": occ,
            "density": mat.topology.nnz / size ** 2,
            "speedup_vs_dense_matmul": dense_ms / ms,
        }), flush=True)


if __name__ == "__main__":
    main()
