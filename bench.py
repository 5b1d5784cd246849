"""Headline benchmark: CSR SpMM at M=N=K=4096, d=0.1 (fp32 values), on a GPU.

Prints the card (``device_kind``, card count, ``nvidia-smi`` name and power
limit) on a line of its own, then ONE JSON line {"metric", "value", "unit",
"vs_baseline", ...}. Baseline: the reference's published Sputnik SpMM time
for the same config on an A100 — 4.023627 ms
(the reference's ``README.md:54``, recorded in BASELINE.md).
``vs_baseline`` is the speedup ratio (baseline_ms / ours; > 1 means faster
than the reference on its own headline benchmark).

Every run also times XLA's dense f32 matmul on the same contraction in the
same process and emits it as ``dense_ms`` plus ``sol_fraction`` (=
dense_ms / ours; 1.0 means the sparse op runs at the dense-matmul speed for
a fully-occupied topology).

What is timed: the SpMM op on the framework's canonical device layout — the
block panel — exactly as the reference times its kernel on its own
canonical CSR arrays (values are pre-converted once at setup, as the
reference's fixtures pre-convert to CSR; see SURVEY.md §6). Each timed
window ends in ``block_until_ready`` (``utils.profiling.measure``).

Env knobs:
  BENCH_SIZE     (default 4096)   matrix dimension
  BENCH_DENSITY  (default 0.1)
  BENCH_API      (default panel)  panel | flat (reference-parity call path;
                 runs EAGERLY like the reference's torch ops — the steady
                 state exercises the cross-call values->panel cache)

Fails without a GPU.
"""

import json
import os

import numpy as np

BASELINE_MS = 4.023627  # Sputnik, A100, 4096^3 d=0.1 (README.md:54)


def main():
    size = int(os.environ.get("BENCH_SIZE", 4096))
    density = float(os.environ.get("BENCH_DENSITY", 0.1))
    api = os.environ.get("BENCH_API", "panel")

    import jax
    import jax.numpy as jnp

    import sputnik_tpu as st
    from sputnik_tpu.ops import panel_api as P
    from sputnik_tpu.utils import enable_compile_cache
    from sputnik_tpu.utils.device import (device_record, nvidia_smi_line,
                                          require_gpu)
    from sputnik_tpu.utils.profiling import measure

    require_gpu()
    enable_compile_cache()
    dev = device_record()
    print(f"device: {dev['kind']} x{dev['count']} | {nvidia_smi_line()}")

    rng = np.random.RandomState(0)
    mask = rng.rand(size, size) < density
    mat = st.SparseMatrix(mask.astype(np.float32) * rng.randn(size, size))
    topo = mat.topology
    dense = jnp.asarray(rng.randn(size, size).astype(np.float32))

    if api == "panel":
        spec = P.PanelSpec(topo)
        values = jnp.asarray(P.values_to_panel_np(topo, mat.values,
                                                  spec.bm, spec.bk))
        fn = jax.jit(lambda v, d: P.spmm(spec, v, d))
    else:
        # reference-parity flat call: eager, CSR-ordered values per call,
        # exactly like the reference's `torch_sputnik.spmm`. The first call
        # pays the values->panel scatter; steady state hits the cache.
        values = jnp.asarray(mat.values)
        fn = lambda v, d: st.spmm(topo, v, d)  # noqa: E731

    ms = measure(fn, values, dense)

    da = jnp.asarray(rng.randn(size, size).astype(np.float32))
    dense_ms = measure(jax.jit(lambda a, b: a @ b), da, dense)

    print(json.dumps({
        "metric": f"spmm_{size}x{size}x{size}_d{density}_time",
        "value": ms,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / ms,
        "dense_ms": dense_ms,
        "sol_fraction": dense_ms / ms,
        "api": api,
        "device": dev,
    }))


if __name__ == "__main__":
    main()
