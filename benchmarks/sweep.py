"""SpMM sweep reproducing the reference's README benchmark table.

The reference publishes Sputnik-vs-cuSPARSE SpMM times on A100 for
M=N=K in {64, 4096} over densities {0.05..0.5}
(the reference's `README.md:33-55`, recorded in BASELINE.md). This harness
reruns the same grid on a GPU (it fails without one) through the
framework's canonical panel path and reports per-config: time, effective
GFLOP/s (2*nnz*N useful flops), speedup vs the reference's published
Sputnik number, and the roofline fraction against the card's published
peaks (``utils.profiling.CHIP_SPECS``).

Usage:  python benchmarks/sweep.py [--sizes 64,4096] [--densities ...]
Writes a markdown table to stdout and JSON lines to benchmarks/results.json.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Reference numbers: ms, A100, fp32 (README.md:39-55).
REFERENCE_MS = {
    (64, 0.5): 0.007468, (64, 0.25): 0.005868, (64, 0.2): 0.005615,
    (64, 0.15): 0.005206, (64, 0.1): 0.004922, (64, 0.05): 0.004506,
    (4096, 0.5): 13.047884, (4096, 0.25): 7.870807, (4096, 0.2): 6.065586,
    (4096, 0.15): 5.078734, (4096, 0.1): 4.023627, (4096, 0.05): 2.521871,
}

def bench_one(size, density):
    import jax
    import jax.numpy as jnp

    import sputnik_tpu as st
    from sputnik_tpu.ops import panel_api as P
    from sputnik_tpu.utils.profiling import chip_peaks, measure

    rng = np.random.RandomState(0)
    mask = rng.rand(size, size) < density
    mat = st.SparseMatrix(mask.astype(np.float32) * rng.randn(size, size))
    topo = mat.topology
    dense = jnp.asarray(rng.randn(size, size).astype(np.float32))

    spec = P.PanelSpec(topo)
    bm, bk = spec.bm, spec.bk
    values = jnp.asarray(P.values_to_panel_np(topo, mat.values, bm, bk))

    if size <= 1024:
        # Tiny problems are launch-bound one by one; chain iterations
        # inside one jit with a data dependency so the time per iteration
        # is per-op *device* time, matching how the reference times a
        # tight CUDA-event loop (tests/test_attention.py:55-76).
        n_it = 1000

        @jax.jit
        def chain(v, d):
            def body(_, dd):
                out = P.spmm(spec, v, dd)
                return dd + 1e-6 * out[: dd.shape[0]]
            return jax.lax.fori_loop(0, n_it, body, d)

        ms = measure(chain, values, dense, iters=3) / n_it
    else:
        ms = measure(jax.jit(lambda v, d: P.spmm(spec, v, d)), values, dense)

    nnz = topo.nnz
    useful_gflop = 2.0 * nnz * size / 1e9
    # minimal device-memory traffic: values panel (occupied blocks) +
    # dense + out, f32; compute at the card's TF32 peak
    bv = spec.view
    hbm_gbs, _, tf32_tflops = chip_peaks()
    bytes_min = (bv.num_blocks * bm * bk + 2 * size * size) * 4
    roofline_ms = bytes_min / (hbm_gbs * 1e9) * 1e3
    compute_ms = (2.0 * bv.num_blocks * bm * bk * size) / (
        tf32_tflops * 1e12) * 1e3
    sol_ms = max(roofline_ms, compute_ms)
    return {
        "size": size,
        "density": density,
        "ms": ms,
        "gflops_effective": useful_gflop / (ms / 1e3),
        "ref_sputnik_ms": REFERENCE_MS.get((size, density)),
        "speedup_vs_ref": REFERENCE_MS[(size, density)] / ms
        if (size, density) in REFERENCE_MS else None,
        "speed_of_light_ms": sol_ms,
        "sol_fraction": sol_ms / ms,
        "block_occupancy": bv.block_density,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="64,4096")
    ap.add_argument("--densities", default="0.05,0.1,0.15,0.2,0.25,0.5")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results.json"))
    args = ap.parse_args()

    from sputnik_tpu.utils import enable_compile_cache
    from sputnik_tpu.utils.device import require_gpu

    require_gpu()
    enable_compile_cache()
    sizes = [int(s) for s in args.sizes.split(",")]
    densities = [float(d) for d in args.densities.split(",")]

    rows = []
    for size in sizes:
        for d in densities:
            r = bench_one(size, d)
            rows.append(r)
            print(json.dumps(r), flush=True)

    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")

    print("\n| M=N=K | density | ms | ref A100 ms | speedup | "
          "eff GFLOP/s | SoL frac |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['size']} | {r['density']} | {r['ms']:.4f} | "
              f"{r['ref_sputnik_ms']} | {r['speedup_vs_ref']:.2f}x | "
              f"{r['gflops_effective']:.1f} | {r['sol_fraction']:.3f} |")


if __name__ == "__main__":
    main()
