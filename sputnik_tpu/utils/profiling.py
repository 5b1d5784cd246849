"""Profiling and roofline helpers.

Replaces the reference's ad-hoc ``torch.cuda.Event`` timing pairs
(``tests/test_attention.py:16-28``) with (a) a wall-clock measurement that
ends every timed window in ``block_until_ready`` (JAX dispatch is
asynchronous), (b) ``jax.profiler`` trace capture, and (c) a per-topology
roofline model fed by the block panel's occupancy
(``BlockView.block_density``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

__all__ = ["measure", "trace", "roofline", "CHIP_SPECS", "chip_peaks"]

# Published dense peaks per device kind (substring of ``device_kind``,
# lower case): (device memory GB/s, bf16 TFLOP/s, TF32 TFLOP/s). NVIDIA
# H100 SXM data sheet, at the card's full 700 W power limit.
CHIP_SPECS = {
    "h100": (3350.0, 989.0, 495.0),
}


def measure(fn: Callable, *args, iters: int = 20, repeats: int = 3) -> float:
    """Milliseconds per call of an already-jitted ``fn(*args)``: the best
    of ``repeats`` windows of ``iters`` back-to-back calls, each window
    ended by ``block_until_ready`` (compilation happens in a warm-up call
    outside the windows)."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best / iters * 1e3


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` trace context; view with TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def chip_peaks(device_kind: Optional[str] = None) -> tuple:
    """``CHIP_SPECS`` row of ``device_kind`` (default: the first JAX
    device's). A device that is not in the table is an error."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    kind = device_kind.lower()
    for key, peaks in CHIP_SPECS.items():
        if key in kind:
            return peaks
    raise ValueError(f"no published peaks for device kind {device_kind!r}")


def roofline(spec, n_out: int, dtype_bytes: int = 4,
             device_kind: Optional[str] = None) -> Dict[str, float]:
    """Speed-of-light estimate for ``spmm(spec, panel, dense[n, n_out])``.

    Returns bytes/flops of the *block-touched* computation and the
    bandwidth/compute-bound time bounds on the device — the target the
    BASELINE asks kernels to sit within 10% of. Compute is priced at the
    bf16 peak for 2-byte operands and the TF32 peak otherwise.
    """
    bv = spec.view
    hbm_gbs, bf16_tflops, tf32_tflops = chip_peaks(device_kind)
    tflops = bf16_tflops if dtype_bytes <= 2 else tf32_tflops
    touched = bv.num_blocks * bv.bm * bv.bk
    bytes_min = (touched + spec.topo.n * n_out + spec.topo.m * n_out
                 ) * dtype_bytes
    flops = 2.0 * touched * n_out
    bw_ms = bytes_min / (hbm_gbs * 1e9) * 1e3
    fl_ms = flops / (tflops * 1e12) * 1e3
    return {
        "bytes_min": float(bytes_min),
        "flops": float(flops),
        "bandwidth_ms": bw_ms,
        "compute_ms": fl_ms,
        "speed_of_light_ms": max(bw_ms, fl_ms),
        "block_occupancy": bv.block_density,
        "useful_flop_fraction": (
            2.0 * spec.topo.nnz * n_out / max(flops, 1.0)),
    }
