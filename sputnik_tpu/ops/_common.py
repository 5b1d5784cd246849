"""Shared route selection and padding helpers for the op layers.

Single source of truth for which implementation serves an op:

  * ``"kernel"``    — the hand-written Pallas-Triton kernel, compiled for
    the GPU;
  * ``"interpret"`` — the same kernel through the Pallas interpreter. Only
    the test-only :func:`interpret_kernels` switch selects it; no
    library path chooses the interpreter on its own;
  * ``"plain"``     — the plain ``jax.numpy`` version that XLA compiles.

``sputnik_tpu.set_backend`` steers the choice: ``"xla"`` forces the plain
version everywhere, ``"pallas"`` forces the kernels (and needs a GPU),
``"auto"`` takes the kernel on a GPU and the plain version elsewhere.
"""

from __future__ import annotations

import contextlib
import threading

import jax

__all__ = ["round_up", "on_gpu", "route", "interpret_kernels", "tile_n",
           "trace_clean", "device_arrays", "acc_dtype"]

_state = threading.local()


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def acc_dtype(*xs):
    """Accumulation dtype of the plain versions: float32, or wider when
    an operand is (float64 gradient checks stay float64)."""
    import jax.numpy as jnp

    return jnp.promote_types(jnp.result_type(*xs), jnp.float32)


def trace_clean() -> bool:
    """True when not inside any JAX trace (safe to create + cache
    device arrays)."""
    from jax._src import core as _core

    return bool(_core.trace_state_clean())


def device_arrays(obj, attr: str, build) -> dict:
    """Numpy metadata -> DEVICE arrays, cached as ``obj.<attr>``.

    ``build()`` returns the numpy dict (called only on a cache miss;
    non-ndarray entries are dropped). Device-resident metadata enters a
    surrounding ``jit`` as hoisted runtime buffers, not HLO literals —
    keeping compile payloads O(1) in topology size. The cache is only
    populated outside a trace; tracing first still works, just without
    caching.
    """
    import numpy as _np

    import jax.numpy as jnp

    cached = getattr(obj, attr, None)
    if cached is not None:
        return cached
    dev = {k: jnp.asarray(v) for k, v in build().items()
           if isinstance(v, _np.ndarray)}
    if trace_clean():
        setattr(obj, attr, dev)
    return dev


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


@contextlib.contextmanager
def interpret_kernels():
    """Test-only switch: every kernel-backed op runs its Pallas kernel
    through the interpreter (CPU), whatever the backend setting says —
    except ``set_backend("xla")``, which still forces the plain version."""
    prev = getattr(_state, "interpret", False)
    _state.interpret = True
    try:
        yield
    finally:
        _state.interpret = prev


def route() -> str:
    """``"kernel"``, ``"interpret"`` or ``"plain"`` for the current call."""
    from . import api as _api

    backend = _api.get_backend()
    if backend == "xla":
        return "plain"
    if getattr(_state, "interpret", False):
        return "interpret"
    if backend == "pallas" or on_gpu():
        if not on_gpu():
            raise ValueError("set_backend('pallas') needs a GPU")
        return "kernel"
    return "plain"


def tile_n(q_pad: int, cap: int = 128) -> int:
    """Largest power-of-two output-tile width <= cap that exactly divides
    ``q_pad`` (itself a multiple of 16)."""
    bn = cap
    while bn > 16 and q_pad % bn:
        bn //= 2
    return bn
