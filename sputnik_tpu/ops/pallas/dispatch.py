"""The flat-CSR (reference-parity) op surface, served by the panel ops.

The reference's calling convention passes CSR-ordered ``values[nnz]`` per
call, while the kernels (and their plain block-gather twins) consume the
block panel. Every flat call therefore converts at the boundary and runs
the panel op, whose route (``_common.route``) picks the Triton kernel on a
GPU and the plain version elsewhere:

  * ONE tile-heuristic source: the flat path builds a ``PanelSpec`` (so
    ``panel_api.default_block`` governs both APIs), cached on the
    topology's block view.
  * a cross-call panel cache: eager flat calls (the reference-parity
    usage — torch ops are eager) with the SAME values array re-pay
    nothing; the scatter runs once per distinct values buffer. Keyed by
    object identity with a strong reference held in a small FIFO (an id
    can't be recycled while its object is alive), so repeated
    ``st.spmm(topo, w, x)`` over a fixed weight vector runs at panel
    speed. Traced values (inside a user ``jit``) can't be cached — the
    scatter stays in the trace, where XLA CSE's it across calls within
    one program instead.
"""

from __future__ import annotations

from collections import OrderedDict

import jax
import jax.numpy as jnp

from .. import _common

__all__ = ["spmm", "sddmm", "sparse_softmax", "spmm_bias_relu",
           "flush_caches"]

_PANEL_CACHE_SLOTS = 8


def _flat_spec(topo):
    """The flat API's PanelSpec — default tiles from ``panel_api``
    (single heuristic source), cached on the topology's block view
    (the topology itself is __slots__-only)."""
    from .. import panel_api as P

    bm, bk = P.default_block(topo)
    bv = topo.block(bm, bk)
    spec = getattr(bv, "_flat_spec", None)
    if spec is None:
        spec = P.PanelSpec(topo, bm=bm, bk=bk)
        object.__setattr__(bv, "_flat_spec", spec)
    return spec


# id(values) -> (spec, values, panel). Holding the values array strongly
# keeps its id from being recycled; FIFO eviction bounds the held memory
# to _PANEL_CACHE_SLOTS value/panel pairs.
_panel_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


def _values_panel(spec, values):
    """values[nnz] -> panel, cached across eager calls per values buffer."""
    from .. import panel_api as P

    def build():
        return P.values_to_panel(spec.topo, values, spec.bm, spec.bk)

    # cache only immutable device arrays outside any trace (a traced value
    # has no stable identity; a numpy array can be mutated in place)
    if not _common.trace_clean() or not isinstance(values, jax.Array):
        return build()
    key = (id(spec), id(values))
    hit = _panel_cache.get(key)
    # the entry must hold BOTH objects strongly and identity-check both:
    # an id() alone can be recycled after GC — a new PanelSpec landing at
    # a dead spec's address with the same values buffer would silently
    # return the dead topology's panel
    if hit is not None and hit[0] is spec and hit[1] is values:
        _panel_cache.move_to_end(key)
        return hit[2]
    panel = build()
    _panel_cache[key] = (spec, values, panel)
    while len(_panel_cache) > _PANEL_CACHE_SLOTS:
        _panel_cache.popitem(last=False)
    return panel


def flush_caches() -> None:
    """Drop the cross-call panel and closure caches (releases the pinned
    device buffers). Called by ``sputnik_tpu.set_backend``; safe any
    time — the caches repopulate on the next eager call."""
    _panel_cache.clear()
    _fn_cache.clear()


# (id(spec), out_dt, epilogue, route) -> prebuilt jitted closure. The
# steady-state eager call costs ONE jit dispatch on two array args instead
# of re-entering _spmm_impl's static-argname machinery every call. The
# route is part of the key: a closure traces its route in.
_fn_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


def _flat_fn(spec, out_dt, epilogue):
    from .. import panel_api as P

    key = (id(spec), jnp.dtype(out_dt).name, epilogue, _common.route())
    hit = _fn_cache.get(key)
    if hit is not None and hit[0] is spec:
        _fn_cache.move_to_end(key)
        return hit[1]
    if epilogue == "none":
        fn = jax.jit(lambda p, d: P._spmm_impl(spec, p, d).astype(out_dt))
    else:
        fn = jax.jit(lambda p, d, b: P._spmm_impl(
            spec, p, d, b, epilogue=epilogue).astype(out_dt))
    _fn_cache[key] = (spec, fn)
    while len(_fn_cache) > 4 * _PANEL_CACHE_SLOTS:
        _fn_cache.popitem(last=False)
    return fn


def spmm(topo, values, dense):
    spec = _flat_spec(topo)
    out_dt = jnp.promote_types(values.dtype, dense.dtype)
    return _flat_fn(spec, out_dt, "none")(_values_panel(spec, values), dense)


def spmm_bias_relu(topo, values, dense, bias, *, relu: bool = True):
    spec = _flat_spec(topo)
    out_dt = jnp.promote_types(values.dtype, dense.dtype)
    ep = "bias_relu" if relu else "bias"
    return _flat_fn(spec, out_dt, ep)(_values_panel(spec, values), dense,
                                      bias)


def sddmm(topo, lhs, rhs):
    from .. import panel_api as P

    spec = _flat_spec(topo)
    panel = P._sddmm_impl(spec, lhs, rhs)
    return P.panel_to_values(topo, panel, spec.bm, spec.bk)


def sparse_softmax(topo, values):
    """Row softmax through the panel's masked reductions (differentiable
    end to end: the panel op carries its own VJP, the two layout
    conversions are plain gathers/scatters)."""
    from .. import panel_api as P

    spec = _flat_spec(topo)
    panel = P.values_to_panel(topo, values, spec.bm, spec.bk)
    out = P.sparse_softmax(spec, panel)
    return P.panel_to_values(topo, out, spec.bm, spec.bk)
