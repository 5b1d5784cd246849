"""Pipeline parallelism: GPipe-style microbatch pipelining over a mesh axis.

The reference has no distribution layer of any kind (SURVEY.md §2
"Parallelism inventory — none"); this module adds the pipeline axis to the
framework's mesh vocabulary (dp x tp x sp x pp x ep).

Design (the standard SPMD pipelining idiom — collective-permute shifts on
a ring, one stage per device, compiler-friendly ``lax.scan`` over the
schedule):

  * stage parameters are STACKED along a leading ``ndev`` axis and sharded
    over the ``pp`` mesh axis — device ``d`` holds stage ``d``'s weights;
  * the schedule runs ``n_micro + ndev - 1`` scan steps; at each step
    every device applies its stage to its current activation and shifts
    the result one hop right via ``lax.ppermute`` (bubble fraction
    ``(ndev-1) / (n_micro + ndev - 1)``, amortised by more microbatches);
  * everything is reverse-differentiable (``scan`` + ``ppermute`` + the
    stage fn), so one ``jax.grad`` spans the whole pipeline — the backward
    pass runs the reverse schedule with reversed permutes automatically.

Works with any ``stage_fn(stage_params, x) -> y`` with ``y.shape ==
x.shape`` (e.g. a ``TransformerLayer.apply``); sparse-attention stages
run their Pallas kernels per device exactly as on one chip.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["PipelineSpec", "pipeline_apply", "stack_stage_params"]


class PipelineSpec:
    """Static pipeline config: mesh axis + microbatch count."""

    def __init__(self, mesh: Mesh, axis: str = "pp",
                 n_micro: Optional[int] = None):
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.shape[axis]
        self.n_micro = n_micro or self.ndev

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def stack_stage_params(per_stage_params):
    """List of per-stage param pytrees (identical structure) -> one pytree
    with a leading ``n_stage`` axis, ready to shard over the pp axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *per_stage_params)


def pipeline_apply(spec: PipelineSpec, stage_fn, stacked_params, x):
    """Run ``x`` through ``ndev`` pipelined stages.

    Args:
      spec: ``PipelineSpec`` (mesh, axis, n_micro).
      stage_fn: ``(stage_params, x_micro) -> y_micro``, shape-preserving.
      stacked_params: pytree with leading ``ndev`` axis (stage ``d`` at
        index ``d``), e.g. from ``stack_stage_params``.
      x: ``[batch, ...]`` with ``batch`` divisible by ``n_micro``.

    Returns ``[batch, ...]`` outputs (microbatches re-assembled).
    """
    ndev, n_micro, ax = spec.ndev, spec.n_micro, spec.axis
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    mb = b // n_micro
    xs = x.reshape(n_micro, mb, *x.shape[1:])
    T = n_micro + ndev - 1
    # pad the feed with zero microbatches for the drain steps
    feed = jnp.concatenate(
        [xs, jnp.zeros((ndev - 1, mb) + x.shape[1:], x.dtype)], axis=0)

    def local(params_st, feed_loc):
        params_loc = jax.tree.map(lambda a: a[0], params_st)
        me = jax.lax.axis_index(ax)
        fwd = [(d, (d + 1) % ndev) for d in range(ndev)]

        def body(carry, x_t):
            x_in = jnp.where(me == 0, x_t, carry)
            y = stage_fn(params_loc, x_in)
            nxt = jax.lax.ppermute(y, ax, fwd)
            return nxt, y

        _, ys = jax.lax.scan(body, jnp.zeros_like(feed_loc[0]), feed_loc)
        return ys[None]                       # [1, T, mb, ...]

    fn = jax.shard_map(
        local, mesh=spec.mesh,
        in_specs=(P(ax), P()), out_specs=P(ax),
        check_vma=False,
    )
    ys = fn(stacked_params, feed)             # [ndev, T, mb, ...]
    # microbatch j leaves the LAST stage at step j + ndev - 1
    out = ys[-1, ndev - 1: ndev - 1 + n_micro]
    return out.reshape(b, *x.shape[1:])
