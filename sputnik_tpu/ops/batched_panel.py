"""Batched panel ops — the many-mask family on the block panel.

The reference's transformer calls phantom ``*_many_mask`` CUDA bindings:
per-batch-element masks, heads sharing their batch element's mask
(``tests/transformer/utils.py:17-38``). Here that family runs through the
batched block-CSR kernel family (``pallas/bsr_spmm``, ``bsr_spmm_t``,
``bsr_sddmm``): one launch for ALL replicas, each program dividing its
replica id by ``heads`` to pick its mask's block metadata — so the ``h``
heads of a batch element share its topology without duplicating it, and
the whole SDDMM -> softmax -> SpMM chain stays in panel layout. Where the
kernels do not serve, the same entries run their plain block-gather
versions.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..blocking import stack_block_meta
from ._common import device_arrays as _device_arrays
from ._common import round_up as _round_up
from .pallas import bsr_sddmm as _sddmm_mod
from .pallas import bsr_spmm as _spmm_mod
from .pallas import bsr_spmm_t as _spmm_t_mod

__all__ = ["BatchedPanelSpec", "spmm_bh", "sddmm_bh", "sparse_softmax_bh"]

_NEG_LARGE = -1e30


class BatchedPanelSpec:
    """Static bundle for ``B`` same-shape topologies x ``heads`` replicas."""

    def __init__(self, topologies: List, *, heads: int = 1,
                 bm: int = 128, bk: int = 128):
        self.topologies = list(topologies)
        self.B = len(topologies)
        self.heads = heads
        self.bm, self.bk = bm, bk
        views = [t.block(bm, bk) for t in topologies]
        self.views = views
        self.meta = stack_block_meta(views)
        self.mb, self.kb = self.meta["mb"], self.meta["kb"]
        self.max_bpr = self.meta["max_bpr"]
        self.max_bpc = self.meta["max_bpc"]
        self.m = topologies[0].m
        self.n = topologies[0].n
        self.m_pad = self.mb * bm
        self.n_pad = self.kb * bk

    @classmethod
    def from_many_mask(cls, mt, *, heads: int = 1, bm: int = 128,
                       bk: int = 128) -> "BatchedPanelSpec":
        return cls(mt.topologies, heads=heads, bm=bm, bk=bk)

    @property
    def R(self) -> int:
        return self.B * self.heads

    @property
    def panel_shape(self):
        """Per-replica panel shape."""
        return (self.mb, self.max_bpr, self.bm, self.bk)

    def stack_values(self, values_r) -> np.ndarray:
        """Flat many-mask values ``[R, nnz_pad]`` -> panels ``[R, *]``
        (host-side boundary)."""
        values_r = np.asarray(values_r, np.float32)
        out = np.zeros((self.R,) + self.panel_shape, np.float32)
        for r in range(self.R):
            v = self.views[r // self.heads]
            flat = np.zeros(v.dump + 1, np.float32)
            take = min(v.scatter_idx.shape[0], values_r.shape[1])
            flat[v.scatter_idx[:take]] = values_r[r, :take]
            out[r, :, : v.max_bpr] = flat[: v.dump].reshape(v.values_shape)
        return out

    def unstack_values(self, panels, nnz_pad: int):
        """Panels ``[R, *]`` -> flat many-mask values ``[R, nnz_pad]``
        (device op; boundary only)."""
        outs = []
        for r in range(self.R):
            v = self.views[r // self.heads]
            p = panels[r, :, : v.max_bpr]
            flat = jnp.concatenate(
                [p.reshape(-1), jnp.zeros((1,), panels.dtype)])
            g = np.full(nnz_pad, v.dump, np.int32)
            take = min(nnz_pad, len(v.gather_idx))
            g[:take] = np.minimum(v.gather_idx[:take], v.dump)
            outs.append(jnp.take(flat, jnp.asarray(g)))
        return jnp.stack(outs)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


# ---------------------------------------------------------------------------
# Impl layer over the batched kernel family.
# ---------------------------------------------------------------------------


def _meta_dev(spec):
    """``spec.meta`` as cached DEVICE arrays (see ``_common.device_arrays``:
    keeps the mask/block metadata out of jit compile payloads)."""
    return _device_arrays(spec, "_meta_dev_cache", lambda: spec.meta)


def _mask_r(spec):
    """Element mask broadcast to replicas without materialising ``heads``
    copies: ``[B, ...] -> [R, ...]`` via a broadcast + reshape (XLA keeps
    the broadcast lazy inside the consuming fusion)."""
    mask = _meta_dev(spec)["mask"]
    shape = (spec.B, spec.heads) + mask.shape[1:]
    return jnp.broadcast_to(mask[:, None], shape).reshape(
        (spec.R,) + mask.shape[1:])


def _pad_rows(spec, x, rows, d_pad):
    if x.shape[1:] == (rows, d_pad):
        return x
    out = jnp.zeros((x.shape[0], rows, d_pad), x.dtype)
    return out.at[:, : x.shape[1], : x.shape[2]].set(x)


def _match(a, b):
    """Promote two operands to a common dtype (accumulation is f32)."""
    dt = jnp.promote_types(a.dtype, b.dtype)
    return a.astype(dt), b.astype(dt)


def _spmm_impl(spec, panels, dense):
    """panels [R, *] x dense [R, n, q] -> [R, m, q]."""
    q = dense.shape[-1]
    panels, dense = _match(panels, dense)
    bn = 128 if q > 64 else 16
    dense_p = _pad_rows(spec, dense, spec.n_pad, _round_up(max(q, 1), bn))
    meta = _meta_dev(spec)
    out = _spmm_mod.bsr_spmm_batched(
        meta["block_cols"], meta["nblocks"], panels, dense_p,
        heads=spec.heads, bn=bn)
    return out[:, : spec.m, :q]


def _spmm_t_impl(spec, panels, g_r):
    """A_r^T @ G_r: panels [R, *] x g [R, m, q] -> [R, n, q]."""
    q = g_r.shape[-1]
    panels, g_r = _match(panels, g_r)
    g_p = _pad_rows(spec, g_r, spec.m_pad, q)
    meta = _meta_dev(spec)
    out = _spmm_t_mod.bsr_spmm_t_batched(
        meta["t_src_i"], meta["t_src_s"], meta["t_nblocks"], panels, g_p,
        heads=spec.heads, kb=spec.kb)
    return out[:, : spec.n]


def _sddmm_impl(spec, lhs_r, rhs_r):
    """lhs [R, m, d] x rhs [R, n, d] -> panels [R, *]."""
    lhs_r, rhs_r = _match(lhs_r, rhs_r)
    d_pad = _round_up(max(lhs_r.shape[-1], 1), 16)
    meta = _meta_dev(spec)
    return _sddmm_mod.bsr_sddmm_batched(
        meta["block_cols"], meta["nblocks"], meta["mask"],
        _pad_rows(spec, lhs_r, spec.m_pad, d_pad),
        _pad_rows(spec, rhs_r, spec.n_pad, d_pad), heads=spec.heads)


def _softmax_impl(spec, panels):
    mask = _mask_r(spec)
    v = jnp.where(mask != 0, panels, _NEG_LARGE)
    row_max = jnp.maximum(jnp.max(v, axis=(2, 4), keepdims=True), _NEG_LARGE)
    e = jnp.where(mask != 0, jnp.exp(v - row_max), 0.0)
    denom = jnp.sum(e, axis=(2, 4), keepdims=True)
    return e / jnp.maximum(denom, jnp.finfo(panels.dtype).tiny)


# ---------------------------------------------------------------------------
# custom_vjp ops.
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def spmm_bh(spec, panels, dense):
    """Batched panel SpMM: ``[R,*] x [R, n, q] -> [R, m, q]``."""
    return _spmm_impl(spec, panels, dense)


def _spmm_bh_fwd(spec, panels, dense):
    return _spmm_impl(spec, panels, dense), (panels, dense)


def _spmm_bh_bwd(spec, res, g):
    panels, dense = res
    d_panels = _sddmm_impl(spec, g, dense)
    d_dense = _spmm_t_impl(spec, panels, g)
    return (d_panels.astype(panels.dtype),
            d_dense[:, : dense.shape[1], : dense.shape[2]].astype(
                dense.dtype))


spmm_bh.defvjp(_spmm_bh_fwd, _spmm_bh_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sddmm_bh(spec, lhs, rhs):
    """Batched sampled product -> panels ``[R, *]``."""
    return _sddmm_impl(spec, lhs, rhs)


def _sddmm_bh_fwd(spec, lhs, rhs):
    return _sddmm_impl(spec, lhs, rhs), (lhs, rhs)


def _sddmm_bh_bwd(spec, res, g_panels):
    lhs, rhs = res
    d_lhs = _spmm_impl(spec, g_panels, rhs)
    d_rhs = _spmm_t_impl(spec, g_panels, lhs)
    return (d_lhs[:, : lhs.shape[1], : lhs.shape[2]].astype(lhs.dtype),
            d_rhs[:, : rhs.shape[1], : rhs.shape[2]].astype(rhs.dtype))


sddmm_bh.defvjp(_sddmm_bh_fwd, _sddmm_bh_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sparse_softmax_bh(spec, panels):
    """Batched row softmax on panels."""
    return _softmax_impl(spec, panels)


def _sm_bh_fwd(spec, panels):
    p = _softmax_impl(spec, panels)
    return p, p


def _sm_bh_bwd(spec, p, g):
    pg = p * g
    rs = jnp.sum(pg, axis=(2, 4), keepdims=True)
    return (p * (g - rs),)


sparse_softmax_bh.defvjp(_sm_bh_fwd, _sm_bh_bwd)
