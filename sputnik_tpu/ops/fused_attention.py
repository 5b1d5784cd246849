"""Differentiable fused sparse attention (sparse-flash fwd AND bwd).

``fused_sparse_attention(spec, q, k, v)`` computes masked softmax attention
over the score topology of ``spec`` without materialising scores:

  * forward: one kernel walking only the occupied key blocks with an
    online softmax (``pallas/flash_sparse.flash_sparse_attention_fwd``);
  * backward: two kernels recomputing score tiles from the saved row
    stats — dq accumulates along the row direction (forward's walk),
    dk/dv along the column direction via the transposed block metadata
    (the same no-value-movement trick as ``bsr_spmm_t``).

Each entry runs its Pallas-Triton kernel on a GPU and its plain
block-gather version elsewhere (``_common.route``). The reference computes
this chain as three CUDA dispatches with a *broken* softmax backward
(``tests/transformer/functions.py:105-115``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import batched_panel as bp
from ._common import device_arrays as _device_arrays
from ._common import trace_clean as _trace_clean
from .pallas import flash_sparse as fs

__all__ = ["fused_sparse_attention"]


def _flash_meta(spec: bp.BatchedPanelSpec):
    """Flash metadata as cached DEVICE arrays (see
    ``_common.device_arrays``: hoisted runtime buffers, not HLO literals —
    the compile payload stays O(1) in topology size). The numpy build is
    always cached."""
    np_meta = getattr(spec, "_flash_meta", None)
    if np_meta is None:
        np_meta = spec._flash_meta = fs.build_flash_meta(spec.views)
    return dict(_device_arrays(spec, "_flash_meta_dev", lambda: np_meta),
                max_bpr=np_meta["max_bpr"])


def _flash_bwd_meta(spec: bp.BatchedPanelSpec):
    np_meta = getattr(spec, "_flash_bwd_meta", None)
    if np_meta is None:
        np_meta = spec._flash_bwd_meta = fs.build_flash_bwd_meta(spec.views)
    return dict(_device_arrays(spec, "_flash_bwd_meta_dev",
                               lambda: np_meta),
                max_bpr=np_meta["max_bpr"], max_bpc=np_meta["max_bpc"])


def warm_flash_meta(spec: bp.BatchedPanelSpec, *,
                    backward: bool = True) -> None:
    """Eagerly build + device-place the flash metadata for ``spec``.

    Call once at model-construction time (outside ``jit``) so the first
    traced step does not bake the metadata into its compile payload.
    No-op under a trace. ``backward=False`` skips the backward-pass
    (transposed) metadata — inference-only paths never differentiate,
    and those tables cost their own host build + device residency.
    """
    if not _trace_clean():
        return
    _flash_meta(spec)
    if backward:
        _flash_bwd_meta(spec)


def _pad(x, rows):
    if x.shape[1] == rows:
        return x
    return jnp.pad(x, ((0, 0), (0, rows - x.shape[1]), (0, 0)))


def _fused_fwd_impl(spec, q, k, v, scale, group):
    meta = _flash_meta(spec)
    R, s, hd = q.shape
    out, stats = fs.flash_sparse_attention_fwd(
        meta["block_cols"], meta["nblocks"], meta["mask_slot"],
        meta["is_partial"], meta["pmask"],
        _pad(q * scale, spec.m_pad), _pad(k, spec.n_pad),
        _pad(v, spec.n_pad),
        R=R, heads=spec.heads, mb=spec.mb, max_bpr=meta["max_bpr"],
        bm=spec.bm, bk=spec.bk, group=group, packed_stats=True)
    return out[:, :s], stats


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 4, 5))
def _fused(spec, q, k, v, scale, group):
    return _fused_fwd_impl(spec, q, k, v, scale, group)[0]


def _fused_f(spec, q, k, v, scale, group):
    out, stats = _fused_fwd_impl(spec, q, k, v, scale, group)
    return out, (q, k, v, out, stats)


def _fused_b(spec, scale, group, res, g):
    q, k, v, out, stats = res
    R, s, hd = q.shape
    meta = _flash_bwd_meta(spec)
    q_p = _pad(q * scale, spec.m_pad)
    k_p, v_p = _pad(k, spec.n_pad), _pad(v, spec.n_pad)
    g_p = _pad(g, spec.m_pad)
    # D = rowsum(g * out), lane 0 of the dcoef operand
    dcoef = _pad(jnp.sum(g.astype(jnp.float32) * out, axis=-1,
                         keepdims=True), spec.m_pad)
    common = dict(R=R, heads=spec.heads, bm=spec.bm, bk=spec.bk,
                  group=group)
    dq = fs.flash_sparse_bwd_dq(
        meta["block_cols"], meta["nblocks"], meta["mask_slot"],
        meta["is_partial"], meta["pmask"],
        q_p, k_p, v_p, g_p, stats, dcoef,
        mb=spec.mb, max_bpr=meta["max_bpr"], **common)
    dk, dv = fs.flash_sparse_bwd_dkv(
        meta["t_src_i"], meta["t_nblocks"], meta["t_mask_slot"],
        meta["t_is_partial"], meta["pmask"],
        q_p, k_p, v_p, g_p, stats, dcoef,
        kb=spec.kb, max_bpc=meta["max_bpc"], **common)
    if group > 1:
        # per-query-replica partials -> shared KV replica gradients
        R_kv = R // group
        dk = dk.reshape(R_kv, group, *dk.shape[1:]).sum(axis=1)
        dv = dv.reshape(R_kv, group, *dv.shape[1:]).sum(axis=1)
    return ((dq[:, :s] * scale).astype(q.dtype),
            dk[:, : k.shape[1]].astype(k.dtype),
            dv[:, : v.shape[1]].astype(v.dtype))


_fused.defvjp(_fused_f, _fused_b)


def fused_sparse_attention(spec: bp.BatchedPanelSpec, q, k, v,
                           scale=None, group: int = 1):
    """``q: [R, s, hd]`` with ``R = spec.B * spec.heads`` -> ``[R, s, hd]``;
    softmax over the nonzeros of each replica's mask row.

    ``group`` (GQA): ``k``/``v`` carry ``R // group`` replicas; each run of
    ``group`` consecutive query replicas reads its shared KV replica
    (``r // group`` — the head-minor ``b*heads + h`` fold order, as in
    the decode caches). KV HBM traffic and dk/dv
    accumulator memory shrink by ``group`` vs repeating K/V to full heads."""
    if q.shape[0] != spec.R:
        raise ValueError(f"replica dim {q.shape[0]} != spec.R {spec.R}")
    if q.shape[1] != spec.m:
        raise ValueError(f"seq {q.shape[1]} != mask rows {spec.m}")
    if group < 1 or spec.R % group or spec.heads % group:
        raise ValueError(f"group {group} must divide heads {spec.heads}")
    if k.shape[0] != q.shape[0] // group or v.shape[0] != q.shape[0] // group:
        raise ValueError(
            f"k/v replicas {k.shape[0]}/{v.shape[0]} != R // group "
            f"{q.shape[0] // group}")
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    return _fused(spec, q, k, v, float(scale), int(group))
