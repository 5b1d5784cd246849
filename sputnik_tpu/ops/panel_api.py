"""Panel-native differentiable ops — the canonical hot path.

The flat-CSR op set (``ops/api.py``) keeps the reference's calling
convention (``values[nnz]`` in CSR order, ``src/sputnik.cpp:36-42``), but a
layout change of 10^6+ elements is a multi-ms gather. So the framework's
*device* layout for sparse values is the block panel
``f32[mb, max_bpr, bm, bk]`` (``blocking.BlockView``), and this module closes
the whole op algebra over that layout with ZERO element permutations:

  * ``spmm``          : panel  x dense  -> dense      (BSR kernel)
  * ``spmm_t``        : panel^T x dense -> dense      (transposed *metadata*,
                        tiles transposed inside the contraction)
  * ``sddmm``         : dense x dense   -> panel      (BSR kernel)
  * ``sparse_softmax``: panel -> panel               (axis reductions)
  * backward passes compose the same three kernels, exactly the reference's
    algebra (``modules/spmm.py:40-74``, ``modules/sddmm.py:41-75``) but
    permutation-free.

CSR <-> panel conversion happens once at the boundary
(``values_to_panel`` / ``panel_to_values``), host-side for module init and
checkpoint import/export.

Each op calls its kernel module's entry, which runs the Pallas-Triton
kernel on a GPU and the plain block-gather version elsewhere
(``_common.route``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ._common import round_up as _round_up
from .pallas import bsr_compressed as _c
from .pallas import bsr_sddmm as _sddmm_mod
from .pallas import bsr_spmm as _spmm_mod
from .pallas import bsr_spmm_t as _spmm_t_mod

__all__ = [
    "PanelSpec",
    "default_block",
    "values_to_panel",
    "values_to_panel_np",
    "panel_to_values",
    "panel_to_values_np",
    "panel_kaiming_values",
    "spmm",
    "spmm_t",
    "sddmm",
    "sparse_softmax",
    "spmm_bias_relu",
]


def default_block(topo) -> Tuple[int, int]:
    """Block tile ``(bm, bk)``: 128 x 128 — one Triton program's output
    rows by the walk's block width. Both are powers of two, and each
    pipelined stage (a ``128 x 32`` panel chunk plus a ``32 x 128`` dense
    chunk) stays far inside a block's 227 KB of shared memory."""
    del topo
    return 128, 128


# ---------------------------------------------------------------------------
# Layout conversion (boundary only).
# ---------------------------------------------------------------------------


def _view(topo, bm, bk, compressed=False):
    if compressed:
        from ..blocking import build_compressed

        # cache on the (dataclass) BlockView it derives from — the topology
        # itself is __slots__-only
        bv = topo.block(bm, bk)
        cached = getattr(bv, "_compressed_view", None)
        if cached is None:
            cached = build_compressed(topo, bm=bm, bk=bk)
            object.__setattr__(bv, "_compressed_view", cached)
        return cached
    return topo.block(bm, bk)


def values_to_panel_np(topo, values: np.ndarray, bm: int, bk: int,
                       *, compressed: bool = False):
    """Host-side CSR values -> panel (module init / checkpoint import).
    Dtype-preserving (bf16 serving params stay bf16)."""
    bv = _view(topo, bm, bk, compressed)
    values = np.asarray(values)
    flat = np.zeros(bv.dump + 1, dtype=values.dtype)
    flat[bv.scatter_idx] = values
    return flat[: bv.dump].reshape(bv.values_shape)


def panel_to_values_np(topo, panel: np.ndarray, bm: int, bk: int,
                       *, compressed: bool = False):
    """Host-side panel -> CSR values (checkpoint export). Dtype-preserving."""
    bv = _view(topo, bm, bk, compressed)
    panel = np.asarray(panel)
    flat = np.concatenate(
        [panel.reshape(-1), np.zeros(1, panel.dtype)]
    )
    return flat[np.minimum(bv.gather_idx, bv.dump)]


def values_to_panel(topo, values, bm: int, bk: int,
                    *, compressed: bool = False):
    """Device-side scatter (boundary op — NOT for per-step use at scale)."""
    bv = _view(topo, bm, bk, compressed)
    flat = jnp.zeros((bv.dump + 1,), values.dtype)
    flat = flat.at[jnp.asarray(bv.scatter_idx)].set(values)
    return flat[: bv.dump].reshape(bv.values_shape)


def panel_to_values(topo, panel, bm: int, bk: int,
                    *, compressed: bool = False):
    bv = _view(topo, bm, bk, compressed)
    flat = jnp.concatenate(
        [panel.reshape(-1), jnp.zeros((1,), panel.dtype)]
    )
    return jnp.take(flat, jnp.asarray(bv.gather_idx))


def panel_kaiming_values(topo, bm: int, bk: int, *, gain: float = 1.0,
                         compressed: bool = False):
    """Kaiming-uniform init over nonzero slots, in panel layout
    (ELL or, with ``compressed=True``, the true-BSR layout)."""
    bv = _view(topo, bm, bk, compressed)
    fan_in = max(float(topo.nnz) / max(topo.m, 1), 1.0)
    bound = gain * np.sqrt(3.0 / fan_in)

    def init(key, shape=bv.values_shape, dtype=jnp.float32):
        vals = jax.random.uniform(key, shape, dtype, -bound, bound)
        return vals * jnp.asarray(bv.mask, dtype)

    return init


class PanelSpec:
    """Static (topology, bm, bk[, bn]) bundle for panel ops; hashable
    identity. ``bn`` overrides the output-tile width heuristic."""

    __slots__ = ("topo", "bm", "bk", "bn", "compressed", "_view")

    def __init__(self, topo, bm: Optional[int] = None,
                 bk: Optional[int] = None, bn: Optional[int] = None,
                 compressed: bool = False):
        dbm, dbk = default_block(topo)
        self.topo = topo
        self.bm = bm or dbm
        self.bk = bk or dbk
        self.bn = bn
        self.compressed = compressed
        self._view = _view(topo, self.bm, self.bk, compressed)

    @property
    def view(self):
        return self._view

    def __hash__(self):
        return hash((id(self.topo), self.bm, self.bk, self.bn,
                     self.compressed))

    def __eq__(self, other):
        return (
            isinstance(other, PanelSpec)
            and self.topo is other.topo
            and (self.bm, self.bk, self.bn, self.compressed)
            == (other.bm, other.bk, other.bn, other.compressed)
        )

    def __repr__(self):
        return (f"PanelSpec({self.topo!r}, bm={self.bm}, bk={self.bk}, "
                f"bn={self.bn})")


def _spec(spec) -> PanelSpec:
    return spec if isinstance(spec, PanelSpec) else PanelSpec(spec)


# ---------------------------------------------------------------------------
# Raw impls (each kernel entry picks the kernel or the plain version).
# ---------------------------------------------------------------------------


def _check_rows(name, x, n_true, n_pad):
    """The padding paths below silently zero-fill missing rows — a
    wrong-sized operand (forgotten transpose, wrong feature dim) would
    return plausible wrong numerics, so reject it here (the flat-CSR
    layer's `_check_dense` equivalent for the panel hot path)."""
    if x.ndim != 2:
        raise ValueError(f"{name} must be rank 2, got shape {x.shape}")
    if x.shape[0] not in (n_true, n_pad):
        raise ValueError(
            f"{name} has {x.shape[0]} rows; expected {n_true} "
            f"(or tile-padded {n_pad})")


def _match_dtypes(panel, dense):
    """Promote to a common dtype (accumulation is always f32)."""
    if panel.dtype != dense.dtype:
        dt = jnp.promote_types(panel.dtype, dense.dtype)
        panel, dense = panel.astype(dt), dense.astype(dt)
    return panel, dense


def _pad2(x, rows, cols):
    """Zero-pad a 2-D operand to ``[rows, cols]`` (no copy when it already
    has that shape — the hot path)."""
    if x.shape == (rows, cols):
        return x
    return jnp.zeros((rows, cols), x.dtype).at[
        : x.shape[0], : x.shape[1]].set(x)


def _out_tile(q: int, cap: int) -> int:
    """Output-tile width: 16 for narrow outputs, ``cap`` otherwise."""
    return cap if q > cap // 2 else 16


def _spmm_impl(spec, panel, dense, bias=None, epilogue="none"):
    t, bv = spec.topo, spec.view
    _check_rows("dense", dense, t.n, bv.n_pad)
    panel, dense = _match_dtypes(panel, dense)
    n_out = dense.shape[-1]
    bn = spec.bn or _out_tile(n_out, 128)
    dense_pad = _pad2(dense, bv.n_pad, _round_up(max(n_out, 1), bn))
    bias_pad = None
    if bias is not None:
        bias_pad = jnp.zeros((bv.m_pad,), jnp.promote_types(
            bias.dtype, jnp.float32)).at[: t.m].set(bias)
    if spec.compressed:
        out = _c.bsr_spmm_panel_c(
            jnp.asarray(bv.block_offsets), jnp.asarray(bv.block_cols),
            panel, dense_pad,
            None if bias_pad is None else bias_pad[:, None],
            mb=bv.mb, max_bpr=bv.max_bpr, num_blocks=bv.num_blocks,
            bm=spec.bm, bk=spec.bk, bn=bn, epilogue=epilogue)
        return out[: t.m, :n_out]
    out = _spmm_mod.bsr_spmm_batched(
        jnp.asarray(bv.block_cols.reshape(1, -1)),
        jnp.asarray(bv.nblocks[None]), panel[None], dense_pad[None],
        bias_pad, bn=bn, epilogue=epilogue,
        mask=jnp.asarray(bv.mask[None]))[0]
    return out[: t.m, :n_out]


def _spmm_t_impl(spec, panel, g):
    """``A^T @ G`` off the original panel."""
    t, bv = spec.topo, spec.view
    _check_rows("g", g, t.m, bv.m_pad)
    panel, g = _match_dtypes(panel, g)
    t_nblocks, t_src = bv.transpose_meta()
    q_out = g.shape[-1]
    g_pad = _pad2(g, bv.m_pad, q_out)
    if spec.compressed:
        out = _c.bsr_spmm_t_panel_c(
            jnp.asarray(t_src[:, :, 0].reshape(-1)),
            jnp.asarray(t_src[:, :, 1].reshape(-1)),
            jnp.asarray(t_nblocks), panel, g_pad,
            kb=bv.kb, max_bpc=t_src.shape[1], num_blocks=bv.num_blocks,
            bm=spec.bm, bk=spec.bk)
        return out[: t.n]
    out = _spmm_t_mod.bsr_spmm_t_batched(
        jnp.asarray(t_src[:, :, 0].reshape(1, -1)),
        jnp.asarray(t_src[:, :, 1].reshape(1, -1)),
        jnp.asarray(t_nblocks[None]), panel[None], g_pad[None],
        kb=bv.kb)[0]
    return out[: t.n]


def _sddmm_impl(spec, lhs, rhs):
    t, bv = spec.topo, spec.view
    _check_rows("lhs", lhs, t.m, bv.m_pad)
    _check_rows("rhs", rhs, t.n, bv.n_pad)
    lhs, rhs = _match_dtypes(lhs, rhs)
    d_pad = _round_up(max(lhs.shape[-1], 1), 16)
    lhs_pad = _pad2(lhs, bv.m_pad, d_pad)
    rhs_pad = _pad2(rhs, bv.n_pad, d_pad)
    if spec.compressed:
        return _c.bsr_sddmm_panel_c(
            jnp.asarray(bv.block_offsets), jnp.asarray(bv.block_cols),
            lhs_pad, rhs_pad, jnp.asarray(bv.mask, jnp.float32),
            mb=bv.mb, max_bpr=bv.max_bpr, num_blocks=bv.num_blocks,
            bm=spec.bm, bk=spec.bk)
    return _sddmm_mod.bsr_sddmm_batched(
        jnp.asarray(bv.block_cols.reshape(1, -1)),
        jnp.asarray(bv.nblocks[None]),
        jnp.asarray(bv.mask[None], jnp.float32),
        lhs_pad[None], rhs_pad[None])[0]


_NEG_LARGE = -1e30


def _softmax_impl(spec, panel):
    """Masked row softmax on the panel.

    ELL layout: reduce over the (slot, lane) axes directly. Compressed
    layout: rows are ragged across back-to-back blocks, so the reduction is
    a segment reduction over the block->row-block map.
    """
    if spec.compressed:
        bv = spec.view
        return _c.c_softmax(jnp.asarray(bv.block_offsets), panel,
                            jnp.asarray(bv.mask), mb=bv.mb)
    mask = jnp.asarray(spec.view.mask)
    v = jnp.where(mask, panel, _NEG_LARGE)
    row_max = jnp.max(v, axis=(1, 3), keepdims=True)
    row_max = jnp.maximum(row_max, _NEG_LARGE)
    e = jnp.where(mask, jnp.exp(v - row_max), 0.0)
    denom = jnp.sum(e, axis=(1, 3), keepdims=True)
    return e / jnp.maximum(denom, jnp.finfo(panel.dtype).tiny)


# ---------------------------------------------------------------------------
# custom_vjp ops.
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def spmm(spec, panel, dense):
    """``A_panel @ dense``: ``[mb,max_bpr,bm,bk] x [n, q] -> [m, q]``."""
    return _spmm_impl(_spec(spec), panel, dense)


def _spmm_fwd(spec, panel, dense):
    return _spmm_impl(_spec(spec), panel, dense), (panel, dense)


def _spmm_bwd(spec, res, g):
    spec = _spec(spec)
    panel, dense = res
    d_panel = _sddmm_impl(spec, g, dense)
    d_dense = _spmm_t_impl(spec, panel, g)
    # cotangent dtypes must match the primals (bf16-streamed training)
    return d_panel.astype(panel.dtype), d_dense.astype(dense.dtype)


spmm.defvjp(_spmm_fwd, _spmm_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def spmm_t(spec, panel, dense):
    """``A_panel^T @ dense``: ``[n, q]`` from ``dense [m, q]``."""
    return _spmm_t_impl(_spec(spec), panel, dense)


def _spmm_t_fwd(spec, panel, dense):
    return _spmm_t_impl(_spec(spec), panel, dense), (panel, dense)


def _spmm_t_bwd(spec, res, g):
    spec = _spec(spec)
    panel, dense = res
    # out = A^T d  =>  dA = d g^T sampled = sddmm(dense_cotangent pair)
    d_panel = _sddmm_impl(spec, dense, g)
    d_dense = _spmm_impl(spec, panel, g)
    return d_panel.astype(panel.dtype), d_dense.astype(dense.dtype)


spmm_t.defvjp(_spmm_t_fwd, _spmm_t_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sddmm(spec, lhs, rhs):
    """Sampled ``lhs @ rhs^T`` -> panel values."""
    return _sddmm_impl(_spec(spec), lhs, rhs)


def _sddmm_fwd(spec, lhs, rhs):
    return _sddmm_impl(_spec(spec), lhs, rhs), (lhs, rhs)


def _sddmm_bwd(spec, res, g_panel):
    spec = _spec(spec)
    lhs, rhs = res
    d_lhs = _spmm_impl(spec, g_panel, rhs)
    d_rhs = _spmm_t_impl(spec, g_panel, lhs)
    return d_lhs.astype(lhs.dtype), d_rhs.astype(rhs.dtype)


sddmm.defvjp(_sddmm_fwd, _sddmm_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def sparse_softmax(spec, panel):
    """Row-wise softmax over nonzeros, panel layout in and out."""
    return _softmax_impl(_spec(spec), panel)


def _softmax_fwd(spec, panel):
    p = _softmax_impl(_spec(spec), panel)
    return p, p


def _softmax_bwd(spec, p, g):
    spec = _spec(spec)
    if spec.compressed:
        # g_x = p * (g - rowsum(p*g)); the ragged rowsum is a segment sum
        # over the block->row-block map. p is 0 at the dump slot but an
        # undefined upstream cotangent there (0 * NaN = NaN) must not leak
        # into the raw gradient array
        bv = spec.view
        rows = jnp.asarray(bv.block_rows)
        pg = jnp.where(jnp.asarray(bv.mask), p * g, 0.0)
        rs = jax.ops.segment_sum(jnp.sum(pg, axis=2), rows,
                                 num_segments=bv.mb)
        out = p * (g - rs[rows][:, :, None])
        return (jnp.where(jnp.asarray(bv.mask), out, 0.0),)
    pg = p * g
    rs = jnp.sum(pg, axis=(1, 3), keepdims=True)
    return (p * (g - rs),)


sparse_softmax.defvjp(_softmax_fwd, _softmax_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def spmm_bias_relu(spec, panel, dense, bias):
    """Fused ``relu(A_panel @ dense + bias[:, None])``."""
    return _spmm_impl(_spec(spec), panel, dense, bias, epilogue="bias_relu")


def _spmm_br_fwd(spec, panel, dense, bias):
    out = _spmm_impl(_spec(spec), panel, dense, bias, epilogue="bias_relu")
    return out, (panel, dense, bias, out)


def _spmm_br_bwd(spec, res, g):
    spec = _spec(spec)
    panel, dense, bias, out = res
    ge = jnp.where(out > 0, g, 0.0)
    d_panel = _sddmm_impl(spec, ge, dense)
    d_dense = _spmm_t_impl(spec, panel, ge)
    d_bias = jnp.sum(ge, axis=-1)
    return (d_panel.astype(panel.dtype), d_dense.astype(dense.dtype),
            d_bias.astype(bias.dtype))


spmm_bias_relu.defvjp(_spmm_br_fwd, _spmm_br_bwd)
