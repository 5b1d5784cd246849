"""Differentiable public op set.

This layer replaces the reference's two bottom
layers at once: the pybind11 bindings (``src/sputnik.cpp:36-42``) and the
hand-written ``torch.autograd.Function`` wrappers (``modules/spmm.py:8-74``,
``modules/sddmm.py:9-75``). Each op is a ``jax.custom_vjp`` whose backward
*composes the forward ops*, exactly the algebra the reference uses:

  * SpMM   backward = SDDMM (sparse grad) + transposed SpMM (dense grad)
  * SDDMM  backward = SpMM + transposed SpMM
  * softmax backward = the correct row-wise VJP (the reference's demo version
    is mathematically wrong — see ``panel_api.sparse_softmax``)
  * CSR transpose is a precomputed value permutation (plain differentiable
    gather), not a cuSPARSE call per backward.

Topologies are static (``nondiff_argnums``), so jitted training steps close
over them as constants; values/dense operands are the traced arguments.

Batched ("replicated") semantics mirror the reference bindings:

  * ``spmm(topo, values[r,nnz], dense[r,k,n])``   per-replica values
    (``src/spmm_cuda.cu:29-30,48-57``)
  * ``left_spmm(topo, values[nnz], dense[r,k,n])`` one shared sparse matrix
    (``src/left_replicated_spmm.cu:8-44``) — implemented as ``vmap`` with an
    unmapped values axis, which also gives the *correct* summed values-grad
    the reference never implemented.

Every flat op runs through the block-panel ops (``ops/pallas/dispatch``),
whose route ``set_backend("xla" | "pallas" | "auto")`` steers: ``"xla"``
forces the plain versions XLA compiles, ``"pallas"`` forces the
Pallas-Triton kernels (GPU only), ``"auto"`` takes the kernels on a GPU
and the plain versions elsewhere (``ops/_common.route``).
"""

from __future__ import annotations

import functools
import threading
from typing import Tuple

import jax
import jax.numpy as jnp


__all__ = [
    "spmm",
    "left_spmm",
    "sddmm",
    "sparse_softmax",
    "csr_transpose",
    "spmm_bias_relu",
    "spmm_bias",
    "set_backend",
    "get_backend",
]

_state = threading.local()


def set_backend(name: str) -> None:
    """``"auto"`` (kernels on a GPU, plain versions elsewhere), ``"xla"``
    (plain versions everywhere) or ``"pallas"`` (kernels; needs a GPU)."""
    if name not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown backend {name!r}")
    if name == "pallas":
        from ._common import on_gpu

        if not on_gpu():
            raise ValueError("set_backend('pallas') needs a GPU")
    _state.backend = name
    # cached eager closures have their route baked in
    from .pallas import dispatch as _dispatch

    _dispatch.flush_caches()


def get_backend() -> str:
    return getattr(_state, "backend", "auto")


# ---------------------------------------------------------------------------
# Core 2-D impls: the panel ops behind the flat surface.
# ---------------------------------------------------------------------------


def _spmm_impl(topo, values, dense):
    from .pallas import dispatch

    return dispatch.spmm(topo, values, dense)


def _sddmm_impl(topo, lhs, rhs):
    from .pallas import dispatch

    return dispatch.sddmm(topo, lhs, rhs)


def _transpose_values(topo, values):
    _, perm = topo.transpose()
    return jnp.take(values, jnp.asarray(perm))


# ---------------------------------------------------------------------------
# custom_vjp cores.
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _spmm(topo, values, dense):
    return _spmm_impl(topo, values, dense)


def _spmm_fwd(topo, values, dense):
    return _spmm_impl(topo, values, dense), (values, dense)


def _spmm_bwd(topo, res, g):
    values, dense = res
    # cotangent dtypes must match the primals (mixed bf16/f32 operands
    # promote in the impls; custom_vjp rejects promoted grads)
    d_values = _sddmm_impl(topo, g, dense).astype(values.dtype)
    topo_t, _ = topo.transpose()
    d_dense = _spmm_impl(topo_t, _transpose_values(topo, values),
                         g).astype(dense.dtype)
    return d_values, d_dense


_spmm.defvjp(_spmm_fwd, _spmm_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _sddmm(topo, lhs, rhs):
    return _sddmm_impl(topo, lhs, rhs)


def _sddmm_fwd(topo, lhs, rhs):
    return _sddmm_impl(topo, lhs, rhs), (lhs, rhs)


def _sddmm_bwd(topo, res, g):
    lhs, rhs = res
    d_lhs = _spmm_impl(topo, g, rhs).astype(lhs.dtype)
    topo_t, _ = topo.transpose()
    d_rhs = _spmm_impl(topo_t, _transpose_values(topo, g),
                       lhs).astype(rhs.dtype)
    return d_lhs, d_rhs


_sddmm.defvjp(_sddmm_fwd, _sddmm_bwd)


def _sparse_softmax(topo, values):
    from .pallas import dispatch

    return dispatch.sparse_softmax(topo, values)


def _spmm_bias_relu_impl(topo, values, dense, bias):
    from .pallas import dispatch

    return dispatch.spmm_bias_relu(topo, values, dense, bias, relu=True)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _spmm_bias_relu(topo, values, dense, bias):
    return _spmm_bias_relu_impl(topo, values, dense, bias)


def _spmm_bias_relu_fwd(topo, values, dense, bias):
    out = _spmm_bias_relu_impl(topo, values, dense, bias)
    # zero-size dtype token for the bias cotangent cast
    return out, (values, dense, jnp.zeros((0,), bias.dtype), out)


def _spmm_bias_relu_bwd(topo, res, g):
    values, dense, bias_dtype, out = res
    ge = jnp.where(out > 0, g, 0.0)
    d_values = _sddmm_impl(topo, ge, dense).astype(values.dtype)
    topo_t, _ = topo.transpose()
    d_dense = _spmm_impl(topo_t, _transpose_values(topo, values),
                         ge).astype(dense.dtype)
    d_bias = jnp.sum(ge, axis=-1).astype(bias_dtype.dtype)
    return d_values, d_dense, d_bias


_spmm_bias_relu.defvjp(_spmm_bias_relu_fwd, _spmm_bias_relu_bwd)


# ---------------------------------------------------------------------------
# Public API (shape dispatch, reference-style batching rules).
# ---------------------------------------------------------------------------


def _check_dense(topo, dense):
    if dense.shape[-2] != topo.n:
        raise ValueError(
            f"dense rows {dense.shape[-2]} != sparse cols {topo.n}"
        )


def spmm(topo, values, dense):
    """``A_sp @ B``. 2-D: ``values[nnz], dense[k,n] -> [m,n]``; replicated:
    ``values[r,nnz], dense[r,k,n] -> [r,m,n]`` (reference asserts
    ``values.dim() == dense.dim() - 1``, ``src/spmm_cuda.cu:22``)."""
    _check_dense(topo, dense)
    if values.ndim == 1 and dense.ndim == 2:
        return _spmm(topo, values, dense)
    if values.ndim == 2 and dense.ndim == 3:
        return jax.vmap(_spmm, in_axes=(None, 0, 0))(topo, values, dense)
    raise ValueError(f"bad ranks: values {values.shape}, dense {dense.shape}")


def left_spmm(topo, values, dense):
    """One shared sparse matrix times batched dense: ``values[nnz],
    dense[r,k,n] -> [r,m,n]`` (``src/left_replicated_spmm.cu:8-44``).

    Because the sparse operand is shared, the replica axis folds into the
    dense *columns* — one big SpMM instead of the reference's
    per-replica kernel-launch loop (``:32-40``)."""
    _check_dense(topo, dense)
    if values.ndim != 1:
        raise ValueError(f"left_spmm values must be 1-D, got {values.shape}")
    if dense.ndim == 2:
        return _spmm(topo, values, dense)
    if dense.ndim == 3:
        r, k, n = dense.shape
        folded = jnp.transpose(dense, (1, 0, 2)).reshape(k, r * n)
        out = _spmm(topo, values, folded)  # [m, r*n]
        return jnp.transpose(out.reshape(topo.m, r, n), (1, 0, 2))
    raise ValueError(f"bad dense rank: {dense.shape}")


def sddmm(topo, lhs, rhs):
    """Sampled ``L @ R^T`` on the topology's nonzeros. ``lhs[m,d], rhs[n,d]
    -> values[nnz]``; batched 3-D operands -> ``[r, nnz]``."""
    if lhs.shape[-2] != topo.m or rhs.shape[-2] != topo.n:
        raise ValueError(
            f"lhs rows {lhs.shape[-2]} != m={topo.m} or "
            f"rhs rows {rhs.shape[-2]} != n={topo.n}"
        )
    if lhs.ndim == 2 and rhs.ndim == 2:
        return _sddmm(topo, lhs, rhs)
    if lhs.ndim == 3 and rhs.ndim == 3:
        return jax.vmap(_sddmm, in_axes=(None, 0, 0))(topo, lhs, rhs)
    raise ValueError(f"bad ranks: lhs {lhs.shape}, rhs {rhs.shape}")


def sparse_softmax(topo, values):
    """Row-wise softmax over nonzeros; ``[nnz]`` or replicated ``[r, nnz]``."""
    if values.ndim == 1:
        return _sparse_softmax(topo, values)
    if values.ndim == 2:
        return jax.vmap(_sparse_softmax, in_axes=(None, 0))(topo, values)
    raise ValueError(f"bad values rank: {values.shape}")


def csr_transpose(topo, values) -> Tuple[object, jnp.ndarray]:
    """CSR -> CSC as a precomputed permutation: returns ``(topo_t,
    values_t)``. Differentiable (plain gather); replaces the per-call
    cuSPARSE conversion at ``src/transpose_cuda.cu:90-99``."""
    topo_t, perm = topo.transpose()
    perm = jnp.asarray(perm)
    if values.ndim == 1:
        return topo_t, jnp.take(values, perm)
    if values.ndim == 2:
        return topo_t, jnp.take(values, perm, axis=1)
    raise ValueError(f"bad values rank: {values.shape}")


def spmm_bias_relu(topo, values, dense, bias):
    """Fused ``relu(A_sp @ B + bias[:, None])`` — the epilogue the reference
    targets with Sputnik's ``CudaSpmmBiasRelu`` (phantom ``spmm_bias``
    binding, ``tests/test_spmm_bias_relu.py:37``). ``bias: f32[m]``."""
    _check_dense(topo, dense)
    if bias.shape != (topo.m,):
        raise ValueError(f"bias must be [m]={topo.m}, got {bias.shape}")
    if values.ndim == 1 and dense.ndim == 2:
        return _spmm_bias_relu(topo, values, dense, bias)
    if values.ndim == 1 and dense.ndim == 3:
        return jax.vmap(_spmm_bias_relu, in_axes=(None, None, 0, None))(
            topo, values, dense, bias
        )
    if values.ndim == 2 and dense.ndim == 3:
        return jax.vmap(_spmm_bias_relu, in_axes=(None, 0, 0, None))(
            topo, values, dense, bias
        )
    raise ValueError(f"bad ranks: values {values.shape}, dense {dense.shape}")


# Reference phantom-API name.
spmm_bias = spmm_bias_relu
