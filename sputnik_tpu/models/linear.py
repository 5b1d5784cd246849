"""SparseLinear: a linear layer with a CSR-sparse weight matrix.

Capability parity with the reference's ``SparseLinear``
(``modules/sparse_linear.py:69-89``): the weight is ``W_sp [out, in]`` in CSR
form, the trainable parameter is the nonzero values, and the layer computes
``y = (W_sp @ x^T)^T + b`` through the shared-sparse ``left_spmm`` path.
Differences:

  * The sparsity pattern is a static ``SparseTopology`` fixed at module
    construction (the reference re-derives CSR from a dense param via
    ``setup_sparse_tensors``; here topology is structure, values are state).
  * The trainable values live in the block-panel layout by default
    (``layout="panel"``): the forward is ONE fused SpMM kernel call with all
    batch dims folded into the dense columns — no per-replica launch loop
    (the reference loops kernel launches per batch element,
    ``src/left_replicated_spmm.cu:32-40``) and no per-step layout gathers.
    ``layout="csr"`` keeps the reference's flat value vector.
  * Bias + ReLU fuse into the ``spmm_bias_relu`` epilogue (the reference
    aspired to this via the phantom ``spmm_bias`` binding,
    ``tests/test_spmm_bias_relu.py:37``).
  * Gradients flow through ``jax.custom_vjp`` ops whose backward composes
    SDDMM + metadata-transposed SpMM (no cuSPARSE transpose per backward).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np

from ..ops import api as ops
from ..ops import panel_api as P
from ..topology import SparseTopology
from .module import Module

__all__ = ["SparseLinear", "sparse_kaiming_values"]


def sparse_kaiming_values(topo: SparseTopology, *, gain: float = 1.0):
    """Kaiming/He-uniform init over the *nonzero slots* of a topology.

    Scales by the effective fan-in (mean nonzeros per output row) so sparse
    layers start with the same output variance as their dense counterparts.
    Returns an ``init(key, shape, dtype)`` callable.
    """
    fan_in = max(float(topo.nnz) / max(topo.m, 1), 1.0)
    bound = gain * np.sqrt(3.0 / fan_in)
    valid = topo.valid

    def init(key, shape=(topo.nnz_pad,), dtype=jnp.float32):
        import jax

        vals = jax.random.uniform(key, shape, dtype, -bound, bound)
        return vals * jnp.asarray(valid, dtype)

    return init


@dataclasses.dataclass(frozen=True)
class SparseLinear(Module):
    """``y = act(W_sp @ x^T + b)^T`` with static weight sparsity.

    Attributes:
      topology: ``SparseTopology`` of the weight, shape ``[features_out,
        features_in]`` (``m = out``, ``n = in``).
      use_bias: add a per-output-feature bias.
      fuse_relu: apply the fused bias+ReLU SpMM epilogue.
      layout: ``"panel"`` (canonical block panel values) or ``"csr"``
        (reference-parity flat value vector).
      param_dtype: dtype of the value parameter.
    """

    topology: SparseTopology
    use_bias: bool = True
    fuse_relu: bool = False
    layout: str = "panel"
    param_dtype: Any = jnp.float32

    @classmethod
    def from_mask(cls, mask: np.ndarray, **kwargs) -> "SparseLinear":
        return cls(topology=SparseTopology.from_dense_mask(mask), **kwargs)

    @property
    def features_out(self) -> int:
        return self.topology.m

    @property
    def features_in(self) -> int:
        return self.topology.n

    def spec(self) -> P.PanelSpec:
        return P.PanelSpec(self.topology)

    def pack_dense(self, w_dense: np.ndarray) -> np.ndarray:
        """Dense ``[out, in]`` weight -> this layer's value-param layout
        (the reference's ``copy_params`` direction, ``test_linear.py:87-99``)."""
        t = self.topology
        w_dense = np.asarray(w_dense, np.float32)
        vals = np.zeros(t.nnz_pad, np.float32)
        vals[: t.nnz] = w_dense[t.row_ids[: t.nnz], t.column_indices[: t.nnz]]
        if self.layout == "panel":
            spec = self.spec()
            return P.values_to_panel_np(t, vals, spec.bm, spec.bk)
        return vals

    def unpack_dense(self, values_param) -> np.ndarray:
        """Value param (either layout) -> dense ``[out, in]`` weight."""
        t = self.topology
        vp = np.asarray(values_param, np.float32)
        if self.layout == "panel":
            spec = self.spec()
            vals = P.panel_to_values_np(t, vp, spec.bm, spec.bk)
        else:
            vals = vp
        out = np.zeros((t.m, t.n), np.float32)
        out[t.row_ids[: t.nnz], t.column_indices[: t.nnz]] = vals[: t.nnz]
        return out

    def forward(self, scope, x):
        t = self.topology
        if x.shape[-1] != t.n:
            raise ValueError(f"input features {x.shape[-1]} != {t.n}")
        if self.layout not in ("panel", "csr"):
            raise ValueError(f"unknown layout {self.layout!r}")

        bias = (
            scope.param("bias", lambda k, s, d: jnp.zeros(s, d), (t.m,),
                        self.param_dtype)
            if self.use_bias
            else None
        )

        lead = x.shape[:-1]
        xt = x.reshape(-1, t.n).T  # [in, N] — all batch dims fold to columns

        if self.layout == "panel":
            spec = self.spec()
            values = scope.param(
                "values",
                P.panel_kaiming_values(t, spec.bm, spec.bk),
                spec.view.values_shape,
                self.param_dtype,
            )
            if self.fuse_relu:
                b = bias if bias is not None else jnp.zeros((t.m,), x.dtype)
                y = P.spmm_bias_relu(spec, values, xt, b)  # [out, N]
            else:
                y = P.spmm(spec, values, xt)
                if bias is not None:
                    y = y + bias[:, None]
        else:
            values = scope.param(
                "values", sparse_kaiming_values(t), (t.nnz_pad,),
                self.param_dtype,
            )
            if self.fuse_relu:
                b = bias if bias is not None else jnp.zeros((t.m,), x.dtype)
                y = ops.spmm_bias_relu(t, values, xt, b)
            else:
                y = ops.left_spmm(t, values, xt)
                if bias is not None:
                    y = y + bias[:, None]

        return y.T.reshape(*lead, t.m)
