"""sputnik_tpu — a sparse linear-algebra framework in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of Torch-Sputnik
(CSR SpMM / SDDMM / sparse softmax / transpose, differentiable, with sparse
linear/attention/transformer modules on top): static padded CSR,
precomputed transpose permutations, block-CSR Pallas-Triton kernels for the
GPU, and a shard_map distribution layer the reference never had.
"""

from . import many_mask, ops, patterns
from .blocking import BlockView, CompressedView, EllView
from .many_mask import (
    ManyMaskTopology,
    csr_transpose_many_mask,
    sddmm_many_mask,
    sparse_softmax_many_mask,
    spmm_many_mask,
)
from .ops import (
    csr_transpose,
    decode,
    left_spmm,
    panel,
    sddmm,
    set_backend,
    sparse_softmax,
    spmm,
    spmm_bias,
    spmm_bias_relu,
)
from .ops.panel_api import PanelSpec
from .topology import SparseMatrix, SparseTopology, diffsort

__version__ = "0.1.0"


def __getattr__(name):
    # load the model/parallel/training layers lazily: importing the op and
    # topology layers stays cheap
    if name in ("models", "parallel", "training"):
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BlockView",
    "decode",
    "CompressedView",
    "EllView",
    "ManyMaskTopology",
    "PanelSpec",
    "panel",
    "SparseMatrix",
    "SparseTopology",
    "csr_transpose",
    "csr_transpose_many_mask",
    "sddmm_many_mask",
    "sparse_softmax_many_mask",
    "spmm_many_mask",
    "diffsort",
    "left_spmm",
    "ops",
    "patterns",
    "sddmm",
    "set_backend",
    "sparse_softmax",
    "spmm",
    "spmm_bias",
    "spmm_bias_relu",
]
