from . import decode
from . import paged
from . import panel_api as panel
from .api import (
    csr_transpose,
    get_backend,
    left_spmm,
    sddmm,
    set_backend,
    sparse_softmax,
    spmm,
    spmm_bias,
    spmm_bias_relu,
)

__all__ = [
    "csr_transpose",
    "decode",
    "get_backend",
    "left_spmm",
    "panel",
    "sddmm",
    "set_backend",
    "sparse_softmax",
    "spmm",
    "spmm_bias",
    "spmm_bias_relu",
]
