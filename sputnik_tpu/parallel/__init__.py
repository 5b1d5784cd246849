"""Distribution layer: sharded sparse ops over a device mesh.

The reference has no parallelism of any kind (SURVEY.md §2 "Parallelism /
distribution inventory": no DP/TP/PP/SP, no NCCL/MPI — its only batching is
a single-stream host loop, ``src/spmm_cuda.cu:48``). This package adds the
distribution the BASELINE north star asks for: the sparse operand
row-partitioned across devices (nnz-balanced via the row swizzle), dense
operands replicated or column-sharded, XLA collectives (``psum`` /
``all_gather``) over the interconnect, inserted by ``shard_map``.
"""

from .partition import RowPartition
from .flash_sharded import (ShardedFlashSpec, flash_attention_sharded,
                            flash_attention_kv_sharded)
from .ring_flash import RingFlashSpec, ring_flash_attention
from .pipeline import PipelineSpec, pipeline_apply, stack_stage_params
from .lm_tp import TPLMServer
from .serving_tp import PagedTPDecoder, TPDecoder
from .sharded_compressed import (
    ShardedCompressedSpec,
    sharded_sddmm_c,
    sharded_softmax_c,
    sharded_spmm_c,
    sharded_spmm_t_c,
    sparse_attention_sharded_c,
)
from .sharded_ops import (
    ShardedPanelSpec,
    sharded_sddmm,
    sharded_spmm_halo,
    sharded_softmax,
    sharded_spmm,
    sharded_spmm_t,
    sparse_attention_sharded,
)

__all__ = [
    "PagedTPDecoder",
    "PipelineSpec",
    "TPLMServer",
    "RowPartition",
    "TPDecoder",
    "ShardedCompressedSpec",
    "ShardedFlashSpec",
    "ShardedPanelSpec",
    "flash_attention_sharded",
    "flash_attention_kv_sharded",
    "RingFlashSpec",
    "ring_flash_attention",
    "pipeline_apply",
    "stack_stage_params",
    "sharded_spmm",
    "sharded_spmm_c",
    "sharded_spmm_halo",
    "sharded_spmm_t",
    "sharded_spmm_t_c",
    "sharded_sddmm",
    "sharded_sddmm_c",
    "sharded_softmax",
    "sharded_softmax_c",
    "sparse_attention_sharded",
    "sparse_attention_sharded_c",
]
