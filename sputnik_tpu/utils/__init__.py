"""Observability + persistence utilities.

The reference has neither (SURVEY.md §5: ad-hoc CUDA-event timing in two
test files, no checkpointing); these are first-class here.
"""

from .checkpoint import restore_checkpoint, save_checkpoint
from .compile_cache import enable_compile_cache
from .elastic import ElasticState, device_healthy, run_elastic
from .profiling import measure, roofline, trace

__all__ = [
    "ElasticState",
    "enable_compile_cache",
    "device_healthy",
    "run_elastic",
    "measure",
    "roofline",
    "trace",
    "save_checkpoint",
    "restore_checkpoint",
]
