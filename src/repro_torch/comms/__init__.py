"""The port of ``repro/comms``: the buffer-planned executor of synthesized
schedules and the ``pccl_*`` collectives, on a stacked single-device
backend (every rank in one tensor) or one rank per process through
``torch.distributed``; and the error-feedback gradient compression."""

from repro_torch.comms.compression import (
    ef_int8_compress,
    ef_int8_decompress,
    error_feedback_all_reduce,
    topk_compress,
    topk_decompress,
)

from repro_torch.comms.executor import (
    STACKED,
    BufferPlan,
    DistBackend,
    StackedBackend,
    clear_plan_cache,
    execute_program,
    gather_slots,
    interpret_rounds,
    plan_buffers,
    plan_buffers_cached,
    plan_cache_stats,
)
from repro_torch.comms.primitives import (
    CollectiveSpec,
    interpret_collective,
    lower_algorithm,
    pccl_all_gather,
    pccl_all_reduce,
    pccl_all_to_all,
    pccl_reduce_scatter,
    synthesize_program,
)

__all__ = [
    "STACKED",
    "BufferPlan",
    "DistBackend",
    "StackedBackend",
    "clear_plan_cache",
    "execute_program",
    "gather_slots",
    "interpret_rounds",
    "plan_buffers",
    "plan_buffers_cached",
    "plan_cache_stats",
    "CollectiveSpec",
    "interpret_collective",
    "lower_algorithm",
    "pccl_all_gather",
    "pccl_all_reduce",
    "pccl_all_to_all",
    "pccl_reduce_scatter",
    "synthesize_program",
    "ef_int8_compress",
    "ef_int8_decompress",
    "error_feedback_all_reduce",
    "topk_compress",
    "topk_decompress",
]
