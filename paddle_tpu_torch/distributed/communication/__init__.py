"""paddle.distributed.communication, PyTorch port: the per-primitive
package of `paddle_tpu/distributed/communication/`. The eager collectives
live in `distributed.collective`; this package re-exports them under the
reference's layout, with the `stream` variants."""
from ..collective import (  # noqa: F401
    ReduceOp, all_reduce, all_gather, all_gather_object, alltoall,
    alltoall_single, broadcast, reduce, reduce_scatter, scatter, send, recv,
    isend, irecv, batch_isend_irecv, P2POp, barrier, wait, get_group,
    destroy_process_group,
)
from ..env import is_initialized  # noqa: F401
from . import stream  # noqa: F401

__all__ = ["stream", "ReduceOp", "all_reduce", "all_gather",
           "all_gather_object", "alltoall", "alltoall_single", "broadcast",
           "reduce", "reduce_scatter", "scatter", "send", "recv", "isend",
           "irecv", "batch_isend_irecv", "P2POp", "barrier", "wait",
           "get_group", "destroy_process_group", "is_initialized"]
