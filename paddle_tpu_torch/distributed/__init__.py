"""paddle.distributed, PyTorch port: data parallelism.

Counterpart of `paddle_tpu/distributed/`, so far as data-parallel
training needs it (ROADMAP item 7(a)): the world and its store (`env`),
the collectives on `torch.distributed` (`collective`, `communication`,
`communication.stream`), `DataParallel` (`parallel`), gloo's explicit
bring-up (`parallel_with_gloo`) and Fleet's collective mode with its
data-parallel meta-optimizers (`fleet`). NCCL on the card, gloo on the
CPU: see `env` for the device rule. The mesh, sharded checkpoints and the
model-parallel tier are item 7(b); the launcher, MoE's token exchange,
RPC, the parameter server and auto-parallel are item 7(c).
"""
from .env import (  # noqa: F401
    init_parallel_env, get_rank, get_world_size, ParallelEnv, is_initialized,
    get_store, TCPStore,
)
from .collective import (  # noqa: F401
    ReduceOp, Group, Task, ProcessGroup, new_group, get_group, all_reduce,
    all_gather, all_gather_object, reduce, broadcast, scatter, alltoall,
    alltoall_single, reduce_scatter, send, recv, isend, irecv, barrier, wait,
    destroy_process_group, get_backend, partial_send, partial_recv, P2POp,
    batch_isend_irecv,
)
from .parallel import DataParallel  # noqa: F401
from . import communication  # noqa: F401
from .communication import stream  # noqa: F401
from .parallel_with_gloo import (  # noqa: F401
    gloo_init_parallel_env, gloo_barrier, gloo_release,
)
from . import fleet  # noqa: F401
from .fleet.base.topology import ParallelMode  # noqa: F401

__all__ = [
    "init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
    "is_initialized", "get_store", "TCPStore", "ReduceOp", "Group", "Task",
    "ProcessGroup", "new_group", "get_group", "all_reduce", "all_gather",
    "all_gather_object", "reduce", "broadcast", "scatter", "alltoall",
    "alltoall_single", "reduce_scatter", "send", "recv", "isend", "irecv",
    "barrier", "wait", "destroy_process_group", "get_backend",
    "partial_send", "partial_recv", "P2POp", "batch_isend_irecv",
    "DataParallel", "communication", "stream", "gloo_init_parallel_env",
    "gloo_barrier", "gloo_release", "fleet", "ParallelMode",
]
