"""Fleet, PyTorch port: its collective mode (`fleet_base`), the strategy,
role makers, topology and `util` (`base`), the data-parallel
meta-optimizers (`meta_optimizers`) and `HybridParallelOptimizer`
(`meta_parallel`). The parameter-server datasets and data generators are
ROADMAP item 7(c)."""
from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, ParallelMode,
)
from .base.role_maker import (  # noqa: F401
    Role, RoleMakerBase, UserDefinedRoleMaker, PaddleCloudRoleMaker,
)
from .base.util_factory import UtilBase  # noqa: F401
from .fleet_base import (  # noqa: F401
    Fleet, init, is_first_worker, worker_index, worker_num, is_worker,
    is_server, worker_endpoints, server_num, server_index, server_endpoints,
    barrier_worker, init_worker, init_server, run_server, stop_worker,
    shrink, state_dict, set_state_dict, get_lr, set_lr, minimize,
    save_inference_model, save_persistables, util,
    distributed_model, distributed_optimizer, get_hybrid_communicate_group,
    _get_fleet,
)
from . import meta_parallel  # noqa: F401
from . import meta_optimizers  # noqa: F401
