"""Fleet's base: strategy, role makers, topology and `fleet.util`."""
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .role_maker import (  # noqa: F401
    Role, RoleMakerBase, UserDefinedRoleMaker, PaddleCloudRoleMaker,
)
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, ParallelMode,
)
from .util_factory import UtilBase  # noqa: F401
