"""Fleet in its collective mode, PyTorch port.

Counterpart of `paddle_tpu/distributed/fleet/fleet_base.py`: one `Fleet`
a process, whose methods the module binds as functions (the reference's
``fleet = Fleet(); init = fleet.init; ...``). `init` joins the world
(`init_parallel_env`, with the port's device rule: ``device=None`` means
the card and NCCL, ``"cpu"`` gloo) and lays the strategy's degrees over it
(`HybridCommunicateGroup`; ``dp_degree`` -1 takes what the other degrees
leave). `distributed_model` applies recompute and the amp O2 cast, then
wraps a model of a data-parallel world larger than one rank in
`DataParallel` over the data-parallel group (the sync off where DGC or
LocalSGD communicate themselves); `distributed_optimizer` applies the
strategy (`meta_optimizers.apply_strategy`) and wraps the result in
`HybridParallelOptimizer`. The worker queries, `barrier_worker`, `util`
and the optimizer's state and lr pass through.

Not ported, each raising `NotImplementedError` with its ROADMAP item:
the pipeline, tensor and sharding branches of `distributed_model` (7(b)),
the parameter-server methods (7(c)), and `save_inference_model` /
`save_persistables`, which go through `paddle.static` (8(b)).
"""
from __future__ import annotations

from ..env import get_rank, get_world_size, init_parallel_env
from .base.distributed_strategy import DistributedStrategy
from .base.role_maker import PaddleCloudRoleMaker
from .base.topology import (CommunicateTopology, HybridCommunicateGroup,
                            ParallelMode)
from .base.util_factory import UtilBase

__all__ = ["Fleet", "init", "is_first_worker", "worker_index", "worker_num",
           "is_worker", "is_server", "worker_endpoints", "server_num",
           "server_index", "server_endpoints", "barrier_worker",
           "init_worker", "init_server", "run_server", "stop_worker",
           "shrink", "state_dict", "set_state_dict", "get_lr", "set_lr",
           "minimize", "save_inference_model", "save_persistables", "util",
           "distributed_model", "distributed_optimizer",
           "get_hybrid_communicate_group"]


def _parameter_server(name):
    raise NotImplementedError(
        f"fleet.{name} belongs to the parameter-server mode: ROADMAP item "
        f"7(c)")


class Fleet:
    def __init__(self):
        self.strategy = None
        self.hcg = None
        self.is_collective = False
        self._role_maker = None
        self._util = UtilBase()
        self._user_optimizer = None

    def init(self, role_maker=None, is_collective=False, strategy=None,
             device=None):
        """Join the world on `device` and lay `strategy`'s hybrid degrees
        over it; returns the fleet."""
        self.is_collective = is_collective
        self.strategy = strategy or DistributedStrategy()
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._util._set_role_maker(self._role_maker)
        init_parallel_env(device)
        hybrid = self.strategy.hybrid_configs
        mp = hybrid.get("mp_degree", 1)
        pp = hybrid.get("pp_degree", 1)
        sharding = hybrid.get("sharding_degree", 1)
        sep = hybrid.get("sep_degree", 1)
        dp = hybrid.get("dp_degree", -1)
        if dp in (-1, 0, None):
            dp = max(get_world_size() // (mp * pp * sharding * sep), 1)
        self.hcg = HybridCommunicateGroup(CommunicateTopology(
            ("data", "pipe", "sharding", "sep", "model"),
            (dp, pp, sharding, sep, mp)))
        return self

    # -- who this worker is ---------------------------------------------------
    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_index(self):
        # a live world of several ranks outranks the role maker's guess
        if get_world_size() > 1 or self._role_maker is None:
            return get_rank()
        return self._role_maker._worker_index()

    def worker_num(self):
        live = get_world_size()
        if live > 1 or self._role_maker is None or \
                not self._role_maker._worker_endpoints:
            return live
        return self._role_maker._worker_num()

    def is_worker(self):
        return self._role_maker is None or self._role_maker._is_worker()

    def is_server(self):
        return self._role_maker is not None and \
            self._role_maker._is_server()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker._get_trainer_endpoints() \
            if self._role_maker else []
        return ",".join(eps) if to_string else eps

    def server_num(self):
        return self._role_maker._server_num() if self._role_maker else 0

    def server_index(self):
        return self._role_maker._server_index() if self._role_maker else -1

    def server_endpoints(self, to_string=False):
        eps = self._role_maker._get_pserver_endpoints() \
            if self._role_maker else []
        return ",".join(eps) if to_string else eps

    @property
    def util(self):
        return self._util

    def barrier_worker(self):
        self._util.barrier()

    # -- the parameter-server mode (ROADMAP item 7(c)) -----------------------
    def init_worker(self, scopes=None):
        _parameter_server("init_worker")

    def init_server(self, *args, **kwargs):
        _parameter_server("init_server")

    def run_server(self):
        _parameter_server("run_server")

    def stop_worker(self):
        _parameter_server("stop_worker")

    def shrink(self, threshold=0.0):
        _parameter_server("shrink")

    # -- the optimizer's state and lr -------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy)

    def _require_opt(self):
        if self._user_optimizer is None:
            raise RuntimeError(
                "call fleet.distributed_optimizer(optimizer) first")
        return self._user_optimizer

    def state_dict(self):
        return self._require_opt().state_dict()

    def set_state_dict(self, state):
        return self._require_opt().set_state_dict(state)

    def get_lr(self):
        return self._require_opt().get_lr()

    def set_lr(self, value):
        return self._require_opt().set_lr(value)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._require_opt().minimize(loss, startup_program,
                                            parameters, no_grad_set)

    def save_inference_model(self, *args, **kwargs):
        raise NotImplementedError(
            "fleet.save_inference_model goes through paddle.static: ROADMAP "
            "item 8(b) (a model saves with paddle_tpu_torch.jit.save)")

    def save_persistables(self, *args, **kwargs):
        raise NotImplementedError(
            "fleet.save_persistables goes through paddle.static: ROADMAP "
            "item 8(b)")


_fleet = Fleet()

init = _fleet.init
is_first_worker = _fleet.is_first_worker
worker_index = _fleet.worker_index
worker_num = _fleet.worker_num
is_worker = _fleet.is_worker
is_server = _fleet.is_server
worker_endpoints = _fleet.worker_endpoints
server_num = _fleet.server_num
server_index = _fleet.server_index
server_endpoints = _fleet.server_endpoints
barrier_worker = _fleet.barrier_worker
init_worker = _fleet.init_worker
init_server = _fleet.init_server
run_server = _fleet.run_server
stop_worker = _fleet.stop_worker
shrink = _fleet.shrink
state_dict = _fleet.state_dict
set_state_dict = _fleet.set_state_dict
get_lr = _fleet.get_lr
set_lr = _fleet.set_lr
minimize = _fleet.minimize
save_inference_model = _fleet.save_inference_model
save_persistables = _fleet.save_persistables
util = _fleet.util


def _get_fleet():
    return _fleet


def get_hybrid_communicate_group():
    return _fleet.hcg


def distributed_model(model):
    """`model` with the strategy's model-side passes (recompute, the amp
    O2 cast) applied, wrapped for the fleet's parallel mode: in a
    data-parallel world of more than one rank, `DataParallel` over the
    data-parallel group; otherwise `model` itself, as the reference."""
    hcg = _fleet.hcg
    strategy = _fleet.strategy
    if strategy is not None and strategy.recompute:
        from .meta_optimizers import apply_recompute
        apply_recompute(model, strategy.recompute_configs)
    if strategy is not None and strategy.amp:
        cfg = strategy.amp_configs or {}
        if cfg.get("level", "O1") == "O2" or cfg.get("use_pure_fp16"):
            from ...amp import decorate
            decorate(models=model, level="O2",
                     dtype=cfg.get("dtype", "bfloat16"))
    if hcg is None:
        return model
    mode = hcg.get_parallel_mode()
    for branch, name in ((ParallelMode.PIPELINE_PARALLEL, "PipelineParallel"),
                         (ParallelMode.TENSOR_PARALLEL, "TensorParallel"),
                         (ParallelMode.SHARDING_PARALLEL,
                          "ShardingParallel")):
        if mode == branch:
            raise NotImplementedError(
                f"fleet.distributed_model: the {name} branch (pp, mp or "
                f"sharding degree above 1) is ROADMAP item 7(b)")
    if get_world_size() > 1:
        from ..parallel import DataParallel
        # DGC and LocalSGD communicate themselves: a dense sync after each
        # backward would undo the compression
        own_comm = bool(strategy and (strategy.dgc or strategy.localsgd))
        return DataParallel(
            model, group=hcg.get_data_parallel_group(),
            find_unused_parameters=bool(
                strategy and strategy.find_unused_parameters),
            grad_sync=not own_comm)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """`optimizer` with the strategy's meta-optimizers applied
    (`apply_strategy`) and the innermost real optimizer wrapped in
    `HybridParallelOptimizer`; the wrappers of gradient merge, LocalSGD
    and DGC stay outside it and keep driving `step`."""
    from .meta_optimizers import _OptWrapper, apply_strategy
    from .meta_parallel.hybrid_optimizer import HybridParallelOptimizer
    hcg = _fleet.hcg
    strategy = strategy or _fleet.strategy
    if strategy is not None:
        optimizer = apply_strategy(optimizer, strategy, hcg=hcg)
    if hcg is None:
        _fleet._user_optimizer = optimizer
        return optimizer
    if isinstance(optimizer, _OptWrapper):
        inner = optimizer
        while isinstance(inner._inner, _OptWrapper):
            inner = inner._inner
        inner._inner = HybridParallelOptimizer(inner._inner, hcg, strategy)
        _fleet._user_optimizer = optimizer
        return optimizer
    out = HybridParallelOptimizer(optimizer, hcg, strategy)
    _fleet._user_optimizer = out
    return out
