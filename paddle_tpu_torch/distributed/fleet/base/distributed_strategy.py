"""DistributedStrategy, PyTorch port.

Counterpart of `paddle_tpu/distributed/fleet/base/distributed_strategy.py`:
the same knobs with the same defaults, a plain-Python config. Each
behaviour flag is consumed or raises: `hybrid_configs` by `fleet.init`;
amp, recompute, sharding, gradient_merge, lamb, lars, dgc and localsgd by
`fleet.distributed_optimizer` (`meta_optimizers.apply_strategy`, which
raises on what it cannot apply) and `fleet.distributed_model`;
`find_unused_parameters` by `DataParallel`. The rest
(`fuse_all_reduce_ops`, `fuse_grad_size_in_MB`, `nccl_comm_num`,
`sync_nccl_allreduce`, `without_graph_optimization`) are taken for the
reference's API and read by nothing: `DataParallel` buckets its sums by
its own `comm_buffer_size`.
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0, "custom_white_list": [],
            "custom_black_list": [], "use_pure_fp16": False, "level": "O1",
            "dtype": "bfloat16",
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "degree": 1,
                                 "offload": False}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01,
                             "exclude_from_weight_decay": []}
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001,
                             "lars_weight_decay": 0.0005, "epsilon": 1e-9,
                             "exclude_from_weight_decay": []}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "rampup_step": 1,
                            "sparsity": [0.999]}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.hybrid_configs = {
            "dp_degree": -1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
            "order": ["dp", "pp", "sharding", "sep", "mp"],
        }
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.sync_nccl_allreduce = False
        self.without_graph_optimization = True

    def __setattr__(self, key, value):
        # hybrid_configs merges into the defaults, as the reference's
        if key == "hybrid_configs" and hasattr(self, "hybrid_configs"):
            merged = dict(self.hybrid_configs)
            merged.update(value)
            object.__setattr__(self, key, merged)
        else:
            object.__setattr__(self, key, value)

    def __repr__(self):
        fields = {k: v for k, v in self.__dict__.items()
                  if not k.startswith("_")}
        return f"DistributedStrategy({fields})"
