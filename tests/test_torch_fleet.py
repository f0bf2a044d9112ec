"""Port parity in one process: Fleet's surface, the topology and the
meta-optimizers, against the JAX package.

- `CommunicateTopology`: coordinates, ranks, axis lists and comm lists
  equal the reference's for several 5-axis shapes; a
  `HybridCommunicateGroup` made before `init_parallel_env` holds, for each
  axis, the reference topology's group of rank 0 (across ranks and with
  process groups: tests/test_torch_distributed_ranks.py).
- The counterparts of tests/test_data_stack.py::test_fleet_surface_39,
  ::test_role_makers, ::test_util_base_file_shard and
  ::test_fleet_singleton_state_passthrough, limited to what the port
  carries; each unported branch raises with its ROADMAP item.
- Each case of tests/test_meta_optimizers.py on both packages, from the
  same numpy weights and data (a Linear-ReLU-Linear model), value for
  value where the reference computes one: the Lamb and Lars swaps (4
  steps), gradient merge's boundaries, LocalSGD at world 1, DGC's
  `_dgc_compress` on the same u, e, g, its rampup and its compressed
  steps, recompute's gradients, the amp O2 masters, the raising knobs.
  Tolerances, fp32: 1e-6 relative on parameters after the optimizers'
  steps (XLA contracts the reference's CPU arithmetic into FMAs, a few
  ulps a step), 1e-5 relative and 1e-7 absolute on gradients.
- `jit.TrainStep` refuses the eager-only wrappers.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import meta_optimizers as jmeta
from paddle_tpu.distributed.fleet.base.topology import \
    CommunicateTopology as JCommunicateTopology

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import fleet_base
from paddle_tpu_torch.distributed.fleet import meta_optimizers as tmeta
from paddle_tpu_torch.jit import TrainStep

AXES = ("data", "pipe", "sharding", "sep", "model")
SHAPES = ((1, 1, 1, 1, 1), (8, 1, 1, 1, 1), (2, 2, 2, 1, 1),
          (2, 1, 1, 2, 2), (1, 4, 1, 1, 2), (3, 2, 1, 1, 2))
PARAM_RTOL = 1e-6
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(autouse=True)
def no_world():
    """No world brought up before or after a test: Fleet's and the
    topology's groups are plain metadata here."""
    dist.destroy_process_group()
    yield
    dist.destroy_process_group()
    fleet_base._fleet.__init__()


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", SHAPES)
def test_topology_equals_the_reference(dims):
    mine = fleet.CommunicateTopology(AXES, dims)
    ref = JCommunicateTopology(AXES, dims)
    assert mine.world_size() == ref.world_size()
    assert mine.coordinate == ref.coordinate
    for rank in range(ref.world_size()):
        assert mine.get_coord(rank) == ref.get_coord(rank)
        kw = dict(zip(AXES, ref.get_coord(rank)))
        assert mine.get_rank(**kw) == ref.get_rank(**kw) == rank
        assert mine.get_rank_from_stage(rank, pipe=0) == \
            ref.get_rank_from_stage(rank, pipe=0)
    for axis in AXES:
        assert mine.get_dim(axis) == ref.get_dim(axis)
        assert mine.get_comm_list(axis) == ref.get_comm_list(axis)
        for i in range(ref.get_dim(axis)):
            assert mine.get_axis_list(axis, i) == ref.get_axis_list(axis, i)
    hcg = fleet.HybridCommunicateGroup(mine)
    groups = {"data": hcg.get_data_parallel_group(),
              "pipe": hcg.get_pipe_parallel_group(),
              "sharding": hcg.get_sharding_parallel_group(),
              "model": hcg.get_model_parallel_group(),
              "sep": hcg.get_sep_parallel_group()}
    for axis, group in groups.items():
        if axis == "sep" and ref.get_dim("sep") == 1:
            assert group is None
            continue
        want = next(g for g in ref.get_comm_list(axis) if 0 in g)
        assert group.ranks == want and group.rank == 0 and group.pg is None
    dp, pp, sharding, sep, mp = dims
    mode = (fleet.ParallelMode.PIPELINE_PARALLEL if pp > 1 else
            fleet.ParallelMode.SHARDING_PARALLEL if sharding > 1 else
            fleet.ParallelMode.TENSOR_PARALLEL if mp > 1 else
            fleet.ParallelMode.DATA_PARALLEL)
    assert hcg.get_parallel_mode() == mode
    assert (hcg.get_data_parallel_world_size(),
            hcg.get_pipe_parallel_world_size(),
            hcg.get_sharding_parallel_world_size(),
            hcg.get_sep_parallel_world_size(),
            hcg.get_model_parallel_world_size()) == dims
    assert hcg.is_first_stage() and hcg.is_last_stage() == (pp == 1)


def test_topology_must_cover_the_world():
    dist.init_parallel_env(device="cpu")
    with pytest.raises(ValueError, match="the world has 1"):
        fleet.HybridCommunicateGroup(
            fleet.CommunicateTopology(AXES, (2, 1, 1, 1, 1)))


# ---------------------------------------------------------------------------
# Fleet's surface
# ---------------------------------------------------------------------------

def test_fleet_surface():
    """tests/test_data_stack.py::test_fleet_surface_39's names, less the
    parameter-server datasets and data generators (ROADMAP item 7(c)),
    each on both packages."""
    names = ["CommunicateTopology", "UserDefinedRoleMaker",
             "PaddleCloudRoleMaker", "Role", "UtilBase",
             "HybridCommunicateGroup", "Fleet", "DistributedStrategy",
             "init", "is_first_worker", "worker_index", "worker_num",
             "is_worker", "worker_endpoints", "server_num", "server_index",
             "server_endpoints", "is_server", "util", "barrier_worker",
             "init_worker", "init_server", "run_server", "stop_worker",
             "distributed_optimizer", "save_inference_model",
             "save_persistables", "distributed_model", "state_dict",
             "set_state_dict", "shrink", "get_lr", "set_lr", "minimize"]
    assert [n for n in names if not hasattr(jfleet, n)] == []
    assert [n for n in names if not hasattr(fleet, n)] == []
    mine, ref = fleet.DistributedStrategy(), jfleet.DistributedStrategy()
    assert vars(mine) == vars(ref)
    mine.hybrid_configs = {"dp_degree": 2}
    ref.hybrid_configs = {"dp_degree": 2}
    assert mine.hybrid_configs == ref.hybrid_configs


def test_role_makers(monkeypatch):
    """tests/test_data_stack.py::test_role_makers on the port."""
    rm = fleet.UserDefinedRoleMaker(current_id=1, role=fleet.Role.WORKER,
                                    worker_num=4)
    assert rm._worker_index() == 1 and rm._worker_num() == 4
    assert rm._is_worker() and not rm._is_server()
    rm2 = fleet.UserDefinedRoleMaker(
        current_id=0, role=fleet.Role.SERVER,
        worker_endpoints=["127.0.0.1:6170"],
        server_endpoints=["127.0.0.1:6270", "127.0.0.1:6271"])
    assert rm2._is_server() and rm2._server_num() == 2
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "127.0.0.1:6170,127.0.0.1:6171,127.0.0.1:6172")
    cloud = fleet.PaddleCloudRoleMaker()
    ref = jfleet.PaddleCloudRoleMaker()
    assert cloud._worker_index() == ref._worker_index() == 2
    assert cloud._worker_num() == ref._worker_num() == 3
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVER_ID", "1")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", "a:1,b:2")
    server, ref = fleet.PaddleCloudRoleMaker(), jfleet.PaddleCloudRoleMaker()
    assert server._server_index() == ref._server_index() == 1
    assert server._get_pserver_endpoints() == ref._get_pserver_endpoints()


def test_util_file_shard_and_world1():
    """tests/test_data_stack.py::test_util_base_file_shard on the port."""
    files = [f"f{i}" for i in range(7)]
    for trainers in (1, 2, 3, 5):
        for rank in range(trainers):
            mine, ref = fleet.UtilBase(), jfleet.UtilBase()
            mine._set_role_maker(fleet.UserDefinedRoleMaker(
                current_id=rank, role=fleet.Role.WORKER,
                worker_num=trainers))
            ref._set_role_maker(jfleet.UserDefinedRoleMaker(
                current_id=rank, role=jfleet.Role.WORKER,
                worker_num=trainers))
            assert mine.get_file_shard(files) == ref.get_file_shard(files)
    u = fleet.UtilBase()
    np.testing.assert_array_equal(u.all_reduce(np.asarray([1.0, 2.0])),
                                  [1.0, 2.0])
    assert u.all_gather(5) == [5]
    with pytest.raises(ValueError):
        u.all_reduce(np.ones(2), mode="avg")
    with pytest.raises(TypeError):
        u.get_file_shard("f0")


def test_fleet_singleton_state_passthrough(capsys):
    """tests/test_data_stack.py::test_fleet_singleton_state_passthrough on
    the port, in a gloo world of one rank: the model comes back as it is,
    the optimizer inside `HybridParallelOptimizer`."""
    m = tnn.Linear(4, 2, device="cpu")
    fleet.init(is_collective=True, device="cpu")
    assert dist.get_backend() == "gloo"
    assert fleet.distributed_model(m) is m
    opt = fleet.distributed_optimizer(
        topt.SGD(learning_rate=0.5, parameters=m.parameters()))
    assert isinstance(opt, fleet.meta_parallel.HybridParallelOptimizer)
    assert fleet.get_lr() == 0.5
    fleet.set_lr(0.25)
    assert opt.get_lr() == 0.25
    assert isinstance(fleet.state_dict(), dict)
    fleet.set_state_dict(fleet.state_dict())
    assert fleet.is_first_worker() and fleet.is_worker()
    assert not fleet.is_server() and fleet.worker_num() >= 1
    assert fleet.worker_index() == 0 and fleet.server_num() == 0
    fleet.barrier_worker()
    fleet.util.print_on_rank("on rank 0", 0)
    assert "on rank 0" in capsys.readouterr().out
    hcg = fleet.get_hybrid_communicate_group()
    assert hcg.get_data_parallel_group().ranks == [0]
    assert hcg.get_data_parallel_group().pg is not None


def test_unported_branches_raise_with_their_item():
    for name in ("init_worker", "init_server", "run_server", "stop_worker",
                 "shrink"):
        with pytest.raises(NotImplementedError, match=r"7\(c\)"):
            getattr(fleet, name)()
    for name in ("save_inference_model", "save_persistables"):
        with pytest.raises(NotImplementedError, match=r"8\(b\)"):
            getattr(fleet, name)(None, "dir")
    m = tnn.Linear(4, 2, device="cpu")
    for dims, what in (((1, 2, 1, 1, 1), "PipelineParallel"),
                       ((1, 1, 1, 1, 2), "TensorParallel"),
                       ((1, 1, 2, 1, 1), "ShardingParallel")):
        fleet_base._fleet.strategy = fleet.DistributedStrategy()
        fleet_base._fleet.hcg = fleet.HybridCommunicateGroup(
            fleet.CommunicateTopology(AXES, dims))
        with pytest.raises(NotImplementedError, match=what + r".*7\(b\)"):
            fleet.distributed_model(m)
    with pytest.raises(NotImplementedError, match=r"7\(b\)"):
        fleet.meta_parallel.HybridParallelOptimizer(
            topt.SGD(parameters=m.parameters()), fleet_base._fleet.hcg)
    with pytest.raises(RuntimeError, match="distributed_optimizer"):
        fleet_base.Fleet().get_lr()


# ---------------------------------------------------------------------------
# meta-optimizers against the reference
# ---------------------------------------------------------------------------

def _pair(seed=0):
    """The reference's tiny model and the port's with its weights."""
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tm = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                        tnn.Linear(16, 4, device="cpu"))
    load_jax_state(tm, {n: np.asarray(p._value)
                        for n, p in jm.named_parameters()})
    return jm, tm


def _data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 8)).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32))


def _jloss(jm, x, y):
    out = jm(paddle.Tensor(jnp.asarray(x), stop_gradient=True))
    d = out - paddle.Tensor(jnp.asarray(y), stop_gradient=True)
    return (d * d).mean()


def _tloss(tm, x, y):
    d = tm(torch.from_numpy(x)) - torch.from_numpy(y)
    return (d * d).mean()


def _train_both(jm, jopt, tm, topt_, steps=4, seed=0, data=None):
    x, y = data or _data(seed)
    jl, tl = [], []
    for _ in range(steps):
        loss = _jloss(jm, x, y)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss))
        loss = _tloss(tm, x, y)
        loss.backward()
        topt_.step()
        topt_.clear_grad()
        tl.append(float(loss.detach()))
    return jl, tl


def _assert_params(jm, tm, rtol=PARAM_RTOL, atol=0.0):
    for (name, jp), tp in zip(jm.named_parameters(), tm.parameters()):
        want = np.asarray(jp._value)
        got = tp.detach().numpy()
        if got.shape != want.shape:
            got = got.T
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)


def _strategy(mod, **flags):
    s = mod.DistributedStrategy()
    for k, v in flags.items():
        setattr(s, k, v)
    return s


def test_strategy_lamb_swaps_adam_and_matches():
    jm, tm = _pair()
    s = dict(lamb=True)
    jopt = jmeta.apply_strategy(paddle.optimizer.AdamW(
        learning_rate=1e-2, parameters=jm.parameters()),
        _strategy(jfleet, **s))
    mine = tmeta.apply_strategy(topt.AdamW(
        learning_rate=1e-2, parameters=tm.parameters()),
        _strategy(fleet, **s))
    assert isinstance(mine, topt.Lamb) and mine._applied_passes == ["lamb"]
    assert mine._epsilon == jopt._epsilon == 1e-8
    jl, tl = _train_both(jm, jopt, tm, mine)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_params(jm, tm, atol=1e-7)


def test_strategy_lars_swaps_momentum_and_matches():
    jm, tm = _pair()
    s = dict(lars=True, lars_configs={"lars_coeff": 0.01,
                                      "lars_weight_decay": 0.0005,
                                      "epsilon": 1e-9,
                                      "exclude_from_weight_decay": []})
    jopt = jmeta.apply_strategy(paddle.optimizer.Momentum(
        learning_rate=1e-1, momentum=0.9, parameters=jm.parameters()),
        _strategy(jfleet, **s))
    mine = tmeta.apply_strategy(topt.Momentum(
        learning_rate=1e-1, momentum=0.9, parameters=tm.parameters()),
        _strategy(fleet, **s))
    assert isinstance(mine, topt.Lars)
    jl, tl = _train_both(jm, jopt, tm, mine)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_params(jm, tm, atol=1e-7)


def test_strategy_rejections_and_raising_knobs():
    _, tm = _pair()
    with pytest.raises(TypeError):
        tmeta.apply_strategy(topt.Momentum(parameters=tm.parameters()),
                             _strategy(fleet, lamb=True))
    with pytest.raises(TypeError):
        tmeta.apply_strategy(topt.AdamW(parameters=tm.parameters()),
                             _strategy(fleet, lars=True))
    with pytest.raises(TypeError):
        tmeta.apply_strategy(topt.AdamW(parameters=tm.parameters()),
                             _strategy(fleet, dgc=True))
    with pytest.raises(NotImplementedError):
        tmeta.apply_strategy(topt.SGD(parameters=tm.parameters()),
                             _strategy(fleet, heter_ccl_mode=True))
    for stage, match in ((1, r"7\(b\)"), (2, "group_sharded_parallel")):
        with pytest.raises(NotImplementedError, match=match):
            tmeta.apply_strategy(
                topt.SGD(parameters=tm.parameters()),
                _strategy(fleet, sharding=True,
                          sharding_configs={"stage": stage}))
    with pytest.raises(TypeError, match="masters"):
        tmeta.apply_strategy(topt.SGD(parameters=tm.parameters()),
                             _strategy(fleet, amp=True,
                                       amp_configs={"level": "O2"}))


def test_strategy_amp_o2_sets_master_weights():
    _, tm = _pair()
    s = _strategy(fleet, amp=True, amp_configs={"level": "O2",
                                                "dtype": "bfloat16"})
    out = tmeta.apply_strategy(topt.AdamW(parameters=tm.parameters(),
                                          multi_precision=False), s)
    assert out._multi_precision is True
    assert "amp_o2_master_weights" in out._applied_passes
    o1 = tmeta.apply_strategy(topt.AdamW(parameters=tm.parameters()),
                              _strategy(fleet, amp=True))
    assert o1._applied_passes == ["amp_o1_bf16"]
    # the model side: distributed_model casts to bf16 under O2
    fleet_base._fleet.strategy = s
    assert fleet.distributed_model(tm) is tm
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())


@pytest.mark.parametrize("k,micro", [(2, 2), (3, 2), (3, 3)])
def test_gradient_merge_boundaries_match(k, micro):
    """k micro-steps of SGD merged with avg: no update before the k-th,
    then one step on the mean gradient; the same on both packages."""
    jm, tm = _pair()
    s = dict(gradient_merge=True,
             gradient_merge_configs={"k_steps": k, "avg": True})
    jopt = jmeta.apply_strategy(paddle.optimizer.SGD(
        learning_rate=1e-2, parameters=jm.parameters()),
        _strategy(jfleet, **s))
    mine = tmeta.apply_strategy(topt.SGD(
        learning_rate=1e-2, parameters=tm.parameters()),
        _strategy(fleet, **s))
    assert isinstance(mine, tmeta.GradientMergeOptimizer)
    before = [p.detach().clone() for p in tm.parameters()]
    for i in range(micro):
        _train_both(jm, jopt, tm, mine, steps=1, seed=i)
    moved = any(not torch.equal(a, b)
                for a, b in zip(before, tm.parameters()))
    assert moved == (micro % k == 0)
    _assert_params(jm, tm, atol=1e-7)


def test_localsgd_world1_matches_sgd_and_the_reference():
    jm, tm = _pair()
    _, tm2 = _pair()
    s = dict(localsgd=True, localsgd_configs={"k_steps": 2})
    jopt = jmeta.apply_strategy(paddle.optimizer.SGD(
        learning_rate=1e-2, parameters=jm.parameters()),
        _strategy(jfleet, **s))
    mine = tmeta.apply_strategy(topt.SGD(
        learning_rate=1e-2, parameters=tm.parameters()),
        _strategy(fleet, **s))
    assert isinstance(mine, tmeta.LocalSGDOptimizer)
    _train_both(jm, jopt, tm, mine)
    _assert_params(jm, tm, atol=1e-7)
    plain = topt.SGD(learning_rate=1e-2, parameters=tm2.parameters())
    x, y = _data()
    for _ in range(4):
        _tloss(tm2, x, y).backward()
        plain.step()
        plain.clear_grad()
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("keep", [0.5, 0.1, 1e-3])
def test_dgc_compress_matches_the_reference(keep):
    rng = np.random.default_rng(3)
    u, e, g = (rng.normal(size=(16, 8)).astype(np.float32) for _ in range(3))
    want = jmeta._dgc_compress(jnp.asarray(u), jnp.asarray(e),
                               jnp.asarray(g), momentum=0.9, keep_ratio=keep)
    got = tmeta._dgc_compress(torch.from_numpy(u), torch.from_numpy(e),
                              torch.from_numpy(g), 0.9, keep)
    for name, a, b in zip(("u", "e", "sparse"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_array_equal(a.numpy() == 0, np.asarray(b) == 0,
                                      err_msg=name)
    assert int((got[2] != 0).sum()) == max(int(np.ceil(keep * 128)), 1)


def _dgc_pair(cfg, lr=1e-2):
    jm, tm = _pair()
    s = dict(dgc=True, dgc_configs=cfg)
    jopt = jmeta.apply_strategy(paddle.optimizer.Momentum(
        learning_rate=lr, momentum=0.9, parameters=jm.parameters()),
        _strategy(jfleet, **s))
    mine = tmeta.apply_strategy(topt.Momentum(
        learning_rate=lr, momentum=0.9, parameters=tm.parameters()),
        _strategy(fleet, **s))
    assert isinstance(mine, tmeta.DGCMomentum)
    return jm, jopt, tm, mine


def test_dgc_rampup_is_plain_momentum_on_both():
    jm, jopt, tm, mine = _dgc_pair({"rampup_begin_step": 100,
                                    "sparsity": [0.999]})
    _, tm2 = _pair()
    _train_both(jm, jopt, tm, mine, steps=3)
    _assert_params(jm, tm, atol=1e-7)
    plain = topt.Momentum(learning_rate=1e-2, momentum=0.9,
                          parameters=tm2.parameters())
    x, y = _data()
    for _ in range(3):
        _tloss(tm2, x, y).backward()
        plain.step()
        plain.clear_grad()
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)


def test_dgc_compressed_steps_match_and_feed_back_errors():
    """Sparsity ramping 0.5 -> 0.75 over 4 steps: the same losses and
    parameters on both packages; the stored errors are nonzero and off
    the sent support."""
    jm, jopt, tm, mine = _dgc_pair({"rampup_begin_step": 1,
                                    "rampup_step": 4,
                                    "sparsity": [0.5, 0.75]})
    jl, tl = _train_both(jm, jopt, tm, mine, steps=5)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_params(jm, tm, atol=1e-7)
    assert sorted(mine._e) == list(range(4))
    for i, jp in enumerate(jm.parameters()):
        got, want = mine._e[i].numpy(), np.asarray(jopt._e[jp.name])
        np.testing.assert_allclose(got if got.shape == want.shape else got.T,
                                   want, rtol=1e-5, atol=1e-7)
    assert any(float(e.abs().sum()) > 0 for e in mine._e.values())


def test_dgc_converges_with_high_sparsity():
    jm, jopt, tm, mine = _dgc_pair({"rampup_begin_step": 0,
                                    "sparsity": [0.9]}, lr=5e-2)
    _, tl = _train_both(jm, jopt, tm, mine, steps=25)
    assert tl[-1] < tl[0] * 0.5, tl


def test_dgc_state_dict_roundtrip():
    _, _, tm, mine = _dgc_pair({"rampup_begin_step": 0, "sparsity": [0.5]})
    x, y = _data()
    for _ in range(2):
        _tloss(tm, x, y).backward()
        mine.step()
        mine.clear_grad()
    sd = mine.state_dict()
    assert sd["_dgc_steps"] == 2
    _, tm2 = _pair()
    other = tmeta.apply_strategy(
        topt.Momentum(learning_rate=1e-2, momentum=0.9,
                      parameters=tm2.parameters()),
        _strategy(fleet, dgc=True,
                  dgc_configs={"rampup_begin_step": 0, "sparsity": [0.5]}))
    other.set_state_dict(sd)
    assert other._steps == mine._steps
    assert set(other._e) == set(mine._e)


def test_stacked_gradient_merge_over_dgc():
    _, tm = _pair()
    opt = tmeta.apply_strategy(
        topt.Momentum(learning_rate=5e-2, momentum=0.9,
                      parameters=tm.parameters()),
        _strategy(fleet, dgc=True,
                  dgc_configs={"rampup_begin_step": 0, "sparsity": [0.5]},
                  gradient_merge=True,
                  gradient_merge_configs={"k_steps": 2, "avg": True}))
    assert isinstance(opt, tmeta.GradientMergeOptimizer)
    assert isinstance(opt._inner, tmeta.DGCMomentum)
    x, y = _data()
    losses = []
    for _ in range(16):
        loss = _tloss(tm, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    # the wrappers step eagerly: TrainStep refuses them
    step = TrainStep(tm, lambda o, t: ((o - t) ** 2).mean(), opt)
    with pytest.raises(NotImplementedError, match="steps eagerly"):
        step(torch.from_numpy(x), torch.from_numpy(y))


def test_apply_recompute_keeps_the_gradients_of_the_reference():
    jm, tm = _pair()
    _, plain = _pair()
    tmeta.apply_recompute(tm, {"checkpoints": ["0", "2"]})
    assert tm[0]._recompute_wrapped and tm[2]._recompute_wrapped
    x, y = _data()
    jloss = _jloss(jm, x, y)
    jloss.backward()
    loss = _tloss(tm, x, y)
    loss.backward()
    _tloss(plain, x, y).backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    for (name, jp), tp, pp in zip(jm.named_parameters(), tm.parameters(),
                                  plain.parameters()):
        assert torch.equal(tp.grad, pp.grad), name
        got = tp.grad.numpy()
        want = np.asarray(jp.grad._value)
        np.testing.assert_allclose(got if got.shape == want.shape
                                   else got.T, want, err_msg=name,
                                   **GRAD_TOL)
    with pytest.raises(ValueError):
        tmeta.apply_recompute(tm, {"checkpoints": []})
    with pytest.raises(ValueError, match="matched"):
        tmeta.apply_recompute(plain, {"checkpoints": ["9"]})
