"""Port parity across processes: the collectives and fleet data-parallel
training on gloo ranks, against the JAX package.

Each test starts its ranks as subprocesses of tests/torch_multiproc_runner.py
(torch only) with PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / PADDLE_MASTER,
as tests/test_multiproc_collective.py starts the reference's; a rank's
process groups time out after 60 s and the test waits at most
`RANK_TIMEOUT` s for each, so a lost rank fails the test instead of
hanging it. One launch a world size:

- 2 and 4 ranks: every assertion of the reference runner, rank by rank;
  the port's all_reduce (sum, max, avg), all_gather, reduce_scatter,
  alltoall_single, broadcast and a send/recv ring against the JAX
  package's shard_map psum / pmax / pmean / all_gather / psum_scatter /
  all_to_all / all_gather[src] / ppermute on a mesh of as many devices,
  over the same seeded rows: moves exactly, sums within fp32 sum-order
  rounding (world size x 2^-23 x the sum of the terms' magnitudes,
  element by element); at 4 ranks, the groups of six hybrid topologies
  exactly the reference `CommunicateTopology`'s.
- 2 ranks, data parallel: `fleet.init(is_collective=True)` ->
  `distributed_model` -> `distributed_optimizer` -> `TrainStep`, each rank
  its half of a global batch of 8 through `DistributedBatchSampler`, 3
  steps of a tiny GPT with head_dim 128 (gpt3_1p3b's), fp32, from the JAX
  model's weights. Against the JAX package on the whole batch: AdamW
  through the JAX `TrainStep` (the mean of the ranks' losses within 2e-6
  relative, parameters within 1e-5 absolute, Adam's step being ~lr =
  1e-4 of sign noise where a gradient element sits within rounding of 0);
  the eager `loss.backward(); opt.step()` loop bit for bit the TrainStep's;
  Momentum with a global-norm clip that binds at every step (the JAX
  eager loop, which clips, within 1e-6: the sync comes before the clip,
  or each rank would scale its half by another factor); the ranks bit for
  bit equal; with ``grad_sync=False`` the ranks differ.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.base.topology import \
    CommunicateTopology as JCommunicateTopology
from paddle_tpu.incubate.models import GPTConfig as JGPTConfig
from paddle_tpu.incubate.models import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.incubate.models import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nn import clip as jclip

from paddle_tpu_torch.incubate.models import GPTConfig, GPTForCausalLM

import torch_multiproc_runner as runner

_RUNNER = os.path.join(os.path.dirname(__file__), "torch_multiproc_runner.py")
ROOT = os.path.dirname(os.path.dirname(_RUNNER))
RANK_TIMEOUT = 120
LOSS_RTOL = 2e-6
ADAM_PARAM_ATOL = 1e-5
MOMENTUM_PARAM_ATOL = 1e-6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world, mode, out_dir):
    """Run `world` ranks of the runner in `mode`; each must exit 0 and
    print its OK line within RANK_TIMEOUT seconds."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env.update({"PADDLE_TRAINER_ID": str(rank),
                    "PADDLE_TRAINERS_NUM": str(world),
                    "PADDLE_MASTER": f"127.0.0.1:{port}",
                    "OMP_NUM_THREADS": "1",
                    "PYTHONPATH": ROOT + os.pathsep
                    + env.get("PYTHONPATH", "")})
        procs.append(subprocess.Popen(
            [sys.executable, _RUNNER, mode, str(out_dir)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"RANK {rank} OK" in out, f"rank {rank} output:\n{out}"
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)]


def _jax_collectives(world):
    """The JAX package's shard_map collectives over a mesh of `world`
    devices, on the rows `torch_multiproc_runner.jax_rows` takes: each
    result as [world, ...], row r what rank r holds."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("g",))

    def run(body, x):
        return np.asarray(jax.shard_map(body, mesh=mesh, in_specs=P("g"),
                                        out_specs=P("g"))(jnp.asarray(x)))

    x = np.random.default_rng(0).normal(size=(world, 4)).astype(np.float32)
    x2 = np.random.default_rng(1).normal(size=(world, world)) \
        .astype(np.float32)
    x3 = np.arange(world * world, dtype=np.float32).reshape(world, world)
    ring = [(i, (i + 1) % world) for i in range(world)]
    return {
        "psum": run(lambda v: lax.psum(v, "g"), x),
        "pmax": run(lambda v: lax.pmax(v, "g"), x),
        "pmean": run(lambda v: lax.pmean(v, "g"), x),
        "all_gather": run(lambda v: lax.all_gather(v, "g", tiled=True)[None],
                          x).reshape(world, world, 4),
        "psum_scatter": run(lambda v: lax.psum_scatter(
            v, "g", scatter_dimension=1, tiled=True), x2),
        "all_to_all": run(lambda v: lax.all_to_all(
            v, "g", split_axis=1, concat_axis=1, tiled=True), x3),
        "broadcast": run(lambda v: lax.all_gather(v, "g")[world - 1], x),
        "ppermute_ring": run(lambda v: lax.ppermute(v, "g", ring), x),
    }


def _topology_want(dims, rank):
    """The reference topology's group of `rank` along each axis (None for
    sep at degree 1, as its HybridCommunicateGroup makes none)."""
    topo = JCommunicateTopology(runner.AXES, dims)
    out = {}
    for axis in runner.AXES:
        if axis == "sep" and topo.get_dim("sep") == 1:
            out[axis] = None
            continue
        out[axis] = next(g for g in topo.get_comm_list(axis) if rank in g)
    coord = topo.get_coord(rank)
    return out, [coord[0], coord[1], coord[2], coord[4]]


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_across_ranks_match_reference_and_jax(world, tmp_path):
    ranks = _launch(world, "collectives", tmp_path)
    want = _jax_collectives(world)
    # sums may round apart by their order: at most world fp32 epsilons of
    # the sum of the terms' magnitudes
    x = np.random.default_rng(0).normal(size=(world, 4)).astype(np.float32)
    x2 = np.random.default_rng(1).normal(size=(world, world)) \
        .astype(np.float32)
    slack = {"psum": np.abs(x).sum(0), "pmean": np.abs(x).sum(0) / world,
             "psum_scatter": np.abs(x2).sum(0)}
    eps = np.finfo(np.float32).eps
    for name, rows in want.items():
        for r in range(world):
            got = ranks[r][name]
            if name not in slack:
                np.testing.assert_array_equal(got, rows[r], err_msg=name)
                continue
            bound = world * eps * slack[name]
            if name == "psum_scatter":
                bound = bound[r:r + 1]
            assert (np.abs(got - rows[r].reshape(got.shape)) <= bound).all(), \
                (name, r, got, rows[r], bound)
    if world != 4:
        return
    for r in range(world):
        with open(tmp_path / f"topology{r}.json") as f:
            got = json.load(f)
        assert [tuple(g["dims"]) for g in got] == list(runner.TOPOLOGIES)
        for entry in got:
            groups, coord = _topology_want(tuple(entry["dims"]), r)
            assert entry["groups"] == groups, (entry, r)
            assert entry["coord"] == coord, (entry, r)
            assert entry["dp_sum"] == sum(groups["data"])
            assert entry["mode"] == _mode(entry["dims"])


def _mode(dims):
    from paddle_tpu_torch.distributed.fleet import ParallelMode
    dp, pp, sharding, sep, mp = dims
    if pp > 1:
        return ParallelMode.PIPELINE_PARALLEL
    if sharding > 1:
        return ParallelMode.SHARDING_PARALLEL
    if mp > 1:
        return ParallelMode.TENSOR_PARALLEL
    return ParallelMode.DATA_PARALLEL


def _jax_model():
    paddle.seed(0)
    return JGPTForCausalLM(JGPTConfig(**runner.DP_CONFIG))


def _jax_params(jm):
    """The JAX model's parameters by name, in the port's layout (Linear
    weights [out, in])."""
    tm = GPTForCausalLM(GPTConfig(**runner.DP_CONFIG), device="cpu")
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    return {n: (np.asarray(p._value).T if n in linear
                else np.asarray(p._value))
            for n, p in jm.named_parameters()}


def _global_batches(ids, labels):
    n = runner.DP_GLOBAL_BATCH
    return [(paddle.to_tensor(ids[k * n:(k + 1) * n]),
             paddle.to_tensor(labels[k * n:(k + 1) * n]))
            for k in range(runner.DP_STEPS)]


def test_fleet_data_parallel_training_matches_jax(tmp_path):
    jm = _jax_model()
    np.savez(tmp_path / "init.npz", **{n: np.asarray(p._value)
                                       for n, p in jm.named_parameters()})
    rng = np.random.default_rng(5)
    shape = (runner.DP_STEPS * runner.DP_GLOBAL_BATCH, runner.DP_SEQ)
    vocab = runner.DP_CONFIG["vocab_size"]
    ids = rng.integers(0, vocab, shape).astype(np.int64)
    labels = rng.integers(0, vocab, shape).astype(np.int64)
    np.savez(tmp_path / "data.npz", ids=ids, labels=labels)
    ranks = _launch(2, "dp", tmp_path)
    crit = JGPTPretrainingCriterion()
    batches = _global_batches(ids, labels)

    # each rank took its half: indices r, r + 2, ... of each global batch
    for r, res in enumerate(ranks):
        for run in runner._DP_RUNS:
            np.testing.assert_array_equal(
                res[f"{run}/batches"],
                np.arange(shape[0]).reshape(runner.DP_STEPS, -1, 2)[:, :, r])

    def params(res, run):
        prefix = f"{run}/param/"
        return {k[len(prefix):]: v for k, v in res.items()
                if k.startswith(prefix)}

    def held(run, j_losses, jm, atol):
        mean = (ranks[0][f"{run}/losses"] + ranks[1][f"{run}/losses"]) / 2
        np.testing.assert_allclose(mean, j_losses, rtol=LOSS_RTOL, atol=0,
                                   err_msg=run)
        want = _jax_params(jm)
        got = params(ranks[0], run)
        assert set(got) == set(want)
        for name, value in got.items():
            np.testing.assert_allclose(value, want[name], rtol=0, atol=atol,
                                       err_msg=f"{run} {name}")
        for name, value in params(ranks[1], run).items():
            np.testing.assert_array_equal(value, got[name],
                                          err_msg=f"{run} {name}")

    # AdamW through the JAX TrainStep on the whole batch
    jopt = paddle.optimizer.AdamW(learning_rate=runner.DP_LR,
                                  weight_decay=runner.DP_DECAY,
                                  parameters=jm.parameters())
    jstep = JTrainStep(jm, lambda o, y: crit(o, y), jopt)
    j_losses = [float(jstep(x, y)) for x, y in batches]
    held("adamw", j_losses, jm, ADAM_PARAM_ATOL)
    for r in range(2):
        for key, value in ranks[r].items():
            if key.startswith("adamw/"):
                np.testing.assert_array_equal(
                    ranks[r]["adamw_eager/" + key[len("adamw/"):]], value,
                    err_msg=key)

    # Momentum with a binding global-norm clip through the JAX eager loop
    jm = _jax_model()
    jopt = paddle.optimizer.Momentum(
        learning_rate=runner.MOMENTUM_LR, momentum=0.9,
        parameters=jm.parameters(),
        grad_clip=jclip.ClipGradByGlobalNorm(runner.CLIP_NORM))
    j_losses = []
    for x, y in batches:
        loss = crit(jm(x), y)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        j_losses.append(float(loss))
    for r in range(2):
        norms = ranks[r]["clip/norms"]
        assert (norms > runner.CLIP_NORM).all(), norms
        np.testing.assert_array_equal(norms, ranks[0]["clip/norms"])
    held("clip", j_losses, jm, MOMENTUM_PARAM_ATOL)

    # no sync: each rank trained on its own half
    a, b = params(ranks[0], "nosync"), params(ranks[1], "nosync")
    assert any(not np.array_equal(a[k], b[k]) for k in a)
