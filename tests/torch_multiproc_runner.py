"""One rank of the port's multi-process tests (torch and gloo only).

Started by tests/test_torch_distributed_ranks.py with PADDLE_TRAINER_ID /
PADDLE_TRAINERS_NUM / PADDLE_MASTER set, as the reference's
tests/multiproc_runner.py is started by its harness:

    python tests/torch_multiproc_runner.py collectives OUT_DIR
    python tests/torch_multiproc_runner.py dp OUT_DIR

Each rank joins the world on the CPU (gloo, 60 s timeouts), runs its
mode, writes what the parent compares into OUT_DIR/rank<r>.npz and prints
"RANK <r> OK".

- ``collectives``: every assertion of the reference runner, rank by rank
  (MoE's token exchange left out: ROADMAP item 7(c)), the rows of the
  collectives the parent holds against the JAX package's `shard_map`
  collectives, and, at 4 ranks, each topology's groups.
- ``dp``: fleet data-parallel training of a tiny GPT from OUT_DIR/init.npz
  over the batches of OUT_DIR/data.npz dealt by DistributedBatchSampler
  (`_DP_RUNS`): each run's losses and final parameters.
"""
import json
import os
import sys

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
    DGCMomentum, LocalSGDOptimizer)
from paddle_tpu_torch.optimizer import SGD, Momentum

# the topologies the 4-rank run lays over its world: (dp, pp, sharding,
# sep, mp)
TOPOLOGIES = ((4, 1, 1, 1, 1), (2, 2, 1, 1, 1), (2, 1, 1, 1, 2),
              (1, 2, 1, 1, 2), (1, 1, 2, 2, 1), (1, 1, 1, 4, 1))
AXES = ("data", "pipe", "sharding", "sep", "model")

# the tiny GPT of the dp mode (head_dim 128, as gpt3_1p3b's), its batch
# and its steps
DP_CONFIG = dict(vocab_size=1024, hidden_size=256, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=1024,
                 max_position_embeddings=64, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
DP_SEQ, DP_GLOBAL_BATCH, DP_STEPS = 64, 8, 3
DP_LR, DP_DECAY = 1e-4, 0.01
MOMENTUM_LR, CLIP_NORM = 0.05, 0.05
# run -> (optimizer, clip, gradient sync, step through TrainStep)
_DP_RUNS = {"adamw": ("adamw", False, True, True),
            "adamw_eager": ("adamw", False, True, False),
            "clip": ("momentum", True, True, True),
            "nosync": ("adamw", False, False, True)}


def _t(arr):
    return torch.tensor(np.asarray(arr, np.float32))


def _check(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32))


def reference_assertions(rank, world):
    """The reference runner's checks (tests/multiproc_runner.py), on the
    port."""
    x = _t([float(rank + 1)] * 4)
    dist.all_reduce(x)
    expect = sum(r + 1 for r in range(world))
    _check(x, [expect] * 4)

    b = _t([rank * 10.0, rank * 10.0])
    dist.broadcast(b, src=0)
    _check(b, [0.0, 0.0])

    gathered = []
    dist.all_gather(gathered, _t([float(rank)] * 3))
    assert len(gathered) == world
    for r in range(world):
        _check(gathered[r], [float(r)] * 3)

    # every rank sends first: send must not wait for the receive
    payload = _t([float(100 + rank)] * 2)
    inbox = _t([0.0, 0.0])
    src, dst = (rank - 1) % world, (rank + 1) % world
    dist.send(payload, dst=dst)
    dist.recv(inbox, src=src)
    _check(inbox, [float(100 + src)] * 2)
    dist.send(payload, dst=src)
    dist.recv(inbox, src=dst)
    _check(inbox, [float(100 + dst)] * 2)

    big = _t([float(rank)] * 8)
    slot = _t([0.0] * 8)
    dist.partial_send(big, dst=dst, nranks=2, rank_id=1)
    dist.partial_recv(slot, src=src, nranks=2, rank_id=1)
    _check(slot[:4], [0.0] * 4)
    _check(slot[4:], [float(src)] * 4)

    # every rank lists its irecv first
    outbox = _t([float(rank * 2)] * 2)
    inbox2 = _t([0.0, 0.0])
    tasks = dist.batch_isend_irecv([dist.P2POp(dist.irecv, inbox2, src),
                                    dist.P2POp(dist.isend, outbox, dst)])
    for task in tasks:
        task.wait()
    _check(inbox2, [float(src * 2)] * 2)

    parts = [_t([float(rank + 1)] * 2) for _ in range(world)]
    out = _t([0.0, 0.0])
    dist.reduce_scatter(out, parts)
    _check(out, [expect] * 2)

    ins = [_t([float(rank * world + j)] * 2) for j in range(world)]
    outs = []
    dist.alltoall(ins, outs)
    for i in range(world):
        _check(outs[i], [float(i * world + rank)] * 2)

    flat = _t([float(rank * world + j) for j in range(world)])
    single_out = _t([0.0] * world)
    dist.alltoall_single(flat, single_out)
    _check(single_out, [float(i * world + rank) for i in range(world)])

    chunk = _t([0.0, 0.0])
    if rank == 0:
        dist.scatter(chunk, [_t([float(7 + r)] * 2) for r in range(world)],
                     src=0)
    else:
        dist.scatter(chunk, src=0)
    _check(chunk, [float(7 + rank)] * 2)

    objs = []
    dist.all_gather_object(objs, {"rank": rank, "tag": "x" * (rank + 1)})
    assert [o["rank"] for o in objs] == list(range(world))
    assert all(objs[r]["tag"] == "x" * (r + 1) for r in range(world))

    # LocalSGD: different data on each rank, equal parameters after the
    # averaging of step 3
    gen = torch.Generator().manual_seed(0)
    m = nn.Linear(4, 2, device="cpu", generator=gen)
    opt = LocalSGDOptimizer(SGD(learning_rate=1e-2,
                                parameters=m.parameters()), k_steps=3)
    rng = np.random.default_rng(100 + rank)
    for _ in range(3):
        x_, y_ = (_t(rng.normal(size=s)) for s in ((8, 4), (8, 2)))
        loss = ((m(x_) - y_) * (m(x_) - y_)).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    mine = m.weight.detach().numpy().copy()
    others = []
    dist.all_gather_object(others, mine)
    for other in others:
        np.testing.assert_allclose(other, mine, rtol=1e-6, atol=1e-7)

    # DGC: the same data and init on every rank, the compressed and
    # averaged gradients equal, so the parameters stay in lockstep
    gen = torch.Generator().manual_seed(1)
    m2 = nn.Linear(4, 2, device="cpu", generator=gen)
    opt2 = DGCMomentum(Momentum(learning_rate=1e-2, momentum=0.9,
                                parameters=m2.parameters()),
                       sparsity=(0.5,))
    rng2 = np.random.default_rng(7)
    for _ in range(3):
        x_, y_ = (_t(rng2.normal(size=s)) for s in ((8, 4), (8, 2)))
        loss = ((m2(x_) - y_) * (m2(x_) - y_)).mean()
        loss.backward()
        opt2.step()
        opt2.clear_grad()
    mine2 = m2.weight.detach().numpy().copy()
    others2 = []
    dist.all_gather_object(others2, mine2)
    for other in others2:
        np.testing.assert_allclose(other, mine2, rtol=1e-6, atol=1e-7)

    dist.barrier()
    store = dist.get_store()
    assert store is not None
    store.set(f"mark/{rank}", str(rank))
    store.barrier("marks")
    for r in range(world):
        assert store.get(f"mark/{r}").decode() == str(r)


def jax_rows(rank, world):
    """This rank's rows of the collectives the parent runs through the
    JAX package's shard_map on the same numpy inputs (the parent's
    `_jax_collectives` makes them from the same seeds)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(world, 4)).astype(np.float32)
    x2 = np.random.default_rng(1).normal(size=(world, world)) \
        .astype(np.float32)
    x3 = np.arange(world * world, dtype=np.float32).reshape(world, world)
    out = {}
    for name, op in (("psum", dist.ReduceOp.SUM), ("pmax", dist.ReduceOp.MAX),
                     ("pmean", dist.ReduceOp.AVG)):
        t = torch.from_numpy(x[rank].copy())
        dist.all_reduce(t, op=op)
        out[name] = t.numpy()
    rows = []
    dist.all_gather(rows, torch.from_numpy(x[rank].copy()))
    out["all_gather"] = torch.stack(rows).numpy()
    mine = torch.zeros(1)
    dist.reduce_scatter(mine, [torch.from_numpy(x2[rank, j:j + 1].copy())
                               for j in range(world)])
    out["psum_scatter"] = mine.numpy()
    got = torch.zeros(world)
    dist.alltoall_single(torch.from_numpy(x3[rank].copy()), got)
    out["all_to_all"] = got.numpy()
    src = world - 1
    b = torch.from_numpy(x[rank].copy())
    dist.broadcast(b, src=src)
    out["broadcast"] = b.numpy()
    ring = torch.zeros(4)
    tasks = dist.batch_isend_irecv([
        dist.P2POp(dist.irecv, ring, (rank - 1) % world),
        dist.P2POp(dist.isend, torch.from_numpy(x[rank].copy()),
                   (rank + 1) % world)])
    for task in tasks:
        task.wait()
    out["ppermute_ring"] = ring.numpy()
    return out


def topology_groups():
    """For each of TOPOLOGIES, this rank's group of each axis (None where
    the reference makes none), its coordinates, the mode, and a sum of
    the ranks over the data-parallel group."""
    out = []
    for dims in TOPOLOGIES:
        hcg = fleet.HybridCommunicateGroup(
            fleet.CommunicateTopology(AXES, dims))
        groups = {"data": hcg.get_data_parallel_group(),
                  "pipe": hcg.get_pipe_parallel_group(),
                  "sharding": hcg.get_sharding_parallel_group(),
                  "sep": hcg.get_sep_parallel_group(),
                  "model": hcg.get_model_parallel_group()}
        total = torch.tensor([float(dist.get_rank())])
        dist.all_reduce(total, group=groups["data"])
        out.append({
            "dims": list(dims),
            "groups": {axis: None if g is None else g.ranks
                       for axis, g in groups.items()},
            "coord": [hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                      hcg.get_sharding_parallel_rank(),
                      hcg.get_model_parallel_rank()],
            "mode": hcg.get_parallel_mode(), "dp_sum": float(total)})
    return out


def collectives(out_dir, rank, world):
    reference_assertions(rank, world)
    rows = jax_rows(rank, world)
    if world == 4:
        with open(os.path.join(out_dir, f"topology{rank}.json"), "w") as f:
            json.dump(topology_groups(), f)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **rows)


def dp(out_dir, rank, world):
    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.incubate.models import (
        GPTConfig, GPTForCausalLM, GPTPretrainingCriterion)
    from paddle_tpu_torch.io import DistributedBatchSampler
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    with np.load(os.path.join(out_dir, "init.npz")) as f:
        init = {k: f[k] for k in f.files}
    with np.load(os.path.join(out_dir, "data.npz")) as f:
        ids, labels = f["ids"], f["labels"]
    results = {}
    for name, (kind, clip, sync, graph) in _DP_RUNS.items():
        strategy = fleet.DistributedStrategy()
        fleet.init(is_collective=True, strategy=strategy, device="cpu")
        inner = GPTForCausalLM(GPTConfig(**DP_CONFIG), device="cpu")
        load_jax_state(inner, init)
        hcg = fleet.get_hybrid_communicate_group()
        assert hcg.get_data_parallel_world_size() == world
        if sync:
            model = fleet.distributed_model(inner)
            assert isinstance(model, dist.DataParallel), model
        else:
            model = dist.DataParallel(
                inner, group=hcg.get_data_parallel_group(), grad_sync=False)
        grad_clip = ClipGradByGlobalNorm(CLIP_NORM) if clip else None
        if kind == "adamw":
            opt = AdamW(learning_rate=DP_LR, weight_decay=DP_DECAY,
                        parameters=inner.parameters(), grad_clip=grad_clip)
        else:
            opt = Momentum(learning_rate=MOMENTUM_LR, momentum=0.9,
                           parameters=inner.parameters(),
                           grad_clip=grad_clip)
        opt = fleet.distributed_optimizer(opt)
        crit = GPTPretrainingCriterion()
        step = TrainStep(model, crit, opt)
        sampler = DistributedBatchSampler(
            np.arange(DP_STEPS * DP_GLOBAL_BATCH),
            batch_size=DP_GLOBAL_BATCH // world, shuffle=False)
        losses, norms = [], []
        for batch in list(sampler)[:DP_STEPS]:
            x = torch.from_numpy(ids[batch])
            y = torch.from_numpy(labels[batch])
            if graph:
                losses.append(float(step(x, y)))
            else:
                loss = crit(model(x), y)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss.detach()))
            if clip:
                norms.append(float(opt._grad_clip.global_norm))
        results[f"{name}/losses"] = np.asarray(losses)
        results[f"{name}/norms"] = np.asarray(norms)
        results[f"{name}/batches"] = np.asarray(list(sampler)[:DP_STEPS])
        for pname, p in inner.named_parameters():
            results[f"{name}/param/{pname}"] = p.detach().numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)


def main():
    mode, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    dist.init_parallel_env(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == int(os.environ["PADDLE_TRAINERS_NUM"]), world
    assert dist.get_backend() == "gloo"
    {"collectives": collectives, "dp": dp}[mode](out_dir, rank, world)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK {rank} OK", flush=True)


if __name__ == "__main__":
    main()
