"""Port parity in one process: the collectives at world size 1, the
world's bring-up, gloo's explicit group, the stream variants,
`DataParallel` at one rank and the samplers, against the JAX package.

- The world-1 answers of tests/test_collective_matrix.py::
  TestEagerCollectiveAPI, the same on the port both before
  `init_parallel_env` (local ops, no process group) and after it (a gloo
  world of one: the ops go through torch.distributed).
- `init_parallel_env()` with no device means the card and raises here,
  where there is none; ``device="cpu"`` means gloo.
- The counterparts of tests/test_data_stack.py::test_gloo_single_rank_roundtrip
  and ::test_communication_stream_package.
- `DataParallel` in a world of one syncs nothing (no hooks), hands
  `TrainStep` its gradients untouched and keeps the wrapped model's state
  names; `_buckets` packs by dtype within the size limit.
- Every sampler's indices equal the reference's exactly
  (`paddle_tpu/io/sampler.py`), the random ones from the same numpy seed;
  `DistributedBatchSampler` over dataset lengths, batch sizes, 1-4
  replicas, shuffle, drop_last and epochs.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import io as jio

import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.distributed.parallel import _buckets

from test_torch_distributed_ranks import _free_port


@pytest.fixture
def world1(request):
    """None: no world brought up; "gloo": a gloo world of one rank. Left
    torn down either way."""
    dist.destroy_process_group()
    if request.param == "gloo":
        dist.init_parallel_env(device="cpu")
    yield request.param
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# world size 1: the reference's eager answers
# ---------------------------------------------------------------------------

def _jax_world1():
    """TestEagerCollectiveAPI's cases on the reference, as numpy."""
    out = {}
    t = paddle.Tensor(jnp.ones((4,), jnp.float32))
    jdist.all_reduce(t)
    out["all_reduce"] = np.asarray(t._value)
    got = []
    jdist.all_gather(got, paddle.Tensor(jnp.arange(4, dtype=jnp.float32)))
    out["all_gather"] = [np.asarray(g._value) for g in got]
    dst = paddle.Tensor(jnp.zeros((4,), jnp.float32))
    jdist.reduce_scatter(dst, [paddle.Tensor(jnp.full((4,), float(i)))
                               for i in range(2)])
    out["reduce_scatter"] = np.asarray(dst._value)
    t = paddle.Tensor(jnp.full((3,), 7.0))
    jdist.broadcast(t, src=0)
    out["broadcast"] = np.asarray(t._value)
    src = paddle.Tensor(jnp.asarray([1.0, 2.0, 3.0]))
    dst = paddle.Tensor(jnp.zeros((3,)))
    jdist.send(src, dst=0)
    jdist.recv(dst, src=0)
    out["send_recv"] = np.asarray(dst._value)
    return out


@pytest.mark.parametrize("world1", [None, "gloo"], indirect=True)
def test_world1_collectives_match_jax(world1):
    want = _jax_world1()
    t = torch.ones(4)
    dist.all_reduce(t)
    np.testing.assert_array_equal(t.numpy(), want["all_reduce"])
    got = []
    dist.all_gather(got, torch.arange(4, dtype=torch.float32))
    assert len(got) == len(want["all_gather"]) == 1
    np.testing.assert_array_equal(got[0].numpy(), want["all_gather"][0])
    dst = torch.zeros(4)
    dist.reduce_scatter(dst, [torch.full((4,), float(i)) for i in range(2)])
    np.testing.assert_array_equal(dst.numpy(), want["reduce_scatter"])
    t = torch.full((3,), 7.0)
    dist.broadcast(t, src=0)
    np.testing.assert_array_equal(t.numpy(), want["broadcast"])
    src, dst = torch.tensor([1.0, 2.0, 3.0]), torch.zeros(3)
    dist.send(src, dst=0)
    dist.recv(dst, src=0)
    np.testing.assert_array_equal(dst.numpy(), want["send_recv"])
    dist.barrier()
    g = dist.get_group(0)
    assert g is not None and g.nranks == 1 and g.rank == 0
    assert dist.get_backend() == world1
    assert (g.pg is None) == (world1 is None)


@pytest.mark.parametrize("world1", [None, "gloo"], indirect=True)
def test_world1_remaining_primitives(world1):
    """The rest of the API at one rank: every op's answer is its own
    input, as the reference's single-process path gives."""
    x = torch.arange(6, dtype=torch.float32)
    for op in (dist.ReduceOp.SUM, dist.ReduceOp.MAX, dist.ReduceOp.MIN,
               dist.ReduceOp.PROD, dist.ReduceOp.AVG):
        t = x.clone()
        task = dist.all_reduce(t, op=op, sync_op=False)
        task.wait()
        assert task.is_completed()
        np.testing.assert_array_equal(t.numpy(), x.numpy())
    t = x.clone()
    dist.reduce(t, dst=0)
    np.testing.assert_array_equal(t.numpy(), x.numpy())
    out = torch.zeros(6)
    dist.scatter(out, [x], src=0)
    np.testing.assert_array_equal(out.numpy(), x.numpy())
    outs = []
    dist.alltoall([x], outs)
    np.testing.assert_array_equal(outs[0].numpy(), x.numpy())
    out = torch.zeros(6)
    dist.alltoall_single(x, out)
    np.testing.assert_array_equal(out.numpy(), x.numpy())
    objs = []
    dist.all_gather_object(objs, {"a": 1})
    assert objs == [{"a": 1}]
    cat = torch.zeros(6)
    dist.all_gather(cat, x)
    np.testing.assert_array_equal(cat.numpy(), x.numpy())
    # a partial exchange with oneself, and a batch listing its irecv first
    slot = torch.zeros(6)
    dist.partial_send(x, dst=0, nranks=2, rank_id=1)
    dist.partial_recv(slot, src=0, nranks=2, rank_id=1)
    np.testing.assert_array_equal(slot.numpy(), [0, 0, 0, 3, 4, 5])
    inbox = torch.zeros(6)
    for task in dist.batch_isend_irecv([dist.P2POp(dist.irecv, inbox, 0),
                                        dist.P2POp(dist.isend, x, 0)]):
        task.wait()
    np.testing.assert_array_equal(inbox.numpy(), x.numpy())
    with pytest.raises(ValueError, match="isend or irecv"):
        dist.P2POp(dist.all_reduce, x, 0)
    g = dist.new_group([0])
    t = x.clone()
    dist.all_reduce(t, group=g)
    np.testing.assert_array_equal(t.numpy(), x.numpy())
    with pytest.raises(ValueError, match="increasing"):
        dist.new_group([0, 0])
    assert dist.get_rank() == 0 and dist.get_world_size() == 1
    env = dist.ParallelEnv()
    assert (env.rank, env.world_size, env.nranks, env.device_id) == \
        (0, 1, 1, 0)


def test_a_larger_group_without_a_world_raises():
    """A group of two ranks made before init_parallel_env carries its
    ranks and no process group; using it raises."""
    dist.destroy_process_group()
    g = dist.new_group([0, 1])
    assert (g.rank, g.nranks, g.ranks, g.pg) == (0, 2, [0, 1], None)
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        dist.all_reduce(torch.ones(2), group=g)


# ---------------------------------------------------------------------------
# bring-up: the device rule
# ---------------------------------------------------------------------------

def test_init_parallel_env_means_the_card_and_cpu_means_gloo():
    dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            dist.init_parallel_env()
        assert not dist.is_initialized()
    with pytest.raises(ValueError, match="finite"):
        dist.init_parallel_env(device="cpu", timeout=float("inf"))
    try:
        env = dist.init_parallel_env(device="cpu", timeout=30)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert (env.rank, env.world_size) == (0, 1)
        # a second call returns the world it has
        assert dist.init_parallel_env().world_size == 1
        store = dist.get_store()
        store.set("k", "v")
        assert store.get("k") == b"v"
        assert store.add("n", 2) == 2 and store.add("n", 3) == 5
        store.barrier("t")
        assert store.delete_key("k")
        with pytest.raises(KeyError):
            store.get("k", wait=False)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized() and dist.get_store() is None


def test_gloo_single_rank_roundtrip():
    """tests/test_data_stack.py::test_gloo_single_rank_roundtrip on the
    port (its own port: a gloo group of its own, apart from the world)."""
    dist.gloo_init_parallel_env(0, 1, f"127.0.0.1:{_free_port()}")
    dist.gloo_barrier()
    dist.gloo_release()
    dist.gloo_release()
    with pytest.raises(RuntimeError, match="gloo_init_parallel_env"):
        dist.gloo_barrier()


@pytest.mark.parametrize("world1", [None], indirect=True)
def test_communication_stream_package(world1):
    """tests/test_data_stack.py::test_communication_stream_package on the
    port."""
    assert hasattr(dist, "stream") and hasattr(dist, "communication")
    t = torch.tensor([1.0, 2.0])
    task = dist.stream.all_reduce(t, sync_op=False, use_calc_stream=True)
    task.wait()
    np.testing.assert_array_equal(t.numpy(), [1.0, 2.0])
    out = []
    dist.stream.all_gather(out, t)
    assert len(out) == 1
    dst = torch.zeros(2)
    dist.stream.alltoall_single(dst, t)
    np.testing.assert_array_equal(dst.numpy(), [1.0, 2.0])
    for name in ("all_gather", "all_reduce", "alltoall", "alltoall_single",
                 "broadcast", "reduce", "reduce_scatter", "recv", "scatter",
                 "send"):
        assert hasattr(dist.stream, name), name
        assert hasattr(dist.communication.stream, name), name


# ---------------------------------------------------------------------------
# DataParallel at one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world1", [None, "gloo"], indirect=True)
def test_data_parallel_at_one_rank_syncs_nothing(world1):
    from paddle_tpu_torch import nn
    gen = torch.Generator().manual_seed(0)
    inner = nn.Sequential(nn.Linear(4, 3, device="cpu", generator=gen),
                          nn.ReLU(), nn.Linear(3, 2, device="cpu",
                                               generator=gen))
    model = dist.DataParallel(inner)
    assert model._hooks == [] and not model._sync
    assert list(model.state_dict()) == list(inner.state_dict())
    x = torch.randn(5, 4, generator=gen)
    np.testing.assert_array_equal(model(x).detach().numpy(),
                                  inner(x).detach().numpy())
    model(x).sum().backward()
    grads = [p.grad.clone() for p in inner.parameters()]
    model.apply_collective_grads()
    for p, g in zip(inner.parameters(), grads):
        assert torch.equal(p.grad, g)
    pairs = [(p, p.grad) for p in inner.parameters()]
    assert model._reduce_grads(pairs) is pairs
    model.load_state_dict(inner.state_dict())


def test_buckets_pack_by_dtype_within_the_limit():
    gs = [torch.zeros(10), torch.zeros(3, dtype=torch.bfloat16),
          torch.zeros(20), torch.zeros(30), torch.zeros(2, dtype=torch.bfloat16),
          torch.zeros(5)]
    # 100 bytes: fp32 10 + 20 elements fit (120 bytes do not)
    got = [[int(g.numel()) for g in b] for b in _buckets(gs, 100)]
    assert got == [[10], [3, 2], [20], [30], [5]]
    got = [[int(g.numel()) for g in b] for b in _buckets(gs, 1 << 20)]
    assert got == [[10, 20, 30, 5], [3, 2]]


# ---------------------------------------------------------------------------
# samplers: the reference's indices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,batch,replicas", [
    (n, b, r) for n, b, r in itertools.product((1, 7, 16, 23), (1, 3, 4),
                                               (1, 2, 3, 4))])
def test_distributed_batch_sampler_indices_equal_the_reference(n, batch,
                                                               replicas):
    data = list(range(n))
    for shuffle, drop_last in itertools.product((False, True), repeat=2):
        for rank in range(replicas):
            kw = dict(batch_size=batch, num_replicas=replicas, rank=rank,
                      shuffle=shuffle, drop_last=drop_last)
            mine = tio.DistributedBatchSampler(data, **kw)
            ref = jio.DistributedBatchSampler(data, **kw)
            for epoch in (0, 3):
                mine.set_epoch(epoch)
                ref.set_epoch(epoch)
                assert list(mine) == list(ref), (kw, epoch)
                assert len(mine) == len(ref)


def test_distributed_batch_sampler_takes_the_world():
    dist.destroy_process_group()
    s = tio.DistributedBatchSampler(list(range(10)), batch_size=4)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_other_samplers_equal_the_reference():
    data = list(range(11))
    for mine, ref in ((tio.SequenceSampler(data), jio.SequenceSampler(data)),):
        assert list(mine) == list(ref) and len(mine) == len(ref)
    for kw in (dict(), dict(replacement=True), dict(num_samples=5),
               dict(replacement=True, num_samples=17)):
        np.random.seed(4)
        ref = list(jio.RandomSampler(data, **kw))
        np.random.seed(4)
        mine = tio.RandomSampler(data, **kw)
        assert list(mine) == ref and len(mine) == len(ref), kw
    weights = [0.1, 0.4, 0.0, 2.0, 1.5]
    for replacement in (True, False):
        np.random.seed(9)
        ref = list(jio.WeightedRandomSampler(weights, 4, replacement))
        np.random.seed(9)
        mine = tio.WeightedRandomSampler(weights, 4, replacement)
        assert list(mine) == ref and len(mine) == 4
    for batch, drop_last, shuffle in itertools.product((1, 4, 5), (False, True),
                                                       (False, True)):
        np.random.seed(2)
        ref = jio.BatchSampler(data, shuffle=shuffle, batch_size=batch,
                               drop_last=drop_last)
        want = list(ref)
        np.random.seed(2)
        mine = tio.BatchSampler(data, shuffle=shuffle, batch_size=batch,
                                drop_last=drop_last)
        assert list(mine) == want and len(mine) == len(ref)
    inner = tio.SequenceSampler(data)
    assert list(tio.BatchSampler(sampler=inner, batch_size=6)) == \
        list(jio.BatchSampler(sampler=jio.SequenceSampler(data),
                              batch_size=6))
    with pytest.raises(NotImplementedError):
        iter(tio.Sampler(data))
