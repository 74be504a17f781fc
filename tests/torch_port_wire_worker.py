"""Ranks of the port's wire-compression checks (gloo, CPU).

Run through torch.multiprocessing by tests/test_torch_port_wire.py (4
ranks, ``run_wire``): every rank builds the same seeded inputs with numpy,
runs the ring collectives (``ring_allreduce``, ``ring_reduce_scatter``,
``ring_allgather``, keeping every payload it sent) and the collectives and the replicated
``DistributedOptimizer`` under wire modes on its own part of them, and
writes what it got to ``<out_dir>/rank<r>.pt``. Imports torch, numpy and
the port only.
"""

import numpy as np
import torch

import horovod_tpu_torch as hvd
import torch_port_api_worker
import torch_port_bn_worker
from horovod_tpu_torch.parallel import ring

WORLD = 4
MODES = ("none", "bf16", "int8")
# test_ring_allreduce_matches_psum's shape, one array a rank
ALLREDUCE_SHAPE = (8, 1003)
# test_ring_reduce_scatter_matches_summed_chunks' odd size
SCATTER_SIZE = 1003
# test_ring_scatter_then_allgather_is_allreduce's size
ROUND_TRIP_SIZE = 777
# allgather shard lengths: any length for none, whole int8 blocks for the
# codecs (test_ring_allgather_reassembles_in_rank_order)
GATHER_LEN = {"none": 37, "bf16": 256, "int8": 256}
# the collectives' inputs: allreduce on a (3, 5) tensor, reduce_scatter on
# an odd count
COLLECTIVE_SHAPE = (3, 5)
RS_COUNT = 1003


def allreduce_input(r):
    return (np.random.RandomState(40 + r).randn(*ALLREDUCE_SHAPE)
            * 5).astype(np.float32)


def scatter_input(r):
    return (np.linspace(-1, 1, SCATTER_SIZE) * (r + 1)).astype(np.float32)


def gather_input(r, mode):
    c = GATHER_LEN[mode]
    return (np.full(c, r + 1, np.float32) +
            np.linspace(0, 1, c).astype(np.float32) * r)


def round_trip_input(r):
    return np.random.RandomState(5 + r).randn(ROUND_TRIP_SIZE).astype(
        np.float32)


def int_input(r):
    return np.arange(64, dtype=np.int32) + 1000 * r


class RecordingCodec(ring.RingCodec):
    """``RingCodec`` that appends a copy of every payload it encodes, in
    the order of the hops, to ``RecordingCodec.log``."""

    log = []

    def encode(self, chunk):
        payload = super().encode(chunk)
        RecordingCodec.log.append(tuple(p.clone() for p in payload))
        return payload


def _rings(r, out):
    # this process only: the ring collectives build their codec from here
    ring.RingCodec = RecordingCodec
    for mode in MODES:
        RecordingCodec.log = out["hops/allreduce/" + mode] = []
        out["allreduce/" + mode] = ring.ring_allreduce(
            torch.from_numpy(allreduce_input(r)), compression=mode)
        RecordingCodec.log = out["hops/reduce_scatter/" + mode] = []
        out["reduce_scatter/" + mode] = ring.ring_reduce_scatter(
            torch.from_numpy(scatter_input(r)), compression=mode)
        RecordingCodec.log = []
        out["allgather/" + mode] = ring.ring_allgather(
            torch.from_numpy(gather_input(r, mode)), compression=mode)
        RecordingCodec.log = out["hops/round_trip/" + mode] = []
        shard = ring.ring_reduce_scatter(
            torch.from_numpy(round_trip_input(r)), compression=mode)
        out["round_trip/" + mode] = ring.ring_allgather(shard,
                                                        compression=mode)
    RecordingCodec.log = []
    out["int32"] = ring.ring_allreduce(torch.from_numpy(int_input(r)),
                                       compression="int8")
    out["int32_rs"] = ring.ring_reduce_scatter(
        torch.from_numpy(int_input(r)), compression="int8")
    # the codec kernels' plain versions ran on these CPU tensors
    from horovod_tpu_torch.ops import wire_codec
    out["kernel_launches"] = wire_codec.launch_counts()


def _collectives(r, out):
    x = torch.from_numpy(torch_port_api_worker.rank_input(
        r, COLLECTIVE_SHAPE))
    t = torch.from_numpy(torch_port_api_worker.rank_input(
        r, (RS_COUNT,), seed=30))
    for mode in MODES:
        out["hvd.allreduce/" + mode] = hvd.allreduce(
            x, average=True, name="ar." + mode, compression=mode)
        out["hvd.reduce_scatter/" + mode] = hvd.reduce_scatter(
            t, average=True, name="rs." + mode, compression=mode)
    out["hvd.allreduce/wire_int8"] = hvd.allreduce(
        x, average=True, compression=hvd.Compression.wire_int8)
    out["hvd.allreduce/int32"] = hvd.allreduce(
        torch.from_numpy(int_input(r)), average=False, compression="int8")


def _optimizer(r, out):
    """The replicated DistributedOptimizer under the int8 wire: one
    backward through its hooks, the reduced gradients, and the bucket
    flattened and summed by ring_allreduce by hand."""
    x, y = (torch.from_numpy(a) for a in torch_port_api_worker.mlp_batch(r))
    model = torch_port_api_worker.Mlp()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = list(model.parameters())
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                   model.named_parameters(),
                                   compression="int8")
    torch_port_api_worker.mlp_loss(model, x, y).backward()
    local = [p.grad.clone() for p in params]
    in_backward = list(opt._order)
    opt.synchronize()
    position = {id(p): i for i, p in enumerate(params)}
    by_hand = [None] * len(params)
    for bucket in opt.buckets:
        grads = [local[position[id(p)]] for p in bucket]
        flat = torch.cat([g.reshape(-1) for g in grads])
        summed = ring.ring_allreduce(flat, compression="int8") / WORLD
        for p, part in zip(bucket, summed.split([g.numel() for g in grads])):
            by_hand[position[id(p)]] = part.view_as(p)
    out["dopt_int8"] = dict(
        in_backward=in_backward, buckets=len(opt.buckets),
        grads=[p.grad.clone() for p in params], by_hand=by_hand)


def run_wire(rank, size, store_path, out_dir):
    store = torch.distributed.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size)
    try:
        out = {}
        _rings(rank, out)
        _collectives(rank, out)
        _optimizer(rank, out)
        torch.save(out, "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def spawn_wire(out_dir, timeout=240):
    return torch_port_bn_worker.spawn(run_wire, out_dir, size=WORLD,
                                      timeout=timeout)
