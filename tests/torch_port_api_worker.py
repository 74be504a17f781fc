"""Ranks of the port's data-parallel API checks (gloo, CPU).

Run through torch.multiprocessing by tests/test_torch_port_api.py (4 ranks,
``run_api``) and tests/test_torch_port_sync_bn.py (2 and 4 ranks,
``run_sync_bn``): every rank builds the same seeded inputs with numpy,
calls the port's API on its own part of them and writes what it got to
``<out_dir>/rank<r>.pt``. Imports torch, numpy and the port only.
"""

import os

import numpy as np
import torch
import torch.nn as nn

import horovod_tpu_torch as hvd
import torch_port_bn_worker
import torch_port_dp_worker
from horovod_tpu_torch.ops import batch_norm as bn
from horovod_tpu_torch.parallel import lm_loss, make_train_step

WORLD = 4
K = 2  # model-parallel width of the mesh: (2, 2)
# allreduce cases: name -> (average, codec name, prescale, postscale)
ALLREDUCE_CASES = {
    "sum": (False, "none", 1.0, 1.0),
    "average": (True, "none", 1.0, 1.0),
    "scaled": (True, "none", 0.5, 3.0),
    "fp16": (True, "fp16", 1.0, 1.0),
    "fp16-scaled": (False, "fp16", 0.25, 2.0),
    "bf16": (True, "bf16", 2.0, 0.5),
}
# reduce_scatter cases: name -> (element count, group: "world" or "batch");
# "even" fills 4 chunks of 256, the int8 block that JAX's in-jit
# reduce_scatter rounds its chunks up to, so both partitions agree
REDUCE_SCATTER_CASES = {"even": (1024, "world"), "uneven": (10, "world"),
                        "batch-odd": (7, "batch")}
LR = 0.05
STEPS = 3
MLP = (6, 8, 3)  # in, hidden, out
# a fusion threshold that splits the small LM into several buckets
BUCKET_BYTES = 8192


def rank_input(r, shape=(3, 5), seed=10):
    return np.random.RandomState(seed + r).randn(*shape).astype(np.float32)


def mlp_params():
    rng = np.random.RandomState(7)
    d, h, o = MLP
    return {"w1": (rng.randn(d, h) * 0.5).astype(np.float32),
            "b1": (rng.randn(h) * 0.1).astype(np.float32),
            "w2": (rng.randn(h, o) * 0.5).astype(np.float32)}


def mlp_batch(r):
    rng = np.random.RandomState(20 + r)
    return (rng.randn(4, MLP[0]).astype(np.float32),
            rng.randn(4, MLP[2]).astype(np.float32))


class Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        for k, v in mlp_params().items():
            setattr(self, k, nn.Parameter(torch.from_numpy(v)))

    def forward(self, x):
        return torch.relu(x @ self.w1 + self.b1) @ self.w2


def mlp_loss(model, x, y):
    return ((model(x) - y) ** 2).mean()


def _codec(name):
    return {"none": None, "fp16": hvd.Compression.fp16,
            "bf16": hvd.Compression.bf16}[name]


def _collectives(r, out):
    x = torch.from_numpy(rank_input(r))
    bg, mg = hvd.batch_group(), hvd.model_group()
    for case, (average, codec, pre, post) in sorted(ALLREDUCE_CASES.items()):
        for gname, group in (("world", None), ("batch", bg)):
            key = "allreduce/%s/%s" % (case, gname)
            out[key] = hvd.allreduce(
                x, average=average, name=key, compression=_codec(codec),
                prescale_factor=pre, postscale_factor=post, group=group)
    for case, (count, gname) in sorted(REDUCE_SCATTER_CASES.items()):
        t = torch.from_numpy(rank_input(r, (count,), seed=30))
        key = "reduce_scatter/" + case
        out[key] = hvd.reduce_scatter(
            t, average=False, name=key,
            group=bg if gname == "batch" else None)
    out["allgather/model"] = hvd.allgather(x[:r % K + 1], group=mg)
    # root_rank is a world rank: the model group's last member
    out["broadcast/model"] = hvd.broadcast(x, root_rank=mg.ranks[-1],
                                           group=mg)
    tree = {"b": x, "a": (x * 2, x[0])}
    out["broadcast/dict"] = hvd.broadcast(tree, root_rank=1)
    # two groups made by hand (every rank makes both); each rank reduces
    # over the one it is in, so every rank makes the same calls
    pair = [hvd.new_group([0, 2]), hvd.new_group([1, 3])]
    out["pair_groups"] = [(g.id, g.ranks, g.rank(), g.size(), r in g)
                          for g in pair]
    out["allreduce/pair"] = hvd.allreduce(x, average=False,
                                          group=pair[r % 2])
    try:  # the group this rank is not in
        hvd.allreduce(x, name="not_a_member", group=pair[1 - r % 2])
        out["non_member"] = None
    except ValueError as e:
        out["non_member"] = str(e)
    out["metric"] = hvd.metric_average(float(r) + 0.25)


def _digest(out):
    """The digest before and after four named calls, for the test's own
    fold of them."""
    out["digest_before"] = hvd.collective_digest()
    x = torch.ones(4)
    hvd.allreduce(x, name="a")
    hvd.allgather(torch.ones(2, 3, dtype=torch.int64), name="bc")
    hvd.broadcast(x.half(), name="d")
    hvd.reduce_scatter(torch.ones(2, 2), name="e")
    out["digest_after"] = hvd.collective_digest()


def _optimizer(r, out):
    """Three Adam steps of the MLP under DistributedOptimizer over the
    batch group: with group=batch_group() and with the default (None,
    which is the batch group under the mesh)."""
    x, y = (torch.from_numpy(a) for a in mlp_batch(r))
    for label, group in (("explicit", hvd.batch_group()), ("default", None)):
        model = Mlp()
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                        lr=LR),
                                       model.named_parameters(), group=group)
        for _ in range(STEPS):
            opt.zero_grad()
            mlp_loss(model, x, y).backward()
            opt.step()
        out["dopt/" + label] = {k: v.detach().clone()
                                for k, v in model.named_parameters()}


def _overlap(r, out):
    """The overlapped reduction against allreduce_gradients on a copy of
    the same local gradients, over the batch group (2 ranks) and the world
    (4)."""
    os.environ["HVD_TPU_FUSION_THRESHOLD"] = str(BUCKET_BYTES)
    try:
        for label, group in (("batch", hvd.batch_group()),
                             ("world", hvd.WORLD)):
            model, tokens = torch_port_dp_worker.model_and_batch()
            params = list(model.parameters())
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(params, lr=0.1), model.named_parameters(),
                group=group)
            lm_loss(model, tokens.chunk(WORLD)[r]).backward()
            local = [p.grad.clone() for p in params]
            in_backward = list(opt._order)
            opt.synchronize()
            overlapped = [p.grad.clone() for p in params]
            for p, g in zip(params, local):
                p.grad = g
            hvd.allreduce_gradients(params, group=group)
            out["overlap/" + label] = dict(
                buckets=len(opt.buckets), in_backward=in_backward,
                launch_order=opt.launch_order, overlapped=overlapped,
                fused=[p.grad.clone() for p in params])
    finally:
        del os.environ["HVD_TPU_FUSION_THRESHOLD"]


def _accumulation(r, out):
    """make_train_step with accum_steps=2 and 1 on the same shard: the
    same update; the first microbatch reduces nothing (the digest counts
    one collective a bucket and the loss's)."""
    for accum in (1, 2):
        model, tokens = torch_port_dp_worker.model_and_batch()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            model.named_parameters())
        step = make_train_step(model, lm_loss, opt, accum_steps=accum,
                               device="cpu")
        seq0 = hvd.collective_digest()[0]
        loss = step(tokens.chunk(WORLD // K)[r // K])
        out["accum/%d" % accum] = dict(
            loss=loss, calls=hvd.collective_digest()[0] - seq0,
            buckets=len(opt.buckets), launch_order=opt.launch_order,
            params={k: v.detach().clone()
                    for k, v in model.named_parameters()})


class _WithUnused(Mlp):
    """The MLP with a parameter the loss never reaches, between two that it
    does: its bucket's hooks never all fire."""

    def __init__(self):
        super().__init__()
        self.unused = nn.Parameter(torch.ones(3))
        self.head = nn.Parameter(torch.full((3,), 0.5))

    def forward(self, x):
        return super().forward(x) * self.head


def _unused(r, out):
    """Buckets (head, unused, w2), (b1,), (w1,): the first never fills in
    the backward, so the other two, though full, wait for it, and all
    three go out at synchronize(), in order."""
    x, y = (torch.from_numpy(a) for a in mlp_batch(r))
    model = _WithUnused()
    params = list(model.parameters())
    os.environ["HVD_TPU_FUSION_THRESHOLD"] = "120"
    try:
        opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                       model.named_parameters())
    finally:
        del os.environ["HVD_TPU_FUSION_THRESHOLD"]
    mlp_loss(model, x, y).backward()
    local = [None if p.grad is None else p.grad.clone() for p in params]
    in_backward = list(opt._order)
    opt.step()
    grads = [None if p.grad is None else p.grad.clone() for p in params]
    for p, g in zip(params, local):
        p.grad = g
    hvd.allreduce_gradients(params, group=hvd.batch_group())
    out["unused"] = dict(in_backward=in_backward, buckets=[
                             [n for n, p in model.named_parameters()
                              if any(p is q for q in b)]
                             for b in opt.buckets],
                         launch_order=opt.launch_order, grads=grads,
                         fused=[None if p.grad is None else p.grad
                                for p in params],
                         params={k: v.detach().clone()
                                 for k, v in model.named_parameters()})


def _divergence(r, out):
    hvd.assert_synchronized()
    out["synchronized"] = hvd.collective_digest()
    alone = hvd.new_group([1])
    if r == 1:  # one extra collective on rank 1 only
        hvd.allreduce(torch.ones(2), group=alone)
    try:
        hvd.assert_synchronized()
        out["diverged"] = None
    except hvd.DivergenceError as e:
        out["diverged"] = str(e)


def run_api(rank, size, store_path, out_dir):
    store = torch.distributed.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size,
             model_parallel=K)
    try:
        out = {"mesh": dict(
            k=hvd.model_parallel_size(),
            batch=(hvd.batch_group().id, hvd.batch_group().ranks,
                   hvd.batch_group().rank()),
            model=(hvd.model_group().id, hvd.model_group().ranks,
                   hvd.model_group().rank()),
            env=os.environ.get("HVD_TPU_MODEL_PARALLEL"))}
        _collectives(rank, out)
        _digest(out)
        _optimizer(rank, out)
        _overlap(rank, out)
        _accumulation(rank, out)
        _unused(rank, out)
        _divergence(rank, out)
        torch.save(out, "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def spawn_api(out_dir, timeout=240):
    return torch_port_bn_worker.spawn(run_api, out_dir, size=WORLD,
                                      timeout=timeout)


# ------------------------------------------------------------- sync BN

# tests/test_batch_norm.py::test_sync_bn_matches_global_batch's inputs:
# 4 shards of 64 rows, 32 channels
BN_N, BN_M, BN_C = 4, 64, 32


def sync_bn_inputs():
    """x, the loss weights w (the loss is sum(y * w)), gamma, beta of the
    whole batch, as that test draws them."""
    rng = np.random.RandomState(5)
    x = rng.randn(BN_N * BN_M, BN_C).astype(np.float32) * 1.5 + 0.3
    w = rng.randn(BN_N * BN_M, BN_C).astype(np.float32)
    gamma = rng.rand(BN_C).astype(np.float32) + 0.5
    beta = rng.randn(BN_C).astype(np.float32)
    return x, w, gamma, beta


def run_sync_bn(rank, size, store_path, out_dir):
    """Stock sync BN on this rank's rows of the batch (the world as the
    group), ``sync_batch_norm_stats`` of its partial sums, and the stock
    sync BN module's running statistics."""
    store = torch.distributed.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size)
    try:
        x, w, gamma, beta = (torch.from_numpy(a).chunk(size)[rank]
                             if a.shape[0] == BN_N * BN_M
                             else torch.from_numpy(a)
                             for a in sync_bn_inputs())
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        y, mean, var = bn.stock_sync_batch_norm_train(*leaves, 1e-5,
                                                      hvd.WORLD)
        dx, dgamma, dbeta = torch.autograd.grad((y * w).sum(), leaves)
        stats = hvd.sync_batch_norm_stats(x.sum(0), (x * x).sum(0),
                                          x.shape[0])
        module = bn.StockBatchNorm(BN_C, group=hvd.WORLD, device="cpu")
        module(x)
        out = dict(y=y.detach(), mean=mean, var=var, dx=dx, dgamma=dgamma,
                   dbeta=dbeta, stats=stats,
                   running=(module.running_mean, module.running_var))
        torch.save(out, "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def spawn_sync_bn(out_dir, size, timeout=180):
    return torch_port_bn_worker.spawn(run_sync_bn, out_dir, size=size,
                                      timeout=timeout)
