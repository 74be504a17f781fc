"""One rank of the port's 2-rank sync-BN checks (gloo, CPU).

Run through torch.multiprocessing by tests/test_torch_port_batch_norm.py
(``run_bn``), tests/test_torch_port_resnet.py (``run_resnet``) and
tests/test_torch_port_lean_bn.py (``run_lean``, plain and ghost): every
rank builds the same seeded inputs, takes its half of the batch, runs
training-mode BN synchronized over the world group, and writes what it got
to ``<out_dir>/rank<r>.pt``. Imports torch and the port only.
"""

import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import BottleneckBlock, ResNet
from horovod_tpu_torch.ops.batch_norm import (fused_batch_norm_train,
                                               lean_batch_norm_train)
from horovod_tpu_torch.parallel import classification_loss

M, C = 64, 24
RESNET = dict(stage_sizes=[1, 1], block_cls=BottleneckBlock, num_classes=10,
              num_filters=8, dtype=torch.float32, norm="pallas")


def bn_inputs():
    """x (M, C), gamma, beta and the cotangent of y, from a seed."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(M, C, generator=g) * 2.0 + 0.5
    gamma = torch.rand(C, generator=g) + 0.5
    beta = torch.randn(C, generator=g)
    gy = torch.randn(M, C, generator=g)
    return x, gamma, beta, gy


def resnet_and_batch(group=None):
    """The small pallas-BN ResNet with nonzero block-final scales, and a
    batch of 8 images with labels."""
    model = ResNet(**RESNET, bn_group=group, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for block in model.blocks:
            block.norms[-1].weight.uniform_(0.5, 1.5, generator=g)
    x = torch.randn(8, 3, 32, 32, generator=g)
    y = torch.randint(0, 10, (8,), generator=g)
    return model, {"x": x, "y": y}


def _start(rank, size, store_path):
    store = dist.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size)
    return hvd.process_group()


def run_bn(rank, size, store_path, out_dir):
    group = _start(rank, size, store_path)
    try:
        x, gamma, beta, gy = bn_inputs()
        rows = slice(rank * M // size, (rank + 1) * M // size)
        xs = x[rows].clone().requires_grad_()
        gs, bs = (t.clone().requires_grad_() for t in (gamma, beta))
        y, mean, var = fused_batch_norm_train(xs, gs, bs, 1e-5, group)
        dx, dgamma, dbeta = torch.autograd.grad(y, (xs, gs, bs), gy[rows])
        torch.save(dict(y=y.detach(), mean=mean, var=var, dx=dx,
                        dgamma=dgamma, dbeta=dbeta),
                   "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def run_lean(rank, size, store_path, out_dir, groups=1):
    """Lean BN with the fused ReLU on this rank's half of the rows, sync
    over the world group, ``groups`` ghost groups on each rank."""
    group = _start(rank, size, store_path)
    try:
        x, gamma, beta, gy = bn_inputs()
        rows = slice(rank * M // size, (rank + 1) * M // size)
        xs = x[rows].clone().requires_grad_()
        gs, bs = (t.clone().requires_grad_() for t in (gamma, beta))
        y, mean, var = lean_batch_norm_train(xs, gs, bs, 1e-5, True, groups,
                                             group)
        dx, dgamma, dbeta = torch.autograd.grad(y, (xs, gs, bs), gy[rows])
        torch.save(dict(y=y.detach(), mean=mean, var=var, dx=dx,
                        dgamma=dgamma, dbeta=dbeta),
                   "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def run_resnet(rank, size, store_path, out_dir):
    group = _start(rank, size, store_path)
    try:
        model, batch = resnet_and_batch(group)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        n = batch["y"].shape[0] // size
        shard = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
        loss = classification_loss(model, shard)
        loss.backward()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01),
            model.named_parameters())
        opt.synchronize()
        torch.save(dict(grads={k: p.grad.clone()
                               for k, p in model.named_parameters()},
                        buffers={k: b.clone()
                                 for k, b in model.named_buffers()},
                        loss=hvd.allreduce(loss.detach())),
                   "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()


def spawn(fn, out_dir, size=2, timeout=180):
    """Runs ``fn(rank, size, store, out_dir)`` on ``size`` spawned ranks
    and returns what each saved."""
    ranks = mp.start_processes(
        fn, args=(size, str(out_dir / "store"), str(out_dir)), nprocs=size,
        start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    while not ranks.join(timeout=5):  # raises if a rank failed
        if time.monotonic() > deadline:
            for proc in ranks.processes:
                proc.kill()
            raise TimeoutError("the gloo ranks did not finish in %d s"
                               % timeout)
    return [torch.load(str(out_dir / ("rank%d.pt" % r)))
            for r in range(size)]
