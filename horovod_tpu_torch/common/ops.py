"""Collectives over the process group.

Counterpart of the in-jit plane of ``horovod_tpu/jax/__init__.py``
(``allreduce``, ``allgather``, ``broadcast``): there a ``psum`` inside
the step, here a ``torch.distributed`` call on the device tensors (NCCL
on the GPU, gloo on the CPU). Each returns a new tensor and leaves its
input as it was.
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics


def allreduce(tensor, average=True):
    """Sum (or mean, ``average=True``) of ``tensor`` over the ranks."""
    group = basics.process_group()
    out = tensor.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    if average:
        out.div_(dist.get_world_size(group))
    return out


def allgather(tensor):
    """Concatenation along dim 0 of every rank's ``tensor``; the ranks may
    differ in dim 0 only."""
    group = basics.process_group()
    n = dist.get_world_size(group)
    rows = torch.tensor([tensor.shape[0]], device=tensor.device)
    counts = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(counts, rows, group=group)
    counts = [int(c.item()) for c in counts]
    padded = tensor.new_zeros((max(counts),) + tuple(tensor.shape[1:]))
    padded[:tensor.shape[0]] = tensor
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)], dim=0)


def broadcast(tensor, root_rank=0):
    """``tensor`` as it is on rank ``root_rank``, on every rank."""
    out = tensor.clone()
    dist.broadcast(out, src=root_rank, group=basics.process_group())
    return out
