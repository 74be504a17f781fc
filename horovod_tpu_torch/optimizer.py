"""Gradient averaging around a torch optimizer.

Counterpart of ``horovod_tpu/jax/__init__.py``'s ``allreduce_gradients``,
``broadcast_parameters``, ``broadcast_optimizer_state`` and
``DistributedOptimizer``. The gradients of a step are averaged over the
ranks before the inner optimizer applies them, through one flat fused
buffer per dtype (the counterpart of the core's tensor fusion), so a
step costs one collective per dtype, not one per parameter.
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics


def allreduce_gradients(parameters, average=True):
    """Averages (or sums) the ``.grad`` of every parameter over the ranks,
    in place, one flat buffer per dtype. Parameters without a gradient are
    skipped: every rank must produce gradients for the same parameters."""
    group = basics.process_group()
    by_dtype = {}
    for p in parameters:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if average:
            flat.div_(dist.get_world_size(group))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def broadcast_parameters(params, root_rank=0):
    """Overwrites ``params`` (a state_dict, named_parameters() or
    tensors) with their values on ``root_rank``, in place."""
    tensors = params.values() if isinstance(params, dict) else (
        p[1] if isinstance(p, tuple) else p for p in params)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=root_rank,
                           group=basics.process_group())


def broadcast_optimizer_state(optimizer, root_rank=0):
    """Overwrites the tensors of the optimizer's state (moments, step
    counts) with root's, in place. State the optimizer has not created
    yet (before its first step) has nothing to send."""
    opt = getattr(optimizer, "optimizer", optimizer)
    with torch.no_grad():
        for state in opt.state.values():
            for key, t in state.items():
                if torch.is_tensor(t):
                    # Adam keeps its step count on the CPU; NCCL sends
                    # device tensors only.
                    buf = t.to(basics.device())
                    dist.broadcast(buf, src=root_rank,
                                   group=basics.process_group())
                    state[key] = buf.to(t.device)


class DistributedOptimizer:
    """Wraps a torch optimizer so that ``step()`` first averages the
    gradients over the ranks (one fused collective per dtype), then runs
    the inner step. ``named_parameters`` fixes the order of the fused
    buffer; it defaults to the optimizer's own parameter order, which is
    the same on every rank that built the same model."""

    def __init__(self, optimizer, named_parameters=None):
        self.optimizer = optimizer
        if named_parameters is not None:
            self._params = [p for _, p in named_parameters]
        else:
            self._params = [p for g in optimizer.param_groups
                            for p in g["params"]]

    def synchronize(self):
        """Averages the gradients over the ranks now."""
        allreduce_gradients(self._params)

    def step(self):
        self.synchronize()
        self.optimizer.step()

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)
