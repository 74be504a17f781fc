"""Data-parallel train step: forward, backward, gradient average, update.

Counterpart of ``horovod_tpu/parallel/train.py::make_train_step`` (the
plain, replicated path). There the whole step is one XLA program whose
gradient ``psum`` rides the TPU interconnect; here the step runs
eagerly, and ``DistributedOptimizer`` averages the gradients over the
process group (NCCL on the GPU) before the inner optimizer's update.
Each rank passes its own shard of the batch. Overlapping the reduction
with the backward pass is later work.
"""

import torch
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.common.ops import allreduce
from horovod_tpu_torch.optimizer import DistributedOptimizer


def make_train_step(model, loss_fn, optimizer, accum_steps=1, device=None):
    """Builds ``step(batch) -> loss`` for ``model``.

    Args:
      model: an ``nn.Module`` on ``device``.
      loss_fn: ``loss_fn(model, batch) -> scalar`` over this rank's shard.
      optimizer: a torch optimizer over the model's parameters, or one
        already wrapped in ``DistributedOptimizer`` (it is wrapped here
        otherwise).
      accum_steps: gradient accumulation. The shard is split into
        ``accum_steps`` microbatches along dim 0 (which must divide it);
        their mean gradient takes one reduction and one update.
      device: where the batch is moved; default the GPU (``"cpu"`` for
        tests).

    ``step(batch)`` returns the loss averaged over the ranks, as a
    0-dim tensor on ``device``.
    """
    device = resolve_device(device)
    if not isinstance(optimizer, DistributedOptimizer):
        optimizer = DistributedOptimizer(optimizer, model.named_parameters())

    def step(batch):
        batch = batch.to(device, non_blocking=True)
        if batch.shape[0] % accum_steps:
            raise ValueError("accum_steps=%d must divide the shard's %d rows"
                             % (accum_steps, batch.shape[0]))
        optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=device)
        for micro in batch.chunk(accum_steps):
            loss = loss_fn(model, micro)
            (loss / accum_steps).backward()
            total += loss.detach().float() / accum_steps
        optimizer.step()
        return allreduce(total, average=True)

    step.optimizer = optimizer
    return step


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy with integer labels, in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


def lm_loss(model, tokens):
    """Next-token loss of the LM benchmark: targets are the tokens rolled
    one to the left, log-softmax in float32, mean over every position."""
    logits = model(tokens)
    return cross_entropy_loss(logits, torch.roll(tokens, -1, dims=1))
