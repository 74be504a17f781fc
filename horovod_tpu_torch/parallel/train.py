"""Data-parallel train step: forward, backward, gradient average, update.

Counterpart of ``horovod_tpu/parallel/train.py::make_train_step`` (the
plain, replicated path). There the whole step is one XLA program whose
gradient ``psum`` rides the TPU interconnect; here the step runs
eagerly, and ``DistributedOptimizer`` averages the gradients over the
process group (NCCL on the GPU), bucket by bucket while the backward pass
runs, before the inner optimizer's update. Each rank passes its own shard
of the batch.
"""

import contextlib

import torch
import torch.nn.functional as F

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.common.ops import allreduce, tree_map
from horovod_tpu_torch.ops.losses import chunked_softmax_cross_entropy
from horovod_tpu_torch.optimizer import DistributedOptimizer


def make_train_step(model, loss_fn, optimizer, accum_steps=1, device=None):
    """Builds ``step(batch) -> loss`` for ``model``.

    Args:
      model: an ``nn.Module`` on ``device``.
      loss_fn: ``loss_fn(model, batch) -> scalar`` over this rank's shard.
        ``batch`` is a tensor, or a tuple, list or dict of tensors (the JAX
        step's pytree), every leaf with the shard's rows along dim 0.
      optimizer: a torch optimizer over the model's parameters, or one
        already wrapped in ``DistributedOptimizer`` (it is wrapped here
        otherwise).
      accum_steps: gradient accumulation. Every leaf of the shard is split
        into ``accum_steps`` microbatches along dim 0 (which must divide
        its rows); their mean gradient takes one reduction, overlapped with
        the last microbatch's backward, and one update.
      device: where the batch is moved; default the GPU (``"cpu"`` for
        tests).

    ``step(batch)`` returns the loss averaged over the ranks, as a
    0-dim tensor on ``device``.
    """
    device = resolve_device(device)
    if not isinstance(optimizer, DistributedOptimizer):
        optimizer = DistributedOptimizer(optimizer, model.named_parameters())

    def step(batch):
        batch = tree_map(lambda t: t.to(device, non_blocking=True), batch)
        for leaf in _leaves(batch):
            if leaf.shape[0] % accum_steps:
                raise ValueError(
                    "accum_steps=%d must divide the shard's %d rows"
                    % (accum_steps, leaf.shape[0]))
        optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=device)
        for i in range(accum_steps):
            micro = tree_map(lambda t: t.chunk(accum_steps)[i], batch)
            last = i == accum_steps - 1
            with contextlib.nullcontext() if last else optimizer._no_sync():
                loss = loss_fn(model, micro)
                (loss / accum_steps).backward()
            total += loss.detach().float() / accum_steps
        optimizer.step()
        return allreduce(total, average=True)

    step.optimizer = optimizer
    return step


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy with integer labels, in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


def lm_loss(model, tokens):
    """Next-token loss of the LM benchmark: targets are the tokens rolled
    one to the left, log-softmax in float32, mean over every position."""
    logits = model(tokens)
    return cross_entropy_loss(logits, torch.roll(tokens, -1, dims=1))


def lm_loss_streaming(model, tokens):
    """``lm_loss`` through the streaming loss (``bench.py --fused-xent``):
    the final hidden states (``return_hidden=True``) go to
    ``chunked_softmax_cross_entropy`` over ``lm_head.weight`` with the
    tokens rolled one to the left as targets, so the [B, L, vocab] f32
    logits never exist. The chunk is bench's: the largest of 512, 256, 128
    and 64 that divides L, else L."""
    L = tokens.shape[1]
    chunk = next((c for c in (512, 256, 128, 64) if L % c == 0), L)
    hidden = model(tokens, return_hidden=True)
    return chunked_softmax_cross_entropy(hidden, model.lm_head.weight,
                                         torch.roll(tokens, -1, dims=1),
                                         chunk=chunk)


def shard_lm_loss(model, batch):
    """Next-token loss of a sequence shard, ``batch = {"tokens",
    "positions", "labels"}`` ([B, L_local] each): the labels were shifted
    in natural order before the sequence was sharded (``zigzag_shard``), and
    the positions are global. Mean over the shard's tokens; averaged over
    equal shards by the step, that is the mean over the whole sequence."""
    logits = model(batch["tokens"], batch["positions"])
    return cross_entropy_loss(logits, batch["labels"])


def classification_loss(model, batch):
    """Loss of the image-classification benchmark: the logits of
    ``batch["x"]`` with the model in training mode (BN on the batch
    statistics), the mean f32 cross entropy against ``batch["y"]``."""
    model.train()
    return cross_entropy_loss(model(batch["x"]), batch["y"])
