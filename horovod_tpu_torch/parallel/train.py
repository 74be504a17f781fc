"""Data-parallel train steps: forward, backward, gradient average, update.

Counterpart of ``horovod_tpu/parallel/train.py``: ``make_train_step``
(the replicated path, ``zero1=True`` and wire ``compression=``) and
``make_fsdp_train_step``. There the whole step is one XLA program whose
collectives ride the TPU interconnect; here the step runs eagerly over
the process group (NCCL on the GPU). In ``make_train_step``,
``DistributedOptimizer`` averages the gradients bucket by bucket while
the backward pass runs, or, under ``zero1``, the sharded update
reduce-scatters them in ``step()``. Each rank passes its own shard of the
batch.
"""

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.utils import parametrize

from horovod_tpu_torch import divergence
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.common.ops import (allreduce, raise_peer_loss,
                                          tree_map)
from horovod_tpu_torch.compression import resolve_wire_arg
from horovod_tpu_torch.ops.losses import chunked_softmax_cross_entropy
from horovod_tpu_torch.optimizer import (DistributedOptimizer,
                                         ReplicatedDistributedOptimizer,
                                         ShardedDistributedOptimizer,
                                         _state_bytes, allreduce_gradients)


def make_train_step(model, loss_fn, optimizer, accum_steps=1, device=None,
                    zero1=False, compression=None, agc=None):
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
      zero1: ZeRO-1 optimizer-state sharding: the optimizer is wrapped in
        the sharded update (``DistributedOptimizer(sharded_update=True)``),
        which reduce-scatters the flat gradients, updates this rank's 1/N
        flat shard and allgathers the parameters back, so the optimizer
        state per rank shrinks N-fold.
      compression: a wire mode ('none', 'bf16', 'int8'; None is
        ``HVD_TPU_COMPRESSION``) for the gradients, on both paths (under
        ``zero1`` the gradient scatter runs the ring with the codec and the
        parameter allgather stays exact), or, on the replicated path only,
        a tensor codec (``Compression.fp16``; under ``zero1`` a codec other
        than ``Compression.none`` raises ``ValueError``).
      agc: adaptive gradient clipping factor (e.g. 0.01; None = off),
        passed to ``DistributedOptimizer(agc=)``, which clips each reduced
        gradient unit-wise against its parameter before the update
        (``ops/agc.py``): the norm-free ResNets' knob. With ``zero1`` it
        raises the reference's ``ValueError``; with an optimizer already
        wrapped, pass it to the wrapper instead.

    ``step(batch)`` returns the loss averaged over the ranks, as a
    0-dim tensor on ``device``.
    """
    device = resolve_device(device)
    if zero1:
        resolve_wire_arg(compression)  # a legacy codec raises here
        if agc is not None:
            raise ValueError(
                "agc= does not compose with zero1: the sharded update "
                "applies the optimizer to 1/N flat shards, which destroys "
                "the per-unit (output-row) norm structure AGC clips "
                "against — every rank would clip a different slice of "
                "each filter")
    if isinstance(optimizer, (ReplicatedDistributedOptimizer,
                              ShardedDistributedOptimizer)):
        if zero1 and not isinstance(optimizer, ShardedDistributedOptimizer):
            raise ValueError("zero1=True needs the sharded update: pass the "
                             "torch optimizer, or one wrapped in "
                             "DistributedOptimizer(sharded_update=True)")
        if agc is not None and agc != getattr(optimizer, "agc", None):
            raise ValueError("agc=%r: the optimizer is already wrapped; "
                             "pass agc= to DistributedOptimizer" % (agc,))
    else:
        optimizer = DistributedOptimizer(
            optimizer, model.named_parameters(), compression=compression,
            sharded_update=True if zero1 else None, agc=agc)

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


class _Gather(torch.autograd.Function):
    """A dim-0 shard to the whole tensor (allgather over the group); the
    backward reduce-scatters the whole tensor's gradient and averages it."""

    @staticmethod
    @raise_peer_loss
    def forward(ctx, shard, name, group, n):
        ctx.name, ctx.group, ctx.n = name, group, n
        parts = [torch.empty_like(shard) for _ in range(n)]
        divergence.record("allgather", shard, name)
        dist.all_gather(parts, shard.contiguous(), group=group)
        return torch.cat(parts, 0)

    @staticmethod
    @raise_peer_loss
    def backward(ctx, grad):
        chunks = [c.contiguous() for c in grad.chunk(ctx.n, 0)]
        out = torch.empty_like(chunks[0])
        divergence.record("reduce_scatter", grad, ctx.name + ".grad")
        dist.reduce_scatter(out, chunks, op=dist.ReduceOp.SUM,
                            group=ctx.group)
        return out.div_(ctx.n), None, None, None


class _DimZeroShard(torch.nn.Module):
    """Parametrization that holds a parameter as its dim-0 shard and gives
    the whole tensor (``_Gather``) where the module reads it."""

    def __init__(self, name, group, n, r):
        super().__init__()
        self.name, self.group, self.n, self.r = name, group, n, r

    def forward(self, shard):
        return _Gather.apply(shard, self.name, self.group, self.n)

    def right_inverse(self, full):
        return full.detach().chunk(self.n, 0)[self.r].clone()


def _fsdp_shards(p, n, min_size):
    """The reference's FSDP rule (``parallel/train.py:295-299``): a
    parameter of ndim >= 1, at least ``min_size`` elements and a dim 0 that
    n divides is held as its dim-0 shard; any other is replicated."""
    return p.dim() >= 1 and p.numel() >= min_size and p.shape[0] % n == 0


def make_fsdp_train_step(model, loss_fn, optimizer_cls, optimizer_kwargs=None,
                         min_size=1024, device=None, group=None,
                         grad_sync=None):
    """Fully sharded data parallelism (ZeRO-3) over the world, or over
    ``group`` (a torch process group, e.g. ``axis_group("fsdp")`` of an
    (fsdp, tp) ``hybrid_mesh``): ``horovod_tpu.parallel.make_fsdp_train_step``
    written by hand over the collectives, where the reference lets GSPMD
    insert them.

    Each parameter that ``_fsdp_shards`` picks is replaced, in ``model``,
    by its dim-0 shard (a ``torch.nn.utils.parametrize`` parametrization:
    the parameter becomes ``<module>.parametrizations.<name>.original``,
    1/N of it). Where the step's forward first reads it, it is allgathered
    through an ``autograd.Function`` whose backward reduce-scatters its
    gradient and averages it, so each rank gets its shard's gradient; once
    a step (``parametrize.cached``). Every other parameter is replicated
    and its gradient allreduce-averaged after the backward. The optimizer,
    ``optimizer_cls(model.parameters(), **optimizer_kwargs)``, is built
    over the shards and the replicated parameters, so its state is 1/N per
    sharded parameter. A parameter registered in several modules (a tied
    weight) stays replicated. Every rank must hold the same weights when
    this is called (broadcast them first).

    ``loss_fn(model, batch)`` sees this rank's equal shard of the batch
    (the port's convention), where the reference's sees the global batch:
    with a mean loss the averaged gradients are the same.

    Returns ``step(batch) -> loss averaged over the ranks``, with
    ``step.optimizer``, ``step.sharded`` (the qualified names of the
    sharded parameters), ``step.full_parameters()`` ({name: whole tensor},
    a collective) and ``step.opt_state_bytes()`` (this rank's optimizer
    state). Reading a sharded parameter outside the step (``module.weight``)
    allgathers it: do it on every rank.

    FSDP x tp: run this on the tp-local model (``cfg.local(tp)``, its tp
    shard loaded) with ``group`` the fsdp axis, so each tp shard is sharded
    again over fsdp, and ``grad_sync=lambda g: tp_grad_sync(g, "tp")``:
    ``grad_sync`` maps {parameter name: gradient} to synced gradients after
    the backward, before the update (names as ``named_parameters()`` gives
    them, a sharded one's ending in ``parametrizations.<name>.original``)."""
    device = resolve_device(device)
    if group is None:
        group = basics.process_group()
    n, r = dist.get_world_size(group), dist.get_rank(group)
    counts = {}
    for _, p in model.named_parameters(remove_duplicate=False):
        counts[p] = counts.get(p, 0) + 1
    owners = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            owners.setdefault(p, (mname, module, pname))
    sharded = []
    for p, (mname, module, pname) in owners.items():
        if counts[p] == 1 and p.requires_grad and _fsdp_shards(p, n,
                                                              min_size):
            name = "%s.%s" % (mname, pname) if mname else pname
            parametrize.register_parametrization(
                module, pname, _DimZeroShard("fsdp." + name, group, n, r),
                unsafe=True)
            sharded.append((name, module, pname))
    shards = {module.parametrizations[pname].original
              for _, module, pname in sharded}
    replicated = [p for p in model.parameters() if p not in shards]
    optimizer = optimizer_cls(model.parameters(), **(optimizer_kwargs or {}))

    def step(batch):
        batch = tree_map(lambda t: t.to(device, non_blocking=True), batch)
        optimizer.zero_grad(set_to_none=True)
        with parametrize.cached():
            loss = loss_fn(model, batch)
            loss.backward()
        allreduce_gradients(replicated, name_prefix="fsdp_grad", group=group)
        if grad_sync is not None:
            named = [(k, p) for k, p in model.named_parameters()
                     if p.grad is not None]
            synced = grad_sync({k: p.grad for k, p in named})
            for k, p in named:
                p.grad = synced[k]
        optimizer.step()
        return allreduce(loss.detach().float(), average=True, group=group)

    def full_parameters():
        with torch.no_grad():
            return {name: getattr(module, pname).detach().clone()
                    for name, module, pname in sharded}

    step.optimizer = optimizer
    step.sharded = [name for name, _, _ in sharded]
    step.full_parameters = full_parameters
    step.opt_state_bytes = lambda: _state_bytes(optimizer)
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
