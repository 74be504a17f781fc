"""Gradient averaging around a torch optimizer.

Counterpart of ``horovod_tpu/jax/__init__.py``'s ``allreduce_gradients``,
``broadcast_parameters``, ``broadcast_optimizer_state`` and
``DistributedOptimizer``, with the reduction overlapped with the backward
pass as the reference Horovod's torch binding does it:
``DistributedOptimizer`` puts the gradients in buckets when it is built
and reduces each bucket asynchronously as soon as the backward has
produced every gradient in it, in a fixed bucket order, so the last
layers' gradients travel while the first layers' are still being
computed. ``allreduce_gradients`` is the same reduction done at once, one
flat buffer per dtype (the counterpart of the core's tensor fusion).
"""

import contextlib
import os
import weakref

import torch
import torch.distributed as dist

from horovod_tpu_torch import divergence
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.compression import codec
from horovod_tpu_torch.groups import group_size, resolve_group

# HVD_TPU_FUSION_THRESHOLD's default in native/operations.cc
FUSION_THRESHOLD = 64 * 1024 * 1024


def _reduce_flat(flat, comp, average, group, name):
    """Starts the sum of a flat buffer over ``group`` under codec ``comp``;
    returns ``finish() -> the reduced buffer in flat's dtype``."""
    wire, ctx = comp.compress(flat)
    divergence.record("allreduce", wire, name)
    work = dist.all_reduce(wire, op=dist.ReduceOp.SUM,
                           group=resolve_group(group), async_op=True)
    n = group_size(group)

    def finish():
        work.wait()
        if average:
            wire.div_(n)
        return comp.decompress(wire, ctx)

    return finish


def _scatter(flat, grads):
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def allreduce_gradients(parameters, average=True, name_prefix="grad",
                        compression=None, group=None):
    """Averages (or sums) the ``.grad`` of every parameter over the ranks
    of ``group`` (the world for None), in place, one flat buffer per dtype
    named ``name_prefix.i``. Parameters without a gradient are skipped:
    every rank must produce gradients for the same parameters."""
    comp = codec(compression)
    by_dtype = {}
    for p in parameters:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for i, grads in enumerate(by_dtype.values()):
        flat = torch.cat([g.reshape(-1) for g in grads])
        _scatter(_reduce_flat(flat, comp, average, group,
                              "%s.%d" % (name_prefix, i))(), grads)


def _tensors(params):
    if isinstance(params, dict):
        return list(params.values())
    return [p[1] if isinstance(p, tuple) else p for p in params]


def broadcast_parameters(params, root_rank=0, name_prefix="param"):
    """Overwrites ``params`` (a state_dict, named_parameters() or
    tensors) with their values on ``root_rank``, in place, each named
    ``name_prefix.i``."""
    with torch.no_grad():
        for i, t in enumerate(_tensors(params)):
            divergence.record("broadcast", t, "%s.%d" % (name_prefix, i))
            dist.broadcast(t.data, src=root_rank,
                           group=basics.process_group())


def broadcast_optimizer_state(optimizer, root_rank=0,
                              name_prefix="opt_state"):
    """Overwrites the tensors of the optimizer's state (moments, step
    counts) with root's, in place. State the optimizer has not created
    yet (before its first step) has nothing to send."""
    opt = getattr(optimizer, "optimizer", optimizer)
    i = 0
    with torch.no_grad():
        for state in opt.state.values():
            for key, t in state.items():
                if torch.is_tensor(t):
                    # Adam keeps its step count on the CPU; NCCL sends
                    # device tensors only.
                    buf = t.to(basics.device())
                    divergence.record("broadcast", buf,
                                      "%s.%d" % (name_prefix, i))
                    i += 1
                    dist.broadcast(buf, src=root_rank,
                                   group=basics.process_group())
                    state[key] = buf.to(t.device)


def _sharded_update_default():
    """``HVD_TPU_SHARDED_UPDATE`` as the native helper reads it: any
    nonzero integer enables."""
    value = os.environ.get("HVD_TPU_SHARDED_UPDATE", "").strip()
    try:
        return int(value or "0", 0) != 0
    except ValueError:
        return False


def plan_buckets(params, threshold):
    """Buckets of ``params`` for the overlapped reduction: the parameters
    in reverse (the order the backward produces their gradients), by
    dtype, each bucket up to ``threshold`` bytes (a larger parameter gets a
    bucket of its own). Bucket i is the i-th one opened, so the plan, and
    the order the buckets go out in, is the same on every rank."""
    buckets, open_ = [], {}
    for p in reversed(params):
        nbytes = p.numel() * p.element_size()
        b = open_.get(p.dtype)
        if b is None or (b[1] and b[1] + nbytes > threshold):
            b = open_[p.dtype] = [[], 0]
            buckets.append(b[0])
        b[0].append(p)
        b[1] += nbytes
    return buckets


class DistributedOptimizer:
    """Wraps a torch optimizer so that ``step()`` applies the gradients
    averaged (or, with ``average=False``, summed) over the ranks of
    ``group``.

    The reduction overlaps the backward pass. At construction the
    parameters (``named_parameters``' order, else the optimizer's; the same
    on every rank that built the same model) go into buckets
    (``plan_buckets``, ``HVD_TPU_FUSION_THRESHOLD`` bytes, 64 MiB by
    default), and each gets a post-accumulate-grad hook. Once every
    gradient of a bucket has arrived, the bucket is flattened, compressed
    by the codec and reduced with an asynchronous collective named
    ``name_prefix.<bucket>``; bucket i goes out only after buckets 0 to
    i - 1, so every rank issues the collectives in the same order.
    ``synchronize()`` (``step()`` calls it) sends what has not gone out,
    in its turn (also a bucket whose gradients never all arrived), waits
    for every bucket and writes the results into the gradients.
    Parameters without a gradient are skipped.

    ``group=None`` is the mesh's ``batch_group()``, looked up at every
    reduction, or the world without a mesh. ``sharded_update`` and
    ``agc`` are not ported (ROADMAP A4 and A6)."""

    def __init__(self, optimizer, named_parameters=None, compression=None,
                 average=True, name_prefix="grad", group=None,
                 sharded_update=None, agc=None):
        if sharded_update is None:
            sharded_update = _sharded_update_default()
        if sharded_update:
            raise NotImplementedError(
                "sharded_update (HVD_TPU_SHARDED_UPDATE) is ROADMAP A4")
        if agc is not None:
            raise NotImplementedError("agc= is ROADMAP A6")
        self.optimizer = optimizer
        self._codec = codec(compression)
        self._average = average
        self._prefix = name_prefix
        self._group = group
        if named_parameters is not None:
            params = [p for _, p in named_parameters]
        else:
            params = [p for g in optimizer.param_groups for p in g["params"]]
        params = [p for p in dict.fromkeys(params) if p.requires_grad]
        threshold = int(os.environ.get("HVD_TPU_FUSION_THRESHOLD", "")
                        or FUSION_THRESHOLD)
        self.buckets = plan_buckets(params, threshold)
        self._bucket_of = {p: i for i, bucket in enumerate(self.buckets)
                           for p in bucket}
        # The hooks hold the optimizer weakly, so one that is dropped stops
        # reducing, and its hooks go with it.
        ref = weakref.ref(self)

        def hook(p):
            opt = ref()
            if opt is not None:
                opt._hook(p)

        self._hooks = [p.register_post_accumulate_grad_hook(hook)
                       for p in self._bucket_of]
        self._sync = True
        # the bucket ids in the order the last synchronize() sent them
        self.launch_order = []
        self._reset()

    def __del__(self):
        for handle in getattr(self, "_hooks", ()):
            handle.remove()

    def _reset(self):
        """Starts a new reduction window: no gradient arrived, no bucket
        out."""
        self._arrived = [set() for _ in self.buckets]
        self._pending = []
        self._order = []
        self._next = 0

    def _hook(self, p):
        if not self._sync:
            return
        i = self._bucket_of[p]
        if i < self._next or p in self._arrived[i]:
            # A gradient arrived again after its bucket went out: a new
            # backward pass without a step in between. Drop the stale
            # window (each rank drops the same one) and start over.
            self._drain()
        self._arrived[i].add(p)
        while (self._next < len(self.buckets) and
               len(self._arrived[self._next]) ==
               len(self.buckets[self._next])):
            self._launch(self._next)

    def _launch(self, i):
        """Sends bucket i; it must be the next one."""
        grads = [p.grad for p in self.buckets[i] if p.grad is not None]
        if grads:
            group = self._group if self._group is not None else \
                basics.batch_group()
            flat = torch.cat([g.reshape(-1) for g in grads])
            self._pending.append((grads, _reduce_flat(
                flat, self._codec, self._average, group,
                "%s.%d" % (self._prefix, i))))
        self._order.append(i)
        self._next = i + 1

    def _drain(self):
        for _, finish in self._pending:
            finish()
        self._reset()

    def synchronize(self):
        """Reduces the gradients over the ranks now: sends every bucket
        that has not gone out, in order, waits for all of them and writes
        the results into the gradients."""
        while self._next < len(self.buckets):
            self._launch(self._next)
        with torch.no_grad():
            for grads, finish in self._pending:
                _scatter(finish(), grads)
        self.launch_order = self._order
        self._reset()

    @contextlib.contextmanager
    def _no_sync(self):
        """Backward passes inside accumulate gradients without reducing
        them (the microbatches of ``make_train_step(accum_steps=n)`` but
        the last)."""
        self._sync = False
        try:
            yield
        finally:
            self._sync = True

    def step(self):
        self.synchronize()
        self.optimizer.step()

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)
